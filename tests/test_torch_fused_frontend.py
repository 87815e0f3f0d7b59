"""K8, the fused frontend, in the port against the JAX package, and the
port's 30-s log-mel against JAX's segmented STFT.

JAX kernel reached: K8 `fused_log_mel` (fast_dft=False), in Pallas
interpret mode as tests/test_fused_frontend.py runs it.  At 30 s the JAX
`fused_batch_wav_to_patches` falls back to its XLA chain (the clip does not
fit the TPU's VMEM); the port runs K8 there too, and the values agree.

Tolerances on the log-mel: 1e-4 absolute.  Both sides compute fp32 products
summed in another order; the log turns a mel error δ into 0.2·δ/(mel +
1e-5), so near silence the bound is set by the 1e-5 offset, and the quiet
clip (amplitude 1e-4) and the silent one are included for that.  Patches:
the same; masks and indices exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu.configs import FrontendConfig as JFront
from cacophony_tpu.configs import PatchConfig as JPatch
from cacophony_tpu.frontend import dsp as jdsp
from cacophony_tpu.frontend import fused as jfused
from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend import dsp, fused
from cacophony_tpu_torch.ops import _kernels as kern

torch.set_num_threads(2)

FRONT = FrontendConfig()
ATOL = 1e-4


def _bufs(seconds, lens, seed=0):
    """(B, seconds·16 k) buffers: noise at 0.1, one quiet clip at 1e-4 and
    zero-length clips; lens are the true lengths."""
    rs = np.random.RandomState(seed)
    bufs = np.zeros((len(lens), seconds * 16_000), np.float32)
    for i, n in enumerate(lens):
        amp = 1e-4 if i == 1 else 0.1
        bufs[i, :n] = amp * rs.randn(n)
    return bufs, np.asarray(lens, np.int32)


def test_padded_matrices_and_rows_match_jax():
    c, mel, nbp = fused._padded_matrices(FRONT)
    jc, jmel, jnbp = jfused._padded_matrices(JFront())
    assert nbp == jnbp == 384 and c.shape == (400, 768) and mel.shape == (384, 128)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(mel, jmel)
    assert fused.audio_rows_for(1000, FRONT) == jfused.audio_rows_for(1000, JFront()) == 1003
    bufs, _ = _bufs(1, [16_000, 900])
    for frames in (100, 90):
        np.testing.assert_array_equal(
            fused.buffer_to_rows(torch.from_numpy(bufs), frames, FRONT).numpy(),
            np.asarray(jfused.buffer_to_rows(jnp.asarray(bufs), frames, JFront())))


def test_log_mel_plain_matches_pallas_k8():
    """10-s buffers (1000 frames): noise, a quiet clip, a silent clip."""
    bufs, _ = _bufs(10, [160_000, 160_000, 0])
    rows = fused.buffer_to_rows(torch.from_numpy(bufs), 1000, FRONT)
    ref = jfused.fused_log_mel(jnp.asarray(rows.numpy()), JFront(), 1000, interpret=True)
    kern.reset_launches()
    got = fused.fused_log_mel(rows, FRONT, 1000)  # CPU tensor → the plain version
    assert kern.LAUNCHES["log_mel"] == 0
    assert got.shape == (3, 1000, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.log(1e-5) * 0.2 + 0.9, rtol=1e-6)
    # and the unfused chain over the same buffers
    np.testing.assert_allclose(got.numpy(), dsp.log_mel_spectrogram(torch.from_numpy(bufs),
                                                                    FRONT).numpy(), atol=ATOL)


def test_30s_log_mel_matches_jax_segmented_stft():
    """At 3000 frames the JAX package switches to its segmented STFT (a
    workaround for XLA on the TPU); the port's one framed product and K8's
    plain version compute the same values."""
    bufs, _ = _bufs(30, [480_000, 300_000])
    assert jdsp.num_stft_frames(480_000, 160) > jdsp._FRAMED_MAX_FRAMES
    ref = np.stack([np.asarray(jdsp.log_mel_spectrogram(jnp.asarray(b), JFront())) for b in bufs])
    got = dsp.log_mel_spectrogram(torch.from_numpy(bufs), FRONT).numpy()
    assert got.shape == ref.shape == (2, 3000, 128)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    k8 = fused.fused_log_mel(fused.buffer_to_rows(torch.from_numpy(bufs), 3000, FRONT), FRONT, 3000)
    np.testing.assert_allclose(k8.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("seconds,seq", [(10, 496), (30, 1536)])
def test_fused_batch_wav_to_patches_matches_jax(seconds, seq):
    n = seconds * 16_000
    bufs, lens = _bufs(seconds, [n, n // 3, 12_345, 0])
    patch = PatchConfig(patches_seq_len=seq)
    ref = jfused.fused_batch_wav_to_patches(jnp.asarray(bufs), jnp.asarray(lens), JFront(),
                                            JPatch(patches_seq_len=seq), interpret=True)
    got = fused.fused_batch_wav_to_patches(torch.from_numpy(bufs), torch.from_numpy(lens),
                                           FRONT, patch)
    for k in ("audio_mask", "audio_time_inds", "audio_freq_inds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["audio_patches"].shape == (4, seq, 256)
    np.testing.assert_allclose(got["audio_patches"].numpy(), np.asarray(ref["audio_patches"]),
                               atol=ATOL)
    idx = fused.patch_index_arrays(torch.from_numpy(lens), FRONT, patch)
    jidx = jfused.patch_index_arrays(jnp.asarray(lens), JFront(), JPatch(patches_seq_len=seq))
    for k, v in idx.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jidx[k]), err_msg=k)
        np.testing.assert_array_equal(v.numpy(), got[k].numpy(), err_msg=k)


def test_log_mel_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        fused.fused_log_mel(torch.empty(1, 103, 160, device="meta"), FRONT, 100)
