"""The port's frontend (wav → log-mel → patches) against the JAX package and
the frozen tf.signal goldens.

No kernel on either side: the JAX frontend here is the XLA op chain
(`wav_to_patches`; the fused frontend kernel K8 is opt-in and off).
Tolerances: log-mel 1e-4 absolute (fp32 products summed in another order,
amplified by the log; the JAX goldens test allows 3.1e-4 for its 3-pass
bf16 STFT); patches, masks and indices exactly equal where integer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu.configs import FrontendConfig as JFront
from cacophony_tpu.configs import PatchConfig as JPatch
from cacophony_tpu.frontend import dsp as jdsp
from cacophony_tpu.frontend.patchify import num_patches_for_samples as jax_num_patches
from cacophony_tpu.frontend.patchify import wav_to_patches as jax_wav_to_patches
from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend import dsp
from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples, wav_to_patches

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "frontend_tf.npz")
CFG = FrontendConfig()


def test_numpy_helpers_are_exact_copies():
    jcfg = JFront()
    np.testing.assert_array_equal(dsp.hann_window_periodic(400), jdsp.hann_window_periodic(400))
    np.testing.assert_array_equal(dsp.linear_to_mel_matrix(CFG), jdsp.linear_to_mel_matrix(jcfg))
    for a, b in zip(dsp._windowed_dft_matrices(400, 512), jdsp._windowed_dft_matrices(400, 512)):
        np.testing.assert_array_equal(a, b)
    for n in (1, 159, 160, 161, 160_000):
        assert dsp.num_stft_frames(n, 160) == jdsp.num_stft_frames(n, 160)
        assert num_patches_for_samples(n, CFG, PatchConfig()) == jax_num_patches(n, jcfg, JPatch())
    assert num_patches_for_samples(160_000, CFG, PatchConfig()) == 496


@pytest.mark.parametrize("n_samples", [16_000, 15_999, 4_321])
def test_logmel_matches_frozen_tf_goldens(n_samples):
    g = np.load(GOLDENS)
    ours = dsp.log_mel_spectrogram(torch.from_numpy(g[f"audio_{n_samples}"]), CFG).numpy()
    theirs = g[f"logmel_{n_samples}"]
    assert ours.shape == theirs.shape == (-(-n_samples // 160), 128)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wav_to_patches_matches_jax_vmap(dtype):
    """Batched buffers of 1 s with true lengths from full to zero (the
    engine's padding clips), seq 48 so both the trim and the pad paths of
    patchify run across the batch."""
    rs = np.random.RandomState(0)
    bufs = np.zeros((5, 16_000), np.float32)
    lens = np.array([16_000, 12_345, 4_000, 160, 0], np.int32)
    for i, n in enumerate(lens):
        bufs[i, :n] = 0.1 * rs.randn(n)
    seq = 48
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.vmap(lambda b, n: jax_wav_to_patches(b, n, JFront(), JPatch(patches_seq_len=seq),
                                                   dtype=jd))(jnp.asarray(bufs), jnp.asarray(lens))
    got = wav_to_patches(torch.from_numpy(bufs), torch.from_numpy(lens), CFG,
                         PatchConfig(patches_seq_len=seq), dtype=td)
    for k in ("audio_mask", "audio_time_inds", "audio_freq_inds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["audio_patches"].dtype == td
    # bf16: the same fp32 log-mel values can round to neighbouring bf16
    # values when the fp32 sums differ in the last bits (1 ulp = 2^-8 rel.)
    atol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got["audio_patches"].float().numpy(),
                               np.asarray(ref["audio_patches"]).astype(np.float32), atol=atol)
