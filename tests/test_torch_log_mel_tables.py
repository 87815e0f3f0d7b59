"""The tables that let K8 skip the work the log-mel does not need, against
the JAX package's matrices: the bin range [k_lo, k_hi) whose mel rows have
a nonzero, each mel channel's run of nonzero bins and its weights
(`fused.mel_bin_tables`), and the work the kernels' bounds count
(`fused.spectrum_work`), at the default frontend and at mel_fmax = 7600.

JAX kernel reached: K8 `fused_log_mel` (fast_dft=False) in Pallas
interpret mode, on a clip of a DC offset plus a Nyquist tone: the two bins
the kernel leaves out (0 and 256) carry most of that clip's energy but add
nothing to the log-mel.  Tolerance 1e-4 absolute on the log-mel, as in
tests/test_torch_fused_frontend.py (fp32 sums in another order, scaled by
the log's 0.2/(mel + 1e-5)).  The sums over the runs are held to the dense
ascending sums bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu.configs import FrontendConfig as JFront
from cacophony_tpu.frontend import fused as jfused
from cacophony_tpu_torch.configs import FrontendConfig
from cacophony_tpu_torch.frontend import fused

torch.set_num_threads(2)

# mel_fmax → (k_lo, k_hi, DFT columns, mel nonzeros) at 16 kHz, fft 512, 128 mels
FRONTS = {None: (1, 256, 510, 505), 7600.0: (1, 244, 486, 481)}


@pytest.mark.parametrize("fmax", list(FRONTS))
def test_bin_tables_cover_exactly_the_jax_mel_nonzeros(fmax):
    k_lo, k_hi, runs, weights = fused.mel_bin_tables(FrontendConfig(mel_fmax=fmax))
    jmel = jfused._padded_matrices(JFront(mel_fmax=fmax))[1]
    nz = jmel != 0
    assert (k_lo, k_hi) == FRONTS[fmax][:2]
    assert runs.shape == (128, 2) and runs.dtype == np.int32
    # every nonzero lies inside its channel's run and the bin range …
    ks, ms = np.nonzero(nz)
    assert (ks >= k_lo).all() and (ks < k_hi).all()
    assert (ks >= runs[ms, 0]).all() and (ks <= runs[ms, 1]).all()
    # … no bin outside the range has a nonzero row, both ends do
    assert not nz[:k_lo].any() and not nz[k_hi:].any()
    assert nz[k_lo].any() and nz[k_hi - 1].any()
    # each run is tight (starts and ends on a nonzero) and its weights are the matrix's
    for m, (lo, hi) in enumerate(runs):
        if hi < lo:
            assert not nz[:, m].any() and not weights[m].any()
            continue
        assert nz[lo, m] and nz[hi, m]
        np.testing.assert_array_equal(weights[m, :hi - lo + 1], jmel[lo:hi + 1, m])
        assert not weights[m, hi - lo + 1:].any()
    assert fused.spectrum_work(FrontendConfig(mel_fmax=fmax)) == FRONTS[fmax][2:]


@pytest.mark.parametrize("fmax", list(FRONTS))
def test_run_sums_equal_dense_ascending_sums_bit_for_bit(fmax):
    """The kernel's mel stage: channel m over its run, ascending, fp32; the
    dense ascending sum over every bin adds only exact zeros beside it."""
    front = FrontendConfig(mel_fmax=fmax)
    k_lo, k_hi, runs, weights = fused.mel_bin_tables(front)
    mel = fused._padded_matrices(front)[1]
    mag = np.abs(np.random.RandomState(0).randn(3, mel.shape[0])).astype(np.float32) * 30
    for f in range(mag.shape[0]):
        for m in range(mel.shape[1]):
            dense = np.float32(0)
            for k in range(mel.shape[0]):
                dense = np.float32(dense + mag[f, k] * mel[k, m])
            run = np.float32(0)
            lo, hi = runs[m]
            for k in range(max(lo, k_lo), min(hi + 1, k_hi)):
                run = np.float32(run + mag[f, k] * weights[m, k - lo])
            assert dense.tobytes() == run.tobytes(), (f, m)


@pytest.mark.parametrize("fmax", list(FRONTS))
def test_log_mel_plain_matches_pallas_k8_on_dc_and_nyquist(fmax):
    """A DC offset plus a Nyquist tone (-1)^n over noise, 0.1 each, and the
    tone alone at a quiet level: most of the energy sits in bins 0 and 256,
    which K8 skips; the log-mel still equals the Pallas kernel's.  (A louder
    tone over less noise leaves bins whose sums cancel, where two fp32
    orders of one sum differ past 1e-4 in the log-mel.)"""
    front, jfront, frames = FrontendConfig(mel_fmax=fmax), JFront(mel_fmax=fmax), 300
    n = np.arange(frames * front.hop_length)
    nyquist = np.where(n % 2 == 0, 1.0, -1.0)
    noise = 0.1 * np.random.RandomState(1).randn(n.size)
    bufs = np.stack([0.1 + 0.1 * nyquist + noise, 1e-3 * nyquist]).astype(np.float32)
    rows = fused.buffer_to_rows(torch.from_numpy(bufs), frames, front)
    ref = np.asarray(jfused.fused_log_mel(jnp.asarray(rows.numpy()), jfront, frames, interpret=True))
    got = fused.fused_log_mel_plain(rows, front, frames).numpy()
    assert got.shape == ref.shape == (2, frames, 128)
    np.testing.assert_allclose(got, ref, atol=1e-4)
