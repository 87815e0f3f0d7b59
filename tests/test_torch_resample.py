"""The port's device FFT resample (`frontend.dsp.resample_fft`, torch.fft)
against the JAX package's `resample_fft` (jnp.fft on the CPU) and the
port's `resample_fft_host` (numpy), within 1e-5 absolute on unit-variance
input (fp32 FFTs of up to 480 000 points summed in other orders: measured
errors are a few 1e-7): up and down, odd and even lengths (the Nyquist
fold and split), 44.1 k → 16 k and 48 k → 16 k, batched input."""

import numpy as np
import pytest
import torch

from cacophony_tpu_torch.frontend import dsp

torch.set_num_threads(2)

CASES = [(1000, 1600), (1001, 1601), (1000, 1601), (1001, 1600),  # up
         (1600, 1000), (1601, 1001), (1600, 1001), (1601, 1000),  # down
         (44100 * 2, 16000 * 2), (48000 * 10, 16000 * 10), (44100 + 7, 16000 + 3)]


@pytest.mark.parametrize("num_in,num_out", CASES)
@pytest.mark.parametrize("batch", [(), (3,)])
def test_resample_fft_matches_jax_and_host(num_in, num_out, batch):
    import jax.numpy as jnp

    from cacophony_tpu.frontend.dsp import resample_fft as jax_resample

    x = np.random.RandomState(num_in + num_out).randn(*batch, num_in).astype(np.float32)
    got = dsp.resample_fft(torch.from_numpy(x), num_out)
    assert got.dtype == torch.float32 and got.shape == (*batch, num_out)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resample(jnp.asarray(x), num_out)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, dsp.resample_fft_host(x, num_out), rtol=0, atol=1e-5)


def test_equal_lengths_return_the_input():
    x = torch.randn(2, 100)
    assert dsp.resample_fft(x, 100) is x
