"""Log-mel frontend: framed windowed DFT → magnitude → mel → log, in fp32.

Same tfio semantics as cacophony_tpu/frontend/dsp.py (the reference's host
TF frontend, src/caco/caco_eval_utils.py:12-24):

- frames = ceil(len / hop)   (tf.signal.stft(..., pad_end=True))
- each frame is `window_length` samples starting at t·hop, zero-padded at
  the END to fft_size
- periodic Hann window; magnitude (power 1) spectrum
- TF mel matrix: HTK mel scale, triangles in MEL space, DC bin zeroed
- log(mel + 1e-5) · 0.2 + 0.9

The numpy matrix helpers are copies of the JAX package's (which cannot be
imported where JAX is absent); the tests hold them equal.  The two products
are plain fp32 `torch.matmul` (XLA ops in the JAX package, not kernels).
The log amplifies rounding, so TF32 must stay off:
`torch.backends.cuda.matmul.allow_tf32 = False` (the engine sets it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cacophony_tpu_torch.configs import FrontendConfig


def num_stft_frames(num_samples, hop_length: int):
    """tfio frame count: ceil(len / hop).  Works on ints and int tensors."""
    return -(-num_samples // hop_length)


def hann_window_periodic(window_length: int) -> np.ndarray:
    """Periodic Hann window (tf.signal.hann_window / torch.hann_window default)."""
    n = np.arange(window_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)).astype(np.float32)


def _hertz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def linear_to_mel_matrix(cfg: FrontendConfig) -> np.ndarray:
    """TF-semantics mel filterbank, shape (num_spectrogram_bins, num_mels)."""
    nbins = cfg.num_spectrogram_bins
    nyquist = cfg.sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, nbins)[1:]  # DC dropped
    spec_mel = _hertz_to_mel(linear_freqs)[:, None]

    band_edges = np.linspace(_hertz_to_mel(cfg.mel_fmin), _hertz_to_mel(cfg.fmax), cfg.num_mels + 2)
    lower, center, upper = band_edges[:-2], band_edges[1:-1], band_edges[2:]

    lower_slopes = (spec_mel - lower) / (center - lower)
    upper_slopes = (upper - spec_mel) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    weights = np.pad(weights, [[1, 0], [0, 0]])  # re-attach the zeroed DC row
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _windowed_dft_matrices(window_length: int, fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices (window_length, fft_size//2+1) with the Hann
    window and end-zero-padding folded in: |X| = sqrt((x@Cr)² + (x@Ci)²)."""
    nbins = fft_size // 2 + 1
    n = np.arange(window_length, dtype=np.float64)[:, None]
    k = np.arange(nbins, dtype=np.float64)[None, :]
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length))
    angle = -2.0 * np.pi * n * k / fft_size
    cr = (w * np.cos(angle)).astype(np.float32)
    ci = (w * np.sin(angle)).astype(np.float32)
    return cr, ci


def stft_magnitude(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Magnitude STFT, tfio semantics.  audio: (..., num_samples) → (..., F, nbins).

    Frames are strided views of the end-padded signal (`unfold`), multiplied
    by the re|im-concatenated windowed-DFT matrix in one fp32 product."""
    hop, win = cfg.hop_length, cfg.window_length
    num_frames = num_stft_frames(audio.shape[-1], hop)
    cr, ci = _windowed_dft_matrices(win, cfg.fft_size)
    nb = cr.shape[1]
    total = (num_frames - 1) * hop + win
    x = audio.float()
    x = torch.nn.functional.pad(x, (0, max(0, total - x.shape[-1])))
    frames = x.unfold(-1, win, hop)  # (..., F, win)
    c = torch.from_numpy(np.concatenate([cr, ci], axis=1)).to(x.device)
    acc = frames @ c
    re, im = acc[..., :nb], acc[..., nb:]
    return torch.sqrt(re * re + im * im)


def log_mel_spectrogram(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """audio (..., num_samples) → log-mel (..., num_frames, num_mels), fp32."""
    spec = stft_magnitude(audio, cfg)
    mel = spec @ torch.from_numpy(linear_to_mel_matrix(cfg)).to(spec.device)
    return torch.log(mel + cfg.log_offset) * cfg.log_scale + cfg.log_bias
