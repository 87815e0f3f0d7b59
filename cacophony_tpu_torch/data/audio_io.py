"""Host-side audio IO: decode, mono mixdown, resample to 16 kHz
(cacophony_tpu/data/audio_io.py:22-77).

Reference behaviour (src/eval/eval_utils.py:6-16): soundfile read → fp32 →
channel mean → scipy FFT resample to 16 kHz.  Decoding goes through the
port's native C++ decoder (native/wavio.py, built at first use; a failed
build raises); a file the decoder refuses (A-law, exotic chunks) is read
with scipy.io.wavfile instead.  The resample is `resample_fft_host`, bit
for bit scipy.signal.resample.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from cacophony_tpu_torch.frontend.dsp import resample_fft_host
from cacophony_tpu_torch.native import wavio

_PCM_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0,
              np.dtype(np.uint8): 128.0}


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ (float32 samples (n,) or (n, ch), sample_rate)."""
    wavio.load()  # outside the try: a failed build raises
    try:
        return wavio.read_wav(path)
    except ValueError:
        pass
    from scipy.io import wavfile

    sr, data = wavfile.read(path, mmap=False)
    if data.dtype in _PCM_SCALE:
        scale = _PCM_SCALE[data.dtype]
        if data.dtype == np.uint8:
            data = data.astype(np.float32) - 128.0
        data = np.asarray(data, np.float32) / scale
    else:
        data = np.asarray(data, np.float32)
    return data, int(sr)


def load_audio(path: str, expected_sr: Optional[int] = None,
               target_sr: int = 16_000) -> np.ndarray:
    """Decode + mono + resample, reference semantics.

    `expected_sr` mirrors the reference's per-dataset configured rate and,
    as there, takes precedence over the file's header rate when given (the
    published numbers were produced that way); a mismatch is warned about.
    """
    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav.mean(axis=-1)
    wav = wav.astype(np.float32)
    if expected_sr is not None and sr != expected_sr:
        warnings.warn(
            f"{path}: file rate {sr} != configured rate {expected_sr}; "
            "using the configured rate (reference behavior)")
    src_sr = sr if expected_sr is None else expected_sr
    if src_sr != target_sr:
        n_out = round(wav.shape[-1] * float(target_sr) / src_sr)
        wav = resample_fft_host(wav, n_out)
    return wav


def pad_to_buffer(wav: np.ndarray, buffer_samples: int) -> Tuple[np.ndarray, int]:
    """Fixed-size zero-padded buffer + true length.  Longer clips are
    truncated (the device patchify keeps the first patches anyway)."""
    n = min(len(wav), buffer_samples)
    buf = np.zeros(buffer_samples, np.float32)
    buf[:n] = wav[:n]
    return buf, n
