"""Spectrogram → ViT patches with static shapes (cacophony_tpu/frontend/patchify.py).

Reference semantics (src/caco/dataset.py:55-93): trim frames to a multiple
of the time patch size, reshape (T, 16, F, 16) → time-major (T·F, 256)
patches, keep the first N or zero-pad to `patches_seq_len` with a validity
mask; time_inds = (mask · arange) // num_freq_patches, freq_inds = … % ….

Audio arrives as a fixed-size zero-padded (B, samples) buffer plus true
lengths; the batch dimension is written out where the JAX package vmaps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend.dsp import log_mel_spectrogram, num_stft_frames


def num_patches_for_samples(num_samples: int, front: FrontendConfig, patch: PatchConfig) -> int:
    """Number of valid patches a clip of `num_samples` produces."""
    frames = num_stft_frames(num_samples, front.hop_length)
    num_freq_patches = front.num_mels // patch.freq_patch_size
    return (frames // patch.time_patch_size) * num_freq_patches


def patchify_spectrogram(spec: torch.Tensor, num_valid_frames: torch.Tensor,
                         patch: PatchConfig,
                         dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """spec: (B, F_buf, num_mels); num_valid_frames: (B,) int.

    → audio_patches (B, S, tp·fp), audio_time_inds, audio_freq_inds,
    audio_mask (B, S) int32, with S = patch.patches_seq_len.  With `dtype`
    the spectrogram is cast before the reshape (bit-identical to casting
    at the patch projection)."""
    tp, fp, seq_len = patch.time_patch_size, patch.freq_patch_size, patch.patches_seq_len
    if dtype is not None:
        spec = spec.to(dtype)
    b, f_buf, num_mels = spec.shape
    t1, f1 = f_buf // tp, num_mels // fp

    x = spec[:, : t1 * tp].reshape(b, t1, tp, f1, fp)
    x = x.permute(0, 1, 3, 2, 4).reshape(b, t1 * f1, tp * fp)
    if t1 * f1 >= seq_len:
        x = x[:, :seq_len]
    else:
        x = torch.nn.functional.pad(x, (0, 0, 0, seq_len - t1 * f1))

    valid_patches = (num_valid_frames // tp) * f1
    positions = torch.arange(seq_len, dtype=torch.int32, device=spec.device)
    mask = (positions[None, :] < valid_patches[:, None]).to(torch.int32)
    inds = positions[None, :] * mask
    return {
        "audio_patches": x * mask[..., None].to(x.dtype),
        "audio_time_inds": inds // f1,
        "audio_freq_inds": inds % f1,
        "audio_mask": mask,
    }


def wav_to_patches(audio_buf: torch.Tensor, num_valid_samples: torch.Tensor,
                   front: FrontendConfig, patch: PatchConfig,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """(B, max_samples) zero-padded waveforms + (B,) true lengths → patch
    dict.  The log-mel runs in fp32; `dtype` applies to the patches."""
    spec = log_mel_spectrogram(audio_buf, front)
    num_valid_frames = num_stft_frames(num_valid_samples, front.hop_length)
    return patchify_spectrogram(spec, num_valid_frames, patch, dtype=dtype)
