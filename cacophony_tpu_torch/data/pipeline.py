"""The training frontend (cacophony_tpu/data/pipeline.py:40-77): waveform
buffers → patches on the device → a random sorted subset of `seq_len`
patches per clip.

For clips with at most `seq_len` valid patches the subset is the first N
plus padding (the eval path's patches); longer clips keep a uniformly
random sorted subset, as the reference training pipeline does
(dataset.py:78-87), drawn from an explicit `torch.Generator` on the
batch's device.  The host-side loader (`CacoTrainLoader`) comes with the
runner slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend.patchify import wav_to_patches


def subsample_patches(generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
                      seq_len: int) -> Dict[str, torch.Tensor]:
    """Batched random patch subsampling: leaves (B, S_full, ...) → (B, seq_len, ...).
    Invalid patches sort last (noise 2.0, stable sort), so a clip with at
    most seq_len valid patches keeps them all, in order, then padding."""
    x, mask = batch["audio_patches"], batch["audio_mask"]
    b, s_full, _ = x.shape
    noise = torch.rand((b, s_full), generator=generator, device=x.device)
    noise = torch.where(mask > 0, noise, 2.0)
    chosen = torch.argsort(noise, dim=1, stable=True)[:, :seq_len].sort(dim=1).values
    new_mask = mask.gather(1, chosen)
    return {
        "audio_patches": x.gather(1, chosen[..., None].expand(-1, -1, x.shape[-1]))
        * new_mask[..., None].to(x.dtype),
        "audio_time_inds": batch["audio_time_inds"].gather(1, chosen) * new_mask,
        "audio_freq_inds": batch["audio_freq_inds"].gather(1, chosen) * new_mask,
        "audio_mask": new_mask,
    }


def device_train_frontend(front: FrontendConfig, full_patch: PatchConfig, seq_len: int):
    """→ fn(generator, bufs (B, samples), lens (B,)) → the training patch
    batch: every patch of the buffer (`full_patch`), then `subsample_patches`."""

    def fn(generator: Optional[torch.Generator], bufs: torch.Tensor, lens: torch.Tensor):
        return subsample_patches(generator, wav_to_patches(bufs, lens, front, full_patch), seq_len)

    return fn
