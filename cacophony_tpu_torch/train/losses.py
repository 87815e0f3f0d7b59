"""Training objectives of both stages (cacophony_tpu/train/losses.py).

The reference ships no training code; the JAX package implements the
objectives its paper implies, with the repo's scoring rule
exp(logit_scale)·A@Tᵀ.  `softmax_cross_entropy_with_integer_labels` of
optax is logsumexp(logits) − logits[label], which is `F.cross_entropy`
without reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip_contrastive_loss(audio_emb: torch.Tensor, text_emb: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch; embeddings (B, D) L2-normalized."""
    logits = torch.exp(logit_scale) * (audio_emb @ text_emb.T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_at = F.cross_entropy(logits, labels, reduction="none")
    l_ta = F.cross_entropy(logits.T, labels, reduction="none")
    return 0.5 * (l_at.mean() + l_ta.mean())


def caption_cross_entropy(logits: torch.Tensor, target_ids: torch.Tensor,
                          target_mask: torch.Tensor) -> torch.Tensor:
    """Token-level CE over (B, S, V) logits, mask-weighted mean."""
    ce = F.cross_entropy(logits.flatten(0, 1), target_ids.flatten().long(),
                         reduction="none").reshape(target_ids.shape)
    m = target_mask.to(ce.dtype)
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def mae_reconstruction_loss(pred_patches: torch.Tensor, true_patches: torch.Tensor,
                            loss_mask: torch.Tensor,
                            normalize_target: bool = False) -> torch.Tensor:
    """MSE over the positions loss_mask marks (MAE: the masked ones)."""
    target = true_patches
    if normalize_target:
        mu = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=False)
        target = (target - mu) / torch.sqrt(var + 1e-6)
    err = (pred_patches - target).square().mean(-1)
    m = loss_mask.to(err.dtype)
    return (err * m).sum() / m.sum().clamp_min(1.0)
