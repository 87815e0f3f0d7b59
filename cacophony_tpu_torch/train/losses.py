"""Training objectives of both stages (cacophony_tpu/train/losses.py).

The reference ships no training code; the JAX package implements the
objectives its paper implies, with the repo's scoring rule
exp(logit_scale)·A@Tᵀ.  `softmax_cross_entropy_with_integer_labels` of
optax is logsumexp(logits) − logits[label], which is `F.cross_entropy`
without reduction.

Under a dp mesh each loss takes the dp process group and stands for the
loss of the global batch, as GSPMD makes JAX's (cacophony_tpu/train/
losses.py:7-10): the contrastive loss gathers both embeddings over the
group with a gather autograd sees (its backward sums over the ranks) and
is the whole B×B loss on every rank; a mask-weighted mean is this rank's
share, its masked sum over the group's count (all-reduced without
gradient), so the shares summed over the ranks are the global mean.

Under tensor parallelism every loss is replicated over the tp ranks (their
inputs are), except the caption cross-entropy over a vocab-parallel head:
each rank holds its block of the vocabulary's logits, and the row max, the
sum of exponentials and the target's logit are taken over the tp group
(Megatron's vocab-parallel cross-entropy).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cacophony_tpu_torch.parallel.mesh import GatherRows
from cacophony_tpu_torch.parallel.tensor import TPShard, all_reduce, reduce_from_tp


def _masked_mean(values: torch.Tensor, mask: torch.Tensor, group) -> torch.Tensor:
    """Σ values·mask / Σ mask, the count taken over the group's ranks."""
    m = mask.to(values.dtype)
    count = m.sum()
    if group is not None:
        count = all_reduce(count.detach().clone(), group)
    return (values * m).sum() / count.clamp_min(1.0)


def clip_contrastive_loss(audio_emb: torch.Tensor, text_emb: torch.Tensor,
                          logit_scale: torch.Tensor, group=None) -> torch.Tensor:
    """Symmetric InfoNCE over the (global) batch; embeddings (B, D)
    L2-normalized."""
    if group is not None:
        audio_emb = GatherRows.apply(audio_emb, group)
        text_emb = GatherRows.apply(text_emb, group)
    logits = torch.exp(logit_scale) * (audio_emb @ text_emb.T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_at = F.cross_entropy(logits, labels, reduction="none")
    l_ta = F.cross_entropy(logits.T, labels, reduction="none")
    return 0.5 * (l_at.mean() + l_ta.mean())


def vocab_parallel_cross_entropy(logits: torch.Tensor, target_ids: torch.Tensor,
                                 tp: TPShard) -> torch.Tensor:
    """logsumexp − the target's logit per position, over (B, S, V/tp)
    logits that hold this rank's block of the vocabulary: the row max is
    taken over tp (no gradient: any common shift gives the same loss), the
    sums of exponentials and the target's logit (from the rank that holds
    it, 0 elsewhere) are summed over tp.  → (B, S), the same on every rank."""
    v = logits.shape[-1]
    lo = tp.rank * v
    top = all_reduce(logits.detach().amax(dim=-1, keepdim=True), tp.group, dist.ReduceOp.MAX)
    shifted = logits - top
    sum_exp = reduce_from_tp(shifted.exp().sum(dim=-1), tp.group)
    target = target_ids.long()
    mine = (target >= lo) & (target < lo + v)
    picked = shifted.gather(-1, (target - lo).clamp(0, v - 1)[..., None])[..., 0]
    return sum_exp.log() - reduce_from_tp(torch.where(mine, picked, 0.0), tp.group)


def caption_cross_entropy(logits: torch.Tensor, target_ids: torch.Tensor,
                          target_mask: torch.Tensor, group=None,
                          tp: Optional[TPShard] = None) -> torch.Tensor:
    """Token-level CE over (B, S, V) logits, mask-weighted mean (this
    rank's share under a group).  With `tp` the logits are this rank's
    block of a vocab-parallel head (`vocab_parallel_cross_entropy`)."""
    if tp is not None:
        ce = vocab_parallel_cross_entropy(logits, target_ids, tp)
    else:
        ce = F.cross_entropy(logits.flatten(0, 1), target_ids.flatten().long(),
                             reduction="none").reshape(target_ids.shape)
    return _masked_mean(ce, target_mask, group)


def mae_reconstruction_loss(pred_patches: torch.Tensor, true_patches: torch.Tensor,
                            loss_mask: torch.Tensor,
                            normalize_target: bool = False, group=None) -> torch.Tensor:
    """MSE over the positions loss_mask marks (MAE: the masked ones; this
    rank's share under a group)."""
    target = true_patches
    if normalize_target:
        mu = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=False)
        target = (target - mu) / torch.sqrt(var + 1e-6)
    err = (pred_patches - target).square().mean(-1)
    return _masked_mean(err, loss_mask, group)
