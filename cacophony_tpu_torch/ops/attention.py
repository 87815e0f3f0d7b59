"""Multi-head self-attention over fused-QKV params (cacophony_tpu/ops/attention.py).

Only the full-sequence self-attention with an additive bias is ported
(JAX `multi_head_attention`, `:132-133` and `:204-228`): the text tower runs
it with the causal+padding bias, and the audio encoder's "einsum" route
with a key mask (`flash_mask`) turned into a −1e30 bias (`:209-215`).  The
KV-cache decode branch and cross-attention come with the decoder slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cacophony_tpu_torch.models.layers import Dense, dense


class Attention(nn.Module):
    """Fused qkv (d, 3d) projection plus output projection."""

    def __init__(self, d_model: int, generator: Optional[torch.Generator] = None,
                 stddev: Optional[float] = None):
        super().__init__()
        self.qkv = Dense(d_model, 3 * d_model, generator, stddev)
        self.o = Dense(d_model, d_model, generator, stddev)


FLASH_MASK_BIAS = -1e30  # ops/attention.py:215


def multi_head_attention(p: Attention, x: torch.Tensor, *, num_heads: int,
                         bias: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = torch.float32,
                         flash_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, D) → (B, S, D).  bias: additive, broadcastable to (B, H, S, S),
    added to the logits in the compute dtype; softmax runs in fp32.  Without
    a bias, `flash_mask` (B, S) (>0 = valid key) becomes the bias 0 / −1e30."""
    b, s, d = x.shape
    head_dim = d // num_heads
    qkv = dense(p.qkv, x, dtype)
    q, k, v = (t.reshape(b, s, num_heads, head_dim) for t in qkv.split(d, dim=-1))
    # 1 / sqrt(Dh) computed in q's dtype, then used as a Python number: a
    # small tensor copied to the card would wait for the device
    q = q * float(1.0 / torch.tensor(float(head_dim)).sqrt().to(q.dtype))
    if bias is None and flash_mask is not None:
        bias = torch.where(flash_mask[:, None, None, :] > 0, 0.0, FLASH_MASK_BIAS)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, d)
    return dense(p.o, out, dtype)
