"""Multi-head attention over fused-QKV params (cacophony_tpu/ops/attention.py).

The full-sequence branches of the JAX `multi_head_attention` (`:89-137`,
`:204-228`):
- the kernel routes, taken when a key mask (`flash_mask`) is given and
  attention dropout is off: a one-shot plan runs K4 over the fused QKV
  (`ops.encoder_attention.encoder_attention`, optionally causal), a blocked
  plan K5 over Q and K|V from the fused weight split into its columns
  (`encoder_attention_blocked`; not causal);
- the einsum route: an additive bias (or one rebuilt from `flash_mask`
  with −1e30, plus the causal triangle), softmax in fp32, optional
  attention-probability dropout;
- cross-attention: q from x, K|V from `memory` (params `q`, `kv`, `o`).
The KV-cache decode branch comes with the decode slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cacophony_tpu_torch.models.layers import Dense, dense, dropout
from cacophony_tpu_torch.ops import encoder_attention as ea


class Attention(nn.Module):
    """Fused qkv (d, 3d) projection plus output projection."""

    def __init__(self, d_model: int, generator: Optional[torch.Generator] = None,
                 stddev: Optional[float] = None):
        super().__init__()
        self.qkv = Dense(d_model, 3 * d_model, generator, stddev)
        self.o = Dense(d_model, d_model, generator, stddev)


class CrossAttention(nn.Module):
    """q (d, d) from the queries' source, fused kv (d, 2d) from the memory, o."""

    def __init__(self, d_model: int, generator: Optional[torch.Generator] = None,
                 stddev: Optional[float] = None):
        super().__init__()
        self.q = Dense(d_model, d_model, generator, stddev)
        self.kv = Dense(d_model, 2 * d_model, generator, stddev)
        self.o = Dense(d_model, d_model, generator, stddev)


FLASH_MASK_BIAS = -1e30  # ops/attention.py:215


def _dense_cols(p: Dense, x: torch.Tensor, dtype, lo: int, hi: int) -> torch.Tensor:
    """x @ w[:, lo:hi] + b[lo:hi] (the fused weight split into columns)."""
    w, b = p.w[:, lo:hi], p.b[lo:hi]
    return x.to(dtype) @ w.to(dtype) + b.to(dtype)


def multi_head_attention(p, x: torch.Tensor, *, num_heads: int,
                         bias: Optional[torch.Tensor] = None,
                         memory: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = torch.float32,
                         flash_mask: Optional[torch.Tensor] = None,
                         causal: bool = False, dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, S, D) → (B, S, D).  bias: additive, broadcastable to (B, H, S, S),
    added to the logits in the compute dtype.  Without a bias, `flash_mask`
    (B, S) (>0 = valid key) picks a kernel route or becomes the bias
    0 / −1e30 (with the causal triangle when `causal`).  `memory` makes it
    cross-attention (params `q`, `kv`, `o`)."""
    b, s, d = x.shape
    head_dim = d // num_heads
    if memory is None:
        plan = ea.kernel_plan(s, d, dtype if dtype is not None else x.dtype)
        use_kernel = flash_mask is not None and dropout_rate == 0.0 and plan is not None
        if use_kernel and plan[0] == "one_shot":
            out = ea.encoder_attention(dense(p.qkv, x, dtype), flash_mask, num_heads, causal)
            return dense(p.o, out, dtype)
        if use_kernel and plan[0] == "blocked" and not causal:
            q_out = _dense_cols(p.qkv, x, dtype, 0, d)
            kv_out = _dense_cols(p.qkv, x, dtype, d, 3 * d)
            out = ea.encoder_attention_blocked(q_out, kv_out, flash_mask, num_heads)
            return dense(p.o, out, dtype)
        q, k, v = dense(p.qkv, x, dtype).split(d, dim=-1)
    else:
        q = dense(p.q, x, dtype)
        k, v = dense(p.kv, memory, dtype).split(d, dim=-1)
    q, k, v = (t.reshape(b, t.shape[1], num_heads, head_dim) for t in (q, k, v))
    # 1 / sqrt(Dh) computed in q's dtype, then used as a Python number: a
    # small tensor copied to the card would wait for the device
    q = q * float(1.0 / torch.tensor(float(head_dim)).sqrt().to(q.dtype))
    if bias is None and flash_mask is not None:
        allowed = flash_mask[:, None, None, :] > 0
        if causal:
            allowed = allowed & torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        bias = torch.where(allowed, 0.0, FLASH_MASK_BIAS)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    if dropout_rate > 0.0 and generator is not None:
        weights = dropout(generator, weights, dropout_rate, False)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, d)
    return dense(p.o, out, dtype)
