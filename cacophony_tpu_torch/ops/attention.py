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
- cross-attention: q from x, K|V from `memory` (params `q`, `kv`, `o`);
- the read-only KV-cache branch of decode (`:143-202`, the merged (B, T, E)
  layout): one query position attends over the cached positions the bias
  leaves open plus its own fresh k/v, and the (B, 1, E) k/v slice goes
  back to the caller, who writes it into the cache.

Under tensor parallelism (the fused QKV or K|V Dense tp-sharded by
`parallel.shard_params`) each rank runs its H/tp heads: the column-parallel
QKV gives their q, k and v, the row-parallel o-projection sums the heads'
outputs over tp.  The route (K4, K5 or the einsum) is decided on the full
width, as JAX decides it on its global shapes, and the kernel runs on the
local heads.  Cross-attention's q Dense is replicated (no rule shards it):
every rank computes the whole q and keeps its heads' columns through
`copy_to_tp`, so q's gradient is summed over tp and its leaves' gradients
come out whole and equal on every rank.  Attention-probability dropout
draws its mask at the global (B, H, S, S) shape and keeps this rank's
heads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cacophony_tpu_torch.models.layers import Dense, dense, dropout, tp_input
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.parallel.tensor import TPShard, copy_to_tp, tp_shard


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
    """x @ w[:, lo:hi] + b[lo:hi] (the fused weight split into columns; x
    is already the column-parallel input under tp)."""
    w, b = p.w[:, lo:hi], p.b[lo:hi]
    return x.to(dtype) @ w.to(dtype) + b.to(dtype)


def _scale_q(q: torch.Tensor, head_dim: int) -> torch.Tensor:
    """q · 1/√Dh, the factor computed in q's dtype and then used as a Python
    number (a small tensor copied to the card would wait for the device)."""
    return q * float(1.0 / torch.tensor(float(head_dim)).sqrt().to(q.dtype))


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     bias: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """One query position against a read-only cache plus its own k/v (JAX
    ops/attention.py:170-199, merged layout).  q, k, v: (B, 1, E); cache_k,
    cache_v: (B, T, E), cast to q's dtype; bias: additive over the T cached
    positions, (1 or B, 1, 1, T), added in the logits' dtype → (B, 1, E).

    Per-head products on the cache viewed as (B, T, H, Dh); the current
    token's logit goes last, the softmax runs in fp32 and is cast back, and
    out = w_past · V_cache + v · w_self."""
    b, s, e = q.shape
    hd = e // num_heads
    q = _scale_q(q.reshape(b, s, num_heads, hd), hd)
    k = k.reshape(b, s, num_heads, hd)
    v = v.reshape(b, s, num_heads, hd)
    ck = cache_k.to(q.dtype).reshape(b, -1, num_heads, hd)
    cv = cache_v.to(q.dtype).reshape(b, -1, num_heads, hd)
    logits_past = torch.einsum("bqhd,bthd->bhqt", q, ck)
    if bias is not None:
        logits_past = logits_past + bias.to(logits_past.dtype)
    logits_self = torch.einsum("bqhd,bqhd->bhq", q, k)[..., None]
    logits = torch.cat([logits_past, logits_self], dim=-1)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    w_past, w_self = weights[..., :-1], weights[..., -1]
    out = torch.einsum("bhqt,bthd->bqhd", w_past, cv)
    out = out + v * w_self.transpose(1, 2)[..., None]
    return out.reshape(b, s, e)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
           num_heads: int, dropout_rate: float = 0.0,
           generator: Optional[torch.Generator] = None,
           tp: Optional[TPShard] = None) -> torch.Tensor:
    """Heads of (B, Sq, E) queries over keys and values → (B, Sq, E): q
    scaled by 1/√Dh, the additive bias in the logits' dtype, softmax in fp32
    cast back, optional attention-probability dropout.  k, v: (B, Sk, E), or
    head-major (B, H, Sk, Dh), which the per-head products read in place
    (the decoder's precomputed cross K/V, read in every decode step).
    With `tp`, the heads are this rank's block of tp.size·num_heads: the
    dropout mask is drawn for all of them."""
    b, s, d = q.shape
    head_dim = d // num_heads
    q = _scale_q(q.reshape(b, s, num_heads, head_dim), head_dim)
    keys = "bhkd" if k.dim() == 4 else "bkhd"
    if k.dim() == 3:
        k, v = (t.reshape(b, t.shape[1], num_heads, head_dim) for t in (k, v))
    logits = torch.einsum(f"bqhd,{keys}->bhqk", q, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    if dropout_rate > 0.0 and generator is not None:
        weights = dropout(generator, weights, dropout_rate, False, tp=tp, dim=1)
    return torch.einsum(f"bhqk,{keys}->bqhd", weights, v).reshape(b, s, d)


def multi_head_attention(p, x: torch.Tensor, *, num_heads: int,
                         bias: Optional[torch.Tensor] = None,
                         memory: Optional[torch.Tensor] = None,
                         kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         dtype: Optional[torch.dtype] = torch.float32,
                         flash_mask: Optional[torch.Tensor] = None,
                         causal: bool = False, dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None):
    """(B, S, D) → (B, S, D).  bias: additive, broadcastable to (B, H, S, S),
    added to the logits in the compute dtype.  Without a bias, `flash_mask`
    (B, S) (>0 = valid key) picks a kernel route or becomes the bias
    0 / −1e30 (with the causal triangle when `causal`).  `memory` makes it
    cross-attention (params `q`, `kv`, `o`).

    Decode (`kv_cache` = (k, v), each (B, T, E)): S must be 1, the cache is
    read only (the bias must close the positions at and past the write
    index, text._decode_bias), and the call returns (out, (k, v)) with the
    current token's (B, 1, E) k/v for the caller to write."""
    b, s, d = x.shape
    tp = tp_shard(p.qkv if memory is None else p.kv)
    heads, width = num_heads, d  # this rank's heads and their width
    if tp is not None:
        if num_heads % tp.size:
            raise ValueError(f"tp={tp.size} does not divide {num_heads} heads")
        heads, width = num_heads // tp.size, d // tp.size
    if kv_cache is not None:
        if s != 1 or memory is not None:
            raise ValueError("KV-cached attention takes one query position and no memory")
        q, k, v = dense(p.qkv, x, dtype).split(d, dim=-1)
        out = cached_attention(q, k, v, kv_cache[0], kv_cache[1], bias, num_heads)
        return dense(p.o, out, dtype), (k, v)
    if memory is None:
        plan = ea.kernel_plan(s, d, dtype if dtype is not None else x.dtype)
        use_kernel = flash_mask is not None and dropout_rate == 0.0 and plan is not None
        if use_kernel and plan[0] == "one_shot":
            out = ea.encoder_attention(dense(p.qkv, x, dtype), flash_mask, heads, causal, width=d)
            return dense(p.o, out, dtype)
        if use_kernel and plan[0] == "blocked" and not causal:
            xin = tp_input(p.qkv, x)
            q_out = _dense_cols(p.qkv, xin, dtype, 0, width)
            kv_out = _dense_cols(p.qkv, xin, dtype, width, 3 * width)
            out = ea.encoder_attention_blocked(q_out, kv_out, flash_mask, heads, width=d)
            return dense(p.o, out, dtype)
        q, k, v = dense(p.qkv, x, dtype).split(width, dim=-1)
    else:
        q = dense(p.q, x, dtype)
        if tp is not None:
            q = copy_to_tp(q, tp.group)[..., tp.block(d)]
        k, v = dense(p.kv, memory, dtype).split(width, dim=-1)
    if bias is None and flash_mask is not None:
        allowed = flash_mask[:, None, None, :] > 0
        if causal:
            allowed = allowed & torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        bias = torch.where(allowed, 0.0, FLASH_MASK_BIAS)
    out = attend(q, k, v, bias, heads, dropout_rate, generator, tp)
    return dense(p.o, out, dtype)
