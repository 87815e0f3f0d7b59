"""Shared building blocks: parameter modules and plain functions on tensors.

Parameters keep the JAX package's layout and names leaf for leaf — a dense
weight is `w` of shape (d_in, d_out) with bias `b`, a LayerNorm holds
`scale` and `bias` — so that `checkpoints/bridge.py` is a name map and the
CPU tests compare like with like.  The modules only hold parameters; the
math lives in plain functions (`dense`, `layer_norm`, ...) that mirror
`cacophony_tpu/models/layers.py`.

Initializers take an explicit `torch.Generator`; with `generator=None` a
module is built with zeros (the target of the bridge).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cacophony_tpu_torch.ops._kernels import layer_norm_plain

NEG_INF = -1e10  # mask bias value (reference roberta_text_model.py:200)


# ---------------------------------------------------------------- init utils

def normal_init(shape, generator: Optional[torch.Generator], stddev: float) -> torch.Tensor:
    """fp32 N(0, stddev²) tensor drawn from `generator`; zeros without one."""
    if generator is None:
        return torch.zeros(shape, dtype=torch.float32)
    return torch.randn(shape, generator=generator, dtype=torch.float32) * stddev


class Dense(nn.Module):
    """{w: (d_in, d_out), b: (d_out,)}.  Default init is lecun-normal
    (flax nn.Dense); pass stddev for the normal(0.02) text-tower inits."""

    def __init__(self, d_in: int, d_out: int,
                 generator: Optional[torch.Generator] = None,
                 stddev: Optional[float] = None):
        super().__init__()
        std = math.sqrt(1.0 / d_in) if stddev is None else stddev
        self.w = nn.Parameter(normal_init((d_in, d_out), generator, std))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=torch.float32))


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))


# ------------------------------------------------------------------- math

def dense(p: Dense, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w + b.  With `dtype`, all three are cast first (bf16 serving);
    without it the operands promote as in JAX (a bf16 x against fp32
    weights computes in fp32)."""
    w, b = p.w, p.b
    if dtype is None:
        dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype) + b.to(dtype)


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics; the output keeps x's dtype (the same
    math as K1's row LayerNorm, whose plain version this is)."""
    return layer_norm_plain(x, p.scale, p.bias, eps)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU (reference text act: ACT2FN['gelu'])."""
    return F.gelu(x, approximate="none")


def sincos_time_embedding(position_ids: torch.Tensor, dim: int) -> torch.Tensor:
    """angle = pos · 10000^(-2i/dim); concat [sin, cos] (reference mae.py:100-105)."""
    if dim % 2:
        raise ValueError(f"sin-cos embedding needs an even dim, got {dim}")
    inv_freq = torch.exp(
        torch.arange(dim // 2, dtype=torch.float32, device=position_ids.device)
        * (-2.0 * math.log(10000.0) / dim))
    angles = position_ids.float()[..., None] * inv_freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Boolean/int mask → additive attention bias (0 valid, NEG_INF masked)."""
    return torch.where(mask > 0, 0.0, NEG_INF).to(dtype)  # computed in fp32, then cast
