"""Shared building blocks: parameter modules and plain functions on tensors.

Parameters keep the JAX package's layout and names leaf for leaf — a dense
weight is `w` of shape (d_in, d_out) with bias `b`, a LayerNorm holds
`scale` and `bias` — so that `checkpoints/bridge.py` is a name map and the
CPU tests compare like with like.  The modules only hold parameters; the
math lives in plain functions (`dense`, `layer_norm`, ...) that mirror
`cacophony_tpu/models/layers.py`.

Initializers take an explicit `torch.Generator`; with `generator=None` a
module is built with zeros (the target of the bridge).

Training pieces (JAX layers.py:70-224): `layer_norm` and `act_dense` carry
the JAX package's custom backwards (`CUSTOM_VJP = True`, its default) as
`torch.autograd.Function`s, and `dropout` / `drop_path` draw their masks
from an explicit `torch.Generator` (`DROPOUT_RECOMPUTE = False`, its
default: the masks are kept for the backward by autograd).

Tensor parallelism: a Dense that `parallel.shard_params` sharded carries a
`TPShard` (parallel/tensor.py), and `dense` / `act_dense` run it as
Megatron does — a column-parallel layer takes `copy_to_tp` of its input, a
row-parallel layer sums its partial products over tp (`reduce_from_tp`)
and adds its bias once, after the sum.  `dropout` over a sharded
activation draws its mask at the global shape and keeps this rank's block,
so the generator advances as in one process and draws the same masks.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cacophony_tpu_torch.parallel.tensor import TPShard, copy_to_tp, reduce_from_tp, tp_shard


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

def tp_input(p, x: torch.Tensor) -> torch.Tensor:
    """x as a column-parallel Dense `p` takes it: `copy_to_tp(x)` where p
    is column-sharded, else x."""
    tp = tp_shard(p)
    return copy_to_tp(x, tp.group) if tp is not None and tp.column else x


def _row_output(p, partial: torch.Tensor) -> torch.Tensor:
    """A row-parallel Dense's partial product summed over tp, plus its bias."""
    return reduce_from_tp(partial, tp_shard(p).group) + p.b.to(partial.dtype)


def dense(p: Dense, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w + b.  With `dtype`, all three are cast first (bf16 serving);
    without it the operands promote as in JAX (a bf16 x against fp32
    weights computes in fp32).  A tp-sharded Dense runs column- or
    row-parallel (module docstring)."""
    w, b = p.w, p.b
    if dtype is None:
        dtype = torch.promote_types(x.dtype, w.dtype)
    tp = tp_shard(p)
    if tp is not None and not tp.column:
        return _row_output(p, x.to(dtype) @ w.to(dtype))
    return tp_input(p, x).to(dtype) @ w.to(dtype) + b.to(dtype)


def cast_dense(module: nn.Module, dtype: torch.dtype):
    """`module`'s parameter tree with every Dense weight and bias cast to
    `dtype` once, as namespaces the plain functions read like the modules.
    `dense` casts the same way on every call, so the values are identical;
    LayerNorm parameters and embedding tables are shared as they are (fp32
    statistics, fp32 embeddings before the cast).  Decode calls it once per
    batch instead of casting the weights again in every step."""
    if isinstance(module, Dense):
        return SimpleNamespace(w=module.w.detach().to(dtype), b=module.b.detach().to(dtype))
    if isinstance(module, nn.ModuleList):
        return [cast_dense(m, dtype) for m in module]
    if not module._modules:
        return module
    out = SimpleNamespace(**dict(module.named_parameters(recurse=False)))
    for name, child in module.named_children():
        setattr(out, name, cast_dense(child, dtype))
    return out


class _LayerNorm(torch.autograd.Function):
    """JAX `_ln` (layers.py:96-130): the forward of `layer_norm_plain`; the
    backward recomputes x̂ in fp32 from the saved x, mean and rsqrt."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        r = torch.rsqrt((x32 - mean).square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, mean, r)
        return ((x32 - mean) * r * scale + bias).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, r = ctx.saved_tensors
        g32 = g.float()
        xhat = (x.float() - mean) * r
        lead = tuple(range(g32.dim() - 1))
        dscale, dbias = (g32 * xhat).sum(dim=lead), g32.sum(dim=lead)
        dy = g32 * scale
        dx = r * (dy - dy.mean(dim=-1, keepdim=True)
                  - xhat * (dy * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype), None


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics; the output keeps x's dtype (the same
    math as K1's row LayerNorm, `layer_norm_plain`), with the JAX package's
    recomputing backward."""
    return _LayerNorm.apply(x, p.scale, p.bias, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x) in x's dtype, as jax.nn.silu writes it."""
    return x * torch.sigmoid(x)


class _ActDense(torch.autograd.Function):
    """JAX `_act_dense` (layers.py:147-182): dense(p, act(h)) whose backward
    recomputes act and its VJP from h; dw and db are computed in the compute
    dtype and then cast to the parameters' dtype.  Without a bias (b None:
    a row-parallel layer, whose bias is added after the sum over tp) it is
    act(h) @ w."""

    @staticmethod
    def forward(ctx, h, w, b, act, dtype):
        dt = dtype if dtype is not None else torch.promote_types(h.dtype, w.dtype)
        ctx.save_for_backward(h, w)
        ctx.act, ctx.dt, ctx.b_dtype = act, dt, None if b is None else b.dtype
        out = act(h).to(dt) @ w.to(dt)
        return out if b is None else out + b.to(dt)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dt = ctx.dt
        with torch.enable_grad():
            hh = h.detach().requires_grad_()
            a = ctx.act(hh)
        a2 = a.detach().reshape(-1, a.shape[-1]).to(dt)
        g2 = g.reshape(-1, g.shape[-1]).to(dt)
        dw = (a2.T @ g2).to(w.dtype)
        db = None if ctx.b_dtype is None else g2.sum(dim=0).to(ctx.b_dtype)
        da = (g.to(dt) @ w.to(dt).T).to(a.dtype)
        (dh,) = torch.autograd.grad(a, hh, da)
        return dh, dw, db, None, None


def act_dense(p: Dense, h: torch.Tensor, act, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`dense(p, act(h), dtype)` whose backward keeps only h (JAX `act_dense`)."""
    tp = tp_shard(p)
    if tp is not None and not tp.column:
        return _row_output(p, _ActDense.apply(h, p.w, None, act, dtype))
    return _ActDense.apply(h, p.w, p.b, act, dtype)


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool, tp: Optional[TPShard] = None, dim: int = -1) -> torch.Tensor:
    """Inverted dropout (JAX layers.py:190-207): keep each value with
    probability 1 − rate, scaled by 1/(1 − rate).  The mask is drawn from
    `generator`, which lives on x's device.  With `tp`, x is this rank's
    block along `dim` of a sharded activation: the mask is drawn at the
    global shape and this rank's block kept."""
    if deterministic or rate == 0.0:
        return x
    shape = list(x.shape)
    if tp is not None:
        shape[dim] *= tp.size
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    if tp is not None:
        keep = keep.narrow(dim, tp.rank * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), 0.0)


def drop_path(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
              deterministic: bool) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch of a sample with
    probability `rate` (JAX layers.py:210-224, reference mae.py:35-53)."""
    if deterministic or rate == 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


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
