"""The audio encoder's attention kernels — the fused layer chains K1, K2,
K3 and the stand-alone attention K4 / K5 with K4's backward K7 — and the
route decisions that pick among them, as the JAX package computes them.

**Which computation a layer performs.**  The JAX package decides per layer
(`_vit_block`, cacophony_tpu/models/audio.py:150-185) among its Pallas
kernels and an XLA einsum path, by a model of the TPU's VMEM
(`kernel_plan`, `fused_block_fits`, `fused_block_blocked_fits`,
`fused_ln_fits`, encoder_attention.py:88-134, :577-591, :746-760,
:1066-1076, gated by the `try_*` functions at :897-1018).  Those choices
change where values are rounded: K1 adds fp32 biases inside the kernel,
while the MLP that runs outside K2 and K3 rounds `x @ w` to the compute
dtype before its bias.  `layer_route` therefore ports the decision itself.
It states which computation the reference performs at a given shape; it
is not capacity planning for Hopper, whose kernels have no VMEM budget.

**K1** (`_fused_block_kernel` with with_mlp=True, :514) computes

    xn  = T(LN1(x))                        fp32 statistics
    qkv = T(xn @ Wqkv + bqkv)              fp32 accumulation, fp32 bias
    att = attention(qkv, mask)             q scaled in T; max-free softmax with
                                           the clamp at 80 and the 2^-24 V
                                           pre-scale; fully masked rows → 0
    yb  = T(att @ Wo + bo + f32(x))        the residual is added in fp32
    yn  = T(LN2(yb))                       statistics from the cast y
    h1  = T(silu_f32(yn @ W1 + b1))
    out = T(f32(yb) + f32(T(h1 @ W2 + b2)))

with T the compute dtype (bf16 or fp32) and every bias and LayerNorm
parameter in fp32.  **K2** (the same kernel with with_mlp=False) stops at
LN2 and returns (yb, yn).  **K3** (`_fused_block_kernel_blocked`, :674,
with_mlp=False) is K2 over a row padded to a multiple of the q-block
(256): the padded keys are masked and the padded query rows sliced away.
Its blocked softmax keeps the deferred normalisation with the 2^-24 V
pre-scale (`BLOCKED_DEFER_NORM`), so its numerics are K2's.

On Hopper a layer cannot be one kernel: a 768x3072 weight pair is 9.4 MB
in bf16 against 227 KB of shared memory per block.  So each is a chain of
hand-written kernels that meet in device memory (ops/_kernels.py, csrc/):
(a) a row LayerNorm for LN1 and LN2, (b) a tiled GEMM with fused
epilogues, (c) a flash-style masked attention.  The attention is already
tiled over queries, which is all that K3's "QKV once per row into scratch,
then per q-block" becomes here.

**K3′** (the blocked kernel with with_mlp=True) is the K1 chain over the
padded row, its MLP epilogues on the padded rows (`_mlp_tail` per q-block
is the same math row by row).  **K6** (`_fused_ln_kernel`, :391) is the
first three links of the chain: LN1 → QKV → attention, the output before
the o-projection.

The entry points are JAX's: `fused_layer` (K1, K3′ by its variant),
`fused_block_attention` (K2, K3) and `fused_ln_attention`
(K6), with the gates `try_fused_layer`, `try_fused_block_attention` and
`try_fused_ln_attention`, which decline exactly where JAX's do.  Each runs
the kernels on a CUDA tensor (or raises) and their plain PyTorch versions
on a CPU tensor, and each is differentiable as JAX's `custom_vjp` is: the
backward is autograd of the plain port of `_xla_layer`, `_xla_block` or
`_xla_ln_attention`, recomputed from the saved inputs, with the textbook
softmax of `xla_attention` inside (a fully masked row gets uniform weights
there, not the chain's 0).  The `*_plain` functions run the plain chain on
any device (the reference the `cuda`-marked tests hold the kernels to).

**K4, K5 and K7** are what training reaches (`multi_head_attention`,
ops/attention.py, for a one-shot or blocked plan).  `encoder_attention` is
K4 as a `torch.autograd.Function` whose backward is K7 when the reference's
`bwd_fits_vmem` holds, and otherwise autograd through `xla_attention`, the
textbook softmax with −1e30 masking that JAX's rematerialising backward
differentiates (encoder_attention.py:1223-1238).  `encoder_attention_blocked`
is K5 (JAX pads Q and K|V to the blocked plan's length, masks the padded
keys and slices the padded query rows away; the kernel, run at the clip
length, gives the same output without the padding copies); its backward
is autograd through `xla_attention_split` at the unpadded length
(:1276-1287).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from cacophony_tpu_torch.ops import _kernels as kern

# Chains launched on the card: K1 and K3′ whole layers, K2 and K3 block
# halves, K6 (LN1 → QKV → attention).
LAYER_LAUNCHES = {"k1_layer": 0, "k3_layer": 0, "k2_block": 0, "k3_block": 0, "k6_attn": 0}

# The JAX package's constants for its route decision (encoder_attention.py).
VMEM_BUDGET_BYTES = 15 * 1024 * 1024
BLOCK_KERNEL_BUDGET = 60 * 1024 * 1024
FUSED_BLOCKED_Q_BLOCK = 256

_KERNEL_OPS = SimpleNamespace(layer_norm=kern.layer_norm, gemm=kern.gemm,
                              attention=kern.attention)
_PLAIN_OPS = SimpleNamespace(layer_norm=kern.layer_norm_plain, gemm=kern.gemm_plain,
                             attention=kern.attention_plain)


# ----------------------------------------------------------- route decision

def _esize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kernel_plan(seq: int, d_model: int, dtype: torch.dtype):
    """("one_shot", seq, seq), ("blocked", padded_seq, q_block) or None
    (encoder_attention.py:88)."""
    e = _esize(dtype)

    def one_shot_fits(s):
        blocks = s * 3 * d_model * e + s * d_model * e
        return 2 * blocks + s * s * 4 + s * s * e <= VMEM_BUDGET_BYTES

    def blocked_fits(s_pad, qb):
        blocks = s_pad * 2 * d_model * e + 2 * qb * d_model * e
        return 2 * blocks + qb * s_pad * 4 + qb * s_pad * e <= VMEM_BUDGET_BYTES

    if one_shot_fits(seq):
        return "one_shot", seq, seq
    for qb in (512, 256, 128):
        s_pad = -(-seq // qb) * qb
        if blocked_fits(s_pad, qb):
            return "blocked", s_pad, qb
    return None


def fused_block_fits(seq: int, d_model: int, dtype: torch.dtype, intermediate: int = 0) -> bool:
    """encoder_attention.py:577; `intermediate` > 0 adds the in-kernel MLP."""
    e = _esize(dtype)
    blocks = (3 * seq * d_model * e + d_model * 3 * d_model * e + d_model * d_model * e
              + 2 * d_model * intermediate * e)
    scratch = (seq * 3 * d_model * e + seq * seq * 4 + seq * seq * e + 2 * seq * d_model * 4
               + seq * intermediate * (4 + e))
    return 2 * blocks + scratch <= BLOCK_KERNEL_BUDGET


def fused_block_blocked_fits(s_pad: int, qb: int, d: int, dtype: torch.dtype,
                             intermediate: int = 0) -> bool:
    """encoder_attention.py:749."""
    e = _esize(dtype)
    blocks = (s_pad * d + d * 3 * d + d * d + 2 * d * intermediate + 2 * qb * d) * e
    scratch = (s_pad * 3 * d * e + qb * s_pad * (4 + e) + 2 * qb * d * 4
               + qb * intermediate * (4 + e))
    return 2 * blocks + scratch <= BLOCK_KERNEL_BUDGET


def fused_ln_fits(seq: int, d_model: int, dtype: torch.dtype) -> bool:
    """encoder_attention.py:1066."""
    e = _esize(dtype)
    blocks = 2 * seq * d_model * e + d_model * 3 * d_model * e
    scratch = seq * 3 * d_model * e + seq * seq * 4 + seq * seq * e
    return 2 * blocks + scratch <= VMEM_BUDGET_BYTES


def fused_variant(seq: int, d_model: int, dtype: torch.dtype, intermediate: int = 0,
                  allow_blocked: bool = True):
    """The variant JAX's `try_fused_block_attention` (intermediate 0, :897)
    or `try_fused_layer` (:978) runs at this shape — ("one_shot",) or
    ("blocked", FUSED_BLOCKED_Q_BLOCK) — or None where it declines."""
    plan = kernel_plan(seq, d_model, dtype)
    if plan is None:
        return None
    if plan[0] == "one_shot":
        return ("one_shot",) if fused_block_fits(seq, d_model, dtype, intermediate) else None
    qb = FUSED_BLOCKED_Q_BLOCK
    s_pad = -(-seq // qb) * qb
    if allow_blocked and fused_block_blocked_fits(s_pad, qb, d_model, dtype, intermediate):
        return "blocked", qb
    return None


def fused_ln_attention_applies(seq: int, d_model: int, dtype: torch.dtype) -> bool:
    """Whether JAX's `try_fused_ln_attention` (:1079) runs K6: a one-shot
    plan within `fused_ln_fits`."""
    plan = kernel_plan(seq, d_model, dtype)
    return plan is not None and plan[0] == "one_shot" and fused_ln_fits(seq, d_model, dtype)


def layer_route(seq: int, d_model: int, intermediate: int,
                dtype: torch.dtype) -> Tuple[str, int]:
    """→ (route, padded_len): which computation the JAX package performs for
    an inference encoder layer over (B, seq, d_model) in `dtype`, in the
    order `_vit_block` tries them (models/audio.py:161-185):

    "k1"      whole layer in one kernel (`try_fused_layer`, one-shot plan)
    "k2"      block half in one kernel, MLP outside (`try_fused_block_attention`)
    "k3"      K2 over a row padded to padded_len (blocked plan)
    "k6"      LN1 + QKV + attention kernel, the rest outside (`try_fused_ln_attention`)
    "k4"      one-shot attention kernel only (`encoder_attention`)
    "k5"      q-blocked attention kernel only (`encoder_attention_blocked`)
    "einsum"  no kernel (`kernel_plan` is None): XLA einsum attention

    padded_len is the length the chosen kernel runs at (seq except for K3
    and K5).  It states the reference's computation, not Hopper capacity."""
    plan = kernel_plan(seq, d_model, dtype)
    if plan is None:
        return "einsum", seq
    if fused_variant(seq, d_model, dtype, intermediate, allow_blocked=False) is not None:
        return "k1", seq
    variant = fused_variant(seq, d_model, dtype)
    if variant is not None:
        return ("k2", seq) if variant[0] == "one_shot" else ("k3", -(-seq // variant[1]) * variant[1])
    if fused_ln_attention_applies(seq, d_model, dtype):
        return "k6", seq
    return ("k4", seq) if plan[0] == "one_shot" else ("k5", plan[1])


def bwd_fits_vmem(seq: int, d_model: int, dtype: torch.dtype) -> bool:
    """Whether JAX's K4 backward is the Pallas kernel K7 (encoder_attention.py:1172)
    rather than XLA rematerialisation: qkv + g in, d_qkv out, double-buffered,
    plus two fp32 (S, S) tiles and one in the compute dtype."""
    e = _esize(dtype)
    blocks = seq * 3 * d_model * e * 2 + seq * d_model * e
    return 2 * blocks + 2 * seq * seq * 4 + seq * seq * e <= VMEM_BUDGET_BYTES


def preferred_seq_len(seq: int, d_model: int, dtype: torch.dtype) -> int:
    """The engine's patch budget: rounded up to the blocked plan's padded
    length, as the JAX engine sizes it (runtime/engine.py:82-89); unchanged
    for one-shot and no-kernel plans."""
    plan = kernel_plan(seq, d_model, dtype)
    return plan[1] if plan is not None and plan[0] == "blocked" else seq


# -------------------------------------------------------------- the chains

# A chain's parameters by their names in ViTBlock (the JAX tree's leaves).
_LN_QKV = ("ln1.scale", "ln1.bias", "attn.qkv.w", "attn.qkv.b")
_BLOCK = _LN_QKV + ("attn.o.w", "attn.o.b", "ln2.scale", "ln2.bias")
_LAYER = _BLOCK + ("mlp.w1.w", "mlp.w1.b", "mlp.w2.w", "mlp.w2.b")


def _w(w, dt):
    return w.to(dt).contiguous()


def _b(p):
    return p.to(torch.float32).contiguous()


def _ln_attention(ops, p, x, mask, num_heads: int, eps: float):
    """LN1 → QKV → attention: K6, and the first links of K1, K2 and K3."""
    xn = ops.layer_norm(x, _b(p["ln1.scale"]), _b(p["ln1.bias"]), eps)
    qkv = ops.gemm(xn, _w(p["attn.qkv.w"], x.dtype), _b(p["attn.qkv.b"]), kern.EPI_BIAS)
    return ops.attention(qkv, mask, num_heads)


def _block(ops, p, x, mask, num_heads: int, eps: float):
    """… → o-proj + fp32 residual → LN2: (yb, yn)."""
    att = _ln_attention(ops, p, x, mask, num_heads, eps)
    yb = ops.gemm(att, _w(p["attn.o.w"], x.dtype), _b(p["attn.o.b"]), kern.EPI_BIAS_RESID_F32, x)
    yn = ops.layer_norm(yb, _b(p["ln2.scale"]), _b(p["ln2.bias"]), eps)
    return yb, yn


def _layer(ops, p, x, mask, num_heads: int, eps: float):
    dt = x.dtype
    yb, yn = _block(ops, p, x, mask, num_heads, eps)
    h1 = ops.gemm(yn, _w(p["mlp.w1.w"], dt), _b(p["mlp.w1.b"]), kern.EPI_BIAS_SILU)
    return ops.gemm(h1, _w(p["mlp.w2.w"], dt), _b(p["mlp.w2.b"]), kern.EPI_BIAS_CAST_ADD, yb)


def _padded(chain, q_block: int):
    """`chain` over the row padded to a multiple of q_block: the padded keys
    are masked and the padded query rows sliced away (K3, K3′)."""
    def run(ops, p, x, mask, num_heads, eps):
        s = x.shape[1]
        pad = -(-s // q_block) * q_block - s
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        out = chain(ops, p, x, mask, num_heads, eps)
        return tuple(t[:, :s] for t in out) if isinstance(out, tuple) else out[:, :s]
    return run


def _ops_for(x: torch.Tensor) -> SimpleNamespace:
    if x.device.type == "cuda":
        return _KERNEL_OPS
    if x.device.type != "cpu":
        raise ValueError(f"the encoder kernels run on cuda or cpu, got {x.device}")
    return _PLAIN_OPS


# ------------------------------------ the reference math of the backwards

def _xla_ln_attention(p, x, mask, num_heads: int, eps: float):
    """`_xla_ln_attention` (encoder_attention.py:1021): LN1 and the QKV
    product as K6 computes them, then the textbook softmax `xla_attention`."""
    xn = kern.layer_norm_plain(x, p["ln1.scale"], p["ln1.bias"], eps)
    qkv = kern.gemm_plain(xn, p["attn.qkv.w"].to(x.dtype), p["attn.qkv.b"], kern.EPI_BIAS)
    return xla_attention(qkv, mask, num_heads)


def _xla_block(p, x, mask, num_heads: int, eps: float):
    """`_xla_block` (:845): the o-projection is rounded to the compute dtype
    and added to the residual in it (the kernels add it in fp32)."""
    out = _xla_ln_attention(p, x, mask, num_heads, eps)
    y = x + kern.gemm_plain(out, p["attn.o.w"].to(x.dtype), p["attn.o.b"], kern.EPI_BIAS)
    return y, kern.layer_norm_plain(y, p["ln2.scale"], p["ln2.bias"], eps)


def _xla_layer(p, x, mask, num_heads: int, eps: float):
    """`_xla_layer` (:933): the MLP with silu in the compute dtype."""
    dt = x.dtype
    y, ln2 = _xla_block(p, x, mask, num_heads, eps)
    h = kern.gemm_plain(ln2, p["mlp.w1.w"].to(dt), p["mlp.w1.b"], kern.EPI_BIAS)
    h = h * torch.sigmoid(h)
    return y + kern.gemm_plain(h, p["mlp.w2.w"].to(dt), p["mlp.w2.b"], kern.EPI_BIAS)


class _FusedChain(torch.autograd.Function):
    """A fused route: the forward is the chain (its CUDA kernels, or their
    plain versions on the CPU); the backward is JAX's (`_fused_layer_bwd`
    :961, `_fused_block_bwd` :880, `_fused_ln_bwd` :1048): autograd of the
    `_xla_*` reference recomputed from the saved inputs, with the cotangent
    cast to x's dtype.  The parameters are inputs, so their gradients reach
    the fp32 leaves through the casts; the mask gets none."""

    @staticmethod
    def forward(ctx, names, chain, reference, x, mask, *params):
        ctx.names, ctx.reference = names, reference
        ctx.save_for_backward(x, mask, *params)
        return chain(dict(zip(names, params)), x, mask)

    @staticmethod
    def backward(ctx, *g):
        x, mask, *params = ctx.saved_tensors
        need = (ctx.needs_input_grad[3],) + ctx.needs_input_grad[5:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip((x, *params), need)]
            out = ctx.reference(dict(zip(ctx.names, leaves[1:])), leaves[0], mask)
            out = out if isinstance(out, tuple) else (out,)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad],
                                             [gg.to(x.dtype) for gg in g], allow_unused=True))
        d_x, *d_params = (next(grads) if t.requires_grad else None for t in leaves)
        return (None, None, None, d_x, None, *d_params)


def _fused(counter: str, names, params, chain, reference, x, mask, num_heads: int, eps: float):
    """Run a fused route as `_FusedChain`: a CUDA tensor runs the CUDA
    chain (counted as `counter`) or raises; a CPU tensor runs the plain
    versions."""
    ops = _ops_for(x)
    if ops is _KERNEL_OPS:
        LAYER_LAUNCHES[counter] += 1
    return _FusedChain.apply(names, lambda p, xx, m: chain(ops, p, xx, m, num_heads, eps),
                             lambda p, xx, m: reference(p, xx, m, num_heads, eps),
                             x.contiguous(), mask.to(torch.int32).contiguous(), *params)


def _params(module, names):
    return [module.get_parameter(n) for n in names]


def _variant_chain(chain, variant):
    return _padded(chain, variant[1]) if variant[0] == "blocked" else chain


def fused_layer(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int, eps: float,
                variant=("one_shot",)) -> torch.Tensor:
    """K1 (variant ("one_shot",)) or K3′ (("blocked", q_block): the chain
    over the row padded to a multiple of q_block): next-layer x.  x: (B, S,
    D) in the compute dtype; mask: (B, S), >0 marks valid keys.
    Differentiable with JAX's backward (`fused_layer`, :945)."""
    counter = "k3_layer" if variant[0] == "blocked" else "k1_layer"
    return _fused(counter, _LAYER, _params(blk, _LAYER), _variant_chain(_layer, variant),
                  _xla_layer, x, mask, num_heads, eps)


def fused_layer_plain(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int, eps: float,
                      variant=("one_shot",)) -> torch.Tensor:
    """K1 / K3′ through the plain PyTorch versions, on any device."""
    p = dict(zip(_LAYER, _params(blk, _LAYER)))
    return _variant_chain(_layer, variant)(_PLAIN_OPS, p, x, mask, num_heads, eps)


def fused_block_attention(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int, eps: float,
                          variant) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (variant ("one_shot",)) or K3 (("blocked", q_block): the chain
    over the row padded to a multiple of q_block): (y, LN2 y), each (B, S,
    D) in x's dtype.  Differentiable with JAX's backward
    (`fused_block_attention`, :862)."""
    counter = "k3_block" if variant[0] == "blocked" else "k2_block"
    return _fused(counter, _BLOCK, _params(blk, _BLOCK), _variant_chain(_block, variant),
                  _xla_block, x, mask, num_heads, eps)


def fused_block_attention_plain(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                                eps: float, variant) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 / K3 through the plain PyTorch versions, on any device."""
    p = dict(zip(_BLOCK, _params(blk, _BLOCK)))
    return _variant_chain(_block, variant)(_PLAIN_OPS, p, x, mask, num_heads, eps)


def fused_ln_attention(ln, qkv, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                       eps: float) -> torch.Tensor:
    """K6 (`_pallas_fused_ln`, :411): LN(x) → x·Wqkv + b → attention, the
    output before the o-projection, (B, S, D) in x's dtype.  `ln` is a
    LayerNorm, `qkv` the fused QKV Dense.  Differentiable with JAX's
    backward (`fused_ln_attention`, :1035)."""
    return _fused("k6_attn", _LN_QKV, [ln.scale, ln.bias, qkv.w, qkv.b], _ln_attention,
                  _xla_ln_attention, x, mask, num_heads, eps)


def fused_ln_attention_plain(ln, qkv, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                             eps: float) -> torch.Tensor:
    """K6 through the plain PyTorch versions, on any device."""
    p = dict(zip(_LN_QKV, (ln.scale, ln.bias, qkv.w, qkv.b)))
    return _ln_attention(_PLAIN_OPS, p, x, mask, num_heads, eps)


# ------------------------------------------------------------------- gates

def try_fused_layer(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int, eps: float,
                    dtype: Optional[torch.dtype] = None, allow_blocked: bool = False):
    """`try_fused_layer` (:978): `fused_layer` in `dtype` (default x's), or
    None where JAX's returns None — no kernel plan, the whole-layer working
    set over JAX's budget, or a blocked plan without allow_blocked."""
    dt = x.dtype if dtype is None else dtype
    variant = fused_variant(x.shape[1], x.shape[2], dt, blk.mlp.w1.w.shape[1], allow_blocked)
    return None if variant is None else fused_layer(blk, x.to(dt), mask, num_heads, eps, variant)


def try_fused_block_attention(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                              eps: float, dtype: Optional[torch.dtype] = None):
    """`try_fused_block_attention` (:897): `fused_block_attention`, or None
    where JAX's returns None."""
    dt = x.dtype if dtype is None else dtype
    variant = fused_variant(x.shape[1], x.shape[2], dt)
    return (None if variant is None
            else fused_block_attention(blk, x.to(dt), mask, num_heads, eps, variant))


def try_fused_ln_attention(ln, attn, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                           eps: float, dtype: Optional[torch.dtype] = None):
    """`try_fused_ln_attention` (:1079): `fused_ln_attention` (attn is the
    Attention holding `qkv`), or None where JAX's returns None."""
    dt = x.dtype if dtype is None else dtype
    if not fused_ln_attention_applies(x.shape[1], x.shape[2], dt):
        return None
    return fused_ln_attention(ln, attn.qkv, x.to(dt), mask, num_heads, eps)


# ------------------------------------------- K4, K5 and K4's backward K7

def xla_attention(qkv, mask, num_heads: int, causal: bool = False):
    """`_xla_attention` (encoder_attention.py:1182): textbook softmax over
    fp32 logits with −1e30 masking, P cast to the compute dtype before P·V.
    Differentiated by autograd where JAX rematerialises K4's backward."""
    dt, s = qkv.dtype, qkv.shape[1]
    q, k, v = (kern.split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    return _xla_core(q, k, v, mask, causal, dt, s)


def xla_attention_split(q, kv, mask, num_heads: int):
    """`_xla_attention_split` (:1244): the same over Q and K|V (K5's backward)."""
    k, v = kv.chunk(2, dim=-1)
    return _xla_core(*(kern.split_heads(t, num_heads) for t in (q, k, v)), mask, False, q.dtype,
                     q.shape[1])


def _xla_core(q, k, v, mask, causal, dt, s):
    # JAX multiplies by a weakly typed 1/sqrt(Dh), which it first casts to dt
    q = q * kern.q_scale(q.shape[-1], dt)
    logits = q.float() @ k.float().transpose(-1, -2)
    allowed = mask[:, None, None, :] > 0
    if causal:
        allowed = allowed & torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    w = torch.softmax(torch.where(allowed, logits, kern._NEG_INF), dim=-1).to(dt)
    return kern.merge_heads(w @ v)


class _EncoderAttention(torch.autograd.Function):
    """K4 forward; K7 backward when `bwd_fits_vmem` at the route width,
    else autograd of `xla_attention`."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads, causal, width):
        ctx.save_for_backward(qkv, mask)
        ctx.num_heads, ctx.causal, ctx.width = num_heads, causal, width
        return kern.attention_k4(qkv, mask, num_heads, causal)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()
        if bwd_fits_vmem(qkv.shape[1], ctx.width, qkv.dtype):
            return (kern.attention_bwd(qkv, mask, g, ctx.num_heads, ctx.causal),
                    None, None, None, None)
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            (d_qkv,) = torch.autograd.grad(xla_attention(x, mask, ctx.num_heads, ctx.causal), x, g)
        return d_qkv, None, None, None, None


def encoder_attention(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                      causal: bool = False, width: Optional[int] = None) -> torch.Tensor:
    """K4: (B, S, 3D) fused QKV + (B, S) key mask → (B, S, D), differentiable;
    the plan must be one-shot, as `_pallas_forward` asserts.  `width` is
    the model width the routes are decided on (default D): under tensor
    parallelism qkv holds this rank's heads, and the plan and the
    backward's route are those of the whole layer, as JAX decides them on
    its global shapes."""
    b, s, three_d = qkv.shape
    width = three_d // 3 if width is None else width
    plan = kernel_plan(s, width, qkv.dtype)
    if plan is None or plan[0] != "one_shot":
        raise ValueError(f"K4 needs a one-shot plan; seq {s} has {plan}")
    return _EncoderAttention.apply(qkv.contiguous(), mask.to(torch.int32).contiguous(),
                                   num_heads, causal, width)


def _blocked_plan(q, width: Optional[int] = None):
    s = q.shape[1]
    plan = kernel_plan(s, q.shape[-1] if width is None else width, q.dtype)
    if plan is None or plan[0] != "blocked":
        raise ValueError(f"K5 needs a blocked plan; seq {s} has {plan}")
    return plan


class _EncoderAttentionBlocked(torch.autograd.Function):
    """K5 forward at the clip length: the kernel zero-fills rows past S and
    gives keys past S p = 0, so its output equals JAX's padded call bit for
    bit (the padded keys are masked, the padded query rows sliced away);
    backward by autograd of `xla_attention_split` at the unpadded length."""

    @staticmethod
    def forward(ctx, q, kv, mask, num_heads):
        ctx.save_for_backward(q, kv, mask)
        ctx.num_heads = num_heads
        return kern.attention_k5(q, kv, mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, kv, mask = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk = q.detach().requires_grad_(), kv.detach().requires_grad_()
            out = xla_attention_split(qq, kk, mask, ctx.num_heads)
            d_q, d_kv = torch.autograd.grad(out, (qq, kk), g.to(q.dtype))
        return d_q, d_kv, None, None


def encoder_attention_blocked(q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor,
                              num_heads: int, width: Optional[int] = None) -> torch.Tensor:
    """K5: Q (B, S, D) and K|V (B, S, 2D) + (B, S) key mask → (B, S, D),
    differentiable; the plan at the route width (`width`, default D; see
    `encoder_attention`) must be blocked, as `_pallas_forward_blocked`
    asserts."""
    _blocked_plan(q, width)
    return _EncoderAttentionBlocked.apply(q.contiguous(), kv.contiguous(),
                                          mask.to(torch.int32).contiguous(), num_heads)


def encoder_attention_blocked_plain(q, kv, mask, num_heads: int) -> torch.Tensor:
    """K5's forward through the plain version, on any device, as
    `_pallas_forward_blocked` (:351-388) runs it: Q, K|V and the mask padded
    to the blocked plan's length, the padded query rows sliced away."""
    s = q.shape[1]
    pad = _blocked_plan(q)[1] - s
    q, kv = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, kv))
    mask = torch.nn.functional.pad(mask.to(torch.int32), (0, pad))
    return kern.attention_split_plain(q, kv, mask, num_heads)[:, :s]
