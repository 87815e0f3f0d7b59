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

`fused_layer` / `fused_block` run the kernels on a CUDA tensor and their
plain PyTorch versions on a CPU tensor; the `*_plain` functions run the
plain versions on any device (the reference chip_smoke.py holds the
kernels to).

**K4, K5 and K7** are what training reaches (`multi_head_attention`,
ops/attention.py, for a one-shot or blocked plan).  `encoder_attention` is
K4 as a `torch.autograd.Function` whose backward is K7 when the reference's
`bwd_fits_vmem` holds, and otherwise autograd through `xla_attention`, the
textbook softmax with −1e30 masking that JAX's rematerialising backward
differentiates (encoder_attention.py:1223-1238).  `encoder_attention_blocked`
is K5 over Q and K|V padded to the blocked plan's length, padded keys
masked and padded query rows sliced away; its backward is autograd through
`xla_attention_split` at the unpadded length (:1276-1287).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch

from cacophony_tpu_torch.ops import _kernels as kern

# Chains launched on the card: K1 whole layers, K2 and K3 block halves.
LAYER_LAUNCHES = {"k1_layer": 0, "k2_block": 0, "k3_block": 0}

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
    if plan[0] == "one_shot":
        if fused_block_fits(seq, d_model, dtype, intermediate):
            return "k1", seq
        if fused_block_fits(seq, d_model, dtype):
            return "k2", seq
        if fused_ln_fits(seq, d_model, dtype):
            return "k6", seq
        return "k4", seq
    qb = FUSED_BLOCKED_Q_BLOCK
    s_pad = -(-seq // qb) * qb
    if fused_block_blocked_fits(s_pad, qb, d_model, dtype):
        return "k3", s_pad
    return "k5", plan[1]


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

def _w(dense, dt):
    return dense.w.to(dt).contiguous()


def _b(p):
    return p.to(torch.float32).contiguous()


def _block(ops, blk, x, mask, num_heads: int, eps: float):
    """LN1 → QKV → attention → o-proj + fp32 residual → LN2: (yb, yn)."""
    dt, attn = x.dtype, blk.attn
    xn = ops.layer_norm(x, _b(blk.ln1.scale), _b(blk.ln1.bias), eps)
    qkv = ops.gemm(xn, _w(attn.qkv, dt), _b(attn.qkv.b), kern.EPI_BIAS)
    att = ops.attention(qkv, mask, num_heads)
    yb = ops.gemm(att, _w(attn.o, dt), _b(attn.o.b), kern.EPI_BIAS_RESID_F32, x)
    yn = ops.layer_norm(yb, _b(blk.ln2.scale), _b(blk.ln2.bias), eps)
    return yb, yn


def _layer(ops, blk, x, mask, num_heads: int, eps: float):
    dt, mlp = x.dtype, blk.mlp
    yb, yn = _block(ops, blk, x, mask, num_heads, eps)
    h1 = ops.gemm(yn, _w(mlp.w1, dt), _b(mlp.w1.b), kern.EPI_BIAS_SILU)
    return ops.gemm(h1, _w(mlp.w2, dt), _b(mlp.w2.b), kern.EPI_BIAS_CAST_ADD, yb)


def _ops_for(x: torch.Tensor) -> SimpleNamespace:
    if x.device.type == "cuda":
        return _KERNEL_OPS
    if x.device.type != "cpu":
        raise ValueError(f"the encoder kernels run on cuda or cpu, got {x.device}")
    return _PLAIN_OPS


def fused_layer(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                eps: float) -> torch.Tensor:
    """K1: next-layer x.  x: (B, S, D) in the compute dtype; mask: (B, S),
    >0 marks valid keys.  A CUDA tensor runs the CUDA chain or raises; a
    CPU tensor runs the plain versions."""
    ops = _ops_for(x)
    if ops is _KERNEL_OPS:
        LAYER_LAUNCHES["k1_layer"] += 1
    return _layer(ops, blk, x.contiguous(), mask.to(torch.int32).contiguous(), num_heads, eps)


def fused_layer_plain(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                      eps: float) -> torch.Tensor:
    """K1 through the plain PyTorch versions, on any device."""
    return _layer(_PLAIN_OPS, blk, x, mask, num_heads, eps)


def _padded_block(ops, blk, x, mask, num_heads, eps, blocked: bool):
    s = x.shape[1]
    s_pad = -(-s // FUSED_BLOCKED_Q_BLOCK) * FUSED_BLOCKED_Q_BLOCK if blocked else s
    if s_pad != s:
        x = torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))
        mask = torch.nn.functional.pad(mask, (0, s_pad - s))
    yb, yn = _block(ops, blk, x.contiguous(), mask.to(torch.int32).contiguous(), num_heads, eps)
    return yb[:, :s], yn[:, :s]


def fused_block(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int, eps: float,
                *, blocked: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (blocked=False) or K3 (blocked=True): (y, LN2 y), each (B, S, D)
    in x's dtype.  K3 pads the row to a multiple of FUSED_BLOCKED_Q_BLOCK
    with masked keys and slices the padded query rows away.  A CUDA tensor
    runs the CUDA chain or raises; a CPU tensor runs the plain versions."""
    ops = _ops_for(x)
    if ops is _KERNEL_OPS:
        LAYER_LAUNCHES["k3_block" if blocked else "k2_block"] += 1
    return _padded_block(ops, blk, x, mask, num_heads, eps, blocked)


def fused_block_plain(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int, eps: float,
                      *, blocked: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 / K3 through the plain PyTorch versions, on any device."""
    return _padded_block(_PLAIN_OPS, blk, x, mask, num_heads, eps, blocked)


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
    """K4 forward; K7 backward when `bwd_fits_vmem`, else autograd of `xla_attention`."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads, causal):
        ctx.save_for_backward(qkv, mask)
        ctx.num_heads, ctx.causal = num_heads, causal
        return kern.attention_k4(qkv, mask, num_heads, causal)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()
        if bwd_fits_vmem(qkv.shape[1], qkv.shape[-1] // 3, qkv.dtype):
            return kern.attention_bwd(qkv, mask, g, ctx.num_heads, ctx.causal), None, None, None
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            (d_qkv,) = torch.autograd.grad(xla_attention(x, mask, ctx.num_heads, ctx.causal), x, g)
        return d_qkv, None, None, None


def encoder_attention(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                      causal: bool = False) -> torch.Tensor:
    """K4: (B, S, 3D) fused QKV + (B, S) key mask → (B, S, D), differentiable;
    the plan must be one-shot, as `_pallas_forward` asserts."""
    b, s, three_d = qkv.shape
    plan = kernel_plan(s, three_d // 3, qkv.dtype)
    if plan is None or plan[0] != "one_shot":
        raise ValueError(f"K4 needs a one-shot plan; seq {s} has {plan}")
    return _EncoderAttention.apply(qkv.contiguous(), mask.to(torch.int32).contiguous(),
                                   num_heads, causal)


def _blocked_forward(q, kv, mask, num_heads: int, attend):
    """Pad Q, K|V and the mask to the blocked plan's length, attend, slice
    the padded query rows away (`_pallas_forward_blocked`, :351-388)."""
    s, d = q.shape[1], q.shape[-1]
    plan = kernel_plan(s, d, q.dtype)
    if plan is None or plan[0] != "blocked":
        raise ValueError(f"K5 needs a blocked plan; seq {s} has {plan}")
    pad = plan[1] - s
    q, kv = (torch.nn.functional.pad(t, (0, 0, 0, pad)).contiguous() for t in (q, kv))
    mask = torch.nn.functional.pad(mask.to(torch.int32), (0, pad)).contiguous()
    return attend(q, kv, mask, num_heads)[:, :s]


class _EncoderAttentionBlocked(torch.autograd.Function):
    """K5 forward; backward by autograd of `xla_attention_split` at the unpadded length."""

    @staticmethod
    def forward(ctx, q, kv, mask, num_heads):
        ctx.save_for_backward(q, kv, mask)
        ctx.num_heads = num_heads
        return _blocked_forward(q, kv, mask, num_heads, kern.attention_k5)

    @staticmethod
    def backward(ctx, g):
        q, kv, mask = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk = q.detach().requires_grad_(), kv.detach().requires_grad_()
            out = xla_attention_split(qq, kk, mask, ctx.num_heads)
            d_q, d_kv = torch.autograd.grad(out, (qq, kk), g.to(q.dtype))
        return d_q, d_kv, None, None


def encoder_attention_blocked(q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """K5: Q (B, S, D) and K|V (B, S, 2D) + (B, S) key mask → (B, S, D),
    differentiable; the plan must be blocked."""
    return _EncoderAttentionBlocked.apply(q, kv, mask, num_heads)


def encoder_attention_blocked_plain(q, kv, mask, num_heads: int) -> torch.Tensor:
    """K5's forward through the plain version, on any device."""
    return _blocked_forward(q, kv, mask, num_heads, kern.attention_split_plain)
