"""K1: the whole audio-encoder layer, as the JAX package's Pallas kernel computes it.

The JAX package runs every encoder layer at serving width through one
Pallas kernel, `_fused_block_kernel` with `with_mlp=True`
(cacophony_tpu/ops/encoder_attention.py:514, reached through
`try_fused_layer:978` from models/audio.py:161).  Its numerics are not
those of the XLA reference `_xla_layer`, and the port follows the kernel:

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
parameter in fp32.

On Hopper the layer cannot be one kernel: a 768x3072 weight pair is 9.4 MB
in bf16 against 227 KB of shared memory per block.  So K1 is a chain of
hand-written kernels that meet in device memory (ops/_kernels.py,
csrc/): (a) a row LayerNorm for LN1 and LN2, (b) a tiled GEMM with fused
epilogues for the four products, (c) a flash-style masked attention.  The
same chain serves bf16 and fp32; the TPU's VMEM capacity planning
(`kernel_plan`, `*_fits`) has no counterpart here.

`fused_layer` runs the chain's kernels on a CUDA tensor and their plain
PyTorch versions on a CPU tensor; `fused_layer_plain` runs the plain
versions on any device (the reference chip_smoke.py holds the kernels to).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from cacophony_tpu_torch.ops import _kernels as kern

# Whole-layer chains launched on the card (12 per audio bucket at caco_base).
LAYER_LAUNCHES = {"k1_layer": 0}

_KERNEL_OPS = SimpleNamespace(layer_norm=kern.layer_norm, gemm=kern.gemm,
                              attention=kern.attention)
_PLAIN_OPS = SimpleNamespace(layer_norm=kern.layer_norm_plain, gemm=kern.gemm_plain,
                             attention=kern.attention_plain)


def _layer(ops, blk, x, mask, num_heads: int, eps: float):
    dt = x.dtype
    f32 = torch.float32

    def w(dense):
        return dense.w.to(dt).contiguous()

    def b(p):
        return p.to(f32).contiguous()

    attn, mlp = blk.attn, blk.mlp
    xn = ops.layer_norm(x, b(blk.ln1.scale), b(blk.ln1.bias), eps)
    qkv = ops.gemm(xn, w(attn.qkv), b(attn.qkv.b), kern.EPI_BIAS)
    att = ops.attention(qkv, mask, num_heads)
    yb = ops.gemm(att, w(attn.o), b(attn.o.b), kern.EPI_BIAS_RESID_F32, x)
    yn = ops.layer_norm(yb, b(blk.ln2.scale), b(blk.ln2.bias), eps)
    h1 = ops.gemm(yn, w(mlp.w1), b(mlp.w1.b), kern.EPI_BIAS_SILU)
    return ops.gemm(h1, w(mlp.w2), b(mlp.w2.b), kern.EPI_BIAS_CAST_ADD, yb)


def fused_layer(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                eps: float) -> torch.Tensor:
    """Next-layer x = K1(blk, x).  x: (B, S, D) in the compute dtype;
    mask: (B, S), >0 marks valid keys.  A CUDA tensor runs the CUDA chain
    or raises; a CPU tensor runs the plain versions."""
    if x.device.type == "cuda":
        LAYER_LAUNCHES["k1_layer"] += 1
        return _layer(_KERNEL_OPS, blk, x.contiguous(), mask.to(torch.int32).contiguous(),
                      num_heads, eps)
    if x.device.type != "cpu":
        raise ValueError(f"fused_layer runs on cuda or cpu, got {x.device}")
    return fused_layer_plain(blk, x, mask, num_heads, eps)


def fused_layer_plain(blk, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                      eps: float) -> torch.Tensor:
    """The chain through the plain PyTorch versions, on any device."""
    return _layer(_PLAIN_OPS, blk, x, mask, num_heads, eps)
