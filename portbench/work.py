"""The operations and bytes of the work a cell asks of the card, counted
from its shapes and its inputs (never from launch counts), and the
classes of kernel names that do it.  A roofline share is the least time
of the work (frozen.least_seconds, summed over products) over the device
time of the kernels of its class."""

from __future__ import annotations

import re
from typing import Iterable

from portbench import frozen

# Attention: the port's kernels (attention_*_kernel, K7's attn_bwd_* and
# dq_to_bf16) and PyTorch's SDPA / flash / memory-efficient kernels.
ATTENTION = re.compile(r"attention|attn_bwd|dq_to_bf16|flash|fmha|sdpa|efficient_attention", re.I)
# GEMM: the port's gemm_* kernels and cuBLAS / cuBLASLt / CUTLASS kernels.
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|matmul", re.I)


def is_attention(name: str) -> bool:
    return bool(ATTENTION.search(name))


def is_gemm(name: str) -> bool:
    return bool(GEMM.search(name)) and not is_attention(name)


def valid_frames(n: int, front: dict) -> int:
    return -(-n // front["hop_length"])


def valid_patches(n: int, front: dict, seq: int) -> int:
    return min(seq, (valid_frames(n, front) // 16) * (front["num_mels"] // 16))


def _product(m: int, k: int, n: int, kind: str, item: int, w_item: int):
    """Least seconds of (m×k)@(k×n): operands and output once, the weight
    once per call."""
    return frozen.least_seconds(2 * m * k * n, (m * k + m * n) * item + k * n * w_item, kind)


def attention_least_s(d: int, heads: int, rows: Iterable[int], products: int = 2) -> float:
    """Self-attention over each row's `v` valid positions: Q·Kᵀ and P·V
    (five products in the backward); Q, K, V read once and O written once
    (in the backward also dO read and dQ, dK, dV written), bf16."""
    hd, total = d // heads, 0.0
    for v in rows:
        tensors = 4 if products == 2 else 8
        total += frozen.least_seconds(frozen.attn_flops(heads, hd, v, v, products),
                                      tensors * v * d * 2, "bf16")
    return total


def embed_gemm_least_s(cfg: dict, lengths: Iterable[int], batch: int, seq: int) -> float:
    """The embedding pipeline's products other than attention, bucket by
    bucket: the frontend's windowed DFT and mel in fp32, then the patch
    projection, each layer's QKV, o-projection and MLP, and the pooler's
    K|V and output in bf16, over the valid frames and patches."""
    front, a = cfg["frontend"], cfg["audio"]
    d, ffn, nb = a["hidden_size"], a["intermediate_size"], front["fft_size"] // 2 + 1
    lengths = list(lengths)
    total = 0.0
    for i in range(0, len(lengths), batch):
        bucket = lengths[i:i + batch]
        f = sum(valid_frames(n, front) for n in bucket)
        p = sum(valid_patches(n, front, seq) for n in bucket)
        total += _product(f, front["window_length"], 2 * nb, "fp32", 4, 4)
        total += _product(f, nb, front["num_mels"], "fp32", 4, 4)
        total += _product(p, a["patch_size"], d, "bf16", 2, 2)
        layer = (_product(p, d, 3 * d, "bf16", 2, 2) + _product(p, d, d, "bf16", 2, 2)
                 + _product(p, d, ffn, "bf16", 2, 2) + _product(p, ffn, d, "bf16", 2, 2))
        total += a["num_layers"] * layer
        total += _product(p, d, 2 * d, "bf16", 2, 2) + _product(len(bucket), d,
                                                                cfg["projection_size"], "bf16", 2, 2)
    return total


def embed_attention_least_s(cfg: dict, lengths: Iterable[int], seq: int) -> float:
    a = cfg["audio"]
    rows = [valid_patches(n, cfg["frontend"], seq) for n in lengths]
    return a["num_layers"] * attention_least_s(a["hidden_size"], a["num_heads"], rows)


def caco_attention_least_s(cfg: dict, lengths: Iterable[int], seq: int) -> float:
    """Forward and backward attention of the stage-2 step's audio tower over
    each clip's valid patches (the text towers' attention runs as einsums
    in the program and is left out)."""
    a = cfg["audio"]
    rows = [valid_patches(n, cfg["frontend"], seq) for n in lengths]
    return sum(a["num_layers"] * attention_least_s(a["hidden_size"], a["num_heads"], rows, k)
               for k in (2, 5))


def mae_attention_least_s(cfg: dict, lengths: Iterable[int], seq: int) -> float:
    """Forward and backward attention of the stage-1 step over each clip:
    the encoder over its visible patches (round(seq · (1 − mask_ratio)) of
    its valid ones), the decoder over its valid patches, visible and masked
    (the grid's padding is masked out as keys, and no query there is
    needed)."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    keep = max(1, int(round(seq * (1.0 - cfg["mask_ratio"]))))
    valid = [valid_patches(n, cfg["frontend"], seq) for n in lengths]
    shown = [min(keep, v) for v in valid]
    return sum(enc["num_layers"] * attention_least_s(enc["hidden_size"], enc["num_heads"], shown, k)
               + dec["num_layers"] * attention_least_s(dec["hidden_size"], dec["num_heads"], valid,
                                                       k)
               for k in (2, 5))
