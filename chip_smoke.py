#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (cacophony_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no final `ok` line):
1. print the card's name and power limit (nvidia-smi); build the CUDA
   kernels from cacophony_tpu_torch/csrc (one nvcc per source, in parallel);
   where the toolkit has cuobjdump, count the HGMMA (wgmma) instructions of
   the bf16 GEMM, the attention forward and K7's pre-pass and main pass in
   the built library (none fails);
   sweep the bf16 GEMM's branch-free silu epilogue against apply_epilogue
   over every fp32 input (any differing bit fails);
2. hold each K1 kernel, and the K1 layer chain as a whole, against its
   plain PyTorch version on the card: B=8, S=496, D=768, H=8, I=3072, some
   padded keys and one all-masked clip, bf16 and fp32 (the fp32 GEMM and
   attention are the register-tiled SIMT kernels); the GEMM at ragged
   M, N, K (N, K not multiples of 8: the SIMT kernel in bf16 too), every
   epilogue, bf16 and fp32;
3. K2 and K3 (`fused_block_attention`, the chain up to LN2) against the plain
   version: B=8, K2 at S=496 in fp32, K3 at S=1496 padded to 1536 inside
   in bf16 and fp32, mixed lengths and a clip with no valid patch;
3b. K6 (`fused_ln_attention`: LN1 → QKV → attention) at S=496 and K3′
   (`fused_layer` with the blocked variant: the whole layer at S=1496
   padded to 1536 inside) against the plain chain, bf16, B=8;
4. K8 and K8′ (the fused log-mel, fp32 and bf16×3 DFT) against their plain
   versions, and K8′ against K8 within 2e-4: B=8, 1000 and 3000 frames,
   with a quiet and a silent clip;
5. caco_base() with random weights from seed 0, a bf16 10-s CacoEngine on
   cuda: embed_audio on 70 clips of 3-10 s (the last bucket is mostly
   padding), embed_texts, score; K1 launched 12 times per bucket;
5b. caco_tiny() in bf16 on cuda (Dh 16: the attention link is the mma.sync
   kernel): K1 launched 2 times per bucket; cosine >= 0.999 against the
   CPU engine;
6. the fp32 10-s engine on the same clips: K2 launched 12 times per bucket
   and K1 none; fp32 card vs fp32 plain on the CPU (cosine >= 0.9999 on 2
   clips); bf16 vs fp32 on the card (cosine >= 0.999);
7. a bf16 10-s engine with fused_frontend=True: K8 launched once per
   bucket; cosine >= 0.9999 against the unfused engine;
8. the 30-s retrieval engine in bf16: 1536 patches, 40 clips of 3-30 s
   with K3 launched 12 times per bucket and K1 none, embed_audio_long on
   clips of 45-75 s; against an fp32 30-s engine (no kernel: the einsum
   route) at cosine >= 0.999;
8b. the paths of K6, K3′ and K8′ at caco_base in bf16, through their own
   entry points: a 12-layer 10-s encoder (B=32, S=496) with every layer on
   route "k6" (K6 12 times, no K1; cosine >= 0.999 against the K1 route),
   a 12-layer 30-s encoder (B=8, 1536 patches) through
   `try_fused_layer(allow_blocked=True)` (K3′ 12 times, no K3; cosine >=
   0.999 against the K3 route), `fused_batch_wav_to_patches(fast_dft=True)`
   on 10-s buffers (K8′ once) and on 30-s ones (K8′ none: JAX's exact
   fallback, K8 once);
8c. gradients through the inference encoder: bf16 10 s at B=8 (K1 12
   times in the forward; every block parameter's gradient present and
   finite), fp32 at B=2 (K2 route) against the CPU (relative L2 <= 1e-4);
9. K4, K5 and K7 against their plain versions: K4 at B=8, S=500, H=8,
   Dh=96 in bf16 and fp32 and causal at H=12, Dh=64, S=100, padded keys
   and an all-masked clip; K5 at S=1500 (the plain version padded to
   1536), and bit-identical to the kernel over the padded row; K7 in bf16
   at S=500 and fp32 at S=100, causal and not, the all-masked clip's
   gradients finite and zero; the attention link, K4 (causal) and K7 at
   head dims 16, 32 and 128 in bf16 and fp32, with an all-masked clip and
   with logits far above the clamp of 80; the wgmma K7 at Dh 64 and 96,
   S = 1, 63, 128, 500, 579, causal and not, logits above the clamp; heads
   past 128 columns (Dh 160, 192, 256, 384) in both dtypes for the
   attention link, K4 causal, K5's strides and K7, and a K1 chain at Dh
   256;
10. the stage-2 training step (train/train.py) at caco_base in bf16: B=16,
   500 patches from `device_train_frontend` on synthetic 3-10-s wavs, 100
   tokens; 5 steps on one batch with warmup 1: K4 and K7 launched 12 times
   per step and no K1, K2, K3 or K5; finite loss and grad_norm, the loss
   falls from step 1 to step 4; peak device memory; the device's busy
   time per step (the union of its kernel intervals, torch.profiler);
11. the fp32 10-s step (text dropout off): K4 12 per step and no K7; its
   loss and gradients at B=2 against the same fp32 step on the CPU through
   the plain versions; 3 timed steps;
12. the bf16 30-s step at B=4 (1500 patches, blocked plan 1536): K5 12
   times per step and no K4 or K7; peak memory, 3 timed steps;
13. time embed_audio at batch 32 (10-s and 30-s clips, bf16), each K1
   kernel and chain, the K2 and K3 blocks, K3′, K4, K5, K6, K7, K8 and K8′
   against their plain versions, and the bf16 10-s training step (median of 6),
   beside the card's name and power limit; each kernel's bound (its bytes
   or operations over the H100's peaks); the redesigned bf16 GEMM and
   attention against one PyTorch call in turns (torch.matmul at the 10-s
   and 30-s products, F.scaled_dot_product_attention at S=496 and 1536, K4
   and K5, SDPA's backward alone for K7), K2's fp32 links and K4 in fp32
   against torch.matmul / SDPA in fp32, the LayerNorm link and K8's three
   library calls; the fp32 10-s embed_audio rate; the K5 call against its
   kernel alone, and the host microseconds per K4 / K5 call.
Every main path is driven with the launch counts set to 0 just before it
and read just after.  The line before the last is a JSON object with one
entry per TPU kernel (K1, K2, K3, K3′, K4, K5, K6, K7, K8, K8′); the last line is
{"ok": true, "device": {...}}.

It needs a CUDA device and never imports JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.data.pipeline import device_train_frontend
from cacophony_tpu_torch.data.tokenizer import ByteLevelBPETokenizer, _bytes_to_unicode
from cacophony_tpu_torch.frontend import fused
from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples, patchify_spectrogram
from cacophony_tpu_torch.models import caco
from cacophony_tpu_torch.models.audio import LN_EPS, ViTBlock, audio_input_embedding, encoder_layer
from cacophony_tpu_torch.models.caco import caco_init, get_audio_embedding
from cacophony_tpu_torch.models.layers import layer_norm
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.train import train

SEED = 0
DEVICE = "cuda"
N_CLIPS = 70      # 10-s paths: 3 buckets, the last mostly zero-length padding
N_CLIPS_30 = 40   # 30-s path: 2 buckets
BATCH = 32
D, H, INTER = 768, 8, 3072  # caco_base's audio layer: width, heads, MLP
CSRC = "cacophony_tpu_torch/csrc/"
K1_PARTS = {  # launch-count key → source of one kernel of the K1/K2/K3 chain
    "layer_norm": CSRC + "layer_norm.cu",
    "gemm": CSRC + "gemm.cu",
    "attention": CSRC + "attention.cu",
}
CHAIN_SOURCES = ", ".join(K1_PARTS.values())
EA = "cacophony_tpu/ops/encoder_attention.py"
TPU_KERNELS = {  # name → (sources, the Pallas function it replaces, launch-count key)
    "K1": (CHAIN_SOURCES, f"{EA}:594", "k1_layer"),  # _pallas_fused_block, with_mlp=True
    "K2": (CHAIN_SOURCES, f"{EA}:594", "k2_block"),  # _pallas_fused_block, with_mlp=False
    "K3": (CHAIN_SOURCES, f"{EA}:763", "k3_block"),  # _pallas_fused_block_blocked
    "K3′": (CHAIN_SOURCES, f"{EA}:763", "k3_layer"),  # the same, with_mlp=True
    "K4": (CSRC + "attention.cu", f"{EA}:317", "k4"),  # _pallas_forward
    "K5": (CSRC + "attention.cu", f"{EA}:351", "k5"),  # _pallas_forward_blocked
    "K6": (CHAIN_SOURCES, f"{EA}:411", "k6_attn"),  # _pallas_fused_ln
    "K7": (CSRC + "attention_bwd.cu", f"{EA}:1147", "k7"),  # _pallas_backward
    "K8": (CSRC + "log_mel.cu", "cacophony_tpu/frontend/fused.py:153", "log_mel"),
    "K8′": (CSRC + "log_mel.cu", "cacophony_tpu/frontend/fused.py:153", "log_mel_fast"),
}
TRAIN_BATCH, TRAIN_BATCH_30, TEXT_LEN = 16, 4, 100
VARIANT_BATCH_30, GRAD_BATCH = 8, 8  # the K3′ 30-s path; the bf16 gradient phase
TRAIN_STEPS = 5
# |kernel - plain| ≤ atol + rtol·|plain|, elementwise.  bf16: outputs are
# rounded to bf16 (8 mantissa bits) after fp32 sums taken in another order,
# so one rounding step apart is 2^-8 relative; the chain compounds seven
# such steps.  fp32: summation order only.  K8: fp32 sums in another order,
# and the log scales a mel error δ by 0.2/(mel + 1e-5).
TOL = {
    torch.bfloat16: {"kernel": (2e-2, 1e-2), "chain": (6e-2, 3e-2), "k7": (3e-2, 2e-2)},
    torch.float32: {"kernel": (1e-4, 1e-4), "chain": (5e-4, 5e-4), "k7": (1e-4, 1e-4)},
    "log_mel": (1e-4, 0.0),
    "fast_dft": (2e-4, 0.0),
}
# K8′ (the bf16×3 DFT) against its plain version: TOL["log_mel"].  Against
# exact K8: the JAX package's own bound on its fast DFT, 2e-4
# (tests/test_fused_frontend.py:71-82, two clips of 200 frames).  Over
# millions of values the bf16×3 DFT itself passes it on about one value in
# a million — a mel value near 1e-3 whose few DFT bins nearly cancel — so
# the bound is held where the plain version meets it, and elsewhere K8′ may
# be no farther from K8 than the plain version is, plus TOL["log_mel"].  The fp32 gradients through the inference encoder on the
# card against the same computation on the CPU: relative L2 ≤ 1e-4 (fp32
# sums in another order through 12 layers, their forward kernels and the
# rematerialising backward).  The variant paths against the default route
# at caco_base in bf16: cosine ≥ 0.999, the bf16-vs-fp32 bound of phase 6
# (K6 and K3′ round where K1 and K3 do, but the MLP outside K6 and the
# blocked MLP inside K3′ move bf16 rounding points).
GRAD_TOL = 1e-4
COS_VARIANT = 0.999
# K7's bf16 bound is wider than one kernel's: P and dS are rounded to bf16
# before their products, so a rounding step of either moves a gradient by
# one more.  The fp32 step on the card against the same step on the CPU
# (phase 11): the loss to 1e-5 and the gradients to 1e-4 relative (fp32
# sums in another order through 28 layers and their backward).
STEP_TOL = {"loss": 1e-5, "grads": 1e-4}
# The fused and the unfused frontend give the same fp32 log-mel up to the
# order of fp32 sums (~1e-6); after the cast to bf16 a patch value changes
# only where it lies that close to a rounding boundary, by one bf16 step.
# Those few flips move the bf16 embedding far less than bf16 itself does
# against fp32 (bounded at 0.999 in phase 6).
COS_FUSED = 0.9999


class SmokeFailure(Exception):
    pass


def reset_launches() -> None:
    kern.reset_launches()
    for k in ea.LAYER_LAUNCHES:
        ea.LAYER_LAUNCHES[k] = 0


def launches() -> dict:
    return dict(kern.LAUNCHES, **ea.LAYER_LAUNCHES)


def drive(name, fn, expect):
    """Run one main path with every launch count at 0 just before it; check
    the counts read just after against `expect` (key → exact count, or
    None for "at least once")."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = launches()
    print(f"  {name}: launches {got}")
    for k, want in expect.items():
        ok = got[k] > 0 if want is None else got[k] == want
        check(ok, f"{name}: {k} launched {got[k]} times, expected "
                  f"{'at least once' if want is None else want}")
    return out, got


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int):
    """plain, kernel, kernel, plain in one call; → (kernel ms, plain ms).
    With a library call as kernel_fn and the kernel as plain_fn: kernel,
    library, library, kernel; → (library ms, kernel ms)."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# The least time of a function on one H100 SXM (NVIDIA's published dense
# peaks for the card): the larger of its bytes (each
# input read once, each output written once) over the memory rate and its
# operations over the peak of their type.
PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(ops: dict, nbytes: float):
    """ops: {"bf16" or "fp32": operations} → (bound ms, "operations" or "bytes")."""
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attn_flops(heads, hd, s, valid, products=2):
    """2·S·Dh flops per (query, valid key) for each of `products` S×S
    products (Q·Kᵀ and P·V forward; five in the backward), per head; keys
    that are masked out are work no caller needs."""
    return products * 2 * heads * hd * s * int(sum(valid))


def check_sass():
    """Phase 1: the redesigned kernels issue wgmma (HGMMA in the SASS of the
    built library), where the toolkit has cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("  HGMMA in the new kernels: not checked (no cuobjdump)")
        return None
    sass = subprocess.run([tool, "-sass", kern.load_library()._name], capture_output=True,
                          text=True, check=True).stdout
    counts = {"gemm_bf16_wgmma_kernel": 0, "attention_bf16_wgmma_kernel": 0,
              "attn_bwd_pre_wgmma": 0, "attn_bwd_main_wgmma": 0}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in counts if k in line), None)
        elif current and "HGMMA" in line:
            counts[current] += 1
    print(f"  HGMMA instructions in the SASS (all instantiations): {counts}")
    check(all(counts.values()), f"a redesigned kernel issues no wgmma: {counts}")
    return counts


def compare(name, got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    ok = bool((err <= atol + rtol * ref.abs()).all())
    max_err = float(err.max())
    print(f"  {name:<36} max_abs_err {max_err:.3e}  (atol {atol:g}, rtol {rtol:g})"
          f"  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return max_err


def layer_inputs(b, s, d, dtype, gen, lengths):
    x = torch.randn(b, s, d, generator=gen).to(DEVICE, dtype)
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to(DEVICE, torch.int32)
    return x, mask


def layer_cases(blk, x, mask, heads):
    """Each K1 kernel's inputs inside one layer, from the plain chain:
    {kernel: [(label, args), ...]}."""
    dt = x.dtype
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    w = lambda dense: dense.w.to(dt).contiguous()  # noqa: E731
    ln1 = (x, f32(blk.ln1.scale), f32(blk.ln1.bias), 1e-6)
    xn = kern.layer_norm_plain(*ln1)
    qkv_args = (xn, w(blk.attn.qkv), f32(blk.attn.qkv.b), kern.EPI_BIAS)
    qkv = kern.gemm_plain(*qkv_args)
    att = kern.attention_plain(qkv, mask, heads)
    o_args = (att, w(blk.attn.o), f32(blk.attn.o.b), kern.EPI_BIAS_RESID_F32, x)
    yb = kern.gemm_plain(*o_args)
    ln2 = (yb, f32(blk.ln2.scale), f32(blk.ln2.bias), 1e-6)
    up_args = (kern.layer_norm_plain(*ln2), w(blk.mlp.w1), f32(blk.mlp.w1.b), kern.EPI_BIAS_SILU)
    down_args = (kern.gemm_plain(*up_args), w(blk.mlp.w2), f32(blk.mlp.w2.b),
                 kern.EPI_BIAS_CAST_ADD, yb)
    return {
        "layer_norm": [("layer_norm LN1", ln1), ("layer_norm LN2", ln2)],
        "gemm": [("gemm qkv + bias", qkv_args), ("gemm o-proj + bias + f32 resid", o_args),
                 ("gemm mlp up + bias + silu", up_args),
                 ("gemm mlp down + bias, cast, + resid", down_args)],
        "attention": [("attention", (qkv, mask, heads))],
    }


@torch.inference_mode()
def kernel_phase(blk):
    """Phase 2: every K1 kernel and the chain against the plain versions."""
    b, s, d, h, inter = 8, 496, D, H, INTER
    lengths = [496, 400, 300, 496, 100, 250, 0, 17]  # clip 6: all keys masked
    gen = torch.Generator().manual_seed(SEED + 4)
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[dt]["kernel"]
        print(f"phase 2: kernels vs plain, {str(dt).split('.')[-1]}, "
              f"B={b} S={s} D={d} H={h} I={inter}")
        x, mask = layer_inputs(b, s, d, dt, gen, lengths)
        dt_errs = {}
        cases = layer_cases(blk, x, mask, h)
        for key, key_cases in cases.items():
            kernel, plain = getattr(kern, key), getattr(kern, key + "_plain")
            dt_errs[key] = max(compare(label, kernel(*args), plain(*args), atol, rtol)
                               for label, args in key_cases)
        qkv = cases["attention"][0][1][0]
        check(bool((kern.attention(qkv, mask, h)[6] == 0).all()),
              "attention: all-masked clip is not exactly 0")
        catol, crtol = TOL[dt]["chain"]
        dt_errs["k1_layer"] = compare("K1 layer chain", ea.fused_layer(blk, x, mask, h, 1e-6),
                                      ea.fused_layer_plain(blk, x, mask, h, 1e-6), catol, crtol)
        if dt == torch.bfloat16:
            errs = dt_errs
    errs["gemm_ragged"] = ragged_gemm_check(gen)
    return errs


def ragged_gemm_check(gen):
    """Phase 2: the GEMM where N and K are not multiples of 8 (the SIMT
    kernel, in bf16 as in fp32) and M is not a multiple of the tile, every
    epilogue, against the plain version."""
    m, n, k = 1000, 2300, 764
    err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        a = torch.randn(m, k, generator=gen).to(DEVICE, dt)
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(DEVICE, dt)
        bias = torch.randn(n, generator=gen).to(DEVICE)
        r = torch.randn(m, n, generator=gen).to(DEVICE, dt)
        for epi in (kern.EPI_BIAS, kern.EPI_BIAS_RESID_F32, kern.EPI_BIAS_SILU, kern.EPI_BIAS_CAST_ADD):
            err = max(err, compare(f"gemm {_dt_name(dt)} M={m} N={n} K={k} epilogue {epi}",
                                   kern.gemm(a, w, bias, epi, r), kern.gemm_plain(a, w, bias, epi, r),
                                   *TOL[dt]["kernel"]))
    return err


@torch.inference_mode()
def block_phase(blk):
    """Phase 3: K2 and K3 (fused_block_attention) against the plain chain.  At
    S=1496 K3 pads to 1536 inside: 40 padded keys on top of the short
    clips, and clip 6 has no valid patch at all."""
    b, d, h = 8, D, H
    gen = torch.Generator().manual_seed(SEED + 2)
    errs = {}
    for name, dt, s, blocked in (("K2", torch.float32, 496, False),
                                 ("K3", torch.bfloat16, 1496, True),
                                 ("K3", torch.float32, 1496, True)):
        lengths = ([496, 400, 300, 496, 100, 250, 0, 17] if s == 496
                   else [1496, 1200, 700, 1496, 100, 37, 0, 1000])
        print(f"phase 3: {name} block vs plain, {str(dt).split('.')[-1]}, B={b} S={s}"
              f"{' (padded to 1536 inside)' if blocked else ''}")
        x, mask = layer_inputs(b, s, d, dt, gen, lengths)
        variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK) if blocked else ("one_shot",)
        got = ea.fused_block_attention(blk, x, mask, h, 1e-6, variant)
        ref = ea.fused_block_attention_plain(blk, x, mask, h, 1e-6, variant)
        atol, rtol = TOL[dt]["chain"]
        err = max(compare(f"{name} {label}", g, r, atol, rtol)
                  for label, g, r in zip(("y", "LN2 y"), got, ref))
        check(all(bool(torch.isfinite(t[6]).all()) and t.shape == (b, s, d) for t in got),
              f"{name}: the clip with no valid patch gave non-finite rows")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


@torch.inference_mode()
def variant_phase(blk):
    """Phase 3b: K6 (LN1 → QKV → attention) at S=496 and K3′ (the whole
    layer at S=1496 padded to 1536 inside) against the plain chain, bf16,
    B=8, padded keys and a clip with no valid key (K6 gives it 0)."""
    b, h, dt = 8, H, torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 6)
    atol, rtol = TOL[dt]["chain"]
    print(f"phase 3b: K6 and K3′ vs plain, bfloat16, B={b}")
    x, mask = layer_inputs(b, 496, D, dt, gen, [496, 400, 300, 496, 100, 250, 0, 17])
    got = ea.fused_ln_attention(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6)
    errs = {"K6": compare("K6 LN1 → QKV → attention, S=496", got,
                          ea.fused_ln_attention_plain(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6),
                          atol, rtol)}
    check(bool((got[6] == 0).all()), "K6: the all-masked clip is not exactly 0")
    x, mask = layer_inputs(b, 1496, D, dt, gen, [1496, 1200, 700, 1496, 100, 37, 0, 1000])
    variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK)
    got = ea.fused_layer(blk, x, mask, h, 1e-6, variant)
    check(got.shape == (b, 1496, D) and bool(torch.isfinite(got).all()),
          f"K3′: shape {tuple(got.shape)} or non-finite rows")
    errs["K3′"] = compare("K3′ layer, S=1496 (1536 inside)", got,
                          ea.fused_layer_plain(blk, x, mask, h, 1e-6, variant), atol, rtol)
    return errs


@torch.inference_mode()
def log_mel_phase():
    """Phase 4: K8 and K8′ against their plain versions, and K8′ against
    K8, B=8, 10-s and 30-s buffers."""
    front = configs.FrontendConfig()
    gen = torch.Generator().manual_seed(SEED + 3)
    err = err_fast = 0.0
    for seconds in (10, 30):
        frames = seconds * 100
        lens = [seconds * 16000, 3 * 16000, 12345, seconds * 16000, 16000, 0, 160, 7 * 16000]
        bufs = torch.zeros(len(lens), seconds * 16000)
        for i, n in enumerate(lens):
            bufs[i, :n] = (1e-4 if i == 3 else 0.1) * torch.randn(n, generator=gen)
        rows = fused.buffer_to_rows(bufs.to(DEVICE), frames, front)
        print(f"phase 4: K8 and K8′ vs plain, B={len(lens)}, {frames} frames")
        exact = fused.fused_log_mel(rows, front, frames)
        err = max(err, compare(f"K8 log-mel, {frames} frames", exact,
                               fused.fused_log_mel_plain(rows, front, frames), *TOL["log_mel"]))
        fast = fused.fused_log_mel(rows, front, frames, fast_dft=True)
        plain_fast = fused.fused_log_mel_plain(rows, front, frames, fast_dft=True)
        err_fast = max(err_fast, compare(f"K8′ log-mel, {frames} frames", fast, plain_fast,
                                         *TOL["log_mel"]))
        check_fast_dft(f"{frames} frames", fast, plain_fast, exact)
    return {"K8": err, "K8′": err_fast}


def check_fast_dft(label, fast, plain_fast, exact):
    """K8′ against exact K8: within JAX's 2e-4 wherever its bf16×3 DFT (the
    plain version) is, and elsewhere no farther than it plus TOL["log_mel"]."""
    bound = TOL["fast_dft"][0]
    err, err_plain = (fast - exact).abs(), (plain_fast - exact).abs()
    ok = bool((err <= torch.clamp(err_plain + TOL["log_mel"][0], min=bound)).all())
    print(f"  K8′ vs exact K8, {label}: max |Δ| {float(err.max()):.3e} (plain bf16×3 "
          f"{float(err_plain.max()):.3e}); values beyond {bound:g}: {int((err > bound).sum())} of "
          f"{err.numel()} (plain {int((err_plain > bound).sum())})  {'ok' if ok else 'FAIL'}")
    check(ok, f"K8′ {label}: farther from K8 than its plain version allows")


def _dt_name(dt) -> str:
    return str(dt).split(".")[-1]


@torch.inference_mode()
def attention_phase():
    """Phase 9: K4, K5 and K7 against their plain versions, B=8; clip 6 has
    no valid key."""
    b = 8
    gen = torch.Generator().manual_seed(SEED + 5)
    lengths = {500: [500, 400, 300, 500, 100, 250, 0, 17], 100: [100, 80, 60, 100, 20, 50, 0, 3],
               1500: [1500, 1200, 700, 1500, 100, 37, 0, 1000]}

    def inputs(s, width, dt):
        x = (1.5 * torch.randn(b, s, width, generator=gen)).to(DEVICE, dt)
        mask = (torch.arange(s)[None, :] < torch.tensor(lengths[s])[:, None]).to(DEVICE, torch.int32)
        return x, mask

    errs = {}
    cases = ((torch.bfloat16, 500, 8, False), (torch.float32, 500, 8, False),
             (torch.bfloat16, 100, 12, True), (torch.float32, 100, 12, True))
    print("phase 9: K4, K5, K7 vs plain, B=8")
    for dt, s, heads, causal in cases:
        qkv, mask = inputs(s, 3 * D, dt)
        label = f"K4 {_dt_name(dt)} S={s} H={heads}{' causal' if causal else ''}"
        got = kern.attention_k4(qkv, mask, heads, causal)
        err = compare(label, got, kern.attention_plain(qkv, mask, heads, causal), *TOL[dt]["kernel"])
        errs["K4"] = max(errs.get("K4", 0.0), err)
        check(bool((got[6] == 0).all()), f"{label}: the all-masked clip is not exactly 0")
    q, mask = inputs(1500, D, torch.bfloat16)
    kv, _ = inputs(1500, 2 * D, torch.bfloat16)
    got = ea.encoder_attention_blocked(q, kv, mask, H)
    errs["K5"] = compare("K5 bf16 S=1500 (plain: padded to 1536)", got,
                         ea.encoder_attention_blocked_plain(q, kv, mask, H), *TOL[torch.bfloat16]["kernel"])
    pad = 1536 - 1500
    padded = kern.attention_k5(F.pad(q, (0, 0, 0, pad)), F.pad(kv, (0, 0, 0, pad)), F.pad(mask, (0, pad)),
                               H)[:, :1500]
    same = torch.equal(got, padded)
    print(f"  K5 at S=1500 (no padding copy) vs the kernel over the row padded to 1536: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    check(same, "K5 at the clip length differs from the padded call")
    cases = ((torch.bfloat16, 500, 8, False), (torch.bfloat16, 500, 8, True),
             (torch.float32, 100, 8, False), (torch.float32, 100, 12, True))
    for dt, s, heads, causal in cases:
        qkv, mask = inputs(s, 3 * D, dt)
        g = torch.randn(b, s, D, generator=gen).to(DEVICE, dt)
        label = f"K7 {_dt_name(dt)} S={s} H={heads}{' causal' if causal else ''}"
        got = kern.attention_bwd(qkv, mask, g, heads, causal)
        err = compare(label, got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), *TOL[dt]["k7"])
        errs["K7"] = max(errs.get("K7", 0.0), err)
        check(bool((got[6] == 0).all()), f"{label}: the all-masked clip's gradients are not 0")
    for key, err in head_dim_checks(gen).items():
        errs[key] = max(errs[key], err)
    errs["K7"] = max(errs["K7"], k7_wgmma_checks(gen))
    for key, err in wide_head_checks(gen).items():
        errs[key] = max(errs.get(key, 0.0), err)
    return errs


def clamp_qkv(b, s, heads, hd, gen):
    """Fused QKV (CPU, fp32) whose logits reach far past the clamp of 80
    while every element stays moderate: Q and K share the all-ones direction
    of each head (30 along it), K with a per-key weight in [-1, 1.2], so
    q·k/sqrt(Dh) runs from about -110 to +130 at Dh 64 and every row clamps
    many keys.  (Scaling all of q, k, v by 8 instead puts one bf16 step of
    dS times |q| ≈ 30 past K7's bound: a test of the inputs, not the kernel.)"""
    d = heads * hd
    x = 1.5 * torch.randn(b, s, 3 * d, generator=gen)
    along = 30.0 / hd ** 0.5
    x[..., :d] += along
    x[..., d:2 * d] += along * (2.2 * torch.rand(b, s, 1, generator=gen) - 1.0)
    return x


def k7_wgmma_checks(gen):
    """Phase 9: the redesigned bf16 K7 (wgmma: pre-pass, main pass, dQ
    conversion) at Dh 64 (12 heads) and 96 (8 heads), S = 1, 63, 128, 500
    and 579 (`bwd_fits_vmem`'s bf16 limit), causal and not, B=4 with an
    all-masked clip (exactly 0), and logits far above the clamp (S=500)."""
    b, err = 4, 0.0
    tol = TOL[torch.bfloat16]["k7"]
    for hd, heads in ((64, 12), (96, 8)):
        for s in (1, 63, 128, 500, 579):
            lens = [s, max(s // 3, 1), 0, max(s // 2, 1)]
            mask = (torch.arange(s)[None, :] < torch.tensor(lens)[:, None]).to(DEVICE, torch.int32)
            for causal, clamp in ((False, False), (True, False)) + (((False, True),) if s == 500 else ()):
                qkv = (clamp_qkv(b, s, heads, hd, gen) if clamp else
                       1.5 * torch.randn(b, s, 3 * heads * hd, generator=gen)).to(DEVICE, torch.bfloat16)
                g = torch.randn(b, s, heads * hd, generator=gen).to(DEVICE, torch.bfloat16)
                label = (f"K7 wgmma Dh={hd} S={s}{' causal' if causal else ''}"
                         f"{' (logits above the clamp)' if clamp else ''}")
                if clamp:
                    q, k, _ = (kern.split_heads(t, heads).float() for t in qkv.chunk(3, dim=-1))
                    top = torch.minimum((q * kern.q_scale(hd, torch.bfloat16)).to(torch.bfloat16).float()
                                        @ k.transpose(-1, -2), kern._kbias(mask, s, False)).amax(dim=-1)
                    check(bool((top[[0, 1, 3]] >= 80.0).all()), f"{label}: a row does not reach the clamp")
                got = kern.attention_bwd(qkv, mask, g, heads, causal)
                err = max(err, compare(label, got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), *tol))
                check(bool((got[2] == 0).all()), f"{label}: the all-masked clip's gradients are not 0")
    return err


def wide_head_checks(gen):
    """Phase 9: heads past 128 columns (run in pieces of 128), Dh 160, 192,
    256 and 384 (2 heads, B=4, S=300, an all-masked clip) in bf16 and fp32:
    the attention link, K4 causal, K5's strides, K7 causal and not; and a
    K1 chain (`fused_layer`) at width 768 with 3 heads of Dh 256."""
    b, s, heads = 4, 300, 2
    mask = (torch.arange(s)[None, :] < torch.tensor([300, 123, 0, 17])[:, None]).to(DEVICE, torch.int32)
    errs = {"K4": 0.0, "K5": 0.0, "K7": 0.0, "k1_wide_chain": 0.0}
    for hd in (160, 192, 256, 384):
        d = heads * hd
        for dt in (torch.bfloat16, torch.float32):
            qkv = (1.5 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            g = torch.randn(b, s, d, generator=gen).to(DEVICE, dt)
            q, kv = qkv[..., :d].contiguous(), qkv[..., d:].contiguous()
            name = f"Dh={hd} {_dt_name(dt)}"
            for label, got, ref, tol, key in (
                    ("attention link", kern.attention(qkv, mask, heads),
                     kern.attention_plain(qkv, mask, heads), TOL[dt]["kernel"], "K4"),
                    ("K4 causal", kern.attention_k4(qkv, mask, heads, True),
                     kern.attention_plain(qkv, mask, heads, True), TOL[dt]["kernel"], "K4"),
                    ("K5 strides", kern.attention_k5(q, kv, mask, heads),
                     kern.attention_split_plain(q, kv, mask, heads), TOL[dt]["kernel"], "K5"),
                    ("K7", kern.attention_bwd(qkv, mask, g, heads),
                     kern.attention_bwd_plain(qkv, mask, g, heads), TOL[dt]["k7"], "K7"),
                    ("K7 causal", kern.attention_bwd(qkv, mask, g, heads, True),
                     kern.attention_bwd_plain(qkv, mask, g, heads, True), TOL[dt]["k7"], "K7")):
                errs[key] = max(errs[key], compare(f"{label} {name}", got, ref, *tol))
                check(bool((got[2] == 0).all()), f"{label} {name}: the all-masked clip is not 0")
    blk = ViTBlock(D, INTER, torch.Generator().manual_seed(SEED + 9)).to(DEVICE)
    for dt in (torch.bfloat16, torch.float32):
        x, m = layer_inputs(b, s, D, dt, gen, [300, 123, 0, 17])
        errs["k1_wide_chain"] = max(errs["k1_wide_chain"], compare(
            f"K1 chain, 3 heads of Dh=256, {_dt_name(dt)}", ea.fused_layer(blk, x, m, 3, 1e-6),
            ea.fused_layer_plain(blk, x, m, 3, 1e-6), *TOL[dt]["chain"]))
    return errs


# Logits far above the clamp (q, k of scale 8): fp32 keeps 1e-4 relative
# but logits of a few hundred carry ~1e-5 of absolute rounding into p, so
# 5e-3 absolute (as tests/test_torch_cuda.py); bf16 rows whose every
# attended logit lies below -70 are left out (the tensor cores flush
# p·v·2^-24 below fp32's normal range where the plain version keeps it).
TOL_CLAMP = {torch.float32: (5e-3, 1e-4), torch.bfloat16: (6e-2, 2e-2)}


def head_dim_checks(gen):
    """Phase 9: the attention link, K4 (causal) and K7 at head dims 16, 32
    and 128 (8 heads, B=4, S=500, bf16 and fp32; bf16 through the mma.sync
    kernel), an all-masked clip, and logits far above the clamp."""
    b, s, heads = 4, 500, 8
    mask = (torch.arange(s)[None, :] < torch.tensor([500, 321, 0, 17])[:, None]).to(DEVICE, torch.int32)
    errs = {"K4": 0.0, "K7": 0.0}
    for hd in (16, 32, 128):
        d = heads * hd
        for dt in (torch.bfloat16, torch.float32):
            qkv = (1.5 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            g = torch.randn(b, s, d, generator=gen).to(DEVICE, dt)
            name = f"Dh={hd} {_dt_name(dt)}"
            for label, got, ref, tol, key in (
                    ("attention link", kern.attention(qkv, mask, heads),
                     kern.attention_plain(qkv, mask, heads), TOL[dt]["kernel"], "K4"),
                    ("K4 causal", kern.attention_k4(qkv, mask, heads, True),
                     kern.attention_plain(qkv, mask, heads, True), TOL[dt]["kernel"], "K4"),
                    ("K7", kern.attention_bwd(qkv, mask, g, heads),
                     kern.attention_bwd_plain(qkv, mask, g, heads), TOL[dt]["k7"], "K7"),
                    ("K7 causal", kern.attention_bwd(qkv, mask, g, heads, True),
                     kern.attention_bwd_plain(qkv, mask, g, heads, True), TOL[dt]["k7"], "K7")):
                errs[key] = max(errs[key], compare(f"{label} {name}", got, ref, *tol))
                check(bool((got[2] == 0).all()), f"{label} {name}: the all-masked clip is not 0")
            big = (8.0 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            got, ref = kern.attention(big, mask, heads), kern.attention_plain(big, mask, heads)
            q, k, _ = (kern.split_heads(t, heads).float() for t in big.chunk(3, dim=-1))
            top = torch.minimum((q * kern.q_scale(hd, dt)).to(dt).float() @ k.transpose(-1, -2),
                                kern._kbias(mask, s, False)).amax(dim=-1)
            rows = kern.merge_heads((top > -70.0)[..., None].expand(-1, -1, -1, hd))
            clamped = float((top >= 80.0).float()[:2].mean())
            if dt == torch.float32:
                rows = torch.ones_like(rows)
            compare(f"attention link {name}, logits above the clamp ({clamped:.2f} of rows)",
                    got[rows], ref[rows], *TOL_CLAMP[dt])
            check(clamped > 0.3, f"{name}: too few rows reach the clamp ({clamped})")
            check(bool((got[2] == 0).all()), f"clamp case {name}: the all-masked clip is not 0")
    return errs


def train_batch(cfg, rs, b: int, seconds: int, seq_len: int):
    """A stage-2 batch on the card: synthetic clips of 3 s to `seconds` s
    through `device_train_frontend` (every patch of the buffer, then a
    sorted random subset of seq_len), and token ids of 8-100 tokens."""
    front = configs.FrontendConfig()
    samples = seconds * front.sample_rate
    lens = rs.randint(3 * front.sample_rate, samples + 1, size=b).astype(np.int32)
    bufs = np.zeros((b, samples), np.float32)
    for i, n in enumerate(lens):
        bufs[i, :n] = 0.1 * rs.randn(n)
    full = num_patches_for_samples(samples, front, configs.PatchConfig())
    frontend = device_train_frontend(front, configs.PatchConfig(patches_seq_len=max(full, seq_len)),
                                     seq_len)
    batch = frontend(torch.Generator(device=DEVICE).manual_seed(SEED),
                     torch.from_numpy(bufs).to(DEVICE), torch.from_numpy(lens).to(DEVICE))
    tmask = (np.arange(TEXT_LEN)[None] < rs.randint(8, TEXT_LEN + 1, size=b)[:, None]).astype(np.int32)
    ids = np.where(tmask > 0, rs.randint(4, cfg.text.vocab_size, size=(b, TEXT_LEN)), 1)
    batch["text_input_ids"] = torch.from_numpy(ids.astype(np.int32)).to(DEVICE)
    batch["text_mask"] = torch.from_numpy(tmask).to(DEVICE)
    check(batch["audio_patches"].shape == (b, seq_len, 256), f"patch batch {batch['audio_patches'].shape}")
    return batch


def no_text_dropout(cfg):
    text = dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0)
    dec = dataclasses.replace(cfg.decoder, hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(cfg, text=text, decoder=dec)


NO_SERVING_KERNELS = {"k1_layer": 0, "k2_block": 0, "k3_block": 0, "k3_layer": 0, "k6_attn": 0,
                      "attention": 0, "gemm": 0, "layer_norm": 0, "log_mel": 0,
                      "log_mel_fast": 0}  # training runs none of the serving kernels


def device_busy_ms(fn, n: int):
    """fn run n times under torch.profiler (device activity only) →
    (device busy ms per run: the union of the intervals of every kernel,
    copy and memset on the card; host wall ms per run, profiler included;
    device operations per run)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    check(busy > 0, "the profiler recorded no device time")
    return busy / 1e3 / n, wall, len(spans) / n


def host_us(fn, n: int = 50) -> float:
    """Host microseconds per call of fn (the enqueue: argument checks,
    tensor maps, the launch), the device left to catch up afterwards."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return t


def time_steps(step, state, batch, gen, n: int):
    """n more steps, each timed on the host clock between synchronisations
    → (state, sorted ms)."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, sorted(ms)


def train_bf16_phase(cfg, rs):
    """Phase 10: the bf16 10-s step at caco_base, B=16, 5 steps on one batch
    (text dropout 0.1 as configured), then 6 timed steps."""
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    n = cfg.audio.num_layers
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(DEVICE)
    state = train.init_train_state(model, tc)
    step = train.make_caco_train_step(cfg, tc)
    batch = train_batch(cfg, rs, TRAIN_BATCH, 10, 500)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    print(f"phase 10: bf16 10-s training step, caco_base, B={TRAIN_BATCH}, 500 patches, "
          f"{TEXT_LEN} tokens, {TRAIN_STEPS} steps")
    metrics = []

    def steps():
        nonlocal state
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch, gen)
            metrics.append({k: float(v) for k, v in m.items()})

    torch.cuda.reset_peak_memory_stats()
    _, got = drive("bf16 10-s train step x5", steps,
                   {"k4": n * TRAIN_STEPS, "k7": n * TRAIN_STEPS, "k5": 0, **NO_SERVING_KERNELS})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    print(f"  loss {['%.5f' % v for v in losses]}\n  grad_norm {['%.4f' % v for v in norms]}\n"
          f"  peak device memory {peak:.2f} GiB")
    check(all(np.isfinite(losses + norms)), "non-finite loss or grad_norm")
    check(losses[4] < losses[1], "the loss did not fall from step 1 to step 4")
    state, ms = time_steps(step, state, batch, gen, 6)
    print(f"  step times {['%.2f' % v for v in ms]} ms, median {np.median(ms):.2f} ms/step")

    def one_step():
        nonlocal state
        state, m = step(state, batch, gen)
        float(m["loss"])

    busy, wall, ops = device_busy_ms(one_step, 3)
    print(f"  device busy {busy:.2f} ms/step (union of device intervals, 3 steps under the "
          f"profiler, {wall:.2f} ms wall/step there, idle share {1 - busy / wall:.3f}, "
          f"{ops:.0f} device operations/step)")
    del state, model
    return got, {"loss": losses, "grad_norm": norms, "peak_gib": peak, "step_ms": ms,
                 "median_step_ms": float(np.median(ms)), "device_busy_ms": busy,
                 "profiled_wall_ms": wall, "device_ops_per_step": ops}


def train_fp32_phase(cfg, rs):
    """Phase 11: the fp32 10-s step (text dropout off, so the card and the
    CPU compute the same function); then loss and gradients at B=2 against
    the CPU's plain versions, from the same fresh parameters."""
    cfg = no_text_dropout(dataclasses.replace(cfg, dtype=torch.float32))
    n = cfg.audio.num_layers
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    batch = train_batch(cfg, rs, TRAIN_BATCH, 10, 500)
    print(f"phase 11: fp32 10-s training step, caco_base, B={TRAIN_BATCH}")
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(DEVICE)
    state = train.init_train_state(model, tc)
    step = train.make_caco_train_step(cfg, tc)
    (_, m), got = drive("fp32 10-s train step", lambda: step(state, batch, None),
                        {"k4": n, "k7": 0, "k5": 0, **NO_SERVING_KERNELS})
    check(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])),
          "fp32 step: non-finite loss or grad_norm")
    state, ms = time_steps(step, state, batch, None, 3)
    print(f"  step times {['%.2f' % v for v in ms]} ms")
    del state, model
    loss_fn = train.make_caco_loss(cfg, tc)
    small = {k: v[:2] for k, v in batch.items()}
    out = []
    for device in (DEVICE, "cpu"):
        net = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(device)
        loss, _ = loss_fn(net, {k: v.to(device) for k, v in small.items()}, None)
        loss.backward()
        out.append((float(loss.detach()), torch.cat([p.grad.flatten().double().cpu() for p in net.parameters()])))
        del net
    (l_card, g_card), (l_cpu, g_cpu) = out
    l_err = abs(l_card - l_cpu) / abs(l_cpu)
    g_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    print(f"  B=2 card vs CPU plain: loss {l_card:.6f} vs {l_cpu:.6f} (rel {l_err:.2e} ≤ "
          f"{STEP_TOL['loss']}), gradients rel L2 {g_err:.2e} (≤ {STEP_TOL['grads']})")
    check(l_err <= STEP_TOL["loss"] and g_err <= STEP_TOL["grads"],
          "fp32 step on the card disagrees with the CPU")
    return got, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "step_ms": ms,
                 "b2_loss_rel_err": l_err, "b2_grad_rel_err": g_err}


def train_30s_phase(cfg, rs):
    """Phase 12: the bf16 30-s step, B=4, 1500 patches (blocked plan, 1536)."""
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    n = cfg.audio.num_layers
    check(ea.kernel_plan(1500, D, torch.bfloat16) == ("blocked", 1536, 256), "30-s plan")
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(DEVICE)
    state = train.init_train_state(model, tc)
    step = train.make_caco_train_step(cfg, tc)
    batch = train_batch(cfg, rs, TRAIN_BATCH_30, 30, 1500)
    print(f"phase 12: bf16 30-s training step, caco_base, B={TRAIN_BATCH_30}, 1500 patches")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    (state, m), got = drive("bf16 30-s train step", lambda: step(state, batch, gen),
                            {"k5": n, "k4": 0, "k7": 0, **NO_SERVING_KERNELS})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])),
          "30-s step: non-finite loss or grad_norm")
    state, ms = time_steps(step, state, batch, gen, 3)
    print(f"  loss {float(m['loss']):.5f}, grad_norm {float(m['grad_norm']):.4f}, "
          f"peak device memory {peak:.2f} GiB, step times {['%.2f' % v for v in ms]} ms")
    del state, model
    return got, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "peak_gib": peak,
                 "step_ms": ms}


def cosine_rows(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def check_embeddings(name, emb, n, cfg):
    check(emb.shape == (n, cfg.projection_size), f"{name}: shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), f"{name}: non-finite values")
    dev = float(np.abs(np.linalg.norm(emb, axis=-1) - 1.0).max())
    check(dev <= 1e-3, f"{name}: embedding norms off by {dev}")


def embed_by_layers(model, cfg, batch, layer):
    """The pooled, normalized audio embedding with every encoder layer run
    by `layer(blk, x, mask)` (get_audio_embedding's computation, the layer
    driven from outside)."""
    mask = batch["audio_mask"]
    x = audio_input_embedding(model.audio, cfg.audio, batch["audio_patches"],
                              batch["audio_time_inds"], batch["audio_freq_inds"], cfg.dtype)
    for blk in model.audio.blocks:
        x = layer(blk, x, mask)
    hidden = layer_norm(model.audio.ln_f, x, LN_EPS)
    return caco._normalize(caco.audio_pooler_apply(model.audio_pool, cfg, hidden, mask))


def device_buffers(wavs, seconds: int):
    """(B, seconds · 16 k) zero-padded buffers and (B,) lengths on the card."""
    bufs = np.zeros((len(wavs), seconds * 16000), np.float32)
    for i, w in enumerate(wavs):
        bufs[i, :len(w)] = w[:bufs.shape[1]]
    lens = np.asarray([min(len(w), bufs.shape[1]) for w in wavs], np.int32)
    return torch.from_numpy(bufs).to(DEVICE), torch.from_numpy(lens).to(DEVICE)


@torch.inference_mode()
def variant_paths_phase(cfg, model, engine, engine30, wavs, wavs30):
    """Phase 8b: the paths of K6, K3′ and K8′ at caco_base, bf16, seed 0,
    each through its own entry point: a 12-layer 10-s encoder (B=32,
    S=496) through route "k6"; a 12-layer 30-s encoder (B=8, 1536 patches)
    through `try_fused_layer(allow_blocked=True)`; `fused_batch_wav_to_patches`
    with fast_dft on 10-s and 30-s buffers."""
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    n, dt = cfg.audio.num_layers, torch.bfloat16
    print("phase 8b: the K6, K3′ and K8′ paths at caco_base, bf16")
    check(ea.layer_route(496, D, INTER, dt) == ("k1", 496)
          and ea.fused_ln_attention_applies(496, D, dt), "K6 does not apply at S=496")
    out = {}
    batch = engine.audio_patch_batch(wavs[:BATCH])[0]
    ref = get_audio_embedding(model, cfg, **batch)[0].float().cpu().numpy()
    emb, out["K6"] = drive("bf16 10-s encoder, every layer through route k6",
                           lambda: embed_by_layers(model, cfg, batch,
                                                   lambda b, x, m: encoder_layer(b, x, m, H, "k6", dt)),
                           {"k6_attn": n, "k1_layer": 0, "k2_block": 0, "attention": n})
    emb = emb.float().cpu().numpy()
    check_embeddings("route k6", emb, BATCH, cfg)
    cos_k6 = float(cosine_rows(emb, ref).min())

    b30 = VARIANT_BATCH_30
    batch30 = {k: v[:b30] for k, v in engine30.audio_patch_batch(wavs30[:b30])[0].items()}
    check(batch30["audio_patches"].shape[1] == 1536, "30-s batch is not at 1536 patches")

    def k3_prime(b, x, m):
        y = ea.try_fused_layer(b, x, m, H, LN_EPS, dt, allow_blocked=True)
        check(y is not None, "try_fused_layer(allow_blocked=True) declined at 1536 patches")
        return y

    ref30 = get_audio_embedding(model, cfg, **batch30)[0].float().cpu().numpy()
    emb30, out["K3′"] = drive("bf16 30-s encoder through try_fused_layer(allow_blocked=True)",
                              lambda: embed_by_layers(model, cfg, batch30, k3_prime),
                              {"k3_layer": n, "k3_block": 0, "k1_layer": 0})
    emb30 = emb30.float().cpu().numpy()
    check_embeddings("K3′ path", emb30, b30, cfg)
    cos_k3p = float(cosine_rows(emb30, ref30).min())
    print(f"  cosine route k6 vs k1 (10 s, {BATCH} clips, min) {cos_k6:.7f}; K3′ vs K3 (30 s, "
          f"{b30} clips, min) {cos_k3p:.7f} (≥ {COS_VARIANT})")
    check(cos_k6 >= COS_VARIANT and cos_k3p >= COS_VARIANT, "a variant path disagrees with its default")

    front = configs.FrontendConfig()
    errs = {}
    for seconds, clips, eng in ((10, wavs[:BATCH], engine), (30, wavs30[:b30], engine30)):
        bufs, lens = device_buffers(clips, seconds)
        fast_k8p = 1 if seconds == 10 else 0
        fast, got = drive(f"fused_batch_wav_to_patches(fast_dft=True), {seconds}-s buffers",
                          lambda: fused.fused_batch_wav_to_patches(bufs, lens, front, eng.patch,
                                                                   fast_dft=True),
                          {"log_mel_fast": fast_k8p, "log_mel": 1 - fast_k8p})
        exact = fused.fused_batch_wav_to_patches(bufs, lens, front, eng.patch)
        for k in ("audio_mask", "audio_time_inds", "audio_freq_inds"):
            check(torch.equal(fast[k], exact[k]), f"fast_dft {seconds} s: {k} differs")
        if seconds == 30:
            check(torch.equal(fast["audio_patches"], exact["audio_patches"]),
                  "fast_dft at 30 s is not the exact path")
            continue
        out["K8′"] = got
        frames = seconds * 100
        plain = fused.fused_log_mel_plain(fused.buffer_to_rows(bufs, frames, front), front, frames,
                                          fast_dft=True)
        valid = -(-lens // front.hop_length)
        ref = patchify_spectrogram(plain, valid, eng.patch)["audio_patches"]
        errs[seconds] = compare("fast_dft patches, 10 s, vs the plain K8′", fast["audio_patches"],
                                ref, *TOL["log_mel"])
    print("  fast_dft patches at 30 s: the exact path's (JAX's exact fallback)")
    return out, {"cos_k6_vs_k1": cos_k6, "cos_k3prime_vs_k3": cos_k3p,
                 "fast_dft_patch_err_10s": errs[10]}


def grad_phase(cfg, model, wavs):
    """Phase 8c: gradients through the inference encoder (the fused routes'
    JAX backward).  bf16 10 s, B=8, loss = Σ embedding · a fixed random
    vector: K1 12 times in the forward, every block parameter's gradient
    present and finite.  fp32 at B=2 (K2 route): the card's gradients
    against the same computation on the CPU."""
    n = cfg.audio.num_layers
    print("phase 8c: gradients through the inference encoder (audio_encoder_apply, train=False)")
    vec = torch.randn(cfg.projection_size, generator=torch.Generator().manual_seed(SEED + 7))

    def patch_batch(dt, clips):
        engine = CacoEngine(cfg, model, device=DEVICE, batch_size=len(clips), dtype=dt)
        return {k: v.clone() for k, v in engine.audio_patch_batch(clips)[0].items()}

    def loss_backward(net, cfg_dt, batch):
        emb, _ = get_audio_embedding(net, cfg_dt, **batch)
        (emb @ vec.to(emb.device)).sum().backward()

    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    batch = patch_batch(torch.bfloat16, wavs[:GRAD_BATCH])
    model.zero_grad(set_to_none=True)
    _, got = drive(f"bf16 10-s encoder forward + backward, B={GRAD_BATCH}",
                   lambda: loss_backward(model, cfg16, batch),
                   {"k1_layer": n, "k2_block": 0, "k6_attn": 0, "k7": 0})
    blocks = list(model.audio.blocks.named_parameters())
    bad = [k for k, p in blocks if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"bf16 block parameters without a finite gradient: {bad[:4]}")
    print(f"  {len(blocks)} block parameters, every gradient present and finite")

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    batch = patch_batch(torch.float32, wavs[:2])
    model.zero_grad(set_to_none=True)
    drive("fp32 10-s encoder forward + backward, B=2", lambda: loss_backward(model, cfg32, batch),
          {"k2_block": n, "k1_layer": 0})
    cpu_model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    loss_backward(cpu_model, cfg32, {k: v.cpu() for k, v in batch.items()})
    grads = []
    for net in (model, cpu_model):
        params = list(net.audio.parameters()) + list(net.audio_pool.parameters())
        check(all(p.grad is not None for p in params), "an audio parameter has no gradient")
        grads.append(torch.cat([p.grad.flatten().double().cpu() for p in params]))
    rel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    print(f"  fp32 gradients card vs CPU (audio encoder + pooler), rel L2 {rel:.2e} (≤ {GRAD_TOL})")
    check(rel <= GRAD_TOL, "fp32 gradients on the card disagree with the CPU")
    model.zero_grad(set_to_none=True)
    return got, {"fp32_grad_rel_err": rel, "bf16_block_params_with_grad": len(blocks)}


def tiny_engine_phase(wavs):
    """Phase 5b: CacoEngine at caco_tiny width (hidden 32, 2 heads of Dh 16)
    in bf16 on the card, every audio layer on K1 with the mma.sync attention
    link; its embeddings against the CPU engine's in bf16 and in fp32."""
    cfg = configs.caco_tiny()
    clips = wavs[:40]
    n_buckets = -(-len(clips) // BATCH)
    engine = CacoEngine(cfg, caco_init(cfg, torch.Generator().manual_seed(SEED)), device=DEVICE,
                        batch_size=BATCH, dtype=torch.bfloat16)
    print(f"phase 5b: caco_tiny bf16 10-s engine on cuda (Dh {cfg.audio.hidden_size // cfg.audio.num_heads})")
    emb, got = drive("caco_tiny bf16 embed_audio",
                     lambda: engine.embed_audio(clips),
                     {"k1_layer": cfg.audio.num_layers * n_buckets, "k2_block": 0, "k3_block": 0,
                      "attention": cfg.audio.num_layers * n_buckets})
    check_embeddings("caco_tiny audio", emb, len(clips), cfg)
    cos = {}
    for dt in (torch.bfloat16, torch.float32):
        cpu = CacoEngine(cfg, caco_init(cfg, torch.Generator().manual_seed(SEED)), device="cpu",
                         batch_size=BATCH, dtype=dt)
        cos[_dt_name(dt)] = float(cosine_rows(emb, cpu.embed_audio(clips)).min())
    print(f"  cosine card bf16 vs CPU ({len(clips)} clips, min): bf16 {cos['bfloat16']:.7f}, "
          f"fp32 {cos['float32']:.7f} (≥ 0.999)")
    check(min(cos.values()) >= 0.999, "caco_tiny bf16 on the card disagrees with the CPU engine")
    return got, cos


def byte_tokenizer():
    """Degenerate byte-level BPE: specials + all 256 byte symbols, no merges."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in _bytes_to_unicode().values():
        vocab[c] = len(vocab)
    return ByteLevelBPETokenizer(vocab, [])


@torch.inference_mode()
def timing_phase(blk, label):
    """Phase 13: per-layer K1 chain and each kernel vs plain at B=32, S=496,
    bf16 (a kernel's time is the sum over its calls in one layer); the K2
    block in fp32 at S=496, the K3 block and the K3′ layer in bf16 at
    S=1536, K6 in bf16 at S=496, and K8 and K8′ at 1000 and 3000 frames,
    all at B=32; K4 and K7 at the 10-s step's shape (B=16,
    S=500, bf16) and K5 at the 30-s step's (B=4, S=1500 padded to 1536)."""
    b, s, d, h = BATCH, 496, D, H
    gen = torch.Generator().manual_seed(SEED + 1)
    lengths = list(np.random.RandomState(SEED).randint(48, 497, size=b))
    x, mask = layer_inputs(b, s, d, torch.bfloat16, gen, lengths)
    times, bounds = {}, {}
    hd, m = d // h, b * s
    w_layer, w_block = 3 * d * d + d * d + 2 * d * INTER, 4 * d * d
    bounds["k1_layer"] = bound({"bf16": 2 * m * w_layer + attn_flops(h, hd, s, lengths)},
                               2 * (2 * m * d + w_layer))
    bounds["k6_attn"] = bound({"bf16": 2 * m * 3 * d * d + attn_flops(h, hd, s, lengths)},
                              2 * (2 * m * d + 3 * d * d))
    for key, cases in layer_cases(blk, x, mask, h).items():
        kernel, plain = getattr(kern, key), getattr(kern, key + "_plain")
        times[key] = paired_ms(lambda: [kernel(*a) for _, a in cases],
                               lambda: [plain(*a) for _, a in cases], 10)
    times["k1_layer"] = paired_ms(lambda: ea.fused_layer(blk, x, mask, h, 1e-6),
                                  lambda: ea.fused_layer_plain(blk, x, mask, h, 1e-6), 10)
    for key, dt, s_blk, blocked in (("k2_block", torch.float32, 496, False),
                                    ("k3_block", torch.bfloat16, 1536, True)):
        lens = list(np.random.RandomState(SEED).randint(s_blk // 10, s_blk + 1, size=b))
        xb, mb = layer_inputs(b, s_blk, d, dt, gen, lens)
        size = 4 if dt == torch.float32 else 2
        bounds[key] = bound({"fp32" if size == 4 else "bf16":
                             2 * b * s_blk * w_block + attn_flops(h, hd, s_blk, lens)},
                            size * (3 * b * s_blk * d + w_block))
        variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK) if blocked else ("one_shot",)
        times[key] = paired_ms(lambda: ea.fused_block_attention(blk, xb, mb, h, 1e-6, variant),
                               lambda: ea.fused_block_attention_plain(blk, xb, mb, h, 1e-6, variant),
                               5)
    qkv, m16 = layer_inputs(TRAIN_BATCH, 500, 3 * d, torch.bfloat16, gen,
                            list(np.random.RandomState(SEED).randint(100, 501, size=TRAIN_BATCH)))
    g = torch.randn(TRAIN_BATCH, 500, d, generator=gen).to(DEVICE, torch.bfloat16)
    valid16 = m16.sum(dim=1).tolist()
    bounds["k4"] = bound({"bf16": attn_flops(h, hd, 500, valid16)}, 2 * TRAIN_BATCH * 500 * 4 * d)
    bounds["k7"] = bound({"bf16": attn_flops(h, hd, 500, valid16, products=5)},
                         2 * TRAIN_BATCH * 500 * 7 * d)
    times["k4"] = paired_ms(lambda: kern.attention_k4(qkv, m16, h),
                            lambda: kern.attention_plain(qkv, m16, h), 10)
    times["k7"] = paired_ms(lambda: kern.attention_bwd(qkv, m16, g, h),
                            lambda: kern.attention_bwd_plain(qkv, m16, g, h), 10)
    lens = list(np.random.RandomState(SEED).randint(150, 1501, size=TRAIN_BATCH_30))
    q, m4 = layer_inputs(TRAIN_BATCH_30, 1500, d, torch.bfloat16, gen, lens)
    kv, _ = layer_inputs(TRAIN_BATCH_30, 1500, 2 * d, torch.bfloat16, gen, lens)
    bounds["k5"] = bound({"bf16": attn_flops(h, hd, 1500, lens)}, 2 * TRAIN_BATCH_30 * 1500 * 4 * d)
    times["k5"] = paired_ms(lambda: ea.encoder_attention_blocked(q, kv, m4, h),
                            lambda: ea.encoder_attention_blocked_plain(q, kv, m4, h), 10)
    # the K5 call against its kernel alone, and the host time per call
    host = {"k5_kernel_ms": cuda_ms(lambda: kern.attention_k5(q, kv, m4, h), 10),
            "k5_call_host_us": host_us(lambda: ea.encoder_attention_blocked(q, kv, m4, h)),
            "k5_host_us": host_us(lambda: kern.attention_k5(q, kv, m4, h)),
            "k4_host_us": host_us(lambda: kern.attention_k4(qkv, m16, h)),
            "k4_kernel_ms": times["k4"][0]}
    print(f"  K5 call (B=4, S=1500, no padding copy) {times['k5'][0]:.4f} ms, the kernel alone "
          f"{host['k5_kernel_ms']:.4f} ms; host per call: K5 {host['k5_host_us']:.1f} us "
          f"(encoder_attention_blocked {host['k5_call_host_us']:.1f} us), K4 {host['k4_host_us']:.1f} us "
          f"against its kernel's {1e3 * times['k4'][0]:.1f} us ({label})")
    times["k6_attn"] = paired_ms(
        lambda: ea.fused_ln_attention(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6),
        lambda: ea.fused_ln_attention_plain(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6), 10)
    lens = list(np.random.RandomState(SEED).randint(153, 1537, size=b))
    x30, m30 = layer_inputs(b, 1536, d, torch.bfloat16, gen, lens)
    bounds["k3_layer"] = bound({"bf16": 2 * b * 1536 * w_layer + attn_flops(h, hd, 1536, lens)},
                               2 * (2 * b * 1536 * d + w_layer))
    variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK)
    times["k3_layer"] = paired_ms(lambda: ea.fused_layer(blk, x30, m30, h, 1e-6, variant),
                                  lambda: ea.fused_layer_plain(blk, x30, m30, h, 1e-6, variant), 5)
    front = configs.FrontendConfig()
    for frames in (1000, 3000):
        bufs = 0.1 * torch.randn(b, frames * 160, generator=gen)
        rows = fused.buffer_to_rows(bufs.to(DEVICE), frames, front)
        bins = front.fft_size // 2 + 1
        dft, mel = 2 * b * frames * front.window_length * 2 * bins, 2 * b * frames * bins * front.num_mels
        nbytes = 4 * (rows.numel() + b * frames * front.num_mels)
        bounds[f"log_mel_{frames}"] = bound({"fp32": dft + mel}, nbytes)
        bounds[f"log_mel_fast_{frames}"] = bound({"bf16": 3 * dft, "fp32": mel}, nbytes)
        times[f"log_mel_{frames}"] = paired_ms(lambda: fused.fused_log_mel(rows, front, frames),
                                               lambda: fused.fused_log_mel_plain(rows, front, frames),
                                               10)
        times[f"log_mel_fast_{frames}"] = paired_ms(
            lambda: fused.fused_log_mel(rows, front, frames, fast_dft=True),
            lambda: fused.fused_log_mel_plain(rows, front, frames, fast_dft=True), 10)
    what = {"layer_norm": "LN1 + LN2 (bf16, S=496)", "gemm": "4 products, one layer (bf16, S=496)",
            "attention": "attention (bf16, S=496)", "k1_layer": "K1 chain, one layer (bf16, S=496)",
            "k2_block": "K2 block (fp32, S=496)", "k3_block": "K3 block (bf16, S=1536)",
            "k4": "K4 (bf16, B=16, S=500)", "k7": "K7 (bf16, B=16, S=500)",
            "k5": "K5 (bf16, B=4, S=1500 → 1536)",
            "log_mel_1000": "K8 log-mel (1000 frames)", "log_mel_3000": "K8 log-mel (3000 frames)",
            "k6_attn": "K6 LN1 → QKV → attention (bf16, S=496)",
            "k3_layer": "K3′ layer (bf16, S=1536)",
            "log_mel_fast_1000": "K8′ log-mel (1000 frames)",
            "log_mel_fast_3000": "K8′ log-mel (3000 frames)"}
    for k, (km, pm) in times.items():
        bms = f"  bound {bounds[k][0]:.4f} ms ({bounds[k][1]})" if k in bounds else ""
        print(f"  {what[k]:<38} kernel {km:.4f} ms  plain {pm:.4f} ms{bms}  ({label})")
    return times, bounds, host


def sdpa_backend(q, k, v, am) -> str:
    """The CUDA kernels one SDPA call launches (its backend), by the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    picked = [n for n in names if any(w in n.lower() for w in ("sdpa", "fmha", "flash", "attention", "attn"))]
    return "; ".join(n[:90] for n in (picked or names))


def links_phase(blk, label):
    """Phase 13, the redesigned kernels against one PyTorch call each, in
    turns (kernel, library, library, kernel): the bf16 GEMM link at the four
    10-s products (M = 32·496) and the 30-s QKV and o-proj (M = 32·1536)
    against torch.matmul on the same operands (the epilogue is left out of
    the library call); the bf16 attention link at S = 496 and 1536 (B = 32),
    K4 (B=16, S=500) and K5 (B=4, S=1536, 1500 valid at most) against
    F.scaled_dot_product_attention on the same Q, K, V as (B, H, S, Dh)
    views with the key mask as a boolean attn_mask; K7 against SDPA's
    backward (forward + backward less forward); K2's fp32 links, the
    LayerNorm link and K8's three calls (torch.stft, the mel product, the
    log)."""
    gen = torch.Generator().manual_seed(SEED + 8)
    d, h, hd = D, H, D // H
    out = {}

    def report(key, what, km, lm, ops, nbytes):
        b_ms, by = bound(ops, nbytes)
        flops = sum(ops.values())
        out[key] = {"what": what, "ms": km, "library_ms": lm, "bound_ms": b_ms, "bound_by": by,
                    "tflops": flops / km / 1e9, "library_tflops": flops / lm / 1e9,
                    "share_of_bound": b_ms / km}
        print(f"  {what:<44} kernel {km:.4f} ms ({flops / km / 1e9:.0f} TFLOP/s, "
              f"{b_ms / km:.2f} of its bound {b_ms:.4f} ms)  library {lm:.4f} ms ({label})")

    with torch.no_grad():
        for seconds, m in ((10, BATCH * 496), (30, BATCH * 1536)):
            shapes = [("qkv", 3 * d, d, kern.EPI_BIAS), ("o-proj", d, d, kern.EPI_BIAS_RESID_F32),
                      ("mlp up", INTER, d, kern.EPI_BIAS_SILU),
                      ("mlp down", d, INTER, kern.EPI_BIAS_CAST_ADD)]
            for name, n, k, epi in shapes[: 4 if seconds == 10 else 2]:
                a = torch.randn(m, k, generator=gen).to(DEVICE, torch.bfloat16)
                w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(DEVICE, torch.bfloat16)
                bias = torch.randn(n, generator=gen).to(DEVICE)
                r = torch.randn(m, n, generator=gen).to(DEVICE, torch.bfloat16)
                lm, km = paired_ms(lambda: torch.matmul(a, w), lambda: kern.gemm(a, w, bias, epi, r), 10)
                resid = m * n * 2 if epi in (kern.EPI_BIAS_RESID_F32, kern.EPI_BIAS_CAST_ADD) else 0
                report(f"gemm_{seconds}s_{name}", f"gemm {name}, {seconds} s (M={m} N={n} K={k})",
                       km, lm, {"bf16": 2 * m * n * k}, 2 * (m * k + k * n + m * n) + resid + 4 * n)
            del a, w, r

        def attn_case(key, what, b, s, valid_max, split=False, dt=torch.bfloat16):
            lens = list(np.random.RandomState(SEED).randint(valid_max // 10, valid_max + 1, size=b))
            x = (1.5 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            mask = (torch.arange(s)[None, :] < torch.tensor(lens)[:, None]).to(DEVICE, torch.int32)
            if split:
                q, kv = x[..., :d].contiguous(), x[..., d:].contiguous()
                kfn = lambda: kern.attention_k5(q, kv, mask, h)  # noqa: E731
                qs, ks, vs = (kern.split_heads(t, h) for t in (q, *kv.chunk(2, dim=-1)))
            else:
                kfn = (lambda: kern.attention_k4(x, mask, h)) if key.startswith("k4") else (  # noqa: E731
                    lambda: kern.attention(x, mask, h))
                qs, ks, vs = (kern.split_heads(t, h) for t in x.chunk(3, dim=-1))
            am = (mask > 0)[:, None, None, :]
            lm, km = paired_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am), kfn, 10)
            size, kind = (4, "fp32") if dt == torch.float32 else (2, "bf16")
            report(key, what, km, lm, {kind: attn_flops(h, hd, s, lens)}, size * b * s * 4 * d)
            out[key]["sdpa_backend"] = sdpa_backend(qs, ks, vs, am)
            return x, mask, lens

        attn_case("attention_10s", "attention, 10 s (B=32, S=496)", BATCH, 496, 496)
        attn_case("attention_30s", "attention, 30 s (B=32, S=1536)", BATCH, 1536, 1536)
        qkv16, m16, lens16 = attn_case("k4", "K4 (B=16, S=500)", TRAIN_BATCH, 500, 500)
        attn_case("k5", "K5 (B=4, S=1536, ≤ 1500 valid)", TRAIN_BATCH_30, 1536, 1500, split=True)
        attn_case("k4_fp32", "K4 fp32 (B=16, S=500)", TRAIN_BATCH, 500, 500, dt=torch.float32)
        print(f"  SDPA backend: {out['attention_30s']['sdpa_backend']}; fp32: "
              f"{out['k4_fp32']['sdpa_backend']}")

    # K7 against SDPA's backward alone: one SDPA forward with grad, then its
    # backward (retain_graph) in turns with K7 on the same inputs
    g = torch.randn(TRAIN_BATCH, 500, d, generator=gen).to(DEVICE, torch.bfloat16)
    qh, kh, vh = (kern.split_heads(t, h).contiguous().requires_grad_() for t in qkv16.chunk(3, dim=-1))
    go, am = kern.split_heads(g, h).contiguous(), (m16 > 0)[:, None, None, :]
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
        lm, km = paired_ms(lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), go, retain_graph=True),
                           lambda: kern.attention_bwd(qkv16, m16, g, h), 10)
    report("k7", "K7 (B=16, S=500) vs SDPA backward", km, lm,
           {"bf16": attn_flops(h, hd, 500, lens16, products=5)}, 2 * TRAIN_BATCH * 500 * 7 * d)
    del sdpa_out

    with torch.no_grad():
        m = BATCH * 496
        for name, n, epi in (("qkv", 3 * d, kern.EPI_BIAS), ("o-proj", d, kern.EPI_BIAS_RESID_F32)):
            a = torch.randn(m, d, generator=gen).to(DEVICE)
            w = (torch.randn(d, n, generator=gen) / d ** 0.5).to(DEVICE)
            bias, r = torch.randn(n, generator=gen).to(DEVICE), torch.randn(m, n, generator=gen).to(DEVICE)
            lm, km = paired_ms(lambda: torch.matmul(a, w), lambda: kern.gemm(a, w, bias, epi, r), 5)
            report(f"gemm_fp32_{name}", f"K2 link: fp32 gemm {name} (M={m} N={n})", km, lm,
                   {"fp32": 2 * m * n * d}, 4 * (m * d + d * n + m * n))
        lens = list(np.random.RandomState(SEED).randint(49, 497, size=BATCH))
        x = torch.randn(BATCH, 496, 3 * d, generator=gen).to(DEVICE)
        mask = (torch.arange(496)[None, :] < torch.tensor(lens)[:, None]).to(DEVICE, torch.int32)
        qs, ks, vs = (kern.split_heads(t, h) for t in x.chunk(3, dim=-1))
        am = (mask > 0)[:, None, None, :]
        lm, km = paired_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                           lambda: kern.attention(x, mask, h), 5)
        report("attention_fp32", "K2 link: fp32 attention (B=32, S=496)", km, lm,
               {"fp32": attn_flops(h, hd, 496, lens)}, 4 * BATCH * 496 * 4 * d)
        xb = torch.randn(BATCH, 496, d, generator=gen).to(DEVICE, torch.bfloat16)
        sc, sh = torch.ones(d, device=DEVICE), torch.zeros(d, device=DEVICE)
        lm, km = paired_ms(lambda: F.layer_norm(xb, (d,), sc.bfloat16(), sh.bfloat16(), 1e-6),
                           lambda: kern.layer_norm(xb, sc, sh, 1e-6), 10)
        report("layer_norm", "LayerNorm link (bf16, B=32, S=496)", km, lm, {}, 2 * 2 * BATCH * 496 * d)

        front = configs.FrontendConfig()
        frames, bins = 1000, front.fft_size // 2 + 1
        bufs = (0.1 * torch.randn(BATCH, frames * 160 + front.window_length, generator=gen)).to(DEVICE)
        win = torch.hann_window(front.window_length, periodic=True, device=DEVICE)
        melm = torch.rand(bins, front.num_mels, generator=gen).to(DEVICE)
        stft = lambda: torch.stft(bufs, front.fft_size, front.hop_length, front.window_length, win,  # noqa: E731
                                  center=False, return_complex=True).abs()
        spec = stft().transpose(1, 2)[:, :frames].contiguous()
        mel = spec @ melm
        three = {"torch.stft + abs": cuda_ms(stft, 10), "mel product": cuda_ms(lambda: spec @ melm, 10),
                 "log": cuda_ms(lambda: torch.log(mel + front.log_offset), 10)}
        out["k8_library_calls"] = three
        print("  K8 as three PyTorch calls (B=32, 1000 frames): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in three.items()) + f" ({label})")
    return out


def clips_per_s(engine, wavs, runs=2):
    engine.embed_audio(wavs[:BATCH])  # warm
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.embed_audio(wavs)
        rates.append(len(wavs) / (time.perf_counter() - t0))
    return rates


def run() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = gpu_label()
    print(f"gpu: {label}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kern.load_library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or "C75" in line:
            print(f"  ptxas: {line.strip()}")
    hgmma = check_sass()
    silu_bad = kern.silu_epilogue_mismatches()
    print(f"  bf16 GEMM silu epilogue vs apply_epilogue over all 2^32 fp32 inputs: {silu_bad} "
          f"results differ")
    check(silu_bad == 0, "the bf16 GEMM's silu epilogue is not apply_epilogue's")

    blk = ViTBlock(D, INTER, torch.Generator().manual_seed(SEED)).to(DEVICE)
    errs = kernel_phase(blk)
    errs.update(block_phase(blk))
    errs.update(variant_phase(blk))
    errs.update(log_mel_phase())

    cfg = configs.caco_base()
    n_layers = cfg.audio.num_layers
    tok = byte_tokenizer()
    t0 = time.perf_counter()
    model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    engine = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                        dtype=torch.bfloat16)
    print(f"phase 5: caco_base bf16 10-s engine on cuda in {time.perf_counter() - t0:.1f} s "
          f"(seq {engine.patch.patches_seq_len})")
    check(engine.patch.patches_seq_len == 496, "10-s engine is not at 496 patches")

    rs = np.random.RandomState(SEED)
    lengths = rs.randint(3 * 16000, 10 * 16000 + 1, size=N_CLIPS)
    wavs = [(0.1 * rs.randn(n)).astype(np.float32) for n in lengths]
    texts = ["a dog barking", "rain on a window", "a trumpet solo",
             "people talking in a crowded room", "an engine idling", "birds singing at dawn"]
    n_buckets = -(-N_CLIPS // BATCH)
    no_blocks = {"k2_block": 0, "k3_block": 0}
    chain = dict.fromkeys(K1_PARTS)  # each launched at least once

    path = {}
    a_emb, path["K1"] = drive("bf16 10-s embed_audio", lambda: engine.embed_audio(wavs),
                              {"k1_layer": n_layers * n_buckets, **no_blocks, "log_mel": 0, **chain})
    t_emb = engine.embed_texts(texts)
    scores = engine.score(a_emb, t_emb)
    print(f"  embed_audio {a_emb.shape}, embed_texts {t_emb.shape}, score {scores.shape}")
    check_embeddings("audio", a_emb, N_CLIPS, cfg)
    check_embeddings("text", t_emb, len(texts), cfg)
    check(scores.shape == (N_CLIPS, len(texts)) and bool(np.isfinite(scores).all()),
          f"score: shape {scores.shape} or non-finite values")
    check(np.allclose(scores, np.exp(cfg.logit_scale_init) * a_emb @ t_emb.T, rtol=1e-4, atol=1e-4),
          "score is not exp(logit_scale) · A @ Tᵀ")

    path["tiny"], tiny_cos = tiny_engine_phase(wavs)

    print("phase 6: fp32 10-s engine (K2 + MLP outside the kernel)")
    engine32 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                          dtype=torch.float32)
    a32, path["K2"] = drive("fp32 10-s embed_audio", lambda: engine32.embed_audio(wavs),
                            {"k2_block": n_layers * n_buckets, "k1_layer": 0, "k3_block": 0,
                             **chain})
    check_embeddings("fp32 audio", a32, N_CLIPS, cfg)
    cos_bf16 = float(cosine_rows(a_emb, a32).min())
    cpu_model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    cpu_engine = CacoEngine(cfg, cpu_model, tokenizer=tok, device="cpu", batch_size=2,
                            dtype=torch.float32)
    a_cpu = cpu_engine.embed_audio(wavs[:2])
    cos_cpu = float(cosine_rows(a32[:2], a_cpu).min())
    print(f"  cosine fp32 card vs fp32 CPU plain (2 clips) {cos_cpu:.7f} (≥ 0.9999); "
          f"bf16 vs fp32 on the card ({N_CLIPS} clips, min) {cos_bf16:.7f} (≥ 0.999)")
    check(cos_cpu >= 0.9999, "fp32 card path disagrees with the CPU plain path")
    check(cos_bf16 >= 0.999, "bf16 path disagrees with fp32")
    del engine32, cpu_engine, cpu_model

    print("phase 7: bf16 10-s engine with the fused frontend (K8)")
    engine_k8 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                           dtype=torch.bfloat16, fused_frontend=True)
    a_k8, path["K8"] = drive("fused-frontend embed_audio", lambda: engine_k8.embed_audio(wavs),
                             {"log_mel": n_buckets, "k1_layer": n_layers * n_buckets, **chain})
    check_embeddings("fused-frontend audio", a_k8, N_CLIPS, cfg)
    cos_k8 = float(cosine_rows(a_k8, a_emb).min())
    print(f"  cosine fused vs unfused frontend, bf16 ({N_CLIPS} clips, min) {cos_k8:.7f} "
          f"(≥ {COS_FUSED})")
    check(cos_k8 >= COS_FUSED, "fused frontend disagrees with the unfused one")
    del engine_k8

    print("phase 8: the 30-s retrieval engine, bf16 (K3 + MLP outside the kernel)")
    engine30 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                          dtype=torch.bfloat16, buffer_seconds=30.0)
    check(engine30.patch.patches_seq_len == 1536,
          f"30-s bf16 engine at {engine30.patch.patches_seq_len} patches, expected 1536")
    lengths30 = rs.randint(3 * 16000, 30 * 16000 + 1, size=N_CLIPS_30)
    wavs30 = [(0.1 * rs.randn(n)).astype(np.float32) for n in lengths30]
    n_buckets30 = -(-N_CLIPS_30 // BATCH)
    a30, path["K3"] = drive("bf16 30-s embed_audio", lambda: engine30.embed_audio(wavs30),
                            {"k3_block": n_layers * n_buckets30, "k1_layer": 0, "k2_block": 0,
                             **chain})
    check_embeddings("30-s audio", a30, N_CLIPS_30, cfg)
    long_wavs = [(0.1 * rs.randn(s * 16000)).astype(np.float32) for s in (45, 60, 75)]
    a_long, _ = drive("bf16 30-s embed_audio_long", lambda: engine30.embed_audio_long(long_wavs),
                      {"k3_block": n_layers, "k1_layer": 0})  # 2 + 2 + 3 windows: one bucket
    check_embeddings("embed_audio_long", a_long, len(long_wavs), cfg)
    engine30_32 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                             dtype=torch.float32, buffer_seconds=30.0)
    check(engine30_32.patch.patches_seq_len == 1496,
          f"30-s fp32 engine at {engine30_32.patch.patches_seq_len} patches, expected 1496")
    a30_32, _ = drive("fp32 30-s embed_audio (einsum route, no kernel)",
                      lambda: engine30_32.embed_audio(wavs30),
                      {k: 0 for k in launches()})
    cos30 = float(cosine_rows(a30, a30_32).min())
    print(f"  cosine bf16 (K3) vs fp32 (einsum) at 30 s ({N_CLIPS_30} clips, min) {cos30:.7f} "
          f"(≥ 0.999)")
    check(cos30 >= 0.999, "30-s bf16 path disagrees with fp32")
    del engine30_32

    variant_paths, variants = variant_paths_phase(cfg, model, engine, engine30, wavs, wavs30)
    path.update(variant_paths)
    _, grads = grad_phase(cfg, model, wavs)

    errs.update(attention_phase())
    path["K4"], train_bf16 = train_bf16_phase(cfg, rs)
    path["K7"] = path["K4"]
    _, train_fp32 = train_fp32_phase(cfg, rs)
    path["K5"], train_30 = train_30s_phase(cfg, rs)

    print("phase 13: timings")
    bench = [(0.1 * rs.randn(10 * 16000)).astype(np.float32) for _ in range(4 * BATCH)]
    rates = clips_per_s(engine, bench)
    print(f"  embed_audio {rates[0]:.1f} / {rates[1]:.1f} clips/s (10-s clips, bf16, "
          f"batch {BATCH}, {len(bench)} clips per run; {label})")
    engine32 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                          dtype=torch.float32)
    rates32 = clips_per_s(engine32, bench)
    print(f"  embed_audio {rates32[0]:.1f} / {rates32[1]:.1f} clips/s (10-s clips, fp32, "
          f"batch {BATCH}, {len(bench)} clips per run; {label})")
    del engine32
    bench30 = [(0.1 * rs.randn(30 * 16000)).astype(np.float32) for _ in range(3 * BATCH)]
    rates30 = clips_per_s(engine30, bench30)
    print(f"  embed_audio {rates30[0]:.1f} / {rates30[1]:.1f} clips/s (30-s clips, bf16, "
          f"batch {BATCH}, {len(bench30)} clips per run; {label})")
    times, bounds, host = timing_phase(blk, label)
    times["k8"], bounds["k8"] = times["log_mel_1000"], bounds["log_mel_1000"]
    times["k8_fast"], bounds["k8_fast"] = times["log_mel_fast_1000"], bounds["log_mel_fast_1000"]
    links = links_phase(blk, label)

    print(f"  K7 / SDPA backward alone (B=16, S=500): {links['k7']['ms']:.4f} / "
          f"{links['k7']['library_ms']:.4f} ms = {links['k7']['ms'] / links['k7']['library_ms']:.2f}; "
          f"the K5 call (B=4, S=1500) / SDPA at K5's shape: {times['k5'][0]:.4f} / "
          f"{links['k5']['library_ms']:.4f} ms = {times['k5'][0] / links['k5']['library_ms']:.2f} ({label})")
    print(f"  bf16 10-s training step {train_bf16['median_step_ms']:.2f} ms/step (median of 6, "
          f"B={TRAIN_BATCH}), device busy {train_bf16['device_busy_ms']:.2f} ms/step, "
          f"peak {train_bf16['peak_gib']:.2f} GiB ({label})")
    print(f"  fp32 10-s training step {np.median(train_fp32['step_ms']):.2f} ms/step (median of 3, "
          f"B={TRAIN_BATCH}); bf16 30-s step {np.median(train_30['step_ms']):.2f} ms/step (median "
          f"of 3, B={TRAIN_BATCH_30}), peak {train_30['peak_gib']:.2f} GiB ({label})")
    err_key = {"K1": "k1_layer", "K2": "K2", "K3": "K3", "K3′": "K3′", "K4": "K4", "K5": "K5",
               "K6": "K6", "K7": "K7", "K8": "K8", "K8′": "K8′"}
    time_key = {"K1": "k1_layer", "K2": "k2_block", "K3": "k3_block", "K3′": "k3_layer", "K4": "k4",
                "K5": "k5", "K6": "k6_attn", "K7": "k7", "K8": "k8", "K8′": "k8_fast"}
    # one PyTorch call computes K4's, K5's and K7's function; the chains and
    # K8 / K8′ have none (their links' library times are under "links")
    lib_key = {"K4": "k4", "K5": "k5", "K7": "k7"}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": path[name][key], "max_abs_err": errs[err_key[name]],
                "ms": times[time_key[name]][0], "plain_ms": times[time_key[name]][1],
                "bound_ms": bounds[time_key[name]][0], "bound_by": bounds[time_key[name]][1],
                "library_ms": links[lib_key[name]]["library_ms"] if name in lib_key else None}
               for name, (src, replaces, key) in TPU_KERNELS.items()]
    return {"kernels": kernels,
            "k1_parts": {k: {"source": src, "launches": path["K1"][k], "max_abs_err": errs[k],
                             "ms": times[k][0], "plain_ms": times[k][1]}
                         for k, src in K1_PARTS.items()},
            "log_mel_3000": {"ms": times["log_mel_3000"][0], "plain_ms": times["log_mel_3000"][1]},
            "log_mel_fast_3000": {"ms": times["log_mel_fast_3000"][0],
                                  "plain_ms": times["log_mel_fast_3000"][1]},
            "links": links, "attention_host": host, "hgmma": hgmma,
            "silu_epilogue_mismatches": silu_bad,
            "variant_paths": variants, "inference_grads": grads,
            "clips_per_s": {"10s_bf16": rates, "10s_fp32": rates32, "30s_bf16": rates30},
            "tiny_engine_cosine": tiny_cos,
            "train": {"bf16_10s": train_bf16, "fp32_10s": train_fp32, "bf16_30s": train_30},
            "gpu": label}


def main() -> int:
    try:
        summary = run()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
