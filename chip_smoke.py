#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (cacophony_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no final `ok` line):
1. print the card's name and power limit (nvidia-smi); build the CUDA
   kernels from cacophony_tpu_torch/csrc;
2. hold each K1 kernel, and the K1 layer chain as a whole, against its
   plain PyTorch version on the card: B=8, S=496, D=768, H=8, I=3072, some
   padded keys and one all-masked clip, bf16 and fp32;
3. build caco_base() with random weights from seed 0 and a bf16
   CacoEngine on cuda with a byte-level tokenizer;
4. serve requests: embed_audio on 70 clips of 3-10 s (the last bucket is
   mostly padding), embed_texts on a handful of prompts, score;
5. check: finite values, unit norms, the K1 chain launched 12 times per
   audio bucket and each kernel launched in that run; fp32 on the card vs
   fp32 plain on the CPU (cosine ≥ 0.9999 on 2 clips); bf16 vs fp32 on
   the card (cosine ≥ 0.999);
6. time embed_audio at batch 32 and each kernel and the K1 chain against
   the plain versions, beside the card's name and power limit.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

It needs a CUDA device and never imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.data.tokenizer import ByteLevelBPETokenizer, _bytes_to_unicode
from cacophony_tpu_torch.models.audio import ViTBlock
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.runtime import CacoEngine

SEED = 0
DEVICE = "cuda"
N_CLIPS = 70
BATCH = 32
REPLACES = "cacophony_tpu/ops/encoder_attention.py:514"  # _fused_block_kernel, with_mlp=True
KERNELS = {  # launch-count key → source
    "layer_norm": "cacophony_tpu_torch/csrc/layer_norm.cu",
    "gemm": "cacophony_tpu_torch/csrc/gemm.cu",
    "attention": "cacophony_tpu_torch/csrc/attention.cu",
}
# |kernel - plain| ≤ atol + rtol·|plain|, elementwise.  bf16: outputs are
# rounded to bf16 (8 mantissa bits) after fp32 sums taken in another order,
# so one rounding step apart is 2^-8 relative; the chain compounds seven
# such steps.  fp32: summation order only.
TOL = {
    torch.bfloat16: {"kernel": (2e-2, 1e-2), "chain": (6e-2, 3e-2)},
    torch.float32: {"kernel": (1e-4, 1e-4), "chain": (5e-4, 5e-4)},
}


class SmokeFailure(Exception):
    pass


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
    """plain, kernel, kernel, plain in one call; → (kernel ms, plain ms)."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
def kernel_phase():
    """Phase 2: every K1 kernel and the chain against the plain versions."""
    b, s, d, h, inter = 8, 496, 768, 8, 3072
    lengths = [496, 400, 300, 496, 100, 250, 0, 17]  # clip 6: all keys masked
    gen = torch.Generator().manual_seed(SEED)
    blk = ViTBlock(d, inter, gen).to(DEVICE)
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
    return errs


def cosine_rows(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def byte_tokenizer():
    """Degenerate byte-level BPE: specials + all 256 byte symbols, no merges."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in _bytes_to_unicode().values():
        vocab[c] = len(vocab)
    return ByteLevelBPETokenizer(vocab, [])


@torch.inference_mode()
def timing_phase(blk, label):
    """Phase 6b: per-layer K1 chain and each kernel vs plain at B=32, S=496,
    bf16; a kernel's time is the sum over its calls in one layer."""
    b, s, d, h = BATCH, 496, 768, 8
    gen = torch.Generator().manual_seed(SEED + 1)
    lengths = list(np.random.RandomState(SEED).randint(48, 497, size=b))
    x, mask = layer_inputs(b, s, d, torch.bfloat16, gen, lengths)
    times = {}
    for key, cases in layer_cases(blk, x, mask, h).items():
        kernel, plain = getattr(kern, key), getattr(kern, key + "_plain")
        times[key] = paired_ms(lambda: [kernel(*a) for _, a in cases],
                               lambda: [plain(*a) for _, a in cases], 10)
    times["k1_layer"] = paired_ms(lambda: ea.fused_layer(blk, x, mask, h, 1e-6),
                                  lambda: ea.fused_layer_plain(blk, x, mask, h, 1e-6), 10)
    what = {"layer_norm": "LN1 + LN2", "gemm": "4 products of one layer",
            "attention": "attention", "k1_layer": "K1 chain, one layer"}
    for k, (km, pm) in times.items():
        print(f"  {what[k]:<26} kernel {km:.4f} ms  plain {pm:.4f} ms"
              f"  (bf16, B={b} S={s}; {label})")
    return times


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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    errs = kernel_phase()

    cfg = configs.caco_base()
    tok = byte_tokenizer()
    t0 = time.perf_counter()
    model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    engine = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                        dtype=torch.bfloat16)
    print(f"phase 3: caco_base bf16 engine on cuda in {time.perf_counter() - t0:.1f} s "
          f"(seq {engine.patch.patches_seq_len})")

    rs = np.random.RandomState(SEED)
    lengths = rs.randint(3 * 16000, 10 * 16000 + 1, size=N_CLIPS)
    wavs = [(0.1 * rs.randn(n)).astype(np.float32) for n in lengths]
    texts = ["a dog barking", "rain on a window", "a trumpet solo",
             "people talking in a crowded room", "an engine idling", "birds singing at dawn"]
    n_buckets = -(-N_CLIPS // BATCH)

    kern.reset_launches()
    ea.LAYER_LAUNCHES["k1_layer"] = 0
    a_emb = engine.embed_audio(wavs)
    launches = dict(kern.LAUNCHES, **ea.LAYER_LAUNCHES)
    t_emb = engine.embed_texts(texts)
    scores = engine.score(a_emb, t_emb)
    print(f"phase 4: embed_audio {a_emb.shape}, embed_texts {t_emb.shape}, score {scores.shape}; "
          f"launches {launches}")

    check(a_emb.shape == (N_CLIPS, cfg.projection_size), f"audio shape {a_emb.shape}")
    check(t_emb.shape == (len(texts), cfg.projection_size), f"text shape {t_emb.shape}")
    check(scores.shape == (N_CLIPS, len(texts)), f"score shape {scores.shape}")
    for name, arr in (("audio", a_emb), ("text", t_emb), ("score", scores)):
        check(bool(np.isfinite(arr).all()), f"{name}: non-finite values")
    for name, arr in (("audio", a_emb), ("text", t_emb)):
        dev = float(np.abs(np.linalg.norm(arr, axis=-1) - 1.0).max())
        check(dev <= 1e-3, f"{name}: embedding norms off by {dev}")
    n_layers = cfg.audio.num_layers
    check(launches["k1_layer"] == n_layers * n_buckets,
          f"K1 chain launched {launches['k1_layer']} times, expected {n_layers * n_buckets}")
    for k in KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
    check(np.allclose(scores, np.exp(cfg.logit_scale_init) * a_emb @ t_emb.T, rtol=1e-4, atol=1e-4),
          "score is not exp(logit_scale) · A @ Tᵀ")

    engine32 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                          dtype=torch.float32)
    a32 = engine32.embed_audio(wavs)
    cos_bf16 = float(cosine_rows(a_emb, a32).min())
    cpu_model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    cpu_engine = CacoEngine(cfg, cpu_model, tokenizer=tok, device="cpu", batch_size=2,
                            dtype=torch.float32)
    a_cpu = cpu_engine.embed_audio(wavs[:2])
    cos_cpu = float(cosine_rows(a32[:2], a_cpu).min())
    print(f"phase 5: cosine fp32 card vs fp32 CPU plain (2 clips) {cos_cpu:.7f} (≥ 0.9999); "
          f"bf16 vs fp32 on the card ({N_CLIPS} clips, min) {cos_bf16:.7f} (≥ 0.999)")
    check(cos_cpu >= 0.9999, "fp32 card path disagrees with the CPU plain path")
    check(cos_bf16 >= 0.999, "bf16 path disagrees with fp32")
    del engine32, cpu_engine, cpu_model

    bench = [(0.1 * rs.randn(10 * 16000)).astype(np.float32) for _ in range(4 * BATCH)]
    engine.embed_audio(bench[:BATCH])  # warm
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.embed_audio(bench)
        rates.append(len(bench) / (time.perf_counter() - t0))
    print(f"phase 6: embed_audio {rates[0]:.1f} / {rates[1]:.1f} clips/s (10-s clips, bf16, "
          f"batch {BATCH}, {len(bench)} clips per run; {label})")
    times = timing_phase(model.audio.blocks[0], label)

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": REPLACES,
                "launches": launches[k], "max_abs_err": errs[k],
                "ms": times[k][0], "plain_ms": times[k][1]} for k, src in KERNELS.items()]
    return {"kernels": kernels,
            "k1_layer": {"launches": launches["k1_layer"], "max_abs_err": errs["k1_layer"],
                         "ms": times["k1_layer"][0], "plain_ms": times["k1_layer"][1]},
            "clips_per_s": rates, "gpu": label}


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
