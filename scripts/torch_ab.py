#!/usr/bin/env python3
"""Time the port's fp32 serving path (and the bf16 paths beside it) of one
or more source trees on one CUDA card, each tree in a process of its own,
in the order given — to compare two commits on one card, in turns:

    python3 scripts/torch_ab.py [--only GROUP,...] PARENT_TREE . . PARENT_TREE

A tree is a directory holding `cacophony_tpu_torch/` (a `git archive` of a
commit unpacked into a git-ignored directory); each builds its own kernels
into its `cacophony_tpu_torch/_build/`.  Per tree, at caco_base with random
weights from seed 0 (batch 32, 10-s clips unless stated), in four groups
(`--only` picks some; all by default):
- serving: embed_audio clips/s: fp32 10 s, bf16 10 s, bf16 30 s (128 / 128
  / 96 clips per run, two runs after a warm-up bucket), and bf16 10 s with
  the fused frontend (K8);
- attention: the K2 block (`fused_block_attention`, fp32, B=32, S=496) and its fp32
  links — the QKV and o-proj GEMMs and the attention — beside
  torch.matmul and F.scaled_dot_product_attention on the same operands;
  K4 in fp32 (B=16, S=500); K7 (bf16, B=16, S=500) against SDPA's
  backward alone on the same inputs, and the K5 call
  (`encoder_attention_blocked`, bf16, B=4, S=1500);
- train: the fp32 and bf16 10-s training steps (B=16, 500 patches, 100 tokens,
  text dropout off; medians of 3 and 5 after 2 warm-up steps), and the
  bf16 step's device busy time (the union of the card's kernel, copy and
  memset intervals under torch.profiler, over 3 steps);
- frontend: the LayerNorm link's device time (B=32, S=496, D=768, bf16
  and fp32; torch.profiler's kernel intervals, the input rotated over
  buffers of >= 150 MB in all so that the 50-MB L2 holds none of them)
  beside F.layer_norm's (weights cast once, outside the timed call); K8
  and K8′ (B=32, 1000 and 3000 frames, CUDA events) with their bounds
  counted over the work the log-mel needs (the bins with a nonzero mel
  row, the mel matrix's nonzeros).
Prints the card's name and power limit, then one JSON line per tree
("ab {...}").  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

D, H, BATCH, SEED = 768, 8, 32, 0


def cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_busy_ms(torch, fn, n: int):
    """fn run n times under torch.profiler → (device busy ms per run, the
    union of the card's intervals; host wall ms per run under the profiler)."""
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
    return busy / 1e3 / n, wall


def rotating_device_ms(torch, fn, inputs, n: int = 42):
    """Device ms of one call of fn(x) that launches one kernel, x rotating
    over `inputs` (together larger than L2): the mean of the kernel
    intervals torch.profiler recorded (it may drop a few), not bound by the
    host's enqueue as events around back-to-back calls are when a call's
    host time outlasts its kernel.  → (ms, kernels recorded per call)."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if len({e.name for e in kernels}) != 1:
        raise SystemExit(f"expected one kernel per call, got {sorted({e.name for e in kernels})}")
    return sum(e.time_range.end - e.time_range.start for e in kernels) / len(kernels) / 1e3, len(kernels) / n


GROUPS = ("serving", "attention", "train", "frontend")
PEAK_FP32, PEAK_BF16, HBM = 67e12, 989e12, 3.35e12  # the H100 SXM's published peaks


def measure(tree: str, groups) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.data.pipeline import device_train_frontend
    from cacophony_tpu_torch.frontend import fused
    from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples
    from cacophony_tpu_torch.models.audio import ViTBlock
    from cacophony_tpu_torch.models.caco import caco_init
    from cacophony_tpu_torch.ops import _kernels as kern
    from cacophony_tpu_torch.ops import encoder_attention as ea
    from cacophony_tpu_torch.runtime import CacoEngine
    from cacophony_tpu_torch.train import train

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert os.path.dirname(kern.__file__).startswith(os.path.abspath(tree))
    t0 = time.perf_counter()
    kern.load_library()
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    dev = "cuda"
    rs = np.random.RandomState(SEED)
    cfg = configs.caco_base()
    gen = torch.Generator().manual_seed(SEED + 1)

    if "serving" in groups:
        model = caco_init(cfg, torch.Generator().manual_seed(SEED))

        def rates(engine, wavs):
            engine.embed_audio(wavs[:BATCH])
            got = []
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                engine.embed_audio(wavs)
                got.append(len(wavs) / (time.perf_counter() - t))
            return got

        wavs10 = [(0.1 * rs.randn(10 * 16000)).astype(np.float32) for _ in range(4 * BATCH)]
        wavs30 = [(0.1 * rs.randn(30 * 16000)).astype(np.float32) for _ in range(3 * BATCH)]
        for key, dt, secs, wavs, fused_fe in (("fp32_10s", torch.float32, 10.0, wavs10, False),
                                              ("bf16_10s", torch.bfloat16, 10.0, wavs10, False),
                                              ("bf16_10s_fused_frontend", torch.bfloat16, 10.0,
                                               wavs10, True),
                                              ("bf16_30s", torch.bfloat16, 30.0, wavs30, False)):
            engine = CacoEngine(cfg, model, device=dev, batch_size=BATCH, dtype=dt, buffer_seconds=secs,
                                fused_frontend=fused_fe)
            out[f"clips_per_s_{key}"] = rates(engine, wavs)
            del engine
        del model

    if "attention" in groups:
        qkv = (1.5 * torch.randn(16, 500, 3 * D, generator=gen)).to(dev, torch.bfloat16)
        m16 = (torch.arange(500)[None, :] < torch.tensor(rs.randint(100, 501, size=16))[:, None]).to(
            dev, torch.int32)
        g = torch.randn(16, 500, D, generator=gen).to(dev, torch.bfloat16)
        qh, kh, vh = (kern.split_heads(t, H).contiguous().requires_grad_() for t in qkv.chunk(3, dim=-1))
        with torch.enable_grad():
            sdpa = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=(m16 > 0)[:, None, None, :])
            gh = kern.split_heads(g, H).contiguous()
            out["k7_ms"] = cuda_ms(torch, lambda: kern.attention_bwd(qkv, m16, g, H), 10)
            out["sdpa_bwd_ms"] = cuda_ms(
                torch, lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh, retain_graph=True), 10)
        del sdpa
        q4 = torch.randn(4, 1500, D, generator=gen).to(dev, torch.bfloat16)
        kv4 = torch.randn(4, 1500, 2 * D, generator=gen).to(dev, torch.bfloat16)
        m4 = (torch.arange(1500)[None, :] < torch.tensor(rs.randint(150, 1501, size=4))[:, None]).to(
            dev, torch.int32)
        with torch.inference_mode():
            out["k5_call_ms"] = cuda_ms(torch, lambda: ea.encoder_attention_blocked(q4, kv4, m4, H), 10)
        with torch.inference_mode():
            blk = ViTBlock(D, 4 * D, torch.Generator().manual_seed(SEED)).to(dev)
            lens = np.random.RandomState(SEED).randint(49, 497, size=BATCH)
            mask = (torch.arange(496)[None, :] < torch.tensor(lens)[:, None]).to(dev, torch.int32)
            x = torch.randn(BATCH, 496, D, generator=gen).to(dev)
            out["k2_block_ms"] = cuda_ms(
                torch, lambda: ea.fused_block_attention(blk, x, mask, H, 1e-6, ("one_shot",)), 5)
            m = BATCH * 496
            for name, n, epi in (("qkv", 3 * D, kern.EPI_BIAS), ("oproj", D, kern.EPI_BIAS_RESID_F32)):
                a = torch.randn(m, D, generator=gen).to(dev)
                w = (torch.randn(D, n, generator=gen) / D ** 0.5).to(dev)
                bias, r = torch.randn(n, generator=gen).to(dev), torch.randn(m, n, generator=gen).to(dev)
                out[f"gemm_{name}_ms"] = cuda_ms(torch, lambda: kern.gemm(a, w, bias, epi, r), 5)
                out[f"matmul_{name}_ms"] = cuda_ms(torch, lambda: torch.matmul(a, w), 5)
            qkv = torch.randn(BATCH, 496, 3 * D, generator=gen).to(dev)
            qs, ks, vs = (kern.split_heads(t, H) for t in qkv.chunk(3, dim=-1))
            am = (mask > 0)[:, None, None, :]
            out["attention_ms"] = cuda_ms(torch, lambda: kern.attention(qkv, mask, H), 5)
            out["sdpa_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am), 5)
            q16 = torch.randn(16, 500, 3 * D, generator=gen).to(dev)
            m16 = (torch.arange(500)[None, :] < torch.tensor(rs.randint(100, 501, size=16))[:, None]).to(
                dev, torch.int32)
            out["k4_fp32_ms"] = cuda_ms(torch, lambda: kern.attention_k4(q16, m16, H), 10)
            del blk, x, qkv, q16

    front = configs.FrontendConfig()
    if "train" in groups:
        samples, tlen = 10 * front.sample_rate, 100
        for key, dt, n_steps in (("fp32", torch.float32, 3), ("bf16", torch.bfloat16, 5)):
            c = dataclasses.replace(cfg, dtype=dt)
            c = dataclasses.replace(c, text=dataclasses.replace(c.text, hidden_dropout=0.0, attention_dropout=0.0),
                                    decoder=dataclasses.replace(c.decoder, hidden_dropout=0.0,
                                                                attention_dropout=0.0))
            lens = rs.randint(3 * front.sample_rate, samples + 1, size=16).astype(np.int32)
            bufs = np.zeros((16, samples), np.float32)
            for i, n in enumerate(lens):
                bufs[i, :n] = 0.1 * rs.randn(n)
            full = num_patches_for_samples(samples, front, configs.PatchConfig())
            frontend = device_train_frontend(front, configs.PatchConfig(patches_seq_len=full), 500)
            batch = frontend(torch.Generator(device=dev).manual_seed(SEED), torch.from_numpy(bufs).to(dev),
                             torch.from_numpy(lens).to(dev))
            tmask = (np.arange(tlen)[None] < rs.randint(8, tlen + 1, size=16)[:, None]).astype(np.int32)
            ids = np.where(tmask > 0, rs.randint(4, c.text.vocab_size, size=(16, tlen)), 1)
            batch["text_input_ids"] = torch.from_numpy(ids.astype(np.int32)).to(dev)
            batch["text_mask"] = torch.from_numpy(tmask).to(dev)
            tc = train.TrainConfig(warmup_steps=1, total_steps=100)
            net = caco_init(c, torch.Generator().manual_seed(SEED)).to(dev)
            state = train.init_train_state(net, tc)
            step = train.make_caco_train_step(c, tc)
            ms = []
            for i in range(2 + n_steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(state, batch, None)
                float(metrics["loss"])
                torch.cuda.synchronize()
                if i >= 2:
                    ms.append((time.perf_counter() - t) * 1e3)
            out[f"train_{key}_10s_ms"] = sorted(ms)
            if key == "bf16":
                def one_step():
                    nonlocal state
                    state, metrics = step(state, batch, None)
                    float(metrics["loss"])
                out["train_bf16_10s_device_busy_ms"], out["train_bf16_10s_profiled_wall_ms"] = \
                    device_busy_ms(torch, one_step, 3)
            del state, net, step
            torch.cuda.empty_cache()

    if "frontend" in groups:
        with torch.inference_mode():
            rows, d = BATCH * 496, D
            sc = (1.0 + 0.1 * torch.randn(d, generator=gen)).to(dev)
            sh = (0.1 * torch.randn(d, generator=gen)).to(dev)
            for dt, size in ((torch.bfloat16, 2), (torch.float32, 4)):
                name = str(dt).split(".")[-1]
                n_buf = -(-150_000_000 // (rows * d * size))
                xs = [torch.randn(BATCH, 496, d, generator=gen).to(dev, dt) for _ in range(n_buf)]
                sc_t, sh_t = sc.to(dt), sh.to(dt)  # the library's weights, cast once
                km, k_ops = rotating_device_ms(torch, lambda x: kern.layer_norm(x, sc, sh, 1e-6), xs)
                lm, l_ops = rotating_device_ms(torch, lambda x: F.layer_norm(x, (d,), sc_t, sh_t, 1e-6), xs)
                bound = 2 * size * rows * d / HBM * 1e3
                out[f"layer_norm_{name}"] = {"device_ms": km, "ops_per_call": k_ops,
                                             "library_device_ms": lm, "library_ops_per_call": l_ops,
                                             "bound_ms": bound, "share": bound / km,
                                             "library_share": bound / lm,
                                             "inputs_mb": n_buf * rows * d * size / 1e6}
                del xs
            mel = fused._padded_matrices(front)[1]
            cols, terms = 2 * int((mel != 0).any(axis=1).sum()), int((mel != 0).sum())
            for frames in (1000, 3000):
                bufs = (0.1 * torch.randn(BATCH, frames * 160, generator=gen)).to(dev)
                r = fused.buffer_to_rows(bufs, frames, front)
                dft = 2 * BATCH * frames * front.window_length * cols
                mel_ops = 2 * BATCH * frames * terms
                nbytes = 4 * (r.numel() + BATCH * frames * front.num_mels)
                out[f"k8_{frames}_ms"] = cuda_ms(torch, lambda: fused.fused_log_mel(r, front, frames), 10)
                out[f"k8_fast_{frames}_ms"] = cuda_ms(
                    torch, lambda: fused.fused_log_mel(r, front, frames, fast_dft=True), 10)
                out[f"k8_{frames}_bound_ms"] = max((dft + mel_ops) / PEAK_FP32, nbytes / HBM) * 1e3
                out[f"k8_fast_{frames}_bound_ms"] = max(3 * dft / PEAK_BF16 + mel_ops / PEAK_FP32,
                                                        nbytes / HBM) * 1e3
    return out


def main() -> int:
    args = sys.argv[1:]
    if len(args) >= 3 and args[0] == "--child":
        print("ab " + json.dumps(measure(args[1], args[2].split(","))), flush=True)
        return 0
    groups = GROUPS
    if args[:1] == ["--only"]:
        groups, args = args[1].split(","), args[2:]
        unknown = set(groups) - set(GROUPS)
        if unknown:
            raise SystemExit(f"unknown groups {sorted(unknown)}; choose from {GROUPS}")
    trees = args or ["."]
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {label}", flush=True)
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                               ",".join(groups)], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("ab ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
