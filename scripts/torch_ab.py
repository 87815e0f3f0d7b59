#!/usr/bin/env python3
"""Time the port's fp32 serving path (and the bf16 paths beside it) of one
or more source trees on one CUDA card, each tree in a process of its own,
in the order given — to compare two commits on one card, in turns:

    python3 scripts/torch_ab.py PARENT_TREE . . PARENT_TREE

A tree is a directory holding `cacophony_tpu_torch/` (a `git archive` of a
commit unpacked into a git-ignored directory); each builds its own kernels
into its `cacophony_tpu_torch/_build/`.  Per tree, at caco_base with random
weights from seed 0 (batch 32, 10-s clips unless stated):
- embed_audio clips/s: fp32 10 s, bf16 10 s, bf16 30 s (128 / 128 / 96
  clips per run, two runs after a warm-up bucket);
- the K2 block (`fused_block_attention`, fp32, B=32, S=496) and its fp32
  links — the QKV and o-proj GEMMs and the attention — beside
  torch.matmul and F.scaled_dot_product_attention on the same operands;
  K4 in fp32 (B=16, S=500);
- the fp32 and bf16 10-s training steps (B=16, 500 patches, 100 tokens,
  text dropout off; medians of 3 and 5 after 2 warm-up steps), and the
  bf16 step's device busy time (the union of the card's kernel, copy and
  memset intervals under torch.profiler, over 3 steps);
- K7 (bf16, B=16, S=500) against SDPA's backward alone on the same inputs,
  and the K5 call (`encoder_attention_blocked`, bf16, B=4, S=1500).
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


def measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.data.pipeline import device_train_frontend
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
    for key, dt, secs, wavs in (("fp32_10s", torch.float32, 10.0, wavs10),
                                ("bf16_10s", torch.bfloat16, 10.0, wavs10),
                                ("bf16_30s", torch.bfloat16, 30.0, wavs30)):
        engine = CacoEngine(cfg, model, device=dev, batch_size=BATCH, dtype=dt, buffer_seconds=secs)
        out[f"clips_per_s_{key}"] = rates(engine, wavs)
        del engine

    gen = torch.Generator().manual_seed(SEED + 1)
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

    front = configs.FrontendConfig()
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
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print("ab " + json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    trees = sys.argv[1:] or ["."]
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {label}", flush=True)
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("ab ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
