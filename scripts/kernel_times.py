#!/usr/bin/env python3
"""The port's kernel timer, and the rates of the paths that no benchmark
cell measures yet.  Each source tree runs in a child process of its own,
in the order given, so two commits compare on one card in turns:

    python3 scripts/kernel_times.py [--only kernels,nocell] [TREE ...]   (default: .)
    python3 scripts/kernel_times.py _local/parent . . _local/parent

A tree is a directory holding `cacophony_tpu_torch/` (unpack a commit with
`git archive` into a git-ignored directory); each builds its own kernels.
The bounds (`cacophony_tpu_torch/utils/flops.py`) and the data writers
(`tests/torch_card.py`) are this checkout's, loaded by path, so a tree is
measured only through entry points every tree has.  caco_base and
audiomae_base widths, random weights from seed 0.

The first line gives the card's name and power limit; then one JSON line
a row, each with its "tree" and "group":
- kernels: each row of PERF.md §6's kernel table, K1 (one layer, and its
  GEMM and attention links at 10 s and 30 s), K2 (and its fp32 links), K3,
  K3′, K4 (bf16, fp32), K5, K6, K7, K8 and K8′ (1000 and 3000 frames) and
  `table_grad`: "ms" on the card, "plain_ms" of its plain PyTorch version,
  "library_ms" of the PyTorch call that computes the same function where
  there is one (CUDA events over 10 calls after a warm-up call, in turns:
  plain, kernel, library, library, kernel, plain); "device_ms", the
  kernel's card time a call (events around one replay of a CUDA graph of
  20 calls); "host_us", the host's time to enqueue one call; "bound_ms"
  (the larger of its operations over the peak of their type and its bytes
  over HBM's rate; masked keys, and the DFT bins with no mel weight, are
  not counted), "bound_by", "share" = bound / device_ms.  Where host_us
  reaches ms (a chain's 20-odd launches and weight casts, a short
  kernel's argument checks), the events of ms time the host's pace, which
  moves with the load on the machine's shared cores: trees compare by
  device_ms.  The rows are timed in a second pass after an untimed first
  (first calls, the clocks' ramp).  Then the LayerNorm link's device time
  against F.layer_norm's (events around one replay of a CUDA graph of 42
  calls, the inputs rotated over >= 150 MB, past the 50-MB L2).
- nocell: the rates of paths no cell of BENCHMARK.json measures, each with
  "cell", the ROADMAP queue E-4 cell that will retire it.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import types

GROUPS = ("kernels", "nocell")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, H, INTER, BATCH, SEED = 768, 8, 3072, 32, 0


def own(name: str, rel: str):
    """A module of this checkout, loaded by its path (not the tree's)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(torch, fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, kernel, plain=None, library=None, iters: int = 10) -> dict:
    """plain, kernel, library, library, kernel, plain (those given) → the
    mean ms of each; then the kernel's card time a call ("device_ms": one
    replay of a CUDA graph of 20 calls) and the host µs a call."""
    fns = {k: f for k, f in (("plain_ms", plain), ("ms", kernel), ("library_ms", library)) if f}
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(cuda_ms(torch, fns[k], iters))
    return dict({k: sum(v) / len(v) for k, v in got.items()},
                device_ms=graph_device_ms(torch, lambda _: kernel(), [None], 20),
                host_us=host_us(torch, kernel, 10))


def graph_device_ms(torch, fn, inputs, n: int = 42) -> float:
    """Device ms of one call of fn(x), x rotating over `inputs`: events
    around one replay of a CUDA graph of n calls."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_us(torch, fn, n: int = 50) -> float:
    """Host µs a call (argument checks, tensor maps, the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return t


def kernel_rows(torch, emit):
    """Every row of the kernel table."""
    import numpy as np
    import torch.nn.functional as F

    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.frontend import fused
    from cacophony_tpu_torch.models.audio import ViTBlock
    from cacophony_tpu_torch.ops import _kernels as kern
    from cacophony_tpu_torch.ops import encoder_attention as ea

    flops = own("_kernel_times_flops", "cacophony_tpu_torch/utils/flops.py")
    gen = torch.Generator().manual_seed(SEED + 1)
    hd = D // H

    def lengths(b, lo, hi):
        return list(np.random.RandomState(SEED).randint(lo, hi + 1, size=b))

    def inputs(b, s, width, dt, lens, scale=1.0):
        x = (scale * torch.randn(b, s, width, generator=gen)).to("cuda", dt)
        return x, (torch.arange(s)[None, :] < torch.tensor(lens)[:, None]).to("cuda", torch.int32)

    def row(name, what, t, ops, nbytes, **extra):
        b_ms, by = flops.bound(ops, nbytes)
        emit(dict(row=name, what=what, **t, bound_ms=b_ms, bound_by=by,
                  share=b_ms / t.get("device_ms", t["ms"]), **extra))

    def sdpa(qkv_or_q, mask, kv=None):
        parts = qkv_or_q.chunk(3, dim=-1) if kv is None else (qkv_or_q, *kv.chunk(2, dim=-1))
        q, k, v = (kern.split_heads(t, H) for t in parts)
        am = (mask > 0)[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)

    blk = ViTBlock(D, INTER, torch.Generator().manual_seed(SEED)).to("cuda")
    w_layer, w_block = 3 * D * D + D * D + 2 * D * INTER, 4 * D * D
    with torch.inference_mode():
        # K1: one layer at the 10-s bucket, then its links at 10 s and 30 s
        lens = lengths(BATCH, 48, 496)
        x, mask = inputs(BATCH, 496, D, torch.bfloat16, lens)
        m = BATCH * 496
        row("K1", "K1 chain, one layer (bf16, B=32, S=496)",
            in_turns(torch, lambda: ea.fused_layer(blk, x, mask, H, 1e-6),
                     lambda: ea.fused_layer_plain(blk, x, mask, H, 1e-6)),
            {"bf16": 2 * m * w_layer + flops.attn_flops(H, hd, 496, lens)}, 2 * (2 * m * D + w_layer))
        for seconds, s in ((10, 496), (30, 1536)):
            m = BATCH * s
            shapes = [("qkv", 3 * D, D, kern.EPI_BIAS), ("o-proj", D, D, kern.EPI_BIAS_RESID_F32),
                      ("mlp up", INTER, D, kern.EPI_BIAS_SILU),
                      ("mlp down", D, INTER, kern.EPI_BIAS_CAST_ADD)]
            for name, n, k, epi in shapes[:4 if seconds == 10 else 2]:
                a = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
                w = (torch.randn(k, n, generator=gen) / k ** 0.5).to("cuda", torch.bfloat16)
                bias = torch.randn(n, generator=gen).to("cuda")
                r = torch.randn(m, n, generator=gen).to("cuda", torch.bfloat16)
                resid = m * n * 2 if epi in (kern.EPI_BIAS_RESID_F32, kern.EPI_BIAS_CAST_ADD) else 0
                row(f"K1.gemm {name} {seconds}s", f"bf16 GEMM {name} (M={m} N={n} K={k}); library: "
                    "torch.matmul without the epilogue",
                    in_turns(torch, lambda: kern.gemm(a, w, bias, epi, r),
                             lambda: kern.gemm_plain(a, w, bias, epi, r), lambda: torch.matmul(a, w)),
                    {"bf16": 2 * m * n * k}, 2 * (m * k + k * n + m * n) + resid + 4 * n)
            del a, w, r
            lens = lengths(BATCH, s // 10, s)
            qkv, mk = inputs(BATCH, s, 3 * D, torch.bfloat16, lens, 1.5)
            row(f"K1.attention {seconds}s", f"bf16 attention link (B=32, S={s}); library: SDPA",
                in_turns(torch, lambda: kern.attention(qkv, mk, H), lambda: kern.attention_plain(qkv, mk, H),
                         sdpa(qkv, mk)),
                {"bf16": flops.attn_flops(H, hd, s, lens)}, 2 * BATCH * s * 4 * D)
        del qkv

        # K2 (fp32, the 10-s bucket) and its fp32 links; K3, K3′ (bf16, 1536)
        lens = lengths(BATCH, 49, 496)
        x32, m32 = inputs(BATCH, 496, D, torch.float32, lens)
        m = BATCH * 496
        row("K2", "K2 block (fp32, B=32, S=496)",
            in_turns(torch, lambda: ea.fused_block_attention(blk, x32, m32, H, 1e-6, ("one_shot",)),
                     lambda: ea.fused_block_attention_plain(blk, x32, m32, H, 1e-6, ("one_shot",)),
                     iters=5),
            {"fp32": 2 * m * w_block + flops.attn_flops(H, hd, 496, lens)}, 4 * (3 * m * D + w_block))
        for name, n, epi in (("qkv", 3 * D, kern.EPI_BIAS), ("o-proj", D, kern.EPI_BIAS_RESID_F32)):
            a = torch.randn(m, D, generator=gen).to("cuda")
            w = (torch.randn(D, n, generator=gen) / D ** 0.5).to("cuda")
            bias, r = torch.randn(n, generator=gen).to("cuda"), torch.randn(m, n, generator=gen).to("cuda")
            row(f"K2.gemm {name}", f"fp32 GEMM {name} (M={m} N={n} K={D}); library: torch.matmul",
                in_turns(torch, lambda: kern.gemm(a, w, bias, epi, r),
                         lambda: kern.gemm_plain(a, w, bias, epi, r), lambda: torch.matmul(a, w), 5),
                {"fp32": 2 * m * n * D}, 4 * (m * D + D * n + m * n))
        del a, w, r
        qkv32, _ = inputs(BATCH, 496, 3 * D, torch.float32, lens)
        row("K2.attention", "fp32 attention link (B=32, S=496); library: SDPA",
            in_turns(torch, lambda: kern.attention(qkv32, m32, H),
                     lambda: kern.attention_plain(qkv32, m32, H), sdpa(qkv32, m32), 5),
            {"fp32": flops.attn_flops(H, hd, 496, lens)}, 4 * BATCH * 496 * 4 * D)
        del x32, qkv32
        lens = lengths(BATCH, 153, 1536)
        x30, m30 = inputs(BATCH, 1536, D, torch.bfloat16, lens)
        m = BATCH * 1536
        blocked = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK)
        row("K3", "K3 block (bf16, B=32, S=1536)",
            in_turns(torch, lambda: ea.fused_block_attention(blk, x30, m30, H, 1e-6, blocked),
                     lambda: ea.fused_block_attention_plain(blk, x30, m30, H, 1e-6, blocked), iters=5),
            {"bf16": 2 * m * w_block + flops.attn_flops(H, hd, 1536, lens)}, 2 * (3 * m * D + w_block))
        row("K3′", "K3′ layer (bf16, B=32, S=1536)",
            in_turns(torch, lambda: ea.fused_layer(blk, x30, m30, H, 1e-6, blocked),
                     lambda: ea.fused_layer_plain(blk, x30, m30, H, 1e-6, blocked), iters=5),
            {"bf16": 2 * m * w_layer + flops.attn_flops(H, hd, 1536, lens)}, 2 * (2 * m * D + w_layer))
        del x30
        lens = lengths(BATCH, 48, 496)
        x, mask = inputs(BATCH, 496, D, torch.bfloat16, lens)
        m = BATCH * 496
        row("K6", "K6 LN1 → QKV → attention (bf16, B=32, S=496)",
            in_turns(torch, lambda: ea.fused_ln_attention(blk.ln1, blk.attn.qkv, x, mask, H, 1e-6),
                     lambda: ea.fused_ln_attention_plain(blk.ln1, blk.attn.qkv, x, mask, H, 1e-6)),
            {"bf16": 2 * m * 3 * D * D + flops.attn_flops(H, hd, 496, lens)}, 2 * (2 * m * D + 3 * D * D))

        # K4 at the 10-s step's shape, K5 at the 30-s step's
        lens16 = lengths(16, 100, 500)
        for dt, kind, size in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4)):
            q16, m16 = inputs(16, 500, 3 * D, dt, lens16, 1.5)
            row(f"K4 {kind}", f"K4 ({kind}, B=16, S=500); library: SDPA",
                in_turns(torch, lambda: kern.attention_k4(q16, m16, H),
                         lambda: kern.attention_plain(q16, m16, H), sdpa(q16, m16)),
                {kind: flops.attn_flops(H, hd, 500, lens16)}, size * 16 * 500 * 4 * D)
        lens4 = lengths(4, 150, 1500)
        q4, m4 = inputs(4, 1500, D, torch.bfloat16, lens4, 1.5)
        kv4, _ = inputs(4, 1500, 2 * D, torch.bfloat16, lens4, 1.5)
        row("K5", "K5 call `encoder_attention_blocked` (bf16, B=4, S=1500); library: SDPA",
            in_turns(torch, lambda: ea.encoder_attention_blocked(q4, kv4, m4, H),
                     lambda: ea.encoder_attention_blocked_plain(q4, kv4, m4, H), sdpa(q4, m4, kv4)),
            {"bf16": flops.attn_flops(H, hd, 1500, lens4)}, 2 * 4 * 1500 * 4 * D,
            kernel_alone_ms=graph_device_ms(torch, lambda _: kern.attention_k5(q4, kv4, m4, H), [None], 20))
        q16, m16 = inputs(16, 500, 3 * D, torch.bfloat16, lens16, 1.5)

    # K7 against SDPA's backward alone (one SDPA forward with grad, then its
    # backward with retain_graph)
    g = torch.randn(16, 500, D, generator=gen).to("cuda", torch.bfloat16)
    qh, kh, vh = (kern.split_heads(t, H).contiguous().requires_grad_() for t in q16.chunk(3, dim=-1))
    go = kern.split_heads(g, H).contiguous()
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=(m16 > 0)[:, None, None, :])
        row("K7", "K7 (bf16, B=16, S=500); library: SDPA's backward alone",
            in_turns(torch, lambda: kern.attention_bwd(q16, m16, g, H),
                     lambda: kern.attention_bwd_plain(q16, m16, g, H),
                     lambda: torch.autograd.grad(out, (qh, kh, vh), go, retain_graph=True)),
            {"bf16": flops.attn_flops(H, hd, 500, lens16, products=5)}, 2 * 16 * 500 * 7 * D)
    del out, qh, kh, vh

    with torch.inference_mode():
        # K8, K8′; the bound over the work the log-mel needs
        front = configs.FrontendConfig()
        cols, terms = fused.spectrum_work(front)
        bins = front.fft_size // 2 + 1
        for frames in (1000, 3000):
            rows = fused.buffer_to_rows((0.1 * torch.randn(BATCH, frames * 160, generator=gen)).to("cuda"),
                                        frames, front)
            dft, mel = 2 * BATCH * frames * front.window_length * cols, 2 * BATCH * frames * terms
            nbytes = 4 * (BATCH * fused.audio_rows_for(frames, front) * front.hop_length
                          + BATCH * frames * front.num_mels)
            bufs = (0.1 * torch.randn(BATCH, frames * 160 + front.window_length, generator=gen)).to("cuda")
            win = torch.hann_window(front.window_length, periodic=True, device="cuda")
            melm = torch.rand(bins, front.num_mels, generator=gen).to("cuda")

            def library():
                spec = torch.stft(bufs, front.fft_size, front.hop_length, front.window_length, win,
                                  center=False, return_complex=True).abs()
                return torch.log(spec.transpose(1, 2)[:, :frames] @ melm + front.log_offset)

            for name, fast, ops in (("K8", False, {"fp32": dft + mel}),
                                    ("K8′", True, {"bf16": 3 * dft, "fp32": mel})):
                row(f"{name} {frames}", f"{name} log-mel (B=32, {frames} frames); library: "
                    "torch.stft, abs, the mel product, log",
                    in_turns(torch, lambda: fused.fused_log_mel(rows, front, frames, fast_dft=fast),
                             lambda: fused.fused_log_mel_plain(rows, front, frames, fast_dft=fast),
                             library if not fast else None), ops, nbytes)

        # the frequency table's gradient of the bf16 step at B=128: g read
        # once, the int64 indices read once, the fp32 table written once
        b, s = 128, 500
        inds = (torch.arange(s) % 8).repeat(b, 1)
        inds[torch.arange(s)[None, :] >= torch.randint(s // 4, s + 1, (b,), generator=gen)[:, None]] = 0
        inds = inds.reshape(-1).to("cuda")
        g = (torch.randn(b * s, D, generator=gen) + 0.5).to("cuda", torch.bfloat16)
        row("table_grad", "table_grad (bf16, 64 000 x 768 -> 8); plain: fp32 index_add_; library: "
            "the gather's backward, bf16 index_put_(accumulate=True)",
            in_turns(torch, lambda: kern.table_grad(g, inds, 8), lambda: kern.table_grad_plain(g, inds, 8),
                     lambda: torch.zeros(8, D, dtype=torch.bfloat16, device="cuda").index_put_(
                         (inds,), g, accumulate=True), 20),
            {}, g.numel() * 2 + inds.numel() * 8 + 8 * D * 4)

        # the LayerNorm link's device time, bf16 (K1, K3, K3′, K6) and fp32 (K2)
        n_rows = BATCH * 496
        sc = (1.0 + 0.1 * torch.randn(D, generator=gen)).to("cuda")
        sh = (0.1 * torch.randn(D, generator=gen)).to("cuda")
        for dt, kind, size in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4)):
            xs = [torch.randn(BATCH, 496, D, generator=gen).to("cuda", dt)
                  for _ in range(-(-150_000_000 // (n_rows * D * size)))]
            sc_t, sh_t = sc.to(dt), sh.to(dt)
            t = {"ms": graph_device_ms(torch, lambda x: kern.layer_norm(x, sc, sh, 1e-6), xs),
                 "library_ms": graph_device_ms(torch, lambda x: F.layer_norm(x, (D,), sc_t, sh_t, 1e-6), xs)}
            row(f"K1.layer_norm {kind}", f"LayerNorm link ({kind}, B=32, S=496), device time; library: "
                "F.layer_norm", t, {}, 2 * size * n_rows * D)
            del xs


def nocell_rows(torch, emit):
    """The rates of the paths that no cell measures yet."""
    import contextlib
    import io

    import numpy as np
    import torch.distributed as dist

    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.data.audio_io import load_audio
    from cacophony_tpu_torch.data.tokenizer import ByteLevelBPETokenizer
    from cacophony_tpu_torch.eval import cli as eval_cli
    from cacophony_tpu_torch.hear import predictions_runner
    from cacophony_tpu_torch.hear import runner as hear_runner
    from cacophony_tpu_torch.models import caco
    from cacophony_tpu_torch.models.audio import audiomae_apply, audiomae_init
    from cacophony_tpu_torch.models.caco import caco_init
    from cacophony_tpu_torch.parallel import make_mesh
    from cacophony_tpu_torch.runtime import CacoEngine
    from cacophony_tpu_torch.runtime.continuous import ContinuousCaptioner
    from cacophony_tpu_torch.train import train

    card = own("_kernel_times_card", "tests/torch_card.py")
    rs = np.random.RandomState(SEED)
    cfg = configs.caco_base()
    model = caco_init(cfg, torch.Generator().manual_seed(SEED))

    def rate(cell, name, values, unit, **extra):
        emit(dict(rate=name, values=values, unit=unit, cell=cell, **extra))

    def clips_per_s(engine, wavs, runs=2):
        engine.embed_audio(wavs[:BATCH])
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.embed_audio(wavs)
            out.append(len(wavs) / (time.perf_counter() - t0))
        return out

    wavs10 = [(0.1 * rs.randn(160_000)).astype(np.float32) for _ in range(4 * BATCH)]
    wavs30 = [(0.1 * rs.randn(480_000)).astype(np.float32) for _ in range(3 * BATCH)]
    for name, cell, dt, seconds, fused_fe, wavs in (
            ("embed_fp32_10s", "E-4 item 6, audiomae_base.hear_embed (fp32, K2)", torch.float32, 10.0,
             False, wavs10),
            ("embed_bf16_10s_fused_frontend", "E-4 item 7, embed_10s_fused (K8)", torch.bfloat16, 10.0,
             True, wavs10),
            ("embed_bf16_30s", "E-4 item 2, embed_30s (K3)", torch.bfloat16, 30.0, False, wavs30)):
        engine = CacoEngine(cfg, model, batch_size=BATCH, dtype=dt, buffer_seconds=seconds,
                            fused_frontend=fused_fe)
        rate(cell, f"{name}_clips_per_s", clips_per_s(engine, wavs), "clips/s",
             clips_a_run=len(wavs), batch=BATCH)
        del engine

    # decode and the continuous captioner at bench.py's shapes: bf16, 256
    # streams × 64 at 500 patches, T 1.0; 256 requests on 256 slots
    tok = ByteLevelBPETokenizer(card.byte_vocab(), [])
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    kw = dict(bos_id=tok.bos_token_id, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id)
    with torch.inference_mode():
        batch = card.decode_batch(256, SEED)

        def call(graph, trial):
            return caco.decode(model, cfg16, batch, max_length=64, temperature=1.0, cuda_graph=graph,
                               generator=torch.Generator(device="cuda").manual_seed(trial), **kw)

        ids = call(True, 0)
        rates = {"graph": [], "eager": []}
        for graph in (True, False, False, True):
            call(graph, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for trial in range(3):
                call(graph, trial + 1)
            torch.cuda.synchronize()
            rates["graph" if graph else "eager"].append(256 * 63 * 3 / (time.perf_counter() - t0))
        rate("E-4 item 4, caption_decode", "decode_tokens_per_s", rates, "tokens/s",
             nonzero_ids=int(ids[:, 1:].ne(0).sum()), of=256 * 63)
        reqs = [{k: v[i:i + 1] for k, v in card.decode_batch(256, SEED + 1).items()} for i in range(256)]
        ids_tok = types.SimpleNamespace(bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
                                        pad_token_id=tok.pad_token_id,
                                        batch_decode=lambda ids, **_: [""] * len(ids))

        def serve(seed):
            server = ContinuousCaptioner(cfg16, model, ids_tok, num_slots=256, max_length=64,
                                         temperature=1.0, seed=seed, drain_every=32, device="cuda")
            server.run(reqs)
            return server

        serve(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server = serve(1)
        torch.cuda.synchronize()
        rate("E-4 item 5, caption_continuous", "continuous_tokens_per_s",
             [256 * 63 / (time.perf_counter() - t0)], "tokens/s",
             tokens_generated=server.tokens_generated)
        del batch, reqs, server

    # the bf16 30-s step (B=4, 1500 patches), 3 timed steps after one
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    state = train.init_train_state(caco_init(cfg16, torch.Generator().manual_seed(SEED)).cuda(), tc)
    step = train.make_caco_train_step(cfg16, tc)
    tb = card.train_batch(cfg16, rs, 4, 30, 1500)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ms = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, tb, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    rate("E-4 item 9, train_30s", "train_bf16_30s_step_ms", ms, "ms", batch=4)
    del state, step

    # the one-rank dp step (NCCL, no launcher) against the step without a
    # mesh, bf16 10 s at B=16, 7 each in turns after a round of warm-up
    tb = card.train_batch(cfg16, rs, 16, 10, 500)
    mesh = make_mesh(dp=1, device="cuda")
    try:
        state = train.init_train_state(caco_init(cfg16, torch.Generator().manual_seed(SEED)).cuda(), tc)
        steps = {"none": train.make_caco_train_step(cfg16, tc),
                 "mesh": train.make_caco_train_step(cfg16, tc, mesh=mesh)}
        ms = {"none": [], "mesh": []}
        for i in range(8):
            for k in (("none", "mesh") if i % 2 else ("mesh", "none")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = steps[k](state, tb, gen)
                float(m["loss"])
                torch.cuda.synchronize()
                if i:
                    ms[k].append((time.perf_counter() - t0) * 1e3)
        rate("E-4 item 3, train_dp4", "train_bf16_10s_step_ms_dp1", ms, "ms", batch=16)
        del state, steps
    finally:
        dist.destroy_process_group()
    del model

    # stage 1: the reconstruction forward at bench.py's shape (B=64, 500
    # patches, mask 0.8), the median of 5
    mcfg = configs.audiomae_base()
    mae = audiomae_init(mcfg.encoder, mcfg.decoder, torch.Generator().manual_seed(SEED)).cuda()
    m = card.mae_input(64, mcfg.mask_ratio)
    args = [m[k] for k in card.MAE_ARGS]
    ms = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audiomae_apply(mae, mcfg.encoder, mcfg.decoder, *args, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    rate("E-4 item 1, audiomae_base.pretrain_10s", "mae_recon_clips_per_s",
         [64 / float(np.median(ms[1:])) * 1e3], "clips/s", forward_ms=ms[1:])
    del mae, m, args

    # eval and HEAR from files: zs on 400 ESC-50-shaped clips (5 s, 44.1 kHz
    # PCM16, 40 in each of 10 categories) and the host's read and resample
    # of 32 alone; both HEAR embedders on a 5-fold scene task of 5 × 48 clips
    # of 5 s (Beijing Opera Percussion's size) and the probes over them.
    # Two runs each; the first pays the process's first imports.
    with tempfile.TemporaryDirectory(prefix="kernel_times_") as tmp:
        caco_dir, mae_dir = card.write_models(tmp, SEED + 17)
        tok_dir = card.write_tokenizer(os.path.join(tmp, "tok"))
        rs = np.random.RandomState(SEED + 20)
        cats = ("dog", "rain", "siren", "crying baby", "church bells", "rooster", "sea waves",
                "clock tick", "helicopter", "chainsaw")
        esc = card.write_esc50(os.path.join(tmp, "esc50"), rs, cats, 40, lambda: 5.0)
        paths = sorted(os.listdir(os.path.join(esc, "audio")))[:BATCH]
        t0 = time.perf_counter()
        for f in paths:
            load_audio(os.path.join(esc, "audio", f), expected_sr=44100)
        decode_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
        zs = ["--ckpt_path", caco_dir, "--tokenizer", tok_dir, "--batch_size", str(BATCH),
              "--device", "cuda", "--task", "zs", "--dataset", "esc50"]
        zs_rates = {"float32": [], "bfloat16": []}
        os.environ["CACOPHONY_ESC50_DIR"] = esc
        for _ in range(2):
            for dt in zs_rates:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    eval_cli.main(zs + ["--dtype", dt])
                line = next(ln for ln in buf.getvalue().splitlines()
                            if ln.startswith("zs.decode_embed_stream: "))
                zs_rates[dt].append(400 / float(line.split()[1].rstrip("s")))
        rate("E-4 item 11, eval_zs_esc50", "zs_clips_per_s", zs_rates, "clips/s",
             host_read_resample_ms_a_clip=decode_ms)
        tasks, task = os.path.join(tmp, "tasks"), "kfold-v1.0.0-full"
        card.write_hear_task(tasks, task, "scene", "multiclass",
                             {f"fold{i:02d}": 48 for i in range(5)}, ["top1_acc"],
                             ("bangu", "naobo", "daibo", "xiaoluo"), rs, lambda: 5.0, duration=5.0)
        embed = {"caco": [], "audiomae": []}
        pred_s = []
        for r in range(2):
            root = os.path.join(tmp, f"embeddings_{r}")
            for name, path in (("caco", caco_dir), ("audiomae", mae_dir)):
                with contextlib.redirect_stdout(io.StringIO()):
                    hear_runner.run(path, tasks, root, embedding_name=name, batch_size=8, device="cuda")
                with open(os.path.join(root, name, task, "profile.embeddings.json")) as f:
                    embed[name].append(240 / json.load(f)["time_elapsed"])
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                predictions_runner.run(root, grid="faster", device="cuda")
            torch.cuda.synchronize()
            pred_s.append(time.perf_counter() - t0)
        rate("E-4 item 6, audiomae_base.hear_embed", "hear_clips_per_s", embed, "clips/s",
             predictions_runner_s=pred_s)


def measure(tree: str, groups, emit) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from cacophony_tpu_torch.ops import _kernels as kern

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    assert os.path.dirname(kern.__file__).startswith(os.path.abspath(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kern.load_library()
    emit({"row": "build", "s": time.perf_counter() - t0, "device": torch.cuda.get_device_name(0)})
    if "kernels" in groups:
        # a whole pass untimed first: every row's first call, the clocks'
        # ramp and the allocator's growth fall outside the timed pass
        kernel_rows(torch, lambda r: None)
        kernel_rows(torch, lambda r: emit(dict(r, group="kernels")))
    if "nocell" in groups:
        nocell_rows(torch, lambda r: emit(dict(r, group="nocell")))


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        tree = args[1]
        measure(tree, args[2].split(","),
                lambda r: print("kt " + json.dumps(dict(r, tree=tree), default=float), flush=True))
        return 0
    groups = GROUPS
    if args[:1] == ["--only"]:
        groups, args = args[1].split(","), args[2:]
        if set(groups) - set(GROUPS):
            raise SystemExit(f"unknown groups {sorted(set(groups) - set(GROUPS))}; choose from {GROUPS}")
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {label}", flush=True)
    for tree in args or ["."]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                               ",".join(groups)], capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("kt "):
                print(line[3:], flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
