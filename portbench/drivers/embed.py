"""Kind "embed": closed, offline bulk embedding through `CacoEngine.embed_audio`.

Traffic parameters: `buffer_seconds`, `batch_size`, `dtype`; a pool of
`pool_clips` clips at the sample rate, `full_share` of them the buffer's
length and the rest at the quantiles of U(`short_seconds`), the same set of
lengths on every seed in a seeded order, with seeded content (three tones
under a slow envelope, and noise); each call embeds `passes` shuffled
passes over the pool; calls repeat until the window has passed.  The
window ends when the last call has returned its host embeddings.

Correctness: after the window and with the program freed, `check_clips`
embeddings drawn from the seed out of every call of the window (the
shortest clip of the pool and a full one among them) against the plain
reference's fp32 embeddings of the same clips: `embed_gap` is the largest
L2 distance between a served unit row and the reference's."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import frozen, harness, plain, port, work

SPAN = "portbench.embed_audio"


def seeds(seed: int):
    """(weights seed, traffic seed, numpy generator) of a run seed."""
    return seed * 8 + 1, seed * 8 + 2, np.random.default_rng([seed, 2])


def pool_lengths(t: dict, sr: int) -> np.ndarray:
    n = t["pool_clips"]
    full = int(round(n * t["full_share"]))
    lo, hi = t["short_seconds"]
    q = (np.arange(n - full) + 0.5) / max(1, n - full)
    short = np.round((lo + (hi - lo) * q) * sr).astype(np.int64)
    return np.concatenate([np.full(full, int(round(t["buffer_seconds"] * sr))), short])


def make_pool(t: dict, sr: int, tseed: int, rng, device) -> list:
    """The pool's clips as host fp32 arrays, drawn on the card in bulk."""
    lens = rng.permutation(pool_lengths(t, sr))
    n, samples = len(lens), int(lens.max())
    g = torch.Generator(device=device).manual_seed(tseed)

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    tt = torch.arange(samples, device=device, dtype=torch.float32) / sr
    audio = 0.02 * torch.randn((n, samples), generator=g, device=device)
    for _ in range(3):
        f = 80.0 * (6000.0 / 80.0) ** u(n, 1)
        audio += (0.05 + 0.25 * u(n, 1)) * torch.sin(2 * np.pi * f * tt + 6.3 * u(n, 1))
    audio *= 0.5 + 0.5 * torch.sin(2 * np.pi * (0.2 + 2.8 * u(n, 1)) * tt + 6.3 * u(n, 1))
    host = audio.cpu().numpy()
    return [host[i, :lens[i]] for i in range(n)]


def run(ctx) -> dict:
    cell, t, dev = ctx.cell, ctx.cell.traffic, ctx.device
    from cacophony_tpu_torch.models.caco import CacoModel
    from cacophony_tpu_torch.runtime.engine import CacoEngine

    cfg = cell.config
    sr = cfg["frontend"]["sample_rate"]
    wseed, tseed, rng = seeds(ctx.seed)
    pcfg = port.caco_config(cfg, t["dtype"])
    model = port.build(CacoModel, (pcfg,), plain.make_weights(cell.ref.leaves(cfg), wseed, dev),
                       dev)
    engine = CacoEngine(pcfg, model, device=dev, buffer_seconds=t["buffer_seconds"],
                        batch_size=t["batch_size"], dtype=port.DTYPES[t["dtype"]])
    seq = engine.patch.patches_seq_len
    pool = make_pool(t, sr, tseed, rng, dev)

    def order():
        return np.concatenate([rng.permutation(len(pool)) for _ in range(t["passes"])])

    engine.embed_audio([pool[i] for i in order()])  # warm-up: every shape of the cell
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    calls, outs, marks = [], [], []
    start = ctx.window_starts()
    while time.perf_counter() - start < ctx.seconds or not calls:
        idx = order()
        outs.append(engine.embed_audio([pool[i] for i in idx]))
        calls.append(idx)
        marks.append(time.perf_counter())
    elapsed = time.perf_counter() - start
    clips = sum(len(c) for c in calls)
    call_ms = 1e3 * np.diff([start] + marks)
    ctx.note(f"embed: {len(calls)} calls, {clips} clips in {elapsed:.3f} s (a call: min "
             f"{call_ms.min():.1f}, median {np.median(call_ms):.1f}, max {call_ms.max():.1f} ms); "
             f"seq {seq}, batch {t['batch_size']}, peak buckets in flight {engine.peak_in_flight}")
    samples = int(round(t["buffer_seconds"] * sr))
    full_seq = work.valid_patches(samples, cfg["frontend"], 1 << 30)
    layer = {"units_per_s": clips / elapsed,
             "flops_per_unit": frozen.pipeline_matmul_flops(cfg, cfg["frontend"], full_seq, samples)}
    if ctx.trace:
        stretch = []

        def one():
            idx = order()
            stretch.extend(len(pool[i]) for i in idx)
            engine.embed_audio([pool[i] for i in idx])

        ctx.stretch = harness.profile(ctx, one, t["profile_calls"], SPAN, sync)
        layer["profiled_clips"] = len(stretch)
        layer["attention_least_s"] = work.embed_attention_least_s(cfg, stretch, full_seq)
        layer["gemm_least_s"] = work.embed_gemm_least_s(cfg, stretch, t["batch_size"], full_seq)
    if dev == "cuda":
        ctx.memory_peak = torch.cuda.max_memory_allocated()
    del engine, model
    if dev == "cuda":
        torch.cuda.empty_cache()
    # the sample: drawn from the seed over every (call, row) of the window
    pairs = [(int(c), int(r)) for c, r in zip(rng.integers(0, len(calls), t["check_clips"]),
                                              rng.integers(0, len(calls[0]), t["check_clips"]))]
    lens = np.array([len(p) for p in pool])
    last = calls[-1]
    pairs += [(len(calls) - 1, int(np.argmin(lens[last]))),
              (len(calls) - 1, int(np.argmax(lens[last])))]
    served = np.stack([outs[c][r] for c, r in pairs])
    picked = [int(calls[c][r]) for c, r in pairs]
    t_ref = time.perf_counter()
    ref = reference(cell, wseed, pool, picked, t["batch_size"], dev)
    ctx.note(f"reference: {time.perf_counter() - t_ref:.1f} s")
    gap = float(np.max(np.linalg.norm(served - ref, axis=-1)))
    bad = sum(int(not np.all(np.isfinite(o))) for o in outs)

    def control(P):
        """The checks with the reference in precision P in the program's place."""
        low = reference(cell, wseed, pool, picked, t["batch_size"], dev, P)
        return {"embed_gap": float(np.max(np.linalg.norm(low - ref, axis=-1)))}

    return {"e2e": {"audio_clips_per_s": clips / elapsed}, "attempted": clips,
            "failed": bad * len(calls[0]), "checks": {"embed_gap": gap}, "layer": layer,
            "control": control}


@torch.no_grad()
def reference(cell, wseed: int, pool, picked, block: int, dev, P=plain.Exact):
    """The plain reference's embeddings of pool[picked], `block` clips at a
    time, from weights made again from the seed, over every valid patch of
    the buffer."""
    plain.no_tf32()
    W = plain.make_weights(cell.ref.leaves(cell.config), wseed, dev)
    samples = int(round(cell.traffic["buffer_seconds"] * cell.config["frontend"]["sample_rate"]))
    seq = work.valid_patches(samples, cell.config["frontend"], 1 << 30)
    out = []
    for i in range(0, len(picked), block):
        ids = picked[i:i + block]
        bufs = np.zeros((len(ids), samples), np.float32)
        for j, k in enumerate(ids):
            bufs[j, :len(pool[k])] = pool[k]
        lens = torch.tensor([len(pool[k]) for k in ids], device=dev)
        out.append(cell.ref.embed_audio(W, cell.config, torch.from_numpy(bufs).to(dev), lens, seq,
                                        P).cpu().numpy())
    return np.concatenate(out)
