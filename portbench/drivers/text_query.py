"""Kind "text_query": a retrieval server's text query, closed loop, one
client, no think time: `CacoEngine.embed_texts([prompt])`, then
`GalleryIndex.search(embedding, k)`.

Traffic parameters: `dtype`, `batch_size` (the engine pads a query to
it), `text_len`; `prompts` pre-tokenized prompts, [BOS, words, EOS], with
lengths from the quantiles of U(`prompt_tokens`) (the same set on every
seed, in a seeded order) and words drawn from the whole vocabulary past
the special ids, handed to the engine through a stand-in tokenizer that
pads ids (the vocabulary files are not in the repository); a gallery of
`gallery_rows` seeded unit rows of the projection's width, added in slabs
of `slab_rows`, `deleted_share` of them deleted; `k`.  Requests cycle
through the prompts in a seeded order until the window has passed;
`query_p95_ms` is the 95th percentile of every request's wall time.

Correctness: after the window, with the program freed, `check_queries`
requests drawn from the seed (the longest prompt among them): `text_gap`,
the largest L2 distance between a served query embedding and the plain
reference's fp32 embedding of its prompt; `search_gap`, the largest gap
between a returned score and the reference's score of the same rank, or
between the reference's score of a returned row and that rank's score,
the reference scoring the served embedding against the gallery made
again from the seed in fp32."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, plain, port

SPAN = "portbench.query"


def seeds(seed: int):
    """(weights seed, gallery seed, numpy generator)."""
    return seed * 8 + 1, seed * 8 + 5, np.random.default_rng([seed, 5])


class IdTokenizer:
    """Stands in for the tokenizer: a prompt is already a list of ids; pads
    with `pad` to max_length, as a tokenizer's "max_length" padding does."""

    def __init__(self, pad: int):
        self.pad = pad

    def __call__(self, prompts, padding=None, truncation=True, max_length=None,
                 return_tensors="np"):
        ids = np.full((len(prompts), max_length), self.pad, np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            p = list(p)[:max_length]
            ids[i, :len(p)], mask[i, :len(p)] = p, 1
        return {"input_ids": ids, "attention_mask": mask}


def make_prompts(t: dict, cfg: dict, rng) -> list:
    text = cfg["text"]
    lo, hi = t["prompt_tokens"]
    q = (np.arange(t["prompts"]) + 0.5) / t["prompts"]
    lens = rng.permutation(np.floor(lo + (hi - lo + 1) * q).astype(np.int64))
    first_word = max(text["bos_token_id"], text["pad_token_id"], text["eos_token_id"]) + 2
    return [[text["bos_token_id"], *rng.integers(first_word, text["vocab_size"], k - 2).tolist(),
             text["eos_token_id"]] for k in lens]


def gallery_slabs(t: dict, dim: int, gseed: int, device):
    """The gallery's unit rows, slab by slab, from one generator."""
    g = torch.Generator(device=device).manual_seed(gseed)
    for lo in range(0, t["gallery_rows"], t["slab_rows"]):
        n = min(t["slab_rows"], t["gallery_rows"] - lo)
        x = torch.randn((n, dim), generator=g, device=device)
        yield x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def run(ctx) -> dict:
    from cacophony_tpu_torch.models.caco import CacoModel
    from cacophony_tpu_torch.runtime.engine import CacoEngine
    from cacophony_tpu_torch.runtime.gallery import GalleryIndex

    cell, t, dev = ctx.cell, ctx.cell.traffic, ctx.device
    cfg = cell.config
    wseed, gseed, rng = seeds(ctx.seed)
    W = plain.make_weights(cell.ref.leaves(cfg), wseed, dev)
    scale = float(W["logit_scale"])
    pcfg = port.caco_config(cfg, t["dtype"])
    model = port.build(CacoModel, (pcfg,), W, dev)
    del W
    engine = CacoEngine(pcfg, model, tokenizer=IdTokenizer(cfg["text"]["pad_token_id"]),
                        device=dev, batch_size=t["batch_size"], max_text_len=t["text_len"],
                        dtype=port.DTYPES[t["dtype"]])
    dim = cfg["projection_size"]
    gallery = GalleryIndex(dim, logit_scale=scale, slab=t["gallery_rows"], device=dev)
    for rows in gallery_slabs(t, dim, gseed, dev):
        gallery.add(rows.cpu().numpy())
    deleted = rng.choice(t["gallery_rows"], int(t["gallery_rows"] * t["deleted_share"]),
                         replace=False)
    gallery.delete(deleted)
    prompts = make_prompts(t, cfg, rng)
    order = rng.permutation(len(prompts))

    def query(i):
        emb = engine.embed_texts([prompts[i]])
        return emb, gallery.search(emb, k=t["k"])

    for i in sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[::max(1, len(prompts) // 8)]:
        query(i)  # warm-up: both text buckets, the search
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    served, lat = [], []
    start = ctx.window_starts()
    while time.perf_counter() - start < ctx.seconds or not served:
        i = int(order[len(served) % len(order)])
        t0 = time.perf_counter()
        emb, (scores, idx, _) = query(i)
        lat.append(time.perf_counter() - t0)
        served.append((i, emb[0], scores[0], idx[0]))
    elapsed = time.perf_counter() - start
    lat_ms = 1e3 * np.asarray(lat)
    ctx.note(f"text_query: {len(served)} requests in {elapsed:.3f} s; p50 "
             f"{np.percentile(lat_ms, 50):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} ms, "
             f"p99 {np.percentile(lat_ms, 99):.3f} ms, max {lat_ms.max():.3f} ms")
    layer = {}
    if ctx.trace:
        spans = {"text": [], "search": []}

        def traced():
            i = int(order[int(rng.integers(len(order)))])
            with ctx.span("portbench.embed_texts"):
                a = time.perf_counter()
                emb = engine.embed_texts([prompts[i]])
                b = time.perf_counter()
            with ctx.span("portbench.search"):
                gallery.search(emb, k=t["k"])
            spans["text"].append(b - a)
            spans["search"].append(time.perf_counter() - b)

        ctx.stretch = harness.profile(ctx, traced, t["profile_queries"], SPAN, sync)
        layer = {"text_ms": 1e3 * float(np.median(spans["text"])),
                 "search_ms": 1e3 * float(np.median(spans["search"]))}
    if dev == "cuda":
        ctx.memory_peak = torch.cuda.max_memory_allocated()
    del engine, model, gallery
    if dev == "cuda":
        torch.cuda.empty_cache()
    pick = sorted(set(rng.integers(0, len(served), t["check_queries"]).tolist())
                  | {max(range(len(served)), key=lambda j: len(prompts[served[j][0]]))})
    sample = [served[j] for j in pick]
    t_ref = time.perf_counter()
    checks = check(cell, wseed, gseed, deleted, prompts, sample, scale, dev)
    ctx.note(f"reference: {time.perf_counter() - t_ref:.1f} s")
    bad = sum(int(not (np.all(np.isfinite(e)) and np.all(np.isfinite(s)))) for _, e, s, _ in served)
    return {"e2e": {"query_p95_ms": float(np.percentile(lat_ms, 95))}, "attempted": len(served),
            "failed": bad, "checks": checks, "layer": layer,
            "control": lambda P: check(cell, wseed, gseed, deleted, prompts, sample, scale, dev, P)}


@torch.no_grad()
def check(cell, wseed, gseed, deleted, prompts, sample, scale, dev, P=plain.Exact) -> dict:
    """text_gap and search_gap of the sampled requests.  With a control
    `P` the served results are replaced by the reference's own in lower
    precision: the text tower in `P`, the scores with TF32 products."""
    plain.no_tf32()
    cfg, t = cell.config, cell.traffic
    W = plain.make_weights(cell.ref.leaves(cfg), wseed, dev)
    text_gap, exact = 0.0, []
    for i, emb, _, _ in sample:
        ids = torch.tensor([prompts[i]], device=dev)
        mask = torch.ones_like(ids)
        low = cell.ref.text_embed(W, cfg, cell.ref.text_hidden(W, cfg, ids, mask, None, P), mask, P)
        ref = low if P is plain.Exact else cell.ref.text_embed(
            W, cfg, cell.ref.text_hidden(W, cfg, ids, mask), mask)
        got = emb if P is plain.Exact else low[0].cpu().numpy()
        text_gap = max(text_gap, float(np.linalg.norm(got - ref[0].cpu().numpy())))
        exact.append(got)
    del W
    q = torch.from_numpy(np.stack(exact)).to(dev)
    scores = torch.cat([q @ rows.T for rows in gallery_slabs(t, cfg["projection_size"], gseed, dev)],
                       1) * float(np.exp(scale))
    scores[:, torch.from_numpy(deleted).to(dev)] = -torch.inf
    best = torch.topk(scores, t["k"], dim=1).values.cpu().numpy()
    if P is not plain.Exact:  # the control's search: the same product in TF32
        torch.backends.cuda.matmul.allow_tf32 = True
        low = torch.cat([q @ rows.T for rows in gallery_slabs(t, cfg["projection_size"], gseed, dev)],
                        1) * float(np.exp(scale))
        plain.no_tf32()
        low[:, torch.from_numpy(deleted).to(dev)] = -torch.inf
        vals, idx = torch.topk(low, t["k"], dim=1)
        served = [(v, i) for v, i in zip(vals.cpu().numpy(), idx.cpu().numpy())]
    else:
        served = [(s, ix) for _, _, s, ix in sample]
    scores = scores.cpu().numpy()
    search_gap = 0.0
    for r, (s, ix) in enumerate(served):
        search_gap = max(search_gap, float(np.max(np.abs(s - best[r]))),
                         float(np.max(np.abs(scores[r, ix] - best[r]))))
    return {"text_gap": text_gap, "search_gap": search_gap}
