"""Kind "caco_train": the stage-2 step, `make_caco_train_step` (the
contrastive and the captioning loss over all three towers, AdamW), fed by
`device_train_frontend`.

Traffic parameters: `batch`, `seq_len`, `buffer_seconds`, `dtype`, the
optimizer (`optimizer`: learning rate, warm-up, total steps, weight decay,
clip); a device-resident pool of `pool_clips` waveforms whose lengths are
the quantiles of U(`clip_seconds`), in a seeded order.  Each step takes
the next `batch` rows of a seeded permutation of the pool (a new one every
epoch), so the rows of the first steps all differ.  One generator on the
card, seeded from the run's seed, draws the permutations, the frontend's
patch subset and the step's dropout masks.  And each pool clip's
caption: `text_len` ids (the reference's 100), of which the caption's own
are [BOS, words, EOS] with a length from the quantiles of U(`caption_tokens`)
(the same set on every seed, in a seeded order) and words drawn from the
whole vocabulary past the special ids, then padding.
The configuration's text dropout (0.1) is on: the step draws its masks
from the step generator, in the towers' order.

Set-up, window and comparison: portbench/training.py.  The reference
runs the recorded steps in fp32 from the same weights, rows and dropout
masks (drawn ahead, in the step's order, from the step generator's state
before each step: `Drops` in configs/caco_base_ref.py), `reference_rows`
rows at a time: a first pass without gradients gives every row's audio and
text embedding, the B×B contrastive loss and its gradients with respect to
them; a second pass recomputes each block with gradients and back-
propagates those and the block's share of the caption loss."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench import frozen, plain, port, training, work


def seeds(seed: int):
    """(weights seed, traffic seed, step generator seed, numpy generator)."""
    return seed * 8 + 1, seed * 8 + 2, seed * 8 + 3, np.random.default_rng([seed, 4])


def make_captions(t: dict, cfg: dict, n: int, rng, device):
    """(ids (n, text_len) int32, mask) on the card."""
    text = cfg["text"]
    lo, hi = t["caption_tokens"]
    q = (np.arange(n) + 0.5) / n
    lens = rng.permutation(np.round(lo + (hi - lo) * q).astype(np.int64))
    ids = np.full((n, t["text_len"]), text["pad_token_id"], np.int32)
    mask = np.zeros((n, t["text_len"]), np.int32)
    first_word = max(text["bos_token_id"], text["pad_token_id"], text["eos_token_id"]) + 2
    for i, k in enumerate(lens):
        ids[i, 0], ids[i, k - 1] = text["bos_token_id"], text["eos_token_id"]
        ids[i, 1:k - 1] = rng.integers(first_word, text["vocab_size"], k - 2)
        mask[i, :k] = 1
    return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)


def run(ctx) -> dict:
    from cacophony_tpu_torch.data.pipeline import device_train_frontend
    from cacophony_tpu_torch.models.caco import CacoModel
    from cacophony_tpu_torch.train import train

    cell, t, dev = ctx.cell, ctx.cell.traffic, ctx.device
    cfg, front = cell.config, cell.config["frontend"]
    wseed, tseed, gseed, rng = seeds(ctx.seed)
    pcfg = port.caco_config(cfg, t["dtype"])
    model = port.build(CacoModel, (pcfg,), plain.make_weights(cell.ref.leaves(cfg), wseed, dev),
                       dev)
    tc = train.TrainConfig(**t["optimizer"])
    step = train.make_caco_train_step(pcfg, tc)
    pool, pool_lens, host_lens = training.make_pool(t, front["sample_rate"], tseed, rng, dev)
    ids, tmask = make_captions(t, cfg, len(host_lens), rng, dev)
    full = work.valid_patches(pool.shape[1], front, 1 << 30)
    frontend = device_train_frontend(port.frontend_config(cfg),
                                     port.pc.PatchConfig(patches_seq_len=max(full, t["seq_len"])),
                                     t["seq_len"])
    gen = torch.Generator(device=dev).manual_seed(gseed)

    def make_batch(rows):
        batch = frontend(gen, pool[rows], pool_lens[rows])
        batch["text_input_ids"], batch["text_mask"] = ids[rows], tmask[rows]
        return batch

    out = training.drive(ctx, model, train.init_train_state(model, tc), step, make_batch, gen,
                         len(host_lens), t["batch"])
    del model, step
    if dev == "cuda":
        torch.cuda.empty_cache()
    layer = {"units_per_s": out["rate"], "peak_bytes": out["window_peak"],
             "flops_per_unit": frozen.caco_train_step_matmul_flops(cfg, t["seq_len"],
                                                                    t["text_len"])}
    if out["rows_profiled"] is not None:
        lengths = [int(host_lens[i]) for r in out["rows_profiled"] for i in r]
        layer["attention_least_s"] = work.caco_attention_least_s(cfg, lengths, t["seq_len"])
    data = (pool, pool_lens, ids, tmask)
    t_ref = time.perf_counter()
    ref = reference(cell, wseed, data, out["record"], dev)
    ctx.note(f"reference: {time.perf_counter() - t_ref:.1f} s")
    names = out["names"]
    ctx.note("own-norm gaps, worst leaves: " + training.own_gaps(out["checked"], ref, names))

    def control(P, keep=1.0):
        """The checks with the reference in precision P, or on `keep` of each
        batch, in the program's place."""
        low = reference(cell, wseed, data, out["record"], dev, P, keep)
        return training.compare(training.as_program(low, names), ref, names)

    return {"e2e": {"train_samples_per_s": out["rate"]}, "attempted": out["steps"],
            "failed": out["failed"], "checks": training.compare(out["checked"], ref, names),
            "layer": layer, "control": control}


def _contrastive(a, t, scale):
    logits = torch.exp(scale) * (a @ t.T)
    labels = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def reference(cell, wseed: int, data, record, dev, P=plain.Exact, keep=1.0) -> dict:
    """The plain reference's steps over the recorded rows and dropout masks,
    from weights made again from the seed (see the module docstring).
    `keep` < 1 plants a fault: only that share of each batch's rows."""
    plain.no_tf32()
    ref, t, cfg = cell.ref, cell.traffic, cell.config
    pool, pool_lens, ids, tmask = data
    W = plain.make_weights(ref.leaves(cfg), wseed, dev)
    W0 = {k: v.clone() for k, v in W.items()}
    for v in W.values():
        v.requires_grad_(True)
    opt = plain.AdamW(W, t["optimizer"])
    losses, grad = [], None
    seq, block = t["seq_len"], t["reference_rows"]
    for rows, gstate in record:
        n = max(1, int(len(rows) * keep))
        drops = ref.Drops(cfg, gstate, len(rows), t["text_len"], seq, dev)
        rows = rows[:n]
        blocks = [slice(i, min(n, i + block)) for i in range(0, n, block)]

        def towers(sl):
            r = rows[sl]
            g = plain.patch_grid(pool[r], pool_lens[r], cfg["frontend"], seq)
            a_hidden, a_emb = ref.audio_hidden_embed(W, cfg, g, P)
            t_hidden = ref.text_hidden(W, cfg, ids[r], tmask[r], drops.block(sl), P)
            return g, a_hidden, a_emb, t_hidden, ref.text_embed(W, cfg, t_hidden, tmask[r], P)

        with torch.no_grad():
            embs = [towers(sl) for sl in blocks]
            a_all = torch.cat([e[2] for e in embs]).requires_grad_()
            t_all = torch.cat([e[4] for e in embs]).requires_grad_()
            del embs
        l_con = _contrastive(a_all, t_all, W["logit_scale"])
        l_con.backward()
        count = tmask[rows][:, 1:].sum().double()
        total = float(l_con.detach())
        for sl in blocks:
            g, a_hidden, a_emb, t_hidden, t_emb = towers(sl)
            cap = ref.caption_sum_loss(W, cfg, t_hidden, ids[rows[sl]], tmask[rows[sl]], a_hidden,
                                       g["mask"], drops, P) / count
            ((a_emb * a_all.grad[sl]).sum() + (t_emb * t_all.grad[sl]).sum() + cap).backward()
            total += float(cap.detach())
        losses.append(total)
        clipped = opt.step(W, {k: v.grad for k, v in W.items()})
        if grad is None:
            grad = {k: float(v.double().norm()) for k, v in clipped.items()}
        for v in W.values():
            v.grad = None
    change = {k: float((W[k].detach() - W0[k]).double().norm()) for k in W}
    return {"loss": losses, "grad": grad, "change": change}
