"""Kind "mae_train": the stage-1 step, `make_mae_train_step` (MAE random
masking, the encoder over the visible patches, the decoder over all
positions, the masked reconstruction loss, AdamW), fed by
`device_train_frontend`.

Traffic parameters: `batch`, `seq_len`, `buffer_seconds`, `dtype`, the
optimizer (`optimizer`: learning rate, warm-up, total steps, weight decay,
clip); a device-resident pool of `pool_clips` waveforms whose lengths are
the quantiles of U(`clip_seconds`), in a seeded order, each at a seeded
level within `gain_db`.  Each step takes
the next `batch` rows of a seeded permutation of the pool (a new one every
epoch), so the rows of the first steps all differ.  One generator on the
card, seeded from the run's seed, draws the permutations, the frontend's
patch subset and the step's masking noise.  The mask ratio is the
configuration's.

Set-up, window, comparison and the reference's AdamW loop:
portbench/training.py, with the first gradient recorded elementwise
(`grad_elem_gap`).  The reference
runs the recorded steps in fp32 from the same weights and rows, the
masking noise drawn again from the step generator's state before each
step (configs/audiomae_base_ref.py), `reference_rows` rows at a time:
each block's share of the masked mean is back-propagated by itself."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import frozen, plain, port, training, work


def seeds(seed: int):
    """(weights seed, traffic seed, step generator seed, numpy generator)."""
    return seed * 8 + 1, seed * 8 + 2, seed * 8 + 3, np.random.default_rng([seed, 4])


def mae_config(c: dict, dtype: str) -> "port.pc.AudioMAEConfig":
    pc = port.pc
    return pc.AudioMAEConfig(encoder=pc.AudioEncoderConfig(**c["encoder"]),
                             decoder=pc.AudioDecoderConfig(**c["decoder"]),
                             mask_ratio=c["mask_ratio"], dtype=port.DTYPES[dtype])


def run(ctx) -> dict:
    from cacophony_tpu_torch.data.pipeline import device_train_frontend
    from cacophony_tpu_torch.models.audio import AudioMAE
    from cacophony_tpu_torch.train import train

    cell, t, dev = ctx.cell, ctx.cell.traffic, ctx.device
    cfg, front = cell.config, cell.config["frontend"]
    wseed, tseed, gseed, rng = seeds(ctx.seed)
    mcfg = mae_config(cfg, t["dtype"])
    model = port.build(AudioMAE, (mcfg.encoder, mcfg.decoder),
                       plain.make_weights(cell.ref.leaves(cfg), wseed, dev), dev)
    tc = train.TrainConfig(**t["optimizer"])
    step = train.make_mae_train_step(mcfg, tc)
    pool, pool_lens, host_lens = training.make_pool(t, front["sample_rate"], tseed, rng, dev)
    full = work.valid_patches(pool.shape[1], front, 1 << 30)
    frontend = device_train_frontend(port.frontend_config(cfg),
                                     port.pc.PatchConfig(patches_seq_len=max(full, t["seq_len"])),
                                     t["seq_len"])
    gen = torch.Generator(device=dev).manual_seed(gseed)

    def make_batch(rows):
        return frontend(gen, pool[rows], pool_lens[rows])

    out = training.drive(ctx, model, train.init_train_state(model, tc), step, make_batch, gen,
                         len(host_lens), t["batch"], first_moment=True)
    del model, step
    if dev == "cuda":
        torch.cuda.empty_cache()
    layer = {"units_per_s": out["rate"], "peak_bytes": out["window_peak"],
             "flops_per_unit": frozen.mae_train_step_matmul_flops(cfg, t["seq_len"],
                                                                  cfg["mask_ratio"])}
    if out["rows_profiled"] is not None:
        lengths = [int(host_lens[i]) for r in out["rows_profiled"] for i in r]
        layer["attention_least_s"] = work.mae_attention_least_s(cfg, lengths, t["seq_len"])
    data = (pool, pool_lens)
    t_ref = time.perf_counter()
    ref = reference(cell, wseed, data, out["record"], dev)
    ctx.note(f"reference: {time.perf_counter() - t_ref:.1f} s")
    names = out["names"]
    ctx.note("own-norm gaps, worst leaves: " + training.own_gaps(out["checked"], ref, names))
    ctx.note("losses, program / reference: " + ", ".join(
        f"{a:.7g} / {b:.7g}" for a, b in zip(out["checked"]["loss"], ref["loss"])))

    def control(P, keep=1.0):
        """The checks with the reference in precision P, or on `keep` of each
        batch, in the program's place."""
        low = reference(cell, wseed, data, out["record"], dev, P, keep)
        return training.compare(training.as_program(low, names), ref, names)

    return {"e2e": {"train_samples_per_s": out["rate"]}, "attempted": out["steps"],
            "failed": out["failed"], "checks": training.compare(out["checked"], ref, names),
            "layer": layer, "control": control}


def reference(cell, wseed: int, data, record, dev, P=plain.Exact, keep=1.0) -> dict:
    """The plain reference's steps over the recorded rows and masking noise,
    from weights made again from the seed (see the module docstring).
    `keep` < 1 plants a fault: only that share of each batch's rows."""
    plain.no_tf32()
    ref, t, cfg = cell.ref, cell.traffic, cell.config
    pool, pool_lens = data
    seq, block = t["seq_len"], t["reference_rows"]
    W = plain.make_weights(ref.leaves(cfg), wseed, dev)

    def backward(rows, gstate):
        n = max(1, int(len(rows) * keep))
        noise = ref.noise(gstate, len(rows), seq, dev)[:n]
        rows = rows[:n]
        grids, count = [], 0
        with torch.no_grad():
            for i in range(0, n, block):
                r = rows[i:i + block]
                g = plain.patch_grid(pool[r], pool_lens[r], cfg["frontend"], seq)
                vis = ref.visible(cfg, noise[i:i + block], g["mask"])
                count += int(ref.masked(g, vis).sum())
                grids.append((g, vis))
        total = 0.0
        for g, vis in grids:
            part = ref.masked_sum_loss(W, cfg, g, vis, P) / max(count, 1)
            part.backward()
            total += float(part.detach())
        return total

    return training.reference_steps(W, t["optimizer"], record, backward)
