"""What the training kinds share: the device-resident clip pool, the seeded
feed, the set-up that drives and records the first steps, the window, the
plain reference's AdamW steps, and the comparison of a run with them.

Set-up builds one train state and drives its first `check_steps` steps
through the window's own feed and call; the window continues from that
same state.  It records the steps' losses, each leaf's first gradient as
the optimizer took it (from the second moment after one step: ‖g‖ =
√(Σν / (1 − β₂)); with `first_moment`, elementwise and signed too, from
the first moment: g = μ / (1 − β₁)) and each leaf's change after the
steps, and for the reference each step's rows and the step generator's
state before the step.  The window ends with a synchronise.  The
comparison: `loss_gap`, the largest relative gap of a step's loss;
`loss_step_gap`, how far that relative gap moves from the first step to
the second (under a warm-up of one step the first step's learning rate is
0, so both run on the same weights, whose rounding sets the gap alike in
both: what moves it is the rows a step takes); `grad_gap` and
`change_gap`, the worst leaf's gap of norms against the larger of its
reference norm and the median leaf's, leaves whose reference gradient is
under a thousandth of the median leaf's left out of the change; where
both sides give the elementwise first gradient, the same of the norm of
its elementwise gap (`grad_elem_gap`).

The pool's clips carry three seeded tones over noise; with `gain_db` in
the mix each clip also takes a level drawn uniformly in dB from it."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import harness, plain

SPAN = "portbench.train_step"
B1 = 0.9  # Adam's first-moment decay: after one step μ = (1 − β₁)·g
B2 = 0.999  # Adam's second-moment decay, for the first gradient's norm


def pool_lengths(t: dict, sr: int) -> np.ndarray:
    """The same set of clip lengths on every seed: the quantiles of
    U(`clip_seconds`)."""
    lo, hi = t["clip_seconds"]
    q = (np.arange(t["pool_clips"]) + 0.5) / t["pool_clips"]
    return np.round((lo + (hi - lo) * q) * sr).astype(np.int64)


def make_pool(t: dict, sr: int, tseed: int, rng, device):
    """(pool (n, buffer) fp32 on the card, lengths on the card, on the
    host): three seeded tones and noise at a seeded level within `gain_db`
    where the mix has it, zero past each clip's length."""
    lens = rng.permutation(pool_lengths(t, sr))
    samples = int(round(t["buffer_seconds"] * sr))
    g = torch.Generator(device=device).manual_seed(tseed)
    n = len(lens)
    tt = torch.arange(samples, device=device, dtype=torch.float32) / sr
    audio = 0.02 * torch.randn((n, samples), generator=g, device=device)
    for _ in range(3):
        f = 80.0 * (6000.0 / 80.0) ** torch.rand((n, 1), generator=g, device=device)
        amp = 0.05 + 0.25 * torch.rand((n, 1), generator=g, device=device)
        audio += amp * torch.sin(2 * np.pi * f * tt)
    if "gain_db" in t:
        lo, hi = t["gain_db"]
        audio *= 10.0 ** ((lo + (hi - lo) * torch.rand((n, 1), generator=g, device=device)) / 20)
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(device)
    audio *= torch.arange(samples, device=device)[None] < lens_d[:, None]
    return audio, lens_d, lens


def drive(ctx, model, state, step, make_batch: Callable, gen, pool_size: int, b: int,
          first_moment: bool = False) -> Dict:
    """Set-up's recorded steps, the window and (with --trace 1) the
    profiled stretch.  `make_batch(rows)` gives a step's batch from its pool
    rows, drawing what it draws from `gen`; `first_moment` records the first
    gradient elementwise, on the host.  → the run's readings."""
    dev, t = ctx.device, ctx.cell.traffic
    feed = {"perm": None, "at": 0, "state": state}

    def next_rows():
        if feed["perm"] is None or feed["at"] + b > pool_size:
            feed["perm"], feed["at"] = torch.randperm(pool_size, generator=gen, device=dev), 0
        rows = feed["perm"][feed["at"]:feed["at"] + b]
        feed["at"] += b
        return rows

    def one(record=None):
        with ctx.span("portbench.batch"):
            rows = next_rows()
            batch = make_batch(rows)
        if record is not None:
            record.append((rows.clone(), gen.get_state()))
        feed["state"], metrics = step(feed["state"], batch, gen)
        return rows, metrics["loss"]

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    p0 = [p.detach().clone() for p in model.parameters()]
    record, losses0 = [], []
    for k in range(t["check_steps"]):
        losses0.append(one(record)[1])
        if k == 0:
            g1 = torch.stack([torch.sqrt(nu.double().sum() / (1 - B2))
                              for nu in feed["state"].opt_state.nu])
            first = [(mu.float() / (1 - B1)).cpu() for mu in feed["state"].opt_state.mu] \
                if first_moment else None
    change = torch.stack([(p.detach() - q).double().norm() for p, q in zip(model.parameters(), p0)])
    del p0
    checked = {"loss": [float(x) for x in losses0], "grad": g1.cpu().numpy(),
               "change": change.cpu().numpy()}
    if first is not None:
        checked["first"] = first
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, marks = [], []
    start = ctx.window_starts()
    while time.perf_counter() - start < ctx.seconds or not losses:
        losses.append(one()[1])
        marks.append(time.perf_counter())
    sync()
    elapsed = time.perf_counter() - start
    steps_ms = 1e3 * np.diff([start] + marks)
    window_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    ctx.note(f"{t['kind']}: {len(losses)} steps of {b} in {elapsed:.3f} s "
             f"({1e3 * elapsed / len(losses):.1f} ms a step; host intervals min "
             f"{steps_ms.min():.1f}, median {np.median(steps_ms):.1f}, max {steps_ms.max():.1f}); "
             f"window peak "
             f"{window_peak / 2**30:.2f} GiB, set-up peak {setup_peak / 2**30:.2f} GiB")
    lengths = None
    if ctx.trace:
        seen = []

        def traced():
            seen.append(one()[0])

        ctx.stretch = harness.profile(ctx, traced, t["profile_steps"], SPAN, sync)
        lengths = [r.cpu().numpy() for r in seen]
    ctx.memory_peak = max(setup_peak, torch.cuda.max_memory_allocated()) if dev == "cuda" else 0
    failed = sum(int(not np.isfinite(float(x))) for x in losses)
    feed.clear()
    return {"checked": checked, "record": record, "rate": b * len(losses) / elapsed,
            "steps": len(losses), "failed": failed, "window_peak": window_peak,
            "rows_profiled": lengths, "names": [n for n, _ in model.named_parameters()]}


def reference_steps(W: Dict[str, torch.Tensor], opt: dict, record, backward: Callable) -> Dict:
    """The plain reference's AdamW steps (plain.AdamW) from the weights `W`
    over the recorded steps: `backward(rows, generator state)` puts a step's
    gradients into W's `.grad` and returns its loss.  → each step's loss,
    the first clipped gradient (each leaf's norm, and elementwise) and each
    leaf's change after the steps, by name."""
    W0 = {k: v.clone() for k, v in W.items()}
    for v in W.values():
        v.requires_grad_(True)
    adam = plain.AdamW(W, opt)
    losses, first = [], None
    for rows, gstate in record:
        losses.append(backward(rows, gstate))
        clipped = adam.step(W, {k: v.grad for k, v in W.items()})
        first = clipped if first is None else first
        for v in W.values():
            v.grad = None
    return {"loss": losses, "grad": {k: float(v.double().norm()) for k, v in first.items()},
            "change": {k: float((W[k].detach() - W0[k]).double().norm()) for k in W},
            "first": first}


def compare(prog: dict, ref: dict, names: List[str]) -> dict:
    """loss_gap, loss_step_gap, grad_gap, change_gap and, where both sides
    give the first gradient elementwise, grad_elem_gap of a run (leaf norms
    in `names` order) against the reference's (leaf norms by name)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    rel = [a / b - 1 for a, b in zip(prog["loss"], ref["loss"])]
    rg = np.array([ref["grad"][n] for n in names])
    rc = np.array([ref["change"][n] for n in names])
    pg, pc = np.asarray(prog["grad"]), np.asarray(prog["change"])
    grad_gap = float(np.max(np.abs(pg - rg) / np.maximum(rg, np.median(rg))))
    moved = rg >= 1e-3 * np.median(rg)
    change_gap = float(np.max(np.abs(pc - rc)[moved] / np.maximum(rc[moved], np.median(rc[moved]))))
    out = {"loss_gap": float(loss_gap), "grad_gap": grad_gap, "change_gap": change_gap}
    if len(rel) >= 2:
        out["loss_step_gap"] = float(abs(rel[0] - rel[1]))
    if "first" in prog and "first" in ref:
        gaps = np.array([float((p.to(ref["first"][n].device) - ref["first"][n]).double().norm())
                         for n, p in zip(names, prog["first"])])
        out["grad_elem_gap"] = float(np.max(gaps / np.maximum(rg, np.median(rg))))
    return out


def own_gaps(prog: dict, ref: dict, names: List[str], n: int = 5) -> str:
    """For the notes: the leaves with the largest gap of norms against their
    own reference norm (no floor of the median leaf), and every position
    table's, among the leaves the reference moves."""
    out = []
    for key in ("grad", "change"):
        r = np.array([ref[key][k] for k in names])
        rel = np.abs(np.asarray(prog[key]) - r) / np.maximum(r, 1e-30)
        moved = np.array([ref["grad"][k] for k in names]) >= 1e-3 * np.median(
            [ref["grad"][k] for k in names])
        picked = [i for i in np.argsort(-rel) if moved[i]][:n]
        picked += [i for i, k in enumerate(names) if "pos_embed" in k and i not in picked]
        out.append(f"{key}: " + ", ".join(f"{names[i]} {rel[i]:.4g}" for i in picked))
    return "; ".join(out)


def as_program(ref: dict, names: List[str]) -> dict:
    """A reference run's readings in the program's form (for a control)."""
    out = {"loss": ref["loss"], "grad": [ref["grad"][n] for n in names],
           "change": [ref["change"][n] for n in names]}
    if "first" in ref:
        out["first"] = [ref["first"][n] for n in names]
    return out
