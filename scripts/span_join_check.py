"""Hold the benchmark's join of the program's spans to the device trace
against the exact join, on the card.

    python scripts/span_join_check.py <cell> <seed> [seconds [dump.pkl]]

Runs one cell of BENCHMARK.json traced (as `python -m portbench.run ...
--trace 1` does) and keeps the CUDA-only profiler session that the harness
opens.  Prints, on standard output, one JSON object:

- `launches`: of the session's device events, how many share a
  correlation id with a host-side runtime or driver call (a launch);
- `marker_us`: how far the harness's marker puts the program's spans
  (portbench/spans.py, by the harness's own spans) from where the
  session's clock puts them (`trace_start_ns`): min, median, max of the
  start's gap, µs (positive: the marker places them later);
- `device_ms`: each span name's device ms over the stretch as spans.py
  joins them (edge events and one offset) beside the exact join
  (`profiling.join`: by the launch's host time), descendants included;
- `agree_share`: the share of kernel time that both joins give to the same
  span (the nearest span with edge events, for the exact join), %.
"""

from __future__ import annotations

import json
import os
import pickle
import statistics
import sys

import torch.profiler

sys.path.insert(0, os.getcwd())


def check(ctx) -> dict:
    """Run the traced context `ctx` (a `harness.Context`) → the object printed."""
    from cacophony_tpu_torch.utils import profiling
    from portbench import run

    sessions = []
    base = torch.profiler.profile

    class Kept(base):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            sessions.append(self)
            return out

    torch.profiler.profile = Kept
    try:
        result = run.execute(ctx)
    finally:
        torch.profiler.profile = base
    prog = ctx.stretch.__dict__.get("_program")
    prof = sessions[-1]
    if prog is None:
        raise SystemExit("the traced run recorded no program spans")
    rec = prog.rec
    exact = profiling.join(prof, rec)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    gaps = [prog.placed(s.start_ns) - a for s, a, _ in rec.placed(start_ns)]

    def timed(s):
        while s is not None and s.device_us is None:
            s = prog.by_id.get(s.parent)
        return s

    key = {(round(a, 3), round(b, 3)): s for _, a, b, _, s in exact}
    total = agree = 0.0
    names = sorted({s.name for s in rec.spans if s.device_us is not None})
    mine = {n: 0.0 for n in names}
    for i, (_, a, b) in enumerate(prog.kernels):
        total += b - a
        s = timed(key.get((round(a, 3), round(b, 3))))
        owner = prog.owner.get(i)
        if s is not None and owner is not None and s.id == owner.id:
            agree += b - a
        for n in names:
            if s is not None and prog.under(s, n):
                mine[n] += (b - a) / 1e3
    return {
        "cell": ctx.cell.name, "seed": ctx.seed, "correct": result["correct"],
        "launches": {"device_events": len(exact),
                     "with_launch": sum(k[3] is not None for k in exact)},
        "marker_us": [min(gaps), statistics.median(gaps), max(gaps)] if gaps else None,
        "device_ms": {n: {"spans_py": sum(prog.device_ms(n).values()), "exact": mine[n]}
                      for n in names},
        "agree_share": 100.0 * agree / total if total else None,
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "_exact": [(a, b, at, s.id if s is not None else None) for _, a, b, at, s in exact]}


def main(argv) -> None:
    from portbench import harness

    name, seed = argv[0], int(argv[1])
    seconds = float(argv[2]) if len(argv) > 2 else 5.0
    ctx = harness.Context(harness.resolve(os.getcwd(), name), seed, seconds, True)
    out = check(ctx)
    if len(argv) > 3:  # the raw stretch, to try other joins on without the card
        prog = ctx.stretch.__dict__["_program"]
        with open(argv[3], "wb") as f:
            pickle.dump({"kernels": prog.kernels, "harness": ctx.stretch.spans,
                         "recording": prog.rec, "exact": out.pop("_exact")}, f)
    out.pop("_exact", None)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
