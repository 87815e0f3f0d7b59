"""Readings that set a cell's correctness limits; not run by the benchmark.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 2 \\
        [--controls]

Runs the cell once per seed in this one process (short windows) and prints,
for each, the numbers the cell compares; with --controls also the same
numbers for the plain reference in lower precision put in the program's
place ("lower": fp8 products; the gallery's fp32 scores in TF32), and
for a training cell the planted fault "half of the batch left out, the
mean taken over the rest".  One JSON line a seed."""

from __future__ import annotations

import argparse
import json
import os

from portbench import harness, plain, run


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", action="store_true")
    args = ap.parse_args()
    run._cache_dirs(os.getcwd())
    cell = harness.resolve(os.getcwd(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell, seed, args.seconds, False)
        res = cell.driver().run(ctx)
        controls = {}
        if args.controls:
            controls["lower"] = res["control"](plain.Fp8)
            if cell.traffic["kind"].endswith("_train"):
                controls["half_batch"] = res["control"](plain.Exact, 0.5)
        print(json.dumps({"seed": seed, "checks": res["checks"], "controls": controls,
                          "e2e": res["e2e"], "memory_peak": ctx.memory_peak}), flush=True)


if __name__ == "__main__":
    main()
