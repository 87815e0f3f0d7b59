"""Run one cell of BENCHMARK.json once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's driver (drivers/<kind>.py,
the kind named by its traffic file) makes the weights and the traffic from
the seed on the card, warms up (set-up), measures for --seconds, reads the
peak memory, frees the program's state and compares what the timed path
produced with the plain reference.  With --trace 1 the end-to-end window
is followed by a short stretch under torch.profiler, and the cell's
per-layer metrics (metrics/<name>.py) are reported instead of the
end-to-end ones.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, close standard error and that
line.  Exits 2 with no result without a card, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import harness

_T_IMPORT = time.time()


def _cache_dirs(root: str) -> None:
    """Every compiler cache of the process inside the checkout, at fixed
    paths, so that only a checkout's first run builds."""
    base = os.path.join(root, "portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    _cache_dirs(root)
    if not os.path.exists(os.path.join(root, "BENCHMARK.json")):
        fail("run from the root of a checkout that holds BENCHMARK.json")
    cell = harness.resolve(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"needs {cell.chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import cacophony_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        fail(f"the program is not in this checkout ({e})")
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace))
    out = execute(ctx)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"JAX or the JAX package was loaded: {', '.join(bad)}")
    emit(out)


def execute(ctx: "harness.Context") -> dict:
    """Drive the cell and build the result object."""
    import torch

    cell = ctx.cell
    on_card = ctx.device == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu (a test run: no device numbers)"
    ctx.note(f"portbench: {cell.name}, seed {ctx.seed}, {ctx.seconds:g} s, trace {int(ctx.trace)}; "
             f"card: {harness.device_notes() if on_card else 'none'}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}; process start to import "
             f"{_T_IMPORT - ctx.t_start:.3f} s")
    res = cell.driver().run(ctx)
    metrics = {}
    if not ctx.trace:
        e2e = dict(res["e2e"], setup_s=ctx.t_window - ctx.t_start)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        read_ctx = dict(res.get("layer", {}), cell=cell, trace=ctx.stretch,
                        device_name=kind, e2e=res["e2e"])
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(read_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, shown = harness.judge(cell.limits, res["checks"])
    correct = correct and res["failed"] == 0 and res["attempted"] > 0
    out = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                      "memory_peak_bytes": ctx.memory_peak}}
    if ctx.trace:
        out["device"]["busy_s"] = ctx.stretch.busy_s()
        out["device"]["window_s"] = ctx.stretch.wall_s
        out["breakdown"] = {"device_ops": ctx.stretch.top_ops(), "idle_gaps": ctx.stretch.idle_gaps()}
    out["checks"] = shown
    return out


def emit(out: dict) -> None:
    print(f"correct {out['correct']}", file=sys.stderr)
    for key, v in out["checks"].items():
        print(f"check {key} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
