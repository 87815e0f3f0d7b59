"""Golden-number regression gate for eval runs (`--expect golden.json`);
a copy of cacophony_tpu/eval/expect.py.

The reference's correctness bar is reproducing its published eval table
(reference src/eval/README.md:16-46) on the released checkpoints.  This
module turns that table into an executable assertion: a golden file maps
dotted paths into a task's results dict to expected values, and a run
fails loudly when any metric drifts past tolerance.

Golden file format::

    {
      "atol": 0.005,                      # default tolerance
      "expect": {
        "esc50": 0.934,                   # plain float
        "text_to_audio.R1": [0.202, 0.01] # [value, per-metric atol]
      }
    }

Jackknife metric dicts ({"estimate": ..., "ci_low": ...}) resolve to their
point estimate, matching how the reference reports them.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple


def resolve_path(results: Any, path: str) -> float:
    """Follow a dotted path through nested dicts; jackknife dicts resolve to
    their 'estimate'."""
    node = results
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"golden path {path!r}: {part!r} not in results "
                           f"(have {sorted(node) if isinstance(node, dict) else type(node).__name__})")
        node = node[part]
    if isinstance(node, dict):
        if "estimate" in node:
            node = node["estimate"]
        else:
            raise KeyError(f"golden path {path!r} resolves to a dict, not a number")
    return float(node)


def check_expectations(results: Any, golden: Dict) -> List[Tuple[str, float, float, float]]:
    """→ list of failures (path, got, want, atol); empty list = all pass."""
    default_atol = float(golden.get("atol", 0.005))
    failures = []
    for path, want in golden["expect"].items():
        if isinstance(want, (list, tuple)):
            want_val, atol = float(want[0]), float(want[1])
        else:
            want_val, atol = float(want), default_atol
        got = resolve_path(results, path)
        if abs(got - want_val) > atol:
            failures.append((path, got, want_val, atol))
    return failures


def enforce_expectations(results: Any, golden_path: str) -> None:
    """Load a golden file, compare, and raise SystemExit(1) on any drift."""
    with open(golden_path) as f:
        golden = json.load(f)
    failures = check_expectations(results, golden)
    n = len(golden["expect"])
    if failures:
        for path, got, want, atol in failures:
            print(f"EXPECT FAIL {path}: got {got:.4f}, want {want:.4f} "
                  f"(atol {atol})")
        raise SystemExit(
            f"--expect {golden_path}: {len(failures)}/{n} metrics drifted")
    print(f"--expect {golden_path}: all {n} metrics within tolerance")
