"""HEAR prediction-phase runner CLI (reference predictions/runner.py;
cacophony_tpu/hear/predictions_runner.py).

Loops task embedding directories, skipping those with prediction-done.json,
validating embedding dimensions across splits, logging per task.  The
probes train on `--device`: the card unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from cacophony_tpu_torch.hear.predictions import (
    FAST_PARAM_GRID,
    FASTER_PARAM_GRID,
    PARAM_GRID,
    task_predictions,
)

GRIDS = {"default": PARAM_GRID, "fast": FAST_PARAM_GRID, "faster": FASTER_PARAM_GRID}


def _check_embedding_dims(task_dir: Path):
    dims = set()
    for f in task_dir.glob("*.embedding-dimensions.json"):
        dims.add(json.loads(f.read_text())[1])
    if len(dims) > 1:
        raise ValueError(f"inconsistent embedding dims across splits: {dims}")


def run(embeddings_dir: str, task: str = "all", grid: str = "default",
        grid_points: int = 8, strict_reference_bugs: bool = False, device="cuda"):
    root = Path(embeddings_dir)
    if task == "all":
        task_dirs = sorted(p for p in root.glob("*/*") if p.is_dir())
    else:
        task_dirs = [p for p in root.glob(f"*/{task}") if p.is_dir()]

    for task_dir in task_dirs:
        if (task_dir / "prediction-done.json").exists():
            print(f"skip {task_dir.name} (done)")
            continue
        if not (task_dir / "task_metadata.json").exists():
            continue
        log_path = task_dir / "prediction.log"
        handler = logging.FileHandler(log_path)
        task_logger = logging.getLogger("cacophony_tpu_torch.hear")
        task_logger.setLevel(logging.INFO)  # default WARNING would drop
        task_logger.addHandler(handler)     # the per-conf INFO lines
        try:
            _check_embedding_dims(task_dir)
            result = task_predictions(str(task_dir), grid=GRIDS[grid],
                                      grid_points=grid_points,
                                      strict_reference_bugs=strict_reference_bugs,
                                      device=device)
            print(f"{task_dir.name}: {result['test']}")
        finally:
            task_logger.removeHandler(handler)
            handler.close()


def main(argv=None):
    p = argparse.ArgumentParser("cacophony_tpu_torch.hear.predictions_runner")
    p.add_argument("--embeddings-dir", default="embeddings")
    p.add_argument("--task", default="all")
    p.add_argument("--grid", choices=sorted(GRIDS), default="default")
    p.add_argument("--grid-points", type=int, default=8)
    p.add_argument("--strict-reference-bugs", action="store_true",
                   help="reproduce the reference's postprocess selection "
                        "bit-for-bit, incl. its unconditional descending "
                        "sort even for minimizing primaries (segment ER)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the probes (cuda, or cpu)")
    a = p.parse_args(argv)
    run(a.embeddings_dir, a.task, a.grid, a.grid_points,
        strict_reference_bugs=a.strict_reference_bugs, device=a.device)


if __name__ == "__main__":
    main()
