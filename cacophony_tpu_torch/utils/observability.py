"""Structured metrics logging (cacophony_tpu/utils/observability.py): a
JSONL metrics stream, appended row by row (crash-safe), mirrored to stdout."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, mirror_stdout: bool = True):
        self.path = path
        self.mirror = mirror_stdout
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, step: Optional[int] = None, **metrics):
        row = {"time": time.time()}
        if step is not None:
            row["step"] = int(step)
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.item()
            elif hasattr(v, "item"):
                v = np.asarray(v).item()
            row[k] = v
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self.mirror:
            print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items() if k != "time"), flush=True)
        return row
