"""Tracing and profiling hooks (cacophony_tpu/utils/profiling.py).

- `trace(logdir)`: a `torch.profiler` session (host, and the card's kernels
  when there is one) written as a Chrome trace to `logdir/trace.json`;
- `annotate(name)`: a named region in that trace
  (`torch.profiler.record_function`);
- `StageTimer`: per-stage wall time that synchronises the card before it
  reads the clock, so that queued kernels are counted in their stage.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Wall-clock stage timing.  The card is synchronised before each
    reading of the clock; `result_fetch` (a tensor, or anything with
    `.cpu()`) is also fetched before the stage ends."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result_fetch=None):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result_fetch is not None and hasattr(result_fetch, "cpu"):
                result_fetch.cpu()
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name}: {self.totals[name]:.3f}s "
                         f"({self.counts[name]} calls, "
                         f"{self.totals[name] / self.counts[name] * 1e3:.1f} ms/call)")
        return "\n".join(lines)
