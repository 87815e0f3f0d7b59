"""What every cell shares: finding a cell's files by name, the device's
description, the profiled stretch and its reduction (device busy time,
kernel time by name, idle gaps by the harness span the host was in), the
guard against JAX in the process, and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "cacophony_tpu")


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`cacophony_tpu_torch` is not `cacophony_tpu`)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_file(path: str, name: Optional[str] = None):
    """Import a Python file by its path (metric files carry dots in their
    names, so they are not importable as modules)."""
    spec = importlib.util.spec_from_file_location(name or f"portbench_file_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads and the files it names."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    ref: object
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str
    chips: int = 1

    def driver(self):
        return load_file(os.path.join(self.root, "portbench", "drivers",
                                      f"{self.traffic['kind']}.py"),
                         f"portbench_driver_{self.traffic['kind']}")

    def reader(self, metric: str):
        return load_file(os.path.join(self.root, "portbench", "metrics", f"{metric}.py"))


def _applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration, its
    plain reference, its traffic mix, its limits and its metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    ref = load_file(os.path.join(root, conf["file"][:-len(".json")] + "_ref.py"),
                    f"portbench_ref_{w['config']}")
    with open(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(root, "portbench", "limits", f"{name}.json")) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, config, traffic, limits, ref, e2e, layer, root, w["chips"])


# ------------------------------------------------------------------ device

def device_notes() -> str:
    """The card's name, clocks and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,"
                              "clocks.sm,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        return out or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


# ---------------------------------------------------------------- profiling

@dataclass
class Trace:
    """A profiled stretch: device intervals (name, start µs, end µs), the
    harness's host spans on the device's clock (name, start µs, end µs) and
    the wall seconds."""

    kernels: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    wall_s: float

    def busy_s(self, select: Callable[[str], bool] = lambda n: True) -> float:
        """Seconds of the union of the selected device intervals."""
        busy, end = 0.0, -math.inf
        for _, a, b in sorted((k for k in self.kernels if select(k[0])), key=lambda k: k[1]):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, a, b in self.kernels:
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k[:200], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device intervals, each named by the
        innermost harness span whose range holds the gap's start (the span
        the host was in while the card waited)."""
        gaps, end = [], None
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if end is not None and a > end:
                gaps.append((a - end, end))
            end = b if end is None else max(end, b)
        out = []
        for length, at in sorted(gaps, reverse=True)[:n]:
            inside = [s for s in self.spans if s[1] <= at <= s[2]]
            label = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "between spans"
            out.append([label, length / 1e6])
        return out


def profile(ctx: "Context", fn: Callable[[], None], n: int, span_name: str, sync) -> Trace:
    """Run `fn` n times under torch.profiler with CUDA activity alone (the
    host's own ops are not recorded, so the host keeps its unprofiled
    pace), each call inside a harness span named `span_name`.  The host spans are put on the device's clock
    by a marker: the first operation of the stretch, launched on an idle
    card.  `sync` waits for the device at the end."""
    import torch
    from torch.profiler import ProfilerActivity

    sync()
    on_card = torch.cuda.is_available()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA if on_card
                                            else ProfilerActivity.CPU]) as prof:
        t_marker = time.perf_counter()
        torch.empty(1, device="cuda" if on_card else "cpu").fill_(1.0)
        ctx.spans = []
        try:
            for _ in range(n):
                with ctx.span(span_name):
                    fn()
            sync()
            wall = time.perf_counter() - t_marker
        finally:
            host, ctx.spans = ctx.spans, None
    kernels = [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("portbench.")]
    kernels.sort(key=lambda k: k[1])
    origin = kernels[0][1] if kernels else 0.0
    spans = [(name, origin + 1e6 * (a - t_marker), origin + 1e6 * (b - t_marker))
             for name, a, b in host]
    return Trace(kernels[1:], spans, wall)


# ------------------------------------------------------------------ result

@dataclass
class Context:
    """What a driver is handed and fills in."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = field(default_factory=process_start)
    t_window: Optional[float] = None
    memory_peak: Optional[int] = None
    stretch: Optional[Trace] = None
    spans: Optional[list] = None  # host spans while a stretch is profiled

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span around a call into the program: recorded (host
        clock) while a stretch is profiled, to name the device's idle gaps."""
        if self.spans is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def window_starts(self) -> float:
        self.t_window = time.time()
        return time.perf_counter()

    def note(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)


def judge(limits: dict, checks: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each compared number against its limit (≤); a missing or non-finite
    number fails."""
    shown, ok = {}, True
    for key, limit in limits.items():
        value = checks.get(key)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        shown[key] = {"value": value, "limit": limit}
    return ok, shown
