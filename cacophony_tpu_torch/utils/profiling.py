"""Tracing and profiling hooks (cacophony_tpu/utils/profiling.py): one
recorder of spans and counters, and `trace(logdir)`.

- `span(name)`: a named stretch of host time (start, end, parent span,
  request id inherited from the parent, thread); spans nest per thread.
  `device=` a CUDA device also records a pair of CUDA timing events on its
  current stream at the span's edges, so the span's edges on the card can
  be read after the work has run.  `request=True` opens a new request id.
- `count(name, n)`: adds n to a counter.
- `active()`: whether the recorder records; guard work done only to count.
- `recording()`: records inside the block and yields the `Recording` of
  what was recorded there (filled when the block ends).
- `take()`: hands out (and clears) everything recorded so far.
- `report(recording)`: per-name totals, calls and ms per call.
- `trace(logdir)`: a `torch.profiler` session (host, and the card's
  kernels when there is one) written as a Chrome trace to
  `logdir/trace.json`, the program's spans on their own track.
- `join(prof, recording)`: the session's device kernels, each with the host
  time of the launch that shares its correlation id and the innermost span
  open then (exact where the session holds the launches).

The recorder records only while a `torch.profiler` session is active or
inside `recording()`.  Otherwise `span` is one flag read that returns a
shared no-op object: it reads no clock and allocates nothing.  Recording
never synchronises the card either: spans are kept in memory, at most
`MAX_SPANS` of them (the rest are counted as dropped), until `take()`,
which waits for the card once to read the edge events.

Clocks: spans are taken on `time.perf_counter_ns()`; one
(`time.time_ns()`, `perf_counter_ns()`) pair taken when recording starts
puts them on the epoch clock that `torch.profiler` uses, where each event's
`time_range` counts µs from `prof.profiler.kineto_results.trace_start_ns()`.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 17
_clock = time.perf_counter_ns  # the recorder's clock (tests count its reads)


@dataclass
class Span:
    """One recorded span.  `device_us`: its edges on the card in µs from the
    recording's first edge event, for a span given a CUDA device."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    thread: int
    device_us: Optional[Tuple[float, float]] = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class Recording:
    """What a recording held: spans by start, counters, the spans dropped
    past the buffer's bound, and the (epoch ns, perf_counter ns) pair."""

    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    dropped: int = 0
    anchor: Optional[Tuple[int, int]] = None

    def self_ms(self, name: str) -> List[float]:
        """The host ms of each span of that name less its children's."""
        kids: Dict[int, float] = {}
        for s in self.spans:
            if s.parent is not None:
                kids[s.parent] = kids.get(s.parent, 0.0) + s.ms
        return [s.ms - kids.get(s.id, 0.0) for s in self.spans if s.name == name]

    def epoch_ns(self, perf_ns: int) -> int:
        wall, perf = self.anchor
        return wall + perf_ns - perf

    def placed(self, trace_start_ns: int) -> List[Tuple[Span, float, float]]:
        """Each span with its start and end in µs from `trace_start_ns`, the
        clock of a profiler session's `time_range`s."""
        return [(s, (self.epoch_ns(s.start_ns) - trace_start_ns) / 1e3,
                 (self.epoch_ns(s.end_ns) - trace_start_ns) / 1e3) for s in self.spans]


class _Off:
    """The shared span of a recorder that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span being recorded: the buffer takes a plain tuple when it ends."""

    __slots__ = ("rec", "name", "request", "device", "frame")

    def __init__(self, rec: "Recorder", name: str, request: bool, device):
        self.rec, self.name, self.request, self.device = rec, name, request, device

    def __enter__(self):
        rec = self.rec
        if rec._anchor is None:
            rec._start()
        stack, tid = rec._thread()
        parent = stack[-1] if stack else None
        request = next(rec._requests) if self.request else (parent[1] if parent else None)
        events = None
        start = _clock()
        if self.device is not None and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(torch.cuda.current_stream(self.device))
        self.frame = (next(rec._ids), request, parent[0] if parent else None, start, tid, events)
        stack.append(self.frame)

    def __exit__(self, *exc):
        sid, request, parent, start, tid, events = self.frame
        if events is not None:
            events[1].record(torch.cuda.current_stream(self.device))
        end = _clock()
        rec = self.rec
        rec._thread()[0].pop()
        with rec._lock:
            if len(rec._spans) < rec.capacity:
                rec._spans.append((self.name, start, end, sid, parent, request, tid, events))
            else:
                rec._dropped += 1
        return False


class Recorder:
    """Spans and counters of one process (module docstring)."""

    def __init__(self, capacity: int = MAX_SPANS):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._local = threading.local()
        self._explicit = 0  # open recording() blocks
        self._ids = itertools.count()
        self._requests = itertools.count(1)
        self._spans: List[tuple] = []  # (name, start, end, id, parent, request, thread, events)
        self._counters: Dict[str, int] = {}
        self._dropped = 0
        self._anchor: Optional[Tuple[int, int]] = None

    def active(self) -> bool:
        return bool(self._explicit or _autograd_profiler._is_profiler_enabled)

    def span(self, name: str, *, device=None, request: bool = False):
        if not (self._explicit or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _On(self, name, request, device)

    def count(self, name: str, n: int = 1) -> None:
        if not (self._explicit or _autograd_profiler._is_profiler_enabled):
            return
        self._start()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def _thread(self):
        """This thread's open spans and its native id."""
        local = self._local
        try:
            return local.stack, local.tid
        except AttributeError:
            local.stack, local.tid = [], threading.get_native_id()
            return local.stack, local.tid

    def _start(self) -> None:
        """Take the clock pair when a recording starts."""
        if self._anchor is None:
            with self._lock:
                if self._anchor is None:
                    self._anchor = (time.time_ns(), _clock())

    @contextlib.contextmanager
    def recording(self):
        """Record inside the block; yields a Recording of the spans and
        counter increments made in it, filled when the block ends.  The
        outermost block, with no profiler session active, also clears the
        recorder (no one else reads what it held)."""
        out = Recording()
        with self._lock:
            self._explicit += 1
            first, before = next(self._ids), dict(self._counters)
        self._start()
        try:
            yield out
        finally:
            with self._lock:
                self._explicit -= 1
                held = [t for t in self._spans if t[3] > first]
                out.counters = {k: v - before.get(k, 0) for k, v in self._counters.items()
                                if v != before.get(k, 0)}
                out.dropped, out.anchor = self._dropped, self._anchor
                if self._explicit == 0 and not _autograd_profiler._is_profiler_enabled:
                    self._drain()
            out.spans = _finish(held)

    def take(self) -> Recording:
        """Everything recorded so far, and the recorder cleared."""
        with self._lock:
            spans, counters, dropped, anchor = self._drain()
        return Recording(_finish(spans), counters, dropped, anchor)

    def _drain(self):
        out = self._spans, self._counters, self._dropped, self._anchor
        self._spans, self._counters, self._dropped, self._anchor = [], {}, 0, None
        return out


def _finish(held) -> List[Span]:
    """The buffer's tuples as Spans by start, their edge events read as µs
    from the first edge recorded (this waits for the card once)."""
    spans = [(Span(*t[:7]), t[7]) for t in held]
    timed = [(s, ev) for s, ev in spans if ev is not None]
    if timed:
        first = min(timed, key=lambda p: p[0].start_ns)[1][0]
        torch.cuda.synchronize()
        for s, (a, b) in timed:
            s.device_us = (1e3 * first.elapsed_time(a), 1e3 * first.elapsed_time(b))
    return sorted((s for s, _ in spans), key=lambda s: (s.start_ns, s.id))


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
active = RECORDER.active
recording = RECORDER.recording
take = RECORDER.take


def report(rec: Recording) -> str:
    """A recording's per-name totals of host time, calls and ms per call,
    largest first, then its counters and the spans it dropped."""
    totals: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for s in rec.spans:
        totals[s.name] = totals.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
        calls[s.name] = calls.get(s.name, 0) + 1
    lines = [f"{name}: {totals[name]:.3f}s ({calls[name]} calls, "
             f"{totals[name] / calls[name] * 1e3:.1f} ms/call)"
             for name in sorted(totals, key=totals.get, reverse=True)]
    lines += [f"{name}: {n}" for name, n in sorted(rec.counters.items())]
    if rec.dropped:
        lines.append(f"dropped spans: {rec.dropped}")
    return "\n".join(lines)


def join(prof, rec: Recording) -> List[Tuple[str, float, float, Optional[float], Optional[Span]]]:
    """The device events of a finished profiler session, by start: (name,
    start µs, end µs, launch µs or None, span or None).  The launch is the
    host-side runtime or driver call that shares the event's correlation
    id; the span is the innermost of `rec`'s spans open at the launch, on
    any thread (the autograd engine launches a backward's kernels from its
    own threads while the caller waits inside its span)."""
    results = prof.profiler.kineto_results
    start_ns, events = results.trace_start_ns(), list(results.events())
    cuda = torch.autograd.DeviceType.CUDA
    launch = {e.correlation_id(): (e.start_ns() - start_ns) / 1e3 for e in events
              if e.device_type() != cuda and e.name().startswith("cu")}
    placed = rec.placed(start_ns) if rec.anchor is not None else []
    starts = [p[1] for p in placed]
    out = []
    for e in events:
        if e.device_type() != cuda or getattr(e, "is_user_annotation", lambda: False)():
            continue
        at, inner = launch.get(e.correlation_id()), None
        i = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        while i >= 0:  # the latest-started span still open at the launch
            if placed[i][2] >= at:
                inner = placed[i][0]
                break
            i -= 1
        out.append((e.name(), (e.start_ns() - start_ns) / 1e3, (e.end_ns() - start_ns) / 1e3,
                    at, inner))
    return sorted(out, key=lambda k: k[1])


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    rec = take()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if rec.spans:
        with open(path) as f:
            doc = json.load(f)
        base = int(doc.get("baseTimeNanoseconds", 0))
        doc["traceEvents"].extend(
            {"ph": "X", "cat": "program_span", "name": s.name, "pid": "program spans",
             "tid": s.thread, "ts": (rec.epoch_ns(s.start_ns) - base) / 1e3, "dur": s.ms * 1e3,
             "args": {"request": s.request, "id": s.id, "parent": s.parent}}
            for s in rec.spans)
        with open(path, "w") as f:
            json.dump(doc, f)
