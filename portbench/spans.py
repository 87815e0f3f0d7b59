"""The program's own spans and counters over a traced stretch, joined to
the device trace, for the per-layer metrics of the engine, the text tower,
the gallery and the training step's phases.

The program's recorder (`cacophony_tpu_torch.utils.profiling`) records
while the harness's profiler session runs.  What it recorded is taken once
a stretch, when the first of these metrics is read, and kept on the
stretch's `harness.Trace`; the Trace itself is left as it was.  A program
without the recorder gives nothing, and so does a stretch without device
kernels (a run on the CPU): these are numbers of the port on the card.

The program's spans are put on the kernels' clock (µs from the profiler's
start) by their edge events: a span given a CUDA device records an event
on its stream at each edge, read as µs from the first edge.
- first guess: the harness's own spans are on the kernels' clock by its
  marker; a program span that a harness span wraps (`ANCHORS`) ends just
  before it, and an edge fires no earlier than the host recorded it.  On an
  H100 the marker placed the host 0.17 to 2.5 ms late.
- device offset: on one stream a kernel runs wholly between the edges
  around its launch, so the offset is where the fewest edges fall inside a
  kernel, below the guess.  The events' clock may run at another rate than
  the kernels' (from -401 to +623 ppm in stretches on an H100), so the
  rate is fitted with it where one offset leaves edges inside kernels.
- host offset: an edge fires about when the host records it on an idle
  stream, so the least gap between the edges' places and their host times
  places the host (within µs where the rate is near 0).
A kernel belongs to the innermost span whose device edges hold its
midpoint, and to that span's ancestors."""

from __future__ import annotations

import bisect
import statistics
import sys
from typing import Dict, List, Optional

# (program span, the harness span that wraps it and ends just after it)
ANCHORS = (("engine.embed_audio", "portbench.embed_audio"),
           ("engine.embed_texts", "portbench.embed_texts"),
           ("gallery.search", "portbench.search"),
           ("train.frontend", "portbench.batch"))
SEARCH_US = (3000.0, 200.0)  # how far below and above its first guess the offset is sought
EDGE_TOL_US = 0.5  # an edge may sit this far inside a kernel (events' resolution)
# the events' clock against the kernels': rates tried, coarse then fine
# (step, steps each side, how far the offset may move with the rate, µs)
RATE_STEPS = ((2.5e-5, 40, 0.0), (2.5e-6, 10, 300.0), (2.5e-7, 10, 100.0))
COARSE_EDGES = 128
CANDIDATES = 8  # coarse rates refined
ENDS_US = 1000.0  # the stretch's first and last edges lie this near its kernels


def program(c: dict) -> Optional["Program"]:
    """The stretch's program spans and counters (taken once a stretch), or
    None without a stretch or without the recorder."""
    t = c.get("trace")
    if t is None:
        return None
    if "_program" not in t.__dict__:
        t._program = _take(t)
    return t._program


def _take(trace) -> Optional["Program"]:
    try:
        from cacophony_tpu_torch.utils.profiling import take
    except ImportError:  # a program without the recorder
        return None
    rec = take()
    if not trace.kernels or not (rec.spans or rec.counters):
        return None  # a run without the card's kernels: no number of the port on the card
    p = Program(rec, trace.kernels, trace.spans)
    print(f"portbench spans: {len(rec.spans)} spans, {rec.dropped} dropped; "
          f"kernel time no span claims: {p.unclaimed_share()}; {p.about}",
          file=sys.stderr, flush=True)
    return p


def per_step(c: dict, names) -> Optional[float]:
    """Device ms of the kernels inside spans of these names, per training
    step (the stretch's `train.forward` spans), or None."""
    p = program(c)
    if p is None or p.dev_off is None or not p.spans("train.forward"):
        return None
    return sum(sum(p.device_ms(n).values()) for n in names) / len(p.spans("train.forward"))


def median(values: List[float]) -> Optional[float]:
    return float(statistics.median(values)) if values else None


def share(num: Optional[float], den: Optional[float]) -> Optional[float]:
    return 100.0 * num / den if num is not None and den else None


class Program:
    """A recording joined to a stretch's kernels and harness spans."""

    def __init__(self, rec, kernels, harness_spans):
        self.rec, self.kernels = rec, sorted(kernels, key=lambda k: k[1])
        self.by_id = {s.id: s for s in rec.spans}
        self.host_off = self.marker_off = self._host_offset(harness_spans)
        self.dev_off, self.owner, about = None, {}, []
        if self.kernels and self.host_off is not None:
            self._join_device(about)
        self.about = "; ".join(about) or "not joined to kernels"

    # ------------------------------------------------------------ host side

    def spans(self, name: str) -> list:
        return [s for s in self.rec.spans if s.name == name]

    def host_ms(self, name: str) -> List[float]:
        return [s.ms for s in self.spans(name)]

    def counter(self, name: str) -> Optional[int]:
        return self.rec.counters.get(name)

    def under(self, s, name: str) -> bool:
        """Whether span s is `name` or lies inside a span of that name."""
        while s is not None:
            if s.name == name:
                return True
            s = self.by_id.get(s.parent)
        return False

    def _host_offset(self, harness_spans) -> Optional[float]:
        best = None
        for prog, wrap in ANCHORS:
            mine = [s for s in self.rec.spans if s.name == prog and s.parent is None]
            theirs = [h for h in harness_spans if h[0] == wrap]
            if mine and len(mine) == len(theirs):
                gap = min(h[2] - s.end_ns / 1e3 for s, h in zip(mine, theirs))
                best = gap if best is None else min(best, gap)
        return best

    def placed(self, ns: int) -> float:
        return ns / 1e3 + self.host_off

    # ---------------------------------------------------------- device side

    def _join_device(self, about: list) -> None:
        timed = [s for s in self.rec.spans if s.device_us is not None]
        if not timed:
            return
        guess = max(self.placed(s.start_ns) - s.device_us[0] for s in timed)
        edges = [e for s in timed for e in s.device_us]
        mid = 0.5 * (min(edges) + max(edges))
        off, rate, inside = self._fit(edges, guess, mid)
        self.dev_off, self.dev_rate, self._mid = off, rate, mid
        self.host_off = min(self.on_kernels(s.device_us[0]) - s.start_ns / 1e3 for s in timed)
        about.append(f"device edges placed {off - guess:+.1f} µs from the first guess, their "
                     f"clock {rate * 1e6:+.1f} ppm ({inside} of {len(edges)} edges inside a "
                     f"kernel); the host {self.host_off - self.marker_off:+.1f} µs from the "
                     f"harness's marker")
        windows = sorted(((self.on_kernels(s.device_us[0]), self.on_kernels(s.device_us[1]), s)
                          for s in timed), key=lambda w: w[0])
        starts = [w[0] for w in windows]
        for i, (_, a, b) in enumerate(self.kernels):
            mid, j = 0.5 * (a + b), bisect.bisect_right(starts, 0.5 * (a + b)) - 1
            while j >= 0:  # the latest-starting window that still holds the midpoint
                if windows[j][1] >= mid:
                    self.owner[i] = windows[j][2]
                    break
                j -= 1

    def _fit(self, edges: List[float], guess: float, mid: float):
        """The events' clock on the kernels' → (offset at `mid`, rate, edges
        inside a kernel there), sought from SEARCH_US below the first guess
        to a little above it.  Where edges still fall inside kernels at one
        offset, rates are tried coarse (on a sample of the edges, each edge
        allowed as far inside a kernel as the step leaves it) then fine
        around the CANDIDATES best, and kept where they leave fewer inside."""
        self._starts = [k[1] for k in self.kernels]
        self._reach, top = [], float("-inf")
        for k in self.kernels:  # the latest end up to each kernel
            top = max(top, k[2])
            self._reach.append(top)
        lo, hi = guess - SEARCH_US[0], guess + SEARCH_US[1]
        off0, n0 = self._sweep(edges, guess, lo, hi)
        if not n0:
            return off0, 0.0, n0
        far = max(abs(x - mid) for x in edges)
        some = sorted(edges)[::max(1, len(edges) // COARSE_EDGES)]
        (step, width, _), finer = RATE_STEPS[0], RATE_STEPS[1:]
        tol = EDGE_TOL_US + 0.5 * step * far
        coarse = sorted((self._sweep([x + k * step * (x - mid) for x in some], guess, lo, hi,
                                     tol)[::-1] + (k * step,)) for k in range(-width, width + 1))
        best = (n0, off0, 0.0)
        for m, off, rate in coarse[:CANDIDATES]:  # the fewest inside, then the nearest
            for step, width, reach in finer:
                tol, centre, pick = EDGE_TOL_US + 0.5 * step * far, rate, None
                for k in range(-width, width + 1):
                    r = centre + k * step
                    o, m = self._sweep([x + r * (x - mid) for x in edges], guess, off - reach,
                                       off + reach, tol)
                    if pick is None or (m, abs(o - guess), abs(k)) < pick[0]:
                        pick = ((m, abs(o - guess), abs(k)), o, r)
                _, off, rate = pick
            o, n = self._sweep([x + rate * (x - mid) for x in edges], guess, off - reach,
                               off + reach)
            if (n, abs(o - guess)) < (best[0], abs(best[1] - guess)):
                best = (n, o, rate)
        return best[1], best[2], best[0]

    def _sweep(self, edges: List[float], guess: float, lo: float, hi: float,
               tol: float = EDGE_TOL_US):
        """The offset in (lo, hi) → (offset, edges inside a kernel there; an
        edge more than ENDS_US outside the stretch's kernels counts as one).
        Among the offsets at which the fewest edges fall inside a kernel, the
        stretch of them nearest `guess`; at its lower end, where an edge that
        fired on a busy stream meets the end of the kernel before it (higher
        offsets only keep edges in idle time)."""
        marks, first, last = [], self.kernels[0][1] - ENDS_US, self._reach[-1] + ENDS_US
        for x in edges:
            if first - x > lo:  # an edge long before the stretch's first kernel
                marks += [(lo, 1), (min(first - x, hi), -1)]
            if last - x < hi:  # or long after its last
                marks += [(max(last - x, lo), 1), (hi, -1)]
            j = bisect.bisect_left(self._starts, x + hi) - 1
            while j >= 0 and self._reach[j] > x + lo:
                a, b = self._starts[j] + tol - x, self.kernels[j][2] - tol - x
                if b > a and b > lo and a < hi:
                    marks += [(max(a, lo), 1), (min(b, hi), -1)]
                j -= 1
        marks.sort(key=lambda m: (m[0], m[1]))
        best, depth, at = None, 0, lo
        for x, step in marks + [(hi, 0)]:
            if x > at:  # (at, x) lies inside `depth` kernels' intervals
                key = (depth, max(0.0, at - guess, guess - x))
                if best is None or key < best[0]:
                    best = (key, at)
            depth += step
            at = max(at, x)
        if best is None:
            return guess, 0
        return min(best[1] + tol, hi), best[0][0]

    def on_kernels(self, edge_us: float) -> float:
        """An edge's time on the kernels' clock."""
        return edge_us + self.dev_off + self.dev_rate * (edge_us - self._mid)

    def device_ms(self, name: str, by_request: bool = False) -> Dict[int, float]:
        """Device ms of the kernels inside each span of that name (by span id,
        or by request id), descendants included; spans with none read 0."""
        out = {(s.request if by_request else s.id): 0.0 for s in self.spans(name)
               if s.device_us is not None}
        for i, s in self.owner.items():
            while s is not None and s.name != name:
                s = self.by_id.get(s.parent)
            if s is not None:
                key = s.request if by_request else s.id
                a, b = self.kernels[i][1], self.kernels[i][2]
                out[key] = out.get(key, 0.0) + (b - a) / 1e3
        return out

    def unclaimed_share(self) -> str:
        total = sum(b - a for _, a, b in self.kernels)
        if not total or self.dev_off is None:
            return "not measured (no device kernels or no device edges)"
        mine = sum(self.kernels[i][2] - self.kernels[i][1] for i in self.owner)
        return f"{100.0 * (1 - mine / total):.3f} % of {total / 1e6:.4f} s"

    def idle_share(self, name: str) -> Optional[float]:
        """% of the device's idle µs between kernels (as Trace.idle_gaps takes
        them) during which the host's innermost program span, on any thread,
        was `name` or inside it."""
        if not self.kernels or self.host_off is None:
            return None
        gaps, end = [], None
        for _, a, b in self.kernels:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        total = sum(b - a for a, b in gaps)
        if not total:
            return None
        hit = sum(min(b, y) - max(a, x) for a, b, s in self._innermost() if self.under(s, name)
                  for x, y in _overlapping(gaps, a, b))
        return 100.0 * hit / total

    def _innermost(self):
        """The host timeline cut where a span opens or closes: (start, end,
        the latest-opened span still open) for each piece inside a span."""
        marks = sorted([(self.placed(s.start_ns), 1, s) for s in self.rec.spans] +
                       [(self.placed(s.end_ns), -1, s) for s in self.rec.spans],
                       key=lambda m: (m[0], m[1]))
        open_, out, at = {}, [], None
        for x, step, s in marks:
            if open_ and at is not None and x > at:
                inner = max(open_.values(), key=lambda o: (o.start_ns, o.id))
                out.append((at, x, inner))
            if step > 0:
                open_[s.id] = s
            else:
                open_.pop(s.id, None)
            at = x
        return out


def _overlapping(gaps, a: float, b: float):
    """The gaps (sorted, disjoint) that meet (a, b)."""
    i = max(0, bisect.bisect_right(gaps, (a, float("inf"))) - 1)
    while i < len(gaps) and gaps[i][0] < b:
        if gaps[i][1] > a:
            yield gaps[i]
        i += 1
