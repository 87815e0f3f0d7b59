"""The engine's pinned fill of one bucket: the median self time of the
program's `engine.fill` spans over the traced stretch, ms (host clock;
the program's own span, recorded while the profiler runs)."""

from portbench import spans


def read(c):
    p = spans.program(c)
    return spans.median(p.rec.self_ms("engine.fill")) if p else None
