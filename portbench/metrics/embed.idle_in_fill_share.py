"""The share of the card's idle time between kernels in the traced
embedding calls (the gaps `Trace.idle_gaps` takes) during which the host's
innermost program span was `engine.fill`, %.  The program's spans are put
on the kernels' clock by the harness's spans (spans.py)."""

from portbench import spans


def read(c):
    p = spans.program(c)
    return p.idle_share("engine.fill") if p else None
