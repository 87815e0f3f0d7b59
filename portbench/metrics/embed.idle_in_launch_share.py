"""The share of the card's idle time between kernels in the traced
embedding calls during which the host's innermost program span was
`engine.launch` or one inside it (`engine.frontend`, `audio.encoder`,
`audio.pooler`), %."""

from portbench import spans


def read(c):
    p = spans.program(c)
    return p.idle_share("engine.launch") if p else None
