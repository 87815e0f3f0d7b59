"""The host's launch of one bucket: the median host time of the program's
`engine.launch` spans over the traced stretch (the copy to the card, the
frontend, the encoder, the pooler, the copy back and the event all
enqueued), ms."""

from portbench import spans


def read(c):
    p = spans.program(c)
    return spans.median(p.host_ms("engine.launch")) if p else None
