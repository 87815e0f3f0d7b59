"""The host time of the text tower in a query: the median of the program's
`engine.text_tower` spans (the ids to the card and `get_text_embedding`
enqueued, up to the copy back), ms."""

from portbench import spans


def read(c):
    p = spans.program(c)
    return spans.median(p.host_ms("engine.text_tower")) if p else None
