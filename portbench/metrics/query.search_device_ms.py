"""The card's time for the gallery search of a query: the device time of
the kernels between the edges of each `gallery.search` span (the product,
the mask, the top-k and the copy back); the median over the traced
queries, ms."""

from portbench import spans


def read(c):
    p = spans.program(c)
    if p is None or p.dev_off is None:
        return None
    return spans.median(list(p.device_ms("gallery.search").values()))
