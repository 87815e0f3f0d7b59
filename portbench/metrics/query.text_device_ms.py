"""The card's time for the text tower of a query: per query, the device
time of the kernels that ran between the edges of its `engine.text_tower`
spans; the median over the traced queries, ms (spans.py joins the spans'
device edges to the kernels)."""

from portbench import spans


def read(c):
    p = spans.program(c)
    if p is None or p.dev_off is None:
        return None
    return spans.median(list(p.device_ms("engine.text_tower", by_request=True).values()))
