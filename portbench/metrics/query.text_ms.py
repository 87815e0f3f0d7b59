"""The median host time of `embed_texts` over the traced stretch's
queries, ms (the harness's own span around each call; the call returns
host numpy, so the host clock holds the device's work)."""


def read(c):
    return c.get("text_ms")
