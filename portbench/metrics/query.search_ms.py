"""The median host time of `GalleryIndex.search` over the traced
stretch's queries, ms (the harness's own span around each call; it
returns host numpy)."""


def read(c):
    return c.get("search_ms")
