"""The card's peak allocated memory over the training window, GiB
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats` at the
window's start)."""


def read(c):
    peak = c.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
