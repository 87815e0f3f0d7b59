"""The share of the profiled stretch of queries in which no
operation ran on the card: 100 · (1 − union of device intervals ÷ wall)."""


def read(c):
    t = c.get("trace")
    if t is None or t.wall_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
