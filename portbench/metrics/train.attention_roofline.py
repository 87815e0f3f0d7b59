"""Attention's share of its roofline in the profiled training steps: the
least time of the forward (Q·Kᵀ, P·V) and backward (five products) over
each clip's valid positions in every layer (the driver's
`attention_least_s`, from work.py) ÷ the device time of the
attention-class kernels (K4's forward, K7's backward, or PyTorch's SDPA
kernels: work.is_attention)."""

from portbench import work


def read(c):
    t = c.get("trace")
    busy = t.busy_s(work.is_attention) if t is not None else 0.0
    if busy <= 0 or not c.get("attention_least_s"):
        return None
    return 100.0 * c["attention_least_s"] / busy
