"""The share of the encoder's patch slots that hold a valid patch in the
traced embedding calls: the program's counters `engine.valid_patches` ÷
`engine.patch_slots` (rows × the patch budget, padding rows included), %.
Fixed by the pool's lengths: the same on every seed."""

from portbench import spans


def read(c):
    p = spans.program(c)
    return spans.share(p.counter("engine.valid_patches"), p.counter("engine.patch_slots")) \
        if p else None
