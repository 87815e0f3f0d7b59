"""audiomae_base.pretrain_10s on the CPU: both stacks at caco_tiny's
widths, 4 rows of 48 patches from 1-s buffers of 0.4-1-s clips (16-48
valid patches), of which 10 are visible, at the real mix's levels."""

from tiny_cells import SMALL, TRAIN, _config


def config() -> dict:
    c = _config("audiomae_base")
    for k in ("encoder", "decoder"):
        c[k].update(SMALL)
    return c


TRAFFIC = dict(TRAIN, buffer_seconds=1.0, clip_seconds=[0.4, 1.0])
