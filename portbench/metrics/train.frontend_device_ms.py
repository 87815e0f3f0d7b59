"""The card's time for the training step's device frontend (log-mel,
patches, the patch subset): the device time of the kernels between the
edges of the `train.frontend` spans, per step of the traced stretch, ms."""

from portbench import spans


def read(c):
    return spans.per_step(c, ("train.frontend",))
