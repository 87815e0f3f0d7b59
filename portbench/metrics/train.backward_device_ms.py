"""The card's time for the training step's backward: the device time of
the kernels between the edges of the `train.backward` spans (the autograd
engine's threads launch them on the step's stream), per step, ms."""

from portbench import spans


def read(c):
    return spans.per_step(c, ("train.backward",))
