"""The card's time for the training step's forward (`loss_fn`: the three
towers and both losses): the device time of the kernels between the edges
of the `train.forward` spans, per step of the traced stretch, ms."""

from portbench import spans


def read(c):
    return spans.per_step(c, ("train.forward",))
