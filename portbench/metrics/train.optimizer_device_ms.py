"""The card's time for the training step's gradient norm and AdamW
update: the device time of the kernels between the edges of the
`train.grad_norm` and `train.optimizer` spans, per step, ms."""

from portbench import spans


def read(c):
    return spans.per_step(c, ("train.grad_norm", "train.optimizer"))
