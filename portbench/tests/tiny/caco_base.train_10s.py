"""caco_base.train_10s on the CPU: 4 rows of 48 patches, 12-token captions."""

from tiny_cells import TRAIN
from tiny_cells import caco as config  # noqa: F401

TRAFFIC = dict(TRAIN, text_len=12, caption_tokens=[4, 10])
