"""Training: objectives, the stage-1 and stage-2 steps and their runner
(`python -m cacophony_tpu_torch.train.runner`)."""
from cacophony_tpu_torch.train.losses import (  # noqa: F401
    caption_cross_entropy,
    clip_contrastive_loss,
    mae_reconstruction_loss,
)
from cacophony_tpu_torch.train.train import (  # noqa: F401
    TrainConfig,
    TrainState,
    make_caco_train_step,
    make_mae_train_step,
    mae_random_masking,
)
