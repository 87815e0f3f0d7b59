"""Training: objectives, the stage-2 step and its runner (`python -m cacophony_tpu_torch.train.runner`)."""
