"""Training: objectives and the stage-2 step."""
