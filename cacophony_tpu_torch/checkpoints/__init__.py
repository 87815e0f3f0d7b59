from cacophony_tpu_torch.checkpoints.bridge import jax_state_dict, params_from_jax  # noqa: F401
