from cacophony_tpu_torch.runtime.engine import CacoEngine  # noqa: F401
