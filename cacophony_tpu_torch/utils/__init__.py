"""Metrics logging and profiling hooks."""
from cacophony_tpu_torch.utils.observability import MetricsLogger  # noqa: F401
from cacophony_tpu_torch.utils.profiling import trace  # noqa: F401
