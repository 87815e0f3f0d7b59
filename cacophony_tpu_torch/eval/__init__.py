from cacophony_tpu_torch.eval.metrics import jackknife_stats, retrieval_metrics  # noqa: F401
from cacophony_tpu_torch.eval.tasks import audio_captioning, audio_retrieval, zs_classification  # noqa: F401
