"""cacophony_tpu_torch — the PyTorch / CUDA port of cacophony_tpu.

The JAX package `cacophony_tpu` stays the reference; this package mirrors
its module names and runs on an NVIDIA H100 (sm_90a), with the Pallas
kernels of its main path rewritten as hand-written CUDA (`csrc/`).  It
imports torch and never jax.

Ported so far: wav → log-mel → patches → 12-layer audio ViT (every layer
through the K1 kernel chain, ops/encoder_attention.py) → pooled audio
embedding; the causal text tower and its pooler → text embedding; and the
contrastive score, served by `CacoEngine`.
"""

__version__ = "0.1.0"

from cacophony_tpu_torch import configs  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (keeps `import cacophony_tpu_torch` light)."""
    if name == "CacoEngine":
        from cacophony_tpu_torch.runtime import CacoEngine

        return CacoEngine
    raise AttributeError(name)
