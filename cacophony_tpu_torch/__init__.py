"""cacophony_tpu_torch — the PyTorch / CUDA port of cacophony_tpu.

The JAX package `cacophony_tpu` stays the reference; this package mirrors
its module names and runs on an NVIDIA H100 (sm_90a), with the Pallas
kernels of its main path rewritten as hand-written CUDA (`csrc/`).  It
imports torch and never jax.

Ported so far: wav → log-mel (unfused, or the fused K8 kernel) → patches →
12-layer audio ViT, each layer on the route the JAX package takes for its
length and dtype (K1, K2 or K3 kernel chains, or the einsum layer;
ops/encoder_attention.py) → pooled audio embedding; the causal text tower
and its pooler → text embedding; and the contrastive score, served by
`CacoEngine` (embed_audio at 10-s and 30-s buffers, embed_audio_long,
audio_patch_batch, embed_texts, score).  The stage-2 training step
(`train/train.py`), with the caption decoder and the training frontend;
its audio attention runs the K4 / K5 kernels and K4's backward K7.
Released checkpoints load with `load_caco` (a Flax msgpack reader of its
own, checkpoints/msgpack.py), and `python -m cacophony_tpu_torch.train.runner`
trains stage 2 from a folder of audio files and captions (host decode in
native/, the loader in data/pipeline.py), saving and resuming its state.
"""

__version__ = "0.1.0"

from cacophony_tpu_torch import configs  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (keeps `import cacophony_tpu_torch` light)."""
    if name == "CacoEngine":
        from cacophony_tpu_torch.runtime import CacoEngine

        return CacoEngine
    if name == "load_caco":
        from cacophony_tpu_torch.checkpoints.io import load_caco

        return load_caco
    raise AttributeError(name)
