"""cacophony_tpu_torch — the PyTorch / CUDA port of cacophony_tpu.

The JAX package `cacophony_tpu` stays the reference; this package mirrors
its module names and runs on an NVIDIA H100 (sm_90a), with the Pallas
kernels of its main path rewritten as hand-written CUDA (`csrc/`).  It
imports torch and never jax.

Ported so far:
- serving (`CacoEngine`): wav → log-mel (unfused, or the fused K8 kernel)
  → patches → 12-layer audio ViT, each layer on the route the JAX package
  takes for its length and dtype (K1, K2 or K3 kernel chains, or the einsum
  layer; ops/encoder_attention.py) → pooled audio embedding; the causal
  text tower and its pooler → text embedding; the contrastive score
  (embed_audio at 10-s and 30-s buffers, embed_audio_long,
  audio_patch_batch, embed_texts, score);
- captioning: `CacoEngine.caption` (KV-cached batched decode, a CUDA graph
  per step on the card; models/caco.py), the continuous-batching
  `runtime.continuous.ContinuousCaptioner`, and the device-resident
  retrieval gallery `runtime.gallery.GalleryIndex`;
- stage 1, the AudioMAE (models/audio.py: `audiomae_apply`) and its
  training step; stage 2, the contrastive + caption training step
  (train/train.py), whose audio attention runs the K4 / K5 kernels and
  K4's backward K7;
- checkpoints: released Flax msgpack files load with `load_caco` /
  `load_audiomae` (a reader of its own, checkpoints/msgpack.py), and
  `python -m cacophony_tpu_torch.train.runner` trains either stage from a
  folder of audio files (host decode in native/, the loader in
  data/pipeline.py), saving and resuming its state, its text tower
  optionally started from a local HF RoBERTa directory (checkpoints/hf.py);
- data and tensor parallelism over a process-group mesh (parallel/: the
  training steps on the global batch, Megatron's split of heads and MLP
  blocks under tp, the engine and the gallery split by rows,
  `runner --dp` / `--tp` under torchrun);
- the matmul-FLOP counters and device peaks (utils/flops.py) and the
  device FFT resample (`frontend.dsp.resample_fft`).
"""

__version__ = "0.1.0"

from cacophony_tpu_torch import configs  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (keeps `import cacophony_tpu_torch` light)."""
    if name == "CacoEngine":
        from cacophony_tpu_torch.runtime import CacoEngine

        return CacoEngine
    if name == "load_caco":
        from cacophony_tpu_torch.checkpoints import load_caco

        return load_caco
    if name == "load_audiomae":
        from cacophony_tpu_torch.checkpoints import load_audiomae

        return load_audiomae
    if name == "load_tokenizer":
        from cacophony_tpu_torch.data import load_tokenizer

        return load_tokenizer
    raise AttributeError(name)
