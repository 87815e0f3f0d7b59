"""Typed configuration for the PyTorch port.

The same dataclasses, field names and defaults as `cacophony_tpu.configs`,
with torch dtypes in place of jnp dtypes.  Canonical model dimensions follow
the JAX checkpoint loader of the reference (src/caco/load_model.py:23-49).

Left out until their slices are ported: the AudioMAE configs and the
`flash_attention` switch (the port's audio encoder always runs the K1 layer
chain at inference; see ops/encoder_attention.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Log-mel spectrogram frontend (tfio semantics: frames = ceil(len/hop),
    periodic Hann, end-padded to fft_size, magnitude spectrum, TF mel matrix
    with mel-space triangles and zeroed DC bin)."""

    sample_rate: int = 16_000
    hop_length: int = 160
    window_length: int = 400
    fft_size: int = 512
    num_mels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None  # default sample_rate / 2
    log_offset: float = 1e-5
    log_scale: float = 0.2
    log_bias: float = 0.9

    @property
    def fmax(self) -> float:
        return self.sample_rate / 2 if self.mel_fmax is None else self.mel_fmax

    @property
    def num_spectrogram_bins(self) -> int:
        return self.fft_size // 2 + 1


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Spectrogram → ViT patches: 16×16 patches, time-major, first-N / pad
    to a static sequence length."""

    time_patch_size: int = 16
    freq_patch_size: int = 16
    patches_seq_len: int = 500

    @property
    def patch_size(self) -> int:
        return self.time_patch_size * self.freq_patch_size


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """ViT-MAE audio encoder (reference src/caco/load_model.py:28-40)."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 3072
    patch_size: int = 256  # 16 * 16
    num_freq_patches: int = 8
    max_time_ind: int = 10_000  # informational, as in the JAX config
    dropout_rate: float = 0.0
    drop_path_rate: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """RoBERTa-style text tower (reference roberta_text_model.py:45-65)."""

    vocab_size: int = 50_265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    cross_attention: bool = False
    causal: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class CacoConfig:
    """Top-level CACO model (reference src/caco/load_model.py:43-49)."""

    audio: AudioEncoderConfig = dataclasses.field(default_factory=AudioEncoderConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    decoder: TextConfig = dataclasses.field(
        default_factory=lambda: TextConfig(num_layers=4, cross_attention=True)
    )
    logit_scale_init: float = 2.0
    num_attention_pool_heads: int = 8
    projection_size: int = 768
    use_decoder: bool = True
    # Compute dtype for matmuls; params are always stored fp32.
    dtype: torch.dtype = torch.float32

    @property
    def pool_head_dim(self) -> int:
        return self.audio.hidden_size // self.num_attention_pool_heads


def caco_base() -> CacoConfig:
    """Canonical config matching the released Cacophony checkpoint."""
    return CacoConfig()


def caco_tiny(vocab_size: int = 128) -> CacoConfig:
    """Tiny config for unit tests."""
    return CacoConfig(
        audio=AudioEncoderConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            patch_size=256, num_freq_patches=8,
        ),
        text=TextConfig(
            vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64,
        ),
        decoder=TextConfig(
            vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64, cross_attention=True,
        ),
        num_attention_pool_heads=2,
        projection_size=32,
    )
