"""CACO top-level model: the joint audio-text embedding space and the
caption decoder's parameters (cacophony_tpu/models/caco.py).

- `logit_scale`, `text_proj` and a multi-head single-query audio attention
  pooler (reference caco.py:19-69);
- get_audio_embedding: audio encoder → pooler → L2 normalize;
- get_text_embedding: text encoder → pooler → text_proj → normalize;
- normalization is bug-compatible with the reference: x / ||x + eps||;
- scoring rule exp(logit_scale) · A @ Tᵀ.

With `train=True` the embeddings run the towers' training paths (dropout
from a `torch.Generator`; the stage-2 step in train/train.py).  Decoding
(`decode`) comes with the decode slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cacophony_tpu_torch.configs import CacoConfig
from cacophony_tpu_torch.models.audio import AudioEncoder, audio_encoder_apply
from cacophony_tpu_torch.models.layers import Dense, dense, normal_init
from cacophony_tpu_torch.models.text import CaptionDecoder, TextEncoder, text_encoder_apply

NORM_EPS = 1e-10  # reference caco.py:9


class AudioPooler(nn.Module):
    def __init__(self, cfg: CacoConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.audio.hidden_size
        self.kv = Dense(d, 2 * d, generator)
        self.query = nn.Parameter(normal_init((d,), generator, 0.02))
        self.out = Dense(d, cfg.projection_size or d, generator)


class CacoModel(nn.Module):
    """Parameters of the model; names mirror the JAX tree."""

    def __init__(self, cfg: CacoConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.audio = AudioEncoder(cfg.audio, generator)
        self.text = TextEncoder(cfg.text, generator)
        self.audio_pool = AudioPooler(cfg, generator)
        self.text_proj = Dense(cfg.text.hidden_size, cfg.projection_size, generator)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init, dtype=torch.float32))
        if cfg.use_decoder:
            self.decoder = CaptionDecoder(cfg.decoder, generator)


def caco_init(cfg: CacoConfig, generator: torch.Generator) -> CacoModel:
    """Random fp32 parameters drawn from `generator` (on the CPU)."""
    return CacoModel(cfg, generator)


def audio_pooler_apply(p: AudioPooler, cfg: CacoConfig, hidden: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Multi-head single-query attention pool in cfg.dtype; softmax in fp32
    (reference caco.py:19-54)."""
    m, hd = cfg.num_attention_pool_heads, cfg.pool_head_dim
    kv = dense(p.kv, hidden, cfg.dtype)
    k, v = kv.chunk(2, dim=-1)
    b, s, _ = k.shape
    k = k.reshape(b, s, m, hd)
    v = v.reshape(b, s, m, hd)
    q = p.query.reshape(m, hd).to(hidden.dtype)
    # sqrt(hd) in q's dtype, as a Python number (a small tensor copied to the
    # card would wait for the device)
    q = q / float(torch.tensor(float(hd), dtype=q.dtype).sqrt())
    logits = torch.einsum("hd,bjhd->bhj", q, k)
    if mask is not None:
        logits = torch.where(mask[:, None] > 0, logits.float(), torch.finfo(torch.float32).min)
    w = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
    out = torch.einsum("bhj,bjhd->bhd", w, v).reshape(b, m * hd)
    return dense(p.out, out, cfg.dtype)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Bug-compatible L2 normalize in fp32: x / ||x + eps|| (reference caco.py:91)."""
    x = x.float()
    return x / torch.linalg.vector_norm(x + NORM_EPS, dim=-1, keepdim=True)


def get_audio_embedding(p: CacoModel, cfg: CacoConfig, audio_patches, audio_time_inds,
                        audio_freq_inds, audio_mask, *, normalize: bool = True,
                        train: bool = False, generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (embedding (B, proj), hidden (B, S, D)).  Reference caco.py:72-96."""
    hidden = audio_encoder_apply(p.audio, cfg.audio, audio_patches, audio_time_inds,
                                 audio_freq_inds, audio_mask, dtype=cfg.dtype, train=train,
                                 generator=generator)
    emb = audio_pooler_apply(p.audio_pool, cfg, hidden, audio_mask)
    return (_normalize(emb) if normalize else emb), hidden


def get_text_embedding(p: CacoModel, cfg: CacoConfig, text_input_ids, text_mask, *,
                       normalize: bool = True, train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (embedding (B, proj), hidden (B, S, D)).  Reference caco.py:99-123.
    text_proj runs without a dtype, so a bf16 pooled vector promotes to fp32."""
    pooled, hidden = text_encoder_apply(p.text, cfg.text, text_input_ids, text_mask,
                                        dtype=cfg.dtype, train=train, generator=generator)
    emb = dense(p.text_proj, pooled)
    return (_normalize(emb) if normalize else emb), hidden


def contrastive_logits(p: CacoModel, audio_emb: torch.Tensor,
                       text_emb: torch.Tensor) -> torch.Tensor:
    """exp(logit_scale) · A @ Tᵀ (embeddings must be normalized)."""
    return torch.exp(p.logit_scale) * audio_emb @ text_emb.T
