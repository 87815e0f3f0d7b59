"""Causal RoBERTa-style text encoder, its attention pooler, and the caption
decoder (cacophony_tpu/models/text.py, full-sequence mode).

- embeddings = word + absolute position (arange; past the table's last row
  the position clamps to it, as JAX's gather does) + token-type row 0,
  LayerNorm (eps 1e-5), dropout, cast to the compute dtype (reference
  :92-129);
- post-LN blocks: self-attention → LN(dropout(h) + x) → [cross-attention
  → LN(dropout(h) + x)] → gelu-exact MLP → LN(dropout(h) + x) (reference
  :295-428), causal by default (reference :385);
- single learned-query attention pooler (reference :510-536);
- the caption decoder: text-encoder hidden states through cross-attention
  blocks over the audio hidden states, then the vocab projection (:606-627).

The text towers run no kernel: the JAX package keeps their attention on the
einsum path with an additive causal bias (`TEXT_ATTN_KERNEL = False`,
text.py:90, :417-418), and so does the port.  With `train=True` the
attention probabilities and the hidden states go through dropout drawn
from a `torch.Generator`.  The KV cache and decode come with the decode
slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cacophony_tpu_torch.configs import TextConfig
from cacophony_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    act_dense,
    dense,
    dropout,
    gelu_exact,
    layer_norm,
    mask_to_bias,
    normal_init,
)
from cacophony_tpu_torch.ops.attention import Attention, CrossAttention, multi_head_attention

_STD = 0.02


class TextBlock(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        self.attn = Attention(d, generator, _STD)
        self.ln_attn = LayerNorm(d)
        self.mlp_in = Dense(d, cfg.intermediate_size, generator, _STD)
        self.mlp_out = Dense(cfg.intermediate_size, d, generator, _STD)
        self.ln_mlp = LayerNorm(d)
        if cfg.cross_attention:
            self.cross = CrossAttention(d, generator, _STD)
            self.ln_cross = LayerNorm(d)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        self.word = nn.Parameter(normal_init((cfg.vocab_size, d), generator, _STD))
        self.position = nn.Parameter(normal_init((cfg.max_position_embeddings, d), generator, _STD))
        self.token_type = nn.Parameter(normal_init((cfg.type_vocab_size, d), generator, _STD))
        self.ln = LayerNorm(d)


class TextPooler(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        self.key = Dense(d, d, generator, _STD)
        self.value = Dense(d, d, generator, _STD)
        self.query = nn.Parameter(normal_init((1, d), generator, _STD))


class TextEncoder(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg, generator)
        self.blocks = nn.ModuleList(TextBlock(cfg, generator) for _ in range(cfg.num_layers))
        self.pooler = TextPooler(cfg, generator)


class CaptionDecoder(nn.Module):
    """Cross-attention text blocks and the vocab projection (JAX
    `caption_decoder_init`, text.py:141-147)."""

    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.cross_attention:
            raise ValueError("the caption decoder needs cross_attention=True")
        self.blocks = nn.ModuleList(TextBlock(cfg, generator) for _ in range(cfg.num_layers))
        self.vocab_proj = Dense(cfg.hidden_size, cfg.vocab_size, generator, 0.01)


def _post_ln_residual(ln: LayerNorm, h, residual, eps: float, generator, rate: float,
                      det: bool):
    """RoBERTa post-LN wrapper: LN(dropout(h) + residual) (reference
    :295-312, :363-380)."""
    return layer_norm(ln, dropout(generator, h, rate, det) + residual, eps)


def _text_block(p: TextBlock, x, cfg: TextConfig, bias, dtype, *, memory=None,
                memory_bias=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
    """Post-LN block in full-sequence mode (JAX `_text_block`, text.py:179-250)."""
    det = not train
    eps = cfg.layer_norm_eps
    attn_rate = 0.0 if det else cfg.attention_dropout
    h = multi_head_attention(p.attn, x, num_heads=cfg.num_heads, bias=bias, dtype=dtype,
                             dropout_rate=attn_rate, generator=generator)
    x = _post_ln_residual(p.ln_attn, h, x, eps, generator, cfg.hidden_dropout, det)
    if memory is not None:
        h = multi_head_attention(p.cross, x, num_heads=cfg.num_heads, bias=memory_bias,
                                 memory=memory, dtype=dtype, dropout_rate=attn_rate,
                                 generator=generator)
        x = _post_ln_residual(p.ln_cross, h, x, eps, generator, cfg.hidden_dropout, det)
    h = act_dense(p.mlp_out, dense(p.mlp_in, x, dtype), gelu_exact, dtype)
    return _post_ln_residual(p.ln_mlp, h, x, eps, generator, cfg.hidden_dropout, det)


def _causal_bias(text_mask: torch.Tensor) -> torch.Tensor:
    """Padding mask ∧ causal triangle → (B, 1, S, S) additive bias (reference :210-218)."""
    s = text_mask.shape[-1]
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=text_mask.device))
    combined = causal[None] & (text_mask[:, None, :] > 0)
    return mask_to_bias(combined)[:, None]


def text_pooler_apply(p: TextPooler, hidden: torch.Tensor, mask: Optional[torch.Tensor],
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Single learned-query attention pool; softmax statistics in fp32."""
    d = hidden.shape[-1]
    key = dense(p.key, hidden, dtype) / torch.sqrt(
        torch.tensor(float(d), dtype=hidden.dtype, device=hidden.device))
    value = dense(p.value, hidden, dtype)
    logits = torch.einsum("mh,bnh->bmn", p.query.to(hidden.dtype), key)
    if mask is not None:
        logits = torch.where(mask[:, None] > 0, logits.float(), torch.finfo(torch.float32).min)
    w = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
    return torch.einsum("bmn,bnh->bmh", w, value)[:, 0]


def text_encoder_apply(p: TextEncoder, cfg: TextConfig, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, *, pool: bool = True,
                       dtype: torch.dtype = torch.float32, train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """→ (pooled (B, D) or None, hidden (B, S, D)); causal unless
    cfg.causal is False (then padding-only masking).  A sequence longer
    than the position table reuses its last row for the positions past it,
    as JAX's clamping gather does (text.py:380-393)."""
    ids = input_ids.long()
    emb = p.embeddings
    s, rows = ids.shape[-1], emb.position.shape[0]
    if s <= rows:
        pos = emb.position[:s]
    else:
        pos = emb.position[torch.arange(s, device=ids.device).clamp(max=rows - 1)]
    x = emb.word[ids] + pos + emb.token_type[0]
    x = layer_norm(emb.ln, x, cfg.layer_norm_eps)
    x = dropout(generator, x, cfg.hidden_dropout, not train).to(dtype)
    if cfg.causal:
        bias = _causal_bias(attention_mask)
    else:
        bias = mask_to_bias(attention_mask)[:, None, None, :]
    for blk in p.blocks:
        x = _text_block(blk, x, cfg, bias, dtype, train=train, generator=generator)
    pooled = text_pooler_apply(p.pooler, x, attention_mask, dtype=dtype) if pool else None
    return pooled, x


def caption_decoder_apply(p: CaptionDecoder, cfg: TextConfig, text_hidden: torch.Tensor,
                          attention_mask: torch.Tensor, audio_hidden: torch.Tensor,
                          audio_mask: torch.Tensor, *, train: bool = False,
                          generator: Optional[torch.Generator] = None,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """→ vocab logits (B, S, V): teacher-forced full mode of JAX
    `caption_decoder_apply` (text.py:460-492): causal self-attention over the
    text hidden states, cross-attention to the audio hidden states."""
    bias = _causal_bias(attention_mask)
    memory_bias = mask_to_bias(audio_mask)[:, None, None, :]
    x = text_hidden
    for blk in p.blocks:
        x = _text_block(blk, x, cfg, bias, dtype, memory=audio_hidden, memory_bias=memory_bias,
                        train=train, generator=generator)
    return dense(p.vocab_proj, x, dtype)
