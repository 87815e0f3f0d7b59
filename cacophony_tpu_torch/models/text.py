"""Causal RoBERTa-style text encoder and its attention pooler
(cacophony_tpu/models/text.py, full-sequence inference path).

- embeddings = word + absolute position (arange) + token-type row 0,
  LayerNorm (eps 1e-5), cast to the compute dtype (reference :92-129);
- post-LN blocks: self-attention → LN(h + x) → gelu-exact MLP → LN(h + x)
  (reference :295-428), causal by default (reference :385);
- single learned-query attention pooler (reference :510-536).

The text tower runs no kernel: the JAX package keeps its text attention on
the einsum path with an additive causal bias (`TEXT_ATTN_KERNEL = False`,
text.py:90, :417-418), and so does the port.  The KV cache and the caption
decoder come with the decoder slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cacophony_tpu_torch.configs import TextConfig
from cacophony_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    dense,
    gelu_exact,
    layer_norm,
    mask_to_bias,
    normal_init,
)
from cacophony_tpu_torch.ops.attention import Attention, multi_head_attention

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


def _text_block(p: TextBlock, x, cfg: TextConfig, bias, dtype):
    """Post-LN block in full-sequence mode (reference :295-428)."""
    eps = cfg.layer_norm_eps
    h = multi_head_attention(p.attn, x, num_heads=cfg.num_heads, bias=bias, dtype=dtype)
    x = layer_norm(p.ln_attn, h + x, eps)
    h = dense(p.mlp_in, x, dtype)
    h = dense(p.mlp_out, gelu_exact(h), dtype)
    return layer_norm(p.ln_mlp, h + x, eps)


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
                       dtype: torch.dtype = torch.float32
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """→ (pooled (B, D) or None, hidden (B, S, D)); causal unless
    cfg.causal is False (then padding-only masking)."""
    ids = input_ids.long()
    emb = p.embeddings
    s = ids.shape[-1]
    if s > emb.position.shape[0]:
        raise ValueError(f"sequence {s} exceeds {emb.position.shape[0]} positions")
    x = emb.word[ids] + emb.position[:s] + emb.token_type[0]
    x = layer_norm(emb.ln, x, cfg.layer_norm_eps).to(dtype)
    if cfg.causal:
        bias = _causal_bias(attention_mask)
    else:
        bias = mask_to_bias(attention_mask)[:, None, None, :]
    for blk in p.blocks:
        x = _text_block(blk, x, cfg, bias, dtype)
    pooled = text_pooler_apply(p.pooler, x, attention_mask, dtype=dtype) if pool else None
    return pooled, x
