"""Audio ViT-MAE encoder (cacophony_tpu/models/audio.py, inference path).

Dense patch projection, sin-cos TIME embedding from explicit time indices,
learned frequency embedding gathered by freq indices, N pre-LN ViT layers,
final LayerNorm (reference mae.py:107-139).  Every layer runs through K1
(`ops.encoder_attention.fused_layer`), as the JAX package does at
inference.  The MAE decoder and the training path (dropout, drop-path)
come with their own slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cacophony_tpu_torch.configs import AudioEncoderConfig
from cacophony_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    dense,
    layer_norm,
    normal_init,
    sincos_time_embedding,
)
from cacophony_tpu_torch.ops.attention import Attention
from cacophony_tpu_torch.ops.encoder_attention import fused_layer

LN_EPS = 1e-6  # flax nn.LayerNorm default (reference audio tower uses it)


class MLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w1 = Dense(hidden, intermediate, generator)
        self.w2 = Dense(intermediate, hidden, generator)


class ViTBlock(nn.Module):
    """Pre-LN block parameters: ln1, attn (fused qkv + o), ln2, mlp."""

    def __init__(self, hidden: int, intermediate: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(hidden)
        self.attn = Attention(hidden, generator)
        self.ln2 = LayerNorm(hidden)
        self.mlp = MLP(hidden, intermediate, generator)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: AudioEncoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_proj = Dense(cfg.patch_size, cfg.hidden_size, generator)
        self.freq_pos_embed = nn.Parameter(
            normal_init((cfg.num_freq_patches, cfg.hidden_size), generator, 0.02))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.hidden_size, cfg.intermediate_size, generator)
            for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size)


def audio_encoder_apply(p: AudioEncoder, cfg: AudioEncoderConfig,
                        patches: torch.Tensor,    # (B, S, patch_size)
                        time_inds: torch.Tensor,  # (B, S) int
                        freq_inds: torch.Tensor,  # (B, S) int
                        mask: torch.Tensor,       # (B, S) 1 = valid
                        *, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """→ hidden states (B, S, hidden) in `dtype`.  Reference: mae.py:111-139."""
    x = dense(p.patch_proj, patches.to(dtype), dtype)
    x = x + sincos_time_embedding(time_inds, cfg.hidden_size).to(x.dtype)
    x = x + p.freq_pos_embed.to(x.dtype)[freq_inds.long()]
    for blk in p.blocks:
        x = fused_layer(blk, x, mask, cfg.num_heads, LN_EPS)
    return layer_norm(p.ln_f, x, LN_EPS)
