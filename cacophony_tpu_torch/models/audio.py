"""Audio ViT-MAE encoder (cacophony_tpu/models/audio.py, inference path).

Dense patch projection, sin-cos TIME embedding from explicit time indices,
learned frequency embedding gathered by freq indices, N pre-LN ViT layers,
final LayerNorm (reference mae.py:107-139).  Each layer takes the route the
JAX package's `_vit_block` takes at inference (models/audio.py:150-185),
decided by `ops.encoder_attention.layer_route` from the sequence length,
the widths and the compute dtype:

- "k1": the whole layer through K1 (`fused_layer`);
- "k2" / "k3": the block half through K2 / K3 (`fused_block`), then the MLP
  outside the kernel with XLA's numerics: dense rounds `x @ w` to the
  compute dtype before adding the bias cast to it, silu runs in the
  compute dtype, and the residual is added in it;
- "einsum": no kernel — LayerNorm, the einsum attention with the −1e30 key
  bias (`ops.attention.multi_head_attention`), the residual, LN2, the MLP.

The JAX package computes the MLP and the einsum attention in XLA outside
any Pallas kernel, so they stay PyTorch products here.  The MAE decoder and
the training path (dropout, drop-path) come with their own slices.
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
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.ops.attention import Attention, multi_head_attention

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


def _mlp(p: MLP, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dense → silu → Dense outside the kernels (JAX `_vit_block`:170-172,
    :190-194).  silu is h · sigmoid(h) in the compute dtype, as
    jax.nn.silu writes it; where XLA rounds inside it in bf16 is the
    backend's choice, so bf16 agrees with JAX to a tolerance, not bit for bit."""
    h = dense(p.w1, h, dtype)
    return dense(p.w2, h * torch.sigmoid(h), dtype)


def _einsum_layer(blk: ViTBlock, x, mask, num_heads: int, dtype):
    """The no-kernel layer (JAX `_vit_block`:180-203 with flash_mask set)."""
    h = layer_norm(blk.ln1, x, LN_EPS)
    x = x + multi_head_attention(blk.attn, h, num_heads=num_heads, dtype=dtype,
                                 flash_mask=mask)
    return x + _mlp(blk.mlp, layer_norm(blk.ln2, x, LN_EPS), dtype)


def encoder_layer(blk: ViTBlock, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                  route: str, dtype: torch.dtype) -> torch.Tensor:
    """One inference layer by the route `layer_route` chose."""
    if route == "k1":
        return ea.fused_layer(blk, x, mask, num_heads, LN_EPS)
    if route in ("k2", "k3"):
        y, ln2y = ea.fused_block(blk, x, mask, num_heads, LN_EPS, blocked=route == "k3")
        return y + _mlp(blk.mlp, ln2y, dtype)
    if route == "einsum":
        return _einsum_layer(blk, x, mask, num_heads, dtype)
    # "k4", "k5", "k6": no serving buffer reaches them at caco_base or caco_tiny widths
    raise NotImplementedError(
        f"encoder layer route {route!r} (the JAX package's {route.upper()} kernel) is not "
        f"ported yet: ROADMAP queue A item 2, the training slice (K4, K5, K6, K7)")


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
    route, _ = ea.layer_route(x.shape[1], cfg.hidden_size, cfg.intermediate_size, dtype)
    for blk in p.blocks:
        x = encoder_layer(blk, x, mask, cfg.num_heads, route, dtype)
    return layer_norm(p.ln_f, x, LN_EPS)
