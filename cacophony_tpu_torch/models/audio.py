"""Audio ViT-MAE encoder (cacophony_tpu/models/audio.py).

Dense patch projection, sin-cos TIME embedding from explicit time indices,
learned frequency embedding gathered by freq indices, N pre-LN ViT layers,
final LayerNorm (reference mae.py:107-139).  Each layer takes the route the
JAX package's `_vit_block` takes at inference (models/audio.py:150-185),
decided by `ops.encoder_attention.layer_route` from the sequence length,
the widths and the compute dtype:

- "k1": the whole layer through K1 (`fused_layer`);
- "k2" / "k3": the block half through K2 / K3 (`fused_block_attention`), then the MLP
  outside the kernel with XLA's numerics: dense rounds `x @ w` to the
  compute dtype before adding the bias cast to it, silu runs in the
  compute dtype, and the residual is added in it;
- "k6": LN1 → QKV → attention through K6 (`fused_ln_attention`), then the
  o-projection, the residual, LN2 and the MLP outside the kernel (JAX's
  narrow fallback, `_vit_block`:175-203);
- "einsum", "k4", "k5": the unfused block `vit_block` — LayerNorm, then
  `ops.attention.multi_head_attention`, which itself takes K4 (one-shot
  plan), K5 (blocked plan) or the einsum attention with the −1e30 key bias
  (no plan), the residual, LN2, the MLP.

Every route is differentiable, as in JAX, where the fused kernels are
`custom_vjp`s whose backward rematerialises the layer in XLA.

In training (`train=True`) every layer is `vit_block`, as in JAX, where the
fused routes are off in training (`FUSED_IN_TRAIN = False`, audio.py:55):
attention through K4 / K5 (whose backwards are K7 or autograd of the plain
math) while attention dropout is 0, dropout and drop-path from a
`torch.Generator`, and the `act_dense` MLP tail.  Under tensor
parallelism (`parallel.shard_params`) the training layers run Megatron's
split — the attention on this rank's heads, the MLP on its block of the
hidden features (`dense`'s column- and row-parallel forms) — and the
MLP-hidden dropout draws its mask at the global width and keeps this
rank's block.  Inference runs on whole parameters.

The JAX package computes the MLP and the einsum attention in XLA outside
any Pallas kernel, so they stay PyTorch products here.

The stage-1 AudioMAE (JAX models/audio.py:123-135, :260-319): the
reconstruction decoder re-projects the encoder's hidden states with
`in_proj`, adds the same positional scheme, appends a learned mask token
(plus its positions) for every patch to reconstruct, and runs its layers by
the encoder's rules on the concatenated length — `layer_route`'s route at
inference, `vit_block` in training — then `ln_f` and `out_proj`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cacophony_tpu_torch.configs import AudioDecoderConfig, AudioEncoderConfig
from cacophony_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    act_dense,
    dense,
    drop_path,
    dropout,
    layer_norm,
    normal_init,
    silu,
    sincos_time_embedding,
)
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.ops.attention import Attention, multi_head_attention
from cacophony_tpu_torch.parallel.tensor import tp_shard

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


class AudioDecoder(nn.Module):
    """The MAE's reconstruction decoder; `mask_token` is one (hidden,) row."""

    def __init__(self, cfg: AudioDecoderConfig, encoder_hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_proj = Dense(encoder_hidden, cfg.hidden_size, generator)
        self.freq_pos_embed = nn.Parameter(
            normal_init((cfg.num_freq_patches, cfg.hidden_size), generator, 0.02))
        self.mask_token = nn.Parameter(normal_init((cfg.hidden_size,), generator, 0.02))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.hidden_size, cfg.intermediate_size, generator)
            for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size)
        self.out_proj = Dense(cfg.hidden_size, cfg.patch_size, generator)


class AudioMAE(nn.Module):
    """Stage-1 parameters {encoder, decoder}; without a decoder config the
    decoder is left out (an encoder-only stage-1 file)."""

    def __init__(self, enc_cfg: AudioEncoderConfig, dec_cfg: Optional[AudioDecoderConfig],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = AudioEncoder(enc_cfg, generator)
        if dec_cfg is not None:
            self.decoder = AudioDecoder(dec_cfg, enc_cfg.hidden_size, generator)


def audiomae_init(enc_cfg: AudioEncoderConfig, dec_cfg: AudioDecoderConfig,
                  generator: torch.Generator) -> AudioMAE:
    """Random fp32 parameters drawn from `generator` (on the CPU)."""
    return AudioMAE(enc_cfg, dec_cfg, generator)


def _mlp(p: MLP, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dense → silu → Dense outside the kernels (JAX `_vit_block`:170-172,
    :190-194), the second Dense with `act_dense`'s recomputing backward.
    silu is h · sigmoid(h) in the compute dtype, as jax.nn.silu writes it;
    where XLA rounds inside it in bf16 is the backend's choice, so bf16
    agrees with JAX to a tolerance, not bit for bit."""
    return act_dense(p.w2, dense(p.w1, h, dtype), silu, dtype)


def vit_block(blk: ViTBlock, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
              dtype: torch.dtype, *, train: bool = False, dropout_rate: float = 0.0,
              drop_path_rate: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The unfused pre-LN block, x + DropPath(MHA(LN(x))), x + DropPath(MLP(LN(x)))
    (JAX `_vit_block`:180-203 with flash_mask set; reference mae.py:72-98)."""
    det = not train
    h = layer_norm(blk.ln1, x, LN_EPS)
    h = multi_head_attention(blk.attn, h, num_heads=num_heads, dtype=dtype, flash_mask=mask,
                             dropout_rate=0.0 if det else dropout_rate, generator=generator)
    h = dropout(generator, h, dropout_rate, det)
    x = x + drop_path(generator, h, drop_path_rate, det)
    h = layer_norm(blk.ln2, x, LN_EPS)
    if det or dropout_rate == 0.0:
        h = _mlp(blk.mlp, h, dtype)
    else:
        h = dropout(generator, silu(dense(blk.mlp.w1, h, dtype)), dropout_rate, det,
                    tp=tp_shard(blk.mlp.w1))
        h = dense(blk.mlp.w2, h, dtype)
    h = dropout(generator, h, dropout_rate, det)
    return x + drop_path(generator, h, drop_path_rate, det)


def encoder_layer(blk: ViTBlock, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                  route: str, dtype: torch.dtype) -> torch.Tensor:
    """One inference layer by the route `layer_route` chose."""
    if route == "k1":
        return ea.fused_layer(blk, x, mask, num_heads, LN_EPS)
    if route in ("k2", "k3"):
        variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK) if route == "k3" else ("one_shot",)
        y, ln2y = ea.fused_block_attention(blk, x, mask, num_heads, LN_EPS, variant)
        return y + _mlp(blk.mlp, ln2y, dtype)
    if route in ("einsum", "k4", "k5"):
        return vit_block(blk, x, mask, num_heads, dtype)
    if route == "k6":
        h = ea.fused_ln_attention(blk.ln1, blk.attn.qkv, x, mask, num_heads, LN_EPS)
        x = x + dense(blk.attn.o, h, dtype)
        return x + _mlp(blk.mlp, layer_norm(blk.ln2, x, LN_EPS), dtype)
    raise ValueError(f"unknown encoder layer route {route!r}")


class _TableRows(torch.autograd.Function):
    """`table.to(dtype)[inds]` (a cast and a gather commute, so these are
    the same bits) whose backward sums the table's gradient in fp32 and hands
    it straight to the table, past the cast: the gather's own backward would
    add a few rows' tens of thousands of duplicates one after another in
    `dtype`.  The sum is `kern.table_grad`: its kernel on the card, the
    plain fp32 sum on the CPU."""

    @staticmethod
    def forward(ctx, table, inds, dtype):
        ctx.save_for_backward(inds)
        ctx.n_rows = table.shape[0]
        return table.to(dtype)[inds]

    @staticmethod
    def backward(ctx, g):
        (inds,) = ctx.saved_tensors
        g, inds = g.reshape(-1, g.shape[-1]).contiguous(), inds.reshape(-1)
        return kern.table_grad(g, inds, ctx.n_rows), None, None


def table_rows(table: torch.Tensor, inds: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`table.to(dtype)[inds]`; where the table takes a gradient, through
    `_TableRows`, whose backward sums it in fp32."""
    inds = inds.long()
    if torch.is_grad_enabled() and table.requires_grad:
        return _TableRows.apply(table, inds, dtype)
    return table.to(dtype)[inds]


def _add_positions(x: torch.Tensor, freq_pos_embed: torch.Tensor, time_inds: torch.Tensor,
                   freq_inds: torch.Tensor) -> torch.Tensor:
    """x plus the sin-cos time and learned frequency embeddings, in x's dtype."""
    x = x + sincos_time_embedding(time_inds, x.shape[-1]).to(x.dtype)
    return x + table_rows(freq_pos_embed, freq_inds, x.dtype)


def audio_input_embedding(p: AudioEncoder, cfg: AudioEncoderConfig, patches: torch.Tensor,
                          time_inds: torch.Tensor, freq_inds: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """The first layer's input: the patch projection plus the sin-cos time
    and learned frequency embeddings, in `dtype`."""
    return _add_positions(dense(p.patch_proj, patches.to(dtype), dtype), p.freq_pos_embed,
                          time_inds, freq_inds)


def _run_blocks(blocks: nn.ModuleList, cfg, x: torch.Tensor, mask: torch.Tensor,
               dtype: torch.dtype, train: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """A layer stack by the encoder's rules (JAX `_run_blocks`): inference
    takes `layer_route`'s route for x's length and cfg's widths; training
    runs `vit_block` on every layer, its dropout masks from `generator`."""
    if not train and any(tp_shard(blk.attn.qkv) is not None for blk in blocks):
        raise ValueError("inference runs on whole parameters: gather_params first")
    route = None if train else ea.layer_route(x.shape[1], cfg.hidden_size,
                                              cfg.intermediate_size, dtype)[0]
    for blk in blocks:
        if train:
            x = vit_block(blk, x, mask, cfg.num_heads, dtype, train=True,
                          dropout_rate=cfg.dropout_rate, drop_path_rate=cfg.drop_path_rate,
                          generator=generator)
        else:
            x = encoder_layer(blk, x, mask, cfg.num_heads, route, dtype)
    return x


def audio_encoder_apply(p: AudioEncoder, cfg: AudioEncoderConfig,
                        patches: torch.Tensor,    # (B, S, patch_size)
                        time_inds: torch.Tensor,  # (B, S) int
                        freq_inds: torch.Tensor,  # (B, S) int
                        mask: torch.Tensor,       # (B, S) 1 = valid
                        *, dtype: torch.dtype = torch.float32, train: bool = False,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """→ hidden states (B, S, hidden) in `dtype`.  Reference: mae.py:111-139.
    Inference takes `layer_route`'s route per layer; training (`train=True`,
    dropout masks from `generator`) runs `vit_block` on every layer."""
    x = audio_input_embedding(p, cfg, patches, time_inds, freq_inds, dtype)
    x = _run_blocks(p.blocks, cfg, x, mask, dtype, train, generator)
    return layer_norm(p.ln_f, x, LN_EPS)


def audio_decoder_input(p: AudioDecoder, hidden: torch.Tensor, mask: torch.Tensor,
                        time_inds: torch.Tensor, freq_inds: torch.Tensor,
                        restore_time_inds: torch.Tensor, restore_freq_inds: torch.Tensor,
                        restore_mask: torch.Tensor, dtype: torch.dtype):
    """The decoder's first layer input and its mask: [in_proj(hidden) +
    positions, mask token + the restore set's positions] in `dtype`, under
    [mask, restore_mask]."""
    x = _add_positions(dense(p.in_proj, hidden.to(dtype), dtype), p.freq_pos_embed,
                       time_inds, freq_inds)
    xm = _add_positions(p.mask_token.to(x.dtype)[None, None, :], p.freq_pos_embed,
                        restore_time_inds, restore_freq_inds)
    return torch.cat([x, xm], dim=1), torch.cat([mask, restore_mask], dim=1)


def audio_decoder_apply(p: AudioDecoder, cfg: AudioDecoderConfig,
                        hidden: torch.Tensor,             # (B, S_vis, enc_hidden)
                        mask: torch.Tensor,               # (B, S_vis)
                        time_inds: torch.Tensor, freq_inds: torch.Tensor,
                        restore_time_inds: torch.Tensor,  # (B, S_masked)
                        restore_freq_inds: torch.Tensor,
                        restore_mask: torch.Tensor,
                        *, dtype: torch.dtype = torch.float32, train: bool = False,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """→ reconstructed patches (B, S_vis + S_masked, patch_size) in `dtype`.
    Reference: mae.py:148-188.  The layers' route is decided on the
    concatenated length, under the combined mask [mask, restore_mask]."""
    x, full_mask = audio_decoder_input(p, hidden, mask, time_inds, freq_inds, restore_time_inds,
                                       restore_freq_inds, restore_mask, dtype)
    x = _run_blocks(p.blocks, cfg, x, full_mask, dtype, train, generator)
    return dense(p.out_proj, layer_norm(p.ln_f, x, LN_EPS), dtype)


def audiomae_apply(p: AudioMAE, enc_cfg: AudioEncoderConfig, dec_cfg: AudioDecoderConfig,
                   patches: torch.Tensor, mask: torch.Tensor, time_inds: torch.Tensor,
                   freq_inds: torch.Tensor, restore_time_inds: torch.Tensor,
                   restore_freq_inds: torch.Tensor, restore_mask: torch.Tensor, *,
                   dtype: torch.dtype = torch.float32, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stage-1 reconstruction forward (reference mae.py:190-225): the encoder
    over the visible patches, then the decoder; in training both draw their
    dropout masks from `generator`, the encoder first."""
    h = audio_encoder_apply(p.encoder, enc_cfg, patches, time_inds, freq_inds, mask,
                            dtype=dtype, train=train, generator=generator)
    return audio_decoder_apply(p.decoder, dec_cfg, h, mask, time_inds, freq_inds,
                               restore_time_inds, restore_freq_inds, restore_mask,
                               dtype=dtype, train=train, generator=generator)
