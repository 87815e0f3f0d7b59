"""Analytic matmul-FLOP counts of the serving pipeline and the stage-2
training step, and the devices' bf16 peaks (cacophony_tpu/utils/flops.py).

MFU (model FLOPs utilization) = counted matmul FLOPs ÷ wall time ÷ the
device's peak.  Only matmul FLOPs are counted (softmax, LayerNorm and GELU
are elementwise work that MFU by convention leaves out), so the number is
comparable to published MFU figures.  The counters take the port's configs
and give the JAX package's integers.

Hot loop accounted: the wav→embedding pipeline (reference
src/caco/caco_eval_utils.py:12-24 frontend + src/caco/audio_models/mae.py:
107-139 encoder + src/caco/caco.py:19-96 pooler / projection).
"""

from __future__ import annotations

from typing import Optional

from cacophony_tpu_torch.configs import (
    AudioEncoderConfig,
    CacoConfig,
    FrontendConfig,
    PatchConfig,
    TextConfig,
)

# Dense bf16 matmul peak per device, FLOP/s, keyed by lowercased substrings
# of the device's name, the more specific keys first.  NVIDIA's figures for
# the H100 (dense, no sparsity): SXM 989 TFLOP/s, PCIe 756, NVL 835;
# `torch.cuda.get_device_name()` gives e.g. "NVIDIA H100 80GB HBM3" (SXM).
# The TPU rows are the JAX package's (jax `Device.device_kind`), kept so
# the function answers as JAX's does for those names.
BF16_PEAK_FLOPS = {
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
    "h100": 989e12,
    "v6e": 918e12,
    "v6": 918e12,
    "v5p": 459e12,
    "v5e": 197e12,
    "v5 lite": 197e12,
    "v5litepod": 197e12,
    "v4": 275e12,
    "v3": 123e12,
    "v2": 46e12,
}


def device_peak_flops(device_name: str) -> Optional[float]:
    """bf16 peak FLOP/s for a device name (`torch.cuda.get_device_name()`,
    or a jax device_kind), or None if unknown."""
    name = device_name.lower()
    for key, peak in BF16_PEAK_FLOPS.items():
        if key in name:
            return peak
    return None


def frontend_matmul_flops(front: FrontendConfig, num_samples: int) -> int:
    """Windowed-DFT (re+im) + mel projection matmul FLOPs for one clip."""
    frames = -(-num_samples // front.hop_length)
    nbins = front.num_spectrogram_bins
    dft = 2 * frames * front.window_length * nbins * 2  # re and im
    mel = 2 * frames * nbins * front.num_mels
    return dft + mel


def encoder_matmul_flops(cfg: AudioEncoderConfig, seq: int) -> int:
    """ViT encoder matmul FLOPs for one sequence of length `seq`."""
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    per_layer = (
        2 * seq * h * (3 * h)      # fused QKV projection
        + 2 * seq * seq * h        # Q @ K^T (all heads)
        + 2 * seq * seq * h        # attn @ V
        + 2 * seq * h * h          # output projection
        + 2 * seq * h * ffn        # MLP up
        + 2 * seq * ffn * h        # MLP down
    )
    return cfg.num_layers * per_layer + 2 * seq * cfg.patch_size * h  # + patch proj


def pooler_matmul_flops(cfg: CacoConfig, seq: int) -> int:
    """Single-query attention pooler + output projection."""
    h = cfg.audio.hidden_size
    proj = cfg.projection_size or h
    return (
        2 * seq * h * (2 * h)  # fused KV projection
        + 2 * seq * h          # q · K scores (1 query, all heads)
        + 2 * seq * h          # weights @ V
        + 2 * h * proj         # output Dense
    )


def text_matmul_flops(cfg: TextConfig, seq: int, memory_seq: int = 0) -> int:
    """Text-tower matmul FLOPs for one sequence of length `seq`.

    memory_seq > 0 adds the cross-attention sub-block each layer carries in
    decoder configs (q proj + per-layer memory K/V proj + two S×S_mem
    attention matmuls + o proj)."""
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    per_layer = (
        2 * seq * h * (3 * h)      # self-attn QKV
        + 2 * seq * seq * h        # Q @ K^T
        + 2 * seq * seq * h        # attn @ V
        + 2 * seq * h * h          # o proj
        + 2 * seq * h * ffn        # MLP up
        + 2 * seq * ffn * h        # MLP down
    )
    if memory_seq:
        per_layer += (
            2 * seq * h * h                 # cross q proj
            + 2 * memory_seq * h * (2 * h)  # cross K/V proj
            + 2 * seq * memory_seq * h      # q @ K_mem^T
            + 2 * seq * memory_seq * h      # attn @ V_mem
            + 2 * seq * h * h               # cross o proj
        )
    return cfg.num_layers * per_layer


def text_pooler_matmul_flops(cfg: CacoConfig, seq: int) -> int:
    h = cfg.text.hidden_size
    proj = cfg.projection_size or h
    return 2 * seq * h * (2 * h) + 2 * seq * h + 2 * seq * h + 2 * h * proj


def caco_train_step_matmul_flops(
    cfg: CacoConfig, audio_seq: int, text_seq: int, remat_encoder: bool = False
) -> int:
    """Counted matmul FLOPs for ONE sample through the stage-2 train step
    (fwd + bwd; optimizer elementwise work and the B×B contrastive logits
    are excluded by MFU convention).

    Backward of a matmul is two matmuls (dX and dW / the two attention
    VJPs), so train = 3× forward; remat adds one more encoder forward.
    The caption branch reuses the contrastive text tower's hiddens
    (train/train.py loss_fn), so the text encoder is counted ONCE.
    """
    audio_fwd = (
        encoder_matmul_flops(cfg.audio, audio_seq)
        + pooler_matmul_flops(cfg, audio_seq)
    )
    text_fwd = text_matmul_flops(cfg.text, text_seq) + text_pooler_matmul_flops(
        cfg, text_seq
    )
    dec_seq = text_seq - 1  # teacher forcing drops the last position
    dec_fwd = (
        text_matmul_flops(cfg.decoder, dec_seq, memory_seq=audio_seq)
        + 2 * dec_seq * cfg.decoder.hidden_size * cfg.decoder.vocab_size
    )
    total = 3 * (audio_fwd + text_fwd + dec_fwd)
    if remat_encoder:
        total += encoder_matmul_flops(cfg.audio, audio_seq)
    return total


def pipeline_matmul_flops(
    cfg: CacoConfig, front: FrontendConfig, patch: PatchConfig, num_samples: int
) -> int:
    """Total matmul FLOPs for ONE clip through wav→patches→encoder→embedding."""
    seq = patch.patches_seq_len
    return (
        frontend_matmul_flops(front, num_samples)
        + encoder_matmul_flops(cfg.audio, seq)
        + pooler_matmul_flops(cfg, seq)
    )
