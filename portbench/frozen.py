"""Frozen arithmetic of the benchmark: the matmul-FLOP counters, the H100
peaks and the least-time bound.  Copied from the port's
`utils/flops.py` and `chip_smoke.py` (`bound`, `attn_flops`, `PEAK`,
`HBM_BYTES_PER_S`) so that later changes to the port cannot move the
yardstick; the stage-1 step counter is new.  The counters take plain dicts
of sizes (a configuration file's groups), not the port's dataclasses."""

from __future__ import annotations

from typing import Optional

# Dense bf16 peak FLOP/s by lowercased substrings of the device's name, the
# more specific keys first (NVIDIA's figures, no sparsity).
BF16_PEAK_FLOPS = {"h100 pcie": 756e12, "h100 nvl": 835e12, "h100": 989e12}
# One H100 SXM: fp32 outside the tensor cores, and HBM3's rate.
PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def device_peak_flops(device_name: str) -> Optional[float]:
    """bf16 peak FLOP/s for `torch.cuda.get_device_name()`, None if unknown."""
    name = device_name.lower()
    return next((peak for key, peak in BF16_PEAK_FLOPS.items() if key in name), None)


def least_seconds(flops: float, nbytes: float, kind: str) -> float:
    """The least time of one product: the larger of its operations over the
    peak of their type and its bytes (each input read once, each output
    written once) over the memory rate."""
    return max(flops / PEAK[kind], nbytes / HBM_BYTES_PER_S)


def attn_flops(heads: int, hd: int, queries: int, keys: int, products: int = 2) -> int:
    """2·Dh flops per (query, key) pair for each of `products` S×S products
    (Q·Kᵀ and P·V forward; five in the backward), per head."""
    return products * 2 * heads * hd * queries * keys


def frontend_matmul_flops(front: dict, num_samples: int) -> int:
    """Windowed-DFT (re+im) + mel projection matmul FLOPs for one clip."""
    frames = -(-num_samples // front["hop_length"])
    nbins = front["fft_size"] // 2 + 1
    return 2 * frames * front["window_length"] * nbins * 2 + 2 * frames * nbins * front["num_mels"]


def encoder_matmul_flops(enc: dict, seq: int) -> int:
    """ViT encoder matmul FLOPs for one sequence of length `seq` (patch
    projection included)."""
    h, ffn = enc["hidden_size"], enc["intermediate_size"]
    per_layer = (2 * seq * h * 3 * h + 2 * seq * seq * h + 2 * seq * seq * h
                 + 2 * seq * h * h + 2 * seq * h * ffn + 2 * seq * ffn * h)
    return enc["num_layers"] * per_layer + 2 * seq * enc["patch_size"] * h


def vit_stack_matmul_flops(blocks: dict, seq: int) -> int:
    """A ViT layer stack alone (no projection in or out)."""
    return encoder_matmul_flops(dict(blocks, patch_size=0), seq)


def pooler_matmul_flops(cfg: dict, seq: int) -> int:
    """Single-query attention pooler + output projection."""
    h = cfg["audio"]["hidden_size"]
    proj = cfg["projection_size"] or h
    return 2 * seq * h * 2 * h + 2 * seq * h + 2 * seq * h + 2 * h * proj


def text_matmul_flops(text: dict, seq: int, memory_seq: int = 0) -> int:
    """Text-tower matmul FLOPs for one sequence; memory_seq > 0 adds the
    decoder's cross-attention sub-block."""
    h, ffn = text["hidden_size"], text["intermediate_size"]
    per_layer = (2 * seq * h * 3 * h + 4 * seq * seq * h + 2 * seq * h * h
                 + 4 * seq * h * ffn)
    if memory_seq:
        per_layer += (2 * seq * h * h + 2 * memory_seq * h * 2 * h + 4 * seq * memory_seq * h
                      + 2 * seq * h * h)
    return text["num_layers"] * per_layer


def text_pooler_matmul_flops(cfg: dict, seq: int) -> int:
    h = cfg["text"]["hidden_size"]
    proj = cfg["projection_size"] or h
    return 2 * seq * h * 2 * h + 4 * seq * h + 2 * h * proj


def pipeline_matmul_flops(cfg: dict, front: dict, seq: int, num_samples: int) -> int:
    """Matmul FLOPs for ONE clip through wav → patches → encoder → embedding."""
    return (frontend_matmul_flops(front, num_samples) + encoder_matmul_flops(cfg["audio"], seq)
            + pooler_matmul_flops(cfg, seq))


def caco_train_step_matmul_flops(cfg: dict, audio_seq: int, text_seq: int) -> int:
    """Counted matmul FLOPs for ONE sample through the stage-2 step (forward
    and backward = 3 × forward; the text tower counted once)."""
    audio_fwd = encoder_matmul_flops(cfg["audio"], audio_seq) + pooler_matmul_flops(cfg, audio_seq)
    text_fwd = text_matmul_flops(cfg["text"], text_seq) + text_pooler_matmul_flops(cfg, text_seq)
    dec, dec_seq = cfg["decoder"], text_seq - 1
    dec_fwd = (text_matmul_flops(dec, dec_seq, memory_seq=audio_seq)
               + 2 * dec_seq * dec["hidden_size"] * dec["vocab_size"])
    return 3 * (audio_fwd + text_fwd + dec_fwd)


def mae_train_step_matmul_flops(cfg: dict, seq: int, mask_ratio: float) -> int:
    """Counted matmul FLOPs for ONE sample through the stage-1 step: 3 × the
    forward of the encoder over the visible patches, the decoder's
    in-projection of them, its layers over all `seq` and its out-projection."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    keep = max(1, int(round(seq * (1.0 - mask_ratio))))
    fwd = (encoder_matmul_flops(enc, keep)
           + 2 * keep * enc["hidden_size"] * dec["hidden_size"]
           + vit_stack_matmul_flops(dec, seq)
           + 2 * seq * dec["hidden_size"] * dec["patch_size"])
    return 3 * fwd
