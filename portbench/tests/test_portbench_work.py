"""The roofline counts against hand counts, and the kernel-name classes."""

import pytest

from portbench import frozen, work
from tiny_cells import _config

CACO = _config("caco_base")


def test_valid_patches_and_frames():
    front = CACO["frontend"]
    assert work.valid_frames(160_000, front) == 1000
    assert work.valid_patches(160_000, front, 1 << 30) == 496
    assert work.valid_patches(16_000, front, 1 << 30) == 48  # 100 frames: 6 time patches × 8
    assert work.valid_patches(160_000, front, 300) == 300


def test_attention_by_hand():
    """One clip of 496 valid patches, one layer at 768 wide in 8 heads:
    Q·Kᵀ and P·V are 2 · 2 · 496² · 768 flops; Q, K, V and O 4 · 496 · 768
    bf16 values.  The backward: five products; eight tensors."""
    f, b = 4 * 496 ** 2 * 768, 4 * 496 * 768 * 2
    assert work.attention_least_s(768, 8, [496]) == max(f / 989e12, b / 3.35e12)
    f5, b5 = 10 * 496 ** 2 * 768, 8 * 496 * 768 * 2
    assert work.attention_least_s(768, 8, [496], 5) == max(f5 / 989e12, b5 / 3.35e12)
    assert work.embed_attention_least_s(CACO, [160_000, 16_000], 1 << 30) == pytest.approx(
        12 * (work.attention_least_s(768, 8, [496]) + work.attention_least_s(768, 8, [48])))


def test_embed_gemms_by_hand():
    """One bucket of one 10-s clip: the frontend's two fp32 products over
    1000 frames, then the bf16 products over 496 patches."""
    m, d, ffn = 496, 768, 3072

    def t(mm, k, n, kind, item):
        return frozen.least_seconds(2 * mm * k * n, (mm * k + mm * n) * item + k * n * item, kind)

    hand = (t(1000, 400, 514, "fp32", 4) + t(1000, 257, 128, "fp32", 4) + t(m, 256, d, "bf16", 2)
            + 12 * (t(m, d, 3 * d, "bf16", 2) + t(m, d, d, "bf16", 2) + t(m, d, ffn, "bf16", 2)
                    + t(m, ffn, d, "bf16", 2))
            + t(m, d, 2 * d, "bf16", 2) + t(1, d, 768, "bf16", 2))
    assert work.embed_gemm_least_s(CACO, [160_000], 32, 1 << 30) == pytest.approx(hand, rel=1e-12)


def test_stage2_attention_by_hand():
    """The stage-2 step: the audio tower alone, forward and backward."""
    dec = [work.attention_least_s(768, 8, [496], k) for k in (2, 5)]
    assert work.caco_attention_least_s(CACO, [160_000], 500) == pytest.approx(12 * sum(dec))


def test_stage1_attention_by_hand():
    """The stage-1 step: the encoder over 100 visible patches, the decoder
    over the clip's valid ones (496 of a 10-s clip, 144 of a 3-s clip),
    forward and backward, 12 layers each."""
    mae = _config("audiomae_base")

    def both(v):
        return sum(work.attention_least_s(768, 8, [v], k) for k in (2, 5))

    assert work.mae_attention_least_s(mae, [160_000, 48_000], 500) == pytest.approx(
        12 * (2 * both(100) + both(496) + both(144)))


@pytest.mark.parametrize("name,attention,gemm", [
    ("void k1::attention_bf16_wgmma_kernel<96>(CUtensorMap_st, int const*)", True, False),
    ("void k1::attn_bwd_main_wgmma<96>(CUtensorMap_st)", True, False),
    ("void k1::dq_to_bf16(float const*, __nv_bfloat16*, int)", True, False),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<96>>", True, False),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", True, False),
    ("void k1::gemm_bf16_wgmma_kernel<2>(CUtensorMap_st, CUtensorMap_st)", False, True),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_cublas", False, True),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", False, True),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_nn_align8>",
     False, True),
    ("void k1::layer_norm_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", False, False),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda>",
     False, False),
    ("Memcpy HtoD (Pinned -> Device)", False, False),
])
def test_kernel_classes(name, attention, gemm):
    assert work.is_attention(name) is attention
    assert work.is_gemm(name) is gemm
