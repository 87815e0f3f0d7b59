"""K1's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with nvcc and is marked `cuda`; on a
machine without one each skips.  The file imports neither JAX nor the JAX
package, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py configures JAX, hence --noconftest there).
Tolerances: fp32 5e-4 absolute (summation order through the layer), bf16
6e-2 absolute plus 3e-2 relative (bf16 roundings of values computed from
fp32 sums taken in another order, compounded over the layer's seven
stages); the same bounds chip_smoke.py states.
"""

import numpy as np
import pytest
import torch

from cacophony_tpu_torch.models.audio import ViTBlock
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea

TOL = {"float32": (5e-4, 5e-4), "bfloat16": (6e-2, 3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(d, inter, b, s, lengths, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    blk = ViTBlock(d, inter, gen)
    x = torch.randn(b, s, d, generator=gen).to(dtype)
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to(torch.int32)
    return blk, x, mask


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches(cuda):
    """A CPU tensor launches nothing; one CUDA layer launches LN ×2,
    GEMM ×4, attention ×1 and one K1 chain."""
    blk, x, mask = _layer(768, 3072, 2, 64, [64, 30], torch.bfloat16, 0)
    kern.reset_launches()
    ea.LAYER_LAUNCHES["k1_layer"] = 0
    with torch.inference_mode():
        ea.fused_layer(blk, x, mask, 8, 1e-6)
        assert all(v == 0 for v in kern.LAUNCHES.values())
        ea.fused_layer(blk.to(cuda), x.to(cuda), mask.to(cuda), 8, 1e-6)
        torch.cuda.synchronize()
    assert kern.LAUNCHES == {"layer_norm": 2, "gemm": 4, "attention": 1}
    assert ea.LAYER_LAUNCHES["k1_layer"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,lengths", [(3, 64, [64, 50, 0]), (2, 130, [130, 1])])
def test_chain_matches_plain(cuda, dtype, b, s, lengths):
    """Published width (Dh = 96); ragged tiles (s = 130 is not a multiple
    of any tile); an all-masked clip gives finite output."""
    td = getattr(torch, dtype)
    blk, x, mask = _layer(768, 3072, b, s, lengths, td, 1)
    with torch.inference_mode():
        plain = ea.fused_layer_plain(blk, x, mask, 8, 1e-6)
        got = ea.fused_layer(blk.to(cuda), x.to(cuda), mask.to(cuda), 8, 1e-6).cpu()
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    qkv = torch.randn(4, 64, 3 * 192, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(4, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        kern.attention(qkv, mask, 1)  # bf16 Dh = 192
    with pytest.raises(ValueError, match="mask"):
        kern.attention(qkv, mask.long(), 2)
    w = torch.randn(576, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        kern.gemm(qkv, w, torch.zeros(12, device=cuda), kern.EPI_BIAS)
    ones, zeros = torch.ones(576, device=cuda), torch.zeros(576, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        kern.layer_norm(qkv.half(), ones, zeros, 1e-6)
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        kern.layer_norm(qkv, ones.cpu(), zeros, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_clamp_and_masking_match_plain(cuda, dtype):
    """Logits far above the clamp of 80 (equal weights among the clamped
    keys, no inf/NaN), padded keys, and an all-masked clip that gives 0."""
    td = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(2)
    qkv = (8.0 * torch.randn(3, 100, 3 * 768, generator=gen)).to(td)
    mask = (torch.arange(100)[None, :] < torch.tensor([100, 37, 0])[:, None]).to(torch.int32)
    plain = kern.attention_plain(qkv, mask, 8)
    got = kern.attention(qkv.to(cuda), mask.to(cuda), 8).cpu()
    assert torch.isfinite(got).all() and (got[2] == 0).all()
    atol, rtol = {"float32": (5e-3, 1e-4), "bfloat16": (6e-2, 2e-2)}[dtype]
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=atol, rtol=rtol)
