"""Host-side logic of the GEMM and attention kernels, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
here: the contracts their wrappers check before a launch (shapes, row
strides, head dims).  The GEMM takes any M, N, K and the attention any
head dim up to 128, at any alignment: the C entry points pick the TMA
kernels where the operands allow and the SIMT / mma.sync kernels
elsewhere.
"""

import pytest
import torch

from cacophony_tpu_torch.ops import _kernels as kern

torch.set_num_threads(2)


def _views(b=2, s=5, heads=8, hd=96, dtype=torch.bfloat16):
    qkv = torch.zeros(b, s, 3 * heads * hd, dtype=dtype)
    mask = torch.ones(b, s, dtype=torch.int32)
    return qkv, mask


def test_gemm_operands_contract():
    a = torch.zeros(3, 7, 768, dtype=torch.bfloat16)
    w = torch.zeros(768, 2304, dtype=torch.bfloat16)
    bias = torch.zeros(2304)
    assert kern.gemm_operands(a, w, bias, kern.EPI_BIAS) == (21, 2304, 768)
    r = torch.zeros(21, 2304, dtype=torch.bfloat16)
    assert kern.gemm_operands(a, w, bias, kern.EPI_BIAS_CAST_ADD, r) == (21, 2304, 768)
    with pytest.raises(ValueError, match="residual"):
        kern.gemm_operands(a, w, bias, kern.EPI_BIAS_RESID_F32)
    # K and N that are not multiples of 8 (the SIMT kernel takes them)
    assert kern.gemm_operands(a[..., :764].contiguous(), w[:764], bias, kern.EPI_BIAS) == (21, 2304, 764)
    assert kern.gemm_operands(a, w[:, :2300].contiguous(), bias[:2300], kern.EPI_BIAS) == (21, 2300, 768)
    with pytest.raises(ValueError, match="epilogue"):
        kern.gemm_operands(a, w, bias, 7)
    with pytest.raises(ValueError, match="bias width"):
        kern.gemm_operands(a, w, bias[:-1], kern.EPI_BIAS)
    # a view starting 2 bytes into its storage: not a TMA operand, taken by the SIMT kernel
    flat = torch.zeros(21 * 768 + 8, dtype=torch.bfloat16)
    assert kern.gemm_operands(flat[1:1 + 21 * 768].view(21, 768), w, bias, kern.EPI_BIAS) == (21, 2304, 768)


@pytest.mark.parametrize("hd,heads", [(96, 8), (64, 12), (16, 2), (32, 4), (20, 3)])
def test_attention_operands_contract(hd, heads):
    """Dh 20 with 3 heads: k and v start 120 bytes after q, not on a
    16-byte boundary (read element by element).  Half the heads widens
    the head: 128 (and 60) is taken, 192 raises."""
    qkv, mask = _views(heads=heads, hd=hd)
    d = heads * hd
    q, k, v = qkv.chunk(3, dim=-1)
    assert kern.attention_operands(q, k, v, 3 * d, 3 * d, mask, heads) == (2, 5, d, hd)
    qs, kv = qkv[..., :d].contiguous(), qkv[..., d:].contiguous()  # K5's operands
    k5, v5 = kv.chunk(2, dim=-1)
    assert kern.attention_operands(qs, k5, v5, d, 2 * d, mask, heads) == (2, 5, d, hd)
    with pytest.raises(ValueError, match="row strides"):
        kern.attention_operands(q, k, v, d, 3 * d, mask, heads)
    with pytest.raises(ValueError, match="mask"):
        kern.attention_operands(q, k, v, 3 * d, 3 * d, mask.long(), heads)
    wide = d // (heads // 2)
    if wide <= kern.MAX_HEAD_DIM:
        assert kern.attention_operands(q, k, v, 3 * d, 3 * d, mask, heads // 2) == (2, 5, d, wide)
    else:
        with pytest.raises(ValueError, match=f"head dim {wide}"):
            kern.attention_operands(q, k, v, 3 * d, 3 * d, mask, heads // 2)
