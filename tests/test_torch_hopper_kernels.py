"""Host-side logic of the Hopper bf16 GEMM and attention kernels, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
here: the contracts their wrappers check before a launch (shapes, row
strides, 16-byte alignment of the base pointers that TMA and the 16-byte
epilogue accesses need).
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
    with pytest.raises(ValueError, match="multiples of 8"):
        kern.gemm_operands(a[..., :764].contiguous(), w[:764], bias, kern.EPI_BIAS)
    with pytest.raises(ValueError, match="multiples of 8"):
        kern.gemm_operands(a, w[:, :2300].contiguous(), bias[:2300], kern.EPI_BIAS)
    with pytest.raises(ValueError, match="epilogue"):
        kern.gemm_operands(a, w, bias, 7)
    # a view starting 2 bytes into its storage: TMA needs 16-byte aligned bases
    flat = torch.zeros(21 * 768 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        kern.gemm_operands(flat[1:1 + 21 * 768].view(21, 768), w, bias, kern.EPI_BIAS)


@pytest.mark.parametrize("hd,heads", [(96, 8), (64, 12)])
def test_attention_operands_contract(hd, heads):
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
    with pytest.raises(ValueError, match="head dim"):
        kern.attention_operands(q, k, v, 3 * d, 3 * d, mask, heads // 2)
