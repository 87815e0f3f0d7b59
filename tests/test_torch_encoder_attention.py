"""K1 in the port — the plain PyTorch versions of the whole-layer kernel and
of its attention — against the JAX package's Pallas kernels, run in
interpret mode on the CPU as tests/test_encoder_attention.py runs them.

JAX kernels reached: `try_fused_layer` → K1 `_fused_block_kernel` with
with_mlp=True (one-shot plan at these shapes); `encoder_attention` → K4
`_kernel`, whose softmax numerics (q scaled in the compute dtype, clamp at
80, 2^-24 V pre-scale, deferred normalization) are the ones K1 uses.
Inputs come from numpy with a fixed seed and go to both packages.

Tolerances: fp32 5e-5 absolute (the summation order of the products);
bf16 3e-2 absolute (one bf16 rounding step apart at |x| ≲ 4 after seven
rounded stages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu.ops import encoder_attention as jea
from cacophony_tpu_torch.models.audio import ViTBlock
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as tea

torch.set_num_threads(2)

D, H, B, S = 64, 4, 3, 48
LENGTHS = [48, 40, 0]  # clip 2: every key masked (an engine padding clip)
TOL = {"float32": 5e-5, "bfloat16": 3e-2}


def _block_params(rs, d, inter):
    """A JAX block tree and the same values in the port's ViTBlock."""
    def dense(din, dout):
        return {"w": (rs.randn(din, dout) / np.sqrt(din)).astype(np.float32),
                "b": (0.1 * rs.randn(dout)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rs.randn(d)).astype(np.float32),
                "bias": (0.1 * rs.randn(d)).astype(np.float32)}

    tree = {"ln1": ln(), "attn": {"qkv": dense(d, 3 * d), "o": dense(d, d)}, "ln2": ln(),
            "mlp": {"w1": dense(d, inter), "w2": dense(inter, d)}}
    blk = ViTBlock(d, inter)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            leaf = tree
            for k in name.split("."):
                leaf = leaf[k]
            p.copy_(torch.from_numpy(leaf))
    return tree, blk


def _mask(lengths, s):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_matches_pallas_k1(dtype):
    rs = np.random.RandomState(0)
    tree, blk = _block_params(rs, D, 4 * D)
    x = rs.randn(B, S, D).astype(np.float32)
    mask = _mask(LENGTHS, S)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jea.try_fused_layer(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                              jnp.asarray(mask), H, 1e-6, jd)
    assert ref is not None  # the JAX dispatch took K1
    with torch.no_grad():
        got = tea.fused_layer(blk, torch.from_numpy(x).to(td), torch.from_numpy(mask), H, 1e-6)
    assert got.dtype == td and torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref).astype(np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_kernel(dtype):
    rs = np.random.RandomState(1)
    qkv = (1.5 * rs.randn(B, S, 3 * D)).astype(np.float32)
    mask = _mask(LENGTHS, S)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jea.encoder_attention(jnp.asarray(qkv, jd), jnp.asarray(mask), H, True)
    got = kern.attention_plain(torch.from_numpy(qkv).to(td), torch.from_numpy(mask), H)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref).astype(np.float32),
                               atol=TOL[dtype])
    # the all-masked clip attends to nothing: exactly 0, never NaN
    assert (got[2] == 0).all()


def test_attention_clamp_keeps_huge_logits_finite():
    """Logits far above the clamp of 80 stay finite (equal weights among
    the clamped keys) — the max-free softmax's documented behaviour."""
    qkv = np.zeros((1, 8, 3 * 16), np.float32)
    qkv[0, :, :16] = 40.0   # q
    qkv[0, :, 16:32] = 40.0  # k: logits 40·40·16/4 ≫ 80
    qkv[0, :, 32:] = np.arange(8, dtype=np.float32)[:, None]  # v
    out = kern.attention_plain(torch.from_numpy(qkv), torch.ones(1, 8, dtype=torch.int32), 1)
    np.testing.assert_allclose(out.numpy(), np.full((1, 8, 16), 3.5, np.float32), rtol=1e-6)


def test_gemm_plain_epilogues():
    rs = np.random.RandomState(2)
    a = torch.from_numpy(rs.randn(5, 16).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rs.randn(16, 8).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rs.randn(8).astype(np.float32))
    r = torch.from_numpy(rs.randn(5, 8).astype(np.float32)).bfloat16()
    h = a.double() @ w.double() + bias.double()
    cases = {
        kern.EPI_BIAS: h,
        kern.EPI_BIAS_RESID_F32: h + r.double(),
        kern.EPI_BIAS_SILU: h * torch.sigmoid(h),
        kern.EPI_BIAS_CAST_ADD: h.bfloat16().double() + r.double(),
    }
    for epi, want in cases.items():
        got = kern.gemm_plain(a, w, bias, epi, r)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.double().numpy(), want.bfloat16().double().numpy(),
                                   rtol=2 ** -7, atol=1e-6, err_msg=str(epi))


def test_dispatch_rejects_other_devices_and_mixed_inputs():
    blk = ViTBlock(32, 64)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tea.fused_layer(blk, torch.empty(1, 4, 32, device="meta"),
                        torch.ones(1, 4, dtype=torch.int32), 2, 1e-6)
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        kern.layer_norm(torch.empty(2, 8, device="meta"), torch.ones(8), torch.zeros(8), 1e-6)
