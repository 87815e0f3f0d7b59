"""The CUDA kernels on the card (K1's chain, K2/K3's block chain, K3′'s
blocked layer, K6's LN1 → QKV → attention, K4, K5, K4's backward K7, K8's
log-mel and its bf16×3 form K8′), against their plain PyTorch versions,
and the fused routes' gradients on the card; the Hopper bf16 GEMM (every
epilogue, ragged M, N and K, the caco_base shapes, the double rounding of
EPI_BIAS_CAST_ADD, its silu against apply_epilogue over every fp32 input)
and the Hopper bf16 attention forward (Dh 96 and causal Dh 64 at S = 1 …
1536, the 80 clamp, an all-masked clip, K5's separate strides); the
register-tiled fp32 attention (Dh 16 … 128, S = 1 … 1536, causal and not),
the SIMT GEMM in fp32 and bf16 at ragged M, N, K (N, K not multiples of 8)
with every epilogue, the bf16 attention and K7 at head dims other than 64
and 96, and the caco_tiny bf16 engine (K1 at Dh 16) against the CPU engine;
the wgmma K7 (bf16, Dh 64 and 96, S = 1 … 579, causal and not, logits
above the clamp), heads past 128 columns (Dh 160 … 384: the attention
link, K4, K5, K7 and a K1 chain at Dh 256), and K5 at the clip length
against the padded call, bit for bit.

Every test here needs an NVIDIA GPU with nvcc and is marked `cuda`; on a
machine without one each skips.  The file imports neither JAX nor the JAX
package, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py configures JAX, hence --noconftest there).
Tolerances: fp32 5e-4 absolute (summation order through the layer), bf16
6e-2 absolute plus 3e-2 relative (bf16 roundings of values computed from
fp32 sums taken in another order, compounded over the layer's seven
stages); the same bounds chip_smoke.py states.  K8: 1e-4 absolute on the
log-mel (fp32 sums in another order; the log scales a mel error δ by
0.2/(mel + 1e-5)); K8′ the same against its plain version, and 2e-4
against K8 (JAX's bound on the bf16×3 DFT, tests/test_fused_frontend.py).
K4, K5: bf16 2e-2 + 1e-2·|x|, fp32 1e-4 + 1e-4·|x| (one
kernel: one bf16 rounding after fp32 sums in another order).  K7: bf16
3e-2 + 2e-2·|x| (P and dS are rounded to bf16 before their products, so a
rounding step of either moves a gradient by one more), fp32 1e-4 + 1e-4·|x|.
"""

import numpy as np
import pytest
import torch

from cacophony_tpu_torch.configs import FrontendConfig
from cacophony_tpu_torch.frontend import fused
from cacophony_tpu_torch.models.audio import ViTBlock
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea

TOL = {"float32": (5e-4, 5e-4), "bfloat16": (6e-2, 3e-2)}
TOL_K45 = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
TOL_K7 = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}


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
    assert kern.LAUNCHES == {"layer_norm": 2, "gemm": 4, "attention": 1, "k4": 0, "k5": 0,
                             "k7": 0, "log_mel": 0, "log_mel_fast": 0}
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
    """A mask that is not int32, a bias of the wrong width, a half tensor,
    mixed devices; a head dim of 192 (past 128) runs, forward and K7."""
    qkv = torch.randn(4, 64, 3 * 192, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(4, 64, dtype=torch.int32, device=cuda)
    g = qkv[..., :192].contiguous()
    _check(kern.attention(qkv, mask, 1), kern.attention_plain(qkv, mask, 1), TOL_K45["bfloat16"])
    _check(kern.attention_k4(qkv.float(), mask, 1), kern.attention_plain(qkv.float(), mask, 1),
           TOL_K45["float32"])
    _check(kern.attention_bwd(qkv, mask, g, 1), kern.attention_bwd_plain(qkv, mask, g, 1),
           TOL_K7["bfloat16"])
    with pytest.raises(ValueError, match="mask"):
        kern.attention(qkv, mask.long(), 2)
    w = torch.randn(576, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bias width"):
        kern.gemm(qkv, w, torch.zeros(13, device=cuda), kern.EPI_BIAS)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocked", [False, True])
def test_fused_block_matches_plain_at_1536(cuda, dtype, blocked):
    """K2 over S = 1536, and K3 over S = 1496 padded to 1536 inside (40
    padded keys): mixed lengths, short clips, a clip with no valid patch
    whose rows stay finite; one K2 / K3 count per call."""
    td = getattr(torch, dtype)
    s = 1496 if blocked else 1536
    blk, x, mask = _layer(768, 3072, 4, s, [s, 700, 37, 0], td, 3)
    for k in ea.LAYER_LAUNCHES:
        ea.LAYER_LAUNCHES[k] = 0
    variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK) if blocked else ("one_shot",)
    with torch.inference_mode():
        plain = ea.fused_block_attention_plain(blk, x, mask, 8, 1e-6, variant)
        got = ea.fused_block_attention(blk.to(cuda), x.to(cuda), mask.to(cuda), 8, 1e-6, variant)
        torch.cuda.synchronize()
    assert ea.LAYER_LAUNCHES == {"k1_layer": 0, "k3_layer": 0, "k2_block": int(not blocked),
                                 "k3_block": int(blocked), "k6_attn": 0}
    atol, rtol = TOL[dtype]
    for g, p in zip(got, plain):
        g = g.cpu()
        assert g.shape == (4, s, 768) and torch.isfinite(g).all()
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", [10, 30])
def test_log_mel_kernel_matches_plain(cuda, seconds):
    """1000 and 3000 frames: noise, a quiet clip (1e-4), a silent clip."""
    front = FrontendConfig()
    frames = seconds * 100
    gen = torch.Generator().manual_seed(4)
    bufs = 0.1 * torch.randn(3, seconds * 16_000, generator=gen)
    bufs[1] *= 1e-3
    bufs[2] = 0.0
    rows = fused.buffer_to_rows(bufs, frames, front)
    plain = fused.fused_log_mel_plain(rows, front, frames)
    kern.reset_launches()
    got = fused.fused_log_mel(rows.to(cuda), front, frames).cpu()
    assert kern.LAUNCHES["log_mel"] == 1
    assert got.shape == (3, frames, 128) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4)


def _qkv(b, s, d, lengths, dtype, seed, scale=1.5):
    gen = torch.Generator().manual_seed(seed)
    qkv = (scale * torch.randn(b, s, 3 * d, generator=gen)).to(dtype)
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to(torch.int32)
    return qkv, mask, gen


def _check(got, want, tol):
    got = got.cpu()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), want.float().cpu().numpy(), atol=tol[0], rtol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,heads,causal", [("bfloat16", 500, 8, False),
                                                  ("float32", 500, 8, False),
                                                  ("bfloat16", 100, 12, True),
                                                  ("float32", 100, 12, True)])
def test_k4_matches_plain(cuda, dtype, s, heads, causal):
    """The audio shape (H = 8, Dh = 96, S = 500) and the causal text shape
    (H = 12, Dh = 64, S = 100); padded keys and an all-masked clip (0)."""
    td = getattr(torch, dtype)
    qkv, mask, _ = _qkv(3, s, 768, [s, s // 3, 0], td, 5)
    kern.reset_launches()
    got = kern.attention_k4(qkv.to(cuda), mask.to(cuda), heads, causal)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k4"] == 1 and kern.LAUNCHES["attention"] == 0
    _check(got, kern.attention_plain(qkv, mask, heads, causal), TOL_K45[dtype])
    assert (got[2] == 0).all()


@pytest.mark.cuda
def test_k5_matches_plain_over_the_padded_row(cuda):
    """S = 1500 padded to 1536 inside (bf16 at caco_base width); the padded
    query rows are sliced away."""
    s = 1500
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(2, s, 768, generator=gen).bfloat16()
    kv = torch.randn(2, s, 1536, generator=gen).bfloat16()
    mask = (torch.arange(s)[None, :] < torch.tensor([s, 400])[:, None]).to(torch.int32)
    kern.reset_launches()
    got = ea.encoder_attention_blocked(q.to(cuda), kv.to(cuda), mask.to(cuda), 8)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k5"] == 1 and got.shape == (2, s, 768)
    _check(got, ea.encoder_attention_blocked_plain(q, kv, mask, 8), TOL_K45["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,heads,causal", [("bfloat16", 500, 8, False),
                                                  ("bfloat16", 100, 12, True),
                                                  ("float32", 100, 8, False),
                                                  ("float32", 100, 12, True)])
def test_k7_matches_plain(cuda, dtype, s, heads, causal):
    """d qkv for a random output gradient; the all-masked clip's gradients
    are finite and exactly 0."""
    td = getattr(torch, dtype)
    qkv, mask, gen = _qkv(3, s, 768, [s, s // 3, 0], td, 7)
    g = torch.randn(3, s, 768, generator=gen).to(td)
    kern.reset_launches()
    got = kern.attention_bwd(qkv.to(cuda), mask.to(cuda), g.to(cuda), heads, causal)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k7"] == 1
    _check(got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), TOL_K7[dtype])
    assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k4_backward_is_k7_only_where_jax_runs_it(cuda, dtype):
    """At S = 500 the bf16 backward is K7 and the fp32 one autograd of the
    plain `xla_attention` (`bwd_fits_vmem` is false), as in JAX."""
    td = getattr(torch, dtype)
    qkv, mask, gen = _qkv(2, 500, 768, [500, 120], td, 8)
    x = qkv.to(cuda).requires_grad_()
    kern.reset_launches()
    ea.encoder_attention(x, mask.to(cuda), 8).sum().backward()
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k4"] == 1
    assert kern.LAUNCHES["k7"] == (1 if dtype == "bfloat16" else 0)
    assert torch.isfinite(x.grad).all()


def _reset_layer_launches():
    kern.reset_launches()
    for k in ea.LAYER_LAUNCHES:
        ea.LAYER_LAUNCHES[k] = 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_matches_plain(cuda, dtype):
    """K6 at the published width, S = 496: LN1 → QKV → attention, one K6
    count (LN ×1, GEMM ×1, attention ×1); the all-masked clip gives 0."""
    td = getattr(torch, dtype)
    blk, x, mask = _layer(768, 3072, 3, 496, [496, 123, 0], td, 9)
    _reset_layer_launches()
    with torch.inference_mode():
        plain = ea.fused_ln_attention_plain(blk.ln1, blk.attn.qkv, x, mask, 8, 1e-6)
        blk = blk.to(cuda)
        got = ea.fused_ln_attention(blk.ln1, blk.attn.qkv, x.to(cuda), mask.to(cuda), 8, 1e-6)
        torch.cuda.synchronize()
    assert ea.LAYER_LAUNCHES["k6_attn"] == 1
    assert (kern.LAUNCHES["layer_norm"], kern.LAUNCHES["gemm"], kern.LAUNCHES["attention"]) == (1, 1, 1)
    assert (got[2] == 0).all()
    _check(got, plain, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_prime_matches_plain_at_1536(cuda, dtype):
    """K3′: the whole layer over S = 1496 padded to 1536 inside; one
    k3_layer count and no k1_layer."""
    td = getattr(torch, dtype)
    blk, x, mask = _layer(768, 3072, 3, 1496, [1496, 700, 0], td, 10)
    variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK)
    _reset_layer_launches()
    with torch.inference_mode():
        plain = ea.fused_layer_plain(blk, x, mask, 8, 1e-6, variant)
        got = ea.fused_layer(blk.to(cuda), x.to(cuda), mask.to(cuda), 8, 1e-6, variant)
        torch.cuda.synchronize()
    assert ea.LAYER_LAUNCHES["k3_layer"] == 1 and ea.LAYER_LAUNCHES["k1_layer"] == 0
    assert got.shape == (3, 1496, 768)
    _check(got, plain, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", [10, 30])
def test_log_mel_fast_kernel_matches_plain(cuda, seconds):
    """K8′ at 1000 and 3000 frames: noise, a quiet clip, a silent clip;
    against its plain version and within JAX's 2e-4 of exact K8."""
    front = FrontendConfig()
    frames = seconds * 100
    gen = torch.Generator().manual_seed(11)
    bufs = 0.1 * torch.randn(3, seconds * 16_000, generator=gen)
    bufs[1] *= 1e-3
    bufs[2] = 0.0
    rows = fused.buffer_to_rows(bufs, frames, front)
    plain = fused.fused_log_mel_plain(rows, front, frames, fast_dft=True)
    kern.reset_launches()
    got = fused.fused_log_mel(rows.to(cuda), front, frames, fast_dft=True)
    exact = fused.fused_log_mel(rows.to(cuda), front, frames)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["log_mel_fast"] == 1 and kern.LAUNCHES["log_mel"] == 1
    assert got.shape == (3, frames, 128)
    _check(got, plain, (1e-4, 0.0))
    _check(got, exact.cpu(), (2e-4, 0.0))


@pytest.mark.cuda
def test_fused_routes_take_gradients_on_the_card(cuda):
    """The repair: K1, K3′, K2, K3 and K6 on CUDA tensors whose parameters
    need gradients give outputs with a grad_fn, and backward fills every
    parameter of the route (fp32, against the same backward on the CPU)."""
    blk, x, mask = _layer(768, 3072, 2, 300, [300, 0], torch.float32, 12)
    blk_c = ViTBlock(768, 3072).to(cuda)
    blk_c.load_state_dict(blk.state_dict())
    routes = {
        "k1": lambda b, xx, m: ea.fused_layer(b, xx, m, 8, 1e-6),
        "k3_prime": lambda b, xx, m: ea.fused_layer(b, xx, m, 8, 1e-6, ("blocked", 256)),
        "k2": lambda b, xx, m: sum(ea.fused_block_attention(b, xx, m, 8, 1e-6, ("one_shot",))),
        "k3": lambda b, xx, m: sum(ea.fused_block_attention(b, xx, m, 8, 1e-6, ("blocked", 256))),
        "k6": lambda b, xx, m: ea.fused_ln_attention(b.ln1, b.attn.qkv, xx, m, 8, 1e-6),
    }
    w = torch.randn(300, 768, generator=torch.Generator().manual_seed(13))
    for name, fn in routes.items():
        grads = []
        for b, dev in ((blk, "cpu"), (blk_c, cuda)):
            b.zero_grad(set_to_none=True)
            xx = x.detach().to(dev).requires_grad_()
            out = fn(b, xx, mask.to(dev))
            assert out.grad_fn is not None, name
            (out * w.to(dev)).sum().backward()
            used = [p for p in b.parameters() if p.grad is not None]
            assert used and all(torch.isfinite(p.grad).all() for p in used), name
            if name in ("k1", "k3_prime"):  # a whole layer: every block parameter
                assert len(used) == len(list(b.parameters())), name
            grads.append(torch.cat([xx.grad.flatten()] + [p.grad.flatten() for p in used]).cpu())
        assert grads[0].shape == grads[1].shape, name
        rel = float((grads[1] - grads[0]).norm() / grads[0].norm())
        assert rel <= 1e-4, (name, rel)


# ---- the Hopper bf16 GEMM (wgmma, TMA ring, ping-pong warpgroups) --------

def _gemm_inputs(m, n, k, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=gen).bfloat16()
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).bfloat16()
    bias = torch.randn(n, generator=gen)
    r = torch.randn(m, n, generator=gen).bfloat16()
    return a, w, bias, r


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [kern.EPI_BIAS, kern.EPI_BIAS_RESID_F32, kern.EPI_BIAS_SILU,
                                      kern.EPI_BIAS_CAST_ADD])
@pytest.mark.parametrize("m,n,k", [(300, 2304, 768),   # M not a multiple of the 128-row tile
                                   (100, 104, 168),    # M < 128, N = 8·13, K = 8·21
                                   (1, 8, 8),
                                   (4000, 768, 3072)])  # several tiles per block
def test_bf16_gemm_matches_plain(cuda, epilogue, m, n, k):
    a, w, bias, r = _gemm_inputs(m, n, k, 20)
    got = kern.gemm(a.to(cuda), w.to(cuda), bias.to(cuda), epilogue, r.to(cuda))
    torch.cuda.synchronize()
    _check(got, kern.gemm_plain(a, w, bias, epilogue, r), TOL_K45["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,epilogue", [(32 * 496, 2304, 768, kern.EPI_BIAS),
                                            (32 * 496, 768, 768, kern.EPI_BIAS_RESID_F32),
                                            (32 * 496, 3072, 768, kern.EPI_BIAS_SILU),
                                            (32 * 496, 768, 3072, kern.EPI_BIAS_CAST_ADD),
                                            (32 * 1536, 2304, 768, kern.EPI_BIAS),
                                            (32 * 1536, 768, 768, kern.EPI_BIAS_RESID_F32)])
def test_bf16_gemm_at_caco_base_shapes(cuda, m, n, k, epilogue):
    """The four products of a 10-s layer and the 30-s QKV and o-proj."""
    a, w, bias, r = (t.to(cuda) for t in _gemm_inputs(m, n, k, 21))
    got = kern.gemm(a, w, bias, epilogue, r)
    want = kern.gemm_plain(a, w, bias, epilogue, r)
    atol, rtol = TOL_K45["bfloat16"]
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all() and bool((err <= atol + rtol * want.float().abs()).all())


@pytest.mark.cuda
def test_bf16_gemm_cast_add_rounds_twice(cuda):
    """EPI_BIAS_CAST_ADD rounds acc + b to bf16 before adding the residual:
    h = 1 + 2^-8 + 2^-10 rounds to 1 + 2^-7, plus r = -2^-7 gives exactly 1,
    where one rounding of h + r would give 1 - 2^-8."""
    m, n, k = 130, 136, 8
    a = torch.zeros(m, k)
    a[:, 0] = 1.0
    w = torch.zeros(k, n)
    w[0] = 1.0
    bias = torch.full((n,), 2.0 ** -8 + 2.0 ** -10)
    r = torch.full((m, n), -(2.0 ** -7)).bfloat16()
    got = kern.gemm(a.bfloat16().to(cuda), w.bfloat16().to(cuda), bias.to(cuda),
                    kern.EPI_BIAS_CAST_ADD, r.to(cuda)).cpu()
    assert (got == 1.0).all()
    assert (kern.gemm_plain(a.bfloat16(), w.bfloat16(), bias, kern.EPI_BIAS_CAST_ADD, r) == 1.0).all()
    assert float(torch.tensor(1 + 2.0 ** -8 + 2.0 ** -10 - 2.0 ** -7).bfloat16()) == 1 - 2.0 ** -8


@pytest.mark.cuda
def test_bf16_gemm_silu_epilogue_is_apply_epilogue(cuda):
    """The branch-free silu of the bf16 GEMM against apply_epilogue's
    division over every fp32 input: no result differs in any bit."""
    assert kern.silu_epilogue_mismatches(cuda) == 0


# ---- the Hopper bf16 attention forward (wgmma, TMA K/V ring) --------------

@pytest.mark.cuda
@pytest.mark.parametrize("hd,heads,causal", [(96, 8, False), (64, 12, True)])
@pytest.mark.parametrize("s", [1, 63, 496, 500, 1536])
def test_bf16_attention_matches_plain(cuda, hd, heads, causal, s):
    """Ragged tiles (S = 1, 63, 500), the chains' S = 496 and 1536, padded
    keys, and an all-masked clip that gives exactly 0."""
    qkv, mask, _ = _qkv(3, s, heads * hd, [s, max(s // 3, 1), 0], torch.bfloat16, 22)
    got = kern.attention_k4(qkv.to(cuda), mask.to(cuda), heads, causal)
    torch.cuda.synchronize()
    _check(got, kern.attention_plain(qkv, mask, heads, causal), TOL_K45["bfloat16"])
    assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hd,heads,causal", [(96, 8, False), (64, 12, True)])
@pytest.mark.parametrize("s", [500, 1536])
def test_bf16_attention_clamp_matches_plain(cuda, hd, heads, causal, s):
    """Logits far above the clamp of 80 in most rows, and far below it.
    Rows whose every attended logit lies below -70 are compared apart:
    there p·v·2^-24 falls below fp32's normal range, which the tensor cores
    flush (the output is 0 or finite), while the plain version on the CPU
    keeps subnormals."""
    qkv, mask, _ = _qkv(2, s, heads * hd, [s, s // 2], torch.bfloat16, 23, scale=8.0)
    got = kern.attention_k4(qkv.to(cuda), mask.to(cuda), heads, causal).cpu()
    want = kern.attention_plain(qkv, mask, heads, causal)
    q, k, _ = (kern.split_heads(t, heads).float() for t in qkv.chunk(3, dim=-1))
    qs = (q * kern.q_scale(hd, torch.bfloat16)).bfloat16().float()
    top = torch.minimum(qs @ k.transpose(-1, -2), kern._kbias(mask, s, causal)).amax(dim=-1)
    normal = kern.merge_heads((top > -70.0)[..., None].expand(-1, -1, -1, hd))
    assert torch.isfinite(got).all() and normal.float().mean() > 0.99
    assert bool((top >= 80.0).float().mean() > 0.3)
    atol, rtol = 6e-2, 2e-2
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs())[normal].all())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [63, 500, 1536])
def test_k5_separate_strides_match_plain(cuda, s):
    """K5's operands: Q (B, S, D) and K|V (B, S, 2D), rows D and 2D apart."""
    gen = torch.Generator().manual_seed(24)
    q = (1.5 * torch.randn(3, s, 768, generator=gen)).bfloat16()
    kv = (1.5 * torch.randn(3, s, 1536, generator=gen)).bfloat16()
    mask = (torch.arange(s)[None, :] < torch.tensor([s, s // 3, 0])[:, None]).to(torch.int32)
    kern.reset_launches()
    got = kern.attention_k5(q.to(cuda), kv.to(cuda), mask.to(cuda), 8)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k5"] == 1
    _check(got, kern.attention_split_plain(q, kv, mask, 8), TOL_K45["bfloat16"])
    assert (got[2] == 0).all()


# ---- any head dim up to 128, the fp32 attention and the SIMT GEMM ----------

@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd,heads", [(16, 4), (64, 4), (96, 8), (128, 3)])
@pytest.mark.parametrize("s", [1, 63, 496, 1536])
def test_fp32_attention_matches_plain(cuda, hd, heads, s, causal):
    """The register-tiled fp32 kernel: ragged query and key tiles (S = 1,
    63), the chains' S = 496 and 1536, padded keys, an all-masked clip that
    gives exactly 0; held to the plain version on the card (TF32 off)."""
    qkv, mask, _ = _qkv(3, s, heads * hd, [s, max(s // 3, 1), 0], torch.float32, 30)
    qkv, mask = qkv.to(cuda), mask.to(cuda)
    kern.reset_launches()
    got = kern.attention_k4(qkv, mask, heads, causal)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k4"] == 1
    _check(got, kern.attention_plain(qkv, mask, heads, causal), TOL_K45["float32"])
    assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads", [(16, 2), (20, 3), (32, 4), (48, 2), (128, 6)])
def test_attention_at_any_head_dim_matches_plain(cuda, dtype, hd, heads):
    """Head dims the wgmma kernel does not take (bf16 goes through the
    mma.sync kernel; Dh 20 with 3 heads: rows not 16-byte aligned, read
    element by element), the chain link, K4 causal and K5's strides."""
    td = getattr(torch, dtype)
    d = heads * hd
    qkv, mask, _ = _qkv(3, 300, d, [300, 77, 0], td, 31)
    qkv, mask = qkv.to(cuda), mask.to(cuda)
    tol = TOL_K45[dtype]
    got = kern.attention(qkv, mask, heads)
    _check(got, kern.attention_plain(qkv, mask, heads), tol)
    assert (got[2] == 0).all()
    _check(kern.attention_k4(qkv, mask, heads, True), kern.attention_plain(qkv, mask, heads, True), tol)
    q, kv = qkv[..., :d].contiguous(), qkv[..., d:].contiguous()
    _check(kern.attention_k5(q, kv, mask, heads), kern.attention_split_plain(q, kv, mask, heads), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads,causal", [(16, 2, False), (20, 3, True), (32, 4, False),
                                             (128, 2, True), (128, 6, False)])
def test_k7_at_any_head_dim_matches_plain(cuda, dtype, hd, heads, causal):
    """K7 at head dims other than 64 and 96 (fp32 Dh 128 needs more than 48
    KB of shared memory); the all-masked clip's gradients are exactly 0."""
    td = getattr(torch, dtype)
    qkv, mask, gen = _qkv(3, 100, heads * hd, [100, 33, 0], td, 32)
    g = torch.randn(3, 100, heads * hd, generator=gen).to(td)
    got = kern.attention_bwd(qkv.to(cuda), mask.to(cuda), g.to(cuda), heads, causal)
    torch.cuda.synchronize()
    _check(got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), TOL_K7[dtype])
    assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [kern.EPI_BIAS, kern.EPI_BIAS_RESID_F32, kern.EPI_BIAS_SILU,
                                      kern.EPI_BIAS_CAST_ADD])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [(300, 2300, 764),  # N, K not multiples of 8
                                   (1, 1, 1),
                                   (130, 7, 13),
                                   (257, 768, 768),     # N a multiple of 4: fp32 16-byte loads
                                   (4000, 2304, 768)])
def test_gemm_at_ragged_shapes_matches_plain(cuda, epilogue, dtype, m, n, k):
    """The SIMT GEMM (fp32, and bf16 where TMA cannot describe the
    operands) and, for bf16 shapes TMA can describe, the wgmma kernel."""
    td = getattr(torch, dtype)
    a, w, bias, r = (t.to(cuda) for t in _gemm_inputs(m, n, k, 33))
    a, w, r = a.to(td), w.to(td), r.to(td)
    got = kern.gemm(a, w, bias, epilogue, r)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    _check(got, kern.gemm_plain(a, w, bias, epilogue, r), TOL_K45[dtype])


@pytest.mark.cuda
def test_tiny_bf16_engine_on_the_card_matches_the_cpu(cuda):
    """CacoEngine at caco_tiny width in bf16 on the card: every audio layer
    is K1 (Dh 16); the embeddings agree with the CPU engine's (cosine
    >= 0.999, the bf16-vs-fp32 bound)."""
    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.models.caco import caco_init
    from cacophony_tpu_torch.runtime import CacoEngine

    cfg = configs.caco_tiny()
    rs = np.random.RandomState(34)
    wavs = [(0.1 * rs.randn(int(sec * 16000))).astype(np.float32) for sec in (10, 3.5, 0.2, 7, 12)]
    out = {}
    for device in ("cpu", "cuda"):
        model = caco_init(cfg, torch.Generator().manual_seed(0))
        engine = CacoEngine(cfg, model, device=device, batch_size=4, dtype=torch.bfloat16)
        _reset_layer_launches()
        out[device] = engine.embed_audio(wavs)
        if device == "cuda":
            assert ea.LAYER_LAUNCHES["k1_layer"] == cfg.audio.num_layers * 2
    a, b = out["cuda"], out["cpu"]
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    assert a.shape == (5, cfg.projection_size) and np.isfinite(a).all()
    assert cos.min() >= 0.999, cos


# ---- the wgmma K7, heads past 128 columns, K5 without its padding ----------

@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd,heads", [(64, 12), (96, 8)])
@pytest.mark.parametrize("s", [1, 63, 128, 500, 579])
def test_k7_wgmma_matches_plain(cuda, hd, heads, s, causal):
    """The redesigned bf16 K7 (pre-pass, main pass with dQ by fp32 atomics,
    conversion: three launches, one k7 count) at ragged lengths up to
    `bwd_fits_vmem`'s bf16 limit (579), padded keys, and an all-masked clip
    whose gradients are exactly 0."""
    qkv, mask, gen = _qkv(3, s, heads * hd, [s, max(s // 3, 1), 0], torch.bfloat16, 40)
    g = torch.randn(3, s, heads * hd, generator=gen).bfloat16()
    kern.reset_launches()
    got = kern.attention_bwd(qkv.to(cuda), mask.to(cuda), g.to(cuda), heads, causal)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k7"] == 1
    _check(got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), TOL_K7["bfloat16"])
    assert (got[2] == 0).all()


def clamp_qkv(b, s, heads, hd, gen):
    """Fused QKV whose logits reach far past the clamp of 80 while every
    element stays moderate: Q and K share the direction of all-ones in each
    head (30 along it), K with a per-key weight in [-1, 1.2], so q·k/sqrt(Dh)
    runs from about -110 to +130 (Dh 64) and every row clamps many keys.
    (Scaling all of q, k, v by 8 instead puts one bf16 step of dS times
    |q| ≈ 30 past K7's bound: a test of the inputs, not the kernel.)"""
    d = heads * hd
    x = 1.5 * torch.randn(b, s, 3 * d, generator=gen)
    along = 30.0 / hd ** 0.5
    x[..., :d] += along
    x[..., d:2 * d] += along * (2.2 * torch.rand(b, s, 1, generator=gen) - 1.0)
    return x.bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("hd,heads", [(64, 12), (96, 8)])
def test_k7_wgmma_clamp_matches_plain(cuda, hd, heads):
    """Logits far above the clamp of 80 (many keys share p = 1 / count) and
    far below it, in every row."""
    gen = torch.Generator().manual_seed(41)
    qkv = clamp_qkv(2, 500, heads, hd, gen)
    mask = (torch.arange(500)[None, :] < torch.tensor([500, 250])[:, None]).to(torch.int32)
    g = torch.randn(2, 500, heads * hd, generator=gen).bfloat16()
    q, k, _ = (kern.split_heads(t, heads).float() for t in qkv.chunk(3, dim=-1))
    top = torch.minimum((q * kern.q_scale(hd, torch.bfloat16)).bfloat16().float() @ k.transpose(-1, -2),
                        kern._kbias(mask, 500, False)).amax(dim=-1)
    assert bool((top >= 80.0).all())
    got = kern.attention_bwd(qkv.to(cuda), mask.to(cuda), g.to(cuda), heads)
    _check(got, kern.attention_bwd_plain(qkv, mask, g, heads), TOL_K7["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads", [(160, 2), (192, 4), (256, 3), (384, 2)])
def test_wide_heads_match_plain(cuda, dtype, hd, heads):
    """Heads past 128 columns, run in pieces of 128: the chain link, K4
    causal, K5's strides and K7 (causal and not); the all-masked clip
    gives exactly 0."""
    td = getattr(torch, dtype)
    d = heads * hd
    qkv, mask, gen = _qkv(3, 200, d, [200, 77, 0], td, 42)
    g = torch.randn(3, 200, d, generator=gen).to(td)
    qkv, mask, g = qkv.to(cuda), mask.to(cuda), g.to(cuda)
    got = kern.attention(qkv, mask, heads)
    _check(got, kern.attention_plain(qkv, mask, heads), TOL_K45[dtype])
    assert (got[2] == 0).all()
    _check(kern.attention_k4(qkv, mask, heads, True), kern.attention_plain(qkv, mask, heads, True),
           TOL_K45[dtype])
    q, kv = qkv[..., :d].contiguous(), qkv[..., d:].contiguous()
    _check(kern.attention_k5(q, kv, mask, heads), kern.attention_split_plain(q, kv, mask, heads),
           TOL_K45[dtype])
    for causal in (False, True):
        got = kern.attention_bwd(qkv, mask, g, heads, causal)
        _check(got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), TOL_K7[dtype])
        assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_chain_at_a_wide_head_matches_plain(cuda, dtype):
    """`fused_layer` at width 768 with 3 heads of Dh 256."""
    td = getattr(torch, dtype)
    blk, x, mask = _layer(768, 3072, 3, 130, [130, 41, 0], td, 43)
    with torch.inference_mode():
        plain = ea.fused_layer_plain(blk, x, mask, 3, 1e-6)
        got = ea.fused_layer(blk.to(cuda), x.to(cuda), mask.to(cuda), 3, 1e-6)
    _check(got, plain, TOL[dtype])


@pytest.mark.cuda
def test_k5_at_the_clip_length_equals_the_padded_call(cuda):
    """`encoder_attention_blocked` at S = 1500 runs K5 at 1500 with no
    padding copy; its output equals the kernel over Q, K|V and the mask
    padded to 1536 (the key tiles, their order and the skipped tiles are
    the same), bit for bit."""
    gen = torch.Generator().manual_seed(44)
    s = 1500
    q = (1.5 * torch.randn(3, s, 768, generator=gen)).bfloat16().to(cuda)
    kv = (1.5 * torch.randn(3, s, 1536, generator=gen)).bfloat16().to(cuda)
    mask = (torch.arange(s)[None, :] < torch.tensor([s, 1000, 0])[:, None]).to(cuda, torch.int32)
    kern.reset_launches()
    got = ea.encoder_attention_blocked(q, kv, mask, 8)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k5"] == 1
    pad = 1536 - s
    padded = kern.attention_k5(torch.nn.functional.pad(q, (0, 0, 0, pad)),
                               torch.nn.functional.pad(kv, (0, 0, 0, pad)),
                               torch.nn.functional.pad(mask, (0, pad)), 8)[:, :s]
    assert torch.equal(got, padded)
