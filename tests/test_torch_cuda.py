"""The CUDA kernels on the card (K1's chain, K2/K3's block chain, K3′'s
blocked layer, K6's LN1 → QKV → attention, K4, K5, K4's backward K7, K8's
log-mel and its bf16×3 form K8′, and the frequency table's gradient
`table_grad`), against their plain PyTorch versions,
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
above the clamp, and its flush of p below 2^-126 to 0 where the CPU
keeps subnormals), heads past 128 columns (Dh 160 … 384: the attention
link, K4, K5, K7 and a K1 chain at Dh 256), K5 at the clip length
against the padded call, bit for bit, and K8 at 1 … 3000 frames with a
silent clip and a DC plus Nyquist clip, at the default frontend and at
mel_fmax = 7600; `load_caco` of a caco_tiny file onto the card serving
through K1, and two steps of `train.runner.main` at caco_tiny in bf16 (K4
and K7 launch counts); the stage-1 AudioMAE at audiomae_base widths with
one layer a tower (the reconstruction forward's routes against the CPU,
one loss and backward's K4 / K7 counts, fp32 against the CPU),
`load_audiomae` onto the card and two steps of `runner --stage mae`;
greedy fp32 decode at caco_tiny on the card (the step as a CUDA graph and
eager) against the CPU token for token, the engine's text tower as a
CUDA graph per shape against the eager tower bit for bit, gallery search
on the card against the CPU; the HEAR embedders' forward at published audio width
(one layer, 500 patches, K2) against the CPU with the padded rows, and
one HEAR probe step on the card against the CPU.

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
                             "k7": 0, "log_mel": 0, "log_mel_fast": 0, "table_grad": 0}
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


def _log_mel_clips(frames, seed):
    """(4, frames·160) buffers: noise, a silent clip, a DC offset plus a
    Nyquist tone over noise, 0.1 each (most of its energy in bins 0 and
    256, which K8 skips), and a quiet clip (1e-4).  A louder tone over less
    noise leaves bins whose sums cancel, where two fp32 orders of one sum
    differ by more than 1e-4 in the log-mel."""
    gen = torch.Generator().manual_seed(seed)
    n = frames * 160
    bufs = 0.1 * torch.randn(4, n, generator=gen)
    bufs[1] = 0.0
    bufs[2] += 0.1 + 0.1 * (1 - 2 * (torch.arange(n) % 2))
    bufs[3] *= 1e-3
    return bufs


@pytest.mark.cuda
@pytest.mark.parametrize("fmax", [None, 7600.0])
@pytest.mark.parametrize("frames", [1, 63, 64, 65, 1000, 3000])
def test_log_mel_kernel_at_frame_edges(cuda, frames, fmax):
    """K8 over one block's edge (63, 64, 65 frames), a single frame and the
    10-s and 30-s lengths, at the default frontend (bins 1–255) and at
    mel_fmax = 7600 (bins 1–243); and K8′ against it under chip_smoke.py's
    rule: within JAX's 2e-4 wherever the plain bf16×3 DFT is, elsewhere no
    farther than the plain version plus 1e-4 (the DC plus Nyquist clip's
    leakage bins nearly cancel, and there bf16×3 itself is farther)."""
    front = FrontendConfig(mel_fmax=fmax)
    rows = fused.buffer_to_rows(_log_mel_clips(frames, 13), frames, front)
    plain = fused.fused_log_mel_plain(rows, front, frames)
    kern.reset_launches()
    got = fused.fused_log_mel(rows.to(cuda), front, frames)
    fast = fused.fused_log_mel(rows.to(cuda), front, frames, fast_dft=True)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["log_mel"] == 1 and kern.LAUNCHES["log_mel_fast"] == 1
    assert got.shape == (4, frames, 128)
    _check(got, plain, (1e-4, 0.0))
    got, fast = got.cpu(), fast.cpu()
    err_plain = (fused.fused_log_mel_plain(rows, front, frames, fast_dft=True) - got).abs()
    assert ((fast - got).abs() <= torch.clamp(err_plain + 1e-4, min=2e-4)).all()
    assert (got[1] == got[1, 0, 0]).all()  # silence: log(offset) everywhere


@pytest.mark.cuda
@pytest.mark.parametrize("fft_size,hop", [(1024, 160), (512, 128)])
def test_log_mel_kernels_other_frontends(cuda, fft_size, hop):
    """Frontends no configuration uses but the Pallas kernel takes: 513
    bins (two passes of 256, the sums carried in the output between them)
    and a hop of 128 (the kernels' runtime-hop instantiation); K8 and K8′
    against their plain versions."""
    front = FrontendConfig(fft_size=fft_size, hop_length=hop)
    frames = 150
    gen = torch.Generator().manual_seed(14)
    bufs = 0.1 * torch.randn(3, frames * hop, generator=gen)
    bufs[1] = 0.0
    rows = fused.buffer_to_rows(bufs, frames, front)
    for fast in (False, True):
        got = fused.fused_log_mel(rows.to(cuda), front, frames, fast_dft=fast)
        assert got.shape == (3, frames, 128)
        _check(got, fused.fused_log_mel_plain(rows, front, frames, fast_dft=fast), (1e-4, 0.0))


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
def test_k7_flushes_p_below_the_normal_range(cuda):
    """The bf16 K7 at Dh 96 takes its exponentials with ex2.approx.ftz: where
    every logit of a query row lies below ≈ -87, p = e^logit is below 2^-126
    and flushes to 0, so that row's gradients are exactly 0 on the card,
    while the plain version on the CPU keeps the subnormal p (its row sum
    floored at 1e-37) and gives small nonzero gradients.  Clip 0's q and k
    share a direction with opposite signs (every logit ≈ -100); clip 1 is
    ordinary and matches the plain version within K7's bound."""
    s, heads, hd = 64, 8, 96
    qkv, mask, gen = _qkv(2, s, heads * hd, [s, s], torch.bfloat16, 31)
    c = (100.0 / kern.q_scale(hd, torch.bfloat16)) ** 0.5 / hd ** 0.5  # |q|·|k|·scale = 100
    qkv[0, :, :heads * hd] = c
    qkv[0, :, heads * hd:2 * heads * hd] = -c
    g = torch.randn(2, s, heads * hd, generator=gen).to(torch.bfloat16)
    q, k = (kern.split_heads(t, heads).float() for t in qkv[:1, :, :2 * heads * hd].chunk(2, -1))
    logits = (q * kern.q_scale(hd, torch.bfloat16)).bfloat16().float() @ k.transpose(-1, -2)
    assert float(logits.max()) < -87.0
    got = kern.attention_bwd(qkv.to(cuda), mask.to(cuda), g.to(cuda), heads).cpu()
    want = kern.attention_bwd_plain(qkv, mask, g, heads)
    assert (got[0] == 0).all() and float(want[0].float().abs().max()) > 0.0
    _check(got[1], want[1], TOL_K7["bfloat16"])


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


def _table_grad_inputs(b, s, width, dtype, seed):
    """Time-major patches over 8 frequency rows with each clip's padding at
    index 0, and an upstream gradient with a component common to every
    patch (CPU)."""
    gen = torch.Generator().manual_seed(seed)
    inds = (torch.arange(s) % 8).repeat(b, 1)
    lengths = torch.randint(s // 4, s + 1, (b,), generator=gen)
    inds[torch.arange(s)[None, :] >= lengths[:, None]] = 0
    g = (torch.randn(b * s, width, generator=gen) + 0.5).to(dtype)
    return g, inds.reshape(-1)


def _rel_fp64(got, g, inds, n_rows=8):
    ref = torch.zeros(n_rows, g.shape[-1], dtype=torch.float64).index_add_(0, inds.long(),
                                                                         g.double())
    return float((got.cpu().double() - ref).norm() / ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width", [768, 512])
@pytest.mark.parametrize("index_dtype", ["int64", "int32"])
def test_table_grad_matches_plain(cuda, dtype, width, index_dtype):
    """The frequency table's gradient at caco_base's 128 × 500 patches into
    8 rows (width 768) and at the MAE decoder's width 512: fp32, within fp32
    rounding of the fp64 sum and of the plain version, and the same bits on
    a second call."""
    g, inds = _table_grad_inputs(128, 500, width, getattr(torch, dtype), 40)
    gc, ic = g.to(cuda), inds.to(cuda, getattr(torch, index_dtype))
    got = kern.table_grad(gc, ic, 8)
    plain = kern.table_grad_plain(gc, ic, 8)
    assert got.dtype == torch.float32 and got.shape == (8, width)
    assert _rel_fp64(got, g, inds) <= 1e-5
    assert float((got - plain).norm() / plain.norm()) <= 2e-5
    assert torch.equal(got, kern.table_grad(gc, ic, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("n,width,offset", [(0, 768, 0), (1, 768, 0), (5, 768, 0),
                                            (3001, 100, 0), (3001, 768, 1)])
def test_table_grad_edges(cuda, n, width, offset):
    """Fewer rows than a thread keeps in flight, no row at all, a width the
    16-byte loads do not divide, and a base 2 bytes off 16-byte alignment
    (the element-by-element path), in bf16."""
    gen = torch.Generator().manual_seed(41)
    flat = torch.randn(n * width + offset, generator=gen).to(torch.bfloat16)
    g = flat[offset:].view(n, width)
    inds = torch.randint(0, 8, (n,), generator=gen)
    got = kern.table_grad(flat.to(cuda)[offset:].view(n, width), inds.to(cuda), 8)
    ref = kern.table_grad_plain(g, inds, 8)
    assert got.shape == (8, width)
    assert torch.allclose(got.cpu(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_table_grad_refuses_a_large_table(cuda):
    g = torch.randn(100, 768, device=cuda)
    inds = torch.zeros(100, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        kern.table_grad(g, inds, 17)  # 17 × 768 fp32 values past 48 KB
    with pytest.raises(ValueError):
        kern.table_grad(g.half(), inds, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_frequency_table_backward_is_one_table_grad(cuda, dtype):
    """A backward through the positions gather launches the kernel once and
    hands the fp32 table its fp32 sum."""
    from cacophony_tpu_torch.models import audio

    td = getattr(torch, dtype)
    g, inds = _table_grad_inputs(128, 500, 768, td, 42)
    gc, ic = g.view(128, 500, 768).to(cuda), inds.view(128, 500).to(cuda)
    table = torch.randn(8, 768, device=cuda, requires_grad=True)
    kern.reset_launches()
    audio.table_rows(table, ic, td).backward(gc)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["table_grad"] == 1
    assert table.grad.dtype == torch.float32 and _rel_fp64(table.grad, g, inds) <= 1e-5


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


# ---- checkpoints in, trained checkpoints out --------------------------------

@pytest.mark.cuda
def test_load_caco_on_the_card_serves_through_k1(cuda, tmp_path):
    """A caco_tiny released-layout file written by the port loads with
    `load_caco` onto the card (its default device); the bf16 engine on it
    runs every audio layer on K1 and agrees with the CPU engine on the same
    file (cosine >= 0.999, the bf16-vs-fp32 bound)."""
    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.checkpoints import bridge, convert, io, msgpack
    from cacophony_tpu_torch.models.caco import caco_init
    from cacophony_tpu_torch.runtime import CacoEngine

    cfg = configs.caco_tiny()
    model = caco_init(cfg, torch.Generator().manual_seed(5))
    ref = convert.caco_params_to_reference(bridge.params_to_jax(model), cfg.audio.num_heads)
    msgpack.save_checkpoint(str(tmp_path), {"0": {"params": ref}}, step=0)
    loaded_cfg, loaded = io.load_caco(str(tmp_path), cfg, strict_counts=False)
    assert next(loaded.parameters()).device.type == "cuda"
    for name, t in loaded.state_dict().items():
        assert torch.equal(t.cpu(), model.state_dict()[name]), name
    rs = np.random.RandomState(35)
    wavs = [(0.1 * rs.randn(int(sec * 16000))).astype(np.float32) for sec in (10, 3.5, 7)]
    _reset_layer_launches()
    got = CacoEngine(loaded_cfg, loaded, batch_size=4, dtype=torch.bfloat16).embed_audio(wavs)
    assert ea.LAYER_LAUNCHES["k1_layer"] == cfg.audio.num_layers
    _, cpu_model = io.load_caco(str(tmp_path), cfg, strict_counts=False, device="cpu")
    ref_emb = CacoEngine(cfg, cpu_model, device="cpu", batch_size=4,
                         dtype=torch.bfloat16).embed_audio(wavs)
    cos = (got * ref_emb).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref_emb, axis=-1)
    assert np.isfinite(got).all() and cos.min() >= 0.999, cos


@pytest.mark.cuda
def test_runner_two_steps_on_the_card(cuda, tmp_path):
    """`train.runner.main` at caco_tiny in bf16 on the card from audio files:
    2 steps, K4 and K7 once per audio layer per step, every file decoded
    natively, finite logged losses, the train state saved."""
    import csv
    import json
    import os

    from scipy.io import wavfile

    from cacophony_tpu_torch.data import pipeline
    from cacophony_tpu_torch.data.tokenizer import _bytes_to_unicode
    from cacophony_tpu_torch.train import runner

    data, tok = tmp_path / "data", tmp_path / "tok"
    data.mkdir()
    tok.mkdir()
    rows = [["file_name", "caption"]]
    for i in range(8):
        sr = (16000, 44100, 48000)[i % 3]
        x = (0.1 * np.random.RandomState(i).randn(int(sr * 0.7))).astype(np.float32)
        wavfile.write(str(data / f"c{i}.wav"), sr, x if i % 3 == 2 else (x * 32767).astype(np.int16))
        rows.append([f"c{i}.wav", f"sound {i}"])
    with open(data / "captions.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in _bytes_to_unicode().values():
        vocab[c] = len(vocab)
    (tok / "vocab.json").write_text(json.dumps(vocab))
    (tok / "merges.txt").write_text("#version: 0.2\n")
    work = str(tmp_path / "work")
    kern.reset_launches()
    for k in pipeline.DECODE_COUNTS:
        pipeline.DECODE_COUNTS[k] = 0
    state = runner.main(["--stage", "caco", "--data-dir", str(data), "--workdir", work,
                         "--tokenizer", str(tok), "--steps", "2", "--batch-size", "4",
                         "--buffer-seconds", "1", "--patches-seq-len", "32", "--tiny-model",
                         "--dtype", "bfloat16", "--checkpoint-every", "0", "--log-every", "1"])
    torch.cuda.synchronize()
    layers = 2  # caco_tiny's audio layers
    assert kern.LAUNCHES["k4"] == 2 * layers and kern.LAUNCHES["k7"] == 2 * layers
    assert pipeline.DECODE_COUNTS == {"native": 8, "fallback": 0}
    assert state.step == 2 and next(state.params.parameters()).device.type == "cuda"
    losses = [json.loads(line)["loss"] for line in open(os.path.join(work, "metrics.jsonl"))]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.listdir(os.path.join(work, "checkpoints")) == ["step_00000002"]


def _mae_one_layer(seed):
    """audiomae_base's widths (768-d, 8 heads, MLP 3072) with one encoder
    and one decoder layer, random weights from `seed`."""
    import dataclasses

    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.models.audio import audiomae_init

    base = configs.audiomae_base()
    cfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, num_layers=1),
                              decoder=dataclasses.replace(base.decoder, num_layers=1))
    return cfg, audiomae_init(cfg.encoder, cfg.decoder, torch.Generator().manual_seed(seed))


def _mae_grid(b, s, lengths, seed):
    """A masked 500-patch grid (mask ratio 0.8) with a clip shorter than a
    fifth of it, on the CPU."""
    from cacophony_tpu_torch.train import train

    rs = np.random.RandomState(seed)
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None] * mask
    patches = (rs.randn(b, s, 256) * mask[..., None]).astype(np.float32)
    batch = {"audio_patches": torch.from_numpy(patches),
             "audio_time_inds": torch.from_numpy(inds // 8),
             "audio_freq_inds": torch.from_numpy(inds % 8),
             "audio_mask": torch.from_numpy(mask)}
    noise = train.mae_noise(torch.Generator().manual_seed(seed), batch["audio_mask"])
    return batch, train.mae_random_masking(noise, batch, 0.8)


_MAE_ARGS = ("patches", "mask", "time_inds", "freq_inds", "restore_time_inds",
             "restore_freq_inds", "restore_mask")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,routes", [("bfloat16", {"k1_layer": 2, "k2_block": 0}),
                                          ("float32", {"k1_layer": 1, "k2_block": 1})])
def test_mae_reconstruction_on_the_card(cuda, dtype, routes):
    """The reconstruction forward at audiomae_base widths (one layer a
    tower): the encoder at 100 patches and the decoder at 500 take
    `layer_route`'s routes (bf16 K1 and K1, fp32 K1 and K2); the rows agree
    with the CPU's plain path (cosine >= 0.9999 fp32, 0.999 bf16)."""
    from cacophony_tpu_torch.models.audio import audiomae_apply

    td = getattr(torch, dtype)
    cfg, model = _mae_one_layer(3)
    _, m = _mae_grid(3, 500, [500, 320, 80], 4)
    args = [m[k] for k in _MAE_ARGS]
    with torch.no_grad():
        ref = audiomae_apply(model, cfg.encoder, cfg.decoder, *args, dtype=td).float()
        card = model.to(cuda)
        _reset_layer_launches()
        got = audiomae_apply(card, cfg.encoder, cfg.decoder, *(a.to(cuda) for a in args),
                             dtype=td).float().cpu()
    torch.cuda.synchronize()
    for k, n in routes.items():
        assert ea.LAYER_LAUNCHES[k] == n, (k, ea.LAYER_LAUNCHES)
    cos = torch.nn.functional.cosine_similarity(got.flatten(0, 1), ref.flatten(0, 1), dim=-1)
    assert torch.isfinite(got).all() and cos.min() >= (0.9999 if dtype == "float32" else 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k7", [("bfloat16", 2), ("float32", 1)])
def test_mae_train_step_on_the_card(cuda, dtype, k7, monkeypatch):
    """One stage-1 loss and backward at audiomae_base widths (one layer a
    tower) under the same masking noise on both devices: K4 in both layers;
    K7 in both in bf16 and in the encoder only in fp32 (the decoder's 500
    patches fail fp32's `bwd_fits_vmem`).  fp32: loss 1e-5 and gradients
    1e-4 relative against the CPU."""
    import dataclasses

    from cacophony_tpu_torch.train import train

    cfg, model = _mae_one_layer(5)
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    batch, _ = _mae_grid(2, 500, [500, 80], 6)
    noise = train.mae_noise(torch.Generator().manual_seed(0), batch["audio_mask"])
    monkeypatch.setattr(train, "mae_noise", lambda generator, mask: noise.to(mask.device))
    loss_fn = train.make_mae_loss(cfg, train.TrainConfig())
    out = []
    for device in ("cpu", cuda):
        net = model.to(device)
        net.zero_grad(set_to_none=True)
        _reset_layer_launches()
        loss, _ = loss_fn(net, {k: v.to(device) for k, v in batch.items()}, None)
        loss.backward()
        out.append((float(loss.detach()),
                    torch.cat([p.grad.flatten().double().cpu() for p in net.parameters()])))
    torch.cuda.synchronize()
    assert kern.LAUNCHES["k4"] == 2 and kern.LAUNCHES["k7"] == k7
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert np.isfinite(l_card) and torch.isfinite(g_card).all()
    if dtype == "float32":
        assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
        assert float((g_card - g_cpu).norm() / g_cpu.norm()) <= 1e-4


@pytest.mark.cuda
def test_load_audiomae_on_the_card(cuda, tmp_path):
    """A stage-1 file written by the port loads with `load_audiomae` onto
    the card (its default device), every tensor equal to the source."""
    import dataclasses

    from cacophony_tpu_torch.checkpoints import bridge, convert, io, msgpack
    from cacophony_tpu_torch.models.audio import audiomae_init
    from cacophony_tpu_torch.train.runner import _tiny_mae

    cfg = _tiny_mae()
    model = audiomae_init(cfg.encoder, cfg.decoder, torch.Generator().manual_seed(8))
    ref = convert.audiomae_params_to_reference(bridge.params_to_jax(model), 2, 2)
    msgpack.save_checkpoint(str(tmp_path), {"0": {"params": ref}}, step=0)
    loaded_cfg, loaded = io.load_audiomae(str(tmp_path), strict_counts=False)
    assert loaded_cfg.decoder == cfg.decoder  # the encoder's informational max_time_ind is base's
    assert loaded_cfg.encoder == dataclasses.replace(cfg.encoder, max_time_ind=1000)
    assert next(loaded.parameters()).device.type == "cuda"
    for name, t in loaded.state_dict().items():
        assert torch.equal(t.cpu(), model.state_dict()[name]), name


@pytest.mark.cuda
def test_mae_runner_two_steps_on_the_card(cuda, tmp_path):
    """`train.runner.main --stage mae --tiny-model` in bf16 on the card from
    wavs alone: K4 and K7 once per layer of each tower per step."""
    import json
    import os

    from scipy.io import wavfile

    from cacophony_tpu_torch.train import runner

    data = tmp_path / "data"
    data.mkdir()
    for i in range(8):
        x = (0.1 * np.random.RandomState(i).randn(12000)).astype(np.float32)
        wavfile.write(str(data / f"c{i}.wav"), 16000, (x * 32767).astype(np.int16))
    work = str(tmp_path / "work")
    kern.reset_launches()
    state = runner.main(["--stage", "mae", "--data-dir", str(data), "--workdir", work,
                         "--steps", "2", "--batch-size", "4", "--buffer-seconds", "1",
                         "--patches-seq-len", "32", "--tiny-model", "--dtype", "bfloat16",
                         "--checkpoint-every", "0", "--log-every", "1"])
    torch.cuda.synchronize()
    layers = 2 + 2  # the tiny encoder's and decoder's
    assert kern.LAUNCHES["k4"] == 2 * layers and kern.LAUNCHES["k7"] == 2 * layers
    assert state.step == 2 and next(state.params.parameters()).device.type == "cuda"
    losses = [json.loads(line)["loss"] for line in open(os.path.join(work, "metrics.jsonl"))]
    assert len(losses) == 2 and np.isfinite(losses).all()


def _tiny_caption_model(seed):
    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.models.caco import caco_init

    cfg = configs.caco_tiny(vocab_size=300)
    return cfg, caco_init(cfg, torch.Generator().manual_seed(seed))


def _tiny_patches(b, s, seed):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(s // 3, s + 1, size=b)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None, :] * mask
    return {"audio_patches": torch.from_numpy((rs.randn(b, s, 256) * mask[..., None])
                                              .astype(np.float32)),
            "audio_time_inds": torch.from_numpy(inds // 8),
            "audio_freq_inds": torch.from_numpy(inds % 8),
            "audio_mask": torch.from_numpy(mask)}


@pytest.mark.cuda
@pytest.mark.parametrize("cuda_graph", [True, False])
def test_greedy_decode_on_the_card_matches_cpu(cuda, cuda_graph):
    """fp32 top_k=1 decode at caco_tiny: the card (K2 in the audio pass; the
    step as a CUDA graph or eager) gives the CPU's ids token for token."""
    from cacophony_tpu_torch.models.caco import decode

    cfg, model = _tiny_caption_model(11)
    batch = _tiny_patches(6, 32, 11)
    kw = dict(max_length=24, temperature=1.0, bos_id=0, eos_id=2, pad_id=1, top_k=1)
    with torch.inference_mode():
        ref = decode(model, cfg, batch, generator=torch.Generator().manual_seed(0), **kw)
        model = model.to(cuda)
        got = decode(model, cfg, {k: v.to(cuda) for k, v in batch.items()},
                     generator=torch.Generator(device=cuda).manual_seed(0),
                     cuda_graph=cuda_graph, **kw)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_gallery_search_on_the_card_matches_cpu(cuda):
    """Top-k search over 20 000 rows with 1 % deleted: the same rows in the
    same order, scores within 1e-5 (TF32 off)."""
    from cacophony_tpu_torch.runtime.gallery import GalleryIndex

    rs = np.random.RandomState(13)
    rows = rs.randn(20_000, 64).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    dead = rs.choice(20_000, 200, replace=False)
    out = {}
    for dev in ("cpu", "cuda"):
        g = GalleryIndex(64, logit_scale=1.2, slab=4096, device=dev)
        for i in range(0, 20_000, 3000):
            g.add(rows[i:i + 3000])
        g.delete(dead)
        out[dev] = g.search(rows[:32], k=10)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-5)


class _IdTokenizer:
    """Stands in for the tokenizer: a prompt is a list of ids, padded with
    id 1 to max_length."""

    def __call__(self, prompts, padding=None, truncation=True, max_length=None,
                 return_tensors="np"):
        ids = np.ones((len(prompts), max_length), np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            p = list(p)[:max_length]
            ids[i, :len(p)], mask[i, :len(p)] = p, 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.cuda
@pytest.mark.parametrize("longest,bucket", [(10, 16), (30, 32), (50, 64), (90, 100)])
def test_text_tower_graph_matches_eager_bit_for_bit(cuda, longest, bucket):
    """`embed_texts` on the card replays one CUDA graph per (rows, bucket):
    bit for bit the eager `get_text_embedding` of the same padded ids at
    caco_tiny in bf16, for 1 prompt, batch_size prompts and two chunks,
    and again after new weights are copied into the text tower in place
    (no new capture); one capture a shape, one replay a chunk."""
    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.models.caco import caco_init, get_text_embedding
    from cacophony_tpu_torch.runtime import CacoEngine
    from cacophony_tpu_torch.utils import profiling

    cfg = configs.caco_tiny()
    engine = CacoEngine(cfg, caco_init(cfg, torch.Generator().manual_seed(5)),
                        tokenizer=_IdTokenizer(), device=cuda, batch_size=4, max_text_len=100,
                        dtype=torch.bfloat16)
    rs = np.random.RandomState(longest)
    calls = [[rs.randint(3, cfg.text.vocab_size, k).tolist()
              for k in [longest, *rs.randint(2, longest + 1, n - 1)]] for n in (1, 4, 7)]

    @torch.inference_mode()
    def eager(texts):
        ids, mask, n = engine._text_batch(texts)
        assert ids.shape[1] == bucket
        return torch.cat([get_text_embedding(
            engine.params, engine.cfg, torch.from_numpy(ids[i:i + 4]).to(cuda),
            torch.from_numpy(mask[i:i + 4]).to(cuda))[0].cpu()
            for i in range(0, len(ids), 4)]).numpy()[:n]

    first = None
    for new_weights in (False, True):
        if new_weights:
            other = caco_init(cfg, torch.Generator().manual_seed(6))
            with torch.no_grad():
                for mine, theirs in ((engine.params.text, other.text),
                                     (engine.params.text_proj, other.text_proj)):
                    for p, q in zip(mine.parameters(), theirs.parameters()):
                        p.copy_(q)
        for j, texts in enumerate(calls):
            with profiling.recording() as rec:
                got = engine.embed_texts(texts)
            chunks = -(-len(texts) // 4)
            assert got.shape == (len(texts), cfg.projection_size)
            assert np.array_equal(got, eager(texts)), (new_weights, len(texts))
            captures = {"engine.text_graph_captures": 1} if (j, new_weights) == (0, False) else {}
            assert rec.counters == {"engine.text_prompts": len(texts),
                                    "engine.text_rows": 4 * chunks,
                                    "engine.text_graph_replays": chunks, **captures}
            if j == 0:
                if first is None:
                    first = got
                else:
                    assert not np.array_equal(got, first)  # the new weights were read
    assert list(engine._text_graphs) == [(4, bucket)]


def _hear_model(kind, seed):
    """A HEAR embedder's model at published audio width with one encoder
    layer: caco_base's audio tower (a caco_tiny text side), or
    audiomae_base's encoder and decoder."""
    import dataclasses

    from cacophony_tpu_torch import configs
    from cacophony_tpu_torch.models.caco import caco_init

    if kind == "audiomae":
        return _mae_one_layer(seed)
    base, tiny = configs.caco_base(), configs.caco_tiny()
    cfg = dataclasses.replace(base, audio=dataclasses.replace(base.audio, num_layers=1),
                              text=tiny.text, decoder=tiny.decoder)
    return cfg, caco_init(cfg, torch.Generator().manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["caco", "audiomae"])
def test_hear_embedder_on_the_card_matches_cpu(cuda, kind, tmp_path):
    """The HEAR forward at 10 s (500 patches, fp32: K2) on clips of 0.7,
    2.5 and 10 s: the whole encoder output, the padded rows included (the
    event pool averages them), and the scene and event embeddings agree
    with the CPU's plain path within the fp32 chain bound."""
    import copy

    from scipy.io import wavfile

    from cacophony_tpu_torch.hear import embeddings

    rs = np.random.RandomState(21)
    paths = []
    for i, seconds in enumerate((0.7, 2.5, 10.0)):
        paths.append(str(tmp_path / f"clip{i}.wav"))
        wavfile.write(paths[-1], 16000, (0.1 * rs.randn(int(seconds * 16000)) * 32767)
                      .astype(np.int16))
    cfg, model = _hear_model(kind, 22)
    cls = embeddings.CacoHearEmbedder if kind == "caco" else embeddings.AudioMAEHearEmbedder
    cpu = cls(cfg, model)
    card = cls(cfg, copy.deepcopy(model).to(cuda))
    assert card.device.type == "cuda" and card.patch.patches_seq_len == 500

    def hidden(emb):
        out = emb._fwd(paths)
        return (out[1] if kind == "caco" else out).float().cpu()

    ref = hidden(cpu)
    _reset_layer_launches()
    got = hidden(card)
    torch.cuda.synchronize()
    assert ea.LAYER_LAUNCHES["k2_block"] == 1 and ea.LAYER_LAUNCHES["k1_layer"] == 0
    atol, rtol = TOL["float32"]
    mask = cpu._batch(paths)["audio_mask"]
    assert mask[0].sum() < 500 and (mask == 0).any()  # padded rows present
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=atol, rtol=rtol)
    pad = (mask == 0).numpy()
    np.testing.assert_allclose(got.numpy()[pad], ref.numpy()[pad], atol=atol, rtol=rtol)
    np.testing.assert_allclose(card.scene_embeddings(paths), cpu.scene_embeddings(paths),
                               atol=atol, rtol=rtol)
    (ev, ts), (ev_ref, ts_ref) = card.event_embeddings(paths), cpu.event_embeddings(paths)
    assert ev.shape == (3, 62, 768)
    np.testing.assert_array_equal(ts, ts_ref)
    np.testing.assert_allclose(ev, ev_ref, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_probe_train_step_on_the_card_matches_cpu(cuda):
    """One step of the HEAR probe (dropout 0, two hidden layers with BN,
    multiclass) on the card against the same step on the CPU: every gradient,
    weight, BN parameter and statistic, and the probabilities, within 1e-5.
    The gradient of a pre-BN bias is zero in exact arithmetic (the BN takes
    the batch mean out).  Each device leaves a rounding residue, near 1e-8
    on the CPU and so near Adam's eps, and Adam's first step turns it into a
    move of lr·|g| / (|g| + eps) < lr that differs from device to device.
    So on each device those gradients are held to 1e-6 (the other leaves'
    are 1e-2 to 1e-1) and those moves to lr, and the probabilities are
    compared with the CPU's pre-BN biases on both probes."""
    from cacophony_tpu_torch.hear.predictions import MLPProbe

    conf = {"hidden_layers": 2, "hidden_dim": 64, "dropout": 0.0, "batch_size": 64, "lr": 1e-3}
    rs = np.random.RandomState(5)
    x = rs.randn(64, 768).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 64)]
    probes = {d: MLPProbe(768, 10, "multiclass", conf, seed=7, device=d) for d in ("cpu", "cuda")}
    assert all(p.device.type == "cuda" for p in probes["cuda"].parameters())
    pre_bn = {f"net.{i}.bias" for i in (0, 4)}
    init = {k: v.clone() for k, v in probes["cpu"].state_dict().items() if k in pre_bn}
    grads, moves = {}, {}
    for d, probe in probes.items():
        probe.train_batch(torch.from_numpy(x).to(d), torch.from_numpy(y).to(d))
        grads[d] = {k: p.grad.cpu().numpy() for k, p in probe.named_parameters()}
        moves[d] = {k: float((probe.state_dict()[k].cpu() - init[k]).abs().max()) for k in pre_bn}
    print(f"pre-BN biases, one step: max |gradient| "
          f"{ {d: {k: float(np.abs(g[k]).max()) for k in sorted(pre_bn)} for d, g in grads.items()} },"
          f" max |move| {moves} (lr {conf['lr']})")
    for k, g in grads["cpu"].items():
        if k in pre_bn:
            for d in grads:
                assert np.abs(grads[d][k]).max() <= 1e-6, (d, k)
                assert moves[d][k] < conf["lr"], (d, k)
        else:
            np.testing.assert_allclose(grads["cuda"][k], g, atol=1e-5, rtol=1e-5, err_msg=k)
    ref, got = probes["cpu"].state_dict(), probes["cuda"].state_dict()
    for k, v in ref.items():
        if k not in pre_bn:
            np.testing.assert_allclose(got[k].cpu().numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    with torch.no_grad():
        for k in pre_bn:
            got[k].copy_(ref[k])
    np.testing.assert_allclose(probes["cuda"].probabilities(x), probes["cpu"].probabilities(x),
                               atol=1e-5, rtol=1e-5)
