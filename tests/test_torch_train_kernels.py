"""K4, K5 and K7 in the port — their plain PyTorch versions and the
autograd Functions around them — against the JAX package's Pallas kernels
run in interpret mode on the CPU, as tests/test_encoder_attention.py runs
them, and the route decisions (`kernel_plan`, `bwd_fits_vmem`) against
JAX's.

JAX kernels reached: `_pallas_forward` (K4), `_pallas_forward_blocked`
(K5), `_pallas_backward` (K7), and through `encoder_attention` /
`encoder_attention_blocked` their custom VJPs (K7, or XLA
rematerialisation).  Inputs come from numpy with a fixed seed.

Tolerances: fp32 2e-5 absolute on outputs and gradients of magnitude ~1
(fp32 sums in another order); the bf16 K4 forward bit-equal (q rounded to
bf16 the same way, exact products, fp32 sums of 48 terms); the bf16 K5
forward at most two bf16 steps (units in the last place) on at most 0.1 %
of values (row sums over 2048 keys in another order move a few values
across a rounding boundary; a value that is a near-cancelled sum can move
two); 2e-2 absolute on bf16 gradients (one bf16 rounding step of
values up to ~4 after fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu.ops import encoder_attention as jea
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as tea

torch.set_num_threads(2)

D, H, B, S = 64, 4, 3, 48
LENGTHS = [48, 40, 0]  # clip 2: every key masked
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_F32, TOL_BF16_GRAD = 2e-5, 2e-2


def _mask(lengths, s):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


def _close(got, ref, dtype, grad=False, step_share=0.0):
    got, ref = got.detach().float().numpy(), np.asarray(ref).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=TOL_F32)
    elif grad:
        np.testing.assert_allclose(got, ref, atol=TOL_BF16_GRAD)
    else:
        off = got != ref
        assert off.mean() <= step_share, off.mean()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref[off]))) - 7)  # bf16: 8 significant bits
        assert (np.abs(got[off] - ref[off]) <= 2 * ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_k4_plain_matches_pallas_forward(dtype, causal):
    rs = np.random.RandomState(1)
    qkv = (1.5 * rs.randn(B, S, 3 * D)).astype(np.float32)
    mask = _mask(LENGTHS, S)
    jd, td = DTYPES[dtype]
    ref = jea._pallas_forward(jnp.asarray(qkv, jd), jnp.asarray(mask), H, True, causal)
    got = kern.attention_k4(torch.from_numpy(qkv).to(td), torch.from_numpy(mask), H, causal)
    assert got.dtype == td
    _close(got, ref, dtype)
    assert (got[2] == 0).all()  # the all-masked clip attends to nothing


@pytest.mark.parametrize("dtype,s", [("float32", 1400), ("bfloat16", 1700)])
def test_k5_unpadded_matches_the_padded_plain_version(dtype, s):
    """`encoder_attention_blocked` runs K5 at the clip length (no padding
    copies); the plain version pads to the plan's length as
    `_pallas_forward_blocked` does.  The padded keys add exact zeros, but a
    CPU BLAS may sum the longer key axis in another order: fp32 within
    1e-6, bf16 within one bf16 step (the card holds the kernel to bit
    equality, tests/test_torch_cuda.py)."""
    d, h = 32, 2
    td = DTYPES[dtype][1]
    plan = tea.kernel_plan(s, d, td)
    assert plan[0] == "blocked" and s % plan[2] != 0
    rs = np.random.RandomState(6)
    q = torch.from_numpy(rs.randn(2, s, d).astype(np.float32)).to(td)
    kv = torch.from_numpy(rs.randn(2, s, 2 * d).astype(np.float32)).to(td)
    mask = torch.from_numpy(_mask([s, 700], s))
    got = tea.encoder_attention_blocked(q, kv, mask, h)
    ref = tea.encoder_attention_blocked_plain(q, kv, mask, h)
    assert got.shape == ref.shape == (2, s, d) and got.dtype == td
    got, ref = got.float().numpy(), ref.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(got - ref) <= ulp).all()


@pytest.mark.parametrize("dtype,s", [("float32", 1400), ("bfloat16", 1700)])
def test_k5_plain_matches_pallas_forward_blocked(dtype, s):
    """S not a multiple of the q-block: the plan pads (1400 → 1536 in fp32,
    1700 → 2048 in bf16, q-blocks of 512) and slices the padded rows away."""
    d, h = 32, 2
    jd, td = DTYPES[dtype]
    plan = tea.kernel_plan(s, d, td)
    assert plan[0] == "blocked" and plan[1] % plan[2] == 0 and s % plan[2] != 0
    rs = np.random.RandomState(2)
    q = rs.randn(2, s, d).astype(np.float32)
    kv = rs.randn(2, s, 2 * d).astype(np.float32)
    mask = _mask([s, 700], s)
    ref = jea._pallas_forward_blocked(jnp.asarray(q, jd), jnp.asarray(kv, jd), jnp.asarray(mask),
                                      h, True)
    got = tea.encoder_attention_blocked_plain(torch.from_numpy(q).to(td),
                                              torch.from_numpy(kv).to(td),
                                              torch.from_numpy(mask), h)
    assert got.shape == (2, s, d)
    _close(got, ref, dtype, step_share=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_k7_plain_matches_pallas_backward(dtype, causal):
    rs = np.random.RandomState(3)
    qkv = (1.5 * rs.randn(B, S, 3 * D)).astype(np.float32)
    g = rs.randn(B, S, D).astype(np.float32)
    mask = _mask(LENGTHS, S)
    jd, td = DTYPES[dtype]
    ref = jea._pallas_backward(jnp.asarray(qkv, jd), jnp.asarray(mask), jnp.asarray(g, jd), H,
                               True, causal)
    got = kern.attention_bwd(torch.from_numpy(qkv).to(td), torch.from_numpy(mask),
                             torch.from_numpy(g).to(td), H, causal)
    assert got.shape == (B, S, 3 * D) and got.dtype == td
    _close(got, ref, dtype, grad=True)
    assert torch.isfinite(got).all() and (got[2] == 0).all()  # all-masked clip: zero gradients


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads", [(128, 1), (20, 3), (192, 1), (256, 2)])
def test_k4_k7_plain_match_pallas_at_other_head_dims(dtype, hd, heads):
    """The head dims the port's kernels take beyond 64 and 96: 128, one
    that is not a multiple of 8 (20), and heads past 128 columns (192, 256:
    the kernels run them in pieces of 128), causal, against
    `_pallas_forward` and `_pallas_backward`."""
    rs = np.random.RandomState(4)
    d = hd * heads
    qkv = (1.5 * rs.randn(B, S, 3 * d)).astype(np.float32)
    g = rs.randn(B, S, d).astype(np.float32)
    mask = _mask(LENGTHS, S)
    jd, td = DTYPES[dtype]
    ref = jea._pallas_forward(jnp.asarray(qkv, jd), jnp.asarray(mask), heads, True, True)
    got = kern.attention_k4(torch.from_numpy(qkv).to(td), torch.from_numpy(mask), heads, True)
    _close(got, ref, dtype, step_share=1e-3)
    ref = jea._pallas_backward(jnp.asarray(qkv, jd), jnp.asarray(mask), jnp.asarray(g, jd), heads,
                               True, True)
    got = kern.attention_bwd(torch.from_numpy(qkv).to(td), torch.from_numpy(mask),
                             torch.from_numpy(g).to(td), heads, True)
    _close(got, ref, dtype, grad=True)
    assert (got[2] == 0).all()


def _jax_grads(fn, args, g):
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(g)


@pytest.mark.parametrize("dtype,s,causal", [("float32", S, False), ("bfloat16", S, True),
                                            ("float32", 1200, False)])
def test_k4_function_gradients_match_jax_custom_vjp(dtype, s, causal):
    """Forward and d qkv of `encoder_attention`: K7 at S = 48, and at
    S = 1200 in fp32 (one-shot, but `bwd_fits_vmem` false) autograd of the
    plain `_xla_attention` on both sides."""
    d, h = (D, H) if s == S else (32, 2)
    jd, td = DTYPES[dtype]
    assert tea.bwd_fits_vmem(s, d, td) == (s == S)
    rs = np.random.RandomState(4)
    qkv = rs.randn(2, s, 3 * d).astype(np.float32)
    g = rs.randn(2, s, d).astype(np.float32)
    mask = _mask([s, s // 2], s)
    ref, (ref_d,) = _jax_grads(lambda x: jea.encoder_attention(x, jnp.asarray(mask), h, True,
                                                               causal),
                               (jnp.asarray(qkv, jd),), jnp.asarray(g, jd))
    x = torch.from_numpy(qkv).to(td).requires_grad_()
    out = tea.encoder_attention(x, torch.from_numpy(mask), h, causal)
    out.backward(torch.from_numpy(g).to(td))
    _close(out, ref, dtype)
    _close(x.grad, ref_d, dtype, grad=True)


def test_k5_function_gradients_match_jax_custom_vjp():
    """`encoder_attention_blocked` at S = 1400 (padded to 1536 inside):
    forward, dQ and dK|V from autograd of the plain `_xla_attention_split`
    at the unpadded length."""
    s, d, h = 1400, 32, 2
    rs = np.random.RandomState(5)
    q = rs.randn(2, s, d).astype(np.float32)
    kv = rs.randn(2, s, 2 * d).astype(np.float32)
    g = rs.randn(2, s, d).astype(np.float32)
    mask = _mask([s, 900], s)
    ref, (rq, rkv) = _jax_grads(lambda a, b: jea.encoder_attention_blocked(a, b, jnp.asarray(mask),
                                                                           h, True),
                                (jnp.asarray(q), jnp.asarray(kv)), jnp.asarray(g))
    tq, tkv = torch.from_numpy(q).requires_grad_(), torch.from_numpy(kv).requires_grad_()
    out = tea.encoder_attention_blocked(tq, tkv, torch.from_numpy(mask), h)
    out.backward(torch.from_numpy(g))
    for got, want in ((out, ref), (tq.grad, rq), (tkv.grad, rkv)):
        _close(got, want, "float32")


def test_k4_k5_refuse_the_other_plan():
    with pytest.raises(ValueError, match="one-shot"):
        tea.encoder_attention(torch.zeros(1, 1400, 96), torch.ones(1, 1400), 2)
    with pytest.raises(ValueError, match="blocked"):
        tea.encoder_attention_blocked(torch.zeros(1, 64, 32), torch.zeros(1, 64, 64),
                                      torch.ones(1, 64), 2)


@pytest.mark.parametrize("width", [32, 768])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_routes_match_jax(width, dtype):
    """`kernel_plan` and `bwd_fits_vmem` over seq 8…2100: which attention
    kernel the training step runs and whether its backward is K7."""
    jd, td = DTYPES[dtype]
    for s in list(range(8, 2101, 37)) + [100, 335, 336, 500, 543, 544, 579, 580, 891, 892, 1500]:
        assert tea.kernel_plan(s, width, td) == jea.kernel_plan(s, width, jd), s
        assert tea.bwd_fits_vmem(s, width, td) == jea.bwd_fits_vmem(s, width, jd), s
    if width == 768:  # the routes the training configurations take
        assert tea.kernel_plan(500, 768, td)[0] == "one_shot"
        assert tea.bwd_fits_vmem(500, 768, td) == (dtype == "bfloat16")
    if width == 768 and dtype == "bfloat16":
        assert tea.kernel_plan(1500, 768, td) == ("blocked", 1536, 256)
