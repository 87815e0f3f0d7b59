"""K2, K3 and the route decision in the port against the JAX package.

JAX kernels reached, in Pallas interpret mode as tests/test_encoder_attention.py
runs them: K2 `_pallas_fused_block(with_mlp=False)`, K3
`_pallas_fused_block_blocked(with_mlp=False)`, K3' (the blocked kernel with
with_mlp=True), and, through `_vit_block`, whichever of them the JAX
dispatch picks; the "einsum" route reaches no kernel.  Inputs come from
numpy with a fixed seed and go to both packages.

Tolerances: fp32 5e-5 absolute (summation order of the products; the einsum
layer 2e-4 at width 768, whose sums are longer).  bf16: K2 bit-equal (the
plain chain rounds where the Pallas kernel rounds); K3 within one bf16 step
(rtol 2^-7, on < 0.1 % of the values: over 512 padded keys an fp32 sum
taken in another order moves a value across a rounding boundary); K3' 2^-6
absolute plus one step (such a flip, carried through the in-kernel MLP);
layers with the MLP outside the kernel 2^-6 absolute plus two steps (silu's
rounding points in bf16 belong to XLA's backend).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu.models import audio as jaudio
from cacophony_tpu.ops import attention as jattn
from cacophony_tpu.ops import encoder_attention as jea
from cacophony_tpu_torch.models.audio import encoder_layer
from cacophony_tpu_torch.ops import encoder_attention as tea
from cacophony_tpu_torch.ops.attention import multi_head_attention
from tests.test_torch_encoder_attention import _block_params, _mask

torch.set_num_threads(2)

EPS = 1e-6
SEQS = (64, 496, 1000, 1496, 1536, 2000)
WIDTHS = {"caco_tiny": (32, 64), "caco_base": (768, 3072)}


def _jax_route(s, d, inter, jd):
    """The order in which the JAX `_vit_block` tries its kernels
    (models/audio.py:161-185 → encoder_attention.py:897-1018, and
    ops/attention.py:113-131 for the attention-only kernels)."""
    plan = jea.kernel_plan(s, d, jd)
    if plan is None:
        return "einsum", s
    if plan[0] == "one_shot":
        if jea.fused_block_fits(s, d, jd, intermediate=inter):
            return "k1", s
        if jea.fused_block_fits(s, d, jd):
            return "k2", s
        return ("k6", s) if jea.fused_ln_fits(s, d, jd) else ("k4", s)
    qb = jea.FUSED_BLOCKED_Q_BLOCK
    s_pad = -(-s // qb) * qb
    if jea.fused_block_blocked_fits(s_pad, qb, d, jd):
        return "k3", s_pad
    return "k5", plan[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_layer_route_matches_jax_dispatch(width, dtype):
    d, inter = WIDTHS[width]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for s in SEQS:
        assert tea.layer_route(s, d, inter, td) == _jax_route(s, d, inter, jd), s
        assert tea.preferred_seq_len(s, d, td) == jea.preferred_seq_len(s, d, jd), s
        assert tea.kernel_plan(s, d, td) == jea.kernel_plan(s, d, jd), s


def test_serving_routes():
    """The serving table: 10-s buffers have 496 patches, 30-s ones 1496."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tea.layer_route(496, 768, 3072, bf16) == ("k1", 496)
    assert tea.layer_route(496, 768, 3072, f32) == ("k2", 496)
    assert tea.preferred_seq_len(1496, 768, bf16) == 1536
    assert tea.layer_route(1536, 768, 3072, bf16) == ("k3", 1536)
    assert tea.preferred_seq_len(1000, 768, f32) == 1024
    assert tea.layer_route(1024, 768, 3072, f32) == ("k3", 1024)
    assert tea.preferred_seq_len(1496, 768, f32) == 1496
    assert tea.layer_route(1496, 768, 3072, f32) == ("einsum", 1496)
    assert tea.layer_route(1496, 32, 64, bf16) == ("k1", 1496)
    assert tea.preferred_seq_len(1496, 32, f32) == 1536
    assert tea.layer_route(1536, 32, 64, f32) == ("k3", 1536)


@pytest.mark.parametrize("route", ["k4", "k5", "k6"])
def test_unported_routes_raise(route):
    """Every route is ported now, and only an unknown route raises.  The
    "k4" and "k5" routes run the unfused block, whose attention takes K4 or
    K5 by its plan (here one-shot: K4); "k6" runs K6 with the rest of the
    layer outside it, the einsum layer's value up to fp32 rounding (the
    clamp softmax against the −1e30 bias)."""
    _, blk = _block_params(np.random.RandomState(0), 32, 64)
    x, mask = torch.randn(1, 8, 32), torch.ones(1, 8)
    with torch.no_grad():
        got = encoder_layer(blk, x, mask, 2, route, torch.float32)
        want = encoder_layer(blk, x, mask, 2, "einsum", torch.float32)
    if route == "k6":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    else:
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown encoder layer route"):
        encoder_layer(blk, x, mask, 2, "k9", torch.float32)


def _inputs(rs, b, s, d, lengths):
    return rs.randn(b, s, d).astype(np.float32), _mask(lengths, s)


def _assert_matches(got, ref, dtype, bf16_tol=None, bf16_share=0.0):
    """fp32: 5e-5 absolute.  bf16: bit-equal, or within bf16_tol = (atol,
    rtol) with at most bf16_share of the values differing at all."""
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=5e-5)
    elif bf16_tol is None:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=bf16_tol[0], rtol=bf16_tol[1])
        assert (got != ref).mean() <= bf16_share


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_matches_pallas_k2(dtype):
    """B=3, S=48, D=64, H=4; clip 2 has no valid key."""
    rs = np.random.RandomState(0)
    tree, blk = _block_params(rs, 64, 256)
    x, mask = _inputs(rs, 3, 48, 64, [48, 40, 0])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jea._pallas_fused_block(jt, jnp.asarray(x, jd), jnp.asarray(mask), 4, EPS,
                                  interpret=True, with_mlp=False)
    with torch.no_grad():
        got = tea.fused_block_attention(blk, torch.from_numpy(x).to(td), torch.from_numpy(mask), 4,
                                        EPS, ("one_shot",))
    for g, r in zip(got, ref):
        assert g.dtype == td and g.shape == (3, 48, 64)
        _assert_matches(g, r, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_blocked_matches_pallas_k3(dtype):
    """S=300 pads to 512 (two q-blocks of 256): padded keys masked, padded
    query rows sliced away; mixed lengths and a clip with no valid key."""
    rs = np.random.RandomState(1)
    tree, blk = _block_params(rs, 64, 256)
    x, mask = _inputs(rs, 3, 300, 64, [300, 123, 0])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jea._pallas_fused_block_blocked(jt, jnp.asarray(x, jd), jnp.asarray(mask), 4, EPS,
                                          q_block=256, interpret=True)
    with torch.no_grad():
        got = tea.fused_block_attention(blk, torch.from_numpy(x).to(td), torch.from_numpy(mask), 4,
                                        EPS, ("blocked", 256))
    for g, r in zip(got, ref):
        assert g.shape == (3, 300, 64)
        _assert_matches(g, r, dtype, (1e-6, 2 ** -7), 1e-3)
    plain = tea.fused_block_attention_plain(blk, torch.from_numpy(x).to(td), torch.from_numpy(mask),
                                            4, EPS, ("blocked", 256))
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_chain_at_padded_length_matches_pallas_k3_prime(dtype):
    """The whole-layer chain over a row padded to 512 equals the blocked
    kernel with its MLP inside (K3', no caller in the JAX package)."""
    rs = np.random.RandomState(2)
    tree, blk = _block_params(rs, 64, 256)
    x, mask = _inputs(rs, 2, 300, 64, [300, 77])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jea._pallas_fused_block_blocked(jt, jnp.asarray(x, jd), jnp.asarray(mask), 4, EPS,
                                          q_block=256, interpret=True, with_mlp=True)
    xp = np.pad(x, ((0, 0), (0, 212), (0, 0)))
    mp = np.pad(mask, ((0, 0), (0, 212)))
    with torch.no_grad():
        got = tea.fused_layer(blk, torch.from_numpy(xp).to(td), torch.from_numpy(mp), 4, EPS)
    _assert_matches(got[:, :300], ref, dtype, (2 ** -6, 2 ** -7), 0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_einsum_attention_matches_jax_flash_mask_path(dtype):
    """multi_head_attention with a key mask and no kernel: JAX, and the port
    with it, decline their kernels when attention dropout is requested
    (here without a key or generator, so no dropout is applied) and build
    the −1e30 bias from the mask."""
    from cacophony_tpu_torch.ops.attention import Attention

    rs = np.random.RandomState(3)
    d, h = 32, 2
    params = {"qkv": {"w": (rs.randn(d, 3 * d) / np.sqrt(d)).astype(np.float32),
                      "b": (0.1 * rs.randn(3 * d)).astype(np.float32)},
              "o": {"w": (rs.randn(d, d) / np.sqrt(d)).astype(np.float32),
                    "b": (0.1 * rs.randn(d)).astype(np.float32)}}
    p = Attention(d)
    with torch.no_grad():
        for name in ("qkv", "o"):
            getattr(p, name).w.copy_(torch.from_numpy(params[name]["w"]))
            getattr(p, name).b.copy_(torch.from_numpy(params[name]["b"]))
    x, mask = _inputs(rs, 3, 40, d, [40, 9, 0])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref, _ = jattn.multi_head_attention(jax.tree_util.tree_map(jnp.asarray, params),
                                        jnp.asarray(x, jd), num_heads=h, dtype=jd,
                                        flash_mask=jnp.asarray(mask), dropout_rate=0.5)
    with torch.no_grad():
        got = multi_head_attention(p, torch.from_numpy(x).to(td), num_heads=h, dtype=td,
                                   flash_mask=torch.from_numpy(mask), dropout_rate=0.5)
    tol = 5e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=tol)


# (route, d, intermediate, heads, dtype, seq, lengths): each is the route
# the JAX dispatch takes at that shape.
LAYER_CASES = [
    ("k2", 768, 3072, 8, "float32", 248, [248]),
    ("k3", 32, 64, 2, "float32", 1496, [1496, 700]),
    ("k3", 32, 64, 2, "bfloat16", 2000, [2000, 0]),
    ("einsum", 768, 768, 8, "float32", 1496, [1200]),
]


@pytest.mark.parametrize("route,d,inter,heads,dtype,seq,lengths", LAYER_CASES)
def test_layer_matches_jax_vit_block(route, d, inter, heads, dtype, seq, lengths):
    """One inference layer, the port's `encoder_layer` against the JAX
    `_vit_block`: the kernel half plus the MLP outside it (K2, K3) or the
    einsum layer."""
    rs = np.random.RandomState(4)
    tree, blk = _block_params(rs, d, inter)
    x, mask = _inputs(rs, len(lengths), seq, d, lengths)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    assert tea.layer_route(seq, d, inter, td)[0] == route == _jax_route(seq, d, inter, jd)[0]
    ref = jaudio._vit_block(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x, jd), None,
                            num_heads=heads, dropout_rate=0.0, drop_path_rate=0.0, dtype=jd,
                            flash_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = encoder_layer(blk, torch.from_numpy(x).to(td), torch.from_numpy(mask), heads,
                            route, td)
    assert got.dtype == td and torch.isfinite(got).all()
    atol, rtol = {"float32": (2e-4 if d == 768 else 5e-5, 0), "bfloat16": (2 ** -6, 2 ** -6)}[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
