"""Gradients of the port's fused encoder routes against the JAX package's
custom VJPs.

JAX's `fused_layer`, `fused_block_attention` and `fused_ln_attention` are
`jax.custom_vjp`s: the forward is the Pallas kernel (here in interpret
mode, as tests/test_encoder_attention.py:209-247 and :429-451 run it), the
backward the vjp of the XLA reference `_xla_layer` / `_xla_block` /
`_xla_ln_attention` at the saved inputs.  The port's routes are
`torch.autograd.Function`s with that backward.  Every case has a clip with
no valid key: JAX's textbook softmax gives it uniform weights over the
masked keys, so its values get gradients, where autograd of the clamp
chain (the forward's numerics, its row sum floored at 1e-37) gives no
usable gradient.

fp32 at tiny widths, inputs from numpy with a fixed seed.  Tolerance:
5e-5 absolute plus 1e-4 relative on gradients of magnitude up to ~10
(fp32 sums in another order through the layer and its backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.models import audio as jaudio
from cacophony_tpu.ops import encoder_attention as jea
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import jax_state_dict
from cacophony_tpu_torch.models import audio as taudio
from cacophony_tpu_torch.ops import encoder_attention as tea
from tests.test_torch_encoder_attention import _block_params, _mask

torch.set_num_threads(2)

EPS = 1e-6
D, INTER, H = 32, 64, 2
ATOL, RTOL = 5e-5, 1e-4


def _close(got, ref, name):
    assert got is not None, name
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=name)


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def _inputs(seed, s):
    rs = np.random.RandomState(seed)
    tree, blk = _block_params(rs, D, INTER)
    x = rs.randn(3, s, D).astype(np.float32)
    mask = _mask([s, s // 2, 0], s)  # clip 2: every key masked
    return rs, tree, blk, x, mask


def _check_grads(blk, names, jgrads, x, jdx):
    for name in names:
        _close(blk.get_parameter(name).grad, _leaf(jgrads, name), name)
    _close(x.grad, jdx, "x")


# (route, variant, s): one-shot at S = 40; blocked at S = 300 (padded to 512)
CASES = [("layer", ("one_shot",), 40), ("layer", ("blocked", 256), 300),
         ("block", ("one_shot",), 40), ("block", ("blocked", 256), 300)]


@pytest.mark.parametrize("route,variant,s", CASES)
def test_fused_route_gradients_match_jax_custom_vjp(route, variant, s):
    """`fused_layer` (K1, K3′) and `fused_block_attention` (K2, K3):
    outputs, every parameter's gradient and dx against `jax.vjp` of JAX's
    function for the same cotangents."""
    rs, tree, blk, x, mask = _inputs(0, s)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jm = jnp.asarray(mask)
    if route == "layer":
        names = tea._LAYER
        fn = lambda p, xx: jea.fused_layer(p, xx, jm, H, EPS, variant, True)  # noqa: E731
    else:
        names = tea._BLOCK
        jt = {k: jt[k] for k in ("ln1", "attn", "ln2")}
        fn = lambda p, xx: jea.fused_block_attention(p, xx, jm, H, EPS, variant, True)  # noqa: E731
    ref, vjp = jax.vjp(fn, jt, jnp.asarray(x))
    outs = ref if isinstance(ref, (tuple, list)) else (ref,)
    gs = [rs.randn(*o.shape).astype(np.float32) for o in outs]
    jgrads, jdx = vjp(tuple(map(jnp.asarray, gs)) if len(gs) > 1 else jnp.asarray(gs[0]))

    tx = torch.from_numpy(x).requires_grad_()
    if route == "layer":
        got = (tea.fused_layer(blk, tx, torch.from_numpy(mask), H, EPS, variant),)
    else:
        got = tea.fused_block_attention(blk, tx, torch.from_numpy(mask), H, EPS, variant)
    for g, r in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=ATOL)
    torch.autograd.backward(got, [torch.from_numpy(g) for g in gs])
    _check_grads(blk, names, jgrads, tx, jdx)
    assert not (tx.grad[2] == 0).all()


def test_fused_ln_attention_gradients_match_jax_custom_vjp():
    """K6 (`fused_ln_attention`): the LayerNorm and QKV parameters' and x's
    gradients.  The all-masked clip reaches its output only through the
    attention, so its dx is JAX's nonzero value."""
    rs, tree, blk, x, mask = _inputs(1, 40)
    jm = jnp.asarray(mask)
    ln, qkv = (jax.tree_util.tree_map(jnp.asarray, t) for t in (tree["ln1"], tree["attn"]["qkv"]))
    ref, vjp = jax.vjp(lambda lp, qp, xx: jea.fused_ln_attention(lp, qp, xx, jm, H, EPS, True),
                       ln, qkv, jnp.asarray(x))
    g = rs.randn(*ref.shape).astype(np.float32)
    d_ln, d_qkv, jdx = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    got = tea.fused_ln_attention(blk.ln1, blk.attn.qkv, tx, torch.from_numpy(mask), H, EPS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL)
    got.backward(torch.from_numpy(g))
    _check_grads(blk, tea._LN_QKV, {"ln1": d_ln, "attn": {"qkv": d_qkv}}, tx, jdx)
    assert float(tx.grad[2].abs().max()) > 1e-3
    assert blk.attn.o.w.grad is None and blk.mlp.w1.w.grad is None  # not K6's parameters


def test_inference_encoder_gradients_match_jax():
    """`audio_encoder_apply(train=False)` at caco_tiny (every layer K1, as in
    JAX): d(loss)/d(every encoder parameter) and d/d(patches), loss = Σ
    hidden · w for a fixed w, one clip with no valid patch."""
    jc, tc = jcfg.caco_tiny().audio, tcfg.caco_tiny().audio
    tree = jax.tree_util.tree_map(np.asarray, jaudio.audio_encoder_init(jax.random.PRNGKey(3), jc))
    enc = taudio.AudioEncoder(tc)
    enc.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jax_state_dict(tree).items()})
    rs = np.random.RandomState(2)
    s = 48
    mask = _mask([s, 20, 0], s)
    inds = np.arange(s, dtype=np.int32)[None, :] * mask
    patches = (rs.randn(3, s, tc.patch_size) * mask[..., None]).astype(np.float32)
    w = rs.randn(3, s, tc.hidden_size).astype(np.float32)
    t_inds, f_inds = inds // 8, inds % 8
    assert tea.layer_route(s, tc.hidden_size, tc.intermediate_size, torch.float32)[0] == "k1"

    def loss(p, pt):
        h = jaudio.audio_encoder_apply(p, jc, pt, jnp.asarray(t_inds), jnp.asarray(f_inds),
                                       jnp.asarray(mask))
        return jnp.sum(h * w)

    jgrads, jdp = jax.grad(loss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, tree),
                                                 jnp.asarray(patches))
    tp = torch.from_numpy(patches).requires_grad_()
    h = taudio.audio_encoder_apply(enc, tc, tp, torch.from_numpy(t_inds), torch.from_numpy(f_inds),
                                   torch.from_numpy(mask))
    (h * torch.from_numpy(w)).sum().backward()
    flat = jax_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in enc.named_parameters():
        _close(p.grad, flat[name], name)
    _close(tp.grad, jdp, "patches")
