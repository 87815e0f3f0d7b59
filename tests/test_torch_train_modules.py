"""The training pieces of the port against the JAX package: the custom
backwards of `layer_norm` and `act_dense`, dropout and drop-path, the
caption decoder, the three losses, the optimizer with its decay mask, the
text tower's position clamp, the training frontend's patch subsampling,
and the bridge's inverse.

No JAX kernel is reached: the decoder and the text tower run the einsum
attention (`TEXT_ATTN_KERNEL = False`).  Inputs come from numpy.
Tolerances: fp32 1e-5 absolute on values of magnitude ~1 (fp32 sums in
another order) unless a test says otherwise; bf16 one or two bf16 steps,
as each test states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.data import pipeline as jpipe
from cacophony_tpu.models import caco as jcaco
from cacophony_tpu.models import layers as jlayers
from cacophony_tpu.models import text as jtext
from cacophony_tpu.train import losses as jlosses
from cacophony_tpu.train import train as jtrain
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import (
    decay_mask,
    jax_state_dict,
    params_from_jax,
    params_to_jax,
)
from cacophony_tpu_torch.data import pipeline as tpipe
from cacophony_tpu_torch.models import layers as tlayers
from cacophony_tpu_torch.models import text as ttext
from cacophony_tpu_torch.train import losses as tlosses
from cacophony_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jcfg.caco_tiny(), tcfg.caco_tiny()
    tree = jax.tree_util.tree_map(np.asarray, jcaco.caco_init(jax.random.PRNGKey(0), jc))
    return jc, tc, tree


def _np(t):
    return t.detach().float().numpy()


def _bf16_steps(got, ref, steps, atol=0.0):
    """|got − ref| within `steps` bf16 units in the last place of ref, plus atol."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= steps * ulp + atol).all(), np.abs(got - ref).max()


# ------------------------------------------------------- custom backwards

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_backward_matches_jax_custom_vjp(dtype):
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(0)
    x = (2 + rs.randn(4, 6, 32)).astype(np.float32)
    scale, bias = (1 + 0.1 * rs.randn(32)).astype(np.float32), (0.1 * rs.randn(32)).astype(np.float32)
    g = rs.randn(4, 6, 32).astype(np.float32)
    ref, vjp = jax.vjp(lambda x_, s_, b_: jlayers.layer_norm({"scale": s_, "bias": b_}, x_, 1e-5),
                       jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias))
    rdx, rds, rdb = vjp(jnp.asarray(g, jd))
    ln = tlayers.LayerNorm(32)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    out = tlayers.layer_norm(ln, tx, 1e-5)
    out.backward(torch.from_numpy(g).to(td))
    if dtype == "float32":
        for got, want in ((out, ref), (tx.grad, rdx), (ln.scale.grad, rds), (ln.bias.grad, rdb)):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=1e-5)
    else:  # the same fp32 formula, rounded once to bf16 (dscale, dbias stay fp32)
        _bf16_steps(_np(out), ref, 1)
        _bf16_steps(_np(tx.grad), rdx, 1)
        np.testing.assert_allclose(_np(ln.scale.grad), np.asarray(rds), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(ln.bias.grad), np.asarray(rdb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_dense_backward_matches_jax_custom_vjp(dtype, act):
    """dW and db in the compute dtype (bf16-rounded in bf16), dh through
    the recomputed activation.  bf16: 2^-7 relative plus one bf16 step at
    the scale of the tensor's largest value, 2^-8·max|ref| (bf16 sums in
    another order; a near-cancelled sum carries the rounding of its largest
    terms, and the activation's VJP rounds at other places in XLA)."""
    jd, td = DTYPES[dtype]
    jact = {"silu": jax.nn.silu, "gelu": jlayers.gelu_exact}[act]
    tact = {"silu": tlayers.silu, "gelu": tlayers.gelu_exact}[act]
    rs = np.random.RandomState(1)
    w, b = (rs.randn(24, 16) / 5).astype(np.float32), (0.1 * rs.randn(16)).astype(np.float32)
    h = rs.randn(3, 5, 24).astype(np.float32)
    g = rs.randn(3, 5, 16).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, h_: jlayers.act_dense(p, h_, jact, jd),
                       {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(h, jd))
    rp, rh = vjp(jnp.asarray(g, jd))
    dense = tlayers.Dense(24, 16)
    with torch.no_grad():
        dense.w.copy_(torch.from_numpy(w))
        dense.b.copy_(torch.from_numpy(b))
    th = torch.from_numpy(h).to(td).requires_grad_()
    out = tlayers.act_dense(dense, th, tact, td)
    out.backward(torch.from_numpy(g).to(td))
    assert dense.w.grad.dtype == torch.float32 and th.grad.dtype == td
    pairs = ((out, ref), (dense.w.grad, rp["w"]), (dense.b.grad, rp["b"]), (th.grad, rh))
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), want, atol=1e-5)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7,
                                       atol=2.0 ** -8 * np.abs(want).max())


# ------------------------------------------------------- dropout, drop-path

def test_dropout_and_drop_path_rate_zero_and_eval_are_the_identity():
    x = torch.randn(4, 8)
    g = torch.Generator().manual_seed(0)
    for fn in (tlayers.dropout, tlayers.drop_path):
        assert fn(g, x, 0.0, False) is x and fn(g, x, 0.5, True) is x


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_a_binomial_share_scaled_and_seeded(rate):
    x = torch.rand(200, 500) + 0.5  # no zeros of its own
    out = tlayers.dropout(torch.Generator().manual_seed(3), x, rate, False)
    kept = out != 0
    n, p = x.numel(), 1.0 - rate
    assert abs(kept.sum().item() - n * p) <= 5 * (n * p * rate) ** 0.5  # 5 sigma
    torch.testing.assert_close(out[kept], x[kept] / (1.0 - rate), rtol=0, atol=0)
    again = tlayers.dropout(torch.Generator().manual_seed(3), x, rate, False)
    assert torch.equal(again, out)
    other = tlayers.dropout(torch.Generator().manual_seed(4), x, rate, False)
    assert not torch.equal(other != 0, kept)


def test_dropout_and_drop_path_gradient_is_zero_where_dropped():
    x = torch.randn(64, 3, 8, requires_grad=True)
    out = tlayers.dropout(torch.Generator().manual_seed(5), x, 0.3, False)
    out.sum().backward()
    kept = out.detach() != 0
    assert (x.grad[~kept] == 0).all()
    torch.testing.assert_close(x.grad[kept], torch.full_like(x.grad[kept], 1 / 0.7))
    x.grad = None
    out = tlayers.drop_path(torch.Generator().manual_seed(6), x, 0.5, False)
    out.sum().backward()
    dropped = (out.detach() == 0).all(dim=(1, 2))
    assert 10 < dropped.sum() < 54  # whole samples dropped, about half of them
    assert (x.grad[dropped] == 0).all()
    assert torch.equal(x.grad[~dropped], torch.full_like(x.grad[~dropped], 2.0))


# ----------------------------------------------------------- text towers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_caption_decoder_matches_jax(tiny, dtype):
    """Full-mode (teacher-forced) logits at caco_tiny.  bf16: 3e-2 absolute
    plus 2^-6 relative, as the text tower's tests (two bf16 rounding steps
    where XLA and PyTorch round gelu and the residual sums differently)."""
    jc, tc, tree = tiny
    jd, td = DTYPES[dtype]
    model = params_from_jax(tree, tc)
    rs = np.random.RandomState(2)
    text_h = rs.randn(3, 11, 32).astype(np.float32)
    tmask = (np.arange(11)[None] < np.array([11, 7, 1])[:, None]).astype(np.int32)
    audio_h = rs.randn(3, 20, 32).astype(np.float32)
    amask = (np.arange(20)[None] < np.array([20, 9, 0])[:, None]).astype(np.int32)
    ref, _ = jtext.caption_decoder_apply(tree["decoder"], jc.decoder, jnp.asarray(text_h, jd),
                                         jnp.asarray(tmask), jnp.asarray(audio_h, jd),
                                         jnp.asarray(amask), dtype=jd)
    with torch.no_grad():
        got = ttext.caption_decoder_apply(model.decoder, tc.decoder,
                                          torch.from_numpy(text_h).to(td), torch.from_numpy(tmask),
                                          torch.from_numpy(audio_h).to(td),
                                          torch.from_numpy(amask), dtype=td)
    assert got.shape == (3, 11, tc.decoder.vocab_size) and got.dtype == td
    atol, rtol = (1e-5, 0.0) if dtype == "float32" else (3e-2, 2.0 ** -6)
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def test_text_positions_past_the_table_clamp_to_its_last_row(tiny):
    """70 tokens against the 64-row position table: JAX's gather clamps
    positions 64…69 to row 63, and so does the port (it raised before)."""
    jc, tc, tree = tiny
    model = params_from_jax(tree, tc)
    rs = np.random.RandomState(3)
    ids = rs.randint(4, 128, (2, 70)).astype(np.int32)
    mask = (np.arange(70)[None] < np.array([70, 66])[:, None]).astype(np.int32)
    assert tc.text.max_position_embeddings == 64
    ref_pool, ref_h, _ = jtext.text_encoder_apply(jax.tree_util.tree_map(jnp.asarray, tree["text"]),
                                                  jc.text, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got_pool, got_h = ttext.text_encoder_apply(model.text, tc.text, torch.from_numpy(ids),
                                                   torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got_h), np.asarray(ref_h), atol=1e-5)
    np.testing.assert_allclose(_np(got_pool), np.asarray(ref_pool), atol=1e-5)


# ---------------------------------------------------------------- losses

def test_losses_match_jax():
    rs = np.random.RandomState(4)
    a = rs.randn(6, 16).astype(np.float32)
    t = rs.randn(6, 16).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    ref = jlosses.clip_contrastive_loss(jnp.asarray(a), jnp.asarray(t), jnp.float32(2.0))
    got = tlosses.clip_contrastive_loss(torch.from_numpy(a), torch.from_numpy(t), torch.tensor(2.0))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)

    logits = (3 * rs.randn(3, 7, 50)).astype(np.float32)
    ids = rs.randint(0, 50, (3, 7)).astype(np.int32)
    mask = (np.arange(7)[None] < np.array([7, 3, 0])[:, None]).astype(np.int32)
    ref = jlosses.caption_cross_entropy(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask))
    got = tlosses.caption_cross_entropy(*map(torch.from_numpy, (logits, ids, mask)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    zero = tlosses.caption_cross_entropy(torch.from_numpy(logits), torch.from_numpy(ids),
                                         torch.zeros(3, 7, dtype=torch.int32))
    assert float(zero) == 0.0  # no real token: the mask-weighted mean divides by max(0, 1)

    pred = rs.randn(2, 9, 16).astype(np.float32)
    true = (2 + rs.randn(2, 9, 16)).astype(np.float32)
    lmask = rs.randint(0, 2, (2, 9)).astype(np.int32)
    for norm in (False, True):
        ref = jlosses.mae_reconstruction_loss(jnp.asarray(pred), jnp.asarray(true),
                                              jnp.asarray(lmask), norm)
        got = tlosses.mae_reconstruction_loss(*map(torch.from_numpy, (pred, true, lmask)), norm)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# ------------------------------------------------------------- optimizer

def test_decay_mask_follows_the_rank_of_the_jax_leaf(tiny):
    """`ndim >= 2` on the JAX tree: block biases and block LayerNorms carry
    the layer axis there and ARE decayed; top-level 1-D leaves are not."""
    _, tc, tree = tiny
    model = params_from_jax(tree, tc)
    mask = decay_mask(model)
    for name, leaf in jax_state_dict(jax.tree_util.tree_map(
            lambda x: np.broadcast_to(np.ndim(x) >= 2, np.shape(x)[:1] or (1,)), tree)).items():
        assert mask[name] == bool(np.asarray(leaf).reshape(-1)[0]), name
    assert mask["audio.blocks.0.ln1.scale"] and mask["decoder.blocks.1.cross.kv.b"]
    assert not mask["audio.ln_f.scale"] and not mask["text.embeddings.ln.bias"]
    assert not mask["audio.patch_proj.b"] and not mask["text_proj.b"] and not mask["logit_scale"]
    assert mask["audio.patch_proj.w"] and mask["text.embeddings.word"]


@pytest.mark.parametrize("mu_dtype", ["bfloat16", None])
def test_optimizer_matches_the_optax_chain(tiny, mu_dtype):
    """Five updates on random gradients (steps 0, 2, 4 above the clipping
    norm, 1 and 3 below it) with warmup 2: parameters, the first moment
    (bf16 by default) and the second.  Tolerance 1e-6 relative + 1e-8
    absolute (fp32 elementwise arithmetic; XLA may contract a multiply-add
    that PyTorch rounds twice; 1e-9 absolute on moments ~1e-3); the bf16
    moment within one bf16 step, and with it the parameters within two
    updates' share of one bf16 step of the moment, 2·lr·2^-8.  The optax update is jitted, as in the
    JAX train step: its bf16-moment arithmetic differs from the eager one."""
    _, tc, tree = tiny
    model = params_from_jax(tree, tc)
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=6,
               adam_mu_dtype=mu_dtype)
    j_opt = jtrain.make_optimizer(jtrain.TrainConfig(**cfg))
    t_tc = ttrain.TrainConfig(**cfg)
    t_opt = ttrain.make_optimizer(t_tc)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = j_opt.init(params)
    j_update = jax.jit(j_opt.update)
    t_state = t_opt.init(model)
    names = [n for n, _ in model.named_parameters()]
    rs = np.random.RandomState(5)
    for i in range(5):
        grads = jax.tree_util.tree_map(lambda x: np.asarray(rs.randn(*np.shape(x))), tree)
        scale = (0.5 if i % 2 else 3.0) / float(optax.global_norm(grads))
        grads = jax.tree_util.tree_map(lambda x: np.asarray(scale * x, np.float32), grads)
        updates, j_state = j_update(jax.tree_util.tree_map(jnp.asarray, grads), j_state, params)
        params = optax.apply_updates(params, updates)
        flat = jax_state_dict(grads)
        tg = [torch.from_numpy(np.array(flat[n])) for n in names]
        t_state = t_opt.update(model, tg, t_state, ttrain.global_norm(tg))
        norm = float(optax.global_norm(grads))
        assert (norm > t_tc.max_grad_norm) == (i % 2 == 0)
    got = jax_state_dict(params_to_jax(model))
    # a bf16 moment whose fp32 value, summed in another order, falls on the
    # other side of a rounding boundary moves later updates by lr·2^-8 each
    atol = 1e-8 if mu_dtype is None else 2 * cfg["learning_rate"] * 2.0 ** -8
    for n, leaf in jax_state_dict(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(got[n], leaf, rtol=1e-6, atol=atol, err_msg=n)
    adam = j_state[1][0]
    mu = jax_state_dict(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), adam.mu))
    nu = jax_state_dict(jax.tree_util.tree_map(np.asarray, adam.nu))
    want_dtype = torch.bfloat16 if mu_dtype else torch.float32
    for n, m, v in zip(names, t_state.mu, t_state.nu):
        assert m.dtype == want_dtype
        if mu_dtype:
            _bf16_steps(_np(m), mu[n], 1, atol=1e-9)
        else:
            np.testing.assert_allclose(_np(m), mu[n], rtol=1e-6, atol=1e-9, err_msg=n)
        np.testing.assert_allclose(_np(v), nu[n], rtol=1e-6, atol=1e-12, err_msg=n)
    assert t_state.count == 5


def test_learning_rate_schedule_matches_optax():
    for warmup, total in ((3, 10), (1, 5), (0, 4), (1000, 100_000)):
        tc = ttrain.TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
        w = min(warmup, max(0, total - 1))
        sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, w, total)
        for count in (0, 1, 2, 3, w, total - 1, total, total + 5, 500, 5000):
            np.testing.assert_allclose(ttrain.learning_rate(tc, count),
                                       float(sched(jnp.int32(count))), rtol=1e-6, atol=1e-12)
    assert ttrain.learning_rate(ttrain.TrainConfig(), 0) == 0.0  # step 0 moves nothing


# ---------------------------------------------------------- bridge, frontend

def test_params_to_jax_inverts_the_bridge(tiny):
    _, tc, tree = tiny
    back = params_to_jax(params_from_jax(tree, tc))
    flat_ref = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert set(flat_ref) == set(flat_got)
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)


def _patch_batch(rs, s_full, lengths):
    mask = (np.arange(s_full)[None] < np.array(lengths)[:, None]).astype(np.int32)
    inds = np.arange(s_full, dtype=np.int32)[None] * mask
    return {"audio_patches": (rs.randn(len(lengths), s_full, 256) * mask[..., None]).astype(np.float32),
            "audio_time_inds": inds // 8, "audio_freq_inds": inds % 8, "audio_mask": mask}


def test_subsample_patches_is_first_n_for_short_clips_and_matches_jax():
    rs = np.random.RandomState(6)
    batch = _patch_batch(rs, 80, [80 - 16, 40, 0])  # every clip at or below seq_len 64
    ref = jpipe.subsample_patches(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()},
                                  64)
    got = tpipe.subsample_patches(torch.Generator().manual_seed(0),
                                  {k: torch.from_numpy(v) for k, v in batch.items()}, 64)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["audio_patches"].numpy(), batch["audio_patches"][:, :64])


def test_subsample_patches_keeps_a_sorted_valid_subset_of_long_clips():
    rs = np.random.RandomState(7)
    batch = _patch_batch(rs, 200, [200, 150, 30])
    got = tpipe.subsample_patches(torch.Generator().manual_seed(1),
                                  {k: torch.from_numpy(v) for k, v in batch.items()}, 64)
    pos = got["audio_time_inds"] * 8 + got["audio_freq_inds"]
    for i, n in enumerate([200, 150, 30]):
        valid = got["audio_mask"][i].numpy() > 0
        assert valid.sum() == min(n, 64)
        p = pos[i].numpy()[valid]
        assert (np.diff(p) > 0).all() and (p < n).all()  # sorted, distinct, valid patches
        np.testing.assert_array_equal(got["audio_patches"][i].numpy()[valid],
                                      batch["audio_patches"][i][p])
    assert not np.array_equal(pos[0].numpy(), np.arange(64))  # a random subset, not first-N


def test_remat_encoder_gives_the_same_loss_and_gradients(tiny):
    """`TrainConfig.remat_encoder` recomputes the audio tower in the
    backward (`torch.utils.checkpoint`): with audio dropout and drop-path
    on, the recomputation draws the same masks, and the text tower after it
    continues the generator's stream where the audio tower left it — so the
    loss and every gradient equal the run without remat."""
    _, tc, tree = tiny
    audio = dataclasses.replace(tc.audio, dropout_rate=0.2, drop_path_rate=0.1)
    cfg = dataclasses.replace(tc, audio=audio)
    rs = np.random.RandomState(8)
    batch = _patch_batch(rs, 24, [24, 10])
    batch["text_input_ids"] = rs.randint(4, 128, (2, 9)).astype(np.int32)
    batch["text_mask"] = (np.arange(9)[None] < np.array([9, 5])[:, None]).astype(np.int32)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for remat in (False, True):
        model = params_from_jax(tree, cfg)
        loss_fn = ttrain.make_caco_loss(cfg, ttrain.TrainConfig(remat_encoder=remat))
        gen = torch.Generator().manual_seed(9)
        loss, _ = loss_fn(model, batch, gen)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in model.parameters()],
                    torch.rand(1, generator=gen)))
    (l0, g0, r0), (l1, g1, r1) = out
    assert torch.equal(l0, l1) and torch.equal(r0, r1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
