"""The port's KV-cached decode against the JAX package at caco_tiny
(vocab 300), same weights (bridged from a JAX `caco_init`) and same numpy
inputs: the cached attention branch, `_decode_bias`, `precompute_cross_kv`,
one decode step, `decode` at top_k=1, `sample_logits`, and
`CacoEngine.caption`.

JAX kernels reached: the audio encoder takes K1 / K2 (`try_fused_layer`,
Pallas interpret mode) in every layer of decode's audio pass; decode's own
attention is einsums in JAX as in the port.  torch cannot draw JAX's random
numbers, so sampling is held by its admissible sets and its frequencies,
and decode token for token at top_k=1 (and at T = 1e-4 through the
engines).  Tolerances: fp32 1e-6 on the attention branch (summation order),
1e-5 on logits (summation order through 4 layers); bf16 one bf16 rounding
step of the largest value (2^-7 of it) on one attention call, 3e-2 on the
first step's logits (bf16 elementwise chains rounded at other places
through 4 layers, as tests/test_torch_models.py bounds the towers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.data import tokenizer as jtok
from cacophony_tpu.models import caco as jcaco
from cacophony_tpu.models import text as jtext
from cacophony_tpu.ops import attention as jattn
from cacophony_tpu.runtime import CacoEngine as JaxEngine
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax
from cacophony_tpu_torch.data import tokenizer as ttok
from cacophony_tpu_torch.models import caco as tcaco
from cacophony_tpu_torch.models import text as ttext
from cacophony_tpu_torch.models.layers import cast_dense
from cacophony_tpu_torch.ops import attention as tattn
from cacophony_tpu_torch.runtime import CacoEngine

from test_torch_engine import _byte_tokenizer

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BOS, PAD, EOS = 0, 1, 2


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jcfg.caco_tiny(vocab_size=300), tcfg.caco_tiny(vocab_size=300)
    tree = jax.tree_util.tree_map(np.asarray, jcaco.caco_init(jax.random.PRNGKey(0), jc))
    return jc, tc, tree, params_from_jax(tree, tc)


def _audio_batch(rs, b, s, lengths):
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None, :] * mask
    patches = (rs.randn(b, s, 256) * mask[..., None]).astype(np.float32)
    return {"audio_patches": patches, "audio_time_inds": inds // 8,
            "audio_freq_inds": inds % 8, "audio_mask": mask}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


# ------------------------------------------------------ the cached branch

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_cached_attention_matches_jax(dtype, per_sample):
    jd, td = DTYPES[dtype]
    b, t, d, heads = 3, 7, 32, 4
    params = jax.tree_util.tree_map(np.asarray, jattn.attention_init(jax.random.PRNGKey(1), d,
                                                                     heads, stddev=0.3))
    attn = tattn.Attention(d)
    for name in ("qkv", "o"):
        params[name]["b"] = params[name]["b"] + 0.1
        getattr(attn, name).w.data = torch.tensor(params[name]["w"])
        getattr(attn, name).b.data = torch.tensor(params[name]["b"])
    rs = np.random.RandomState(0)
    x = rs.randn(b, 1, d).astype(np.float32)
    ck, cv = (rs.randn(b, t, d).astype(np.float32) for _ in range(2))
    index = np.array([0, 3, 6], np.int32) if per_sample else np.int32(4)
    jbias = jtext._decode_bias(t, jnp.asarray(index))
    tbias = ttext._decode_bias(t, torch.from_numpy(np.asarray(index)))
    ref, ref_kv = jattn.multi_head_attention(
        params, jnp.asarray(x, jd), num_heads=heads, bias=jbias, dtype=jd,
        kv_cache={"k": jnp.asarray(ck, jd), "v": jnp.asarray(cv, jd)})
    got, (k, v) = tattn.multi_head_attention(
        attn, torch.from_numpy(x).to(td), num_heads=heads, bias=tbias, dtype=td,
        kv_cache=(torch.from_numpy(ck).to(td), torch.from_numpy(cv).to(td)))
    assert got.dtype == td and got.shape == (b, 1, d) and k.shape == (b, 1, d)
    ref = _f32(ref)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(_f32(got), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(_f32(k), _f32(ref_kv["k"]), rtol=0, atol=tol)
    np.testing.assert_allclose(_f32(v), _f32(ref_kv["v"]), rtol=0, atol=tol)


@pytest.mark.parametrize("index", [0, 3, 9, [0, 4, 9, 2]])
def test_decode_bias_matches_jax(index):
    index = np.asarray(index, np.int32)
    ref = np.asarray(jtext._decode_bias(9, jnp.asarray(index)))
    got = ttext._decode_bias(9, torch.from_numpy(index)).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------- one step

def _jax_state(jc, rs, b, t, index, generating):
    text = jtext.make_kv_cache(jc.text, b, t)
    dec = jtext.make_kv_cache(jc.decoder, b, t)
    ids = rs.randint(3, jc.decoder.vocab_size, size=(b, t)).astype(np.int32)
    for c in (text, dec):
        c["k"] = jnp.asarray(rs.randn(*c["k"].shape).astype(np.float32))
        c["v"] = jnp.asarray(rs.randn(*c["v"].shape).astype(np.float32))
        c["index"] = jnp.int32(index)
    return jcaco.DecodeState(text, dec, jnp.asarray(ids), jnp.int32(index),
                             jnp.asarray(generating, jnp.int32))


def _torch_state(js):
    index = torch.tensor(int(js.index), dtype=torch.int32)
    caches = [ttext.KVCache(torch.from_numpy(np.array(c["k"])), torch.from_numpy(np.array(c["v"])),
                            index) for c in (js.text_cache, js.dec_cache)]
    return tcaco.DecodeState(*caches, torch.from_numpy(np.array(js.input_ids)), index,
                             torch.from_numpy(np.array(js.is_generating)))


def test_cross_kv_and_one_step_match_jax(tiny):
    """precompute_cross_kv; one step's logits and cache writes from the same
    state; the top_k=1 step: finished streams feed pad and write id 0."""
    jc, tc, tree, model = tiny
    rs = np.random.RandomState(1)
    b, t, s = 4, 12, 24
    batch = _audio_batch(rs, b, s, [24, 10, 17, 3])
    _, jhidden = jcaco.get_audio_embedding(tree, jc, *batch.values(), normalize=False)
    jckv = jtext.precompute_cross_kv(tree["decoder"]["blocks"], jc.decoder, jhidden)
    hidden = torch.tensor(np.asarray(jhidden))
    ckv = ttext.precompute_cross_kv(model.decoder.blocks, tc.decoder, hidden)
    for got, ref in zip(ckv, (jckv["k"], jckv["v"])):  # JAX's merged rows, head-major here
        layers = tc.decoder.num_layers
        ref = np.asarray(ref).reshape(layers, b, s, tc.decoder.num_heads, -1).transpose(0, 1, 3, 2, 4)
        assert got.shape == ref.shape and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)

    js = _jax_state(jc, rs, b, t, 5, [1, 0, 1, 0])
    state = _torch_state(js)
    cur = np.where(np.asarray(js.is_generating) > 0, np.asarray(js.input_ids)[:, 5], PAD)
    pos = jnp.full((b, 1), 5, jnp.int32)
    _, th, jtc = jtext.text_encoder_apply(tree["text"], jc.text, jnp.asarray(cur)[:, None],
                                          jnp.ones((b, 1)), position_ids=pos,
                                          cache=js.text_cache, pool=False)
    jlogits, jdc = jtext.caption_decoder_apply(tree["decoder"], jc.decoder, th, jnp.ones((b, 1)),
                                               None, jnp.asarray(batch["audio_mask"]),
                                               cache=js.dec_cache, cross_kv=jckv)
    fed = []

    def step(current):
        fed.append(current.clone())
        return tcaco.step_logits(model.text, model.decoder, tc, state, current, ckv,
                                 torch.from_numpy(batch["audio_mask"]))

    logits = tcaco.decode_step(step, state, temperature=1.0, eos_id=EOS, pad_id=PAD,
                               generator=torch.Generator().manual_seed(0), top_k=1)
    np.testing.assert_array_equal(fed[0].numpy(), cur)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[:, 0], atol=1e-5)
    for got, ref in ((state.text_cache, jtc), (state.dec_cache, jdc)):
        np.testing.assert_allclose(got.k.numpy(), np.asarray(ref["k"]), atol=1e-6)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(ref["v"]), atol=1e-6)
    assert int(state.index) == 6 and int(jtc["index"]) == 6

    jnext = jcaco.decode_step(tree, jc, js, jckv, jnp.asarray(batch["audio_mask"]),
                              temperature=1.0, eos_id=EOS, pad_id=PAD,
                              rng=jax.random.PRNGKey(0), top_k=1)
    np.testing.assert_array_equal(state.input_ids.numpy(), np.asarray(jnext.input_ids))
    np.testing.assert_array_equal(state.is_generating.numpy(), np.asarray(jnext.is_generating))
    assert (state.input_ids[[1, 3], 6] == 0).all()  # finished streams write id 0


# -------------------------------------------------------------- decode

@pytest.fixture(scope="module")
def greedy(tiny):
    jc, tc, tree, model = tiny
    batch = _audio_batch(np.random.RandomState(2), 4, 24, [24, 16, 9, 20])
    fn = jax.jit(lambda p, bt: jcaco.decode(p, jc, bt, max_length=20, temperature=1.0,
                                            bos_id=BOS, eos_id=EOS, pad_id=PAD,
                                            rng=jax.random.PRNGKey(0), top_k=1))
    return batch, np.asarray(fn(tree, batch))


@pytest.mark.parametrize("one_step_windows", [False, True])
def test_greedy_decode_matches_jax(tiny, greedy, one_step_windows):
    """`decode` (windows of DECODE_WINDOW steps, one check each), and the
    decoder stepped and checked one step at a time, give JAX's ids."""
    jc, tc, tree, model = tiny
    batch, ref = greedy
    dec = tcaco.BatchDecoder(model, tc, _torch(batch), max_length=20, temperature=1.0,
                             bos_id=BOS, eos_id=EOS, pad_id=PAD,
                             generator=torch.Generator().manual_seed(0), top_k=1)
    if one_step_windows:
        while not dec.finished():
            dec.steps(1)
        got = dec.state.input_ids
    else:
        got = dec.run()
    assert got.dtype == torch.int32 and got.shape == (4, 20)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref[:, 1:])) > 5  # the streams did not collapse onto one token


def test_bf16_first_step_logits_match_jax(tiny):
    jc, tc, tree, model = tiny
    import dataclasses
    jc16 = dataclasses.replace(jc, dtype=jnp.bfloat16)
    tc16 = dataclasses.replace(tc, dtype=torch.bfloat16)
    batch = _audio_batch(np.random.RandomState(3), 3, 24, [24, 12, 5])
    jbatch = dict(batch, audio_patches=jnp.asarray(batch["audio_patches"], jnp.bfloat16))
    tbatch = dict(_torch(batch), audio_patches=torch.from_numpy(batch["audio_patches"]).bfloat16())
    _, jhidden = jcaco.get_audio_embedding(tree, jc16, *jbatch.values(), normalize=False)
    jckv = jtext.precompute_cross_kv(tree["decoder"]["blocks"], jc16.decoder, jhidden,
                                     dtype=jnp.bfloat16)
    b = 3
    _, th, _ = jtext.text_encoder_apply(
        tree["text"], jc16.text, jnp.full((b, 1), BOS, jnp.int32), jnp.ones((b, 1)),
        position_ids=jnp.zeros((b, 1), jnp.int32),
        cache=jtext.make_kv_cache(jc16.text, b, 10, jnp.bfloat16), pool=False, dtype=jnp.bfloat16)
    ref, _ = jtext.caption_decoder_apply(
        tree["decoder"], jc16.decoder, th, jnp.ones((b, 1)), None,
        jnp.asarray(batch["audio_mask"]), cache=jtext.make_kv_cache(jc16.decoder, b, 10,
                                                                    jnp.bfloat16),
        cross_kv=jckv, dtype=jnp.bfloat16)
    with torch.inference_mode():
        dec = tcaco.BatchDecoder(model, tc16, tbatch, max_length=10, temperature=1.0,
                                 bos_id=BOS, eos_id=EOS, pad_id=PAD,
                                 generator=torch.Generator().manual_seed(0), top_k=1)
        assert dec.state.text_cache.k.dtype == torch.bfloat16 and dec.cross_kv[0].dtype == \
            torch.bfloat16
        dec.steps(1)
    np.testing.assert_allclose(dec.logits.numpy(), _f32(ref)[:, 0], atol=3e-2)


def test_teacher_forced_logits_match_stepwise(tiny):
    """The port's caption_logits on the produced tokens against its own
    cached step logits (the port's form of tests/test_parity.py:258)."""
    jc, tc, tree, model = tiny
    batch = _torch(_audio_batch(np.random.RandomState(4), 3, 24, [24, 13, 7]))
    steps = []
    with torch.inference_mode():
        dec = tcaco.BatchDecoder(model, tc, batch, max_length=12, temperature=1.0, bos_id=BOS,
                                 eos_id=EOS, pad_id=PAD, generator=torch.Generator().manual_seed(1))
        while dec.steps_left:
            dec.steps(1)
            steps.append(dec.logits.clone())
        ids = dec.state.input_ids
        _, hidden = tcaco.get_audio_embedding(model, tc, *batch.values(), normalize=False)
        full = tcaco.caption_logits(model, tc, ids[:, :-1], torch.ones_like(ids[:, :-1]), hidden,
                                    batch["audio_mask"])
    stepwise = torch.stack(steps, dim=1)
    assert stepwise.shape == full.shape == (3, 11, 300)
    np.testing.assert_allclose(stepwise.numpy(), full.numpy(), atol=1e-5)


# ------------------------------------------------------------ sampling

def _jax_support(logits, n=2000, **kw):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    draws = jax.vmap(lambda k: jcaco.sample_logits(k, jnp.asarray(logits)[None], **kw)[0])(keys)
    return set(np.asarray(draws).tolist())


@pytest.mark.parametrize("kw", [dict(top_k=2), dict(top_k=3), dict(top_p=0.6), dict(top_p=0.8),
                                dict(top_k=4, top_p=0.7), dict(temperature=2.0, top_p=0.75)])
def test_sampling_admissible_sets_match_jax(kw):
    """Ties at the k-th value stay in (JAX keeps logits ≥ the k-th), and the
    nucleus cutoff is sorted[sum(cum < p)]."""
    logits = np.log(np.array([0.3, 0.2, 0.2, 0.14, 0.1, 0.06], np.float32))
    ref = _jax_support(logits, **kw)
    masked = tcaco.filter_logits(torch.from_numpy(logits)[None], **kw)[0]
    got = set(torch.nonzero(torch.isfinite(masked)).flatten().tolist())
    assert got == ref
    draws = tcaco.sample_logits(torch.Generator().manual_seed(0),
                                torch.from_numpy(logits).expand(2000, 6), **kw)
    assert set(draws.tolist()) == ref


@pytest.mark.parametrize("kw", [dict(), dict(top_k=3), dict(top_p=0.7), dict(temperature=0.5)])
def test_sampling_frequencies(kw):
    logits = torch.tensor([[1.2, 0.4, 0.4, -0.3, 0.9, -1.0]])
    n = 20_000
    draws = tcaco.sample_logits(torch.Generator().manual_seed(3), logits.expand(n, 6), **kw)
    assert draws.dtype == torch.int32
    freq = np.bincount(draws.numpy(), minlength=6) / n
    expect = torch.softmax(tcaco.filter_logits(logits, **kw), dim=-1)[0].numpy()
    np.testing.assert_allclose(freq, expect, atol=0.02)
    assert (freq[expect == 0] == 0).all()


def test_top_k_one_is_argmax():
    logits = torch.randn(64, 300, generator=torch.Generator().manual_seed(0))
    got = tcaco.sample_logits(torch.Generator().manual_seed(0), logits, top_k=1)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1).numpy())


def test_cast_dense_shares_norms_and_tables(tiny):
    jc, tc, tree, model = tiny
    cast = cast_dense(model.text, torch.bfloat16)
    assert cast.blocks[0].attn.qkv.w.dtype == torch.bfloat16
    assert torch.equal(cast.blocks[0].attn.qkv.w, model.text.blocks[0].attn.qkv.w.bfloat16())
    assert cast.blocks[0].ln_attn is model.text.blocks[0].ln_attn
    assert cast.embeddings.word is model.text.embeddings.word


# -------------------------------------------------------------- engine

def test_engine_caption_matches_jax(tiny):
    jc, tc, tree, model = tiny
    kw = dict(buffer_seconds=1.0, max_text_len=16, batch_size=4)
    jax_engine = JaxEngine(jc, tree, tokenizer=_byte_tokenizer(jtok), **kw)
    engine = CacoEngine(tc, params_from_jax(tree, tc), tokenizer=_byte_tokenizer(ttok),
                        device="cpu", **kw)
    rs = np.random.RandomState(5)
    wavs = [(0.3 * rs.randn(n)).astype(np.float32) for n in (8000, 16000, 5000, 12000, 3000)]
    ref = jax_engine.caption(wavs, max_length=12, temperature=1e-4, seed=0)
    got = engine.caption(wavs, max_length=12, temperature=1e-4, seed=0)
    assert len(got) == 5 and got == ref
    assert len(set(got)) > 1


def test_decoder_is_freed_without_the_cycle_collector(tiny):
    """A decoder holds no reference cycle (its step does not refer back to
    it), so on the card its CUDA graph is freed when the decoder is, never
    by a garbage collection that could run during another graph's capture."""
    import weakref

    jc, tc, tree, model = tiny
    batch = _torch(_audio_batch(np.random.RandomState(6), 2, 24, [24, 9]))
    dec = tcaco.BatchDecoder(model, tc, batch, max_length=6, temperature=1.0, bos_id=BOS,
                             eos_id=EOS, pad_id=PAD, generator=torch.Generator().manual_seed(0))
    dec.run()
    ref = weakref.ref(dec)
    del dec
    assert ref() is None
