"""The port's towers and embeddings against the JAX package, same weights
(bridged from a JAX `caco_init`) and same numpy inputs.

JAX kernels reached: the audio encoder takes K1 (`try_fused_layer`, Pallas
interpret mode) for every layer at these shapes; the text tower runs no
kernel (`TEXT_ATTN_KERNEL = False`, einsum path with the causal bias).
Tolerances: fp32 2e-5 (summation order); bf16 hidden states 3e-2 absolute
plus 2^-6 relative (two bf16 rounding steps: XLA and PyTorch round bf16
elementwise chains such as gelu and the embedding sums at other places),
and 5e-3 on the normalized embeddings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.models import audio as jaudio
from cacophony_tpu.models import caco as jcaco
from cacophony_tpu.models import text as jtext
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import jax_state_dict, params_from_jax
from cacophony_tpu_torch.models import audio as taudio
from cacophony_tpu_torch.models import caco as tcaco
from cacophony_tpu_torch.models import text as ttext

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_HIDDEN = {"float32": 2e-5, "bfloat16": 3e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}
TOL_EMB = {"float32": 2e-5, "bfloat16": 5e-3}


def _pair(jc, tc):
    tree = jax.tree_util.tree_map(np.asarray, jcaco.caco_init(jax.random.PRNGKey(0), jc))
    return tree, params_from_jax(tree, tc)


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jcfg.caco_tiny(vocab_size=300), tcfg.caco_tiny(vocab_size=300)
    tree, model = _pair(jc, tc)
    return jc, tc, tree, model


def _audio_batch(rs, b, s, lengths):
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None, :] * mask
    patches = (rs.randn(b, s, 256) * mask[..., None]).astype(np.float32)
    return patches, inds // 8, inds % 8, mask


def _text_batch(rs, b, s, lengths, vocab):
    ids = rs.randint(4, vocab, size=(b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 1).astype(np.int32), mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref).astype(np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_encoder_and_embedding_match_jax(tiny, dtype):
    jc, tc, tree, model = tiny
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(0)
    batch = _audio_batch(rs, 3, 48, [48, 20, 0])  # one all-masked (padding) clip
    ref_h = jaudio.audio_encoder_apply(tree["audio"], jc.audio, *map(jnp.asarray, batch),
                                       dtype=jd)
    with torch.no_grad():
        got_h = taudio.audio_encoder_apply(model.audio, tc.audio, *_t(*batch), dtype=td)
    assert got_h.dtype == td
    _close(got_h, ref_h, TOL_HIDDEN[dtype], RTOL[dtype])

    ref_e, _ = jcaco.get_audio_embedding(tree, dataclasses.replace(jc, dtype=jd),
                                         *map(jnp.asarray, batch))
    with torch.no_grad():
        got_e, _ = tcaco.get_audio_embedding(model, dataclasses.replace(tc, dtype=td),
                                             *_t(*batch))
    assert got_e.dtype == torch.float32 and torch.isfinite(got_e).all()
    _close(got_e, ref_e, TOL_EMB[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_encoder_and_embedding_match_jax(tiny, dtype):
    jc, tc, tree, model = tiny
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(1)
    ids, mask = _text_batch(rs, 3, 16, [16, 9, 1], 300)
    ref_pool, ref_h, _ = jtext.text_encoder_apply(tree["text"], jc.text, jnp.asarray(ids),
                                                  jnp.asarray(mask), dtype=jd)
    with torch.no_grad():
        got_pool, got_h = ttext.text_encoder_apply(model.text, tc.text, *_t(ids, mask), dtype=td)
    _close(got_h, ref_h, TOL_HIDDEN[dtype], RTOL[dtype])
    _close(got_pool, ref_pool, TOL_HIDDEN[dtype], RTOL[dtype])

    ref_e, _ = jcaco.get_text_embedding(tree, dataclasses.replace(jc, dtype=jd),
                                        jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got_e, _ = tcaco.get_text_embedding(model, dataclasses.replace(tc, dtype=td),
                                            *_t(ids, mask))
    assert got_e.dtype == torch.float32  # text_proj promotes a bf16 pooled vector
    _close(got_e, ref_e, TOL_EMB[dtype])
    ref_s = jcaco.contrastive_logits(tree, ref_e, ref_e)
    _close(tcaco.contrastive_logits(model, got_e, got_e), ref_s, 10 * TOL_EMB[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_encoder_published_width_one_layer(dtype):
    """caco_base widths (768-d, 8 heads of Dh = 96, MLP 3072) with one layer
    at seq 64: the JAX side still takes K1 (its capacity check passes)."""
    audio_j = dataclasses.replace(jcfg.AudioEncoderConfig(), num_layers=1)
    audio_t = dataclasses.replace(tcfg.AudioEncoderConfig(), num_layers=1)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jaudio.audio_encoder_init(jax.random.PRNGKey(1), audio_j))
    enc = taudio.AudioEncoder(audio_t)
    enc.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jax_state_dict(tree).items()})
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(2)
    batch = _audio_batch(rs, 2, 64, [64, 40])
    ref = jaudio.audio_encoder_apply(tree, audio_j, *map(jnp.asarray, batch), dtype=jd)
    with torch.no_grad():
        got = taudio.audio_encoder_apply(enc, audio_t, *_t(*batch), dtype=td)
    _close(got, ref, TOL_HIDDEN[dtype], RTOL[dtype])
