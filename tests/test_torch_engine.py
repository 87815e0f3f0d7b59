"""The port's CacoEngine (embed_audio, embed_texts, score) against the JAX
CacoEngine at caco_tiny with a byte-level tokenizer, and the port's copy of
the tokenizer against the JAX package's.

JAX kernels reached: K1 (`try_fused_layer`, Pallas interpret mode) in every
audio layer; nothing else (the fused frontend K8 is off by default).
Tolerances on the normalized embeddings: fp32 2e-5 (summation order), bf16
1e-2 (bf16 elementwise chains rounded at other places, through 2 layers,
two poolers and a normalize); scores ×exp(2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.data import tokenizer as jtok
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu.runtime import CacoEngine as JaxEngine
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax
from cacophony_tpu_torch.data import tokenizer as ttok
from cacophony_tpu_torch.runtime import CacoEngine

torch.set_num_threads(2)

TEXTS = ["a dog barking", "rain on a window", "a trumpet solo",
         "café ☕ naïve, don't stop!", "wind"]
TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _byte_tokenizer(module, merges=()):
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in module._bytes_to_unicode().values():
        vocab[c] = len(vocab)
    for a, b in merges:
        vocab[a + b] = len(vocab)
    return module.ByteLevelBPETokenizer(vocab, list(merges))


def test_tokenizer_copy_matches_jax_package():
    merges = [("h", "e"), ("he", "l"), ("hel", "l"), ("Ġ", "d"), ("Ġd", "o"), ("o", "r")]
    ours, theirs = _byte_tokenizer(ttok, merges), _byte_tokenizer(jtok, merges)
    texts = TEXTS + ["hello hello world", "  two  spaces ", "tab\there\n1234 567 's"]
    for max_length in (8, 32):
        a = ours(texts, padding="max_length", truncation=True, max_length=max_length)
        b = theirs(texts, padding="max_length", truncation=True, max_length=max_length)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[k], b[k])
        assert ours.batch_decode(a["input_ids"]) == theirs.batch_decode(b["input_ids"])


@pytest.fixture(scope="module")
def engines():
    jc, tc = jcfg.caco_tiny(vocab_size=300), tcfg.caco_tiny(vocab_size=300)
    jparams = jax_caco_init(jax.random.PRNGKey(0), jc)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tc)
    kw = dict(buffer_seconds=1.0, max_text_len=24, batch_size=4)
    out = {}
    for name, jd, td in (("float32", None, None), ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        out[name] = (JaxEngine(jc, jparams, tokenizer=_byte_tokenizer(jtok), dtype=jd, **kw),
                     CacoEngine(tc, model, tokenizer=_byte_tokenizer(ttok), dtype=td, **kw))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_embed_and_score_match_jax(engines, dtype):
    """6 clips, batch 4: the second bucket holds 2 clips and 2 zero-length
    padding clips (all-zero mask); one clip is longer than the buffer."""
    jax_engine, engine = engines[dtype]
    rs = np.random.RandomState(0)
    wavs = [(0.1 * rs.randn(n)).astype(np.float32)
            for n in (16_000, 4_000, 9_000, 20_000, 100, 12_000)]
    a_ref, a_got = jax_engine.embed_audio(wavs), engine.embed_audio(wavs)
    assert a_got.shape == (6, 32) and np.isfinite(a_got).all()
    np.testing.assert_allclose(np.linalg.norm(a_got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(a_got, a_ref, atol=TOL[dtype])

    t_ref, t_got = jax_engine.embed_texts(TEXTS), engine.embed_texts(TEXTS)
    assert t_got.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(t_got, t_ref, atol=TOL[dtype])

    s_ref, s_got = jax_engine.score(a_ref, t_ref), engine.score(a_got, t_got)
    assert s_got.shape == (6, len(TEXTS))
    np.testing.assert_allclose(s_got, s_ref, atol=np.exp(2.0) * 2 * TOL[dtype])


def test_engine_bucketing_does_not_change_results(engines):
    _, engine = engines["float32"]
    rs = np.random.RandomState(1)
    wavs = [(0.1 * rs.randn(n)).astype(np.float32) for n in (8_000, 5_000, 16_000)]
    np.testing.assert_allclose(engine.embed_audio(wavs[:1])[0], engine.embed_audio(wavs)[0],
                               atol=1e-6)
    assert engine.embed_audio([]).shape == (0, 32)
    assert engine.patch.patches_seq_len == 48  # 1 s: ceil(16000/160)//16 · 8
