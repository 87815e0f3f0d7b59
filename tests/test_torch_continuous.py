"""The port's continuous captioner against the JAX package at caco_tiny
(vocab 300), same weights and the same byte-level tokenizer: the port forms
of tests/test_continuous.py, each held to the JAX package's captions at a
near-greedy temperature (1e-4: torch cannot draw JAX's random numbers, so
only the argmax path can agree token for token).

JAX kernels reached: K1 / K2 in interpret mode in the audio encoder of the
prefill; the decode step runs none.  Requests: slices of each engine's
`audio_patch_batch` (torch tensors for the port), and numpy dicts.
"""

import jax
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.data import tokenizer as jtok
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu.runtime import CacoEngine as JaxEngine
from cacophony_tpu.runtime.continuous import ContinuousCaptioner as JaxCaptioner
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax
from cacophony_tpu_torch.data import tokenizer as ttok
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.continuous import ContinuousCaptioner

from test_torch_engine import _byte_tokenizer

torch.set_num_threads(2)

T = 1e-4


def _pair(seed, **kw):
    jc, tc = jcfg.caco_tiny(vocab_size=300), tcfg.caco_tiny(vocab_size=300)
    tree = jax.tree_util.tree_map(np.asarray, jax_caco_init(jax.random.PRNGKey(seed), jc))
    kw = dict(dict(buffer_seconds=1.0, batch_size=4, max_text_len=16), **kw)
    jax_engine = JaxEngine(jc, tree, tokenizer=_byte_tokenizer(jtok), **kw)
    engine = CacoEngine(tc, params_from_jax(tree, tc), tokenizer=_byte_tokenizer(ttok),
                        device="cpu", **kw)
    return jax_engine, engine


def _requests(engine, wavs, numpy=False):
    batch, n = engine.audio_patch_batch(wavs)
    if numpy:
        return [{k: np.asarray(v[i:i + 1]) for k, v in batch.items()} for i in range(n)]
    return [{k: v[i:i + 1] for k, v in batch.items()} for i in range(n)]


def _servers(jax_engine, engine, **kw):
    kw = dict(dict(temperature=T, seed=0), **kw)
    return (JaxCaptioner(jax_engine.cfg, jax_engine.params, jax_engine.tokenizer, **kw),
            ContinuousCaptioner(engine.cfg, engine.params, engine.tokenizer, device="cpu", **kw))


@pytest.mark.parametrize("numpy_requests", [False, True])
def test_continuous_matches_jax_batch_decode(numpy_requests):
    """5 clips on 2 slots (refills) against the JAX engine's lockstep
    caption of the same clips."""
    jax_engine, engine = _pair(0, batch_size=8)
    rs = np.random.RandomState(0)
    wavs = [rs.randn(n).astype(np.float32) * 0.3 for n in (8000, 16000, 5000, 12000, 3000)]
    ref = [c.strip() for c in jax_engine.caption(wavs, max_length=10, temperature=T, seed=0)]
    server = ContinuousCaptioner(engine.cfg, engine.params, engine.tokenizer, num_slots=2,
                                 max_length=10, temperature=T, seed=0, device="cpu")
    got = server.run(_requests(engine, wavs, numpy_requests))
    assert len(got) == 5 and all(isinstance(c, str) for c in got)
    assert got == ref
    assert 0 < server.tokens_generated <= 5 * 9


def test_continuous_single_slot_many_requests():
    jax_engine, engine = _pair(1)
    rs = np.random.RandomState(1)
    wavs = [rs.randn(6000).astype(np.float32) * 0.3 for _ in range(3)]
    jserver, server = _servers(jax_engine, engine, num_slots=1, max_length=8)
    ref = jserver.run(_requests(jax_engine, wavs))
    got = server.run(_requests(engine, wavs))
    assert len(got) == 3 and got == ref


def test_continuous_drain_window_invariance():
    """drain_every 1 and 8 give the same captions (the window changes when
    the host looks, not what is computed), equal to JAX's."""
    jax_engine, engine = _pair(3)
    rs = np.random.RandomState(3)
    wavs = [rs.randn(7000).astype(np.float32) * 0.3 for _ in range(4)]
    reqs = _requests(engine, wavs)
    caps = {}
    for k in (1, 8):
        server = ContinuousCaptioner(engine.cfg, engine.params, engine.tokenizer, num_slots=2,
                                     max_length=10, temperature=T, seed=0, drain_every=k,
                                     device="cpu")
        caps[k] = server.run(iter(reqs))  # a generator: pulled lazily
    jserver, _ = _servers(jax_engine, engine, num_slots=2, max_length=10)
    assert caps[1] == caps[8] == jserver.run(_requests(jax_engine, wavs))
    assert len(caps[8]) == 4


def test_continuous_mixed_audio_lengths():
    """Requests of a shorter patch budget are padded into the server's
    (mask-0 padding, as a bucket pads), equal to JAX's; a request over the
    budget raises."""
    jax_engine, engine = _pair(2)
    jax_small, small = _pair(2, buffer_seconds=0.5)
    rs = np.random.RandomState(2)
    wavs = [rs.randn(6000).astype(np.float32) * 0.3 for _ in range(3)]
    big_reqs, small_reqs = _requests(engine, wavs), _requests(small, wavs)
    seq = big_reqs[0]["audio_patches"].shape[1]
    assert small_reqs[0]["audio_patches"].shape[1] < seq
    mixed = [big_reqs[0], small_reqs[1], big_reqs[2]]
    jmixed = [_requests(jax_engine, wavs)[0], _requests(jax_small, wavs)[1],
              _requests(jax_engine, wavs)[2]]
    jserver, server = _servers(jax_engine, engine, num_slots=2, max_length=8, audio_seq_len=seq)
    got = server.run(mixed)
    assert got == jserver.run(jmixed)
    _, server_big = _servers(jax_engine, engine, num_slots=2, max_length=8, audio_seq_len=seq)
    big = server_big.run(big_reqs)
    assert got[0] == big[0] and got[2] == big[2]

    _, tight = _servers(jax_engine, engine, num_slots=2, max_length=8,
                        audio_seq_len=small_reqs[0]["audio_patches"].shape[1])
    with pytest.raises(ValueError, match="exceeds the server budget"):
        tight.run([big_reqs[0]])


def test_continuous_needs_a_card_unless_told_cpu(monkeypatch):
    _, engine = _pair(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousCaptioner(engine.cfg, engine.params, engine.tokenizer)
