"""The port's CacoEngine on the routes beyond the 10-s default, against the
JAX CacoEngine at caco_tiny: the 30-s buffer, embed_audio_long, the fused
frontend, audio_patch_batch, a set `patches_seq_len`, and the bounded
dispatch window.

JAX kernels reached (Pallas interpret mode): at 30 s fp32 the layers take
K3 over 1536 patches, at 30 s bf16 K1 over 1496 — the port takes the same
routes; the fused-frontend engine reaches K8 at 10 s (at 30 s the JAX
engine falls back to its XLA chain, the port runs K8).  The parameters come
through checkpoints/bridge.py unchanged: none of these routes needs a leaf
the bridge does not already map.

Tolerances on normalized embeddings: fp32 2e-5 (summation order); bf16
1e-2 (bf16 elementwise chains rounded at other places, through 2 layers,
the pooler and a normalize); the fused frontend against the unfused one in
the same package 1e-5 (fp32 log-mel values equal to ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu.runtime import CacoEngine as JaxEngine
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.engine import DISPATCH_WINDOW

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jcfg.caco_tiny(vocab_size=300), tcfg.caco_tiny(vocab_size=300)
    jparams = jax_caco_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tc)


def _engines(tiny, dtype, **kw):
    jc, tc, jparams, model = tiny
    jd, td = DTYPES[dtype]
    return (JaxEngine(jc, jparams, dtype=jd, batch_size=4, **kw),
            CacoEngine(tc, model, dtype=td, batch_size=4, device="cpu", **kw))


def _wavs(seconds, seed=0):
    rs = np.random.RandomState(seed)
    return [(0.1 * rs.randn(int(s * 16_000))).astype(np.float32) for s in seconds]


@pytest.mark.parametrize("dtype,seq,route", [("float32", 1536, "k3"), ("bfloat16", 1496, "k1")])
def test_30s_engine_matches_jax(tiny, dtype, seq, route):
    """1496 patches per 30-s buffer; fp32 pads to 1536 and takes K3, bf16
    stays at 1496 on K1, in both packages.  Clips of 30, 12 and 0.5 s and a
    45-s clip cut to the buffer."""
    jax_engine, engine = _engines(tiny, dtype, buffer_seconds=30.0)
    assert engine.patch.patches_seq_len == jax_engine.patch.patches_seq_len == seq
    cfg = engine.cfg.audio
    assert ea.layer_route(seq, cfg.hidden_size, cfg.intermediate_size, engine.cfg.dtype)[0] == route
    wavs = _wavs([30, 12, 0.5, 45])
    ref, got = jax_engine.embed_audio(wavs), engine.embed_audio(wavs)
    assert got.shape == (4, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])


@pytest.mark.parametrize("seconds,seq_len,expect", [(10.0, 200, 200), (10.0, None, 496),
                                                    (30.0, 1400, 1536)])
def test_patches_seq_len_matches_jax(tiny, seconds, seq_len, expect):
    """`patches_seq_len` as the JAX engine takes it: None is the buffer's
    patch count; a budget below it keeps each clip's first patches; either
    is rounded by `preferred_seq_len` (1400 at 30 s in fp32 → the blocked
    plan's 1536)."""
    jax_engine, engine = _engines(tiny, "float32", buffer_seconds=seconds, patches_seq_len=seq_len)
    assert engine.patch.patches_seq_len == jax_engine.patch.patches_seq_len == expect
    wavs = _wavs([seconds, 2.5, 0.1, seconds + 3])
    batch, _ = engine.audio_patch_batch(wavs)
    assert batch["audio_mask"].shape == (4, expect)
    ref, got = jax_engine.embed_audio(wavs), engine.embed_audio(wavs)
    assert got.shape == (4, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL["float32"])


@pytest.mark.parametrize("overlap", [0.0, 5.0])
def test_embed_audio_long_matches_jax(tiny, overlap):
    """Clips of 75, 10 and 31 s and an empty one through 30-s windows: 3, 1,
    2 and 1 windows at no overlap; averaged, renormalized."""
    jax_engine, engine = _engines(tiny, "float32", buffer_seconds=30.0)
    wavs = _wavs([75, 10, 31, 0])
    ref = jax_engine.embed_audio_long(wavs, overlap_seconds=overlap)
    got = engine.embed_audio_long(wavs, overlap_seconds=overlap)
    assert got.shape == (4, 32)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=TOL["float32"])
    # a clip within the buffer is embed_audio's embedding
    np.testing.assert_allclose(got[1], engine.embed_audio(wavs[1:2])[0], atol=1e-6)
    with pytest.raises(ValueError, match="hop"):
        engine.embed_audio_long(wavs, overlap_seconds=30.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_frontend_engine_matches_jax(tiny, dtype):
    jax_engine, engine = _engines(tiny, dtype, buffer_seconds=10.0, fused_frontend=True)
    wavs = _wavs([10, 3.2, 0.05, 14, 7])
    ref, got = jax_engine.embed_audio(wavs), engine.embed_audio(wavs)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])
    if dtype == "float32":
        unfused = CacoEngine(engine.cfg, engine.params, batch_size=4, buffer_seconds=10.0,
                             device="cpu")
        np.testing.assert_allclose(got, unfused.embed_audio(wavs), atol=1e-5)


def test_fused_frontend_30s_engine_matches_jax(tiny):
    jax_engine, engine = _engines(tiny, "float32", buffer_seconds=30.0, fused_frontend=True)
    wavs = _wavs([30, 20.5, 1])
    np.testing.assert_allclose(engine.embed_audio(wavs), jax_engine.embed_audio(wavs),
                               atol=TOL["float32"])


@pytest.mark.parametrize("fused", [False, True])
def test_audio_patch_batch_matches_jax(tiny, fused):
    jax_engine, engine = _engines(tiny, "float32", buffer_seconds=10.0, fused_frontend=fused)
    wavs = _wavs([10, 2, 12, 0.3, 5])
    (ref, n_ref), (got, n) = jax_engine.audio_patch_batch(wavs), engine.audio_patch_batch(wavs)
    assert n == n_ref == 5 and got["audio_mask"].shape == (8, 496)
    for k in ("audio_mask", "audio_time_inds", "audio_freq_inds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["audio_patches"].numpy(), np.asarray(ref["audio_patches"]),
                               atol=1e-4)


def test_generator_input_and_bounded_dispatch_window(tiny):
    """11 clips at batch 2 are 6 buckets, more than the window of 4: a
    generator gives the list's embeddings, and no more than the window is
    ever in flight (and the window is used)."""
    _, tc, _, model = tiny
    engine = CacoEngine(tc, model, batch_size=2, buffer_seconds=1.0, device="cpu")
    wavs = _wavs([1, 0.4, 0.8, 1.5, 0.2, 1, 0.7, 0.9, 0.1, 1, 0.5])
    from_list = engine.embed_audio(wavs)
    assert engine.peak_in_flight == DISPATCH_WINDOW == 4
    from_gen = engine.embed_audio(w for w in wavs)
    assert engine.peak_in_flight == DISPATCH_WINDOW
    np.testing.assert_array_equal(from_gen, from_list)
    assert from_list.shape == (11, 32)
    engine.embed_audio(wavs[:3])
    assert engine.peak_in_flight == 2


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(tiny, monkeypatch):
    """The default device is the card; without one the default raises
    (it never falls back to the CPU), and device="cpu" runs."""
    import inspect

    _, tc, _, model = tiny
    assert inspect.signature(CacoEngine).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CacoEngine(tc, model, batch_size=2, buffer_seconds=1.0)
    assert CacoEngine(tc, model, batch_size=2, buffer_seconds=1.0, device="cpu").device.type == "cpu"
