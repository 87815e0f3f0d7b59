"""Serving and the runner under a tensor-parallel mesh on the CPU (gloo).

- `CacoEngine(mesh=make_mesh(2, 2))`: the parameters whole on every rank,
  the batch split into row blocks over all four ranks in rank order, the
  rows gathered over the whole group (JAX's engine folds both mesh axes
  into data parallelism) — against the engine without a mesh and JAX's
  engine on `make_mesh(2, 2)`, at the tolerances of
  tests/test_torch_parallel_serving.py (fp32 1e-5; bf16 1e-5 against the
  port, 1e-2 against JAX);
- `GalleryIndex(mesh=make_mesh(2, 2))`: rows sharded over dp, replicated
  over tp (JAX's P("dp")), against one device and JAX's mesh gallery;
- `train.runner --dp 1 --tp 2` launched as torchrun launches it: rank 0
  alone logs and writes a file of whole leaves that equals the
  one-process run's (parameters 1e-5 relative in L2, the bound of the
  one-process comparison in tests/test_torch_parallel_tp.py; the Adam
  moments 1e-4: the second moment squares the gradients' rounding), and
  that file resumes at tp 2 and at tp 1 to the same state.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.parallel import make_mesh
from cacophony_tpu_torch.parallel.multihost import initialize_multihost
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.gallery import GalleryIndex
from cacophony_tpu_torch.train import runner
from test_torch_parallel_serving import (
    DIM,
    ENGINE_KW,
    SLAB,
    TEXTS,
    _gallery_ops,
    _long_wavs,
    _run_gallery,
    _tokenizer,
    _torchrun,
    _wavs,
)
from test_torch_runner import _args, data  # noqa: F401  (a fixture; tests/ is on sys.path)

torch.set_num_threads(2)

DP, TP = 2, 2
STATE = os.path.join("checkpoints", "step_{:08d}", "train_state.pt")


def _serve_rank(rank, world, root):
    torch.set_num_threads(1)
    initialize_multihost(f"file://{root}/rendezvous", world, rank, device="cpu")
    out = {}
    try:
        mesh = make_mesh(DP, TP, device="cpu")
        cfg = tcfg.caco_tiny(vocab_size=300)
        model = caco_init(cfg, torch.Generator().manual_seed(50 + rank))  # rank 0's is broadcast
        if rank == 0:
            model.load_state_dict(torch.load(os.path.join(root, "model.pt")))
        for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            engine = CacoEngine(cfg, model, tokenizer=_tokenizer(), dtype=dtype, device="cpu",
                                mesh=mesh, **ENGINE_KW)
            batch, n = engine.audio_patch_batch(_wavs()[:6])
            rows = engine._rows(ENGINE_KW["batch_size"])
            out[name] = {"audio": engine.embed_audio(_wavs()), "long": engine.embed_audio_long(
                _long_wavs(), overlap_seconds=0.25), "text": engine.embed_texts(TEXTS),
                "patches": {k: v.clone() for k, v in batch.items()}, "n": n,
                "rows": (rows.start, rows.stop)}
        out["whole"] = all(p.shape == q.shape for p, q in zip(
            model.parameters(), caco_init(cfg, torch.Generator()).parameters()))
        g = GalleryIndex(DIM, logit_scale=1.5, slab=SLAB, device="cpu", mesh=mesh)
        out["gallery"] = _run_gallery(g, *_gallery_ops())
        out["gallery_block"] = (g.capacity, g._store.shape[0], g._lo)
    finally:
        torch.save(out, os.path.join(root, f"serve_{rank}.pt"))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_tp"))
    model = caco_init(tcfg.caco_tiny(vocab_size=300), torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), os.path.join(root, "model.pt"))
    mp.spawn(_serve_rank, args=(DP * TP, root), nprocs=DP * TP, join=True)
    results = [torch.load(os.path.join(root, f"serve_{r}.pt"), weights_only=False)
               for r in range(DP * TP)]
    return results, model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_folds_tp_into_data_parallelism(served, dtype):
    import jax
    import jax.numpy as jnp

    from cacophony_tpu import configs as jcfg
    from cacophony_tpu.data import tokenizer as jtok
    from cacophony_tpu.parallel import make_mesh as jax_make_mesh
    from cacophony_tpu.runtime import CacoEngine as JaxEngine
    from cacophony_tpu_torch.checkpoints.bridge import params_to_jax

    results, model = served
    per_rank = ENGINE_KW["batch_size"] // (DP * TP)
    for r, res in enumerate(results):  # one row block a rank, over all four ranks
        assert res[dtype]["rows"] == (r * per_rank, (r + 1) * per_rank) and res["whole"]
        for key in ("audio", "long", "text"):  # every rank returns the whole result
            assert np.array_equal(res[dtype][key], results[0][dtype][key]), key
    got = results[0][dtype]
    ref = CacoEngine(tcfg.caco_tiny(vocab_size=300), model, tokenizer=_tokenizer(),
                     dtype=getattr(torch, dtype), device="cpu", **ENGINE_KW)
    np.testing.assert_allclose(got["audio"], ref.embed_audio(_wavs()), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["long"], ref.embed_audio_long(_long_wavs(), overlap_seconds=0.25),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["text"], ref.embed_texts(TEXTS), rtol=0, atol=1e-5)
    batch, n = ref.audio_patch_batch(_wavs()[:6])
    assert got["n"] == n == 6
    for k, v in batch.items():
        assert torch.equal(got["patches"][k], v), k
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in jtok._bytes_to_unicode().values():
        vocab[c] = len(vocab)
    with pytest.warns(UserWarning, match="idle"):
        jmesh = jax_make_mesh(dp=DP, tp=TP)
    jeng = JaxEngine(jcfg.caco_tiny(vocab_size=300),
                     jax.tree_util.tree_map(jnp.asarray, params_to_jax(model)),
                     tokenizer=jtok.ByteLevelBPETokenizer(vocab, []), mesh=jmesh,
                     dtype=None if dtype == "float32" else jnp.bfloat16, **ENGINE_KW)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got["audio"], jeng.embed_audio(_wavs()), rtol=0, atol=tol)
    np.testing.assert_allclose(got["text"], jeng.embed_texts(TEXTS), rtol=0, atol=tol)


def test_gallery_shards_over_dp_and_replicates_over_tp(served):
    from cacophony_tpu.parallel import make_mesh as jax_make_mesh
    from cacophony_tpu.runtime.gallery import GalleryIndex as JaxGallery

    results, _ = served
    one = _run_gallery(GalleryIndex(DIM, logit_scale=1.5, slab=SLAB, device="cpu"),
                       *_gallery_ops())
    with pytest.warns(UserWarning, match="idle"):
        jmesh = jax_make_mesh(dp=DP, tp=TP)
    jax_gallery = _run_gallery(JaxGallery(DIM, logit_scale=1.5, slab=SLAB, mesh=jmesh),
                               *_gallery_ops())
    for r, res in enumerate(results):
        # capacity 32 in blocks of 16 over dp: ranks 0, 1 (dp 0) hold rows 0-15
        assert res["gallery_block"] == (32, 16, 16 * (r // TP))
        for (s, i, lab), (s1, i1, lab1), (sj, ij, labj) in zip(res["gallery"], one, jax_gallery):
            np.testing.assert_array_equal(i, i1)
            np.testing.assert_array_equal(i, np.asarray(ij))
            np.testing.assert_allclose(s, s1, rtol=0, atol=1e-5)
            np.testing.assert_allclose(s, np.asarray(sj), rtol=0, atol=1e-5)
            assert lab == lab1 == labj


def _rel_l2(got, ref):
    num = sum(float((g.double() - r.double()).square().sum()) for g, r in zip(got, ref))
    return (num / sum(float(r.double().square().sum()) for r in ref)) ** 0.5


def _close_files(a, b, moments=True):
    fa, fb = (torch.load(f, weights_only=True) for f in (a, b))
    assert fa["names"] == fb["names"] and fa["step"] == fb["step"] and fa["count"] == fb["count"]
    assert list(fa["params"]) == list(fb["params"])
    for k, v in fa["params"].items():
        assert v.shape == fb["params"][k].shape, k  # whole leaves
    rel = _rel_l2(list(fa["params"].values()), list(fb["params"].values()))
    assert rel <= 1e-5, rel
    if moments:
        for key in ("mu", "nu"):
            assert all(x.dtype == y.dtype and x.shape == y.shape for x, y in zip(fa[key], fb[key]))
            rel = _rel_l2(fa[key], fb[key])
            assert rel <= 1e-4, (key, rel)


def test_runner_tp2_writes_whole_leaves_and_resumes_at_tp2_and_tp1(data, tmp_path):  # noqa: F811
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    outs, _ = _torchrun(_args(data, a, 2) + ["--dp", "1", "--tp", "2"], str(tmp_path))
    assert "done at step 2" in outs[0] and "done at step" not in outs[1]
    assert [json.loads(line)["step"] for line in open(os.path.join(a, "metrics.jsonl"))] == [0, 1]
    runner.main(_args(data, b, 2))
    _close_files(os.path.join(a, STATE.format(2)), os.path.join(b, STATE.format(2)))
    # the tp file resumed at tp 2 and at tp 1
    c = str(tmp_path / "c")
    shutil.copytree(a, c)
    outs, _ = _torchrun(_args(data, a, 4) + ["--dp", "1", "--tp", "2"], str(tmp_path))
    assert "resumed from step 2" in outs[0] and "done at step 4" in outs[0]
    assert runner.main(_args(data, c, 4)).step == 4
    _close_files(os.path.join(a, STATE.format(4)), os.path.join(c, STATE.format(4)))
    rows = [json.loads(line) for line in open(os.path.join(a, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1, 2, 3] and all(np.isfinite(r["loss"]) for r in rows)
