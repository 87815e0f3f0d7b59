"""Data-parallel serving and the data-parallel runner on the CPU (gloo):
the port's CacoEngine and GalleryIndex under a 2-rank mesh (spawned ranks,
a `file://` rendezvous, one thread a rank, no JAX in the ranks) against the
port without a mesh and the JAX package's under `make_mesh(dp=2)`, both
computed here in the parent; then `train.runner --dp 2` launched as
torchrun launches it (MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE /
LOCAL_RANK in the environment of two processes), and `--tp 2` in one
process refused.

Tolerances: the engine's fp32 embeddings 1e-5 against the port without a
mesh and against JAX's mesh engine (each rank runs the one-device program
on its rows: the same sums at a smaller batch); bf16 the same 1e-5
against the port without a mesh (the same kernels' plain versions on the
same rows), 1e-2 against JAX as tests/test_torch_engine.py holds the bf16
engine.  The gallery: indices equal (ties included: equal scores lower
row first, as `lax.top_k`), scores 1e-5 (products summed in another
order).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.io import latest_step
from cacophony_tpu_torch.data import tokenizer as ttok
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.parallel import make_mesh
from cacophony_tpu_torch.parallel.multihost import initialize_multihost
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.gallery import GalleryIndex
from cacophony_tpu_torch.train import runner
from test_torch_runner import _args, data  # noqa: F401  (a fixture; tests/ is on sys.path)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TEXTS = ["a dog barking", "rain on a window", "a trumpet solo", "wind", "engine", "birds"]
ENGINE_KW = dict(buffer_seconds=1.0, max_text_len=24, batch_size=4)
DIM, SLAB = 16, 4


def _tokenizer():
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in ttok._bytes_to_unicode().values():
        vocab[c] = len(vocab)
    return ttok.ByteLevelBPETokenizer(vocab, [])


def _wavs():
    rs = np.random.RandomState(0)
    return [(0.1 * rs.randn(n)).astype(np.float32)
            for n in (16_000, 4_000, 9_000, 20_000, 100, 12_000, 7_000, 16_000, 3_000)]


def _long_wavs():
    rs = np.random.RandomState(1)
    return [(0.1 * rs.randn(n)).astype(np.float32) for n in (40_000, 8_000)]


def _normed(rs, n):
    e = rs.randn(n, DIM).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _gallery_ops():
    """Rows in four adds (growth past the slab twice), with duplicated rows
    (tied scores), deletions, and the queries."""
    rs = np.random.RandomState(3)
    parts = [_normed(rs, n) for n in (3, 6, 2, 9)]
    parts[2] = parts[0][:2].copy()  # rows 9, 10 repeat rows 0, 1
    parts[3][4] = parts[1][0]       # row 15 repeats row 3
    queries = np.concatenate([_normed(rs, 3), parts[0][:1], parts[1][:1]])
    return parts, [[1, 13], [13, 17]], queries


def _run_gallery(g, parts, deletes, queries):
    out = []
    for i, rows in enumerate(parts):
        g.add(rows, labels=[f"p{i}r{j}" for j in range(len(rows))] if i % 2 else None)
        out.append(g.search(queries, k=4))
    for dead in deletes:
        g.delete(dead)
        out.append(g.search(queries, k=6))
    out.append(g.search(queries, k=100))
    return out


# ------------------------------------------------------------ spawned ranks

def _serve_rank(rank, world, root):
    torch.set_num_threads(1)
    initialize_multihost(f"file://{root}/rendezvous", world, rank, device="cpu")
    out = {}
    try:
        mesh = make_mesh(dp=world, device="cpu")
        cfg = tcfg.caco_tiny(vocab_size=300)
        model = caco_init(cfg, torch.Generator().manual_seed(50 + rank))  # rank 0's is broadcast
        if rank == 0:
            model.load_state_dict(torch.load(os.path.join(root, "model.pt")))
        for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            engine = CacoEngine(cfg, model, tokenizer=_tokenizer(), dtype=dtype, device="cpu",
                                mesh=mesh, **ENGINE_KW)
            batch, n = engine.audio_patch_batch(_wavs()[:6])
            out[name] = {"audio": engine.embed_audio(_wavs()), "long": engine.embed_audio_long(
                _long_wavs(), overlap_seconds=0.25), "text": engine.embed_texts(TEXTS),
                "patches": {k: v.clone() for k, v in batch.items()}, "n": n}
        try:
            CacoEngine(cfg, model, device="cpu", mesh=mesh, **dict(ENGINE_KW, batch_size=3))
        except ValueError as e:
            out["indivisible"] = str(e)
        g = GalleryIndex(DIM, logit_scale=1.5, slab=SLAB, device="cpu", mesh=mesh)
        out["gallery"] = _run_gallery(g, *_gallery_ops())
        out["gallery_block"] = (g.capacity, g._store.shape[0])
        g.save(os.path.join(root, "port_gallery.npz"))
        loaded = GalleryIndex.load(os.path.join(root, "jax_gallery.npz"), device="cpu", mesh=mesh)
        out["loaded_jax"] = loaded.search(_gallery_ops()[2], k=6)
    finally:
        torch.save(out, os.path.join(root, f"serve_{rank}.pt"))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX mesh gallery's file first (the ranks load it), then the
    ranks; → (root, [each rank's results], the model)."""
    import jax  # noqa: F401

    from cacophony_tpu.parallel import make_mesh as jax_make_mesh
    from cacophony_tpu.runtime.gallery import GalleryIndex as JaxGallery

    root = str(tmp_path_factory.mktemp("serve"))
    model = caco_init(tcfg.caco_tiny(vocab_size=300), torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), os.path.join(root, "model.pt"))
    with pytest.warns(UserWarning, match="idle"):
        jmesh = jax_make_mesh(dp=WORLD)
    jg = JaxGallery(DIM, logit_scale=1.5, slab=SLAB, mesh=jmesh)
    jax_gallery = _run_gallery(jg, *_gallery_ops())
    jg.save(os.path.join(root, "jax_gallery.npz"))
    mp.spawn(_serve_rank, args=(WORLD, root), nprocs=WORLD, join=True)
    results = [torch.load(os.path.join(root, f"serve_{r}.pt"), weights_only=False)
               for r in range(WORLD)]
    return root, results, model, (jmesh, jax_gallery)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_on_a_mesh_matches_one_device_and_jax(served, dtype):
    import jax
    import jax.numpy as jnp

    from cacophony_tpu import configs as jcfg
    from cacophony_tpu.data import tokenizer as jtok
    from cacophony_tpu.runtime import CacoEngine as JaxEngine
    from cacophony_tpu_torch.checkpoints.bridge import params_to_jax

    _, results, model, (jmesh, _) = served
    for res in results[1:]:  # every rank returns the whole result
        for key in ("audio", "long", "text"):
            assert np.array_equal(res[dtype][key], results[0][dtype][key]), key
    got = results[0][dtype]
    ref = CacoEngine(tcfg.caco_tiny(vocab_size=300), model, tokenizer=_tokenizer(),
                     dtype=getattr(torch, dtype), device="cpu", **ENGINE_KW)
    np.testing.assert_allclose(got["audio"], ref.embed_audio(_wavs()), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["long"], ref.embed_audio_long(_long_wavs(), overlap_seconds=0.25),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["text"], ref.embed_texts(TEXTS), rtol=0, atol=1e-5)
    batch, n = ref.audio_patch_batch(_wavs()[:6])
    assert got["n"] == n == 6 and set(got["patches"]) == set(batch)
    for k, v in batch.items():
        assert torch.equal(got["patches"][k], v), k
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in jtok._bytes_to_unicode().values():
        vocab[c] = len(vocab)
    jeng = JaxEngine(jcfg.caco_tiny(vocab_size=300),
                     jax.tree_util.tree_map(jnp.asarray, params_to_jax(model)),
                     tokenizer=jtok.ByteLevelBPETokenizer(vocab, []), mesh=jmesh,
                     dtype=None if dtype == "float32" else jnp.bfloat16, **ENGINE_KW)
    tol = 1e-5 if dtype == "float32" else 1e-2  # tests/test_torch_engine.py's bf16 bound
    np.testing.assert_allclose(got["audio"], jeng.embed_audio(_wavs()), rtol=0, atol=tol)
    np.testing.assert_allclose(got["text"], jeng.embed_texts(TEXTS), rtol=0, atol=tol)


def test_engine_batch_must_divide_over_the_mesh(served):
    for res in served[1]:
        assert "must divide evenly over the 2-device mesh" in res["indivisible"]


def test_gallery_on_a_mesh_matches_one_device_and_jax(served):
    from cacophony_tpu.runtime.gallery import GalleryIndex as JaxGallery

    root, results, _, (jmesh, jax_gallery) = served
    one = _run_gallery(GalleryIndex(DIM, logit_scale=1.5, slab=SLAB, device="cpu"),
                       *_gallery_ops())
    for res in results:
        assert res["gallery_block"] == (32, 16)  # capacity 4 → 8 → 16 → 32, half a rank
        for (s, i, lab), (s1, i1, lab1), (sj, ij, labj) in zip(res["gallery"], one, jax_gallery):
            np.testing.assert_array_equal(i, i1)
            np.testing.assert_array_equal(i, np.asarray(ij))
            np.testing.assert_allclose(s, s1, rtol=0, atol=1e-5)
            np.testing.assert_allclose(s, np.asarray(sj), rtol=0, atol=1e-5)
            assert lab == lab1 == labj
    s, i, _ = one[3]  # ties: rows 0 / 9 and 3 / 15 score equal for the last two queries
    assert i[3, 0] == 0 and i[3, 1] == 9 and i[4, 0] == 3 and i[4, 1] == 15
    assert s[3, 0] == s[3, 1] and s[4, 0] == s[4, 1]
    queries = _gallery_ops()[2]
    ref = JaxGallery.load(os.path.join(root, "jax_gallery.npz"), mesh=jmesh).search(queries, k=6)
    for res in results:  # the port's mesh gallery loaded JAX's file
        np.testing.assert_array_equal(res["loaded_jax"][1], np.asarray(ref[1]))
        np.testing.assert_allclose(res["loaded_jax"][0], np.asarray(ref[0]), rtol=0, atol=1e-5)
    loaded = JaxGallery.load(os.path.join(root, "port_gallery.npz"), mesh=jmesh)
    got = loaded.search(queries, k=6)
    np.testing.assert_array_equal(np.asarray(got[1]), results[0]["gallery"][-2][1])
    assert loaded.num_deleted == 3 and loaded.labels == GalleryIndex.load(
        os.path.join(root, "port_gallery.npz"), device="cpu").labels


# ------------------------------------------------------------ runner --dp

_LAUNCH = ("import sys, torch; torch.set_num_threads(1); "
           "from cacophony_tpu_torch.train import runner; "
           "s = runner.main(sys.argv[2:]); torch.save(s.params.state_dict(), sys.argv[1])")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(argv, out_dir, world=WORLD):
    """Two processes with torchrun's environment; → each rank's stdout and
    final parameters."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LAUNCH, os.path.join(out_dir, f"params_{r}.pt"), *argv],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    params = [torch.load(os.path.join(out_dir, f"params_{r}.pt")) for r in range(world)]
    return outs, params


def test_runner_dp2_writes_from_rank0_and_resumes_across_world_sizes(data, tmp_path):  # noqa: F811
    # a dp run of 2 steps, resumed on one process to 4
    a = str(tmp_path / "a")
    outs, params = _torchrun(_args(data, a, 2) + ["--dp", "2"], str(tmp_path))
    for k, v in params[0].items():  # the replicas stayed equal
        assert torch.equal(params[1][k], v), k
    assert "done at step 2" in outs[0] and "done at step" not in outs[1]
    rows = [json.loads(line) for line in open(os.path.join(a, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1]  # rank 0 alone logged
    assert sorted(os.listdir(os.path.join(a, "checkpoints"))) == ["step_00000002"]
    saved = torch.load(os.path.join(a, "checkpoints", "step_00000002", "train_state.pt"))
    for k, v in params[0].items():
        assert torch.equal(saved["params"][k], v), k
    resumed = runner.main(_args(data, a, 4))
    assert resumed.step == 4
    assert [json.loads(line)["step"] for line in open(os.path.join(a, "metrics.jsonl"))] == [0, 1, 2, 3]
    # a one-process run of 2 steps, resumed by a dp run to 4
    b = str(tmp_path / "b")
    runner.main(_args(data, b, 2))
    outs, params = _torchrun(_args(data, b, 4) + ["--dp", "2"], str(tmp_path))
    assert "resumed from step 2" in outs[0] and "done at step 4" in outs[0]
    for k, v in params[0].items():
        assert torch.equal(params[1][k], v), k
    assert latest_step(os.path.join(b, "checkpoints")) == 4
    rows = [json.loads(line) for line in open(os.path.join(b, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_runner_tp_raises(data, tmp_path):  # noqa: F811
    # --tp 2 in one process: the mesh needs two ranks (tests/test_torch_parallel_tp_serving.py
    # runs it under a launcher), and the one-rank group the runner made is removed again
    with pytest.raises(ValueError, match="tp=2 does not divide the 1 ranks"):
        runner.main(_args(data, str(tmp_path / "w"), 1) + ["--tp", "2"])
    assert not dist.is_initialized()
