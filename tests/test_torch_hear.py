"""The port's HEAR pipeline (cacophony_tpu_torch/hear) against the JAX
package's, on the synthetic tasks of tests/test_hear.py.

- The embedders: `CacoHearEmbedder` (caco_tiny) and `AudioMAEHearEmbedder`
  (the tiny MAE) on the same bridged weights and wavs, scene and event
  embeddings within 1e-5 in fp32 (summation order through two layers),
  clips shorter than the buffer included: the event pool averages the
  padded patch rows too.  The timestamps are equal.
- `task_embeddings` writes JAX's file tree, memmaps, labels and
  timestamps; each package's `task_predictions` reads the other's folder.
- The probe: at init through `probe_from_jax`, eval probabilities within
  1e-5 / 1e-6 of JAX's; after 3 steps at dropout 0, weights (the pre-BN
  bias aside: its gradient is zero in exact arithmetic, torch's BN backward
  gives exactly 0, JAX's a residue that Adam turns into a step of ≈ lr),
  BN statistics and head within 1e-4 / 1e-5, probabilities within 5e-3 /
  5e-4 (the JAX mirror test's bounds, tests/test_hear.py); dropout from
  the probe's generator is repeatable and keeps 0.9 ± 0.02.
- `task_predictions` with FASTER_PARAM_GRID on a scene task, a 3-fold task
  and an event task: keys, files and score ranges as JAX's; on a linearly
  separable variant of the scene task both reach top-1 accuracy 1.0.
- `_select_event_postprocess` on the hand-computed cases of
  tests/test_hear.py, with `strict_reference_bugs` on and off.

JAX kernels reached: K1 (Pallas interpret mode) in the JAX encoders' layers;
the port runs K1's plain version on the CPU.  The probes train on the CPU.
"""

import csv
import itertools
import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.hear import embeddings as jemb
from cacophony_tpu.hear import predictions as jpred
from cacophony_tpu.hear import runner as jrunner
from cacophony_tpu.models.audio import audiomae_init as jax_audiomae_init
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax
from cacophony_tpu_torch.hear import embeddings as temb
from cacophony_tpu_torch.hear import predictions as tpred
from cacophony_tpu_torch.hear import runner as trunner
from test_hear import _write_wav, hear_fold_task_dir, hear_task_dir  # noqa: F401  (fixtures)
from test_torch_mae_model import tiny_mae

torch.set_num_threads(2)

EMB_TOL = 1e-5
BUFFER_S = 2.0  # the fixtures' clips are 1-2 s: padded rows in every pool


@pytest.fixture()
def event_task_dir(tmp_path):
    """The event task of tests/test_hear.py:381-436 (2-s clips, two labels,
    two events a clip)."""
    task = tmp_path / "tasks" / "toyevent-v1.0.0-full"
    (task / "16000").mkdir(parents=True)
    metadata = {"task_name": "toyevent", "embedding_type": "event",
                "prediction_type": "multilabel", "splits": ["train", "valid", "test"],
                "evaluation": ["segment_1s_er", "event_onset_200ms_fms"],
                "sample_duration": 2.0}
    (task / "task_metadata.json").write_text(json.dumps(metadata))
    with open(task / "labelvocabulary.csv", "w", newline="") as f:
        csv.writer(f).writerows([["idx", "label"], ["0", "beep"], ["1", "hiss"]])
    seed = 100
    for split, n in [("train", 6), ("valid", 4), ("test", 4)]:
        d = task / "16000" / split
        d.mkdir(parents=True)
        split_json = {}
        for i in range(n):
            name = f"{split}_{i}.wav"
            _write_wav(d / name, 2.0, 16_000, seed)
            label = "beep" if i % 2 == 0 else "hiss"
            split_json[name] = [{"label": label, "start": 0.0, "end": 900.0},
                                {"label": label, "start": 1200.0, "end": 1800.0}]
            seed += 1
        (task / f"{split}.json").write_text(json.dumps(split_json))
    return task


@pytest.fixture(scope="module")
def caco():
    jc, tc = jcfg.caco_tiny(), tcfg.caco_tiny()
    params = jax_caco_init(jax.random.PRNGKey(0), jc)
    return jc, params, tc, params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc)


@pytest.fixture(scope="module")
def mae():
    jc, tc = tiny_mae(jcfg), tiny_mae(tcfg)
    params = jax_audiomae_init(jax.random.PRNGKey(0), jc.encoder, jc.decoder)
    return jc, params, tc, params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc)


def _embedders(kind, caco, mae, **kw):
    if kind == "caco":
        jc, jp, tc, tm = caco
        return jemb.CacoHearEmbedder(jc, jp, **kw), temb.CacoHearEmbedder(tc, tm, **kw)
    jc, jp, tc, tm = mae
    return jemb.AudioMAEHearEmbedder(jc, jp, **kw), temb.AudioMAEHearEmbedder(tc, tm, **kw)


# ------------------------------------------------------------ embedders

@pytest.mark.parametrize("kind", ["caco", "audiomae"])
def test_embeddings_match_jax(kind, caco, mae, hear_task_dir, event_task_dir):  # noqa: F811
    """Scene and event embeddings of 1-s and 2-s clips in a 2-s buffer
    (half the patch rows of the 1-s clips are padding) and of a 0.3-s clip."""
    theirs, ours = _embedders(kind, caco, mae, sample_rate=16_000,
                              audio_max_len_s=BUFFER_S, batch_size=4)
    short = hear_task_dir / "short.wav"
    _write_wav(short, 0.3, 16_000, 77)
    paths = [str(hear_task_dir / "16000" / "train" / "train_0.wav"), str(short),
             str(event_task_dir / "16000" / "test" / "test_1.wav"),
             str(hear_task_dir / "16000" / "test" / "test_3.wav")]
    assert ours.patch.patches_seq_len == theirs.patch.patches_seq_len == 100
    got, want = ours.scene_embeddings(paths), theirs.scene_embeddings(paths)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=0)
    (got, got_ts), (want, want_ts) = ours.event_embeddings(paths), theirs.event_embeddings(paths)
    assert got.shape == want.shape == (4, 12, 32)
    np.testing.assert_allclose(got, np.asarray(want), atol=EMB_TOL, rtol=0)
    np.testing.assert_array_equal(got_ts, want_ts)
    # the rows past a 1-s clip are pooled padding, and they are not zero
    assert np.abs(got[0, -1]).max() > 1e-3


def test_embedder_default_buffer_is_500_patches(caco):
    jc, jp, tc, tm = caco
    assert temb.CacoHearEmbedder(tc, tm).patch.patches_seq_len == 500
    assert temb.CacoHearEmbedder(tc, tm).device == torch.device("cpu")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _assert_same_store(ours, theirs, event: bool):
    """Same files; per-clip arrays, memmaps within EMB_TOL; labels, dims,
    JSON files equal (filename timestamps up to their root)."""
    assert _tree(ours) == _tree(theirs)
    for rel in _tree(theirs):
        a, b = os.path.join(ours, rel), os.path.join(theirs, rel)
        if rel.endswith(".embedding.npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), atol=EMB_TOL, rtol=0)
        elif rel.endswith(".embeddings.npy"):
            with open(os.path.join(theirs, rel.replace("embeddings.npy",
                                                       "embedding-dimensions.json"))) as f:
                shape = tuple(json.load(f))
            mm = [np.memmap(p, dtype=np.float32, mode="r", shape=shape) for p in (a, b)]
            np.testing.assert_allclose(mm[0], mm[1], atol=EMB_TOL, rtol=0)
        elif rel.endswith(".filename-timestamps.json"):
            with open(a) as f, open(b) as g:
                got, want = json.load(f), json.load(g)
            assert [(os.path.relpath(s, ours), t) for s, t in got] == \
                [(os.path.relpath(s, theirs), t) for s, t in want]
            assert event
        elif rel.endswith(".pkl"):
            with open(a, "rb") as f, open(b, "rb") as g:
                assert pickle.load(f) == pickle.load(g)
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), rel


@pytest.mark.parametrize("kind,task", [("caco", "scene"), ("audiomae", "scene"),
                                       ("caco", "event")])
def test_task_embeddings_match_jax(kind, task, caco, mae, hear_task_dir, event_task_dir,  # noqa: F811
                                   tmp_path):
    """The runner's store of a task: JAX's tree, memmaps and labels; then
    each package's task_predictions reads the other's folder."""
    theirs, ours = _embedders(kind, caco, mae, sample_rate=16_000,
                              audio_max_len_s=BUFFER_S, batch_size=4)
    task_dir = event_task_dir if task == "event" else hear_task_dir
    out = {name: tmp_path / "embeddings" / name / kind / task_dir.name for name in ("jax", "port")}
    jrunner.task_embeddings(theirs, task_dir, out["jax"])
    trunner.task_embeddings(ours, task_dir, out["port"])
    _assert_same_store(str(out["port"]), str(out["jax"]), task == "event")
    grid = dict(tpred.FASTER_PARAM_GRID, max_epochs=[2])
    got = tpred.task_predictions(str(out["jax"]), grid=grid, grid_points=1, device="cpu")
    want = jpred.task_predictions(str(out["port"]), grid=grid, grid_points=1)
    assert set(got) == set(want) and set(got["test"]) == set(want["test"])
    for d in out.values():
        assert (d / "test.predicted-scores.json").exists() and (d / "prediction-done.json").exists()


# ---------------------------------------------------------------- probe

PROBE_CONF = {"hidden_layers": 2, "hidden_dim": 16, "dropout": 0.0, "batch_size": 8, "lr": 1e-3}


def _probe_data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 12).astype(np.float32)
    y = np.zeros((8, 5), np.float32)
    y[np.arange(8), rng.randint(0, 5, 8)] = 1.0
    y[::3, 1] = 1.0  # multilabel rows with two labels (argmax unchanged for multiclass)
    return x, y


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("ptype", ["multiclass", "multilabel"])
def test_probe_matches_jax(ptype):
    x, y = _probe_data()
    theirs = jpred.MLPProbe(12, 5, ptype, PROBE_CONF, seed=0)
    ours = tpred.probe_from_jax(_numpy(theirs.params), _numpy(theirs.bn_state), PROBE_CONF, 12, 5,
                                ptype, device="cpu")
    np.testing.assert_allclose(ours.probabilities(x), theirs.probabilities(x),
                               rtol=1e-5, atol=1e-6)
    linears = [m for m in ours.net if isinstance(m, torch.nn.Linear)]
    norms = [m for m in ours.net if isinstance(m, torch.nn.BatchNorm1d)]
    # Σ momentum·(1 − momentum)^(steps − k)·b_k: the pre-BN biases' share of
    # each package's running means (its biases b_k at the steps' forwards)
    bias_share = {"jax": [0.0] * len(norms), "port": [0.0] * len(norms)}
    for _ in range(3):
        for i, (lin, lyr) in enumerate(zip(linears, theirs.params["hidden"])):
            for name, b in (("jax", np.asarray(lyr["b"])), ("port", lin.bias.detach().numpy())):
                bias_share[name][i] = 0.9 * bias_share[name][i] + 0.1 * b.copy()
        theirs.train_batch(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
                           PROBE_CONF["lr"])
        ours.train_batch(torch.from_numpy(x), torch.from_numpy(y))
    tol = dict(rtol=1e-4, atol=1e-5)
    for i, (lin, bn, lyr, stats) in enumerate(zip(linears, norms, theirs.params["hidden"],
                                                  theirs.bn_state)):
        np.testing.assert_allclose(lin.weight.detach().numpy().T, np.asarray(lyr["w"]), **tol)
        np.testing.assert_allclose(bn.weight.detach().numpy(), np.asarray(lyr["scale"]), **tol)
        np.testing.assert_allclose(bn.bias.detach().numpy(), np.asarray(lyr["bias"]), **tol)
        np.testing.assert_allclose(bn.running_mean.numpy() - bias_share["port"][i],
                                   np.asarray(stats["mean"]) - bias_share["jax"][i], **tol)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **tol)
    head = theirs.params["head"]
    np.testing.assert_allclose(linears[-1].weight.detach().numpy().T, np.asarray(head["w"]), **tol)
    np.testing.assert_allclose(linears[-1].bias.detach().numpy(), np.asarray(head["b"]), **tol)
    np.testing.assert_allclose(ours.probabilities(x), theirs.probabilities(x),
                               rtol=5e-3, atol=5e-4)


def test_probe_architecture_and_init():
    """[Linear → BN → Dropout → ReLU]^L → Linear, the same weights from the
    same seed on every call, xavier-uniform bounds."""
    conf = dict(PROBE_CONF, dropout=0.1)
    a = tpred.MLPProbe(12, 5, "multiclass", conf, seed=3, device="cpu")
    b = tpred.MLPProbe(12, 5, "multiclass", conf, seed=3, device="cpu")
    kinds = [type(m).__name__ for m in a.net]
    assert kinds == ["Linear", "BatchNorm1d", "_Dropout", "ReLU"] * 2 + ["Linear"]
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    w = a.net[0].weight
    assert w.abs().max() <= (6 / (12 + 16)) ** 0.5 and a.net[1].eps == 1e-5
    assert a.net[1].momentum == 0.1


def test_probe_dropout_is_repeatable_and_keeps_its_share():
    conf = dict(PROBE_CONF, dropout=0.1, hidden_layers=1, hidden_dim=1000)
    x, y = _probe_data()
    states = []
    for _ in range(2):
        probe = tpred.MLPProbe(12, 5, "multiclass", conf, seed=1, device="cpu")
        probe.train_batch(torch.from_numpy(x), torch.from_numpy(y))
        states.append(probe.snapshot())
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    drop = probe.net[2]
    drop.train()
    kept = (drop(torch.ones(100, 1000)) != 0).float().mean().item()
    assert abs(kept - 0.9) <= 0.02


def test_probe_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.MLPProbe(12, 5, "multiclass", PROBE_CONF)


# ------------------------------------------------------ task_predictions

def _embed_both(task_dir, caco, tmp_path):
    """The task embedded by the port's runner; each package then predicts
    on its own copy of the folder."""
    _, ours = _embedders("caco", caco, None, sample_rate=16_000, audio_max_len_s=1.0,
                         batch_size=4)
    out = tmp_path / "embeddings" / "caco" / task_dir.name
    trunner.task_embeddings(ours, task_dir, out)
    twin = tmp_path / "twin" / "caco" / task_dir.name
    shutil.copytree(out, twin)
    return out, twin


def _check_result(got, want, metadata):
    assert set(got) == set(want) and got["num_folds"] == want["num_folds"]
    assert set(got["test"]) == set(want["test"]) == set(metadata["evaluation"])
    assert set(got["aggregated_scores"]) == set(want["aggregated_scores"])
    assert set(got["best_conf"]) == set(want["best_conf"])
    for name, v in got["test"].items():
        assert np.isfinite(v) and v >= 0.0 and (name == "segment_1s_er" or v <= 1.0), (name, v)


@pytest.mark.parametrize("task", ["scene", "kfold", "event"])
def test_task_predictions_match_jax(task, caco, hear_task_dir, hear_fold_task_dir,  # noqa: F811
                                    event_task_dir, tmp_path):
    task_dir = {"scene": hear_task_dir, "kfold": hear_fold_task_dir, "event": event_task_dir}[task]
    ours_dir, theirs_dir = _embed_both(task_dir, caco, tmp_path)
    got = tpred.task_predictions(str(ours_dir), grid=tpred.FASTER_PARAM_GRID, grid_points=2,
                                 device="cpu")
    want = jpred.task_predictions(str(theirs_dir), grid=jpred.FASTER_PARAM_GRID, grid_points=2)
    metadata = json.loads((task_dir / "task_metadata.json").read_text())
    _check_result(got, want, metadata)
    keys = sorted(tpred.FASTER_PARAM_GRID)
    assert got["best_conf"] in [dict(zip(keys, v)) for v in
                                itertools.product(*(tpred.FASTER_PARAM_GRID[k] for k in keys))]
    assert got["num_folds"] == (3 if task == "kfold" else 1)
    for d in (ours_dir, theirs_dir):
        saved = json.loads((d / "test.predicted-scores.json").read_text())
        assert set(saved) == set(got)
        assert json.loads((d / "prediction-done.json").read_text()) == {"done": True}


def test_separable_scene_task_reaches_full_accuracy(caco, hear_task_dir, tmp_path):  # noqa: F811
    """The scene task with its embeddings replaced by two well-separated
    clusters (class ± 1 along every axis, noise 0.1): both packages reach
    top-1 accuracy 1.0 on the test split."""
    ours_dir, theirs_dir = _embed_both(hear_task_dir, caco, tmp_path)
    for d in (ours_dir, theirs_dir):
        for split in ("train", "valid", "test"):
            n, dim = json.loads((d / f"{split}.embedding-dimensions.json").read_text())
            with open(d / f"{split}.target-labels.pkl", "rb") as f:
                labels = pickle.load(f)
            sign = np.asarray([1.0 if lbl == ["dog"] else -1.0 for lbl in labels], np.float32)
            mm = np.memmap(d / f"{split}.embeddings.npy", dtype=np.float32, mode="r+",
                           shape=(n, dim))
            mm[:] = sign[:, None] + 0.1 * np.random.RandomState(len(split)).randn(n, dim)
            mm.flush()
    got = tpred.task_predictions(str(ours_dir), grid=tpred.FASTER_PARAM_GRID, grid_points=8,
                                 device="cpu")
    want = jpred.task_predictions(str(theirs_dir), grid=jpred.FASTER_PARAM_GRID, grid_points=8)
    assert got["test"]["top1_acc"] == want["test"]["top1_acc"] == 1.0


# ------------------------------------------------- postprocess selection

SELECTION_CASES = [  # tests/test_hear.py:311-372: (grid, primary, strict, score, min_duration)
    ({"median_filter_ms": [50], "min_duration": [100, 300]}, "event_onset_200ms_fms", False,
     1.0, 100),
    ({"median_filter_ms": [50], "min_duration": [100, 150]}, "event_onset_200ms_fms", False,
     1.0, 150),
    ({"median_filter_ms": [50], "min_duration": [100, 300]}, "segment_1s_er", False, 0.0, 100),
    ({"median_filter_ms": [50], "min_duration": [100, 300]}, "segment_1s_er", True, 1.0, 300),
    ({"median_filter_ms": [50], "min_duration": [100, 300]}, "event_onset_200ms_fms", True,
     1.0, 100),
]


@pytest.mark.parametrize("case", range(len(SELECTION_CASES)))
def test_select_event_postprocess_matches_jax(case, monkeypatch):
    grid, primary, strict, score, min_duration = SELECTION_CASES[case]
    monkeypatch.setattr(tpred, "EVENT_POSTPROCESSING_GRID", grid)
    monkeypatch.setattr(jpred, "EVENT_POSTPROCESSING_GRID", grid)
    ts = [float(t) for t in range(0, 1000, 100)]
    fname_ts = [["clip.wav", t] for t in ts]
    probs = np.zeros((len(ts), 1), np.float32)
    probs[2:5, 0] = 0.9  # one event (200, 400) ms
    metadata = {"evaluation": [primary], "embedding_type": "event"}
    targets = {"clip.wav": [{"label": "A", "start": 200.0, "end": 400.0}]}
    args = (probs, metadata, targets, fname_ts, {0: "A"})
    got = tpred._select_event_postprocess(*args, strict_reference_bugs=strict)
    assert got == jpred._select_event_postprocess(*args, strict_reference_bugs=strict)
    assert got[0] == pytest.approx(score) and got[1]["min_duration"] == min_duration
