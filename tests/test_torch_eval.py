"""The port's evaluation harness (cacophony_tpu_torch/eval) against the JAX
package's, on the synthetic datasets of tests/test_eval.py.

- The six dataset processors return exactly what JAX's return.
- `jackknife_stats`, `retrieval_metrics` and `check_expectations` equal
  JAX's on the hand examples of tests/test_eval.py and tests/test_expect.py;
  the port's goldens carry JAX's `atol` and `expect`.
- Zero-shot and retrieval through the port's CacoEngine (CPU, fp32) and the
  JAX engine on the same bridged caco_tiny weights: score matrices within
  1e-5 relative; equal metrics, which the fixture's rankings allow (no row
  holds two scores within 1e-5, asserted); the port's `retrieval_metrics`
  on JAX's matrix equals JAX's result exactly.
- Near-greedy captions (T = 1e-4, each package with its own noise) equal
  JAX's, and both CSV files are byte-identical.
- The CLI end to end on a released-layout file: `--task zs` with
  `--output_json` and `--expect`, both packages (`--tiny_model`, the port
  with `--device cpu`); results equal to 1e-6; a shifted golden makes both
  exit non-zero.

JAX kernels reached: K1 (Pallas interpret mode) in every audio layer of
the JAX engine; the port runs K1's plain version on the CPU.
"""

import csv
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.checkpoints.convert import caco_params_to_reference
from cacophony_tpu.data import tokenizer as jtok
from cacophony_tpu.eval import cli as jcli
from cacophony_tpu.eval import expect as jexpect
from cacophony_tpu.eval import metrics as jmetrics
from cacophony_tpu.eval import processors as jproc
from cacophony_tpu.eval import tasks as jtasks
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu.runtime import CacoEngine as JaxEngine
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax
from cacophony_tpu_torch.data import tokenizer as ttok
from cacophony_tpu_torch.eval import cli as tcli
from cacophony_tpu_torch.eval import expect as texpect
from cacophony_tpu_torch.eval import metrics as tmetrics
from cacophony_tpu_torch.eval import processors as tproc
from cacophony_tpu_torch.eval import tasks as ttasks
from cacophony_tpu_torch.runtime import CacoEngine
from test_eval import _write_wav, clotho_dir, esc50_dir  # noqa: F401  (fixtures)
from test_torch_checkpoint_io import _flax_write
from test_torch_engine import _byte_tokenizer

torch.set_num_threads(2)

ENGINE_KW = dict(buffer_seconds=2.0, max_text_len=24, batch_size=4)  # tests/test_eval.py


# ----------------------------------------------------------- processors

def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)


@pytest.fixture()
def other_dirs(tmp_path):
    """The AudioCaps, US8K, VGGSound and TUT layouts of tests/test_eval.py."""
    ac = tmp_path / "ac"
    (ac / "test").mkdir(parents=True)
    _write_wav(str(ac / "test" / "ytid0.wav"), 0.5, 16_000, seed=1)
    _write_csv(ac / "test.csv", [["audiocap_id", "youtube_id", "start_time", "caption"],
                                 ["1", "ytid0", "0", "a dog barks"],
                                 ["2", "ytid0", "0", "a loud dog"]])
    us = tmp_path / "us8k"
    (us / "audio" / "fold1").mkdir(parents=True)
    (us / "metadata").mkdir()
    _write_wav(str(us / "audio" / "fold1" / "100032-3-0-0.wav"), 0.5, 44_100, 1)
    _write_csv(us / "metadata" / "UrbanSound8K.csv",
               [["slice_file_name", "fsID", "start", "end", "salience", "fold", "classID",
                 "class"],
                ["100032-3-0-0.wav", "100032", "0", "0.3", "1", "1", "3", "dog_bark"]])
    vgg = tmp_path / "vgg"
    (vgg / "test").mkdir(parents=True)
    _write_wav(str(vgg / "test" / "clipA.wav"), 0.5, 48_000, 2)
    _write_wav(str(vgg / "test" / "unlabeled.wav"), 0.5, 48_000, 3)
    (vgg / "vggsound_full.json").write_text(json.dumps({"clipA": "playing drums"}))
    tut = tmp_path / "tut"
    (tut / "train").mkdir(parents=True)
    (tut / "eval").mkdir()
    _write_wav(str(tut / "train" / "a1.wav"), 0.5, 44_100, 4)
    _write_wav(str(tut / "eval" / "b1.wav"), 0.5, 44_100, 5)
    (tut / "meta_train.json").write_text(json.dumps({"a1.wav": "beach"}))
    (tut / "meta_eval.json").write_text(json.dumps({"b1.wav": "bus"}))
    return {"audiocaps": (str(ac), "test"), "us8k": (str(us), ""),
            "vggsound": (str(vgg), "test"), "tutas2017": (str(tut), "")}


@pytest.mark.parametrize("name", sorted(jproc.PROCESSORS))
def test_processors_match_jax(name, esc50_dir, clotho_dir, other_dirs):  # noqa: F811
    dirs = dict(other_dirs, esc50=(esc50_dir, ""), clotho=(clotho_dir, "evaluation"))
    data_dir, split = dirs[name]
    ours = tproc.PROCESSORS[name](data_dir=data_dir)
    theirs = jproc.PROCESSORS[name](data_dir=data_dir)
    assert dataclasses.astuple(ours.config) == dataclasses.astuple(theirs.config)
    got = ours.get_filepaths_and_descriptions(split)
    assert got == theirs.get_filepaths_and_descriptions(split)
    assert len(got[0]) >= 1


def test_processor_roots_follow_the_environment(monkeypatch, tmp_path):
    """`CACOPHONY_<NAME>_DIR` wins over DATA_ROOT/<default>, as in JAX."""
    monkeypatch.setenv("CACOPHONY_CLOTHO16K_DIR", str(tmp_path / "c"))
    for name in sorted(jproc.PROCESSORS):
        assert (tproc.PROCESSORS[name]().config.data_dir
                == jproc.PROCESSORS[name]().config.data_dir)
    assert tproc.Clotho16kProcessor().config.data_dir == str(tmp_path / "c")
    assert tproc.DATA_ROOT == jproc.DATA_ROOT


# ------------------------------------------------------ metrics, goldens

def _jack(v):
    return {"estimate": v, "bias": 0.0, "std_err": 0.0, "ci_low": v, "ci_high": v}


RETRIEVAL_CASES = [  # tests/test_eval.py:35-54
    (np.asarray([[2, 0, 1], [2, 1, 0]]), ["a0", "a1"], ["c0", "c1", "c2"],
     {"a0": ["c0", "c1"], "a1": ["c2"]}, "at"),
    (np.asarray([[0, 1], [1, 0], [1, 0]]), ["c0", "c1", "c2"], ["a0", "a1"],
     {"c0": "a0", "c1": "a0", "c2": "a1"}, "ta"),
]


@pytest.mark.parametrize("case", range(len(RETRIEVAL_CASES)))
def test_retrieval_metrics_match_jax(case):
    args = RETRIEVAL_CASES[case]
    assert tmetrics.retrieval_metrics(*args) == jmetrics.retrieval_metrics(*args)
    assert (tmetrics.format_metrics(tmetrics.retrieval_metrics(*args))
            == jmetrics.format_metrics(jmetrics.retrieval_metrics(*args)))


@pytest.mark.parametrize("values", [[1.0, 2.0, 3.0, 4.0, 10.0], [0.5], [0.0, 1.0, 1.0, 0.0]])
def test_jackknife_matches_jax(values):
    assert tmetrics.jackknife_stats(np.asarray(values)) == jmetrics.jackknife_stats(
        np.asarray(values))


EXPECT_CASES = [  # tests/test_expect.py
    ({"esc50": 0.930, "us8k": 0.771},
     {"atol": 0.005, "expect": {"esc50": 0.934, "us8k": 0.771}}),
    ({"esc50": 0.930, "us8k": 0.771}, {"atol": 0.001, "expect": {"esc50": 0.934}}),
    ({"esc50": 0.930, "us8k": 0.771}, {"atol": 0.001, "expect": {"esc50": [0.934, 0.01]}}),
    ({"esc50": 0.93, "text_to_audio": {"R1": _jack(0.41)}},
     {"expect": {"esc50": 0.9, "text_to_audio.R1": [0.4, 0.001]}}),
]


@pytest.mark.parametrize("case", range(len(EXPECT_CASES)))
def test_check_expectations_matches_jax(case):
    results, golden = EXPECT_CASES[case]
    assert (texpect.check_expectations(results, golden)
            == jexpect.check_expectations(results, golden))


def test_resolve_path_errors_match_jax():
    for results, path in (({"text_to_audio": {"R1": _jack(0.4)}}, "text_to_audio.R99"),
                          ({"x": {"a": 1}}, "x")):
        with pytest.raises(KeyError) as ours:
            texpect.resolve_path(results, path)
        with pytest.raises(KeyError) as theirs:
            jexpect.resolve_path(results, path)
        assert str(ours.value) == str(theirs.value)


def test_goldens_carry_jax_numbers():
    """Same files, same atol and expect; the usage line names the port."""
    import cacophony_tpu.eval as jeval
    import cacophony_tpu_torch.eval as teval

    jdir = os.path.join(os.path.dirname(jeval.__file__), "goldens")
    tdir = os.path.join(os.path.dirname(teval.__file__), "goldens")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name)) as f:
            theirs = json.load(f)
        with open(os.path.join(tdir, name)) as f:
            ours = json.load(f)
        assert ours["atol"] == theirs["atol"] and ours["expect"] == theirs["expect"], name
        assert ours["_usage"].startswith("python -m cacophony_tpu_torch.eval "), name


# ------------------------------------------------------------- the tasks

@pytest.fixture(scope="module")
def engines():
    """The JAX engine of tests/test_eval.py and the port's on its weights."""
    jc, tc = jcfg.caco_tiny(vocab_size=300), tcfg.caco_tiny(vocab_size=300)
    jparams = jax_caco_init(jax.random.PRNGKey(0), jc)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tc)
    return (JaxEngine(jc, jparams, tokenizer=_byte_tokenizer(jtok), **ENGINE_KW),
            CacoEngine(tc, model, tokenizer=_byte_tokenizer(ttok), device="cpu", **ENGINE_KW))


def _capture_scores(engine, monkeypatch):
    seen = []
    score = engine.score

    def capture(a, t):
        out = score(a, t)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(engine, "score", capture)
    return seen


def _min_gap(rows):
    """Smallest gap between two scores of one row, relative to the largest
    score: a ranking that a 1e-5 difference cannot reorder has gaps above
    that."""
    s = np.sort(rows, axis=-1)
    return float(np.diff(s, axis=-1).min() / np.abs(rows).max())


def _assert_scores_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_zs_classification_matches_jax(engines, esc50_dir, monkeypatch):  # noqa: F811
    jax_engine, engine = engines
    got_scores = _capture_scores(engine, monkeypatch)
    want_scores = _capture_scores(jax_engine, monkeypatch)
    acc = ttasks.zs_classification(engine, tproc.ESC50Processor(data_dir=esc50_dir),
                                   verbose=False)
    want = jtasks.zs_classification(jax_engine, jproc.ESC50Processor(data_dir=esc50_dir),
                                    verbose=False)
    _assert_scores_close(got_scores[0], want_scores[0])
    assert _min_gap(want_scores[0]) > 1e-5
    assert acc == want and 0.0 <= acc <= 1.0


def test_audio_retrieval_matches_jax(engines, clotho_dir, monkeypatch):  # noqa: F811
    jax_engine, engine = engines
    got_scores = _capture_scores(engine, monkeypatch)
    want_scores = _capture_scores(jax_engine, monkeypatch)
    got = ttasks.audio_retrieval(engine, tproc.Clotho16kProcessor(data_dir=clotho_dir),
                                 verbose=False)
    want = jtasks.audio_retrieval(jax_engine, jproc.Clotho16kProcessor(data_dir=clotho_dir),
                                  verbose=False)
    sim = want_scores[0]  # (audio, text)
    _assert_scores_close(got_scores[0], sim)
    assert min(_min_gap(sim), _min_gap(sim.T)) > 1e-5
    assert got == want
    # the port's metrics on JAX's own matrix, as audio_retrieval ranks it
    files, desc, _ = jproc.Clotho16kProcessor(data_dir=clotho_dir).get_filepaths_and_descriptions(
        "evaluation")
    names = [os.path.basename(p).split(".wav")[0] for p in files]
    texts = [c for n in names for c in desc[n]["description"]]
    gt_at = {n: list(desc[n]["description"]) for n in names}
    gt_ta = {c: n for n in names for c in desc[n]["description"]}
    at = np.argsort(-sim, axis=-1)
    ta = np.argsort(-sim.T, axis=-1)
    assert tmetrics.retrieval_metrics(at, names, texts, gt_at, "at") == want["audio_to_text"]
    assert tmetrics.retrieval_metrics(ta, texts, names, gt_ta, "ta") == want["text_to_audio"]


def test_audio_captioning_matches_jax(engines, clotho_dir, tmp_path):  # noqa: F811
    """Near-greedy (T = 1e-4): the same strings as JAX's and byte-identical
    predictions.csv / gt.csv (the reference's format)."""
    jax_engine, engine = engines
    kw = dict(split="evaluation", max_length=12, temperature=1e-4, verbose=False)
    got = ttasks.audio_captioning(engine, tproc.Clotho16kProcessor(data_dir=clotho_dir),
                                  output_dir=str(tmp_path / "port"), **kw)
    want = jtasks.audio_captioning(jax_engine, jproc.Clotho16kProcessor(data_dir=clotho_dir),
                                   output_dir=str(tmp_path / "jax"), **kw)
    assert got == want and len(got[0]) == 3
    for name in ("predictions.csv", "gt.csv"):
        ours = (tmp_path / "port" / name).read_bytes()
        assert ours == (tmp_path / "jax" / name).read_bytes(), name
        assert len(ours.decode().strip().split("\n")) == 4


# ------------------------------------------------------------------ CLI

@pytest.fixture()
def released(tmp_path, esc50_dir, monkeypatch):  # noqa: F811
    """A released-layout caco_tiny file and a tokenizer directory, with the
    ESC-50 fixture as the zero-shot dataset (tests/test_eval.py:201-245)."""
    tok = _byte_tokenizer(jtok)
    cfg = jcfg.caco_tiny(vocab_size=tok.vocab_size)
    params = jax.tree_util.tree_map(np.asarray, jax_caco_init(jax.random.PRNGKey(3), cfg))
    ckpt_dir = tmp_path / "ckpt"
    _flax_write(ckpt_dir, caco_params_to_reference(params, cfg.audio.num_heads))
    tokdir = tmp_path / "tok"
    tokdir.mkdir()
    (tokdir / "vocab.json").write_text(json.dumps(tok.vocab))
    (tokdir / "merges.txt").write_text("#version: 0.2\n")
    monkeypatch.setenv("CACOPHONY_ESC50_DIR", esc50_dir)
    return ["--ckpt_path", str(ckpt_dir), "--task", "zs", "--dataset", "esc50",
            "--tokenizer", str(tokdir), "--tiny_model", "--batch_size", "4"]


def test_cli_zs_with_expect_matches_jax(released, tmp_path):
    """Both CLIs, a golden every accuracy passes, then one moved past its
    atol: the JSON results agree to 1e-6, and both gates exit non-zero."""
    loose = tmp_path / "loose.json"
    loose.write_text(json.dumps({"atol": 1.0, "expect": {"esc50": 0.5}}))
    out = {}
    for name, cli, extra in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        results = cli.main(released + extra + ["--output_json", str(path),
                                               "--expect", str(loose)])
        out[name] = json.loads(path.read_text())
        assert out[name]["top1_accuracy"] == results
    assert out["port"]["task"] == out["jax"]["task"] == "zs"
    acc = out["jax"]["top1_accuracy"]["esc50"]
    assert out["port"]["top1_accuracy"]["esc50"] == pytest.approx(acc, abs=1e-6)
    shifted = tmp_path / "shifted.json"
    shifted.write_text(json.dumps(
        {"atol": 0.001, "expect": {"esc50": acc + 0.5 if acc < 0.5 else acc - 0.5}}))
    for cli, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            cli.main(released + extra + ["--expect", str(shifted)])
        assert e.value.code not in (None, 0)


def test_cli_caption_refuses_expect(released, tmp_path):
    argv = [a if a != "zs" else "caption" for a in released]
    argv[argv.index("esc50")] = "clotho"
    with pytest.raises(SystemExit, match="zs/ar tasks only"):
        tcli.main(argv + ["--device", "cpu", "--expect", str(tmp_path / "any.json")])


def test_cli_default_device_is_the_card():
    assert tcli.build_parser().parse_args(["--ckpt_path", "x"]).device == "cuda"
