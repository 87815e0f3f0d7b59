"""The port's HEAR scorer (cacophony_tpu_torch/hear/score.py) and its copy
of the sed_eval shim against the JAX package's.

- Scene scores: the port computes average precision and ROC AUC in numpy;
  the JAX package calls scikit-learn.  Equal to 1e-12 (float64 sums in
  another order), or NaN where JAX gives NaN, on one-hot and multilabel
  targets, tied scores, a column with no positive and one with no
  negative.
- Event scores: the port's `EVENT_SCORES` and its shim equal the JAX
  package's `score` and shim exactly on the random event sets of
  tests/test_sed_differential.py.
- The matching: `_max_bipartite_matching` against scipy's.

No JAX kernel is reached: the scorers are numpy.
"""

import random
import warnings

import numpy as np
import pytest
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

from cacophony_tpu.hear import score as jscore
from cacophony_tpu.third_party import sed_eval_shim as jshim
from cacophony_tpu.third_party.sed_eval_shim.containers import MetaDataContainer as JContainer
from cacophony_tpu_torch.hear import score as tscore
from cacophony_tpu_torch.third_party import sed_eval_shim as tshim
from cacophony_tpu_torch.third_party.sed_eval_shim.containers import (
    MetaDataContainer as TContainer,
)
from test_sed_differential import random_event_sets

SEEDS = 20


def _targets(rs, n, c, kind):
    if kind == "onehot":
        t = np.zeros((n, c), np.float32)
        t[np.arange(n), rs.randint(0, c, n)] = 1.0
        return t
    return (rs.rand(n, c) < 0.4).astype(np.float32)


def _scores(rs, n, c, tied):
    p = rs.rand(n, c).astype(np.float32)
    return np.round(p * 4) / 4 if tied else p


def _assert_same(name, got, want):
    if np.isnan(want):
        assert np.isnan(got), (name, got, want)
    else:
        assert abs(got - want) <= 1e-12, (name, got, want)


DEGENERATE = ["none", "no_positive", "no_negative", "both"]


@pytest.mark.parametrize("kind", ["onehot", "multilabel"])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("degenerate", DEGENERATE)
def test_scene_scores_match_jax(kind, tied, degenerate):
    """Every SCENE_SCORES entry on 10 random score sets of 2-80 clips and
    2-6 classes; degenerate columns turn AP into 0.0 / 1.0 and AUC and d′
    into NaN, as scikit-learn gives them."""
    rs = np.random.RandomState(100 * (kind == "onehot") + 10 * tied
                               + DEGENERATE.index(degenerate))
    for _ in range(10):
        n, c = rs.randint(2, 81), rs.randint(2, 7)
        p, t = _scores(rs, n, c, tied), _targets(rs, n, c, kind)
        if degenerate in ("no_positive", "both"):
            t[:, 0] = 0.0
        if degenerate in ("no_negative", "both"):
            t[:, -1] = 1.0
        for name, fn in tscore.SCENE_SCORES.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # scikit-learn's degenerate-column warnings
                want = jscore.SCENE_SCORES[name](p, t)
            _assert_same(name, fn(p, t), want)
    assert set(tscore.SCENE_SCORES) == set(jscore.SCENE_SCORES)


def test_scene_score_edge_cases_match_jax():
    """One column (scikit-learn's binary path), a NaN score (its input
    check raises: NaN), one clip of each class, and the hand example of
    tests/test_hear.py."""
    rs = np.random.RandomState(1)
    cases = [
        (rs.rand(12, 1), (rs.rand(12, 1) < 0.5).astype(np.float32)),
        (np.asarray([[0.9, np.nan], [0.2, 0.8]]), np.asarray([[1, 0], [0, 1]], np.float32)),
        (np.asarray([[0.7, 0.3], [0.4, 0.6]]), np.asarray([[1, 0], [0, 1]], np.float32)),
        (np.asarray([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]]),
         np.asarray([[1, 0], [0, 1], [0, 1]], np.float32)),
    ]
    for p, t in cases:
        for name, fn in tscore.SCENE_SCORES.items():
            if name in ("top1_acc", "pitch_acc", "chroma_acc") and np.isnan(p).any():
                continue  # argmax of NaN: not a case the probes produce
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = jscore.SCENE_SCORES[name](p, t)
            _assert_same(name, fn(p, t), want)


def test_degenerate_columns_as_scikit_learn_gives_them():
    """A column with no positive has AP 0.0 and enters the macro mean; a
    column with no negative has AP 1.0; either makes AUC and d′ NaN."""
    p = np.asarray([[0.9, 0.1, 0.3], [0.2, 0.8, 0.6], [0.6, 0.4, 0.5]])
    t = np.asarray([[1, 0, 0], [0, 1, 0], [1, 0, 0]], np.float32)
    ap = [tscore._binary_average_precision(t[:, c], p[:, c]) for c in range(3)]
    assert ap[2] == 0.0
    assert tscore.mean_average_precision(p, t) == pytest.approx(np.mean(ap))
    assert np.isnan(tscore.aucroc(p, t)) and np.isnan(tscore.d_prime(p, t))
    t[:, 2] = 1.0
    assert tscore._binary_average_precision(t[:, 2], p[:, 2]) == 1.0


def _container(module, events_by_file):
    rows = [{"event_label": str(e["label"]), "event_onset": e["start"] / 1000.0,
             "event_offset": e["end"] / 1000.0, "file": fname}
            for fname, evs in events_by_file.items() for e in evs]
    return module(rows)


def _shim_overall(container, metric, preds, targs):
    ref_c, est_c = _container(container, targs), _container(container, preds)
    for fname in preds:  # the reference iterates prediction files
        metric.evaluate(reference_event_list=ref_c.filter(filename=fname),
                        estimated_event_list=est_c.filter(filename=fname))
    return metric.results_overall_metrics()


EVENT_SHIM_PARAMS = [
    {"evaluate_onset": True, "evaluate_offset": False, "t_collar": 0.2},
    {"evaluate_onset": True, "evaluate_offset": False, "t_collar": 0.05},
    {"evaluate_onset": True, "evaluate_offset": True, "t_collar": 0.05,
     "percentage_of_length": 0.2},
]


@pytest.mark.parametrize("dense", [False, True])
def test_event_scores_and_shim_match_jax_exactly(dense):
    """20 seeds of random event sets (zero-length events, boundary onsets,
    dense same-label overlaps, files only in the targets, empty prediction
    files): every EVENT_SCORES entry, the segment metrics' dicts and both
    shims' overall results are equal to JAX's, not merely close."""
    for seed in range(SEEDS):
        preds, targs = random_event_sets(random.Random(seed), dense=dense)
        for name, fn in tscore.EVENT_SCORES.items():
            assert fn(preds, targs) == jscore.EVENT_SCORES[name](preds, targs), (seed, name)
        assert (tscore.segment_based_metrics(preds, targs)
                == jscore.segment_based_metrics(preds, targs)), seed
        got = _shim_overall(TContainer, tshim.sound_event.SegmentBasedMetrics(
            event_label_list=["A", "B"], time_resolution=1.0), preds, targs)
        want = _shim_overall(JContainer, jshim.sound_event.SegmentBasedMetrics(
            event_label_list=["A", "B"], time_resolution=1.0), preds, targs)
        assert got == want, seed
        assert got["error_rate"]["error_rate"] == tscore.segment_based_error_rate(preds, targs)
        for params in EVENT_SHIM_PARAMS:
            got = _shim_overall(TContainer, tshim.sound_event.EventBasedMetrics(
                event_label_list=["A", "B"], **params), preds, targs)
            want = _shim_overall(JContainer, jshim.sound_event.EventBasedMetrics(
                event_label_list=["A", "B"], **params), preds, targs)
            assert got == want, (seed, params)
    assert set(tscore.EVENT_SCORES) == set(jscore.EVENT_SCORES)
    assert tscore.LOWER_IS_BETTER == jscore.LOWER_IS_BETTER


def test_bipartite_matching_matches_scipy():
    """The port's iterative augmenting-path matching against scipy's
    maximum matching on random graphs, and a dense 1500 × 1500 block."""
    rng = np.random.RandomState(0)
    for n, p in ((30, 0.1), (200, 0.02), (1500, 0.002)):
        m = rng.rand(n, n) < p
        adj = [list(np.nonzero(m[u])[0]) for u in range(n)]
        want = int((maximum_bipartite_matching(csr_matrix(m), perm_type="column") >= 0).sum())
        assert tscore._max_bipartite_matching(adj) == want, n
    n = 1500
    assert tscore._max_bipartite_matching([list(range(n))] * n) == n
