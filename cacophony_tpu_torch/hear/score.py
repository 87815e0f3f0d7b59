"""HEAR score functions, implemented natively (cacophony_tpu/hear/score.py).

Covers the reference registry (src/eval/heareval/score.py:365-404):
top1_acc, pitch_acc / chroma_acc, mAP (macro), d_prime, aucroc, and the
sed_eval-backed segment/event-based scores (the segment/event F1
definitions below follow the standard Mesaros et al. 2016 formulation
sed_eval implements).

Neither scikit-learn nor sed_eval is a dependency.  Macro average precision
and per-class ROC AUC are written in numpy and return what scikit-learn's
`average_precision_score` / `roc_auc_score` (1.9) return on the same
inputs, degenerate columns included: a column with no positive has AP 0.0
(it enters the macro mean) and AUC NaN; a column with no negative has AP
1.0 and AUC NaN; tied scores form one threshold."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
from scipy.stats import norm, rankdata


def label_vocab_as_dict(df_rows: Sequence[dict], key: str = "label",
                        value: str = "idx") -> Dict:
    """labelvocabulary.csv rows → {label: idx} (reference score.py:19)."""
    return {row[key]: int(row[value]) for row in df_rows}


def label_to_binary_vector(labels: List, nlabels: int) -> np.ndarray:
    v = np.zeros(nlabels, np.float32)
    for l in labels:
        v[int(l)] = 1.0
    return v


# -------------------------------------------------------------- scene scores

def top1_accuracy(predictions: np.ndarray, targets: np.ndarray) -> float:
    """targets: binary (n, c); predictions: scores (n, c)."""
    pred = predictions.argmax(-1)
    true = targets.argmax(-1)
    return float((pred == true).mean())


def chroma_accuracy(predictions: np.ndarray, targets: np.ndarray) -> float:
    """Octave-invariant pitch accuracy: correct if class index matches
    modulo 12 (reference ChromaAccuracy, score.py:158)."""
    pred = predictions.argmax(-1)
    true = targets.argmax(-1)
    return float(((pred % 12) == (true % 12)).mean())


def _check_scores(predictions: np.ndarray, targets: np.ndarray):
    """→ (scores, targets) as 2-D arrays of one shape; ValueError where
    scikit-learn's input checks raise (non-finite scores, shapes)."""
    p = np.asarray(predictions)
    t = np.asarray(targets)
    if p.ndim == 1:
        p = p[:, None]
    if t.ndim == 1:
        t = t[:, None]
    if p.shape != t.shape or p.ndim != 2 or p.shape[0] == 0:
        raise ValueError(f"scores {p.shape} and targets {t.shape} do not match")
    if not np.isfinite(p).all():
        raise ValueError("scores contain NaN or infinity")
    return p, t


def _binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP of one column as scikit-learn computes it: the precision-recall
    curve over the distinct scores in descending order (a tie is one
    threshold), integrated as a step function, clipped at 0.0."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    score, hit = y_score[order], y_true[order] == 1
    last = np.r_[np.where(np.diff(score))[0], hit.size - 1]
    tps = np.cumsum(hit, dtype=np.float64)[last]
    fps = 1 + last - tps
    precision = np.zeros_like(tps)
    np.divide(tps, tps + fps, out=precision, where=(tps + fps) != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.hstack((precision[::-1], 1))
    recall = np.hstack((recall[::-1], 0))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC AUC of one column: the Mann-Whitney statistic with average ranks
    for ties, which is the trapezoid over the distinct thresholds; NaN when
    the column holds one class only."""
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = pos.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(y_score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _per_class(metric, predictions, targets) -> np.ndarray:
    p, t = _check_scores(predictions, targets)
    return np.asarray([metric(t[:, c], p[:, c]) for c in range(p.shape[1])])


def mean_average_precision(predictions: np.ndarray, targets: np.ndarray) -> float:
    """Macro-averaged AP over ALL classes (reference score.py:289-315 —
    degenerate classes propagate rather than being silently dropped)."""
    try:
        return float(np.mean(_per_class(_binary_average_precision, predictions, targets)))
    except ValueError:
        return float("nan")


def aucroc(predictions: np.ndarray, targets: np.ndarray) -> float:
    """Macro AUC-ROC over ALL classes (NaN on degenerate splits, like the
    reference score.py:343-362)."""
    try:
        return float(np.mean(_per_class(_binary_roc_auc, predictions, targets)))
    except ValueError:
        return float("nan")


def d_prime(predictions: np.ndarray, targets: np.ndarray) -> float:
    """Mean over classes of sqrt(2)·Φ⁻¹(per-class AUC) — per-class BEFORE
    the nonlinear ppf, like the reference (score.py:317-341); ppf of the
    averaged AUC gives materially different values."""
    try:
        per_class = _per_class(_binary_roc_auc, predictions, targets)
    except ValueError:
        return float("nan")
    per_class = np.clip(per_class, 1e-7, 1 - 1e-7)
    return float(np.mean((2 ** 0.5) * norm.ppf(per_class)))


# -------------------------------------------- event scores (sed_eval-exact)
#
# The reference scores event tasks with sed_eval through heareval's
# SoundEventScore (reference score.py:183-286):
#   - score fns are called as fn(predictions, targets) with BOTH arguments
#     dicts {filename: [ {label, start, end} ]} in milliseconds,
#   - evaluate() is invoked per filename in PREDICTIONS (score.py:224-228),
#     so files present only in the targets are never evaluated,
#   - sed_eval SegmentBasedMetrics grids each file to
#     ceil(max(ref.max_offset, est.max_offset) / time_resolution) segments
#     and marks roll[floor(onset/res):ceil(offset/res)] — a zero-length
#     event on a boundary marks nothing,
#   - sed_eval EventBasedMetrics matches hits with MAXIMUM bipartite
#     matching (util.bipartite_match), not greedily,
#   - all rates use eps = numpy.spacing(1) denominators.

EPS = float(np.spacing(1))


def _events_by_file(events):
    """Accept {filename: [events]} or a flat event list carrying
    'filename' keys (our event-extraction output)."""
    if isinstance(events, dict):
        return events
    by_file = defaultdict(list)
    for e in events:
        by_file[e["filename"]].append(e)
    return dict(by_file)


def _evaluated_filenames(predictions, targets):
    """sed_eval via the reference iterates prediction filenames only
    (score.py:224-228). Flat-list inputs can't represent empty-prediction
    files, so they fall back to the union of filenames."""
    if isinstance(predictions, dict):
        return list(predictions.keys())
    p, t = _events_by_file(predictions), _events_by_file(targets)
    return sorted(set(p) | set(t))


def _roll(events: List[dict], label_index: Dict[str, int], nseg: int,
          res_ms: float) -> np.ndarray:
    roll = np.zeros((nseg, len(label_index)), bool)
    for e in events:
        lo = int(np.floor(e["start"] / res_ms))
        hi = int(np.ceil(e["end"] / res_ms))
        roll[lo:hi, label_index[e["label"]]] = True
    return roll


def segment_based_metrics(predictions, targets,
                          time_resolution_ms: float = 1000.0) -> Dict[str, float]:
    """sed_eval SegmentBasedMetrics overall results (reference
    'segment_1s_er'/'segment_1s_fms' via SegmentBasedScore,
    score.py:266-274,394-400). Events in ms."""
    pred_by, ref_by = _events_by_file(predictions), _events_by_file(targets)
    labels = sorted({e["label"]
                     for evs in (*pred_by.values(), *ref_by.values())
                     for e in evs})
    label_index = {l: i for i, l in enumerate(labels)}
    ntp = nref = nsys = s_tot = d_tot = i_tot = 0
    for fname in _evaluated_filenames(predictions, targets):
        refs = ref_by.get(fname, [])
        ests = pred_by.get(fname, [])
        max_off = max([e["end"] for e in refs + ests] + [0.0])
        nseg = int(np.ceil(max_off / time_resolution_ms))
        if nseg == 0:
            continue
        ref_roll = _roll(refs, label_index, nseg, time_resolution_ms)
        est_roll = _roll(ests, label_index, nseg, time_resolution_ms)
        tp_seg = (ref_roll & est_roll).sum(axis=1)
        nref_seg = ref_roll.sum(axis=1)
        nsys_seg = est_roll.sum(axis=1)
        ntp += int(tp_seg.sum())
        nref += int(nref_seg.sum())
        nsys += int(nsys_seg.sum())
        s_tot += int((np.minimum(nref_seg, nsys_seg) - tp_seg).sum())
        d_tot += int(np.maximum(0, nref_seg - nsys_seg).sum())
        i_tot += int(np.maximum(0, nsys_seg - nref_seg).sum())
    precision = ntp / (nsys + EPS)
    recall = ntp / (nref + EPS)
    return {
        "f_measure": 2 * precision * recall / (precision + recall + EPS),
        "precision": precision,
        "recall": recall,
        "error_rate": (s_tot + d_tot + i_tot) / (nref + EPS),
        "substitution_rate": s_tot / (nref + EPS),
        "deletion_rate": d_tot / (nref + EPS),
        "insertion_rate": i_tot / (nref + EPS),
    }


def _max_bipartite_matching(adj: List[List[int]]) -> int:
    """Maximum-cardinality bipartite matching size (augmenting paths) —
    sed_eval matches candidate hits optimally via util.bipartite_match.
    ITERATIVE DFS: a dense same-label file (1000+ overlapping candidate
    events from an aggressive postprocess config) would blow Python's
    recursion limit with the recursive formulation."""
    match_right: Dict[int, int] = {}

    def try_assign(root: int) -> bool:
        seen: set = set()
        # stack frames: (u, iterator over u's candidates, v reserved by u)
        stack = [(root, iter(adj[root]), None)]
        while stack:
            u, it, _ = stack[-1]
            advanced = False
            for v in it:
                if v in seen:
                    continue
                seen.add(v)
                if v not in match_right:
                    # augmenting path found: commit reservations up the stack
                    match_right[v] = u
                    for uu, _, vv in reversed(stack[:-1]):
                        match_right[vv] = uu
                    return True
                stack[-1] = (u, it, v)
                stack.append((match_right[v], iter(adj[match_right[v]]), None))
                advanced = True
                break
            if not advanced:
                stack.pop()
        return False

    return sum(try_assign(u) for u in range(len(adj)))


def event_based_metrics(predictions, targets, *, t_collar_ms: float = 200.0,
                        evaluate_offset: bool = False,
                        percentage_of_length: float = 0.5) -> Dict[str, float]:
    """sed_eval EventBasedMetrics overall f-measure block (reference
    EventBasedScore, score.py:276-286 with params from score.py:370-393).
    Onset condition |Δonset| ≤ collar; offset condition
    |Δoffset| ≤ max(collar, percentage_of_length · ref_length)."""
    pred_by, ref_by = _events_by_file(predictions), _events_by_file(targets)
    ntp = nref = nsys = 0
    for fname in _evaluated_filenames(predictions, targets):
        refs = ref_by.get(fname, [])
        ests = pred_by.get(fname, [])
        nref += len(refs)
        nsys += len(ests)
        adj: List[List[int]] = []
        for r in refs:
            cands = []
            off_tol = max(t_collar_ms,
                          percentage_of_length * (r["end"] - r["start"]))
            for j, e in enumerate(ests):
                if e["label"] != r["label"]:
                    continue
                if abs(e["start"] - r["start"]) > t_collar_ms:
                    continue
                if evaluate_offset and abs(e["end"] - r["end"]) > off_tol:
                    continue
                cands.append(j)
            adj.append(cands)
        ntp += _max_bipartite_matching(adj)
    precision = ntp / (nsys + EPS)
    recall = ntp / (nref + EPS)
    return {
        "f_measure": 2 * precision * recall / (precision + recall + EPS),
        "precision": precision,
        "recall": recall,
    }


def segment_based_error_rate(predictions, targets) -> float:
    return float(segment_based_metrics(predictions, targets)["error_rate"])


def segment_based_f1(predictions, targets) -> float:
    return float(segment_based_metrics(predictions, targets)["f_measure"])


def onset_only_event_based_f1(predictions, targets,
                              t_collar_ms: float = 200.0) -> float:
    return float(event_based_metrics(
        predictions, targets, t_collar_ms=t_collar_ms,
        evaluate_offset=False)["f_measure"])


def event_based_f1(predictions, targets, t_collar_ms: float = 50.0,
                   percentage_of_length: float = 0.2) -> float:
    return float(event_based_metrics(
        predictions, targets, t_collar_ms=t_collar_ms, evaluate_offset=True,
        percentage_of_length=percentage_of_length)["f_measure"])


# Registry mirroring the reference's available_scores (score.py:365-404).
# Event entries are fn(predictions, targets) → the score's PRIMARY value
# (first of its `scores` tuple: f_measure for *_fms, error_rate for
# segment_1s_er).
SCENE_SCORES = {
    "top1_acc": top1_accuracy,
    "pitch_acc": top1_accuracy,
    "chroma_acc": chroma_accuracy,
    "mAP": mean_average_precision,
    "aucroc": aucroc,
    "d_prime": d_prime,
}

EVENT_SCORES = {
    # sed_eval semantics: segment_1s_er is an ERROR RATE (lower is better)
    "segment_1s_er": segment_based_error_rate,
    "segment_1s_fms": segment_based_f1,
    "event_onset_200ms_fms": lambda p, t: onset_only_event_based_f1(
        p, t, t_collar_ms=200.0),
    "event_onset_50ms_fms": lambda p, t: onset_only_event_based_f1(
        p, t, t_collar_ms=50.0),
    "event_onset_offset_50ms_20perc_fms": lambda p, t: event_based_f1(
        p, t, t_collar_ms=50.0, percentage_of_length=0.2),
}

# metrics where smaller values win (selection/aggregation direction)
LOWER_IS_BETTER = {"segment_1s_er"}
