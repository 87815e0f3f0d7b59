"""Retrieval metrics with jackknife confidence intervals (a copy of
cacophony_tpu/eval/metrics.py).

Same semantics as the reference (src/eval/eval_utils.py:18-67): R@1/5/10 and
mAP@10 from argsorted score indices; audio→text dedups repeated captions in
the top-10 before scoring; 95% CI via leave-one-out jackknife (the reference
uses astropy — not in this environment, and it's ~15 lines of numpy).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

_Z95 = 1.959963984540054


def jackknife_stats(values: np.ndarray) -> Dict[str, float]:
    """Leave-one-out jackknife of the mean with a 95% normal CI."""
    values = np.asarray(values, np.float64)
    n = len(values)
    mean = values.mean()
    if n < 2:
        return {"estimate": float(mean), "bias": 0.0, "std_err": 0.0,
                "ci_low": float(mean), "ci_high": float(mean)}
    loo = (values.sum() - values) / (n - 1)
    jack_mean = loo.mean()
    bias = (n - 1) * (jack_mean - mean)
    estimate = mean - bias
    std_err = np.sqrt((n - 1) / n * np.square(loo - jack_mean).sum())
    return {
        "estimate": float(estimate), "bias": float(bias),
        "std_err": float(std_err),
        "ci_low": float(estimate - _Z95 * std_err),
        "ci_high": float(estimate + _Z95 * std_err),
    }


def retrieval_metrics(
    indices: np.ndarray,                  # (n_queries, >=10) argsorted key ids
    queries: Sequence[str],
    keys: Sequence[str],
    gt_query_to_key: Mapping,
    retrieval_type: str = "at",
) -> Dict[str, Dict[str, float]]:
    """→ {metric: jackknife stats}.

    'at' (audio→text): gt maps audio → list of caption strings; duplicate
    captions among the retrieved top-10 count once (reference
    eval_utils.py:27-37).
    'ta' (text→audio): gt maps caption → its single audio name.
    """
    r1, r5, r10, map10 = [], [], [], []
    for qi, query in enumerate(queries):
        top = [keys[k] for k in np.asarray(indices[qi][:10])]
        if retrieval_type == "at":
            hits, seen = [], set()
            for key in top:
                ok = key not in seen and key in gt_query_to_key[query]
                if ok:
                    seen.add(key)
                hits.append(ok)
            hits = np.asarray(hits)
        elif retrieval_type == "ta":
            hits = np.asarray([gt_query_to_key[query] == key for key in top])
        else:
            raise ValueError(retrieval_type)

        r1.append(float(hits[:1].any()))
        r5.append(float(hits[:5].any()))
        r10.append(float(hits[:10].any()))
        pos = np.nonzero(hits[:10])[0] + 1.0
        if len(pos):
            map10.append(float((np.arange(1, len(pos) + 1) / pos).mean()))
        else:
            map10.append(0.0)

    return {
        "R1": jackknife_stats(np.asarray(r1)),
        "R5": jackknife_stats(np.asarray(r5)),
        "R10": jackknife_stats(np.asarray(r10)),
        "mAP10": jackknife_stats(np.asarray(map10)),
    }


def format_metrics(metrics: Dict[str, Dict[str, float]]) -> str:
    return "\n".join(
        f"{name} {m['estimate']:.3f} [{m['ci_low']:.3f}, {m['ci_high']:.3f}]"
        for name, m in metrics.items()
    )
