"""HEAR downstream probe training over cached embeddings
(cacophony_tpu/hear/predictions.py).

Re-implements the reference's prediction phase
(src/eval/heareval/predictions/task_predictions.py) without
pytorch-lightning: shallow MLP probes trained on the memmapped embeddings
with random grid search, early stopping on the task's primary score,
k-fold re-training of the best config, and median-filter event extraction
for event tasks.  The probe is the reference's FullyConnectedPrediction as
torch modules, trained with torch.optim.Adam on the device it is given
(the card unless the CPU is asked for; no fallback), where the JAX
package reproduces it by hand on the host CPU.  Splits, scores, the
postprocessing grid and the result files stay numpy on the host.

Protocol constants follow the reference: PARAM_GRID (:57-94,
hidden 1024, dropout 0.1, lr {3.2e-3,1e-3,3.2e-4,1e-4}, patience 20,
batch 1024, BatchNorm, Adam), EVENT_POSTPROCESSING_GRID (:117-122),
seed 42 (:1291), grid_points=8 random configs (:1284), event extraction via
median filter + threshold 0.5 + min-duration (:615-683).
"""

from __future__ import annotations

import csv
import itertools
import json
import logging
import os
import pickle
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.ndimage import median_filter
from torch import nn

from cacophony_tpu_torch.hear import score as score_lib

logger = logging.getLogger("cacophony_tpu_torch.hear")

PARAM_GRID = {
    "hidden_layers": [1, 2],
    "hidden_dim": [1024],
    "dropout": [0.1],
    "lr": [3.2e-3, 1e-3, 3.2e-4, 1e-4],
    "patience": [20],
    "max_epochs": [500],
    "check_val_every_n_epoch": [3],
    "batch_size": [1024],
}

FAST_PARAM_GRID = dict(PARAM_GRID, max_epochs=[50], patience=[5])
FASTER_PARAM_GRID = dict(PARAM_GRID, hidden_layers=[0, 1], hidden_dim=[64],
                         max_epochs=[10], patience=[2],
                         check_val_every_n_epoch=[1])

EVENT_POSTPROCESSING_GRID = {
    "median_filter_ms": [250],
    "min_duration": [125, 250],
}


# ------------------------------------------------------------- probe model
#
# The reference FullyConnectedPrediction (task_predictions.py:140-192):
# [Linear → BatchNorm1d → Dropout → ReLU]^L → Linear head, xavier-uniform
# weights, torch-default uniform biases, BCE-with-logits (multilabel) /
# cross-entropy on the argmax (multiclass), Adam with torch's defaults.

_BN_EPS = 1e-5      # torch.nn.BatchNorm1d defaults
_BN_MOMENTUM = 0.1


def _linear(fan_in: int, fan_out: int, generator: torch.Generator) -> nn.Linear:
    """nn.Linear drawn from `generator`: the weight xavier-uniform (the
    reference overrides torch's default), the bias torch.nn.Linear's own
    U(-1/√fan_in, 1/√fan_in)."""
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    nn.init.xavier_uniform_(lin.weight, generator=generator)
    bound = float(1.0 / np.sqrt(fan_in))
    nn.init.uniform_(lin.bias, -bound, bound, generator=generator)
    return lin


class _Dropout(nn.Module):
    """Inverted dropout drawing its masks from an explicit generator."""

    def __init__(self, p: float, generator: torch.Generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x * keep / (1.0 - self.p)


class MLPProbe(nn.Module):
    """A probe with its optimizer, on `device` (the card unless "cpu" is
    given; without a card it raises).  Weights are drawn on the host from
    `seed`, so every device starts from the same probe; dropout masks come
    from a generator on the device seeded with seed + 1."""

    def __init__(self, nfeatures: int, nlabels: int, prediction_type: str,
                 conf: Dict[str, Any], seed: int = 42, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f'MLPProbe on {device}: no CUDA device; pass device="cpu"')
        self.prediction_type = prediction_type
        self.conf = conf
        self.device = device
        init = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator(device=device).manual_seed(seed + 1)
        layers, dim = [], nfeatures
        for _ in range(conf["hidden_layers"]):
            layers += [_linear(dim, conf["hidden_dim"], init),
                       nn.BatchNorm1d(conf["hidden_dim"], eps=_BN_EPS, momentum=_BN_MOMENTUM),
                       _Dropout(conf["dropout"], self.dropout_generator),
                       nn.ReLU()]
            dim = conf["hidden_dim"]
        self.net = nn.Sequential(*layers, _linear(dim, nlabels, init)).to(device)
        self.loss_fn = nn.BCEWithLogitsLoss() if self.multilabel else nn.CrossEntropyLoss()
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=conf["lr"])

    @property
    def multilabel(self) -> bool:
        return self.prediction_type == "multilabel"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)

    def train_batch(self, x: torch.Tensor, y: torch.Tensor) -> None:
        """One Adam step on a batch on the probe's device (BN in train mode,
        dropout from the probe's generator)."""
        self.train()
        logits = self(x)
        loss = self.loss_fn(logits, y if self.multilabel else y.argmax(dim=1))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()

    @torch.no_grad()
    def probabilities(self, x: np.ndarray) -> np.ndarray:
        self.eval()
        x = torch.from_numpy(np.array(x, np.float32, copy=True)).to(self.device)
        logits = self(x)
        probs = torch.sigmoid(logits) if self.multilabel else torch.softmax(logits, -1)
        return probs.cpu().numpy()

    def snapshot(self):
        """The weights and BN statistics (not the optimizer), copied."""
        return {k: v.detach().clone() for k, v in self.state_dict().items()}

    def restore(self, snap) -> None:
        self.load_state_dict(snap)


def probe_from_jax(params, bn_state, conf: Dict[str, Any], nfeatures: int, nlabels: int,
                   prediction_type: str, device="cuda") -> MLPProbe:
    """A JAX `MLPProbe`'s params and BN running stats (as numpy) → the
    port's probe on `device`: Dense weights transposed into nn.Linear's
    (out, in) layout, BN scale / bias → weight / bias, running mean / var.
    The optimizer starts fresh, as JAX's does."""
    model = MLPProbe(nfeatures, nlabels, prediction_type, conf, device=device)
    linears = [m for m in model.net if isinstance(m, nn.Linear)]
    norms = [m for m in model.net if isinstance(m, nn.BatchNorm1d)]
    if len(params["hidden"]) != len(norms) or len(bn_state) != len(norms):
        raise ValueError(f"{len(params['hidden'])} hidden layers for a conf with {len(norms)}")

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    with torch.no_grad():
        for lin, src in zip(linears, [*params["hidden"], params["head"]]):
            lin.weight.copy_(t(src["w"]).T)
            lin.bias.copy_(t(src["b"]))
        for bn, lyr, stats in zip(norms, params["hidden"], bn_state):
            bn.weight.copy_(t(lyr["scale"]))
            bn.bias.copy_(t(lyr["bias"]))
            bn.running_mean.copy_(t(stats["mean"]))
            bn.running_var.copy_(t(stats["var"]))
    return model


def _load_split(embed_dir: str, split: str, label_to_idx: Dict[str, int],
                nlabels: int):
    with open(os.path.join(embed_dir, f"{split}.embedding-dimensions.json")) as f:
        n, dim = json.load(f)
    x = np.memmap(os.path.join(embed_dir, f"{split}.embeddings.npy"),
                  dtype=np.float32, mode="r", shape=(n, dim))
    with open(os.path.join(embed_dir, f"{split}.target-labels.pkl"), "rb") as f:
        labels = pickle.load(f)
    y = np.stack([
        score_lib.label_to_binary_vector([label_to_idx[l] for l in row], nlabels)
        for row in labels
    ]) if labels else np.zeros((0, nlabels), np.float32)
    assert np.isfinite(x).all(), f"non-finite embeddings in {split}"
    return np.asarray(x), y


def _primary_sign(metadata: Dict) -> float:
    """+1 when the task's primary metric maximizes, −1 when it minimizes
    (the reference sets EarlyStopping/ModelCheckpoint mode from
    scores[0].maximize, task_predictions.py:994-1005)."""
    return -1.0 if metadata["evaluation"][0] in score_lib.LOWER_IS_BETTER else 1.0


def _postprocess_confs() -> List[Dict]:
    """EVENT_POSTPROCESSING_GRID as sklearn-ParameterGrid-ordered dicts
    (sorted keys, cartesian product — task_predictions.py:117-122)."""
    keys = sorted(EVENT_POSTPROCESSING_GRID)
    return [dict(zip(keys, vals)) for vals in
            itertools.product(*(EVENT_POSTPROCESSING_GRID[k] for k in keys))]


def _select_event_postprocess(probs: np.ndarray, metadata: Dict,
                              target_events: Dict, fname_ts,
                              idx_to_label,
                              strict_reference_bugs: bool = False,
                              ) -> Tuple[float, Dict]:
    """One validation epoch of the reference's EventPredictionModel
    (_score_epoch_end, task_predictions.py:471-516): extract events for
    EVERY postprocessing config, score each with the primary metric
    (NaN → 0.0), pick the best.

    The reference sorts (score, postprocessing) descending UNCONDITIONALLY
    — even when the primary metric minimizes (segment_1s_er), where it
    picks the WORST postprocess. Default here respects the metric
    direction; pass strict_reference_bugs=True to reproduce the
    reference's selection bit-for-bit. Returns (primary score, postprocess)."""
    primary_fn = score_lib.EVENT_SCORES[metadata["evaluation"][0]]
    sign = 1.0 if strict_reference_bugs else _primary_sign(metadata)
    scored = []
    for post in _postprocess_confs():
        pred_events = get_events_for_all_files(probs, fname_ts, idx_to_label,
                                               post)
        s = primary_fn(pred_events, target_events)
        if np.isnan(s):
            s = 0.0
        scored.append((sign * s, s, tuple(sorted(post.items()))))
    scored.sort(reverse=True)
    return scored[0][1], dict(scored[0][2])


def train_probe(x_train, y_train, x_valid, y_valid, metadata, conf,
                seed: int = 42, event_ctx: Optional[Dict] = None,
                strict_reference_bugs: bool = False, device="cuda",
                ) -> Tuple[MLPProbe, float, Optional[Dict]]:
    """Train one probe on `device` with early stopping on the validation
    PRIMARY score.

    Scene tasks monitor the primary scene metric. Event tasks follow the
    reference protocol (task_predictions.py:388-530): at every validation
    check the postprocessing grid is swept on validation predictions, the
    best primary score is the monitored value, and the postprocessing of
    the best epoch is returned for test-time use. `event_ctx` supplies
    {'target_events', 'fname_ts', 'idx_to_label'} for that sweep.  The
    batch order is np.random.RandomState(seed)'s, as in the JAX package.

    Returns (model at its best epoch, best raw score, best postprocessing
    or None for scene tasks)."""
    sign = _primary_sign(metadata)
    is_event = metadata["embedding_type"] == "event"
    bs = conf["batch_size"]
    perm_rng = np.random.RandomState(seed)

    model = MLPProbe(x_train.shape[1], y_train.shape[1],
                     metadata["prediction_type"], conf, seed=seed, device=device)
    # copy=True: splits may be read-only memmaps
    xt = torch.from_numpy(np.array(x_train, np.float32, copy=True)).to(model.device)
    yt = torch.from_numpy(np.array(y_train, np.float32, copy=True)).to(model.device)
    best_signed, best_raw, best_state, best_post, since_best = (
        -np.inf, float("nan"), None, None, 0)
    for epoch in range(conf["max_epochs"]):
        perm = torch.from_numpy(perm_rng.permutation(len(xt))).to(model.device)
        for i in range(0, len(xt), bs):
            idx = perm[i:i + bs]
            if len(idx) < 2:  # BatchNorm needs >1 sample
                continue
            model.train_batch(xt[idx], yt[idx])

        if (epoch + 1) % conf["check_val_every_n_epoch"]:
            continue
        probs = model.probabilities(x_valid)
        post = None
        if is_event:
            val, post = _select_event_postprocess(
                probs, metadata, event_ctx["target_events"],
                event_ctx["fname_ts"], event_ctx["idx_to_label"],
                strict_reference_bugs=strict_reference_bugs)
        else:
            name = metadata["evaluation"][0]
            val = score_lib.SCENE_SCORES[name](probs, y_valid)
        if sign * val > best_signed:
            best_signed, best_raw, best_post, since_best = (
                sign * val, val, post, 0)
            best_state = model.snapshot()
        else:
            since_best += 1
            if since_best >= conf["patience"]:
                break
    if best_state is not None:
        model.restore(best_state)
    return model, float(best_raw), best_post


# -------------------------------------------------------------- event utils

def create_events_from_prediction(
    prediction: np.ndarray,        # (T, C) frame probabilities for ONE file
    timestamps: Sequence[float],   # (T,) ms
    idx_to_label: Dict[int, str],
    threshold: float = 0.5,
    median_filter_ms: float = 250,
    min_duration_ms: float = 60,
) -> List[Dict]:
    """Frame probabilities → event list via median filter + thresholding +
    min-duration pruning (reference task_predictions.py:615-683)."""
    if len(timestamps) > 1:
        frame_ms = timestamps[1] - timestamps[0]
        ksize = max(1, int(round(median_filter_ms / max(frame_ms, 1e-6))))
    else:
        ksize = 1
    smoothed = median_filter(prediction, size=(ksize, 1))
    active = smoothed > threshold

    events = []
    ts = np.asarray(timestamps, np.float64)
    for c in range(prediction.shape[1]):
        on = None
        col = active[:, c]
        for t in range(len(col)):
            if col[t] and on is None:
                on = ts[t]
            if on is not None and (not col[t] or t == len(col) - 1):
                # end = the LAST ACTIVE frame's timestamp (reference
                # task_predictions.py:672-676) — ending on the first
                # inactive frame would stretch every event by one step and
                # keep single-frame events the reference drops
                off = ts[t - 1] if not col[t] else ts[t]
                if off - on >= min_duration_ms:
                    events.append({"label": idx_to_label[c],
                                   "start": float(on), "end": float(off)})
                on = None
    return sorted(events, key=lambda e: (e["start"], e["label"]))


def get_events_for_all_files(predictions: np.ndarray, filename_timestamps,
                             idx_to_label, postprocess: Dict) -> Dict[str, List[Dict]]:
    """Group frame rows by source file, extract events per file. Returns
    {filename: [events]} with an entry for EVERY file — empty-prediction
    files stay present, which matters because scoring iterates prediction
    filenames (reference get_events_for_all_files, task_predictions.py:686-764)."""
    rows_by_file = defaultdict(list)
    for i, (slug, ts) in enumerate(filename_timestamps):
        rows_by_file[slug].append((ts, i))
    events: Dict[str, List[Dict]] = {}
    for slug, rows in rows_by_file.items():
        rows.sort()
        ts = [r[0] for r in rows]
        pred = predictions[[r[1] for r in rows]]
        events[os.path.basename(slug)] = create_events_from_prediction(
            pred, ts, idx_to_label,
            median_filter_ms=postprocess["median_filter_ms"],
            min_duration_ms=postprocess["min_duration"])
    return events


def _reference_events(embed_dir: str, split: str) -> Dict[str, List[Dict]]:
    """{split}.json → {filename: [events]} (the reference's
    validation/test_target_events, task_predictions.py:417-420)."""
    with open(os.path.join(embed_dir, f"{split}.json")) as f:
        split_data = json.load(f)
    return {fname: [{"label": e["label"], "start": e["start"], "end": e["end"]}
                    for e in evs]
            for fname, evs in split_data.items()}


# --------------------------------------------------------------- orchestrate

def _concat_splits(parts):
    assert parts, "no training splits"
    xs, ys = zip(*parts)
    return np.concatenate(xs), np.concatenate(ys)


def _load_fname_ts(embed_dir, split):
    with open(os.path.join(embed_dir, f"{split}.filename-timestamps.json")) as f:
        return json.load(f)


def _event_scores(probs, embed_dir, split, metadata, idx_to_label, post):
    ref_events = _reference_events(embed_dir, split)
    pred_events = get_events_for_all_files(probs, _load_fname_ts(embed_dir, split),
                                           idx_to_label, post)
    return {name: score_lib.EVENT_SCORES[name](pred_events, ref_events)
            for name in metadata["evaluation"]
            if name in score_lib.EVENT_SCORES}


def _score_model(model, embed_dir, metadata, test_s, data_test, idx_to_label,
                 postprocess: Optional[Dict] = None):
    probs = model.probabilities(data_test[0])
    if metadata["embedding_type"] == "scene":
        return {name: score_lib.SCENE_SCORES[name](probs, data_test[1])
                for name in metadata["evaluation"]
                if name in score_lib.SCENE_SCORES}
    # test uses the postprocessing chosen at the best VALIDATION epoch
    # (reference epoch_best_postprocessing, task_predictions.py:425-434)
    return _event_scores(probs, embed_dir, test_s, metadata, idx_to_label,
                         postprocess or _postprocess_confs()[0])


def task_predictions(
    embed_dir: str,
    grid: Optional[Dict] = None,
    grid_points: int = 8,
    seed: int = 42,
    gpus: None = None,  # accepted for CLI parity; `device` places the probes
    strict_reference_bugs: bool = False,
    device="cuda",
) -> Dict:
    """Full prediction phase for one task directory
    (reference task_predictions.py:1273-1447):

    - train/valid/test tasks: random grid search on (train, valid), best
      config scored on test
    - k-fold tasks (splits = fold00..): grid search on the first fold
      assignment, then the best config re-trained on every fold rotation
      (test=fold i, valid=fold i+1, train=rest) and scores aggregated
      mean/std (reference data_splits_from_folds, :1122-1157)
    Writes test.predicted-scores.json + prediction-done.json.  The probes
    train on `device`: the card unless "cpu" is given.
    """
    rng = random.Random(seed)
    with open(os.path.join(embed_dir, "task_metadata.json")) as f:
        metadata = json.load(f)
    with open(os.path.join(embed_dir, "labelvocabulary.csv")) as f:
        rows = list(csv.DictReader(f))
    label_to_idx = {r["label"]: int(r["idx"]) for r in rows}
    idx_to_label = {v: k for k, v in label_to_idx.items()}
    nlabels = len(label_to_idx)

    grid = grid or PARAM_GRID
    keys = sorted(grid)
    all_confs = [dict(zip(keys, vals))
                 for vals in itertools.product(*(grid[k] for k in keys))]
    rng.shuffle(all_confs)
    confs = all_confs[:grid_points]

    splits = metadata["splits"]
    kfold = not (set(splits) >= {"train", "valid", "test"})
    data = {s: _load_split(embed_dir, s, label_to_idx, nlabels) for s in splits}

    if kfold:
        folds = sorted(splits)
        k = len(folds)
        assignments = []
        for i in range(k):
            test_s, valid_s = folds[i], folds[(i + 1) % k]
            train_ss = [folds[j] for j in range(k)
                        if j != i and j != (i + 1) % k]
            # 2-fold tasks have no third fold: train on the validation fold
            assignments.append((test_s, valid_s, train_ss or [valid_s]))
    else:
        assignments = [("test", "valid", ["train"])]

    is_event = metadata["embedding_type"] == "event"

    def _event_ctx(valid_s):
        if not is_event:
            return None
        return {"target_events": _reference_events(embed_dir, valid_s),
                "fname_ts": _load_fname_ts(embed_dir, valid_s),
                "idx_to_label": idx_to_label}

    # grid search on the first assignment
    test0, valid0, train0 = assignments[0]
    x_tr, y_tr = _concat_splits([data[s] for s in train0])
    sign = _primary_sign(metadata)
    ctx0 = _event_ctx(valid0)
    best = {"signed": -np.inf, "score": float("nan"), "conf": None,
            "model": None, "post": None}
    for conf in confs:
        model, val, post = train_probe(x_tr, y_tr, *data[valid0], metadata,
                                       conf, seed=seed, event_ctx=ctx0,
                                       strict_reference_bugs=strict_reference_bugs,
                                       device=device)
        logger.info("conf %s → valid %.4f", conf, val)
        if sign * val > best["signed"]:
            best = {"signed": sign * val, "score": val, "conf": conf,
                    "model": model, "post": post}

    # evaluate (re-training the best config per fold rotation); event-task
    # postprocessing comes from each fold's best VALIDATION epoch
    per_fold: List[Dict[str, float]] = []
    for i, (test_s, valid_s, train_ss) in enumerate(assignments):
        if i == 0:
            model, post = best["model"], best["post"]
        else:
            x_tr, y_tr = _concat_splits([data[s] for s in train_ss])
            model, _, post = train_probe(x_tr, y_tr, *data[valid_s], metadata,
                                         best["conf"], seed=seed,
                                         event_ctx=_event_ctx(valid_s),
                                         strict_reference_bugs=strict_reference_bugs,
                                         device=device)
        per_fold.append(_score_model(model, embed_dir, metadata, test_s,
                                     data[test_s], idx_to_label,
                                     postprocess=post))

    names = sorted({n for f in per_fold for n in f})
    scores = {n: float(np.mean([f[n] for f in per_fold if n in f])) for n in names}
    aggregated = {}
    for n in names:
        vals = [f[n] for f in per_fold if n in f]
        aggregated[f"test_{n}_mean"] = float(np.mean(vals))
        aggregated[f"test_{n}_std"] = float(np.std(vals))

    result = {
        "best_conf": best["conf"],
        "valid_score": best["score"],
        "num_folds": len(assignments),
        "test": scores,
        "aggregated_scores": aggregated,
    }
    with open(os.path.join(embed_dir, "test.predicted-scores.json"), "w") as f:
        json.dump(result, f, indent=2)
    with open(os.path.join(embed_dir, "prediction-done.json"), "w") as f:
        json.dump({"done": True}, f)
    return result
