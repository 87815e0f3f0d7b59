"""Evaluation tasks: zero-shot classification, retrieval and captioning
(cacophony_tpu/eval/tasks.py), on the port's CacoEngine.

Task semantics match the reference CLIs (src/eval/eval_caco.py:144-306) —
prompt prefixes, 10 s/30 s patch budgets, scoring rule, metric definitions —
but the execution model is batched engine calls instead of the reference's
per-file, batch-1 host loop (SURVEY §3.2's documented stall): audio is
decoded on the host and embedded in fixed-size device batches, each clip
forwarded exactly once.  The engine runs on the device it was built for:
the card, or the CPU when the caller asked for it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cacophony_tpu_torch.data.audio_io import load_audio
from cacophony_tpu_torch.eval.metrics import format_metrics, retrieval_metrics
from cacophony_tpu_torch.eval.processors import DatasetProcessor
from cacophony_tpu_torch.runtime.engine import CacoEngine
from cacophony_tpu_torch.utils import profiling

DEFAULT_ZS_PREFIX = "This is a sound of "  # reference eval_caco.py:144
TUT_ZS_PREFIX = "This is a sound on "      # reference eval_caco.py:333


def _load_dataset_audio(processor: DatasetProcessor, filepaths: Sequence[str]):
    """Lazy per-file decode generator: the engine consumes it in bounded
    buckets, so a VGGSound-scale run (12,722 clips at 48 kHz — multiple GB
    if materialized) keeps peak host RAM at O(batch) like the reference's
    per-file loop (eval_caco.py:195-221)."""
    sr = processor.config.sampling_rate
    return (load_audio(p, expected_sr=sr) for p in filepaths)


def zs_classification(
    engine: CacoEngine,
    processor: DatasetProcessor,
    split: str = "",
    text_prefix: str = DEFAULT_ZS_PREFIX,
    verbose: bool = True,
) -> float:
    """Zero-shot: rank prompted class embeddings per clip, top-1 accuracy
    (reference eval_caco.py:144-181).  Its report: the recorder's spans of
    the run (each stage returns host arrays, so a stage's host time holds
    its device work)."""
    filepaths, descriptions, _ = processor.get_filepaths_and_descriptions(split)
    class_labels = sorted({descriptions[a]["description"][0] for a in descriptions})
    class_to_idx = {c: i for i, c in enumerate(class_labels)}

    with profiling.recording() as stages:
        with profiling.span("zs.text_embed"):
            text_emb = engine.embed_texts([text_prefix + c for c in class_labels])
        with profiling.span("zs.decode_embed_stream"):
            # host decode streams through the engine's bounded bucket window —
            # decode of bucket k+1 overlaps device compute of bucket k
            audio_emb = engine.embed_audio(_load_dataset_audio(processor, filepaths))
        with profiling.span("zs.score"):
            logits = engine.score(audio_emb, text_emb)
    pred = logits.argmax(axis=-1)

    targets = np.asarray(
        [class_to_idx[descriptions[_name(p)]["description"][0]] for p in filepaths]
    )
    acc = float((pred == targets).mean())
    if verbose:
        print(f"top 1 accuracy: {acc:.4f} ({len(filepaths)} clips, "
              f"{len(class_labels)} classes)")
        print(profiling.report(stages))
    return acc


def _name(path: str) -> str:
    return os.path.basename(path).split(".wav")[0]


def audio_retrieval(
    engine: CacoEngine,
    processor: DatasetProcessor,
    split: str = "evaluation",
    verbose: bool = True,
) -> Dict[str, Dict]:
    """Bidirectional retrieval over the full gallery
    (reference eval_caco.py:183-235)."""
    filepaths, descriptions, _ = processor.get_filepaths_and_descriptions(split)

    all_text: List[str] = []
    gt_audio_text: Dict[str, List[str]] = {}
    gt_text_audio: Dict[str, str] = {}
    audio_names = []
    for path in filepaths:
        name = _name(path)
        audio_names.append(name)
        caps = descriptions[name]["description"]
        gt_audio_text[name] = list(caps)
        for c in caps:
            gt_text_audio[c] = name
            all_text.append(c)

    audio_emb = engine.embed_audio(_load_dataset_audio(processor, filepaths))
    text_emb = engine.embed_texts(all_text)

    # similarity (text, audio); logit scale is rank-irrelevant but kept for
    # parity with the reference's score matrix
    sim = engine.score(audio_emb, text_emb).T

    results = {}
    at_indices = np.argsort(-sim.T, axis=-1)
    results["audio_to_text"] = retrieval_metrics(
        at_indices, audio_names, all_text, gt_audio_text, "at")
    ta_indices = np.argsort(-sim, axis=-1)
    results["text_to_audio"] = retrieval_metrics(
        ta_indices, all_text, audio_names, gt_text_audio, "ta")

    if verbose:
        print("audio to text retrieval:")
        print(format_metrics(results["audio_to_text"]))
        print("text to audio retrieval:")
        print(format_metrics(results["text_to_audio"]))
    return results


def audio_captioning(
    engine: CacoEngine,
    processor: DatasetProcessor,
    split: str = "evaluation",
    output_dir: Optional[str] = None,
    max_length: int = 100,
    temperature: float = 0.1,
    seed: int = 42,
    verbose: bool = True,
) -> Tuple[List[str], List[List[str]]]:
    """Caption every clip; write predictions.csv/gt.csv in the reference's
    format when output_dir is given (eval_caco.py:296-306)."""
    filepaths, descriptions, _ = processor.get_filepaths_and_descriptions(split)
    sr = processor.config.sampling_rate

    preds: List[str] = []
    for i in range(0, len(filepaths), engine.batch_size):
        # decode one engine bucket of files at a time (bounded host RAM)
        chunk = [load_audio(p, expected_sr=sr)
                 for p in filepaths[i:i + engine.batch_size]]
        preds.extend(engine.caption(chunk, max_length=max_length,
                                    temperature=temperature, seed=seed + i))
    preds = [p.strip() for p in preds]

    gts = [[c.replace(",", "") for c in descriptions[_name(p)]["description"]]
           for p in filepaths]

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "predictions.csv"), "w") as fp, \
             open(os.path.join(output_dir, "gt.csv"), "w") as fg:
            fp.write("file_name,caption_predicted\n")
            fg.write("file_name," + ",".join(
                f"caption_reference_{i:02d}" for i in range(1, 6)) + "\n")
            for i, path in enumerate(filepaths):
                fp.write(f"{i},{preds[i]}\n")
                fg.write(f"{i}," + ",".join(gts[i]) + "\n")
    if verbose and preds:
        print(f"captioned {len(preds)} clips; first: {preds[0]!r}")
    return preds, gts
