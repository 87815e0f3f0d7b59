"""Evaluation CLI: `python -m cacophony_tpu_torch.eval --task {zs,ar,caption}`
(cacophony_tpu/eval/cli.py).

One typed entry point replacing the reference's two CLIs
(src/eval/eval_caco.py:19-22, eval_caco_torch.py:544-551).  Task configs
follow the reference: ZS uses a 10 s patch budget (500 patches), retrieval
and captioning 30 s (1500 patches) — eval_caco.py:320-384.  The model and
the engine run on `--device`: the card unless the CPU is asked for; with
no card, `cuda` raises.
"""

from __future__ import annotations

import argparse
import json

import torch

from cacophony_tpu_torch.checkpoints.io import load_caco
from cacophony_tpu_torch.configs import caco_tiny
from cacophony_tpu_torch.data.tokenizer import load_tokenizer
from cacophony_tpu_torch.eval.expect import enforce_expectations
from cacophony_tpu_torch.eval.processors import PROCESSORS
from cacophony_tpu_torch.eval.tasks import (
    DEFAULT_ZS_PREFIX,
    TUT_ZS_PREFIX,
    audio_captioning,
    audio_retrieval,
    zs_classification,
)
from cacophony_tpu_torch.runtime.engine import CacoEngine
from cacophony_tpu_torch.utils.profiling import trace

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cacophony_tpu_torch.eval")
    p.add_argument("--ckpt_path", required=True, help="released CACO checkpoint")
    p.add_argument("--task", choices=["zs", "ar", "caption"], default="zs")
    p.add_argument("--dataset", default=None,
                   help=f"one of {sorted(PROCESSORS)}; defaults per task")
    p.add_argument("--split", default=None)
    p.add_argument("--tokenizer", default="roberta-base",
                   help="HF name or local dir with vocab.json/merges.txt")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_text_len", type=int, default=None,
                   help="default: 100 (77 for audiocaps)")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--output_json", default=None,
                   help="write task results to this JSON file")
    p.add_argument("--expect", default=None, metavar="GOLDEN_JSON",
                   help="golden-number regression gate: compare results to "
                        "this goldens file (see eval/goldens/) and exit "
                        "nonzero on drift")
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run here")
    p.add_argument("--no_strict_counts", action="store_true",
                   help="skip published param-count checks (custom models)")
    p.add_argument("--tiny_model", action="store_true",
                   help="load the checkpoint with the tiny test config")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the engine (cuda, or cpu)")
    return p


def _write_json(path, payload):
    if path:
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=float)
        print(f"results written to {path}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trace_dir:
        with trace(args.trace_dir):
            return _run(args)
    return _run(args)


def _run(args):
    tokenizer = load_tokenizer(args.tokenizer)
    cfg, params = load_caco(
        args.ckpt_path,
        cfg=caco_tiny(vocab_size=tokenizer.vocab_size) if args.tiny_model else None,
        strict_counts=not (args.no_strict_counts or args.tiny_model),
        device=args.device,
    )
    engine_kw = dict(tokenizer=tokenizer, device=args.device, batch_size=args.batch_size,
                     dtype=DTYPES[args.dtype])

    if args.task == "zs":
        datasets = [args.dataset] if args.dataset else \
            ["esc50", "tutas2017", "us8k", "vggsound"]
        engine = CacoEngine(cfg, params, buffer_seconds=10.0,
                            max_text_len=args.max_text_len or 100, **engine_kw)
        results = {}
        for name in datasets:
            proc = PROCESSORS[name]()
            prefix = TUT_ZS_PREFIX if name == "tutas2017" else DEFAULT_ZS_PREFIX
            print(f"== zero-shot {name} ==")
            results[name] = zs_classification(engine, proc,
                                              split=args.split or "",
                                              text_prefix=prefix)
        _write_json(args.output_json, {"task": "zs", "top1_accuracy": results})
        if args.expect:
            enforce_expectations(results, args.expect)
        return results

    name = args.dataset or "clotho"
    # Clotho uses a 30 s / text-100 budget, AudioCaps 10 s / text-77
    # (reference eval_caco.py:349-357 and its AudioCaps config :362-370);
    # an explicit --max_text_len always wins.
    buffer_seconds = 10.0 if name == "audiocaps" else 30.0
    max_text_len = args.max_text_len or (77 if name == "audiocaps" else 100)
    engine = CacoEngine(cfg, params, buffer_seconds=buffer_seconds,
                        max_text_len=max_text_len, **engine_kw)
    proc = PROCESSORS[name]()
    split = args.split or ("evaluation" if name == "clotho" else "test")
    if args.task == "ar":
        results = audio_retrieval(engine, proc, split=split)
        _write_json(args.output_json,
                    {"task": "ar", "dataset": name, "results": results})
        if args.expect:
            enforce_expectations(results, args.expect)
        return results
    if args.expect:
        raise SystemExit("--expect supports zs/ar tasks only (the reference "
                         "publishes no caption metrics to gate against)")
    preds, gts = audio_captioning(engine, proc, split=split,
                                  output_dir=args.output_dir)
    _write_json(args.output_json,
                {"task": "caption", "dataset": name, "num_clips": len(preds)})
    return preds, gts


if __name__ == "__main__":
    main()
