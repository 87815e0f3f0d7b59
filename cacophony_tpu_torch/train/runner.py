"""Training runner CLI: stage-2 (CACO) or stage-1 (MAE) training on one
device or data-parallel over several (cacophony_tpu/train/runner.py:47-211).

    python -m cacophony_tpu_torch.train.runner --stage caco --data-dir DIR \
        --workdir WORK --tokenizer TOKDIR [--device cpu] [--dtype bfloat16] \
        [--init-audio-from-mae STAGE1_FILE] [--init-text-from-hf HF_DIR]
    python -m cacophony_tpu_torch.train.runner --stage mae --data-dir DIR \
        --workdir WORK [--device cpu] [--dtype bfloat16]
    torchrun --nproc-per-node N -m cacophony_tpu_torch.train.runner ... --dp N
    torchrun --nproc-per-node 2 -m cacophony_tpu_torch.train.runner ... --dp 1 --tp 2

Data layout: DIR holds wavs (any depth) and `captions.csv` with columns
(file_name, caption), several rows per file allowed, and optionally
`synthetic_captions.csv` in the same format.  The pieces: the host loader
(native decode, seeded caption choice) → pinned prefetch → the device
frontend with random patch subsampling → the stage-2 step → JSONL metrics
every `--log-every` steps and the train state every `--checkpoint-every`
steps and at the end, resumed from `WORK/checkpoints`.

Step i draws its patch subset and dropout masks from a generator seeded by
(seed, i), as JAX folds the step into its key, and the loader skips the
batches already trained on without decoding them: a resumed run draws what
an unbroken run draws.  `--total-steps` (default `--steps`) is the length
of the learning-rate schedule, so a run may stop early and resume on the
same schedule.  `--dtype` is the compute dtype of either stage (the JAX
runner trains in fp32; bf16 runs K7 as K4's backward at 500 patches).

`--stage mae` needs no captions: every wav gets a dummy caption and a
dummy tokenizer, the batch is the training frontend's alone, and the model
is `audiomae_base()` (`--tiny-model`: a 32-wide, 2-layer, 2-head encoder
and decoder with a 64-wide MLP).  `--init-audio-from-mae` starts stage 2's
audio tower from a stage-1 file's encoder (`load_audiomae`, the published
count guards on unless `--tiny-model`).  `--init-text-from-hf DIR` then
replaces the text tower's embeddings and blocks with a local HF RoBERTa
directory's (checkpoints/hf.py; nothing is downloaded).

`--dp N` / `--tp T` (or a torchrun launch) joins the process group
(`initialize_multihost`) and trains over a ('dp', 'tp') mesh, dp·tp the
world size (`--dp` defaults to world // tp): every rank starts from rank
0's parameters, keeps its tp block of the sharded leaves
(`shard_params`), loads the global batch and runs the device frontend on
it with the step's generator, then keeps its dp rows (`shard_batch`; the
tp ranks of a dp group hold the same rows); the step optimizes the global
batch's loss.  Rank 0 alone writes the metrics and the checkpoints, which
hold whole leaves (gathered over tp), so a run of any (dp, tp) resumes one
of any other, one device included.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import itertools
import os
import sys
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.checkpoints.convert import transplant_audiomae_encoder
from cacophony_tpu_torch.checkpoints.hf import load_hf_text_tower
from cacophony_tpu_torch.checkpoints.io import (
    latest_step,
    load_audiomae,
    load_train_state,
    save_train_state,
)
from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.data.pipeline import (
    CacoTrainLoader,
    TrainDataConfig,
    device_train_frontend,
    prefetch_to_device,
)
from cacophony_tpu_torch.data.tokenizer import load_tokenizer
from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples
from cacophony_tpu_torch.models.audio import audiomae_init
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.parallel import make_mesh, shard_batch, shard_params
from cacophony_tpu_torch.parallel.multihost import initialize_multihost
from cacophony_tpu_torch.train.train import (
    TrainConfig,
    init_train_state,
    make_caco_train_step,
    make_mae_train_step,
)
from cacophony_tpu_torch.utils import MetricsLogger

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _read_captions(path: str) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    if not os.path.exists(path):
        return out
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.setdefault(row["file_name"].split(".wav")[0], []).append(row["caption"])
    return out


def build_parser():
    p = argparse.ArgumentParser("cacophony_tpu_torch.train.runner")
    p.add_argument("--stage", choices=["caco", "mae"], default="caco")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--workdir", required=True, help="checkpoints + metrics")
    p.add_argument("--tokenizer", default="roberta-base",
                   help="a directory holding vocab.json and merges.txt")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--total-steps", type=int, default=None,
                   help="length of the learning-rate schedule (default: --steps)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--buffer-seconds", type=float, default=10.0)
    p.add_argument("--patches-seq-len", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    p.add_argument("--tiny-model", action="store_true", help="tiny config (smoke tests)")
    p.add_argument("--init-audio-from-mae", default=None,
                   help="AudioMAE checkpoint to transplant the audio tower from")
    p.add_argument("--init-text-from-hf", default=None,
                   help="local HF RoBERTa directory to initialize the text tower from")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks (default: the launcher's world size)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (Megatron: heads and MLP blocks split)")
    return p


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`: seeded by (seed, step) alone."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return g


class _DummyTok:
    """The MAE stage's tokenizer: every caption becomes ones."""

    bos_token_id, eos_token_id, pad_token_id = 0, 2, 1

    def __call__(self, texts, **kw):
        shape = (len(texts), kw.get("max_length", 8))
        return {"input_ids": np.ones(shape, np.int32), "attention_mask": np.ones(shape, np.int32)}


def _tiny_mae() -> configs.AudioMAEConfig:
    enc = configs.AudioEncoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                     intermediate_size=64)
    dec = configs.AudioDecoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                     intermediate_size=64)
    return configs.AudioMAEConfig(encoder=enc, decoder=dec)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.init_text_from_hf and not os.path.isdir(args.init_text_from_hf):
        sys.exit(f"--init-text-from-hf {args.init_text_from_hf}: not a directory; the HF "
                 "RoBERTa files must be local (nothing is downloaded)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on the CPU")
    if not (args.dp is not None or args.tp > 1 or "WORLD_SIZE" in os.environ):
        return _train(args, device, None)
    owns_group = not dist.is_initialized()
    try:
        initialize_multihost(device=device)
        mesh = make_mesh(dp=args.dp, tp=args.tp, device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return _train(args, device, mesh)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device: torch.device, mesh):
    rank0 = mesh is None or dist.get_rank() == 0
    os.makedirs(args.workdir, exist_ok=True)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=args.warmup_steps,
                     total_steps=args.total_steps or args.steps)
    caco = args.stage == "caco"

    # ---- data
    wavs = sorted(glob.glob(os.path.join(args.data_dir, "**", "*.wav"), recursive=True))
    if not wavs:
        raise FileNotFoundError(f"no wavs under {args.data_dir}")
    captions = _read_captions(os.path.join(args.data_dir, "captions.csv"))
    synthetic = _read_captions(os.path.join(args.data_dir, "synthetic_captions.csv"))
    if caco and not captions:
        raise FileNotFoundError("stage caco needs captions.csv")
    if not caco:  # MAE needs no captions: a dummy entry for every wav
        captions = {os.path.basename(w).split(".wav")[0]: ["-"] for w in wavs}
    tokenizer = load_tokenizer(args.tokenizer) if caco else _DummyTok()
    dcfg = TrainDataConfig(batch_size=args.batch_size, buffer_seconds=args.buffer_seconds,
                           seed=args.seed)
    loader = CacoTrainLoader([w for w in wavs if os.path.basename(w).split(".wav")[0] in captions],
                             captions, tokenizer, dcfg, synthetic_captions=synthetic)

    # ---- model / frontend
    front = FrontendConfig()
    buffer_samples = int(round(args.buffer_seconds * front.sample_rate))
    full_seq = num_patches_for_samples(buffer_samples, front, PatchConfig())
    full_patch = PatchConfig(patches_seq_len=max(full_seq, args.patches_seq_len))
    frontend = device_train_frontend(front, full_patch, args.patches_seq_len)
    gen0 = torch.Generator().manual_seed(args.seed)
    dtype = _DTYPES[args.dtype]
    if caco:
        cfg = (configs.caco_tiny(vocab_size=max(300, getattr(tokenizer, "vocab_size", 0) or 0))
               if args.tiny_model else configs.caco_base())
        cfg = dataclasses.replace(cfg, dtype=dtype)
        model = caco_init(cfg, gen0).to(device)
        if args.init_audio_from_mae:
            _, mae = load_audiomae(args.init_audio_from_mae, strict_counts=not args.tiny_model,
                                   device=device)
            transplant_audiomae_encoder(model, mae)
            del mae
        if args.init_text_from_hf:
            load_hf_text_tower(model, args.init_text_from_hf)
        step_fn = make_caco_train_step(cfg, tc, mesh)
    else:
        cfg = dataclasses.replace(_tiny_mae() if args.tiny_model else configs.audiomae_base(),
                                  dtype=dtype)
        model = audiomae_init(cfg.encoder, cfg.decoder, gen0).to(device)
        step_fn = make_mae_train_step(cfg, tc, mesh)
    if mesh is not None:
        shard_params(model, mesh)

    # ---- state (+ resume)
    state = init_train_state(model, tc)
    ck_dir = os.path.join(args.workdir, "checkpoints")
    if latest_step(ck_dir) is not None:
        state = load_train_state(ck_dir, state)
        if rank0:
            print(f"resumed from step {state.step}", flush=True)
    metrics_log = MetricsLogger(os.path.join(args.workdir, "metrics.jsonl")) if rank0 else None
    start = state.step
    loader.start_batch = start  # resume the data stream, don't replay it
    batches = itertools.islice(loader, max(0, args.steps - start))
    for step_i, host in enumerate(prefetch_to_device(batches, size=2, device=device), start):
        gen = step_generator(args.seed, step_i, device)
        batch = frontend(gen, host["audio_bufs"], host["audio_lens"])
        if caco:
            batch["text_input_ids"], batch["text_mask"] = host["text_input_ids"], host["text_mask"]
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        state, metrics = step_fn(state, batch, gen)
        if metrics_log is not None and step_i % args.log_every == 0:
            metrics_log.log(step=step_i, **{k: float(v) for k, v in metrics.items()})
        if args.checkpoint_every and (step_i + 1) % args.checkpoint_every == 0:
            save_train_state(state, ck_dir, mesh=mesh)
    save_train_state(state, ck_dir, mesh=mesh)
    if rank0:
        print(f"done at step {state.step}", flush=True)
    return state


if __name__ == "__main__":
    main()
