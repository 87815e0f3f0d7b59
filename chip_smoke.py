#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (cacophony_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no final `ok` line):
1. print the card's name and power limit (nvidia-smi); build the CUDA
   kernels from cacophony_tpu_torch/csrc (one nvcc per source, in parallel);
   where the toolkit has cuobjdump, count the HGMMA (wgmma) instructions of
   the bf16 GEMM, the attention forward and K7's pre-pass and main pass in
   the built library (none fails), and check with `cuobjdump -res-usage`
   that the kernels redesigned last (K8, K8′) use no local memory;
   sweep the bf16 GEMM's branch-free silu epilogue against apply_epilogue
   over every fp32 input (any differing bit fails);
2. hold each K1 kernel, and the K1 layer chain as a whole, against its
   plain PyTorch version on the card: B=8, S=496, D=768, H=8, I=3072, some
   padded keys and one all-masked clip, bf16 and fp32 (the fp32 GEMM and
   attention are the register-tiled SIMT kernels); the GEMM at ragged
   M, N, K (N, K not multiples of 8: the SIMT kernel in bf16 too), every
   epilogue, bf16 and fp32;
3. K2 and K3 (`fused_block_attention`, the chain up to LN2) against the plain
   version: B=8, K2 at S=496 in fp32, K3 at S=1496 padded to 1536 inside
   in bf16 and fp32, mixed lengths and a clip with no valid patch;
3b. K6 (`fused_ln_attention`: LN1 → QKV → attention) at S=496 and K3′
   (`fused_layer` with the blocked variant: the whole layer at S=1496
   padded to 1536 inside) against the plain chain, bf16, B=8;
4. K8 and K8′ (the fused log-mel, fp32 and bf16×3 DFT) against their plain
   versions, and K8′ against K8 within 2e-4: B=9, 1000 and 3000 frames,
   with a quiet and a silent clip and a DC offset plus a Nyquist tone over
   noise (most of its energy in the two bins K8 skips); K8 at mel_fmax =
   7600;
5. caco_base() with random weights from seed 0, a bf16 10-s CacoEngine on
   cuda: embed_audio on 70 clips of 3-10 s (the last bucket is mostly
   padding), embed_texts, score; K1 launched 12 times per bucket;
5b. caco_tiny() in bf16 on cuda (Dh 16: the attention link is the mma.sync
   kernel): K1 launched 2 times per bucket; cosine >= 0.999 against the
   CPU engine;
6. the fp32 10-s engine on the same clips: K2 launched 12 times per bucket
   and K1 none; fp32 card vs fp32 plain on the CPU (cosine >= 0.9999 on 2
   clips); bf16 vs fp32 on the card (cosine >= 0.999);
7. a bf16 10-s engine with fused_frontend=True: K8 launched once per
   bucket; cosine >= 0.9999 against the unfused engine;
8. the 30-s retrieval engine in bf16: 1536 patches, 40 clips of 3-30 s
   with K3 launched 12 times per bucket and K1 none, embed_audio_long on
   clips of 45-75 s; against an fp32 30-s engine (no kernel: the einsum
   route) at cosine >= 0.999;
8b. the paths of K6, K3′ and K8′ at caco_base in bf16, through their own
   entry points: a 12-layer 10-s encoder (B=32, S=496) with every layer on
   route "k6" (K6 12 times, no K1; cosine >= 0.999 against the K1 route),
   a 12-layer 30-s encoder (B=8, 1536 patches) through
   `try_fused_layer(allow_blocked=True)` (K3′ 12 times, no K3; cosine >=
   0.999 against the K3 route), `fused_batch_wav_to_patches(fast_dft=True)`
   on 10-s buffers (K8′ once) and on 30-s ones (K8′ none: JAX's exact
   fallback, K8 once);
8c. gradients through the inference encoder: bf16 10 s at B=8 (K1 12
   times in the forward; every block parameter's gradient present and
   finite), fp32 at B=2 (K2 route) against the CPU (relative L2 <= 1e-4);
9. K4, K5 and K7 against their plain versions: K4 at B=8, S=500, H=8,
   Dh=96 in bf16 and fp32 and causal at H=12, Dh=64, S=100, padded keys
   and an all-masked clip; K5 at S=1500 (the plain version padded to
   1536), and bit-identical to the kernel over the padded row; K7 in bf16
   at S=500 and fp32 at S=100, causal and not, the all-masked clip's
   gradients finite and zero; the attention link, K4 (causal) and K7 at
   head dims 16, 32 and 128 in bf16 and fp32, with an all-masked clip and
   with logits far above the clamp of 80; the wgmma K7 at Dh 64 and 96,
   S = 1, 63, 128, 500, 579, causal and not, logits above the clamp; heads
   past 128 columns (Dh 160, 192, 256, 384) in both dtypes for the
   attention link, K4 causal, K5's strides and K7, and a K1 chain at Dh
   256; the frequency table's gradient (`table_grad`) at 128 × 500
   patches into 8 rows of width 768 and 512, bf16 and fp32, against its
   plain version and bit-identical on a second call;
10. the stage-2 training step (train/train.py) at caco_base in bf16: B=16,
   500 patches from `device_train_frontend` on synthetic 3-10-s wavs, 100
   tokens; 5 steps on one batch with warmup 1: K4 and K7 launched 12 times
   per step, `table_grad` once, and no K1, K2, K3 or K5; finite loss and
   grad_norm, the loss falls from step 1 to step 4; peak device memory; the
   device's busy time per step (the union of its kernel intervals,
   torch.profiler);
11. the fp32 10-s step (text dropout off): K4 12 per step and no K7; its
   loss and gradients at B=2 against the same fp32 step on the CPU through
   the plain versions; 3 timed steps;
12. the bf16 30-s step at B=4 (1500 patches, blocked plan 1536): K5 12
   times per step and no K4 or K7; peak memory, 3 timed steps;
13. time embed_audio at batch 32 (10-s and 30-s clips, bf16), each K1
   kernel and chain, the K2 and K3 blocks, K3′, K4, K5, K6, K7, K8, K8′
   and `table_grad` (64 000 × 768 → 8, bf16) against their plain versions,
   and the bf16 10-s training step (median of 6),
   beside the card's name and power limit; each kernel's bound (its bytes
   or operations over the H100's peaks); the redesigned bf16 GEMM and
   attention against one PyTorch call in turns (torch.matmul at the 10-s
   and 30-s products, F.scaled_dot_product_attention at S=496 and 1536, K4
   and K5, SDPA's backward alone for K7), K2's fp32 links and K4 in fp32
   against torch.matmul / SDPA in fp32, K8's three library calls; the
   LayerNorm link's device time (CUDA events around a CUDA graph of 42
   calls, inputs rotated over >= 150 MB, bf16 and fp32) against
   F.layer_norm's, each
   with its share of the bound and rule 2's reading; K8 and K8′ with their
   shares of the bound counted over the work the log-mel needs (the bins
   with a nonzero mel row, the mel nonzeros); the fp32 10-s embed_audio
   rate and the bf16 one with fused_frontend=True beside the default; the
   K5 call against its kernel alone, and the host microseconds per K4 / K5
   call.
14. checkpoints, host data and the runner at caco_base: (a) phase 5's
   model written through caco_params_to_reference and the port's msgpack
   writer (a released-layout file, ~1.16 GB) and read back with
   `load_caco` (config inferred, the published count guards on): every
   tensor identical, the inferred config caco_base(), a bf16 10-s engine
   on the loaded model with K1 12 times per bucket and cosine >= 0.99999
   against phase 5; (b) `train.runner.main` on 48 clips of 3-10 s (PCM16
   mono 16 kHz, PCM16 stereo 44.1 kHz, float32 48 kHz) with a
   captions.csv and a tokenizer directory, bf16, B=16, 500 patches: 3
   steps (every file decoded natively, K4 and K7 12 times per step, finite
   losses, step_00000003 written), then resumed to step 5 (the three
   batches trained on skipped without decoding them, K4 and K7 12 times
   per step); the median step time; (c) one bf16 10-s loss and backward
   with `remat_encoder=True` and one without, from the same parameters and
   generator state: equal losses, gradients within the bf16 chain bound,
   K4 24 and 12 times.  The temporary directories are deleted.
15. stage 1, the AudioMAE at audiomae_base (random weights from the seed):
   (a) the reconstruction forward at bench.py's shape: B=64 10-s buffers
   of 0.1·randn at 500 patches, the last clip 1.5 s (padding inside its
   visible set), mask 0.8 by `mae_random_masking`: the encoder at 100
   patches and the decoder at 500 take `layer_route`'s routes (bf16: K1 24
   times a forward; fp32: K1 12 and K2 12); K1 (S=100 bf16 and fp32, S=500
   bf16), K2 (S=500 fp32), K4 and K7 (B=16 at S=100 and 500; fp32 K7 at 100
   only) against their plain versions on the first layer's real inputs;
   `mae_recon_clips_per_s`, the median of 5 bf16 forwards; min cosine over
   patch rows, fp32 card vs the CPU's plain path at B=2 (>= 0.9999) and
   bf16 vs fp32 on the card (>= 0.999); (b) the stage-1 step, B=16, 500
   patches: bf16 4 steps under one masking (K4 and K7 24 times a step, the
   loss falls), fp32 (K4 24, K7 12: the decoder's 500 patches fail fp32's
   `bwd_fits_vmem`), `table_grad` 3 times a step in both, step times, peak
   memory, and fp32 loss and gradients at B=2 against the CPU (1e-5,
   1e-4); (c) (a)'s model written as a
   released-layout stage-1 file and read back with `load_audiomae` (strict
   counts, config inferred == audiomae_base()), its bf16 reconstruction
   bit-identical to (a)'s; `runner --stage mae` for 2 steps and `runner
   --stage caco --init-audio-from-mae` for 1 on phase 14b's files (the
   audio tower equals the file's encoder after step 0, whose rate is 0).
16. captioning at caco_base (random weights from the seed, the byte-level
   tokenizer): (a) `CacoEngine.caption` with the reference's defaults (max
   100, T 0.1, seed 42) on 8 clips of 3-10 s in 10-s buffers, bf16 (K1 12
   times in the audio pass), fp32 (K2 12 times) and bf16 with the fused
   frontend (K8 once); fp32 stepwise decode logits against the
   teacher-forced `caption_logits` on the produced tokens (max rel <=
   1e-4); the CUDA-graph step against the eager one at top_k=1 (identical
   tokens); bf16 against fp32 first-step logits (cosine >= 0.999); one
   window of graph steps and one of eager steps under
   `torch.cuda.set_sync_debug_mode("error")` (no host sync); (b)
   `decode_tokens_per_s` at bench.py's shape (bf16, 256 streams × 64, 500
   patches, T 1.0; 1 warm-up, then 3 calls and one sync, graph and eager in
   turns), the audio pass, the decoder's build and the steps in ms, the
   steps' device busy time and idle share (torch.profiler), peak memory;
   (c) `continuous_tokens_per_s` (256 requests on 256 slots, drain_every
   32, max_length 64), the tokens generated, the prefill's K1 launches, and
   near-greedy (T 1e-6) fp32 captions of 8 requests on 3 slots against
   batch decode (equal, or a top-two logit gap below 1e-4 where they first
   differ); (d) `GalleryIndex` with 262 144 × 768 fp32 rows added in four
   parts (capacity grows past its 131 072-row slab), 1 % deleted, 1024
   queries, top-10 against numpy (indices equal, scores to 1e-5), a save /
   load round trip, ms per search.
17. eval and HEAR, the user's entry points called in process with
   `--device cuda`, on caco_base and audiomae_base files written from
   seeds (released layout, strict counts) and the byte-level tokenizer:
   (a) `python -m cacophony_tpu_torch.eval` on a synthetic ESC-50 (5
   categories × 8 clips of 2-5 s, 44.1-kHz PCM16: two buckets of 32, the
   second ragged): zs fp32 (K2 12 a bucket) and bf16 (K1 12 a bucket),
   top-1 in [0, 1], clips/s with the host decode; `--expect` on a golden
   of the run's own top-1 passes and, moved past its atol, exits non-zero;
   on a synthetic Clotho (40 clips of 15-30 s, 5 captions each): ar bf16
   (the 30-s engine at 1536 patches: K3 12 a bucket) and fp32 (the einsum
   route: no K1-K3), the metrics recomputed with numpy from the engine's
   own embeddings and scores; caption bf16 (K3 12 in each bucket's audio
   pass), predictions.csv / gt.csv in the reference's format, one row a
   clip; (b) `hear.runner.run` (caco and audiomae) on a scene task
   (multiclass, 3 labels, 32 / 16 / 16 clips of 2-10 s) and an event task
   (10-s clips, 6 / 4 / 4), batches of 8 at 500 patches in fp32 (K2 12 a
   batch): scene 768-d, event (62, 768) a clip at linspace(0, 10000, 62)
   ms, all finite; 2 clips' scene embeddings against the CPU's plain path
   (cosine >= 0.9999); K2 on the first layer's real inputs against its
   plain version on the padded rows; `predictions_runner.run(grid="faster")`
   with every probe on the card, the result files, every score in its
   range, scikit-learn never imported; (c) the rates, warm (after (a) and
   (b) in this process), two runs of each in turns: zs fp32 and bf16 on 400
   ESC-50-shaped clips (5 s at 44.1 kHz, 40 in each of 10 categories) and
   the host's read and resample of 32 of them alone; `hear.runner.run`
   (caco, audiomae) on a 5-fold scene task of 5 × 48 clips of 5 s (the
   size of HEAR's Beijing Opera Percussion), then
   `predictions_runner.run(grid="faster")` over its two folders, each fold
   scored.  The temporary directory is deleted.
18. the modules ported last: (a) a seeded RoBERTa tree at
   roberta-base width (12 × 768, 12 heads, MLP 3072, 50 265 words, 514
   positions, 124.6 M parameters with the HF pooler) written in the three
   HF formats (`flax_model.msgpack` by the port's writer,
   `pytorch_model.bin` by torch.save with `roberta.` names and a
   position_ids buffer, `model.safetensors` by `write_safetensors`), each
   with a config.json, each loaded onto the card into a caco_base model by
   `load_hf_text_tower` (the load seconds; every tower equal to the source
   bit for bit, the text pooler kept), then `train.runner
   --init-text-from-hf` for 2 bf16 steps at B=16 on phase 14b's kind of
   files (K4 and K7 24 times; after step 1, whose rate is 0, the saved text
   tower equals the import); (b) `make_mesh(dp=1)` on NCCL (a one-rank
   group, no launcher) and the stage-2 step with the mesh at phase 10's
   shape (B=16, 500 patches, 100 tokens), 3 steps from the same parameters
   and generator without the mesh, with it, and without it again, in bf16
   (K4 and K7 36 times) and fp32 (K4 36, no K7): the losses before the
   first update bit-identical; where the step repeats itself bit for bit
   (fp32; bf16's K7 sums dQ with float atomics and does not), losses and
   parameters bit-identical, else the differences printed beside the two
   runs without the mesh; one bf16 backward's gradients through the
   coalesced one-rank all-reduce bit for bit; 7 bf16 steps of each in
   turns, the device busy time of one step of each and the device time of
   the all-reduce's NCCL kernels; (c) the bf16 10-s
   engine with the mesh on phase 5's clips and weights, bit-identical to the
   engine without it (K1 12 a bucket), clips/s of both in turns; (d) phase
   16d's gallery with the mesh against the one without (equal results),
   ms of both; (e) `resample_fft` on the card (5-s clips at 44.1 kHz,
   10-s at 48 kHz, to 16 kHz) against `resample_fft_host` within 1e-5, ms a
   clip; (f) `mfu` (utils/flops.py's `pipeline_matmul_flops` at 10 s ×
   (c)'s clips/s without the mesh ÷ the card's bf16 peak) and `train_mfu`
   (16 × `caco_train_step_matmul_flops(caco_base, 500, 100)` ÷ phase 10's
   median step ÷ the peak), with the peak's key and value.
19. tensor parallelism on the one card: two ranks spawned with
   torch.multiprocessing share it over a gloo group on CUDA tensors at
   (dp, tp) = (1, 2) (NCCL takes one rank a device), the kernels built by
   this process first; which collectives gloo takes on CUDA tensors (fp32,
   bf16) is probed and printed; K4, K7 and K5 at a rank's shapes (4 of the
   8 heads, Dh 96; K5's plan that of the full 768 width) against their
   plain versions; the stage-2 step at caco_base (B=16, 500 patches, 100
   tokens, 3 steps) in bf16 and fp32, without and with the configs'
   dropout, held to the one-process step that rank 0 runs alone from the
   same parameters and generators (fp32: losses and grad_norm 1e-5
   relative, parameters 1e-5 relative L2; bf16: losses 1e-2, grad_norm
   2e-2, every parameter within 4·lr·1.05), every replicated leaf
   bit-identical on both ranks after the steps, K4 and K7 launched 12
   times a bf16 step and K4 12 / K7 0 an fp32 one on each rank; the 30-s
   bf16 step (B=4, K5 12 a step); the fp32 stage-1 step at audiomae_base
   (mask 0.8: K4 24 and K7 12 a step); a train state written at tp 2
   (whole leaves) resumed by one process, whose next step equals tp's;
   step times and each rank's peak device memory beside one process's.
Every main path is driven with the launch counts set to 0 just before it
and read just after.  The line before the last is a JSON object with one
entry per TPU kernel (K1, K2, K3, K3′, K4, K5, K6, K7, K8, K8′; `mae_launches` counts
phase 15's: K1 a bf16 reconstruction, K2 an fp32 one, K4 and K7 4 bf16 steps;
`caption_launches` phase 16a's in one caption call: K1 bf16, K2 fp32, K8
with the fused frontend; `decode_launches` and `prefill_launches` phase 16b's
256-stream decode call and 16c's continuous run; `eval_launches` and
`hear_launches` phase 17's eval CLI runs and HEAR runner runs;
`parallel_launches` phase 18's runner run, dp step and dp engine;
`tp_launches` rank 0's in phase 19's tp steps); the last line is
{"ok": true, "device": {...}}.

It needs a CUDA device and never imports JAX.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.checkpoints import bridge, convert, hf, msgpack
from cacophony_tpu_torch.checkpoints import io as ckpt_io
from cacophony_tpu_torch.data import pipeline
from cacophony_tpu_torch.data.audio_io import load_audio
from cacophony_tpu_torch.data.pipeline import device_train_frontend
from cacophony_tpu_torch.data.tokenizer import ByteLevelBPETokenizer, _bytes_to_unicode
from cacophony_tpu_torch.eval import cli as eval_cli
from cacophony_tpu_torch.frontend import dsp, fused
from cacophony_tpu_torch.frontend.patchify import (
    num_patches_for_samples,
    patchify_spectrogram,
    wav_to_patches,
)
from cacophony_tpu_torch.hear import embeddings as hear_emb
from cacophony_tpu_torch.hear import predictions as hear_pred
from cacophony_tpu_torch.hear import predictions_runner
from cacophony_tpu_torch.hear import runner as hear_runner
from cacophony_tpu_torch.models import caco
from cacophony_tpu_torch.models.audio import (
    LN_EPS,
    ViTBlock,
    audio_decoder_input,
    audio_encoder_apply,
    audio_input_embedding,
    audiomae_apply,
    audiomae_init,
    encoder_layer,
)
from cacophony_tpu_torch.models.caco import caco_init, get_audio_embedding
from cacophony_tpu_torch.models.layers import dense, layer_norm
from cacophony_tpu_torch.native import wavio
from cacophony_tpu_torch.parallel import make_mesh, shard_params
from cacophony_tpu_torch.parallel.mesh import coalesced, gather_params
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.continuous import ContinuousCaptioner
from cacophony_tpu_torch.runtime.gallery import GalleryIndex
from cacophony_tpu_torch.train import runner, train
from cacophony_tpu_torch.utils import flops

SEED = 0
DEVICE = "cuda"
N_CLIPS = 70      # 10-s paths: 3 buckets, the last mostly zero-length padding
N_CLIPS_30 = 40   # 30-s path: 2 buckets
BATCH = 32
D, H, INTER = 768, 8, 3072  # caco_base's audio layer: width, heads, MLP
CSRC = "cacophony_tpu_torch/csrc/"
K1_PARTS = {  # launch-count key → source of one kernel of the K1/K2/K3 chain
    "layer_norm": CSRC + "layer_norm.cu",
    "gemm": CSRC + "gemm.cu",
    "attention": CSRC + "attention.cu",
}
CHAIN_SOURCES = ", ".join(K1_PARTS.values())
EA = "cacophony_tpu/ops/encoder_attention.py"
TPU_KERNELS = {  # name → (sources, the Pallas function it replaces, launch-count key)
    "K1": (CHAIN_SOURCES, f"{EA}:594", "k1_layer"),  # _pallas_fused_block, with_mlp=True
    "K2": (CHAIN_SOURCES, f"{EA}:594", "k2_block"),  # _pallas_fused_block, with_mlp=False
    "K3": (CHAIN_SOURCES, f"{EA}:763", "k3_block"),  # _pallas_fused_block_blocked
    "K3′": (CHAIN_SOURCES, f"{EA}:763", "k3_layer"),  # the same, with_mlp=True
    "K4": (CSRC + "attention.cu", f"{EA}:317", "k4"),  # _pallas_forward
    "K5": (CSRC + "attention.cu", f"{EA}:351", "k5"),  # _pallas_forward_blocked
    "K6": (CHAIN_SOURCES, f"{EA}:411", "k6_attn"),  # _pallas_fused_ln
    "K7": (CSRC + "attention_bwd.cu", f"{EA}:1147", "k7"),  # _pallas_backward
    "K8": (CSRC + "log_mel.cu", "cacophony_tpu/frontend/fused.py:153", "log_mel"),
    "K8′": (CSRC + "log_mel.cu", "cacophony_tpu/frontend/fused.py:153", "log_mel_fast"),
}
TRAIN_BATCH, TRAIN_BATCH_30, TEXT_LEN = 16, 4, 100
VARIANT_BATCH_30, GRAD_BATCH = 8, 8  # the K3′ 30-s path; the bf16 gradient phase
TRAIN_STEPS = 5
# |kernel - plain| ≤ atol + rtol·|plain|, elementwise.  bf16: outputs are
# rounded to bf16 (8 mantissa bits) after fp32 sums taken in another order,
# so one rounding step apart is 2^-8 relative; the chain compounds seven
# such steps.  fp32: summation order only.  K8: fp32 sums in another order,
# and the log scales a mel error δ by 0.2/(mel + 1e-5).
TOL = {
    torch.bfloat16: {"kernel": (2e-2, 1e-2), "chain": (6e-2, 3e-2), "k7": (3e-2, 2e-2)},
    torch.float32: {"kernel": (1e-4, 1e-4), "chain": (5e-4, 5e-4), "k7": (1e-4, 1e-4)},
    "log_mel": (1e-4, 0.0),
    "fast_dft": (2e-4, 0.0),
}
# K8′ (the bf16×3 DFT) against its plain version: TOL["log_mel"].  Against
# exact K8: the JAX package's own bound on its fast DFT, 2e-4
# (tests/test_fused_frontend.py:71-82, two clips of 200 frames).  Over
# millions of values the bf16×3 DFT itself passes it on about one value in
# a million — a mel value near 1e-3 whose few DFT bins nearly cancel — so
# the bound is held where the plain version meets it, and elsewhere K8′ may
# be no farther from K8 than the plain version is, plus TOL["log_mel"].  The fp32 gradients through the inference encoder on the
# card against the same computation on the CPU: relative L2 ≤ 1e-4 (fp32
# sums in another order through 12 layers, their forward kernels and the
# rematerialising backward).  The variant paths against the default route
# at caco_base in bf16: cosine ≥ 0.999, the bf16-vs-fp32 bound of phase 6
# (K6 and K3′ round where K1 and K3 do, but the MLP outside K6 and the
# blocked MLP inside K3′ move bf16 rounding points).
GRAD_TOL = 1e-4
COS_VARIANT = 0.999
# The frequency table's gradient against its plain version: both fp32 sums
# of the same rows in another order (8 000 rows a table row at caco_base).
TABLE_GRAD_TOL = 2e-5
# K7's bf16 bound is wider than one kernel's: P and dS are rounded to bf16
# before their products, so a rounding step of either moves a gradient by
# one more.  The fp32 step on the card against the same step on the CPU
# (phase 11): the loss to 1e-5 and the gradients to 1e-4 relative (fp32
# sums in another order through 28 layers and their backward).
STEP_TOL = {"loss": 1e-5, "grads": 1e-4}
# The fused and the unfused frontend give the same fp32 log-mel up to the
# order of fp32 sums (~1e-6); after the cast to bf16 a patch value changes
# only where it lies that close to a rounding boundary, by one bf16 step.
# Those few flips move the bf16 embedding far less than bf16 itself does
# against fp32 (bounded at 0.999 in phase 6).
COS_FUSED = 0.9999


class SmokeFailure(Exception):
    pass


def reset_launches() -> None:
    kern.reset_launches()
    for k in ea.LAYER_LAUNCHES:
        ea.LAYER_LAUNCHES[k] = 0


def launches() -> dict:
    return dict(kern.LAUNCHES, **ea.LAYER_LAUNCHES)


def drive(name, fn, expect):
    """Run one main path with every launch count at 0 just before it; check
    the counts read just after against `expect` (key → exact count, or
    None for "at least once")."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = launches()
    print(f"  {name}: launches {got}")
    for k, want in expect.items():
        ok = got[k] > 0 if want is None else got[k] == want
        check(ok, f"{name}: {k} launched {got[k]} times, expected "
                  f"{'at least once' if want is None else want}")
    return out, got


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int):
    """plain, kernel, kernel, plain in one call; → (kernel ms, plain ms).
    With a library call as kernel_fn and the kernel as plain_fn: kernel,
    library, library, kernel; → (library ms, kernel ms)."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# The least time of a function on one H100 SXM (NVIDIA's published dense
# peaks for the card): the larger of its bytes (each
# input read once, each output written once) over the memory rate and its
# operations over the peak of their type.
PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(ops: dict, nbytes: float):
    """ops: {"bf16" or "fp32": operations} → (bound ms, "operations" or "bytes")."""
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attn_flops(heads, hd, s, valid, products=2):
    """2·S·Dh flops per (query, valid key) for each of `products` S×S
    products (Q·Kᵀ and P·V forward; five in the backward), per head; keys
    that are masked out are work no caller needs."""
    return products * 2 * heads * hd * s * int(sum(valid))


def cuobjdump(flag: str):
    """`cuobjdump <flag>` of the built kernel library, or None where the
    toolkit has no cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, flag, kern.load_library()._name], capture_output=True,
                          text=True, check=True).stdout


def check_sass():
    """Phase 1: the redesigned kernels issue wgmma (HGMMA in the SASS of the
    built library), where the toolkit has cuobjdump."""
    sass = cuobjdump("-sass")
    if sass is None:
        print("  HGMMA in the new kernels: not checked (no cuobjdump)")
        return None
    counts = {"gemm_bf16_wgmma_kernel": 0, "attention_bf16_wgmma_kernel": 0,
              "attn_bwd_pre_wgmma": 0, "attn_bwd_main_wgmma": 0}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in counts if k in line), None)
        elif current and "HGMMA" in line:
            counts[current] += 1
    print(f"  HGMMA instructions in the SASS (all instantiations): {counts}")
    check(all(counts.values()), f"a redesigned kernel issues no wgmma: {counts}")
    return counts


REDESIGNED = ("log_mel_kernel", "log_mel_fast_kernel")  # redesigned in this slice: no local memory


def check_local_memory():
    """Phase 1: the redesigned kernels keep everything in registers and
    shared memory: `cuobjdump -res-usage` reports LOCAL:0 and STACK:0 for
    every instantiation, where the toolkit has cuobjdump."""
    usage = cuobjdump("-res-usage")
    if usage is None:
        print("  local memory of the redesigned kernels: not checked (no cuobjdump)")
        return None
    found, current = {}, None
    for line in usage.splitlines():
        if "Function" in line:
            current = next((k for k in REDESIGNED if k in line), None)
        elif current and "LOCAL:" in line:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            found.setdefault(current, []).append(
                {k: int(fields[k]) for k in ("REG", "STACK", "LOCAL", "SHARED") if k in fields})
            current = None
    print(f"  resource usage of the redesigned kernels (cuobjdump -res-usage): {found}")
    check(set(found) == set(REDESIGNED), f"cuobjdump listed {sorted(found)}, expected {REDESIGNED}")
    check(all(u.get("LOCAL", 0) == 0 and u.get("STACK", 0) == 0 for us in found.values() for u in us),
          f"a redesigned kernel uses local memory: {found}")
    return found


def compare(name, got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    ok = bool((err <= atol + rtol * ref.abs()).all())
    max_err = float(err.max())
    print(f"  {name:<36} max_abs_err {max_err:.3e}  (atol {atol:g}, rtol {rtol:g})"
          f"  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return max_err


def layer_inputs(b, s, d, dtype, gen, lengths):
    x = torch.randn(b, s, d, generator=gen).to(DEVICE, dtype)
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to(DEVICE, torch.int32)
    return x, mask


def layer_cases(blk, x, mask, heads):
    """Each K1 kernel's inputs inside one layer, from the plain chain:
    {kernel: [(label, args), ...]}."""
    dt = x.dtype
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    w = lambda dense: dense.w.to(dt).contiguous()  # noqa: E731
    ln1 = (x, f32(blk.ln1.scale), f32(blk.ln1.bias), 1e-6)
    xn = kern.layer_norm_plain(*ln1)
    qkv_args = (xn, w(blk.attn.qkv), f32(blk.attn.qkv.b), kern.EPI_BIAS)
    qkv = kern.gemm_plain(*qkv_args)
    att = kern.attention_plain(qkv, mask, heads)
    o_args = (att, w(blk.attn.o), f32(blk.attn.o.b), kern.EPI_BIAS_RESID_F32, x)
    yb = kern.gemm_plain(*o_args)
    ln2 = (yb, f32(blk.ln2.scale), f32(blk.ln2.bias), 1e-6)
    up_args = (kern.layer_norm_plain(*ln2), w(blk.mlp.w1), f32(blk.mlp.w1.b), kern.EPI_BIAS_SILU)
    down_args = (kern.gemm_plain(*up_args), w(blk.mlp.w2), f32(blk.mlp.w2.b),
                 kern.EPI_BIAS_CAST_ADD, yb)
    return {
        "layer_norm": [("layer_norm LN1", ln1), ("layer_norm LN2", ln2)],
        "gemm": [("gemm qkv + bias", qkv_args), ("gemm o-proj + bias + f32 resid", o_args),
                 ("gemm mlp up + bias + silu", up_args),
                 ("gemm mlp down + bias, cast, + resid", down_args)],
        "attention": [("attention", (qkv, mask, heads))],
    }


@torch.inference_mode()
def kernel_phase(blk):
    """Phase 2: every K1 kernel and the chain against the plain versions."""
    b, s, d, h, inter = 8, 496, D, H, INTER
    lengths = [496, 400, 300, 496, 100, 250, 0, 17]  # clip 6: all keys masked
    gen = torch.Generator().manual_seed(SEED + 4)
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[dt]["kernel"]
        print(f"phase 2: kernels vs plain, {str(dt).split('.')[-1]}, "
              f"B={b} S={s} D={d} H={h} I={inter}")
        x, mask = layer_inputs(b, s, d, dt, gen, lengths)
        dt_errs = {}
        cases = layer_cases(blk, x, mask, h)
        for key, key_cases in cases.items():
            kernel, plain = getattr(kern, key), getattr(kern, key + "_plain")
            dt_errs[key] = max(compare(label, kernel(*args), plain(*args), atol, rtol)
                               for label, args in key_cases)
        qkv = cases["attention"][0][1][0]
        check(bool((kern.attention(qkv, mask, h)[6] == 0).all()),
              "attention: all-masked clip is not exactly 0")
        catol, crtol = TOL[dt]["chain"]
        dt_errs["k1_layer"] = compare("K1 layer chain", ea.fused_layer(blk, x, mask, h, 1e-6),
                                      ea.fused_layer_plain(blk, x, mask, h, 1e-6), catol, crtol)
        if dt == torch.bfloat16:
            errs = dt_errs
    errs["gemm_ragged"] = ragged_gemm_check(gen)
    return errs


def ragged_gemm_check(gen):
    """Phase 2: the GEMM where N and K are not multiples of 8 (the SIMT
    kernel, in bf16 as in fp32) and M is not a multiple of the tile, every
    epilogue, against the plain version."""
    m, n, k = 1000, 2300, 764
    err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        a = torch.randn(m, k, generator=gen).to(DEVICE, dt)
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(DEVICE, dt)
        bias = torch.randn(n, generator=gen).to(DEVICE)
        r = torch.randn(m, n, generator=gen).to(DEVICE, dt)
        for epi in (kern.EPI_BIAS, kern.EPI_BIAS_RESID_F32, kern.EPI_BIAS_SILU, kern.EPI_BIAS_CAST_ADD):
            err = max(err, compare(f"gemm {_dt_name(dt)} M={m} N={n} K={k} epilogue {epi}",
                                   kern.gemm(a, w, bias, epi, r), kern.gemm_plain(a, w, bias, epi, r),
                                   *TOL[dt]["kernel"]))
    return err


@torch.inference_mode()
def block_phase(blk):
    """Phase 3: K2 and K3 (fused_block_attention) against the plain chain.  At
    S=1496 K3 pads to 1536 inside: 40 padded keys on top of the short
    clips, and clip 6 has no valid patch at all."""
    b, d, h = 8, D, H
    gen = torch.Generator().manual_seed(SEED + 2)
    errs = {}
    for name, dt, s, blocked in (("K2", torch.float32, 496, False),
                                 ("K3", torch.bfloat16, 1496, True),
                                 ("K3", torch.float32, 1496, True)):
        lengths = ([496, 400, 300, 496, 100, 250, 0, 17] if s == 496
                   else [1496, 1200, 700, 1496, 100, 37, 0, 1000])
        print(f"phase 3: {name} block vs plain, {str(dt).split('.')[-1]}, B={b} S={s}"
              f"{' (padded to 1536 inside)' if blocked else ''}")
        x, mask = layer_inputs(b, s, d, dt, gen, lengths)
        variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK) if blocked else ("one_shot",)
        got = ea.fused_block_attention(blk, x, mask, h, 1e-6, variant)
        ref = ea.fused_block_attention_plain(blk, x, mask, h, 1e-6, variant)
        atol, rtol = TOL[dt]["chain"]
        err = max(compare(f"{name} {label}", g, r, atol, rtol)
                  for label, g, r in zip(("y", "LN2 y"), got, ref))
        check(all(bool(torch.isfinite(t[6]).all()) and t.shape == (b, s, d) for t in got),
              f"{name}: the clip with no valid patch gave non-finite rows")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


@torch.inference_mode()
def variant_phase(blk):
    """Phase 3b: K6 (LN1 → QKV → attention) at S=496 and K3′ (the whole
    layer at S=1496 padded to 1536 inside) against the plain chain, bf16,
    B=8, padded keys and a clip with no valid key (K6 gives it 0)."""
    b, h, dt = 8, H, torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 6)
    atol, rtol = TOL[dt]["chain"]
    print(f"phase 3b: K6 and K3′ vs plain, bfloat16, B={b}")
    x, mask = layer_inputs(b, 496, D, dt, gen, [496, 400, 300, 496, 100, 250, 0, 17])
    got = ea.fused_ln_attention(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6)
    errs = {"K6": compare("K6 LN1 → QKV → attention, S=496", got,
                          ea.fused_ln_attention_plain(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6),
                          atol, rtol)}
    check(bool((got[6] == 0).all()), "K6: the all-masked clip is not exactly 0")
    x, mask = layer_inputs(b, 1496, D, dt, gen, [1496, 1200, 700, 1496, 100, 37, 0, 1000])
    variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK)
    got = ea.fused_layer(blk, x, mask, h, 1e-6, variant)
    check(got.shape == (b, 1496, D) and bool(torch.isfinite(got).all()),
          f"K3′: shape {tuple(got.shape)} or non-finite rows")
    errs["K3′"] = compare("K3′ layer, S=1496 (1536 inside)", got,
                          ea.fused_layer_plain(blk, x, mask, h, 1e-6, variant), atol, rtol)
    return errs


@torch.inference_mode()
def log_mel_phase():
    """Phase 4: K8 and K8′ against their plain versions, and K8′ against
    K8, B=9, 10-s and 30-s buffers (noise, a quiet and a silent clip, and a
    DC offset plus a Nyquist tone over noise: most of its energy in the two
    bins K8 skips); K8 again at mel_fmax = 7600 (bins 1–243)."""
    front = configs.FrontendConfig()
    gen = torch.Generator().manual_seed(SEED + 3)
    err = err_fast = 0.0
    for seconds in (10, 30):
        frames = seconds * 100
        lens = [seconds * 16000, 3 * 16000, 12345, seconds * 16000, 16000, 0, 160, 7 * 16000]
        bufs = torch.zeros(len(lens) + 1, seconds * 16000)
        for i, n in enumerate(lens):
            bufs[i, :n] = (1e-4 if i == 3 else 0.1) * torch.randn(n, generator=gen)
        # 0.1 each over noise at 0.1: a louder tone over less noise leaves
        # bins whose sums cancel, where two fp32 orders differ past 1e-4
        bufs[-1] = (0.1 + 0.1 * (1 - 2 * (torch.arange(seconds * 16000) % 2))
                    + 0.1 * torch.randn(seconds * 16000, generator=gen))
        rows = fused.buffer_to_rows(bufs.to(DEVICE), frames, front)
        print(f"phase 4: K8 and K8′ vs plain, B={len(bufs)}, {frames} frames")
        exact = fused.fused_log_mel(rows, front, frames)
        err = max(err, compare(f"K8 log-mel, {frames} frames", exact,
                               fused.fused_log_mel_plain(rows, front, frames), *TOL["log_mel"]))
        if seconds == 10:
            f76 = configs.FrontendConfig(mel_fmax=7600.0)
            err = max(err, compare("K8 log-mel, mel_fmax 7600", fused.fused_log_mel(rows, f76, frames),
                                   fused.fused_log_mel_plain(rows, f76, frames), *TOL["log_mel"]))
        fast = fused.fused_log_mel(rows, front, frames, fast_dft=True)
        plain_fast = fused.fused_log_mel_plain(rows, front, frames, fast_dft=True)
        err_fast = max(err_fast, compare(f"K8′ log-mel, {frames} frames", fast, plain_fast,
                                         *TOL["log_mel"]))
        check_fast_dft(f"{frames} frames", fast, plain_fast, exact)
    return {"K8": err, "K8′": err_fast}


def check_fast_dft(label, fast, plain_fast, exact):
    """K8′ against exact K8: within JAX's 2e-4 wherever its bf16×3 DFT (the
    plain version) is, and elsewhere no farther than it plus TOL["log_mel"]."""
    bound = TOL["fast_dft"][0]
    err, err_plain = (fast - exact).abs(), (plain_fast - exact).abs()
    ok = bool((err <= torch.clamp(err_plain + TOL["log_mel"][0], min=bound)).all())
    print(f"  K8′ vs exact K8, {label}: max |Δ| {float(err.max()):.3e} (plain bf16×3 "
          f"{float(err_plain.max()):.3e}); values beyond {bound:g}: {int((err > bound).sum())} of "
          f"{err.numel()} (plain {int((err_plain > bound).sum())})  {'ok' if ok else 'FAIL'}")
    check(ok, f"K8′ {label}: farther from K8 than its plain version allows")


def _dt_name(dt) -> str:
    return str(dt).split(".")[-1]


@torch.inference_mode()
def attention_phase():
    """Phase 9: K4, K5 and K7 against their plain versions, B=8; clip 6 has
    no valid key."""
    b = 8
    gen = torch.Generator().manual_seed(SEED + 5)
    lengths = {500: [500, 400, 300, 500, 100, 250, 0, 17], 100: [100, 80, 60, 100, 20, 50, 0, 3],
               1500: [1500, 1200, 700, 1500, 100, 37, 0, 1000]}

    def inputs(s, width, dt):
        x = (1.5 * torch.randn(b, s, width, generator=gen)).to(DEVICE, dt)
        mask = (torch.arange(s)[None, :] < torch.tensor(lengths[s])[:, None]).to(DEVICE, torch.int32)
        return x, mask

    errs = {}
    cases = ((torch.bfloat16, 500, 8, False), (torch.float32, 500, 8, False),
             (torch.bfloat16, 100, 12, True), (torch.float32, 100, 12, True))
    print("phase 9: K4, K5, K7 vs plain, B=8")
    for dt, s, heads, causal in cases:
        qkv, mask = inputs(s, 3 * D, dt)
        label = f"K4 {_dt_name(dt)} S={s} H={heads}{' causal' if causal else ''}"
        got = kern.attention_k4(qkv, mask, heads, causal)
        err = compare(label, got, kern.attention_plain(qkv, mask, heads, causal), *TOL[dt]["kernel"])
        errs["K4"] = max(errs.get("K4", 0.0), err)
        check(bool((got[6] == 0).all()), f"{label}: the all-masked clip is not exactly 0")
    q, mask = inputs(1500, D, torch.bfloat16)
    kv, _ = inputs(1500, 2 * D, torch.bfloat16)
    got = ea.encoder_attention_blocked(q, kv, mask, H)
    errs["K5"] = compare("K5 bf16 S=1500 (plain: padded to 1536)", got,
                         ea.encoder_attention_blocked_plain(q, kv, mask, H), *TOL[torch.bfloat16]["kernel"])
    pad = 1536 - 1500
    padded = kern.attention_k5(F.pad(q, (0, 0, 0, pad)), F.pad(kv, (0, 0, 0, pad)), F.pad(mask, (0, pad)),
                               H)[:, :1500]
    same = torch.equal(got, padded)
    print(f"  K5 at S=1500 (no padding copy) vs the kernel over the row padded to 1536: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    check(same, "K5 at the clip length differs from the padded call")
    cases = ((torch.bfloat16, 500, 8, False), (torch.bfloat16, 500, 8, True),
             (torch.float32, 100, 8, False), (torch.float32, 100, 12, True))
    for dt, s, heads, causal in cases:
        qkv, mask = inputs(s, 3 * D, dt)
        g = torch.randn(b, s, D, generator=gen).to(DEVICE, dt)
        label = f"K7 {_dt_name(dt)} S={s} H={heads}{' causal' if causal else ''}"
        got = kern.attention_bwd(qkv, mask, g, heads, causal)
        err = compare(label, got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), *TOL[dt]["k7"])
        errs["K7"] = max(errs.get("K7", 0.0), err)
        check(bool((got[6] == 0).all()), f"{label}: the all-masked clip's gradients are not 0")
    for key, err in head_dim_checks(gen).items():
        errs[key] = max(errs[key], err)
    errs["K7"] = max(errs["K7"], k7_wgmma_checks(gen))
    for key, err in wide_head_checks(gen).items():
        errs[key] = max(errs.get(key, 0.0), err)
    errs["table_grad"] = table_grad_checks(gen)
    return errs


def table_grad_checks(gen):
    """Phase 9: the frequency table's gradient (csrc/table_grad.cu) at
    caco_base's 128 × 500 patches into 8 rows of width 768 and at the MAE
    decoder's 512, bf16 and fp32, each clip's padding at index 0, against
    the plain fp32 sum (relative L2 ≤ TABLE_GRAD_TOL), and the same bits on
    a second call → the largest relative error."""
    b, s, err = 128, 500, 0.0
    for width in (768, 512):
        for dt in (torch.bfloat16, torch.float32):
            g, inds = table_grad_inputs(b, s, width, dt, gen)
            got = kern.table_grad(g, inds, 8)
            want = kern.table_grad_plain(g, inds, 8)
            rel = float((got - want).norm() / want.norm())
            label = f"table_grad {_dt_name(dt)} {b * s} x {width} -> 8"
            print(f"  {label}: relative L2 {rel:.3e}")
            check(rel <= TABLE_GRAD_TOL, f"{label}: {rel:.3e} from the plain sum")
            check(torch.equal(got, kern.table_grad(g, inds, 8)), f"{label}: a second call differs")
            err = max(err, rel)
    return err


def table_grad_inputs(b, s, width, dt, gen):
    """The gradient of b clips × s patches (on the card, (b·s, width) in dt)
    and their frequency rows (int64, time-major over 8 rows, each clip's
    padding at index 0)."""
    inds = (torch.arange(s) % 8).repeat(b, 1)
    lengths = torch.randint(s // 4, s + 1, (b,), generator=gen)
    inds[torch.arange(s)[None, :] >= lengths[:, None]] = 0
    g = (torch.randn(b * s, width, generator=gen) + 0.5).to(DEVICE, dt)
    return g, inds.reshape(-1).to(DEVICE)


def clamp_qkv(b, s, heads, hd, gen):
    """Fused QKV (CPU, fp32) whose logits reach far past the clamp of 80
    while every element stays moderate: Q and K share the all-ones direction
    of each head (30 along it), K with a per-key weight in [-1, 1.2], so
    q·k/sqrt(Dh) runs from about -110 to +130 at Dh 64 and every row clamps
    many keys.  (Scaling all of q, k, v by 8 instead puts one bf16 step of
    dS times |q| ≈ 30 past K7's bound: a test of the inputs, not the kernel.)"""
    d = heads * hd
    x = 1.5 * torch.randn(b, s, 3 * d, generator=gen)
    along = 30.0 / hd ** 0.5
    x[..., :d] += along
    x[..., d:2 * d] += along * (2.2 * torch.rand(b, s, 1, generator=gen) - 1.0)
    return x


def k7_wgmma_checks(gen):
    """Phase 9: the redesigned bf16 K7 (wgmma: pre-pass, main pass, dQ
    conversion) at Dh 64 (12 heads) and 96 (8 heads), S = 1, 63, 128, 500
    and 579 (`bwd_fits_vmem`'s bf16 limit), causal and not, B=4 with an
    all-masked clip (exactly 0), and logits far above the clamp (S=500)."""
    b, err = 4, 0.0
    tol = TOL[torch.bfloat16]["k7"]
    for hd, heads in ((64, 12), (96, 8)):
        for s in (1, 63, 128, 500, 579):
            lens = [s, max(s // 3, 1), 0, max(s // 2, 1)]
            mask = (torch.arange(s)[None, :] < torch.tensor(lens)[:, None]).to(DEVICE, torch.int32)
            for causal, clamp in ((False, False), (True, False)) + (((False, True),) if s == 500 else ()):
                qkv = (clamp_qkv(b, s, heads, hd, gen) if clamp else
                       1.5 * torch.randn(b, s, 3 * heads * hd, generator=gen)).to(DEVICE, torch.bfloat16)
                g = torch.randn(b, s, heads * hd, generator=gen).to(DEVICE, torch.bfloat16)
                label = (f"K7 wgmma Dh={hd} S={s}{' causal' if causal else ''}"
                         f"{' (logits above the clamp)' if clamp else ''}")
                if clamp:
                    q, k, _ = (kern.split_heads(t, heads).float() for t in qkv.chunk(3, dim=-1))
                    top = torch.minimum((q * kern.q_scale(hd, torch.bfloat16)).to(torch.bfloat16).float()
                                        @ k.transpose(-1, -2), kern._kbias(mask, s, False)).amax(dim=-1)
                    check(bool((top[[0, 1, 3]] >= 80.0).all()), f"{label}: a row does not reach the clamp")
                got = kern.attention_bwd(qkv, mask, g, heads, causal)
                err = max(err, compare(label, got, kern.attention_bwd_plain(qkv, mask, g, heads, causal), *tol))
                check(bool((got[2] == 0).all()), f"{label}: the all-masked clip's gradients are not 0")
    return err


def wide_head_checks(gen):
    """Phase 9: heads past 128 columns (run in pieces of 128), Dh 160, 192,
    256 and 384 (2 heads, B=4, S=300, an all-masked clip) in bf16 and fp32:
    the attention link, K4 causal, K5's strides, K7 causal and not; and a
    K1 chain (`fused_layer`) at width 768 with 3 heads of Dh 256."""
    b, s, heads = 4, 300, 2
    mask = (torch.arange(s)[None, :] < torch.tensor([300, 123, 0, 17])[:, None]).to(DEVICE, torch.int32)
    errs = {"K4": 0.0, "K5": 0.0, "K7": 0.0, "k1_wide_chain": 0.0}
    for hd in (160, 192, 256, 384):
        d = heads * hd
        for dt in (torch.bfloat16, torch.float32):
            qkv = (1.5 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            g = torch.randn(b, s, d, generator=gen).to(DEVICE, dt)
            q, kv = qkv[..., :d].contiguous(), qkv[..., d:].contiguous()
            name = f"Dh={hd} {_dt_name(dt)}"
            for label, got, ref, tol, key in (
                    ("attention link", kern.attention(qkv, mask, heads),
                     kern.attention_plain(qkv, mask, heads), TOL[dt]["kernel"], "K4"),
                    ("K4 causal", kern.attention_k4(qkv, mask, heads, True),
                     kern.attention_plain(qkv, mask, heads, True), TOL[dt]["kernel"], "K4"),
                    ("K5 strides", kern.attention_k5(q, kv, mask, heads),
                     kern.attention_split_plain(q, kv, mask, heads), TOL[dt]["kernel"], "K5"),
                    ("K7", kern.attention_bwd(qkv, mask, g, heads),
                     kern.attention_bwd_plain(qkv, mask, g, heads), TOL[dt]["k7"], "K7"),
                    ("K7 causal", kern.attention_bwd(qkv, mask, g, heads, True),
                     kern.attention_bwd_plain(qkv, mask, g, heads, True), TOL[dt]["k7"], "K7")):
                errs[key] = max(errs[key], compare(f"{label} {name}", got, ref, *tol))
                check(bool((got[2] == 0).all()), f"{label} {name}: the all-masked clip is not 0")
    blk = ViTBlock(D, INTER, torch.Generator().manual_seed(SEED + 9)).to(DEVICE)
    for dt in (torch.bfloat16, torch.float32):
        x, m = layer_inputs(b, s, D, dt, gen, [300, 123, 0, 17])
        errs["k1_wide_chain"] = max(errs["k1_wide_chain"], compare(
            f"K1 chain, 3 heads of Dh=256, {_dt_name(dt)}", ea.fused_layer(blk, x, m, 3, 1e-6),
            ea.fused_layer_plain(blk, x, m, 3, 1e-6), *TOL[dt]["chain"]))
    return errs


# Logits far above the clamp (q, k of scale 8): fp32 keeps 1e-4 relative
# but logits of a few hundred carry ~1e-5 of absolute rounding into p, so
# 5e-3 absolute (as tests/test_torch_cuda.py); bf16 rows whose every
# attended logit lies below -70 are left out (the tensor cores flush
# p·v·2^-24 below fp32's normal range where the plain version keeps it).
TOL_CLAMP = {torch.float32: (5e-3, 1e-4), torch.bfloat16: (6e-2, 2e-2)}


def head_dim_checks(gen):
    """Phase 9: the attention link, K4 (causal) and K7 at head dims 16, 32
    and 128 (8 heads, B=4, S=500, bf16 and fp32; bf16 through the mma.sync
    kernel), an all-masked clip, and logits far above the clamp."""
    b, s, heads = 4, 500, 8
    mask = (torch.arange(s)[None, :] < torch.tensor([500, 321, 0, 17])[:, None]).to(DEVICE, torch.int32)
    errs = {"K4": 0.0, "K7": 0.0}
    for hd in (16, 32, 128):
        d = heads * hd
        for dt in (torch.bfloat16, torch.float32):
            qkv = (1.5 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            g = torch.randn(b, s, d, generator=gen).to(DEVICE, dt)
            name = f"Dh={hd} {_dt_name(dt)}"
            for label, got, ref, tol, key in (
                    ("attention link", kern.attention(qkv, mask, heads),
                     kern.attention_plain(qkv, mask, heads), TOL[dt]["kernel"], "K4"),
                    ("K4 causal", kern.attention_k4(qkv, mask, heads, True),
                     kern.attention_plain(qkv, mask, heads, True), TOL[dt]["kernel"], "K4"),
                    ("K7", kern.attention_bwd(qkv, mask, g, heads),
                     kern.attention_bwd_plain(qkv, mask, g, heads), TOL[dt]["k7"], "K7"),
                    ("K7 causal", kern.attention_bwd(qkv, mask, g, heads, True),
                     kern.attention_bwd_plain(qkv, mask, g, heads, True), TOL[dt]["k7"], "K7")):
                errs[key] = max(errs[key], compare(f"{label} {name}", got, ref, *tol))
                check(bool((got[2] == 0).all()), f"{label} {name}: the all-masked clip is not 0")
            big = (8.0 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            got, ref = kern.attention(big, mask, heads), kern.attention_plain(big, mask, heads)
            q, k, _ = (kern.split_heads(t, heads).float() for t in big.chunk(3, dim=-1))
            top = torch.minimum((q * kern.q_scale(hd, dt)).to(dt).float() @ k.transpose(-1, -2),
                                kern._kbias(mask, s, False)).amax(dim=-1)
            rows = kern.merge_heads((top > -70.0)[..., None].expand(-1, -1, -1, hd))
            clamped = float((top >= 80.0).float()[:2].mean())
            if dt == torch.float32:
                rows = torch.ones_like(rows)
            compare(f"attention link {name}, logits above the clamp ({clamped:.2f} of rows)",
                    got[rows], ref[rows], *TOL_CLAMP[dt])
            check(clamped > 0.3, f"{name}: too few rows reach the clamp ({clamped})")
            check(bool((got[2] == 0).all()), f"clamp case {name}: the all-masked clip is not 0")
    return errs


def train_batch(cfg, rs, b: int, seconds: int, seq_len: int):
    """A stage-2 batch on the card: `audio_batch`'s patches and token ids
    of 8-100 tokens."""
    batch = audio_batch(rs, b, seconds, seq_len)
    tmask = (np.arange(TEXT_LEN)[None] < rs.randint(8, TEXT_LEN + 1, size=b)[:, None]).astype(np.int32)
    ids = np.where(tmask > 0, rs.randint(4, cfg.text.vocab_size, size=(b, TEXT_LEN)), 1)
    batch["text_input_ids"] = torch.from_numpy(ids.astype(np.int32)).to(DEVICE)
    batch["text_mask"] = torch.from_numpy(tmask).to(DEVICE)
    return batch


def audio_batch(rs, b: int, seconds: int, seq_len: int):
    """A training patch batch on the card: synthetic clips of 3 s to
    `seconds` s through `device_train_frontend` (every patch of the buffer,
    then a sorted random subset of seq_len)."""
    front = configs.FrontendConfig()
    samples = seconds * front.sample_rate
    lens = rs.randint(3 * front.sample_rate, samples + 1, size=b).astype(np.int32)
    bufs = np.zeros((b, samples), np.float32)
    for i, n in enumerate(lens):
        bufs[i, :n] = 0.1 * rs.randn(n)
    full = num_patches_for_samples(samples, front, configs.PatchConfig())
    frontend = device_train_frontend(front, configs.PatchConfig(patches_seq_len=max(full, seq_len)),
                                     seq_len)
    batch = frontend(torch.Generator(device=DEVICE).manual_seed(SEED),
                     torch.from_numpy(bufs).to(DEVICE), torch.from_numpy(lens).to(DEVICE))
    check(batch["audio_patches"].shape == (b, seq_len, 256), f"patch batch {batch['audio_patches'].shape}")
    return batch


def no_text_dropout(cfg):
    text = dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0)
    dec = dataclasses.replace(cfg.decoder, hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(cfg, text=text, decoder=dec)


NO_SERVING_KERNELS = {"k1_layer": 0, "k2_block": 0, "k3_block": 0, "k3_layer": 0, "k6_attn": 0,
                      "attention": 0, "gemm": 0, "layer_norm": 0, "log_mel": 0,
                      "log_mel_fast": 0}  # training runs none of the serving kernels


def device_busy_ms(fn, n: int):
    """fn run n times under torch.profiler (device activity only) →
    (device busy ms per run: the union of the intervals of every kernel,
    copy and memset on the card; host wall ms per run, profiler included;
    device operations per run)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    check(busy > 0, "the profiler recorded no device time")
    return busy / 1e3 / n, wall, len(spans) / n


def host_us(fn, n: int = 50) -> float:
    """Host microseconds per call of fn (the enqueue: argument checks,
    tensor maps, the launch), the device left to catch up afterwards."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return t


def time_steps(step, state, batch, gen, n: int):
    """n more steps, each timed on the host clock between synchronisations
    → (state, sorted ms)."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, sorted(ms)


def train_bf16_phase(cfg, rs):
    """Phase 10: the bf16 10-s step at caco_base, B=16, 5 steps on one batch
    (text dropout 0.1 as configured), then 6 timed steps."""
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    n = cfg.audio.num_layers
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(DEVICE)
    state = train.init_train_state(model, tc)
    step = train.make_caco_train_step(cfg, tc)
    batch = train_batch(cfg, rs, TRAIN_BATCH, 10, 500)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    print(f"phase 10: bf16 10-s training step, caco_base, B={TRAIN_BATCH}, 500 patches, "
          f"{TEXT_LEN} tokens, {TRAIN_STEPS} steps")
    metrics = []

    def steps():
        nonlocal state
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch, gen)
            metrics.append({k: float(v) for k, v in m.items()})

    torch.cuda.reset_peak_memory_stats()
    _, got = drive("bf16 10-s train step x5", steps,
                   {"k4": n * TRAIN_STEPS, "k7": n * TRAIN_STEPS, "k5": 0,
                    "table_grad": TRAIN_STEPS, **NO_SERVING_KERNELS})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    print(f"  loss {['%.5f' % v for v in losses]}\n  grad_norm {['%.4f' % v for v in norms]}\n"
          f"  peak device memory {peak:.2f} GiB")
    check(all(np.isfinite(losses + norms)), "non-finite loss or grad_norm")
    check(losses[4] < losses[1], "the loss did not fall from step 1 to step 4")
    state, ms = time_steps(step, state, batch, gen, 6)
    print(f"  step times {['%.2f' % v for v in ms]} ms, median {np.median(ms):.2f} ms/step")

    def one_step():
        nonlocal state
        state, m = step(state, batch, gen)
        float(m["loss"])

    busy, wall, ops = device_busy_ms(one_step, 3)
    print(f"  device busy {busy:.2f} ms/step (union of device intervals, 3 steps under the "
          f"profiler, {wall:.2f} ms wall/step there, idle share {1 - busy / wall:.3f}, "
          f"{ops:.0f} device operations/step)")
    del state, model
    return got, {"loss": losses, "grad_norm": norms, "peak_gib": peak, "step_ms": ms,
                 "median_step_ms": float(np.median(ms)), "device_busy_ms": busy,
                 "profiled_wall_ms": wall, "device_ops_per_step": ops}


def train_fp32_phase(cfg, rs):
    """Phase 11: the fp32 10-s step (text dropout off, so the card and the
    CPU compute the same function); then loss and gradients at B=2 against
    the CPU's plain versions, from the same fresh parameters."""
    cfg = no_text_dropout(dataclasses.replace(cfg, dtype=torch.float32))
    n = cfg.audio.num_layers
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    batch = train_batch(cfg, rs, TRAIN_BATCH, 10, 500)
    print(f"phase 11: fp32 10-s training step, caco_base, B={TRAIN_BATCH}")
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(DEVICE)
    state = train.init_train_state(model, tc)
    step = train.make_caco_train_step(cfg, tc)
    (_, m), got = drive("fp32 10-s train step", lambda: step(state, batch, None),
                        {"k4": n, "k7": 0, "k5": 0, **NO_SERVING_KERNELS})
    check(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])),
          "fp32 step: non-finite loss or grad_norm")
    state, ms = time_steps(step, state, batch, None, 3)
    print(f"  step times {['%.2f' % v for v in ms]} ms")
    del state, model
    loss_fn = train.make_caco_loss(cfg, tc)
    small = {k: v[:2] for k, v in batch.items()}
    out = []
    for device in (DEVICE, "cpu"):
        net = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(device)
        loss, _ = loss_fn(net, {k: v.to(device) for k, v in small.items()}, None)
        loss.backward()
        out.append((float(loss.detach()), torch.cat([p.grad.flatten().double().cpu() for p in net.parameters()])))
        del net
    (l_card, g_card), (l_cpu, g_cpu) = out
    l_err = abs(l_card - l_cpu) / abs(l_cpu)
    g_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    print(f"  B=2 card vs CPU plain: loss {l_card:.6f} vs {l_cpu:.6f} (rel {l_err:.2e} ≤ "
          f"{STEP_TOL['loss']}), gradients rel L2 {g_err:.2e} (≤ {STEP_TOL['grads']})")
    check(l_err <= STEP_TOL["loss"] and g_err <= STEP_TOL["grads"],
          "fp32 step on the card disagrees with the CPU")
    return got, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "step_ms": ms,
                 "b2_loss_rel_err": l_err, "b2_grad_rel_err": g_err}


def train_30s_phase(cfg, rs):
    """Phase 12: the bf16 30-s step, B=4, 1500 patches (blocked plan, 1536)."""
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    n = cfg.audio.num_layers
    check(ea.kernel_plan(1500, D, torch.bfloat16) == ("blocked", 1536, 256), "30-s plan")
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(DEVICE)
    state = train.init_train_state(model, tc)
    step = train.make_caco_train_step(cfg, tc)
    batch = train_batch(cfg, rs, TRAIN_BATCH_30, 30, 1500)
    print(f"phase 12: bf16 30-s training step, caco_base, B={TRAIN_BATCH_30}, 1500 patches")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    (state, m), got = drive("bf16 30-s train step", lambda: step(state, batch, gen),
                            {"k5": n, "k4": 0, "k7": 0, **NO_SERVING_KERNELS})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])),
          "30-s step: non-finite loss or grad_norm")
    state, ms = time_steps(step, state, batch, gen, 3)
    print(f"  loss {float(m['loss']):.5f}, grad_norm {float(m['grad_norm']):.4f}, "
          f"peak device memory {peak:.2f} GiB, step times {['%.2f' % v for v in ms]} ms")
    del state, model
    return got, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "peak_gib": peak,
                 "step_ms": ms}


def cosine_rows(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def check_embeddings(name, emb, n, cfg):
    check(emb.shape == (n, cfg.projection_size), f"{name}: shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), f"{name}: non-finite values")
    dev = float(np.abs(np.linalg.norm(emb, axis=-1) - 1.0).max())
    check(dev <= 1e-3, f"{name}: embedding norms off by {dev}")


def embed_by_layers(model, cfg, batch, layer):
    """The pooled, normalized audio embedding with every encoder layer run
    by `layer(blk, x, mask)` (get_audio_embedding's computation, the layer
    driven from outside)."""
    mask = batch["audio_mask"]
    x = audio_input_embedding(model.audio, cfg.audio, batch["audio_patches"],
                              batch["audio_time_inds"], batch["audio_freq_inds"], cfg.dtype)
    for blk in model.audio.blocks:
        x = layer(blk, x, mask)
    hidden = layer_norm(model.audio.ln_f, x, LN_EPS)
    return caco._normalize(caco.audio_pooler_apply(model.audio_pool, cfg, hidden, mask))


def device_buffers(wavs, seconds: int):
    """(B, seconds · 16 k) zero-padded buffers and (B,) lengths on the card."""
    bufs = np.zeros((len(wavs), seconds * 16000), np.float32)
    for i, w in enumerate(wavs):
        bufs[i, :len(w)] = w[:bufs.shape[1]]
    lens = np.asarray([min(len(w), bufs.shape[1]) for w in wavs], np.int32)
    return torch.from_numpy(bufs).to(DEVICE), torch.from_numpy(lens).to(DEVICE)


@torch.inference_mode()
def variant_paths_phase(cfg, model, engine, engine30, wavs, wavs30):
    """Phase 8b: the paths of K6, K3′ and K8′ at caco_base, bf16, seed 0,
    each through its own entry point: a 12-layer 10-s encoder (B=32,
    S=496) through route "k6"; a 12-layer 30-s encoder (B=8, 1536 patches)
    through `try_fused_layer(allow_blocked=True)`; `fused_batch_wav_to_patches`
    with fast_dft on 10-s and 30-s buffers."""
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    n, dt = cfg.audio.num_layers, torch.bfloat16
    print("phase 8b: the K6, K3′ and K8′ paths at caco_base, bf16")
    check(ea.layer_route(496, D, INTER, dt) == ("k1", 496)
          and ea.fused_ln_attention_applies(496, D, dt), "K6 does not apply at S=496")
    out = {}
    batch = engine.audio_patch_batch(wavs[:BATCH])[0]
    ref = get_audio_embedding(model, cfg, **batch)[0].float().cpu().numpy()
    emb, out["K6"] = drive("bf16 10-s encoder, every layer through route k6",
                           lambda: embed_by_layers(model, cfg, batch,
                                                   lambda b, x, m: encoder_layer(b, x, m, H, "k6", dt)),
                           {"k6_attn": n, "k1_layer": 0, "k2_block": 0, "attention": n})
    emb = emb.float().cpu().numpy()
    check_embeddings("route k6", emb, BATCH, cfg)
    cos_k6 = float(cosine_rows(emb, ref).min())

    b30 = VARIANT_BATCH_30
    batch30 = {k: v[:b30] for k, v in engine30.audio_patch_batch(wavs30[:b30])[0].items()}
    check(batch30["audio_patches"].shape[1] == 1536, "30-s batch is not at 1536 patches")

    def k3_prime(b, x, m):
        y = ea.try_fused_layer(b, x, m, H, LN_EPS, dt, allow_blocked=True)
        check(y is not None, "try_fused_layer(allow_blocked=True) declined at 1536 patches")
        return y

    ref30 = get_audio_embedding(model, cfg, **batch30)[0].float().cpu().numpy()
    emb30, out["K3′"] = drive("bf16 30-s encoder through try_fused_layer(allow_blocked=True)",
                              lambda: embed_by_layers(model, cfg, batch30, k3_prime),
                              {"k3_layer": n, "k3_block": 0, "k1_layer": 0})
    emb30 = emb30.float().cpu().numpy()
    check_embeddings("K3′ path", emb30, b30, cfg)
    cos_k3p = float(cosine_rows(emb30, ref30).min())
    print(f"  cosine route k6 vs k1 (10 s, {BATCH} clips, min) {cos_k6:.7f}; K3′ vs K3 (30 s, "
          f"{b30} clips, min) {cos_k3p:.7f} (≥ {COS_VARIANT})")
    check(cos_k6 >= COS_VARIANT and cos_k3p >= COS_VARIANT, "a variant path disagrees with its default")

    front = configs.FrontendConfig()
    errs = {}
    for seconds, clips, eng in ((10, wavs[:BATCH], engine), (30, wavs30[:b30], engine30)):
        bufs, lens = device_buffers(clips, seconds)
        fast_k8p = 1 if seconds == 10 else 0
        fast, got = drive(f"fused_batch_wav_to_patches(fast_dft=True), {seconds}-s buffers",
                          lambda: fused.fused_batch_wav_to_patches(bufs, lens, front, eng.patch,
                                                                   fast_dft=True),
                          {"log_mel_fast": fast_k8p, "log_mel": 1 - fast_k8p})
        exact = fused.fused_batch_wav_to_patches(bufs, lens, front, eng.patch)
        for k in ("audio_mask", "audio_time_inds", "audio_freq_inds"):
            check(torch.equal(fast[k], exact[k]), f"fast_dft {seconds} s: {k} differs")
        if seconds == 30:
            check(torch.equal(fast["audio_patches"], exact["audio_patches"]),
                  "fast_dft at 30 s is not the exact path")
            continue
        out["K8′"] = got
        frames = seconds * 100
        plain = fused.fused_log_mel_plain(fused.buffer_to_rows(bufs, frames, front), front, frames,
                                          fast_dft=True)
        valid = -(-lens // front.hop_length)
        ref = patchify_spectrogram(plain, valid, eng.patch)["audio_patches"]
        errs[seconds] = compare("fast_dft patches, 10 s, vs the plain K8′", fast["audio_patches"],
                                ref, *TOL["log_mel"])
    print("  fast_dft patches at 30 s: the exact path's (JAX's exact fallback)")
    return out, {"cos_k6_vs_k1": cos_k6, "cos_k3prime_vs_k3": cos_k3p,
                 "fast_dft_patch_err_10s": errs[10]}


def grad_phase(cfg, model, wavs):
    """Phase 8c: gradients through the inference encoder (the fused routes'
    JAX backward).  bf16 10 s, B=8, loss = Σ embedding · a fixed random
    vector: K1 12 times in the forward, every block parameter's gradient
    present and finite.  fp32 at B=2 (K2 route): the card's gradients
    against the same computation on the CPU."""
    n = cfg.audio.num_layers
    print("phase 8c: gradients through the inference encoder (audio_encoder_apply, train=False)")
    vec = torch.randn(cfg.projection_size, generator=torch.Generator().manual_seed(SEED + 7))

    def patch_batch(dt, clips):
        engine = CacoEngine(cfg, model, device=DEVICE, batch_size=len(clips), dtype=dt)
        return {k: v.clone() for k, v in engine.audio_patch_batch(clips)[0].items()}

    def loss_backward(net, cfg_dt, batch):
        emb, _ = get_audio_embedding(net, cfg_dt, **batch)
        (emb @ vec.to(emb.device)).sum().backward()

    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    batch = patch_batch(torch.bfloat16, wavs[:GRAD_BATCH])
    model.zero_grad(set_to_none=True)
    _, got = drive(f"bf16 10-s encoder forward + backward, B={GRAD_BATCH}",
                   lambda: loss_backward(model, cfg16, batch),
                   {"k1_layer": n, "k2_block": 0, "k6_attn": 0, "k7": 0})
    blocks = list(model.audio.blocks.named_parameters())
    bad = [k for k, p in blocks if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"bf16 block parameters without a finite gradient: {bad[:4]}")
    print(f"  {len(blocks)} block parameters, every gradient present and finite")

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    batch = patch_batch(torch.float32, wavs[:2])
    model.zero_grad(set_to_none=True)
    drive("fp32 10-s encoder forward + backward, B=2", lambda: loss_backward(model, cfg32, batch),
          {"k2_block": n, "k1_layer": 0})
    cpu_model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    loss_backward(cpu_model, cfg32, {k: v.cpu() for k, v in batch.items()})
    grads = []
    for net in (model, cpu_model):
        params = list(net.audio.parameters()) + list(net.audio_pool.parameters())
        check(all(p.grad is not None for p in params), "an audio parameter has no gradient")
        grads.append(torch.cat([p.grad.flatten().double().cpu() for p in params]))
    rel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    print(f"  fp32 gradients card vs CPU (audio encoder + pooler), rel L2 {rel:.2e} (≤ {GRAD_TOL})")
    check(rel <= GRAD_TOL, "fp32 gradients on the card disagree with the CPU")
    model.zero_grad(set_to_none=True)
    return got, {"fp32_grad_rel_err": rel, "bf16_block_params_with_grad": len(blocks)}


def tiny_engine_phase(wavs):
    """Phase 5b: CacoEngine at caco_tiny width (hidden 32, 2 heads of Dh 16)
    in bf16 on the card, every audio layer on K1 with the mma.sync attention
    link; its embeddings against the CPU engine's in bf16 and in fp32."""
    cfg = configs.caco_tiny()
    clips = wavs[:40]
    n_buckets = -(-len(clips) // BATCH)
    engine = CacoEngine(cfg, caco_init(cfg, torch.Generator().manual_seed(SEED)), device=DEVICE,
                        batch_size=BATCH, dtype=torch.bfloat16)
    print(f"phase 5b: caco_tiny bf16 10-s engine on cuda (Dh {cfg.audio.hidden_size // cfg.audio.num_heads})")
    emb, got = drive("caco_tiny bf16 embed_audio",
                     lambda: engine.embed_audio(clips),
                     {"k1_layer": cfg.audio.num_layers * n_buckets, "k2_block": 0, "k3_block": 0,
                      "attention": cfg.audio.num_layers * n_buckets})
    check_embeddings("caco_tiny audio", emb, len(clips), cfg)
    cos = {}
    for dt in (torch.bfloat16, torch.float32):
        cpu = CacoEngine(cfg, caco_init(cfg, torch.Generator().manual_seed(SEED)), device="cpu",
                         batch_size=BATCH, dtype=dt)
        cos[_dt_name(dt)] = float(cosine_rows(emb, cpu.embed_audio(clips)).min())
    print(f"  cosine card bf16 vs CPU ({len(clips)} clips, min): bf16 {cos['bfloat16']:.7f}, "
          f"fp32 {cos['float32']:.7f} (≥ 0.999)")
    check(min(cos.values()) >= 0.999, "caco_tiny bf16 on the card disagrees with the CPU engine")
    return got, cos


def byte_vocab() -> dict:
    """Specials + all 256 byte symbols."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in _bytes_to_unicode().values():
        vocab[c] = len(vocab)
    return vocab


def byte_tokenizer():
    """Degenerate byte-level BPE: byte_vocab(), no merges."""
    return ByteLevelBPETokenizer(byte_vocab(), [])


@torch.inference_mode()
def timing_phase(blk, label):
    """Phase 13: per-layer K1 chain and each kernel vs plain at B=32, S=496,
    bf16 (a kernel's time is the sum over its calls in one layer); the K2
    block in fp32 at S=496, the K3 block and the K3′ layer in bf16 at
    S=1536, K6 in bf16 at S=496, and K8 and K8′ at 1000 and 3000 frames,
    all at B=32; K4 and K7 at the 10-s step's shape (B=16,
    S=500, bf16) and K5 at the 30-s step's (B=4, S=1500 padded to 1536);
    `table_grad` against fp32 `index_add_` at 128 × 500 patches of width D
    into 8 rows, bf16."""
    b, s, d, h = BATCH, 496, D, H
    gen = torch.Generator().manual_seed(SEED + 1)
    lengths = list(np.random.RandomState(SEED).randint(48, 497, size=b))
    x, mask = layer_inputs(b, s, d, torch.bfloat16, gen, lengths)
    times, bounds = {}, {}
    hd, m = d // h, b * s
    w_layer, w_block = 3 * d * d + d * d + 2 * d * INTER, 4 * d * d
    bounds["k1_layer"] = bound({"bf16": 2 * m * w_layer + attn_flops(h, hd, s, lengths)},
                               2 * (2 * m * d + w_layer))
    bounds["k6_attn"] = bound({"bf16": 2 * m * 3 * d * d + attn_flops(h, hd, s, lengths)},
                              2 * (2 * m * d + 3 * d * d))
    for key, cases in layer_cases(blk, x, mask, h).items():
        kernel, plain = getattr(kern, key), getattr(kern, key + "_plain")
        times[key] = paired_ms(lambda: [kernel(*a) for _, a in cases],
                               lambda: [plain(*a) for _, a in cases], 10)
    times["k1_layer"] = paired_ms(lambda: ea.fused_layer(blk, x, mask, h, 1e-6),
                                  lambda: ea.fused_layer_plain(blk, x, mask, h, 1e-6), 10)
    for key, dt, s_blk, blocked in (("k2_block", torch.float32, 496, False),
                                    ("k3_block", torch.bfloat16, 1536, True)):
        lens = list(np.random.RandomState(SEED).randint(s_blk // 10, s_blk + 1, size=b))
        xb, mb = layer_inputs(b, s_blk, d, dt, gen, lens)
        size = 4 if dt == torch.float32 else 2
        bounds[key] = bound({"fp32" if size == 4 else "bf16":
                             2 * b * s_blk * w_block + attn_flops(h, hd, s_blk, lens)},
                            size * (3 * b * s_blk * d + w_block))
        variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK) if blocked else ("one_shot",)
        times[key] = paired_ms(lambda: ea.fused_block_attention(blk, xb, mb, h, 1e-6, variant),
                               lambda: ea.fused_block_attention_plain(blk, xb, mb, h, 1e-6, variant),
                               5)
    qkv, m16 = layer_inputs(TRAIN_BATCH, 500, 3 * d, torch.bfloat16, gen,
                            list(np.random.RandomState(SEED).randint(100, 501, size=TRAIN_BATCH)))
    g = torch.randn(TRAIN_BATCH, 500, d, generator=gen).to(DEVICE, torch.bfloat16)
    valid16 = m16.sum(dim=1).tolist()
    bounds["k4"] = bound({"bf16": attn_flops(h, hd, 500, valid16)}, 2 * TRAIN_BATCH * 500 * 4 * d)
    bounds["k7"] = bound({"bf16": attn_flops(h, hd, 500, valid16, products=5)},
                         2 * TRAIN_BATCH * 500 * 7 * d)
    times["k4"] = paired_ms(lambda: kern.attention_k4(qkv, m16, h),
                            lambda: kern.attention_plain(qkv, m16, h), 10)
    times["k7"] = paired_ms(lambda: kern.attention_bwd(qkv, m16, g, h),
                            lambda: kern.attention_bwd_plain(qkv, m16, g, h), 10)
    lens = list(np.random.RandomState(SEED).randint(150, 1501, size=TRAIN_BATCH_30))
    q, m4 = layer_inputs(TRAIN_BATCH_30, 1500, d, torch.bfloat16, gen, lens)
    kv, _ = layer_inputs(TRAIN_BATCH_30, 1500, 2 * d, torch.bfloat16, gen, lens)
    bounds["k5"] = bound({"bf16": attn_flops(h, hd, 1500, lens)}, 2 * TRAIN_BATCH_30 * 1500 * 4 * d)
    times["k5"] = paired_ms(lambda: ea.encoder_attention_blocked(q, kv, m4, h),
                            lambda: ea.encoder_attention_blocked_plain(q, kv, m4, h), 10)
    # the K5 call against its kernel alone, and the host time per call
    host = {"k5_kernel_ms": cuda_ms(lambda: kern.attention_k5(q, kv, m4, h), 10),
            "k5_call_host_us": host_us(lambda: ea.encoder_attention_blocked(q, kv, m4, h)),
            "k5_host_us": host_us(lambda: kern.attention_k5(q, kv, m4, h)),
            "k4_host_us": host_us(lambda: kern.attention_k4(qkv, m16, h)),
            "k4_kernel_ms": times["k4"][0]}
    print(f"  K5 call (B=4, S=1500, no padding copy) {times['k5'][0]:.4f} ms, the kernel alone "
          f"{host['k5_kernel_ms']:.4f} ms; host per call: K5 {host['k5_host_us']:.1f} us "
          f"(encoder_attention_blocked {host['k5_call_host_us']:.1f} us), K4 {host['k4_host_us']:.1f} us "
          f"against its kernel's {1e3 * times['k4'][0]:.1f} us ({label})")
    times["k6_attn"] = paired_ms(
        lambda: ea.fused_ln_attention(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6),
        lambda: ea.fused_ln_attention_plain(blk.ln1, blk.attn.qkv, x, mask, h, 1e-6), 10)
    lens = list(np.random.RandomState(SEED).randint(153, 1537, size=b))
    x30, m30 = layer_inputs(b, 1536, d, torch.bfloat16, gen, lens)
    bounds["k3_layer"] = bound({"bf16": 2 * b * 1536 * w_layer + attn_flops(h, hd, 1536, lens)},
                               2 * (2 * b * 1536 * d + w_layer))
    variant = ("blocked", ea.FUSED_BLOCKED_Q_BLOCK)
    times["k3_layer"] = paired_ms(lambda: ea.fused_layer(blk, x30, m30, h, 1e-6, variant),
                                  lambda: ea.fused_layer_plain(blk, x30, m30, h, 1e-6, variant), 5)
    # the frequency table's gradient of the bf16 10-s step at B=128: g read
    # once, the indices read once, the fp32 table written once
    g, inds = table_grad_inputs(128, 500, d, torch.bfloat16, gen)
    bounds["table_grad"] = bound({}, g.numel() * 2 + inds.numel() * 8 + 8 * d * 4)
    times["table_grad"] = paired_ms(lambda: kern.table_grad(g, inds, 8),
                                    lambda: kern.table_grad_plain(g, inds, 8), 20)
    front = configs.FrontendConfig()
    for frames in (1000, 3000):
        bufs = 0.1 * torch.randn(b, frames * 160, generator=gen)
        rows = fused.buffer_to_rows(bufs.to(DEVICE), frames, front)
        bounds[f"log_mel_{frames}"] = log_mel_bound(front, b, frames, False)
        bounds[f"log_mel_fast_{frames}"] = log_mel_bound(front, b, frames, True)
        times[f"log_mel_{frames}"] = paired_ms(lambda: fused.fused_log_mel(rows, front, frames),
                                               lambda: fused.fused_log_mel_plain(rows, front, frames),
                                               10)
        times[f"log_mel_fast_{frames}"] = paired_ms(
            lambda: fused.fused_log_mel(rows, front, frames, fast_dft=True),
            lambda: fused.fused_log_mel_plain(rows, front, frames, fast_dft=True), 10)
    what = {"layer_norm": "LN1 + LN2 (bf16, S=496)", "gemm": "4 products, one layer (bf16, S=496)",
            "attention": "attention (bf16, S=496)", "k1_layer": "K1 chain, one layer (bf16, S=496)",
            "k2_block": "K2 block (fp32, S=496)", "k3_block": "K3 block (bf16, S=1536)",
            "k4": "K4 (bf16, B=16, S=500)", "k7": "K7 (bf16, B=16, S=500)",
            "k5": "K5 (bf16, B=4, S=1500 → 1536)",
            "log_mel_1000": "K8 log-mel (1000 frames)", "log_mel_3000": "K8 log-mel (3000 frames)",
            "k6_attn": "K6 LN1 → QKV → attention (bf16, S=496)",
            "k3_layer": "K3′ layer (bf16, S=1536)",
            "log_mel_fast_1000": "K8′ log-mel (1000 frames)",
            "log_mel_fast_3000": "K8′ log-mel (3000 frames)",
            "table_grad": "table_grad (bf16, 64 000 x 768 -> 8)"}
    for k, (km, pm) in times.items():
        bms = f"  bound {bounds[k][0]:.4f} ms ({bounds[k][1]})" if k in bounds else ""
        print(f"  {what[k]:<38} kernel {km:.4f} ms  plain {pm:.4f} ms{bms}  ({label})")
    return times, bounds, host


def sdpa_backend(q, k, v, am) -> str:
    """The CUDA kernels one SDPA call launches (its backend), by the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    picked = [n for n in names if any(w in n.lower() for w in ("sdpa", "fmha", "flash", "attention", "attn"))]
    return "; ".join(n[:90] for n in (picked or names))


def graph_device_ms(fn, inputs, n: int = 42) -> float:
    """Device ms per call of fn(x), x rotating over `inputs` (together
    larger than the 50-MB L2): CUDA events around one replay of a CUDA
    graph of n calls, so the host's enqueue, which outlasts a call's kernel
    when events bracket back-to-back calls, is not in it.  (torch.profiler
    recorded 39 of 42 such kernels in one run of this script and none in
    another, after the profiler sessions of earlier phases.)"""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def layer_norm_device_times(gen, out, label):
    """The LayerNorm link's device time against F.layer_norm's (its weights
    cast once, outside the timed call), B=32, S=496, D=768, bf16 (the K1,
    K3, K3′ and K6 chains) and fp32 (K2), inputs rotated over >= 150 MB;
    each beside its bound (one read and one write of the rows).  Prints
    rule 2's reading: a kernel under half of its bound is a candidate for
    a redesign.  The launch count shows the graph ran the kernel."""
    rows, d = BATCH * 496, D
    sc = (1.0 + 0.1 * torch.randn(d, generator=gen)).to(DEVICE)
    sh = (0.1 * torch.randn(d, generator=gen)).to(DEVICE)
    for dt, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        n_buf = -(-150_000_000 // (rows * d * size))
        xs = [torch.randn(BATCH, 496, d, generator=gen).to(DEVICE, dt) for _ in range(n_buf)]
        sc_t, sh_t = sc.to(dt), sh.to(dt)
        kern.reset_launches()
        km = graph_device_ms(lambda x: kern.layer_norm(x, sc, sh, 1e-6), xs)
        check(kern.LAUNCHES["layer_norm"] == len(xs) + 42,
              f"layer_norm launched {kern.LAUNCHES['layer_norm']} times for the graph")
        lm = graph_device_ms(lambda x: F.layer_norm(x, (d,), sc_t, sh_t, 1e-6), xs)
        b_ms, by = bound({}, 2 * size * rows * d)
        key = "layer_norm" if dt == torch.bfloat16 else "layer_norm_fp32"
        out[key] = {"what": f"LayerNorm link ({_dt_name(dt)}, B=32, S=496), device time",
                    "ms": km, "library_ms": lm, "bound_ms": b_ms, "bound_by": by,
                    "share_of_bound": b_ms / km, "library_share_of_bound": b_ms / lm,
                    "inputs_mb": n_buf * rows * d * size / 1e6}
        verdict = ("under half of its bound: a candidate for rule 2" if b_ms / km < 0.5
                   else "at half of its bound or better: rule 2 leaves it")
        print(f"  {out[key]['what']:<44} kernel {km:.4f} ms ({b_ms / km:.2f} of its bound "
              f"{b_ms:.4f} ms)  F.layer_norm {lm:.4f} ms ({b_ms / lm:.2f}), inputs rotated over "
              f"{n_buf} buffers, {out[key]['inputs_mb']:.0f} MB; {verdict} ({label})")
        del xs


def log_mel_bound(front, b, frames, fast):
    """K8's (or K8′'s) bound at (b, frames): the DFT over the bins whose mel
    row has a nonzero (2 columns each) and the mel product over the mel
    matrix's nonzeros, fp32 (K8′: the DFT as 3 bf16 products); bytes: the
    audio rows read once, the log-mel written once."""
    cols, terms = fused.spectrum_work(front)
    dft, mel = 2 * b * frames * front.window_length * cols, 2 * b * frames * terms
    nbytes = 4 * (b * fused.audio_rows_for(frames, front) * front.hop_length + b * frames * front.num_mels)
    return bound({"bf16": 3 * dft, "fp32": mel} if fast else {"fp32": dft + mel}, nbytes)


def links_phase(blk, label):
    """Phase 13, the redesigned kernels against one PyTorch call each, in
    turns (kernel, library, library, kernel): the bf16 GEMM link at the four
    10-s products (M = 32·496) and the 30-s QKV and o-proj (M = 32·1536)
    against torch.matmul on the same operands (the epilogue is left out of
    the library call); the bf16 attention link at S = 496 and 1536 (B = 32),
    K4 (B=16, S=500) and K5 (B=4, S=1536, 1500 valid at most) against
    F.scaled_dot_product_attention on the same Q, K, V as (B, H, S, Dh)
    views with the key mask as a boolean attn_mask; K7 against SDPA's
    backward (forward + backward less forward); K2's fp32 links, the
    LayerNorm link and K8's three calls (torch.stft, the mel product, the
    log)."""
    gen = torch.Generator().manual_seed(SEED + 8)
    d, h, hd = D, H, D // H
    out = {}

    def report(key, what, km, lm, ops, nbytes):
        b_ms, by = bound(ops, nbytes)
        flops = sum(ops.values())
        out[key] = {"what": what, "ms": km, "library_ms": lm, "bound_ms": b_ms, "bound_by": by,
                    "tflops": flops / km / 1e9, "library_tflops": flops / lm / 1e9,
                    "share_of_bound": b_ms / km}
        print(f"  {what:<44} kernel {km:.4f} ms ({flops / km / 1e9:.0f} TFLOP/s, "
              f"{b_ms / km:.2f} of its bound {b_ms:.4f} ms)  library {lm:.4f} ms ({label})")

    with torch.no_grad():
        for seconds, m in ((10, BATCH * 496), (30, BATCH * 1536)):
            shapes = [("qkv", 3 * d, d, kern.EPI_BIAS), ("o-proj", d, d, kern.EPI_BIAS_RESID_F32),
                      ("mlp up", INTER, d, kern.EPI_BIAS_SILU),
                      ("mlp down", d, INTER, kern.EPI_BIAS_CAST_ADD)]
            for name, n, k, epi in shapes[: 4 if seconds == 10 else 2]:
                a = torch.randn(m, k, generator=gen).to(DEVICE, torch.bfloat16)
                w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(DEVICE, torch.bfloat16)
                bias = torch.randn(n, generator=gen).to(DEVICE)
                r = torch.randn(m, n, generator=gen).to(DEVICE, torch.bfloat16)
                lm, km = paired_ms(lambda: torch.matmul(a, w), lambda: kern.gemm(a, w, bias, epi, r), 10)
                resid = m * n * 2 if epi in (kern.EPI_BIAS_RESID_F32, kern.EPI_BIAS_CAST_ADD) else 0
                report(f"gemm_{seconds}s_{name}", f"gemm {name}, {seconds} s (M={m} N={n} K={k})",
                       km, lm, {"bf16": 2 * m * n * k}, 2 * (m * k + k * n + m * n) + resid + 4 * n)
            del a, w, r

        def attn_case(key, what, b, s, valid_max, split=False, dt=torch.bfloat16):
            lens = list(np.random.RandomState(SEED).randint(valid_max // 10, valid_max + 1, size=b))
            x = (1.5 * torch.randn(b, s, 3 * d, generator=gen)).to(DEVICE, dt)
            mask = (torch.arange(s)[None, :] < torch.tensor(lens)[:, None]).to(DEVICE, torch.int32)
            if split:
                q, kv = x[..., :d].contiguous(), x[..., d:].contiguous()
                kfn = lambda: kern.attention_k5(q, kv, mask, h)  # noqa: E731
                qs, ks, vs = (kern.split_heads(t, h) for t in (q, *kv.chunk(2, dim=-1)))
            else:
                kfn = (lambda: kern.attention_k4(x, mask, h)) if key.startswith("k4") else (  # noqa: E731
                    lambda: kern.attention(x, mask, h))
                qs, ks, vs = (kern.split_heads(t, h) for t in x.chunk(3, dim=-1))
            am = (mask > 0)[:, None, None, :]
            lm, km = paired_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am), kfn, 10)
            size, kind = (4, "fp32") if dt == torch.float32 else (2, "bf16")
            report(key, what, km, lm, {kind: attn_flops(h, hd, s, lens)}, size * b * s * 4 * d)
            out[key]["sdpa_backend"] = sdpa_backend(qs, ks, vs, am)
            return x, mask, lens

        attn_case("attention_10s", "attention, 10 s (B=32, S=496)", BATCH, 496, 496)
        attn_case("attention_30s", "attention, 30 s (B=32, S=1536)", BATCH, 1536, 1536)
        qkv16, m16, lens16 = attn_case("k4", "K4 (B=16, S=500)", TRAIN_BATCH, 500, 500)
        attn_case("k5", "K5 (B=4, S=1536, ≤ 1500 valid)", TRAIN_BATCH_30, 1536, 1500, split=True)
        attn_case("k4_fp32", "K4 fp32 (B=16, S=500)", TRAIN_BATCH, 500, 500, dt=torch.float32)
        print(f"  SDPA backend: {out['attention_30s']['sdpa_backend']}; fp32: "
              f"{out['k4_fp32']['sdpa_backend']}")

    # K7 against SDPA's backward alone: one SDPA forward with grad, then its
    # backward (retain_graph) in turns with K7 on the same inputs
    g = torch.randn(TRAIN_BATCH, 500, d, generator=gen).to(DEVICE, torch.bfloat16)
    qh, kh, vh = (kern.split_heads(t, h).contiguous().requires_grad_() for t in qkv16.chunk(3, dim=-1))
    go, am = kern.split_heads(g, h).contiguous(), (m16 > 0)[:, None, None, :]
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
        lm, km = paired_ms(lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), go, retain_graph=True),
                           lambda: kern.attention_bwd(qkv16, m16, g, h), 10)
    report("k7", "K7 (B=16, S=500) vs SDPA backward", km, lm,
           {"bf16": attn_flops(h, hd, 500, lens16, products=5)}, 2 * TRAIN_BATCH * 500 * 7 * d)
    del sdpa_out

    with torch.no_grad():
        m = BATCH * 496
        for name, n, epi in (("qkv", 3 * d, kern.EPI_BIAS), ("o-proj", d, kern.EPI_BIAS_RESID_F32)):
            a = torch.randn(m, d, generator=gen).to(DEVICE)
            w = (torch.randn(d, n, generator=gen) / d ** 0.5).to(DEVICE)
            bias, r = torch.randn(n, generator=gen).to(DEVICE), torch.randn(m, n, generator=gen).to(DEVICE)
            lm, km = paired_ms(lambda: torch.matmul(a, w), lambda: kern.gemm(a, w, bias, epi, r), 5)
            report(f"gemm_fp32_{name}", f"K2 link: fp32 gemm {name} (M={m} N={n})", km, lm,
                   {"fp32": 2 * m * n * d}, 4 * (m * d + d * n + m * n))
        lens = list(np.random.RandomState(SEED).randint(49, 497, size=BATCH))
        x = torch.randn(BATCH, 496, 3 * d, generator=gen).to(DEVICE)
        mask = (torch.arange(496)[None, :] < torch.tensor(lens)[:, None]).to(DEVICE, torch.int32)
        qs, ks, vs = (kern.split_heads(t, h) for t in x.chunk(3, dim=-1))
        am = (mask > 0)[:, None, None, :]
        lm, km = paired_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                           lambda: kern.attention(x, mask, h), 5)
        report("attention_fp32", "K2 link: fp32 attention (B=32, S=496)", km, lm,
               {"fp32": attn_flops(h, hd, 496, lens)}, 4 * BATCH * 496 * 4 * d)
        layer_norm_device_times(gen, out, label)

        front = configs.FrontendConfig()
        frames, bins = 1000, front.fft_size // 2 + 1
        rows = fused.buffer_to_rows((0.1 * torch.randn(BATCH, frames * 160, generator=gen)).to(DEVICE),
                                    frames, front)
        for key, fast in (("k8", False), ("k8_fast", True)):
            km = cuda_ms(lambda: fused.fused_log_mel(rows, front, frames, fast_dft=fast), 10)
            b_ms, by = log_mel_bound(front, BATCH, frames, fast)
            out[key] = {"what": f"K8{'′' if fast else ''} (B=32, 1000 frames)", "ms": km,
                        "bound_ms": b_ms, "bound_by": by, "share_of_bound": b_ms / km}
            print(f"  {out[key]['what']:<44} kernel {km:.4f} ms ({b_ms / km:.2f} of its bound "
                  f"{b_ms:.4f} ms: the bins with a nonzero mel row, the mel nonzeros) ({label})")
        bufs = (0.1 * torch.randn(BATCH, frames * 160 + front.window_length, generator=gen)).to(DEVICE)
        win = torch.hann_window(front.window_length, periodic=True, device=DEVICE)
        melm = torch.rand(bins, front.num_mels, generator=gen).to(DEVICE)
        stft = lambda: torch.stft(bufs, front.fft_size, front.hop_length, front.window_length, win,  # noqa: E731
                                  center=False, return_complex=True).abs()
        spec = stft().transpose(1, 2)[:, :frames].contiguous()
        mel = spec @ melm
        three = {"torch.stft + abs": cuda_ms(stft, 10), "mel product": cuda_ms(lambda: spec @ melm, 10),
                 "log": cuda_ms(lambda: torch.log(mel + front.log_offset), 10)}
        out["k8_library_calls"] = three
        print("  K8 as three PyTorch calls (B=32, 1000 frames): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in three.items()) + f" ({label})")
    return out


RUNNER_CLIPS, RUNNER_STEPS, RUNNER_RESUMED_STEPS = 48, 3, 5
COS_LOADED = 0.99999  # the same weights through the same kernels


def checkpoint_phase(cfg, model, wavs, a_emb, tok):
    """Phase 14a: phase 5's model → a released-layout msgpack file → load_caco
    (config inferred, strict counts) → a bf16 10-s engine."""
    n_buckets = -(-len(wavs) // BATCH)
    print("phase 14a: a released-layout checkpoint at caco_base, written and loaded by the port")
    tmp = tempfile.mkdtemp(prefix="caco_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        ref = convert.caco_params_to_reference(bridge.params_to_jax(model), cfg.audio.num_heads)
        path = msgpack.save_checkpoint(tmp, {"0": {"params": ref}}, step=0)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del ref
        t0 = time.perf_counter()
        cfg_loaded, loaded = ckpt_io.load_caco(tmp)  # cfg=None, strict_counts=True, on the card
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    counts = {k: ckpt_io.count_params(getattr(loaded, k)) / 1e6
              for k in ckpt_io.PUBLISHED_PARAM_COUNTS_M}
    print(f"  {os.path.basename(path)}: {size} bytes ({size / 2 ** 30:.3f} GiB), written in "
          f"{write_s:.2f} s, loaded onto the card in {load_s:.2f} s; counts (M) "
          + ", ".join(f"{k} {v:.4f}" for k, v in counts.items()))
    check(cfg_loaded == configs.caco_base(), f"inferred config {cfg_loaded} is not caco_base()")
    src = model.state_dict()
    got_state = loaded.state_dict()
    check(set(got_state) == set(src), "the loaded model has other parameters")
    differ = [k for k, t in got_state.items() if not torch.equal(t, src[k])]
    check(not differ, f"loaded tensors differ from the source model: {differ[:4]}")
    print(f"  {len(got_state)} tensors, every one identical to the source model's")
    engine = CacoEngine(cfg_loaded, loaded, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                        dtype=torch.bfloat16)
    emb, got = drive("bf16 10-s embed_audio on the loaded model", lambda: engine.embed_audio(wavs),
                     {"k1_layer": cfg.audio.num_layers * n_buckets, "k2_block": 0, "k3_block": 0})
    check_embeddings("loaded-model audio", emb, len(wavs), cfg)
    cos = float(cosine_rows(emb, a_emb).min())
    print(f"  cosine loaded vs source model, bf16 ({len(wavs)} clips, min) {cos:.7f} "
          f"(≥ {COS_LOADED})")
    check(cos >= COS_LOADED, "the loaded model's embeddings disagree with the source model's")
    del engine, loaded
    return got, {"file_bytes": size, "write_s": write_s, "load_s": load_s, "param_counts_m": counts,
                 "cosine_min": cos}


def write_runner_data(root: str, rs):
    """48 clips of 3-10 s in three formats (the second one 10 s at 44.1 kHz),
    captions.csv, and a tokenizer directory holding byte_vocab()."""
    from scipy.io import wavfile

    data, tok = os.path.join(root, "data"), os.path.join(root, "tok")
    os.makedirs(data)
    os.makedirs(tok)
    rows = [["file_name", "caption"]]
    for i in range(RUNNER_CLIPS):
        seconds = 10.0 if i == 1 else rs.uniform(3, 10)
        kind = i % 3
        sr = (16000, 44100, 48000)[kind]
        x = (0.1 * rs.randn(int(seconds * sr), 2 if kind == 1 else 1)).astype(np.float32)
        name = f"clip{i:02d}.wav"
        if kind == 2:
            wavfile.write(os.path.join(data, name), sr, x[:, 0])  # float32
        else:
            wavfile.write(os.path.join(data, name), sr, (x * 32767).astype(np.int16).squeeze())
        rows += [[name, f"sound number {i}"], [name, f"another take of sound {i}"]]
    with open(os.path.join(data, "captions.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    with open(os.path.join(tok, "vocab.json"), "w") as f:
        json.dump(byte_vocab(), f)
    with open(os.path.join(tok, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return data, tok


def echoed(fn, *args, **kw):
    """fn(*args, **kw) with its standard output captured and echoed (also
    when it raises) → (its result, the output)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = fn(*args, **kw)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"    | {line}")
    return result, buf.getvalue()


def run_main(argv):
    """runner.main(argv) with its standard output captured and echoed."""
    return echoed(runner.main, argv)


def runner_phase(cfg, label, tmp, data, tok):
    """Phase 14b: the stage-2 runner from audio files on the card, then a
    resumed run; its work directory under `tmp` is deleted."""
    n = cfg.audio.num_layers
    print(f"phase 14b: train.runner --stage caco at caco_base, bf16, B={TRAIN_BATCH}, 500 patches, "
          f"{RUNNER_CLIPS} clips")
    work = os.path.join(tmp, "work")
    try:
        argv = ["--stage", "caco", "--data-dir", data, "--workdir", work, "--tokenizer", tok,
                "--batch-size", str(TRAIN_BATCH), "--buffer-seconds", "10",
                "--patches-seq-len", "500", "--total-steps", str(RUNNER_RESUMED_STEPS),
                "--checkpoint-every", "0", "--log-every", "1", "--dtype", "bfloat16",
                "--device", DEVICE]
        per_step = {"k5": 0, **NO_SERVING_KERNELS}
        for k in pipeline.DECODE_COUNTS:
            pipeline.DECODE_COUNTS[k] = 0
        (state, _), got = drive(f"runner, {RUNNER_STEPS} steps",
                                lambda: run_main(argv + ["--steps", str(RUNNER_STEPS)]),
                                {"k4": n * RUNNER_STEPS, "k7": n * RUNNER_STEPS, **per_step})
        first = dict(pipeline.DECODE_COUNTS)
        ckpts = sorted(os.listdir(os.path.join(work, "checkpoints")))
        print(f"  decoded {first} (native decoder, per-file fallback); checkpoints {ckpts}")
        check(first == {"native": RUNNER_CLIPS, "fallback": 0},
              f"the native decoder did not decode every file once: {first}")
        check(state.step == RUNNER_STEPS and ckpts == [f"step_{RUNNER_STEPS:08d}"],
              f"step {state.step}, checkpoints {ckpts}")
        del state
        for k in pipeline.DECODE_COUNTS:
            pipeline.DECODE_COUNTS[k] = 0
        resumed = RUNNER_RESUMED_STEPS - RUNNER_STEPS
        (state, out), got2 = drive(f"runner resumed to step {RUNNER_RESUMED_STEPS}",
                                   lambda: run_main(argv + ["--steps", str(RUNNER_RESUMED_STEPS)]),
                                   {"k4": n * resumed, "k7": n * resumed, **per_step})
        second = dict(pipeline.DECODE_COUNTS)
        print(f"  decoded {second} in the resumed run")
        check(f"resumed from step {RUNNER_STEPS}" in out, "the second run did not resume")
        check(second == {"native": resumed * TRAIN_BATCH, "fallback": 0},
              f"the resumed run decoded {second}: the trained batches were not skipped")
        check(state.step == RUNNER_RESUMED_STEPS, f"the resumed run ended at step {state.step}")
        del state
        with open(os.path.join(work, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = [r["step"] for r in rows]
        losses = [r["loss"] for r in rows]
        print(f"  logged steps {steps}, loss {['%.5f' % v for v in losses]}")
        check(steps == list(range(RUNNER_RESUMED_STEPS)), f"logged steps {steps}")
        check(all(np.isfinite(losses)), "a logged loss is not finite")
        # the runner's step time: between consecutive logged rows of one run
        # (each row reads the step's metrics, which waits for the card).  The
        # prefetch decodes two batches before a run's first step and each
        # later batch on the host between two steps: of these intervals only
        # the one ending at step 1 holds a decode
        intervals = {b["step"]: 1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])
                     if b["step"] != RUNNER_STEPS}
        ms = list(intervals.values())
        print(f"  runner step intervals (ending at step: ms) "
              f"{ {k: round(v, 1) for k, v in intervals.items()} }, median {np.median(ms):.1f} "
              f"ms ({label})")
        loader = pipeline.CacoTrainLoader([], {}, None, pipeline.TrainDataConfig())
        _, lens = loader._decode([os.path.join(data, "clip01.wav")])
        check(lens.tolist() == [160000], f"a 10-s 44.1-kHz clip decoded to {lens.tolist()} samples")
        print("  a 10-s clip at 44.1 kHz comes out 160000 samples long")
        # the host's share of a step: one batch's native decode alone, and
        # with the resample to 16 kHz (the loader's _decode)
        paths = [os.path.join(data, f"clip{i:02d}.wav") for i in range(TRAIN_BATCH)]
        native_ms, decode_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            wavio.decode_batch(paths, loader.buffer_samples * loader.MAX_SOURCE_RATE_RATIO)
            native_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            loader._decode(paths)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"  host decode of {TRAIN_BATCH} clips (a third at 44.1 kHz, a third at 48 kHz): "
              f"native {['%.1f' % v for v in native_ms]} ms, with the resample "
              f"{['%.1f' % v for v in decode_ms]} ms")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return got, got2, {"decoded": first, "decoded_resumed": second, "loss": losses,
                       "step_ms": intervals, "median_step_ms": float(np.median(ms)),
                       "host_native_decode_ms": native_ms, "host_decode_ms": decode_ms}


def remat_phase(cfg, rs):
    """Phase 14c: one bf16 10-s loss and backward with remat_encoder on and
    one with it off, from the same parameters and generator state."""
    n = cfg.audio.num_layers
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = caco_init(cfg16, torch.Generator().manual_seed(SEED)).to(DEVICE)
    batch = train_batch(cfg16, rs, TRAIN_BATCH, 10, 500)
    print(f"phase 14c: remat_encoder on the card, bf16 10 s, B={TRAIN_BATCH}")
    out, got = {}, {}
    for remat in (True, False):
        loss_fn = train.make_caco_loss(cfg16, train.TrainConfig(remat_encoder=remat))
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        model.zero_grad(set_to_none=True)

        def step():
            loss, _ = loss_fn(model, batch, gen)
            loss.backward()
            return float(loss.detach())

        loss, got[remat] = drive(f"loss + backward, remat_encoder={remat}", step,
                                 {"k4": n * (2 if remat else 1), "k7": n, "k5": 0,
                                  **NO_SERVING_KERNELS})
        out[remat] = (loss, [p.grad.detach().clone() if p.grad is not None
                             else torch.zeros_like(p) for p in model.parameters()])
    (l_r, g_r), (l_p, g_p) = out[True], out[False]
    atol, rtol = TOL[torch.bfloat16]["chain"]
    worst = max(float(((a - b).abs() - rtol * b.abs()).max()) for a, b in zip(g_r, g_p))
    flat_r, flat_p = torch.cat([g.flatten() for g in g_r]), torch.cat([g.flatten() for g in g_p])
    rel = float((flat_r - flat_p).norm() / flat_p.norm())
    print(f"  loss remat {l_r!r} / plain {l_p!r}; gradients: max(|d| - {rtol}·|g|) {worst:.3e} "
          f"(≤ {atol}), rel L2 {rel:.2e}")
    check(l_r == l_p, "remat changes the loss")
    check(worst <= atol, "remat changes the gradients past the bf16 chain bound")
    del model
    return got, {"loss": [l_r, l_p], "grad_excess": worst, "grad_rel_l2": rel}


# Stage 1 (phase 15).  bench.py's reconstruction shape: B=64 10-s buffers at
# 500 patches, mask ratio 0.8 (100 visible, 400 to reconstruct); the
# training step at B=16; the fp32 reconstruction against the CPU at B=2.
MAE_BATCH, MAE_TRAIN_BATCH, MAE_STEPS, MAE_TIMED = 64, 16, 4, 5
# frequency-table gathers a stage-1 step differentiates: the encoder's, and
# the decoder's for the visible patches and for the restore set
MAE_TABLES = 3
MAE_SHORT_SAMPLES = 24_000  # 1.5 s: 72 valid patches, fewer than the 100 visible
MAE_ARGS = ("patches", "mask", "time_inds", "freq_inds", "restore_time_inds",
            "restore_freq_inds", "restore_mask")
# The fp32 reconstruction on the card against the CPU's plain path, and bf16
# against fp32 on the card: min cosine over the reconstructed patch rows
# (PERF.md §2, the fp32 and bf16 agreement bounds of the serving path).
COS_MAE = {torch.float32: 0.9999, torch.bfloat16: 0.999}


def mae_grid(rs):
    """bench.py's input: MAE_BATCH 10-s buffers of 0.1·randn at 500 patches
    (496 valid), the last clip cut to 1.5 s, so that padding lies inside
    its visible set; masked with ratio 0.8 by the port's masking."""
    front, samples = configs.FrontendConfig(), 10 * 16000
    bufs = (0.1 * rs.randn(MAE_BATCH, samples)).astype(np.float32)
    lens = np.full(MAE_BATCH, samples, np.int32)
    lens[-1] = MAE_SHORT_SAMPLES
    bufs[-1, MAE_SHORT_SAMPLES:] = 0.0
    grid = wav_to_patches(torch.from_numpy(bufs).to(DEVICE), torch.from_numpy(lens).to(DEVICE),
                          front, configs.PatchConfig(patches_seq_len=500))
    noise = train.mae_noise(torch.Generator(device=DEVICE).manual_seed(SEED), grid["audio_mask"])
    return train.mae_random_masking(noise, grid, configs.audiomae_base().mask_ratio)


def row_cosines(a, b):
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return F.cosine_similarity(a, b.to(a.device), dim=-1)


@torch.inference_mode()
def mae_kernel_checks(model, cfg, m):
    """K1, K2, K4 and K7 against their plain versions at phase 15's shapes,
    on the first layer's real inputs: K1 at the encoder's 100 patches (bf16,
    fp32) and the decoder's 500 (bf16), K2 at the decoder's 500 (fp32), K4
    and K7 at the training batch's B=16 in both towers (K7 where
    `bwd_fits_vmem` holds: fp32 only at 100)."""
    enc, dec = cfg.encoder, cfg.decoder
    gen = torch.Generator().manual_seed(SEED + 15)
    errs = {}

    def keep(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    for dt in (torch.bfloat16, torch.float32):
        name = _dt_name(dt)
        x = audio_input_embedding(model.encoder, enc, m["patches"], m["time_inds"],
                                  m["freq_inds"], dt)
        blk = model.encoder.blocks[0]
        keep("K1", compare(f"K1 {name} S=100 (encoder layer 0)",
                           ea.fused_layer(blk, x, m["mask"], enc.num_heads, LN_EPS),
                           ea.fused_layer_plain(blk, x, m["mask"], enc.num_heads, LN_EPS),
                           *TOL[dt]["chain"]))
        h = audio_encoder_apply(model.encoder, enc, m["patches"], m["time_inds"], m["freq_inds"],
                                m["mask"], dtype=dt)
        xd, full = audio_decoder_input(model.decoder, h, *(m[k] for k in MAE_ARGS[1:]), dt)
        dblk = model.decoder.blocks[0]
        if dt == torch.bfloat16:
            keep("K1", compare(f"K1 {name} S=500 (decoder layer 0)",
                               ea.fused_layer(dblk, xd, full, dec.num_heads, LN_EPS),
                               ea.fused_layer_plain(dblk, xd, full, dec.num_heads, LN_EPS),
                               *TOL[dt]["chain"]))
        else:
            got = ea.fused_block_attention(dblk, xd, full, dec.num_heads, LN_EPS, ("one_shot",))
            ref = ea.fused_block_attention_plain(dblk, xd, full, dec.num_heads, LN_EPS,
                                                 ("one_shot",))
            for part, a, b in zip(("y", "LN2 y"), got, ref):
                keep("K2", compare(f"K2 {name} S=500 (decoder layer 0) {part}", a, b,
                                   *TOL[dt]["chain"]))
        for tower, layer, xs, mask in (("encoder", blk, x, m["mask"]), ("decoder", dblk, xd, full)):
            xs, mask = xs[:MAE_TRAIN_BATCH], mask[:MAE_TRAIN_BATCH].contiguous()
            s = xs.shape[1]
            qkv = dense(layer.attn.qkv, layer_norm(layer.ln1, xs, LN_EPS), dt).contiguous()
            keep("K4", compare(f"K4 {name} S={s} ({tower} layer 0)",
                               kern.attention_k4(qkv, mask, H), kern.attention_plain(qkv, mask, H),
                               *TOL[dt]["kernel"]))
            if ea.bwd_fits_vmem(s, D, dt):
                g = torch.randn(xs.shape[0], s, D, generator=gen).to(DEVICE, dt)
                keep("K7", compare(f"K7 {name} S={s} ({tower} layer 0)",
                                   kern.attention_bwd(qkv, mask, g, H),
                                   kern.attention_bwd_plain(qkv, mask, g, H), *TOL[dt]["k7"]))
    return errs


def mae_recon_phase(rs, label):
    """Phase 15a: the stage-1 reconstruction forward at audiomae_base (random
    weights from the seed), bench.py's shape, bf16 and fp32."""
    cfg = configs.audiomae_base()
    enc, dec = cfg.encoder, cfg.decoder
    cpu_model = audiomae_init(enc, dec, torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(cpu_model).to(DEVICE)
    m = mae_grid(rs)
    s_vis, s_all = m["patches"].shape[1], m["target_patches"].shape[1]
    print(f"phase 15a: AudioMAE reconstruction, audiomae_base, B={MAE_BATCH} 10-s buffers, "
          f"{s_all} patches, mask {cfg.mask_ratio}: encoder S={s_vis}, decoder S={s_all}")
    check((s_vis, s_all) == (100, 500), f"visible / decoder lengths {s_vis} / {s_all}")
    short_visible = int(m["mask"][-1].sum())
    check(0 < short_visible < s_vis, f"the short clip has {short_visible} visible patches")
    routes = {dt: (ea.layer_route(s_vis, enc.hidden_size, enc.intermediate_size, dt)[0],
                   ea.layer_route(s_all, dec.hidden_size, dec.intermediate_size, dt)[0])
              for dt in (torch.bfloat16, torch.float32)}
    print(f"  layer_route (encoder, decoder): bf16 {routes[torch.bfloat16]}, "
          f"fp32 {routes[torch.float32]}; the short clip has {short_visible} of {s_vis} "
          f"visible patches valid")
    check(routes == {torch.bfloat16: ("k1", "k1"), torch.float32: ("k1", "k2")},
          f"routes {routes}")
    args = [m[k] for k in MAE_ARGS]
    layers = enc.num_layers + dec.num_layers
    chain = dict.fromkeys(K1_PARTS)
    no_train = {"k4": 0, "k5": 0, "k7": 0, "k3_block": 0, "k3_layer": 0, "k6_attn": 0}

    def recon(dt, net=model, a=args):
        with torch.inference_mode():
            return audiomae_apply(net, enc, dec, *a, dtype=dt)

    out16, got16 = drive("bf16 reconstruction", lambda: recon(torch.bfloat16),
                         {"k1_layer": layers, "k2_block": 0, **no_train, **chain})
    out32, got32 = drive("fp32 reconstruction", lambda: recon(torch.float32),
                         {"k1_layer": enc.num_layers, "k2_block": dec.num_layers, **no_train,
                          **chain})
    for name, out in (("bf16", out16), ("fp32", out32)):
        check(out.shape == (MAE_BATCH, s_all, 256) and bool(torch.isfinite(out).all()),
              f"{name} reconstruction: shape {tuple(out.shape)} or non-finite values")
    errs = mae_kernel_checks(model, cfg, m)
    ms = []
    for _ in range(MAE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon(torch.bfloat16)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rate = MAE_BATCH / np.median(ms) * 1e3
    print(f"  mae_recon_clips_per_s {rate:.1f} (bf16, B={MAE_BATCH}, median of {MAE_TIMED} "
          f"forwards: {['%.2f' % v for v in sorted(ms)]} ms; {label})")
    pick = [0, MAE_BATCH - 1]  # a full clip and the short one
    cpu = recon(torch.float32, cpu_model, [a[pick].cpu() for a in args])
    cos_cpu = float(row_cosines(out32[pick].cpu(), cpu).min())
    cos16 = float(row_cosines(out16, out32).min())
    print(f"  cosine over patch rows: fp32 card vs fp32 CPU plain (B=2) {cos_cpu:.7f} "
          f"(≥ {COS_MAE[torch.float32]}); bf16 vs fp32 on the card (B={MAE_BATCH}) {cos16:.7f} "
          f"(≥ {COS_MAE[torch.bfloat16]})")
    check(cos_cpu >= COS_MAE[torch.float32], "fp32 reconstruction disagrees with the CPU")
    check(cos16 >= COS_MAE[torch.bfloat16], "bf16 reconstruction disagrees with fp32")
    del cpu_model, out32
    return model, m, out16, errs, {"bf16": got16, "fp32": got32}, {
        "mae_recon_clips_per_s": rate, "forward_ms": ms, "cosine_fp32_vs_cpu": cos_cpu,
        "cosine_bf16_vs_fp32": cos16, "short_clip_visible": short_visible,
        "routes": {_dt_name(k): v for k, v in routes.items()}}


@contextlib.contextmanager
def fixed_mae_noise(noise):
    """The stage-1 loss masks by `noise` (moved to the batch's device)."""
    draw = train.mae_noise
    train.mae_noise = lambda generator, mask: noise.to(mask.device)
    try:
        yield
    finally:
        train.mae_noise = draw


def mae_train_phase(rs, label):
    """Phase 15b: the stage-1 step at audiomae_base, B=16, 500 patches: bf16
    MAE_STEPS steps under one masking (a generator seeded alike each step),
    then timed steps; fp32 one step, timed steps, and loss and gradients at
    B=2 against the CPU's plain versions."""
    base = configs.audiomae_base()
    enc, dec = base.encoder, base.decoder
    layers = enc.num_layers + dec.num_layers
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    batch = audio_batch(rs, MAE_TRAIN_BATCH, 10, 500)
    per_step = {"k5": 0, **NO_SERVING_KERNELS}
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)  # noqa: E731
    out, got = {}, {}
    for dt, k7, steps in ((torch.bfloat16, layers, MAE_STEPS), (torch.float32, enc.num_layers, 1)):
        name = _dt_name(dt)
        cfg = dataclasses.replace(base, dtype=dt)
        print(f"phase 15b: {name} stage-1 training step, audiomae_base, B={MAE_TRAIN_BATCH}, "
              f"500 patches, {steps} step{'s' * (steps > 1)}")
        state = train.init_train_state(
            audiomae_init(enc, dec, torch.Generator().manual_seed(SEED)).to(DEVICE), tc)
        step = train.make_mae_train_step(cfg, tc)
        metrics = []

        def run_steps():
            nonlocal state
            for _ in range(steps):
                state, mt = step(state, batch, gen())
                metrics.append({k: float(v) for k, v in mt.items()})

        torch.cuda.reset_peak_memory_stats()
        _, got[name] = drive(f"{name} stage-1 step x{steps}", run_steps,
                             {"k4": layers * steps, "k7": k7 * steps,
                              "table_grad": MAE_TABLES * steps, **per_step})
        losses = [mt["loss"] for mt in metrics]
        check(all(np.isfinite(losses + [mt["grad_norm"] for mt in metrics])),
              f"{name} stage-1 step: non-finite loss or grad_norm")
        state, ms = time_steps(step, state, batch, gen(), 3 if dt == torch.float32 else 5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  loss {['%.5f' % v for v in losses]}, step times {['%.2f' % v for v in ms]} ms, "
              f"median {np.median(ms):.2f} ms/step, peak device memory {peak:.2f} GiB ({label})")
        out[name] = {"loss": losses, "step_ms": ms, "median_step_ms": float(np.median(ms)),
                     "peak_gib": peak}
        del state
    check(out["bfloat16"]["loss"][-1] < out["bfloat16"]["loss"][1],
          "the bf16 stage-1 loss did not fall")
    cfg = dataclasses.replace(base, dtype=torch.float32)
    loss_fn = train.make_mae_loss(cfg, tc)
    small = {k: v[:2] for k, v in batch.items()}
    res = []
    noise = train.mae_noise(torch.Generator().manual_seed(SEED), small["audio_mask"].cpu())
    with fixed_mae_noise(noise):
        for device in (DEVICE, "cpu"):
            net = audiomae_init(enc, dec, torch.Generator().manual_seed(SEED)).to(device)
            loss, _ = loss_fn(net, {k: v.to(device) for k, v in small.items()}, None)
            loss.backward()
            res.append((float(loss.detach()),
                        torch.cat([p.grad.flatten().double().cpu() for p in net.parameters()])))
            del net
    (l_card, g_card), (l_cpu, g_cpu) = res
    l_err = abs(l_card - l_cpu) / abs(l_cpu)
    g_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    print(f"  fp32 B=2 card vs CPU plain: loss {l_card:.6f} vs {l_cpu:.6f} (rel {l_err:.2e} ≤ "
          f"{STEP_TOL['loss']}), gradients rel L2 {g_err:.2e} (≤ {STEP_TOL['grads']})")
    check(l_err <= STEP_TOL["loss"] and g_err <= STEP_TOL["grads"],
          "the fp32 stage-1 step on the card disagrees with the CPU")
    out["fp32_b2_loss_rel_err"], out["fp32_b2_grad_rel_err"] = l_err, g_err
    return got, out


def mae_checkpoint_phase(model, m, out16, label, tmp, data, tok):
    """Phase 15c: phase 15a's model as a released-layout stage-1 file,
    `load_audiomae` of it onto the card, its bf16 reconstruction against
    15a's; `runner --stage mae` for 2 steps and `runner --stage caco
    --init-audio-from-mae` for 1 on phase 14b's files."""
    cfg = configs.audiomae_base()
    enc, dec = cfg.encoder, cfg.decoder
    layers = enc.num_layers + dec.num_layers
    print("phase 15c: a released-layout stage-1 checkpoint, written and loaded by the port, "
          "and the runner's two MAE entry points")
    ck = os.path.join(tmp, "mae_ckpt")
    t0 = time.perf_counter()
    ref = convert.audiomae_params_to_reference(bridge.params_to_jax(model), enc.num_heads,
                                               dec.num_heads)
    path = msgpack.save_checkpoint(ck, {"0": {"params": ref}}, step=0)
    write_s, size = time.perf_counter() - t0, os.path.getsize(path)
    del ref
    t0 = time.perf_counter()
    cfg_loaded, loaded = ckpt_io.load_audiomae(ck)  # cfg=None, strict counts, on the card
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    counts = {k: ckpt_io.count_params(getattr(loaded, k)) / 1e6 for k in ("encoder", "decoder")}
    print(f"  {os.path.basename(path)}: {size} bytes, written in {write_s:.2f} s, loaded onto "
          f"the card in {load_s:.2f} s; counts (M) encoder {counts['encoder']:.4f}, decoder "
          f"{counts['decoder']:.4f}")
    check(cfg_loaded == cfg, f"inferred config {cfg_loaded} is not audiomae_base()")
    src = model.state_dict()
    differ = [k for k, t in loaded.state_dict().items() if not torch.equal(t, src[k])]
    check(set(loaded.state_dict()) == set(src) and not differ,
          f"loaded tensors differ from the source model: {differ[:4]}")

    def recon():
        with torch.inference_mode():
            return audiomae_apply(loaded, enc, dec, *(m[k] for k in MAE_ARGS), dtype=torch.bfloat16)

    again, got_ck = drive("bf16 reconstruction on the loaded model", recon,
                          {"k1_layer": layers, "k2_block": 0})
    same = torch.equal(again, out16)
    print(f"  loaded model's bf16 reconstruction vs phase 15a's: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    check(same, "the loaded stage-1 model reconstructs other values")
    del loaded, again
    common = ["--data-dir", data, "--batch-size", str(TRAIN_BATCH), "--buffer-seconds", "10",
              "--patches-seq-len", "500", "--checkpoint-every", "0", "--log-every", "1",
              "--dtype", "bfloat16", "--device", DEVICE]
    per_step = {"k5": 0, **NO_SERVING_KERNELS}
    work = os.path.join(tmp, "mae_work")
    (state, _), got_mae = drive("runner --stage mae, 2 steps",
                                lambda: run_main(["--stage", "mae", "--workdir", work,
                                                  "--steps", "2"] + common),
                                {"k4": layers * 2, "k7": layers * 2, **per_step})
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows]
    print(f"  stage-1 runner: logged loss {['%.5f' % v for v in losses]}")
    check(state.step == 2 and [r["step"] for r in rows] == [0, 1] and all(np.isfinite(losses)),
          f"stage-1 runner: step {state.step}, logged {rows}")
    del state
    shutil.rmtree(work)
    work = os.path.join(tmp, "caco_from_mae")
    n = configs.caco_base().audio.num_layers
    (state, _), got_init = drive(
        "runner --stage caco --init-audio-from-mae, 1 step",
        lambda: run_main(["--stage", "caco", "--workdir", work, "--tokenizer", tok, "--steps", "1",
                          "--total-steps", "5", "--warmup-steps", "1",
                          "--init-audio-from-mae", path] + common),
        {"k4": n, "k7": n, **per_step})
    # the schedule's rate is 0 at step 0: the audio tower is still the file's encoder
    audio = state.params.audio.state_dict()
    differ = [k for k, t in model.encoder.state_dict().items() if not torch.equal(audio[k], t)]
    print(f"  stage 2 from the stage-1 file: {len(audio) - len(differ)} of {len(audio)} audio "
          f"tensors equal to the file's encoder after step 0")
    check(not differ, f"the audio tower is not the stage-1 encoder: {differ[:4]}")
    del state
    shutil.rmtree(work)
    shutil.rmtree(ck)
    return {"loaded": got_ck, "runner_mae": got_mae, "runner_init": got_init}, {
        "file_bytes": size, "write_s": write_s, "load_s": load_s, "param_counts_m": counts,
        "runner_mae_loss": losses}


# Captioning (phase 16).  bench.py's decode shape (`_decode_throughput`):
# bf16, 256 streams × max_length 64 at 500 patches, temperature 1.0, 1
# warm-up then 3 trials; its continuous shape (`_continuous_throughput`):
# 256 requests on 256 slots, drain_every 32.  Random weights over the
# 50 265-token vocabulary almost never sample EOS, so a stream decodes its
# whole budget: tokens = streams × (max_length − 1) per call.
DECODE_STREAMS, DECODE_LEN, DECODE_TRIALS, DECODE_PATCHES = 256, 64, 3, 500
CONT_SLOTS, CONT_DRAIN = 256, 32
CAPTION_CLIPS = 8
# fp32 stepwise decode logits against teacher forcing on the produced tokens
# (the same fp32 math, the attention over the cache instead of the causal
# bias): max |diff| / max |ref| over the live stream-steps.  bf16 against
# fp32 first-step logits: cosine per stream.  Near-greedy continuous
# captions against batch decode, each drawing its own Gumbel noise: equal,
# or the top-two logit gap where they first differ below 1e-4.  A gap g
# flips a draw at temperature T with probability 1 / (1 + exp(g / T)): at
# T = 1e-4 that is 1 % at g = 4.6e-4, so over some 250 draws the bound
# would fail about one run in ten with no fault; at T = 1e-6 a gap of 1e-4
# flips with probability e^-100.  Gallery against numpy: indices equal,
# scores to 1e-5 absolute (fp32 products summed in another order).
CAPTION_REL, CAPTION_COS, NEAR_TIE_GAP, GALLERY_ATOL = 1e-4, 0.999, 1e-4, 1e-5
NEAR_GREEDY_T = 1e-6
GALLERY_ROWS, GALLERY_DIM, GALLERY_QUERIES, GALLERY_SLAB = 262_144, 768, 1024, 131_072


def decoder_kw(tok, **kw):
    return dict(dict(bos_id=tok.bos_token_id, eos_id=tok.eos_token_id,
                     pad_id=tok.pad_token_id), **kw)


def stepwise(cfg, model, batch, tok, max_length, temperature, **kw):
    """A BatchDecoder run one step at a time → (ids, per-step logits
    (B, n, V), per-step generating flags (B, n))."""
    dec = caco.BatchDecoder(model, cfg, batch, max_length=max_length,
                            **decoder_kw(tok, temperature=temperature,
                                         generator=torch.Generator(device=DEVICE).manual_seed(0),
                                         **kw))
    logits, flags = [], []
    while dec.steps_left:
        flags.append(dec.state.is_generating.clone())
        dec.steps(1)
        logits.append(dec.logits.clone())
    return dec.state.input_ids.clone(), torch.stack(logits, 1), torch.stack(flags, 1)


def device_kernels(fn, top: int = 8):
    """fn once under torch.profiler (device activity only) → the `top`
    device operations by their summed time: (name, ms, count)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = total.get(e.name, (0.0, 0))
            total[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in total.items()), key=lambda r: -r[1])[:top]


def no_sync_window(dec) -> None:
    """One window of decode steps, any host sync in it raising."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dec.steps(caco.DECODE_WINDOW)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@torch.inference_mode()
def caption_engine_phase(cfg, model, tok, wavs, label):
    """Phase 16a: CacoEngine.caption at caco_base (bf16, fp32, bf16 with the
    fused frontend) on 8 clips of 3-10 s in 10-s buffers, and the decode
    path's checks on the same clips."""
    clips = wavs[:CAPTION_CLIPS]
    layers = cfg.audio.num_layers
    print(f"phase 16a: CacoEngine.caption at caco_base, {len(clips)} clips in 10-s buffers, "
          f"max_length 100, T 0.1, seed 42 (the reference's defaults)")
    engines, caps, got = {}, {}, {}
    for name, dt, fused_fe, expect in (
            ("bf16", torch.bfloat16, False, {"k1_layer": layers, "k2_block": 0, "log_mel": 0}),
            ("fp32", torch.float32, False, {"k2_block": layers, "k1_layer": 0}),
            ("bf16_fused_frontend", torch.bfloat16, True, {"log_mel": 1, "k1_layer": layers})):
        engines[name] = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE,
                                   batch_size=len(clips), dtype=dt, fused_frontend=fused_fe)
        t0 = time.perf_counter()
        caps[name], got[name] = drive(f"{name} caption", lambda: engines[name].caption(clips),
                                      expect)
        wall = time.perf_counter() - t0
        check(len(caps[name]) == len(clips) and all(isinstance(c, str) for c in caps[name]),
              f"{name} caption: {caps[name]!r}")
        print(f"  {name}: {wall * 1e3:.1f} ms for {len(clips)} captions of 99 steps, the first "
              f"{caps[name][0][:40]!r} ({label})")
    batch16, _ = engines["bf16"].audio_patch_batch(clips)
    batch32, _ = engines["fp32"].audio_patch_batch(clips)
    del engines
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    ids, steps32, flags = stepwise(cfg32, model, batch32, tok, 24, 1.0)
    _, hidden = get_audio_embedding(model, cfg32, batch32["audio_patches"],
                                    batch32["audio_time_inds"], batch32["audio_freq_inds"],
                                    batch32["audio_mask"], normalize=False)
    full = caco.caption_logits(model, cfg32, ids[:, :-1], torch.ones_like(ids[:, :-1]), hidden,
                               batch32["audio_mask"])
    live = flags.bool()
    rel = float((steps32 - full).abs().amax(-1)[live].max() / full.abs().amax(-1)[live].max())
    print(f"  fp32 stepwise decode logits vs teacher-forced caption_logits on the produced "
          f"tokens ({int(live.sum())} stream-steps): max rel {rel:.3e} (≤ {CAPTION_REL})")
    check(rel <= CAPTION_REL, f"fp32 decode logits {rel} from teacher forcing")

    graph_eager = {}
    for graph in (True, False):
        graph_eager[graph] = caco.decode(
            model, cfg16, batch16, max_length=32,
            **decoder_kw(tok, temperature=1.0, top_k=1, cuda_graph=graph,
                         generator=torch.Generator(device=DEVICE).manual_seed(0)))
    same = bool(torch.equal(graph_eager[True], graph_eager[False]))
    print(f"  bf16 top_k=1, {len(clips)} × 31 tokens: CUDA-graph step vs eager step "
          f"identical: {same}")
    check(same, "the CUDA-graph decode step and the eager one gave different tokens")

    _, steps16, _ = stepwise(cfg16, model, batch16, tok, 2, 1.0)
    cos = float(cosine_rows(steps16[:, 0].cpu().numpy(), steps32[:, 0].cpu().numpy()).min())
    print(f"  bf16 vs fp32 first-step logits: min cosine {cos:.7f} (≥ {CAPTION_COS})")
    check(cos >= CAPTION_COS, "bf16 decode logits disagree with fp32")

    for graph in (True, False):
        dec = caco.BatchDecoder(model, cfg16, batch16, max_length=DECODE_LEN,
                                **decoder_kw(tok, temperature=1.0, cuda_graph=graph,
                                             generator=torch.Generator(device=DEVICE)))
        no_sync_window(dec)
        print(f"  {caco.DECODE_WINDOW} {'graph' if graph else 'eager'} steps under "
              f"torch.cuda.set_sync_debug_mode('error'): no host sync")
    return ({"caption": got["bf16"], "caption_fp32": got["fp32"],
             "caption_fused_frontend": got["bf16_fused_frontend"]},
            {"fp32_stepwise_rel": rel, "graph_equals_eager": same, "bf16_fp32_cosine": cos,
             "captions_bf16": caps["bf16"]})


def bench_patch_batch(cfg, n, seed):
    """n 10-s buffers of 0.1·randn through the unfused frontend at 500
    patches in cfg.dtype (bench.py's decode input, made outside the timing)."""
    front = configs.FrontendConfig()
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    bufs = 0.1 * torch.randn(n, 10 * front.sample_rate, generator=g, device=DEVICE)
    lens = torch.full((n,), 10 * front.sample_rate, dtype=torch.int32, device=DEVICE)
    return wav_to_patches(bufs, lens, front, configs.PatchConfig(patches_seq_len=DECODE_PATCHES),
                          dtype=cfg.dtype)


@torch.inference_mode()
def decode_rate_phase(cfg, model, tok, label):
    """Phase 16b: decode_tokens_per_s at bench.py's shape, graph and eager."""
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    batch = bench_patch_batch(cfg16, DECODE_STREAMS, SEED)
    print(f"phase 16b: decode_tokens_per_s, bf16, {DECODE_STREAMS} streams × {DECODE_LEN}, "
          f"{DECODE_PATCHES} patches, T 1.0")

    def call(graph, trial):
        return caco.decode(model, cfg16, batch, max_length=DECODE_LEN,
                           **decoder_kw(tok, temperature=1.0, cuda_graph=graph,
                                        generator=torch.Generator(device=DEVICE)
                                        .manual_seed(trial)))

    out, got = drive(f"bf16 decode, {DECODE_STREAMS} streams", lambda: call(True, 0),
                     {"k1_layer": cfg.audio.num_layers, "k2_block": 0})
    check(out.shape == (DECODE_STREAMS, DECODE_LEN), f"decode ids {tuple(out.shape)}")
    generated, total = int(out[:, 1:].ne(0).sum()), DECODE_STREAMS * (DECODE_LEN - 1)
    # EOS is one id in 50 265: about 0.3 streams in a call end early, each
    # leaving zeros behind it; ids of 0 everywhere else mean broken logits
    check(generated >= 0.99 * total, f"decode wrote {generated} ids other than 0 of {total}")
    rates = {"graph": [], "eager": []}
    for graph in (True, False, False, True):
        call(graph, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for trial in range(DECODE_TRIALS):
            call(graph, trial + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates["graph" if graph else "eager"].append(
            DECODE_STREAMS * (DECODE_LEN - 1) * DECODE_TRIALS / wall)

    def build(graph):
        return caco.BatchDecoder(model, cfg16, batch, max_length=DECODE_LEN,
                                 **decoder_kw(tok, temperature=1.0, cuda_graph=graph,
                                              generator=torch.Generator(device=DEVICE)))

    parts, busy = {}, {}
    for graph in (True, False):
        mode = "graph" if graph else "eager"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        get_audio_embedding(model, cfg16, batch["audio_patches"], batch["audio_time_inds"],
                            batch["audio_freq_inds"], batch["audio_mask"], normalize=False)
        torch.cuda.synchronize()
        audio_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        dec = build(graph)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        dec.run()
        torch.cuda.synchronize()
        steps_ms = (time.perf_counter() - t0) * 1e3
        parts[mode] = {"audio_pass_ms": audio_ms, "build_ms": build_ms, "steps_ms": steps_ms,
                       "step_ms": steps_ms / (DECODE_LEN - 1)}
        # the profiler sees the steps of a decoder built outside it (no
        # capture under the profiler)
        dec = build(graph)
        b_ms, wall_ms, ops = device_busy_ms(dec.run, 1)
        if not graph:
            top = device_kernels(build(False).run)
            print(f"  eager steps of one call, device time by operation: " + "; ".join(
                f"{name[:60]} {ms:.2f} ms ×{n}" for name, ms, n in top))
            parts[mode]["top_device_ops"] = top
        del dec
        busy[mode] = {"device_busy_ms": b_ms, "wall_ms": wall_ms,
                      "idle_share": 1.0 - b_ms / wall_ms, "device_ops": ops}
    torch.cuda.reset_peak_memory_stats()
    call(True, 10)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for mode in ("graph", "eager"):
        p, b = parts[mode], busy[mode]
        print(f"  {mode}: decode_tokens_per_s {' / '.join(f'{r:.1f}' for r in rates[mode])} "
              f"({DECODE_TRIALS} calls a trial, one sync at the end); one call: audio pass "
              f"{p['audio_pass_ms']:.2f} ms, decoder built (audio pass, cross K/V, caches"
              f"{', capture' if mode == 'graph' else ''}) in {p['build_ms']:.2f} ms, "
              f"{DECODE_LEN - 1} steps {p['steps_ms']:.2f} ms ({p['step_ms']:.3f} ms a step); "
              f"the steps profiled: device busy {b['device_busy_ms']:.2f} of {b['wall_ms']:.2f} ms, "
              f"idle share {b['idle_share']:.3f}, {b['device_ops']:.0f} device operations "
              f"({label})")
    print(f"  peak device memory of one graph call {peak:.2f} GiB; ids other than 0 after BOS "
          f"{generated} of {total} ({label})")
    return got, {"decode_tokens_per_s": rates, "parts": parts, "busy": busy, "peak_gib": peak,
                 "nonzero_tokens": generated}


@torch.inference_mode()
def continuous_phase(cfg, model, tok, clips, label):
    """Phase 16c: continuous_tokens_per_s at bench.py's shape, and near-greedy
    fp32 captions of 8 requests on 3 slots against batch decode."""
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    batch = bench_patch_batch(cfg16, DECODE_STREAMS, SEED + 1)
    reqs = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(DECODE_STREAMS)]
    # "captions" that are the ids themselves, so the checks can read them
    ids_tok = types.SimpleNamespace(bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
                                    pad_token_id=tok.pad_token_id,
                                    batch_decode=lambda ids, **kw: [" ".join(map(str, r))
                                                                    for r in ids])
    print(f"phase 16c: continuous_tokens_per_s, bf16, {len(reqs)} requests on {CONT_SLOTS} "
          f"slots, drain_every {CONT_DRAIN}, max_length {DECODE_LEN}")

    def serve(seed):
        server = ContinuousCaptioner(cfg16, model, ids_tok, num_slots=CONT_SLOTS,
                                     max_length=DECODE_LEN, temperature=1.0, seed=seed,
                                     drain_every=CONT_DRAIN, device=DEVICE)
        return server, server.run(reqs)

    serve(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (server, caps), got = drive("continuous captioner", lambda: serve(1), {"k1_layer": None})
    wall = time.perf_counter() - t0
    check(len(caps) == len(reqs) and all(isinstance(c, str) for c in caps),
          "continuous captioner: a request got no caption")
    written = sum(sum(int(t) != 0 for t in c.split()[1:]) for c in caps)
    check(written >= 0.99 * len(reqs) * (DECODE_LEN - 1),
          f"continuous captioner wrote {written} ids other than 0")  # as in 16b
    check(got["k1_layer"] % cfg.audio.num_layers == 0, "prefill K1 launches not whole passes")
    rate = len(reqs) * (DECODE_LEN - 1) / wall
    tokens = server.tokens_generated
    print(f"  continuous_tokens_per_s {rate:.1f} ({wall * 1e3:.1f} ms; tokens actually "
          f"generated {tokens} of {len(reqs) * (DECODE_LEN - 1)}, {written} of them other than "
          f"0; prefill K1 launches "
          f"{got['k1_layer']}, {got['k1_layer'] // cfg.audio.num_layers} encoder passes) ({label})")
    del server, batch, reqs

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    engine32 = CacoEngine(cfg32, model, tokenizer=tok, device=DEVICE, batch_size=len(clips))
    batch32, n = engine32.audio_patch_batch(clips)
    length = 32
    server = ContinuousCaptioner(cfg32, model, ids_tok, num_slots=3, max_length=length,
                                 temperature=NEAR_GREEDY_T, seed=0, drain_every=8, device=DEVICE)
    cont = server.run([{k: v[i:i + 1] for k, v in batch32.items()} for i in range(n)])
    ids, logits, _ = stepwise(cfg32, model, batch32, tok, length, NEAR_GREEDY_T)
    ids = ids.cpu().numpy()
    gaps = []
    for i, cap in enumerate(cont):
        row, ref = [int(t) for t in cap.split()], ids[i].tolist()
        end = ref.index(tok.eos_token_id, 1) + 1 if tok.eos_token_id in ref[1:] else len(ref)
        diff = [t for t in range(1, end) if row[t] != ref[t]]
        if diff:
            top2 = torch.topk(logits[i, diff[0] - 1], 2).values
            gaps.append(float(top2[0] - top2[1]))
    print(f"  near-greedy fp32 (T {NEAR_GREEDY_T}), {n} requests on 3 slots vs batch decode: "
          f"{n - len(gaps)} equal; top-two logit gaps where they first differ: {gaps} "
          f"(< {NEAR_TIE_GAP})")
    check(all(g < NEAR_TIE_GAP for g in gaps),
          "continuous captions differ from batch decode away from a near tie")
    return got, {"continuous_tokens_per_s": rate, "wall_ms": wall * 1e3,
                 "tokens_generated": tokens, "nonzero_ids": written, "near_greedy_gaps": gaps,
                 "near_greedy_equal": n - len(gaps)}


def gallery_phase(label):
    """Phase 16d: GalleryIndex at 262 144 × 768 fp32 on the card against numpy."""
    rs = np.random.default_rng(SEED)
    rows = rs.standard_normal((GALLERY_ROWS, GALLERY_DIM), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    queries = rows[rs.choice(GALLERY_ROWS, GALLERY_QUERIES, replace=False)] + \
        0.05 * rs.standard_normal((GALLERY_QUERIES, GALLERY_DIM), dtype=np.float32)
    dead = rs.choice(GALLERY_ROWS, GALLERY_ROWS // 100, replace=False)
    scale = 1.7
    print(f"phase 16d: GalleryIndex, {GALLERY_ROWS} × {GALLERY_DIM} fp32 (slab {GALLERY_SLAB}), "
          f"{len(dead)} deleted, {GALLERY_QUERIES} queries, top-10")
    g = GalleryIndex(GALLERY_DIM, logit_scale=scale, slab=GALLERY_SLAB, device=DEVICE)
    part = GALLERY_ROWS // 4
    for i in range(0, GALLERY_ROWS, part):
        g.add(rows[i:i + part])
    check(g.capacity == GALLERY_ROWS and g.size == GALLERY_ROWS,
          f"gallery capacity {g.capacity}, size {g.size}")
    g.delete(dead)
    g.delete(dead[:10])  # idempotent
    check(g.num_deleted == len(dead), f"gallery counts {g.num_deleted} deleted rows")
    scores, idx, _ = g.search(queries, k=10)
    ref = np.float32(np.exp(np.float32(scale))) * queries @ rows.T
    ref[:, dead] = -np.inf
    top = np.argpartition(-ref, 10, axis=1)[:, :10]
    order = np.argsort(-np.take_along_axis(ref, top, 1), axis=1, kind="stable")
    ref_idx = np.take_along_axis(top, order, 1)
    ref_scores = np.take_along_axis(ref, ref_idx, 1)
    same = bool(np.array_equal(idx, ref_idx))
    err = float(np.abs(scores - ref_scores).max())
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.search(queries, k=10)
        ms.append((time.perf_counter() - t0) * 1e3)
    tmp = tempfile.mkdtemp(prefix="caco_smoke_gallery_")
    try:
        path = os.path.join(tmp, "gallery.npz")
        g.save(path)
        loaded = GalleryIndex.load(path, device=DEVICE)
        s2, i2, _ = loaded.search(queries, k=10)
        round_trip = bool(np.array_equal(i2, idx) and np.array_equal(s2, scores)
                          and loaded.num_deleted == g.num_deleted)
    finally:
        shutil.rmtree(tmp)
    print(f"  indices equal to numpy: {same}; max |score - numpy| {err:.2e} (≤ {GALLERY_ATOL}); "
          f"save / load round trip identical: {round_trip}; search "
          f"{' / '.join(f'{m:.2f}' for m in sorted(ms))} ms ({GALLERY_QUERIES} queries, host "
          f"copies included; {label})")
    check(same and err <= GALLERY_ATOL, "gallery search disagrees with numpy")
    check(round_trip, "gallery save / load changed the search")
    return {"indices_equal": same, "max_abs_err": err, "search_ms": sorted(ms),
            "round_trip": round_trip}


# Eval and HEAR (phase 17): the evaluation CLI and the two HEAR runners in
# process, on the card, at caco_base / audiomae_base width with random
# weights written as released-layout files.  ESC-50: 5 categories × 8 clips
# of 2-5 s at 44.1 kHz (two buckets of 32, the second ragged); Clotho: 40
# clips of 15-30 s at 16 kHz with 5 captions each; HEAR: a scene task
# (multiclass, 3 labels, 32 / 16 / 16 clips of 2-10 s) and the event task
# of tests/test_hear.py:381-436 at 10 s (6 / 4 / 4 clips).  The rates
# (phase 17c) are taken warm, after those runs in the same process: zs on
# ESC-50's own clip shape (5 s, 44.1 kHz PCM16 mono) and per-category count
# (40) in 10 of its 50 categories; the HEAR runners and the probe trainer on
# a 5-fold scene task of Beijing Opera Percussion's size (HEAR 2021: 236
# clips, 4 labels, top-1 accuracy), 5 × 48 clips of 5 s at 16 kHz.
ESC_CATEGORIES = ("dog", "rain", "siren", "crying baby", "church bells")
RATE_ESC_CATEGORIES = ESC_CATEGORIES + ("rooster", "sea waves", "clock tick", "helicopter",
                                        "chainsaw")
ESC_PER_CATEGORY, CLOTHO_CLIPS = 8, 40
RATE_ESC_PER_CATEGORY, RATE_HEAR_FOLDS, RATE_HEAR_PER_FOLD, RATE_RUNS = 40, 5, 48, 2
HEAR_SCENE_SPLITS = {"train": 32, "valid": 16, "test": 16}
HEAR_EVENT_SPLITS = {"train": 6, "valid": 4, "test": 4}
HEAR_BATCH = 8
HEAR_SCENE_SCORES = ["top1_acc", "mAP", "d_prime", "aucroc"]
# The fp32 HEAR forward on the card against the CPU's plain path: cosine of
# the scene embeddings, the serving path's fp32 bound (phase 6).
COS_HEAR = 0.9999


def write_pcm16(path, sr, x):
    from scipy.io import wavfile

    wavfile.write(path, sr, (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16))


def write_esc50(esc, rs, categories, per_category, seconds):
    """The ESC-50 layout that eval/processors.py reads: per_category clips
    at 44.1 kHz of each category, seconds() long."""
    os.makedirs(os.path.join(esc, "audio"))
    rows = [["filename", "fold", "target", "category"]]
    for c, cat in enumerate(categories):
        for k in range(per_category):
            name = f"{1 + k % 5}-{100 * c + k}-A-{c}.wav"
            write_pcm16(os.path.join(esc, "audio", name), 44100,
                        0.1 * rs.randn(int(seconds() * 44100)))
            rows.append([name, str(1 + k % 5), str(c), cat])
    with open(os.path.join(esc, "esc50.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return esc


def write_eval_data(root, rs):
    """The ESC-50 and Clotho layouts that eval/processors.py reads."""
    esc = write_esc50(os.path.join(root, "esc50"), rs, ESC_CATEGORIES, ESC_PER_CATEGORY,
                      lambda: rs.uniform(2, 5))
    clotho = os.path.join(root, "clotho")
    os.makedirs(os.path.join(clotho, "evaluation"))
    rows = [["file_name"] + [f"caption_{j}" for j in range(1, 6)]]
    for i in range(CLOTHO_CLIPS):
        name = f"clip_{i:02d}.wav"
        write_pcm16(os.path.join(clotho, "evaluation", name), 16000,
                    0.1 * rs.randn(int(rs.uniform(15, 30) * 16000)))
        rows.append([name] + [f"sound {i} of the set heard in take {j}" for j in range(5)])
    with open(os.path.join(clotho, "clotho_captions_evaluation.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return esc, clotho


def write_hear_task(tasks, task, kind, ptype, splits, scores, labels, rs, seconds,
                    duration=10.0):
    """One task in the HEAR layout (hear/runner.py): splits maps a split to
    its clip count, each clip 16 kHz and seconds() long."""
    path = os.path.join(tasks, task)
    os.makedirs(path)
    with open(os.path.join(path, "task_metadata.json"), "w") as f:
        json.dump({"task_name": task.split("-")[0], "embedding_type": kind,
                   "prediction_type": ptype, "splits": list(splits), "evaluation": scores,
                   "sample_duration": duration}, f)
    with open(os.path.join(path, "labelvocabulary.csv"), "w", newline="") as f:
        csv.writer(f).writerows([["idx", "label"]] + [[str(i), l] for i, l in enumerate(labels)])
    for split, n in splits.items():
        os.makedirs(os.path.join(path, "16000", split))
        meta = {}
        for i in range(n):
            name = f"{split}_{i:02d}.wav"
            write_pcm16(os.path.join(path, "16000", split, name), 16000,
                        0.1 * rs.randn(int(seconds() * 16000)))
            label = labels[i % len(labels)]
            meta[name] = ([label] if kind == "scene" else
                          [{"label": label, "start": 0.0, "end": 900.0},
                           {"label": label, "start": 1200.0, "end": 1800.0}])
        with open(os.path.join(path, f"{split}.json"), "w") as f:
            json.dump(meta, f)


def write_hear_tasks(root, rs):
    """A scene task and an event task in the HEAR layout (hear/runner.py)."""
    tasks = os.path.join(root, "tasks")
    write_hear_task(tasks, "scene-v1.0.0-full", "scene", "multiclass", HEAR_SCENE_SPLITS,
                    HEAR_SCENE_SCORES, ("dog", "rain", "siren"), rs, lambda: rs.uniform(2, 10))
    write_hear_task(tasks, "event-v1.0.0-full", "event", "multilabel", HEAR_EVENT_SPLITS,
                    ["segment_1s_er", "event_onset_200ms_fms"], ("beep", "hiss"), rs,
                    lambda: 10.0)
    return tasks


def numpy_retrieval(sim, n_caps):
    """R@1/5/10 and mAP@10 both ways from an (audio, text) score matrix
    whose text j describes audio j // n_caps (every caption distinct)."""
    n_audio, n_text = sim.shape
    owner = np.arange(n_text) // n_caps
    ta = np.argsort(-sim.T, axis=-1)[:, :10] == owner[:, None]
    at = owner[np.argsort(-sim, axis=-1)[:, :10]] == np.arange(n_audio)[:, None]
    out = {}
    for name, hits in (("text_to_audio", ta), ("audio_to_text", at)):
        ranks = np.arange(1, 11)
        ap = [float((np.cumsum(h)[h] / ranks[h]).mean()) if h.any() else 0.0 for h in hits]
        out[name] = {"R1": hits[:, :1].any(1).mean(), "R5": hits[:, :5].any(1).mean(),
                     "R10": hits.any(1).mean(), "mAP10": float(np.mean(ap))}
    return out


@contextlib.contextmanager
def environ(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def spy(cls, name, record):
    """Wrap cls.name so that each call appends (self, args, result) to record."""
    orig = getattr(cls, name)

    def wrapped(self, *args, **kw):
        out = orig(self, *args, **kw)
        record.append((self, args, out))
        return out

    setattr(cls, name, wrapped)
    try:
        yield record
    finally:
        setattr(cls, name, orig)


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def stage_seconds(out: str, stage: str) -> float:
    """A span's total seconds from a captured `profiling.report`."""
    line = next(l for l in out.splitlines() if l.startswith(f"{stage}: "))
    return float(line.split()[1].rstrip("s"))


def write_models(tmp):
    """caco_base and audiomae_base from seeds, as released-layout files (as
    phases 14a and 15c write them) → (caco dir, stage-1 dir)."""
    cfg = configs.caco_base()
    t0 = time.perf_counter()
    model = caco_init(cfg, torch.Generator().manual_seed(SEED + 17))
    ref = convert.caco_params_to_reference(bridge.params_to_jax(model), cfg.audio.num_heads)
    caco_dir = os.path.join(tmp, "caco")
    msgpack.save_checkpoint(caco_dir, {"0": {"params": ref}}, step=0)
    del model, ref
    mcfg = configs.audiomae_base()
    mae = audiomae_init(mcfg.encoder, mcfg.decoder, torch.Generator().manual_seed(SEED + 18))
    ref = convert.audiomae_params_to_reference(bridge.params_to_jax(mae), mcfg.encoder.num_heads,
                                               mcfg.decoder.num_heads)
    mae_dir = os.path.join(tmp, "mae")
    msgpack.save_checkpoint(mae_dir, {"0": {"params": ref}}, step=0)
    del mae, ref
    print(f"  caco_base and audiomae_base from seeds {SEED + 17} / {SEED + 18}, written as "
          f"released-layout files in {time.perf_counter() - t0:.1f} s")
    return caco_dir, mae_dir


def eval_phase(cfg, caco_dir, tok_dir, esc, clotho, tmp, label):
    """Phase 17a: `python -m cacophony_tpu_torch.eval` in process on the card."""
    n = cfg.audio.num_layers
    n_esc = len(ESC_CATEGORIES) * ESC_PER_CATEGORY
    zs_buckets = -(-n_esc // BATCH)
    ar_buckets = -(-CLOTHO_CLIPS // BATCH)
    none = {"k3_layer": 0, "k6_attn": 0, "log_mel": 0, "log_mel_fast": 0}
    base = ["--ckpt_path", caco_dir, "--tokenizer", tok_dir, "--batch_size", str(BATCH),
            "--device", DEVICE]
    zs = base + ["--task", "zs", "--dataset", "esc50"]
    clo = base + ["--dataset", "clotho"]
    launches, out = {}, {}
    with environ(CACOPHONY_ESC50_DIR=esc, CACOPHONY_CLOTHO16K_DIR=clotho):
        for dt, expect in (("float32", {"k2_block": n * zs_buckets, "k1_layer": 0, "k3_block": 0}),
                           ("bfloat16", {"k1_layer": n * zs_buckets, "k2_block": 0,
                                         "k3_block": 0})):
            path = os.path.join(tmp, f"zs_{dt}.json")
            t0 = time.perf_counter()
            (res, text), launches[f"zs_{dt}"] = drive(
                f"eval --task zs --dtype {dt}",
                lambda: echoed(eval_cli.main, zs + ["--dtype", dt, "--output_json", path]),
                {**expect, **none})
            wall = time.perf_counter() - t0
            with open(path) as f:
                saved = json.load(f)
            acc = res["esc50"]
            check(saved == {"task": "zs", "top1_accuracy": res} and 0.0 <= acc <= 1.0,
                  f"zs {dt}: results {res}, file {saved}")
            decode_embed = stage_seconds(text, "zs.decode_embed_stream")
            rate = n_esc / decode_embed
            out[f"zs_{dt}"] = {"top1": acc, "wall_s": wall, "decode_embed_s": decode_embed,
                               "clips_per_s": rate}
            print(f"  zs {dt}: top-1 {acc:.4f}; decode + embed of {n_esc} "
                  f"clips {decode_embed:.3f} s = {rate:.1f} clips/s (host decode and "
                  f"the 44.1 → 16 kHz resample included); the CLI {wall:.2f} s ({label})")
        acc = out["zs_float32"]["top1"]
        golden = os.path.join(tmp, "golden.json")
        with open(golden, "w") as f:
            json.dump({"atol": 1e-9, "expect": {"esc50": acc}}, f)
        echoed(eval_cli.main, zs + ["--expect", golden])
        with open(golden, "w") as f:
            json.dump({"atol": 0.01, "expect": {"esc50": acc + 0.5 if acc < 0.5 else acc - 0.5}}, f)
        try:
            echoed(eval_cli.main, zs + ["--expect", golden])
            exited = None
        except SystemExit as e:
            exited = e.code
        print(f"  --expect with the run's own top-1: passed; one value moved past its atol: "
              f"SystemExit({exited!r})")
        check(exited not in (None, 0), "the --expect gate did not fail on a drifted value")

        for dt, expect in (("bfloat16", {"k3_block": n * ar_buckets, "k1_layer": 0,
                                         "k2_block": 0}),
                           ("float32", {"k1_layer": 0, "k2_block": 0, "k3_block": 0})):
            scores = []
            t0 = time.perf_counter()
            with spy(CacoEngine, "score", scores):
                (res, _), launches[f"ar_{dt}"] = drive(
                    f"eval --task ar --dataset clotho --dtype {dt}"
                    + (" (the einsum route)" if dt == "float32" else ""),
                    lambda: echoed(eval_cli.main, clo + ["--task", "ar", "--dtype", dt]),
                    {**expect, **none})
            wall = time.perf_counter() - t0
            (_, (a, t), sim), = scores
            check(a.shape == (CLOTHO_CLIPS, cfg.projection_size) and sim.shape == (
                CLOTHO_CLIPS, 5 * CLOTHO_CLIPS), f"ar {dt}: shapes {a.shape}, {sim.shape}")
            check(np.allclose(sim, np.exp(cfg.logit_scale_init) * (a.astype(np.float64) @ t.T),
                              rtol=1e-4, atol=1e-4), f"ar {dt}: score is not exp(s)·A@Tᵀ")
            ref = numpy_retrieval(sim, 5)
            diff = max(abs(res[d][m]["estimate"] - ref[d][m]) for d in ref for m in ref[d])
            print(f"  ar {dt}: t→a R1 {res['text_to_audio']['R1']['estimate']:.4f}, a→t R1 "
                  f"{res['audio_to_text']['R1']['estimate']:.4f}; numpy from the engine's "
                  f"embeddings: max |Δ| {diff:.1e}; the CLI {wall:.2f} s ({label})")
            check(diff <= 1e-12, f"ar {dt}: the task's metrics disagree with numpy's")
            out[f"ar_{dt}"] = {"wall_s": wall, "numpy_max_diff": diff,
                               "t2a_R1": res["text_to_audio"]["R1"]["estimate"]}

        caps = os.path.join(tmp, "captions")
        t0 = time.perf_counter()
        ((preds, gts), _), launches["caption_bfloat16"] = drive(
            "eval --task caption --dataset clotho --dtype bfloat16",
            lambda: echoed(eval_cli.main, clo + ["--task", "caption", "--dtype", "bfloat16",
                                                 "--output_dir", caps]),
            {"k3_block": n * ar_buckets, "k1_layer": 0, "k2_block": 0, **none})
        wall = time.perf_counter() - t0
    with open(os.path.join(caps, "predictions.csv")) as f:
        pred_csv = f.read()
    with open(os.path.join(caps, "gt.csv")) as f:
        gt_lines = f.read().splitlines()
    check(len(preds) == len(gts) == CLOTHO_CLIPS and pred_csv == "file_name,caption_predicted\n"
          + "".join(f"{i},{p}\n" for i, p in enumerate(preds)),
          "predictions.csv is not the reference's format with one row per clip")
    check(gt_lines[0] == "file_name," + ",".join(f"caption_reference_{i:02d}" for i in range(1, 6))
          and len(gt_lines) == CLOTHO_CLIPS + 1, f"gt.csv: {gt_lines[:2]}, {len(gt_lines)} lines")
    print(f"  caption: {len(preds)} clips in {ar_buckets} engine buckets (max 100, T 0.1), the "
          f"first {preds[0][:40]!r}; predictions.csv / gt.csv in the reference's format; the CLI "
          f"{wall:.2f} s ({label})")
    out["caption_bfloat16"] = {"wall_s": wall}
    return launches, out


def hear_phase(cfg, caco_dir, mae_dir, root, label):
    """Phase 17b: hear.runner (caco, audiomae) and hear.predictions_runner
    in process on the card."""
    n = cfg.audio.num_layers
    tasks = write_hear_tasks(root, np.random.RandomState(SEED + 19))
    emb_root = os.path.join(root, "embeddings")
    batches = sum(-(-k // HEAR_BATCH) for s in (HEAR_SCENE_SPLITS, HEAR_EVENT_SPLITS)
                  for k in s.values())
    clips = sum(HEAR_SCENE_SPLITS.values()) + sum(HEAR_EVENT_SPLITS.values())
    launches, out = {}, {}
    for name, path in (("caco", caco_dir), ("audiomae", mae_dir)):
        t0 = time.perf_counter()
        _, launches[name] = drive(
            f"hear.runner --embedding-name {name}, {batches} batches of ≤ {HEAR_BATCH}",
            lambda: echoed(hear_runner.run, path, tasks, emb_root, embedding_name=name,
                           batch_size=HEAR_BATCH, device=DEVICE),
            {"k2_block": n * batches, "k1_layer": 0, "k3_block": 0, "k3_layer": 0})
        wall = time.perf_counter() - t0
        embed_s = sum(read_json(emb_root, name, t, "profile.embeddings.json")["time_elapsed"]
                      for t in os.listdir(tasks))
        out[name] = {"wall_s": wall, "embed_s": embed_s, "clips_per_s": clips / embed_s}
        print(f"  {name}: {clips} clips embedded in {embed_s:.2f} s = {clips / embed_s:.1f} "
              f"clips/s (host decode included; {wall:.2f} s with the model's load) ({label})")
        for task in os.listdir(tasks):
            d = os.path.join(emb_root, name, task)
            meta = read_json(d, "task_metadata.json")
            for split in meta["splits"]:
                rows, dim = read_json(d, f"{split}.embedding-dimensions.json")
                mm = np.memmap(os.path.join(d, f"{split}.embeddings.npy"), dtype=np.float32,
                               mode="r", shape=(rows, dim))
                check(dim == 768 and bool(np.isfinite(mm).all()),
                      f"{name}/{task}/{split}: dim {dim} or non-finite embeddings")
            if meta["embedding_type"] == "event":
                clip = os.path.join(d, "test", "test_00.wav")
                emb = np.load(clip + ".embedding.npy")
                ts = read_json(clip + ".timestamps.json")
                check(emb.shape == (62, 768) and np.array_equal(ts, np.linspace(0, 10000, 62)),
                      f"{name} event: {emb.shape}, timestamps {ts[:3]}…")
        print(f"  {name}: scene 768-d, event (62, 768) a clip at linspace(0, 10000, 62) ms, "
              f"all finite")

    # the card's fp32 forward against the CPU's plain path, on 2 clips
    scene = os.path.join(tasks, "scene-v1.0.0-full", "16000", "test")
    names = sorted(os.listdir(scene))[:2]
    paths = [os.path.join(scene, f) for f in names]
    cos = {}
    for name, path, load, cls in (
            ("caco", caco_dir, ckpt_io.load_caco, hear_emb.CacoHearEmbedder),
            ("audiomae", mae_dir, ckpt_io.load_audiomae, hear_emb.AudioMAEHearEmbedder)):
        mcfg, model = load(path, device="cpu")
        ref = cls(mcfg, model).scene_embeddings(paths)
        got = np.stack([np.load(os.path.join(emb_root, name, "scene-v1.0.0-full", "test",
                                             f + ".embedding.npy")) for f in names])
        cos[name] = float(cosine_rows(got, ref).min())
        if name == "caco":
            pad_err = padded_rows_check(mcfg, model, paths)
        del model
    print(f"  scene embeddings on the card vs the CPU's plain path (2 clips, min cosine): "
          f"caco {cos['caco']:.7f}, audiomae {cos['audiomae']:.7f} (≥ {COS_HEAR})")
    check(min(cos.values()) >= COS_HEAR, "HEAR embeddings on the card disagree with the CPU")

    trained = []
    t0 = time.perf_counter()
    with spy(hear_pred.MLPProbe, "train_batch", trained):
        echoed(predictions_runner.run, emb_root, grid="faster", device=DEVICE)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    devices = {str(next(probe.parameters()).device) for probe, _, _ in trained}
    print(f"  predictions_runner --grid faster: {pred_s:.2f} s for 4 task folders, "
          f"{len(trained)} probe steps, probes on {sorted(devices)} ({label})")
    check(trained and devices == {"cuda:0"}, f"the probes trained on {devices}")
    tests = {}
    for name in ("caco", "audiomae"):
        for task in sorted(os.listdir(tasks)):
            d = os.path.join(emb_root, name, task)
            check(os.path.exists(os.path.join(d, "prediction-done.json")), f"{d}: not done")
            res = read_json(d, "test.predicted-scores.json")["test"]
            meta = read_json(d, "task_metadata.json")
            check(set(res) == set(meta["evaluation"]), f"{d}: scores {sorted(res)}")
            for score, v in res.items():
                ok = (np.isfinite(v) if score == "d_prime" else
                      v >= 0.0 if score == "segment_1s_er" else 0.0 <= v <= 1.0)
                check(bool(ok), f"{name}/{task}: {score} = {v} outside its range")
            tests[f"{name}/{task.split('-')[0]}"] = res
    print(f"  test scores: {json.dumps(tests)}")
    check("sklearn" not in sys.modules, "scikit-learn was imported")
    print("  scikit-learn was never imported")
    out.update(prediction_s=pred_s, probe_steps=len(trained), cosine_cpu=cos,
               padded_rows_max_abs_err=pad_err, test_scores=tests)
    return launches, out


@torch.inference_mode()
def padded_rows_check(cfg, cpu_model, paths):
    """K2 on the first layer's real inputs at 500 patches, clips of 2-10 s
    padded to 10 s, against its plain version on the card: the padded query
    rows (which the event pool averages) included."""
    model = copy.deepcopy(cpu_model).to(DEVICE)
    emb = hear_emb.CacoHearEmbedder(cfg, model)
    batch = emb._batch(paths)
    mask = batch["audio_mask"]
    x = audio_input_embedding(model.audio, cfg.audio, batch["audio_patches"],
                              batch["audio_time_inds"], batch["audio_freq_inds"], torch.float32)
    blk, heads = model.audio.blocks[0], cfg.audio.num_heads
    got = ea.fused_block_attention(blk, x, mask, heads, LN_EPS, ("one_shot",))
    ref = ea.fused_block_attention_plain(blk, x, mask, heads, LN_EPS, ("one_shot",))
    pad = mask == 0
    check(bool(pad.any()), "no padded rows in the batch")
    atol, rtol = TOL[torch.float32]["chain"]
    return max(compare(f"K2 {part}, the {int(pad.sum())} padded rows", g[pad], r[pad], atol, rtol)
               for part, g, r in (("y", got[0], ref[0]), ("LN2 y", got[1], ref[1])))


def rate_phase(cfg, caco_dir, mae_dir, tok_dir, tmp, label):
    """Phase 17c: the zs, HEAR embedding and prediction rates, warm (after
    phases 17a and 17b in this process), RATE_RUNS runs of each in turns."""
    n = cfg.audio.num_layers
    rs = np.random.RandomState(SEED + 20)
    n_esc = len(RATE_ESC_CATEGORIES) * RATE_ESC_PER_CATEGORY
    esc = write_esc50(os.path.join(tmp, "esc50_rate"), rs, RATE_ESC_CATEGORIES,
                      RATE_ESC_PER_CATEGORY, lambda: 5.0)
    paths = sorted(os.listdir(os.path.join(esc, "audio")))[:BATCH]
    t0 = time.perf_counter()
    for f in paths:
        load_audio(os.path.join(esc, "audio", f), expected_sr=44100)
    decode_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    zs = ["--ckpt_path", caco_dir, "--tokenizer", tok_dir, "--batch_size", str(BATCH),
          "--device", DEVICE, "--task", "zs", "--dataset", "esc50"]
    buckets = -(-n_esc // BATCH)
    zs_rates = {"float32": [], "bfloat16": []}
    with environ(CACOPHONY_ESC50_DIR=esc):
        for _ in range(RATE_RUNS):
            for dt, key in (("float32", "k2_block"), ("bfloat16", "k1_layer")):
                (_, text), _ = drive(f"eval --task zs --dtype {dt}, {n_esc} clips of 5 s (rate)",
                                     lambda: echoed(eval_cli.main, zs + ["--dtype", dt]),
                                     {key: n * buckets})
                zs_rates[dt].append(n_esc / stage_seconds(text, "zs.decode_embed_stream"))

    tasks = os.path.join(tmp, "rate_tasks")
    task = "kfold-v1.0.0-full"
    folds = {f"fold{i:02d}": RATE_HEAR_PER_FOLD for i in range(RATE_HEAR_FOLDS)}
    write_hear_task(tasks, task, "scene", "multiclass", folds, ["top1_acc"],
                    ("bangu", "naobo", "daibo", "xiaoluo"), rs, lambda: 5.0, duration=5.0)
    clips = RATE_HEAR_FOLDS * RATE_HEAR_PER_FOLD
    batches = RATE_HEAR_FOLDS * -(-RATE_HEAR_PER_FOLD // HEAR_BATCH)
    embed_rates = {"caco": [], "audiomae": []}
    roots = [os.path.join(tmp, f"rate_embeddings_{r}") for r in range(RATE_RUNS)]
    for root in roots:
        for name, path in (("caco", caco_dir), ("audiomae", mae_dir)):
            drive(f"hear.runner --embedding-name {name}, {clips} clips of 5 s (rate)",
                  lambda: echoed(hear_runner.run, path, tasks, root, embedding_name=name,
                                 batch_size=HEAR_BATCH, device=DEVICE),
                  {"k2_block": n * batches})
            seconds = read_json(root, name, task, "profile.embeddings.json")["time_elapsed"]
            embed_rates[name].append(clips / seconds)
    pred_s, steps = [], []
    for root in roots:
        trained = []
        t0 = time.perf_counter()
        with spy(hear_pred.MLPProbe, "train_batch", trained):
            echoed(predictions_runner.run, root, grid="faster", device=DEVICE)
        torch.cuda.synchronize()
        pred_s.append(time.perf_counter() - t0)
        steps.append(len(trained))
        for name in embed_rates:
            res = read_json(root, name, task, "test.predicted-scores.json")
            check(res["num_folds"] == RATE_HEAR_FOLDS and 0.0 <= res["test"]["top1_acc"] <= 1.0,
                  f"rate {name}: {res['num_folds']} folds, scores {res['test']}")

    def runs(v):
        return " / ".join(f"{x:.1f}" for x in v)

    print(f"  rates, warm, {RATE_RUNS} runs in turns ({label}): zs on {n_esc} clips of 5 s at "
          f"44.1 kHz {runs(zs_rates['float32'])} clips/s fp32, {runs(zs_rates['bfloat16'])} "
          f"bf16 (the host's read and resample alone {decode_ms:.2f} ms a clip = "
          f"{1e3 / decode_ms:.1f} clips/s); HEAR on {clips} clips of 5 s at 16 kHz "
          f"{runs(embed_rates['caco'])} clips/s caco, {runs(embed_rates['audiomae'])} audiomae; "
          f"predictions_runner --grid faster over both folders ({RATE_HEAR_FOLDS} folds each) "
          f"{' / '.join(f'{x:.3f}' for x in pred_s)} s ({' / '.join(map(str, steps))} probe "
          f"steps)")
    return {"zs_clips_per_s": zs_rates, "host_decode_ms_per_clip": decode_ms,
            "hear_clips_per_s": embed_rates, "prediction_s": pred_s, "probe_steps": steps}


def eval_hear_phase(label):
    """Phase 17: the eval CLI and the HEAR runners; the temporary directory
    (models, data, outputs) is removed at its end."""
    cfg = configs.caco_base()
    print("phase 17: eval and HEAR at caco_base / audiomae_base width, in process, on the card")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="caco_smoke_eval_")
    try:
        caco_dir, mae_dir = write_models(tmp)
        tok_dir = os.path.join(tmp, "tok")
        os.makedirs(tok_dir)
        with open(os.path.join(tok_dir, "vocab.json"), "w") as f:
            json.dump(byte_vocab(), f)
        with open(os.path.join(tok_dir, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
        esc, clotho = write_eval_data(tmp, np.random.RandomState(SEED + 17))
        eval_launches, eval_out = eval_phase(cfg, caco_dir, tok_dir, esc, clotho, tmp, label)
        hear_launches, hear_out = hear_phase(cfg, caco_dir, mae_dir, tmp, label)
        rates = rate_phase(cfg, caco_dir, mae_dir, tok_dir, tmp, label)
    finally:
        shutil.rmtree(tmp)
    wall = time.perf_counter() - t0
    print(f"  phase 17 took {wall:.1f} s ({label})")
    return eval_launches, hear_launches, {"eval": eval_out, "hear": hear_out, "rates": rates,
                                          "wall_s": wall}


# Phase 18: the modules ported last.  The HF RoBERTa files are
# written at roberta-base width (12 × 768, 12 heads, MLP 3072, 50 265 words,
# 514 positions: the text tower caco_base imports); the mesh is one rank on
# NCCL (the card's machine has one card, and NCCL takes one rank a card).
HF_SEED = SEED + 18
DP_STEPS, DP_TIMED = 3, 7
RESAMPLE = ((44_100, 5, 32), (48_000, 10, 16))  # source rate, seconds, clips
RESAMPLE_ATOL = 1e-5
SAFETENSORS_DTYPE = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}


def roberta_tree(cfg, rs):
    """A FlaxRobertaModel tree at cfg's widths, seeded (numpy fp32)."""
    d, inter = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return rs.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def ln():
        return {"scale": 1 + normal(d), "bias": normal(d)}

    def layer():
        return {"attention": {"self": {"query": dense(d, d), "key": dense(d, d),
                                       "value": dense(d, d)},
                              "output": {"dense": dense(d, d), "LayerNorm": ln()}},
                "intermediate": {"dense": dense(d, inter)},
                "output": {"dense": dense(inter, d), "LayerNorm": ln()}}

    return {"embeddings": {"word_embeddings": {"embedding": normal(cfg.vocab_size, d)},
                           "position_embeddings": {"embedding": normal(cfg.max_position_embeddings, d)},
                           "token_type_embeddings": {"embedding": normal(cfg.type_vocab_size, d)},
                           "LayerNorm": ln()},
            "encoder": {"layer": {str(i): layer() for i in range(cfg.num_layers)}},
            "pooler": {"dense": dense(d, d)}}


def roberta_state_dict(tree, prefix="roberta."):
    """The tree in the torch layout: `(out, in)` Linear weights, LayerNorm
    weight / bias, `*_embeddings.weight`, a position_ids buffer."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            parent = path[-1]
            leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(k, k)
            t = torch.from_numpy(np.ascontiguousarray(v.T if k == "kernel" else v))
            out[prefix + ".".join(path + [leaf])] = t
        return out

    walk(tree, [])
    out[prefix + "embeddings.position_ids"] = torch.arange(
        tree["embeddings"]["position_embeddings"]["embedding"].shape[0])[None]
    return out


def write_safetensors(path, tensors):
    """The safetensors layout: an 8-byte little-endian header length, a JSON
    header (dtype, shape, data_offsets), then the tensors' bytes."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    tensors = {k: t.contiguous() for k, t in tensors.items() if t.dtype in SAFETENSORS_DTYPE}
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": SAFETENSORS_DTYPE[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.view(-1).view(torch.uint8).numpy().data)


def write_hf_dirs(root, cfg, tree):
    """One directory per format, each with a config.json; → {format: dir}."""
    config = {"model_type": "roberta", "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
              "max_position_embeddings": cfg.max_position_embeddings,
              "type_vocab_size": cfg.type_vocab_size}
    dirs = {}
    for fmt in hf.FORMATS:
        d = os.path.join(root, fmt.split(".")[0])
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        path = os.path.join(d, fmt)
        if fmt == "flax_model.msgpack":
            with open(path, "wb") as f:
                msgpack.dump(tree, f)
        elif fmt == "model.safetensors":
            write_safetensors(path, roberta_state_dict(tree, prefix=""))
        else:
            torch.save(roberta_state_dict(tree), path)
        dirs[fmt] = d
    return dirs


def tower_equals(text, source) -> bool:
    """model.text's embeddings and blocks == the imported tree, bit for bit."""
    params = dict(text.named_parameters())
    return all(torch.equal(params[k].detach().cpu(), torch.from_numpy(np.asarray(v)))
               for k, v in source.items())


def hf_phase(cfg, label, tmp, data, tok):
    """Phase 18a: the three HF formats at roberta-base width onto the card,
    then `runner --init-text-from-hf` for 2 bf16 steps."""
    n = cfg.audio.num_layers
    print(f"phase 18a: HF RoBERTa import at roberta-base width ({cfg.text.num_layers} × "
          f"{cfg.text.hidden_size}, {cfg.text.num_heads} heads, MLP {cfg.text.intermediate_size}, "
          f"{cfg.text.vocab_size} words, {cfg.text.max_position_embeddings} positions)")
    tree = roberta_tree(cfg.text, np.random.default_rng(HF_SEED))
    source = bridge.jax_state_dict(convert.convert_hf_roberta(tree))
    count = sum(int(np.prod(v.shape)) for k, v in bridge.jax_state_dict(tree).items())
    t0 = time.perf_counter()
    dirs = write_hf_dirs(tmp, cfg.text, tree)
    sizes = {fmt: os.path.getsize(os.path.join(d, fmt)) for fmt, d in dirs.items()}
    print(f"  {count} parameters ({count / 1e6:.1f} M with the HF pooler); written in "
          f"{time.perf_counter() - t0:.1f} s: {sizes} bytes")
    model = caco_init(cfg, torch.Generator().manual_seed(HF_SEED)).to(DEVICE)
    pooler = {k: v.clone() for k, v in model.text.pooler.state_dict().items()}
    load_s, equal = {}, {}
    for fmt, d in dirs.items():
        with torch.no_grad():
            for k, p in model.text.named_parameters():
                if k.startswith(("embeddings.", "blocks.")):
                    p.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hf.load_hf_text_tower(model, d)
        torch.cuda.synchronize()
        load_s[fmt] = time.perf_counter() - t0
        equal[fmt] = tower_equals(model.text, source)
    pooler_kept = all(torch.equal(model.text.pooler.state_dict()[k], v) for k, v in pooler.items())
    print(f"  load onto the card (s): {load_s}; each equals the source bit for bit: {equal}; "
          f"the text pooler kept: {pooler_kept} ({label})")
    check(all(equal.values()), f"an HF format did not load the source bit for bit: {equal}")
    check(pooler_kept, "the HF import changed the text pooler")
    del model
    for fmt in ("model.safetensors", "pytorch_model.bin"):
        shutil.rmtree(dirs[fmt])
    work = os.path.join(tmp, "work")
    argv = ["--stage", "caco", "--data-dir", data, "--workdir", work, "--tokenizer", tok,
            "--batch-size", str(TRAIN_BATCH), "--buffer-seconds", "10", "--patches-seq-len", "500",
            "--steps", "2", "--total-steps", "5", "--warmup-steps", "1", "--checkpoint-every", "1",
            "--log-every", "1", "--dtype", "bfloat16", "--device", DEVICE,
            "--init-text-from-hf", dirs["flax_model.msgpack"]]
    (state, _), got = drive("runner --init-text-from-hf, 2 steps", lambda: run_main(argv),
                            {"k4": 2 * n, "k7": 2 * n, "k5": 0, **NO_SERVING_KERNELS})
    check(state.step == 2, f"the runner ended at step {state.step}")
    del state
    saved = torch.load(os.path.join(work, "checkpoints", "step_00000001", ckpt_io.TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True, mmap=True)["params"]
    after_1 = all(torch.equal(saved[f"text.{k}"], torch.from_numpy(np.asarray(v)))
                  for k, v in source.items())
    print(f"  after step 1 (rate 0 at step 0) the text tower equals the import: {after_1}")
    check(after_1, "the runner's text tower after step 1 is not the HF import")
    shutil.rmtree(work)
    return got, {"parameters": count, "file_bytes": sizes, "load_s": load_s,
                 "bit_equal": equal, "after_step_1_equal": after_1}


def step_profile(fn):
    """fn once under torch.profiler (device activity) → (device busy ms: the
    union of its device intervals; device operations; the device ms of its
    NCCL kernels; their count)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    nccl = [e.time_range for e in events if "nccl" in e.name.lower()]
    return busy / 1e3, len(events), sum(r.end - r.start for r in nccl) / 1e3, len(nccl)


def dp_runs(cfg, tc, model, init, batch, mesh, expect):
    """DP_STEPS steps from `init` without the mesh, with it (its launches
    checked against `expect`), and without it again; → the three runs'
    (losses, parameters) and the mesh run's launches."""

    def run(m):
        model.load_state_dict(init)
        state = train.init_train_state(model, tc)
        step = train.make_caco_train_step(cfg, tc, mesh=m)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        losses = []
        for _ in range(DP_STEPS):
            state, met = step(state, batch, gen)
            losses.append(float(met["loss"]))
        return losses, {k: v.clone() for k, v in model.state_dict().items()}

    ref = run(None)
    got, counts = drive(f"{_dt_name(cfg.dtype)} dp step at world 1 x{DP_STEPS}",
                        lambda: run(mesh), expect)
    return ref, got, run(None), counts


def max_diff(a, b) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def dp_step_phase(cfg, rs, mesh, label):
    """Phase 18b: the stage-2 step under a one-rank mesh against the step
    without one, from the same parameters and generator.  bf16's K7 sums dQ
    with float atomics, so its step does not repeat itself bit for bit:
    there the losses before the first update (the rate is 0 at step 0) are
    held bit for bit, the gradient sum at world 1 is held to be a copy, and
    the parameters are reported against the spread of two runs without the
    mesh.  fp32 (no K7 at 500 patches) is held bit for bit where its step
    repeats itself."""
    n = cfg.audio.num_layers
    tc = train.TrainConfig(warmup_steps=1, total_steps=100)
    print(f"phase 18b: the dp step at world 1 (NCCL), caco_base, B={TRAIN_BATCH}, 500 patches, "
          f"{TEXT_LEN} tokens, {DP_STEPS} steps from one init, without / with / without the mesh")
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).to(DEVICE)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(cfg, rs, TRAIN_BATCH, 10, 500)
    out = {}
    for dtype, expect in ((torch.bfloat16, {"k4": n * DP_STEPS, "k7": n * DP_STEPS}),
                          (torch.float32, {"k4": n * DP_STEPS, "k7": 0})):
        c = dataclasses.replace(cfg, dtype=dtype)
        ref, got, ref2, counts = dp_runs(c, tc, model, init, batch, mesh,
                                         {**expect, "k5": 0, **NO_SERVING_KERNELS})
        repeat = ref[0] == ref2[0] and max_diff(ref[1], ref2[1]) == 0.0
        bit = ref[0] == got[0] and max_diff(ref[1], got[1]) == 0.0
        name = _dt_name(dtype)
        print(f"  {name}: losses without / with / without {ref[0]} / {got[0]} / {ref2[0]}; "
              f"max |Δθ| with vs without {max_diff(got[1], ref[1]):.3e}, without vs without "
              f"{max_diff(ref2[1], ref[1]):.3e}; the step repeats itself bit for bit: {repeat}; "
              f"with the mesh bit-identical: {bit}")
        check(got[0][:2] == ref[0][:2], f"{name}: the dp step's losses before the first update "
                                        "differ from the step without a mesh")
        if repeat:
            check(bit, f"{name}: the dp step at world 1 differs from the step without a mesh")
        out[name] = {"losses": {"none": ref[0], "mesh": got[0], "none_again": ref2[0]},
                     "max_abs_diff_mesh": max_diff(got[1], ref[1]),
                     "max_abs_diff_repeat": max_diff(ref2[1], ref[1]),
                     "repeatable": repeat, "bit_identical": bit}
        if dtype == torch.bfloat16:
            launches_ = counts
        del ref, got, ref2
    # the gradient sum at world 1 is a copy: one bf16 backward's gradients
    # through the step's coalesced all-reduce
    c = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model.load_state_dict(init)
    for p in model.parameters():
        p.grad = None
    loss, _ = train.make_caco_loss(c, tc)(model, batch, torch.Generator(device=DEVICE).manual_seed(SEED))
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    coalesced(grads, lambda flat: dist.all_reduce(flat, group=mesh.get_group("dp")))
    copy = all(torch.equal(g, p.grad) for g, p in zip(grads, model.parameters()))
    print(f"  the coalesced gradient all-reduce at world 1 leaves {len(grads)} gradients bit for "
          f"bit: {copy}")
    check(copy, "the one-rank gradient all-reduce is not a copy")
    out["all_reduce_is_copy"] = copy
    del grads, loss
    model.load_state_dict(init)
    del init
    state = train.init_train_state(model, tc)
    steps = {"none": train.make_caco_train_step(c, tc), "mesh": train.make_caco_train_step(
        c, tc, mesh=mesh)}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    ms = {"none": [], "mesh": []}
    for i in range(DP_TIMED + 1):
        for k in (("none", "mesh") if i % 2 else ("mesh", "none")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = steps[k](state, batch, gen)
            float(met["loss"])
            torch.cuda.synchronize()
            if i:  # the first round warms up
                ms[k].append((time.perf_counter() - t0) * 1e3)

    def one_step(k):
        nonlocal state
        state, met = steps[k](state, batch, gen)
        float(met["loss"])

    prof = {k: step_profile(lambda: one_step(k)) for k in ("none", "mesh")}
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"  bf16 step ms, {DP_TIMED} each in turns: without a mesh {sorted(ms['none'])} (median "
          f"{med['none']:.2f}), with it {sorted(ms['mesh'])} (median {med['mesh']:.2f}); device "
          f"busy a step without / with {prof['none'][0]:.2f} / {prof['mesh'][0]:.2f} ms "
          f"({prof['none'][1]} / {prof['mesh'][1]} device operations); the gradient "
          f"all-reduce's NCCL kernels {prof['mesh'][2]:.3f} ms ({prof['mesh'][3]} kernels) ({label})")
    del state, model
    return launches_, dict(out, step_ms=ms, median_step_ms=med,
                           device_busy_ms={k: v[0] for k, v in prof.items()},
                           device_ops={k: v[1] for k, v in prof.items()},
                           nccl_device_ms=prof["mesh"][2], nccl_kernels=prof["mesh"][3])


def dp_engine_phase(cfg, tok, wavs, a_emb, mesh, label):
    """Phase 18c: the bf16 10-s engine with a one-rank mesh against the
    engine without one, on phase 5's clips and weights."""
    n_buckets = -(-len(wavs) // BATCH)
    print(f"phase 18c: bf16 10-s CacoEngine with a one-rank mesh, {len(wavs)} clips")
    model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    engine = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                        dtype=torch.bfloat16)
    engine_dp = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                           dtype=torch.bfloat16, mesh=mesh)
    ref = engine.embed_audio(wavs)
    got, counts = drive("bf16 10-s embed_audio, one-rank mesh", lambda: engine_dp.embed_audio(wavs),
                        {"k1_layer": cfg.audio.num_layers * n_buckets, "k2_block": 0,
                         "k3_block": 0, "log_mel": 0, **dict.fromkeys(K1_PARTS)})
    bit, phase5 = bool(np.array_equal(got, ref)), bool(np.array_equal(got, a_emb))
    print(f"  bit-identical to the engine without a mesh: {bit} (to phase 5's: {phase5})")
    check(bit, "the engine under a one-rank mesh differs from the engine without one")
    bench = [(0.1 * np.random.RandomState(SEED + 18).randn(10 * 16000)).astype(np.float32)
             for _ in range(4 * BATCH)]
    rates = {"none": [], "mesh": []}
    for k in ("none", "mesh", "mesh", "none"):
        rates[k] += clips_per_s(engine if k == "none" else engine_dp, bench, runs=1)
    print(f"  embed_audio clips/s without / with the mesh: {rates['none']} / {rates['mesh']} "
          f"(10-s clips, bf16, batch {BATCH}, {len(bench)} clips a run; {label})")
    patch = engine.patch
    del engine, engine_dp, model
    return counts, {"bit_identical": bit, "equal_to_phase_5": phase5, "clips_per_s": rates,
                    "patches_seq_len": patch.patches_seq_len}


def dp_gallery_phase(mesh, label):
    """Phase 18d: phase 16d's gallery with a one-rank mesh against one without."""
    rs = np.random.default_rng(SEED)
    rows = rs.standard_normal((GALLERY_ROWS, GALLERY_DIM), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    queries = rows[rs.choice(GALLERY_ROWS, GALLERY_QUERIES, replace=False)] + \
        0.05 * rs.standard_normal((GALLERY_QUERIES, GALLERY_DIM), dtype=np.float32)
    dead = rs.choice(GALLERY_ROWS, GALLERY_ROWS // 100, replace=False)
    print(f"phase 18d: GalleryIndex with a one-rank mesh, {GALLERY_ROWS} × {GALLERY_DIM}, "
          f"{len(dead)} deleted, {GALLERY_QUERIES} queries, top-10")
    galleries = {}
    for k, m in (("none", None), ("mesh", mesh)):
        g = GalleryIndex(GALLERY_DIM, logit_scale=1.7, slab=GALLERY_SLAB, device=DEVICE, mesh=m)
        part = GALLERY_ROWS // 4
        for i in range(0, GALLERY_ROWS, part):
            g.add(rows[i:i + part])
        g.delete(dead)
        galleries[k] = g
    a, b = galleries["none"].search(queries, k=10), galleries["mesh"].search(queries, k=10)
    same = bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
                and galleries["mesh"].num_deleted == len(dead))
    ms = {"none": [], "mesh": []}
    for k in ("none", "mesh") * 3 + ("mesh", "none") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        galleries[k].search(queries, k=10)
        ms[k].append((time.perf_counter() - t0) * 1e3)
    print(f"  search equal to the gallery without a mesh: {same}; ms without / with the mesh "
          f"{sorted(ms['none'])} / {sorted(ms['mesh'])} ({label})")
    check(same, "the gallery under a one-rank mesh searches differently")
    return {"equal": same, "search_ms": ms}


def resample_phase(label):
    """Phase 18e: resample_fft on the card against resample_fft_host."""
    print("phase 18e: resample_fft (torch.fft on the card) vs resample_fft_host (numpy)")
    rs = np.random.RandomState(SEED + 18)
    out = {}
    for rate, seconds, clips in RESAMPLE:
        x = rs.randn(clips, rate * seconds).astype(np.float32)
        n_out = 16_000 * seconds
        dev = torch.from_numpy(x).to(DEVICE)
        got = dsp.resample_fft(dev, n_out).cpu().numpy()
        t0 = time.perf_counter()
        ref = np.stack([dsp.resample_fft_host(c, n_out) for c in x])
        host_ms = (time.perf_counter() - t0) * 1e3 / clips
        err = float(np.abs(got - ref).max())
        card_ms = cuda_ms(lambda: dsp.resample_fft(dev, n_out), 10) / clips
        print(f"  {clips} clips of {seconds} s at {rate} Hz → 16 kHz: max |card − host| {err:.2e} "
              f"(≤ {RESAMPLE_ATOL}); {card_ms:.4f} ms a clip on the card (batched), {host_ms:.3f} "
              f"ms on the host ({label})")
        check(got.shape == ref.shape and err <= RESAMPLE_ATOL,
              f"resample_fft at {rate} Hz disagrees with the host: {err}")
        out[f"{rate}_{seconds}s"] = {"max_abs_err": err, "card_ms_per_clip": card_ms,
                                     "host_ms_per_clip": host_ms}
    return out


def mfu_phase(cfg, patches_seq_len, clips_per_s_bf16, train_step_ms, label):
    """Phase 18f: mfu and train_mfu from this run's rates (utils/flops.py)."""
    name = torch.cuda.get_device_name(0)
    peak = flops.device_peak_flops(name)
    key = next((k for k in flops.BF16_PEAK_FLOPS if k in name.lower()), None)
    check(peak is not None, f"no bf16 peak for {name}")
    front = configs.FrontendConfig()
    per_clip = flops.pipeline_matmul_flops(cfg, front, configs.PatchConfig(
        patches_seq_len=patches_seq_len), 10 * front.sample_rate)
    per_sample = flops.caco_train_step_matmul_flops(cfg, 500, TEXT_LEN)
    mfu = per_clip * clips_per_s_bf16 / peak
    train_mfu = TRAIN_BATCH * per_sample / (train_step_ms / 1e3) / peak
    print(f"phase 18f: mfu {mfu:.4f} ({per_clip:.4e} matmul FLOP a 10-s clip × "
          f"{clips_per_s_bf16:.1f} clips/s); train_mfu {train_mfu:.4f} ({TRAIN_BATCH} × "
          f"{per_sample:.4e} FLOP a step / {train_step_ms:.2f} ms, phase 10's median); peak "
          f"{key!r} = {peak:.4g} FLOP/s ({label})")
    return {"mfu": mfu, "train_mfu": train_mfu, "flop_per_clip": per_clip,
            "flop_per_sample": per_sample, "peak_key": key, "peak_flops": peak}


def parallel_phase(cfg, tok, wavs, a_emb, train_step_ms, label):
    """Phase 18: the HF import and runner, the dp step, engine and gallery
    under a one-rank NCCL mesh, resample_fft, the MFU readings.  The mesh's
    process group and the temporary directory are removed at the end."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="caco_smoke_parallel_")
    try:
        data, tok_dir = write_runner_data(tmp, np.random.RandomState(SEED + 18))
        hf_launches, hf_out = hf_phase(cfg, label, tmp, data, tok_dir)
    finally:
        shutil.rmtree(tmp)
    mesh = make_mesh(dp=1, device=DEVICE)
    try:
        check(dist.get_backend() == "nccl", f"the mesh's backend is {dist.get_backend()}")
        step_launches, step = dp_step_phase(cfg, np.random.RandomState(SEED + 18), mesh, label)
        engine_launches, engine = dp_engine_phase(cfg, tok, wavs, a_emb, mesh, label)
        gallery = dp_gallery_phase(mesh, label)
    finally:
        dist.destroy_process_group()
    resample = resample_phase(label)
    mfu = mfu_phase(cfg, engine["patches_seq_len"], float(np.median(engine["clips_per_s"]["none"])),
                    train_step_ms, label)
    wall = time.perf_counter() - t0
    print(f"  phase 18 took {wall:.1f} s ({label})")
    launches_ = {"hf_runner": hf_launches, "dp_step": step_launches, "dp_engine": engine_launches}
    return launches_, {"hf": hf_out, "dp_step": step, "dp_engine": engine, "dp_gallery": gallery,
                       "resample": resample, "mfu": mfu, "wall_s": wall}


# Phase 19: tensor parallelism on the one card.  NCCL takes one rank a
# device, so two ranks share the card over a gloo group on CUDA tensors at
# (dp, tp) = (1, 2); rank 0 also runs the one-process step, alone, from the
# same initial parameters and generators.  bf16 tolerances against the
# one-process step: the losses 1e-2 and grad_norm 2e-2 relative (the bounds
# tests/test_torch_train_step.py holds bf16 to: a row-parallel layer rounds
# each rank's partial product to bf16 before the bf16 sum, where one process
# rounds once, a few bf16 steps of 2^-8 a layer), and no parameter further
# than two Adam steps of opposite signs, 4·lr·1.05 (an Adam step moves an
# element by about lr whatever its gradient; bf16's K7 sums dQ with float
# atomics, so not even the one-process step repeats itself bit for bit).
# fp32: losses and grad_norm 1e-5 relative, parameters 1e-5 relative in L2.
TP, TP_STEPS, TP_LR = 2, 3, 1e-4
TP_TOL = {torch.float32: {"loss": 1e-5, "grad_norm": 1e-5, "params_rel_l2": 1e-5},
          torch.bfloat16: {"loss": 1e-2, "grad_norm": 2e-2, "params_max": 4 * TP_LR * 1.05}}
TP_TIMEOUT_S = 600


def collectives_probe(rank: int) -> dict:
    """Which collectives this process group takes on CUDA tensors (fp32 and
    bf16), each checked for its result: → {name: "ok" or the error}."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((6,), rank + 1.0, device=DEVICE, dtype=dt)
        cases = {
            "all_reduce_sum": (lambda: dist.all_reduce(y := x.clone()) or y, 3.0),
            "all_reduce_max": (lambda: dist.all_reduce(y := x.clone(), op=dist.ReduceOp.MAX) or y, 2.0),
            "broadcast": (lambda: dist.broadcast(y := x.clone(), src=1) or y, 2.0),
            "all_gather": (lambda: (dist.all_gather(ys := [torch.empty_like(x) for _ in range(TP)], x)
                                    or torch.cat(ys)), None),
            "all_gather_into_tensor": (lambda: dist.all_gather_into_tensor(
                y := x.new_empty(TP * 6), x) or y, None),
            "reduce_scatter_tensor": (lambda: dist.reduce_scatter_tensor(
                y := x.new_empty(6), x.repeat(TP)) or y, 3.0),
        }
        for name, (fn, want) in cases.items():
            try:
                got = fn().float().cpu()
                ref = (torch.full_like(got, want) if want is not None
                       else torch.cat([torch.full((6,), r + 1.0) for r in range(TP)]))
                out[f"{name} {_dt_name(dt)}"] = "ok" if torch.equal(got, ref) else f"wrong {got.tolist()}"
            except Exception as e:  # noqa: BLE001 — the probe reports what the backend refuses
                out[f"{name} {_dt_name(dt)}"] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    return out


def replicated_equal(model) -> bool:
    """Every leaf tp does not shard is bit-identical on both ranks (rank
    0's values broadcast into copies on every rank and compared there)."""
    layout = model.tp_layout
    mine = [p.detach() for n, p in model.named_parameters() if n not in layout]
    theirs = [t.clone() for t in mine]
    coalesced(theirs, lambda flat: dist.broadcast(flat, src=0))
    ok = torch.tensor([float(all(torch.equal(a, b) for a, b in zip(mine, theirs)))], device=DEVICE)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def tp_steps(step, state, batch, n: int, first: int = 0):
    """n steps, step i drawing from a generator seeded SEED + i, each timed
    on the host clock between synchronisations → (state, metrics, ms)."""
    metrics, ms = [], []
    for i in range(first, first + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, torch.Generator(device=DEVICE).manual_seed(SEED + i))
        metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, metrics, ms


def params_diff(got: dict, ref: dict) -> dict:
    num = sum(float((got[k].double() - ref[k].double()).square().sum()) for k in ref)
    den = sum(float(ref[k].double().square().sum()) for k in ref)
    return {"rel_l2": (num / den) ** 0.5, "max_abs": max_diff(got, ref)}


def tp_run(make_step, cfg, model, init, batch, mesh, n, rank, reference, first=0):
    """n steps of `make_step(cfg, tc, mesh)` from `init` at tp 2 (both
    ranks: launches, memory, replicated leaves after the steps), then on
    rank 0 the same steps without a mesh on `reference` → a summary."""
    tc = train.TrainConfig(learning_rate=TP_LR, warmup_steps=1, total_steps=100)
    model.load_state_dict(init)
    shard_params(model, mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, metrics, ms = tp_steps(make_step(cfg, tc, mesh), train.init_train_state(model, tc),
                                  batch, n, first)
    out = {"launches": launches(), "metrics": metrics, "ms": ms,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
           "param_gib": sum(p.numel() * 4 for p in model.parameters()) / 2 ** 30,
           "replicated_equal": replicated_equal(model)}
    del state
    gather_params(model, mesh)
    if rank == 0:
        reference.load_state_dict(init)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, ref_metrics, ref_ms = tp_steps(make_step(cfg, tc), train.init_train_state(
            reference, tc), batch, n, first)
        del state
        out.update(ref_metrics=ref_metrics, ref_ms=ref_ms,
                   ref_peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                   params=params_diff(model.state_dict(), reference.state_dict()))
    dist.barrier()
    return out


def tp_rank(rank: int, tmp: str, backend: str):
    """One rank of phase 19 (a process of its own, spawned): every run's
    summary to tmp/tp_rank{rank}.pt.  gloo: both ranks on card 0; nccl:
    rank r on card r."""
    import datetime

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern.load_library()  # built by the parent before the spawn
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=TP, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    out = {"collectives": collectives_probe(rank)}
    try:
        mesh = make_mesh(dp=1, tp=TP, device=DEVICE)
        out["mesh"] = (tuple(mesh.shape), dist.get_backend())
        data = torch.load(os.path.join(tmp, "batches.pt"))
        on = lambda b: {k: v.to(DEVICE) for k, v in b.items()}  # noqa: E731
        base = configs.caco_base()
        model = caco_init(base, torch.Generator().manual_seed(SEED)).to(DEVICE)
        init = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        reference = caco_init(base, torch.Generator()).to(DEVICE) if rank == 0 else None
        batch = on(data["caco"])
        for name, dtype, dropout in (("bf16", torch.bfloat16, False), ("fp32", torch.float32, False),
                                     ("bf16_dropout", torch.bfloat16, True),
                                     ("fp32_dropout", torch.float32, True)):
            cfg = dataclasses.replace(base if dropout else no_text_dropout(base), dtype=dtype)
            out[name] = tp_run(train.make_caco_train_step, cfg, model, init, batch, mesh, TP_STEPS,
                               rank, reference)
        out["resume"] = tp_resume(no_text_dropout(base), model, init, batch, mesh, rank, reference,
                                  tmp)
        cfg30 = dataclasses.replace(base, dtype=torch.bfloat16)
        out["bf16_30s"] = tp_run(train.make_caco_train_step, cfg30, model, init, on(data["caco30"]),
                                 mesh, 2, rank, reference)
        del model, reference, init
        mae_cfg = configs.audiomae_base()
        mae = audiomae_init(mae_cfg.encoder, mae_cfg.decoder,
                            torch.Generator().manual_seed(SEED)).to(DEVICE)
        mae_init = {k: v.to("cpu", copy=True) for k, v in mae.state_dict().items()}
        mae_ref = (audiomae_init(mae_cfg.encoder, mae_cfg.decoder, torch.Generator()).to(DEVICE)
                   if rank == 0 else None)
        out["mae_fp32"] = tp_run(train.make_mae_train_step, mae_cfg, mae, mae_init, on(data["mae"]),
                                 mesh, TP_STEPS, rank, mae_ref)
    finally:
        torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))
        dist.destroy_process_group()


def tp_resume(cfg, model, init, batch, mesh, rank, reference, tmp):
    """19e: TP_STEPS fp32 steps at tp 2, the train state saved (whole
    leaves, rank 0 writes), one more step; one process resumes the file and
    takes the same step → its loss and parameters against tp's."""
    tc = train.TrainConfig(learning_rate=TP_LR, warmup_steps=1, total_steps=100)
    model.load_state_dict(init)
    shard_params(model, mesh)
    step = train.make_caco_train_step(cfg, tc, mesh)
    state, _, _ = tp_steps(step, train.init_train_state(model, tc), batch, TP_STEPS)
    ck = os.path.join(tmp, "checkpoints")
    t0 = time.perf_counter()
    path = ckpt_io.save_train_state(state, ck, mesh=mesh)
    write_s = time.perf_counter() - t0
    state, after, _ = tp_steps(step, state, batch, 1, TP_STEPS)
    del state
    gather_params(model, mesh)
    out = {"tp_loss": after[0]["loss"], "write_s": write_s,
           "file_bytes": os.path.getsize(os.path.join(path, ckpt_io.TRAIN_STATE_FILE))}
    if rank == 0:
        like = train.init_train_state(reference, tc)
        resumed = ckpt_io.load_train_state(ck, like)
        names = [n for n, _ in reference.named_parameters()]
        saved = torch.load(os.path.join(path, ckpt_io.TRAIN_STATE_FILE), map_location="cpu")
        whole = all(tuple(saved["params"][n].shape) == tuple(p.shape)
                    for n, p in reference.named_parameters())
        state, one, _ = tp_steps(train.make_caco_train_step(cfg, tc), resumed, batch, 1, TP_STEPS)
        del state, saved
        out.update(one_loss=one[0]["loss"], whole_leaves=whole and resumed.step == TP_STEPS,
                   names=len(names), params=params_diff(model.state_dict(), reference.state_dict()))
    dist.barrier()
    return out


@torch.inference_mode()
def tp_kernel_checks():
    """K4, K7 and K5 at the shapes a rank gives them under tp 2: 4 of the 8
    heads of Dh 96, against their plain versions."""
    gen = torch.Generator().manual_seed(SEED + 19)
    heads, width = H // TP, D // TP
    errs = {}

    def inputs(b, s, w, dt, lengths):
        x = (1.5 * torch.randn(b, s, w, generator=gen)).to(DEVICE, dt)
        return x, (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to(DEVICE, torch.int32)

    lengths = ([500, 400, 300, 500, 100, 250, 0, 17] * 2)[:TRAIN_BATCH]
    for dt in (torch.bfloat16, torch.float32):
        qkv, mask = inputs(TRAIN_BATCH, 500, 3 * width, dt, lengths)
        errs["K4"] = max(errs.get("K4", 0.0), compare(
            f"K4 {_dt_name(dt)} B={TRAIN_BATCH} S=500 H={heads} (tp 2)",
            kern.attention_k4(qkv, mask, heads),
            kern.attention_plain(qkv, mask, heads), *TOL[dt]["kernel"]))
    qkv, mask = inputs(TRAIN_BATCH, 500, 3 * width, torch.bfloat16, lengths)
    g = torch.randn(TRAIN_BATCH, 500, width, generator=gen).to(DEVICE, torch.bfloat16)
    errs["K7"] = compare(f"K7 bf16 B={TRAIN_BATCH} S=500 H={heads} (tp 2)",
                         kern.attention_bwd(qkv, mask, g, heads),
                         kern.attention_bwd_plain(qkv, mask, g, heads), *TOL[torch.bfloat16]["k7"])
    lengths = [1500, 1200, 37, 0][:TRAIN_BATCH_30]
    q, mask = inputs(TRAIN_BATCH_30, 1500, width, torch.bfloat16, lengths)
    kv, _ = inputs(TRAIN_BATCH_30, 1500, 2 * width, torch.bfloat16, lengths)
    check(ea.kernel_plan(1500, D, torch.bfloat16) == ("blocked", 1536, 256), "30-s plan at 768")
    errs["K5"] = compare(f"K5 bf16 B={TRAIN_BATCH_30} S=1500 H={heads} (tp 2, plan of 768)",
                         ea.encoder_attention_blocked(q, kv, mask, heads, width=D),
                         ea.encoder_attention_blocked_plain(q, kv, mask, heads),
                         *TOL[torch.bfloat16]["kernel"])
    return errs


def tp_check_run(name, got, dtype, expect):
    """Phase 19's checks on one run's ranks (`got`: rank 0's, rank 1's)."""
    r0, r1 = got
    tol = TP_TOL[dtype]
    for r, res in enumerate(got):
        for k, want in expect.items():
            check(res["launches"][k] == want, f"phase 19 {name} rank {r}: {k} launched "
                                              f"{res['launches'][k]} times, expected {want}")
        check(all(np.isfinite([m["loss"] for m in res["metrics"]])), f"{name}: non-finite loss")
    check(r0["metrics"] == r1["metrics"], f"phase 19 {name}: the ranks' metrics differ")
    check(r0["replicated_equal"] and r1["replicated_equal"],
          f"phase 19 {name}: a replicated leaf differs between the ranks")
    rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(r0["metrics"], r0["ref_metrics"]))
           for k in ("loss", "grad_norm")}
    for k, v in rel.items():
        check(v <= tol[k], f"phase 19 {name}: {k} {v:.2e} relative from the one-process step "
                           f"(> {tol[k]})")
    p = r0["params"]
    if "params_rel_l2" in tol:
        check(p["rel_l2"] <= tol["params_rel_l2"], f"phase 19 {name}: parameters {p['rel_l2']:.2e} "
                                                   f"relative in L2 from the one-process step")
    else:
        check(p["max_abs"] <= tol["params_max"], f"phase 19 {name}: a parameter {p['max_abs']:.2e} "
                                                 f"from the one-process step")
    print(f"  {name}: losses tp {[round(m['loss'], 6) for m in r0['metrics']]} / one process "
          f"{[round(m['loss'], 6) for m in r0['ref_metrics']]}; max rel Δ loss {rel['loss']:.2e}, "
          f"grad_norm {rel['grad_norm']:.2e}; parameters rel L2 {p['rel_l2']:.2e}, max |Δ| "
          f"{p['max_abs']:.2e}; replicated leaves bit-identical on both ranks; launches a rank "
          f"{ {k: r0['launches'][k] for k in ('k4', 'k5', 'k7')} }")
    return {"rel": rel, "params": p, "launches": r0["launches"]}


def tp_phase(cfg, label, backend: str = "gloo"):
    """Phase 19: the stage-2 step (bf16 and fp32, without and with the
    configs' dropout, 3 steps), the 30-s bf16 step and the fp32 stage-1 step
    at full width on two ranks at (dp, tp) = (1, 2), each held to the
    one-process step; a train state written at tp 2 resumed by one process;
    step times and each rank's memory beside one process's.  gloo: two
    ranks share the one card; nccl (a machine with two cards or more): a
    card a rank."""
    t0 = time.perf_counter()
    n, n_mae = cfg.audio.num_layers, configs.audiomae_base().encoder.num_layers
    where = "on the card over gloo" if backend == "gloo" else "on two cards over NCCL"
    print(f"phase 19: tensor parallelism, two ranks {where}, (dp, tp) = (1, {TP}), "
          f"caco_base / audiomae_base, B={TRAIN_BATCH}, 500 patches, {TEXT_LEN} tokens, "
          f"{TP_STEPS} steps")
    errs = tp_kernel_checks()
    rs = np.random.RandomState(SEED + 19)
    cpu = lambda b: {k: v.cpu() for k, v in b.items()}  # noqa: E731
    tmp = tempfile.mkdtemp(prefix="caco_smoke_tp_")
    try:
        torch.save({"caco": cpu(train_batch(cfg, rs, TRAIN_BATCH, 10, 500)),
                    "caco30": cpu(train_batch(cfg, rs, TRAIN_BATCH_30, 30, 1500)),
                    "mae": cpu(audio_batch(rs, MAE_TRAIN_BATCH, 10, 500))},
                   os.path.join(tmp, "batches.pt"))
        torch.cuda.empty_cache()
        try:
            torch.multiprocessing.spawn(tp_rank, args=(tmp, backend), nprocs=TP, join=True)
        except Exception as e:  # noqa: BLE001 — a rank's failure fails the phase
            raise SmokeFailure(f"phase 19: a rank failed: {e}") from e
        got = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=False)
               for r in range(TP)]
    finally:
        shutil.rmtree(tmp)
    probe = got[0]["collectives"]
    print(f"  {backend} on CUDA tensors (torch {torch.__version__}): "
          + "; ".join(f"{k} {v}" for k, v in probe.items()))
    for need in ("all_reduce_sum float32", "all_reduce_sum bfloat16", "all_gather float32",
                 "all_gather bfloat16", "broadcast float32"):  # what the tp path calls
        check(probe[need] == "ok", f"phase 19: {backend} refuses {need} on CUDA tensors: "
                                   f"{probe[need]}")
    check(got[0]["mesh"] == ((1, TP), backend), f"phase 19 mesh {got[0]['mesh']}")
    none = {"k5": 0, **NO_SERVING_KERNELS}
    out = {"backend": backend, "collectives_cuda": probe}
    for name, dtype, k7 in (("bf16", torch.bfloat16, n), ("fp32", torch.float32, 0),
                            ("bf16_dropout", torch.bfloat16, n), ("fp32_dropout", torch.float32, 0)):
        out[name] = tp_check_run(name, [g[name] for g in got], dtype,
                                 {"k4": n * TP_STEPS, "k7": k7 * TP_STEPS, **none})
    out["bf16_30s"] = tp_check_run("bf16 30 s", [g["bf16_30s"] for g in got], torch.bfloat16,
                                   {"k5": n * 2, "k4": 0, "k7": 0, **NO_SERVING_KERNELS})
    layers = 2 * n_mae
    out["mae_fp32"] = tp_check_run("stage 1 fp32", [g["mae_fp32"] for g in got], torch.float32,
                                   {"k4": layers * TP_STEPS, "k7": n_mae * TP_STEPS, **none})
    res = got[0]["resume"]
    rel = abs(res["tp_loss"] - res["one_loss"]) / abs(res["one_loss"])
    print(f"  19e: a train state of whole leaves written at tp 2 ({res['file_bytes']} bytes in "
          f"{res['write_s']:.2f} s), resumed in one process: the next step's loss {res['one_loss']:.7f} "
          f"vs tp's {res['tp_loss']:.7f} (rel {rel:.2e}), parameters rel L2 "
          f"{res['params']['rel_l2']:.2e}")
    check(res["whole_leaves"], "phase 19e: the tp file does not hold whole leaves")
    check(rel <= TP_TOL[torch.float32]["loss"] and res["params"]["rel_l2"] <= 1e-5,
          "phase 19e: the resumed one-process step differs from the tp step")
    out["resume"] = dict(res, loss_rel=rel)
    for name in ("bf16", "fp32", "bf16_30s", "mae_fp32"):
        r0, r1 = got[0][name], got[1][name]
        med = lambda ms: float(np.median(ms[1:]))  # noqa: E731  (the first step warms up)
        out[name].update(tp_ms=[r0["ms"], r1["ms"]], one_ms=r0["ref_ms"],
                         tp_peak_gib=[r0["peak_gib"], r1["peak_gib"]], one_peak_gib=r0["ref_peak_gib"],
                         param_gib_rank=r0["param_gib"])
        print(f"  {name}: step {med(r0['ms']):.1f} ms at tp 2 (rank 0; steps {['%.1f' % v for v in r0['ms']]}) "
              f"vs {med(r0['ref_ms']):.1f} ms in one process; peak device memory of the run "
              f"{r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB a rank vs {r0['ref_peak_gib']:.2f} "
              f"GiB; fp32 parameters {r0['param_gib']:.3f} GiB a rank ({label})")
    wall = time.perf_counter() - t0
    print(f"  phase 19 took {wall:.1f} s ({label})")
    launches_ = {name: got[0][name]["launches"] for name in ("bf16", "fp32", "bf16_30s", "mae_fp32")}
    return errs, launches_, dict(out, wall_s=wall)


def clips_per_s(engine, wavs, runs=2):
    engine.embed_audio(wavs[:BATCH])  # warm
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.embed_audio(wavs)
        rates.append(len(wavs) / (time.perf_counter() - t0))
    return rates


def run() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = gpu_label()
    print(f"gpu: {label}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kern.load_library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or "C75" in line:
            print(f"  ptxas: {line.strip()}")
    hgmma = check_sass()
    res_usage = check_local_memory()
    silu_bad = kern.silu_epilogue_mismatches()
    print(f"  bf16 GEMM silu epilogue vs apply_epilogue over all 2^32 fp32 inputs: {silu_bad} "
          f"results differ")
    check(silu_bad == 0, "the bf16 GEMM's silu epilogue is not apply_epilogue's")

    blk = ViTBlock(D, INTER, torch.Generator().manual_seed(SEED)).to(DEVICE)
    errs = kernel_phase(blk)
    errs.update(block_phase(blk))
    errs.update(variant_phase(blk))
    errs.update(log_mel_phase())

    cfg = configs.caco_base()
    n_layers = cfg.audio.num_layers
    tok = byte_tokenizer()
    t0 = time.perf_counter()
    model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    engine = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                        dtype=torch.bfloat16)
    print(f"phase 5: caco_base bf16 10-s engine on cuda in {time.perf_counter() - t0:.1f} s "
          f"(seq {engine.patch.patches_seq_len})")
    check(engine.patch.patches_seq_len == 496, "10-s engine is not at 496 patches")

    rs = np.random.RandomState(SEED)
    lengths = rs.randint(3 * 16000, 10 * 16000 + 1, size=N_CLIPS)
    wavs = [(0.1 * rs.randn(n)).astype(np.float32) for n in lengths]
    texts = ["a dog barking", "rain on a window", "a trumpet solo",
             "people talking in a crowded room", "an engine idling", "birds singing at dawn"]
    n_buckets = -(-N_CLIPS // BATCH)
    no_blocks = {"k2_block": 0, "k3_block": 0}
    chain = dict.fromkeys(K1_PARTS)  # each launched at least once

    path = {}
    a_emb, path["K1"] = drive("bf16 10-s embed_audio", lambda: engine.embed_audio(wavs),
                              {"k1_layer": n_layers * n_buckets, **no_blocks, "log_mel": 0, **chain})
    t_emb = engine.embed_texts(texts)
    scores = engine.score(a_emb, t_emb)
    print(f"  embed_audio {a_emb.shape}, embed_texts {t_emb.shape}, score {scores.shape}")
    check_embeddings("audio", a_emb, N_CLIPS, cfg)
    check_embeddings("text", t_emb, len(texts), cfg)
    check(scores.shape == (N_CLIPS, len(texts)) and bool(np.isfinite(scores).all()),
          f"score: shape {scores.shape} or non-finite values")
    check(np.allclose(scores, np.exp(cfg.logit_scale_init) * a_emb @ t_emb.T, rtol=1e-4, atol=1e-4),
          "score is not exp(logit_scale) · A @ Tᵀ")

    path["tiny"], tiny_cos = tiny_engine_phase(wavs)

    print("phase 6: fp32 10-s engine (K2 + MLP outside the kernel)")
    engine32 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                          dtype=torch.float32)
    a32, path["K2"] = drive("fp32 10-s embed_audio", lambda: engine32.embed_audio(wavs),
                            {"k2_block": n_layers * n_buckets, "k1_layer": 0, "k3_block": 0,
                             **chain})
    check_embeddings("fp32 audio", a32, N_CLIPS, cfg)
    cos_bf16 = float(cosine_rows(a_emb, a32).min())
    cpu_model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    cpu_engine = CacoEngine(cfg, cpu_model, tokenizer=tok, device="cpu", batch_size=2,
                            dtype=torch.float32)
    a_cpu = cpu_engine.embed_audio(wavs[:2])
    cos_cpu = float(cosine_rows(a32[:2], a_cpu).min())
    print(f"  cosine fp32 card vs fp32 CPU plain (2 clips) {cos_cpu:.7f} (≥ 0.9999); "
          f"bf16 vs fp32 on the card ({N_CLIPS} clips, min) {cos_bf16:.7f} (≥ 0.999)")
    check(cos_cpu >= 0.9999, "fp32 card path disagrees with the CPU plain path")
    check(cos_bf16 >= 0.999, "bf16 path disagrees with fp32")
    del engine32, cpu_engine, cpu_model

    print("phase 7: bf16 10-s engine with the fused frontend (K8)")
    engine_k8 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                           dtype=torch.bfloat16, fused_frontend=True)
    a_k8, path["K8"] = drive("fused-frontend embed_audio", lambda: engine_k8.embed_audio(wavs),
                             {"log_mel": n_buckets, "k1_layer": n_layers * n_buckets, **chain})
    check_embeddings("fused-frontend audio", a_k8, N_CLIPS, cfg)
    cos_k8 = float(cosine_rows(a_k8, a_emb).min())
    print(f"  cosine fused vs unfused frontend, bf16 ({N_CLIPS} clips, min) {cos_k8:.7f} "
          f"(≥ {COS_FUSED})")
    check(cos_k8 >= COS_FUSED, "fused frontend disagrees with the unfused one")
    del engine_k8

    print("phase 8: the 30-s retrieval engine, bf16 (K3 + MLP outside the kernel)")
    engine30 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                          dtype=torch.bfloat16, buffer_seconds=30.0)
    check(engine30.patch.patches_seq_len == 1536,
          f"30-s bf16 engine at {engine30.patch.patches_seq_len} patches, expected 1536")
    lengths30 = rs.randint(3 * 16000, 30 * 16000 + 1, size=N_CLIPS_30)
    wavs30 = [(0.1 * rs.randn(n)).astype(np.float32) for n in lengths30]
    n_buckets30 = -(-N_CLIPS_30 // BATCH)
    a30, path["K3"] = drive("bf16 30-s embed_audio", lambda: engine30.embed_audio(wavs30),
                            {"k3_block": n_layers * n_buckets30, "k1_layer": 0, "k2_block": 0,
                             **chain})
    check_embeddings("30-s audio", a30, N_CLIPS_30, cfg)
    long_wavs = [(0.1 * rs.randn(s * 16000)).astype(np.float32) for s in (45, 60, 75)]
    a_long, _ = drive("bf16 30-s embed_audio_long", lambda: engine30.embed_audio_long(long_wavs),
                      {"k3_block": n_layers, "k1_layer": 0})  # 2 + 2 + 3 windows: one bucket
    check_embeddings("embed_audio_long", a_long, len(long_wavs), cfg)
    engine30_32 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                             dtype=torch.float32, buffer_seconds=30.0)
    check(engine30_32.patch.patches_seq_len == 1496,
          f"30-s fp32 engine at {engine30_32.patch.patches_seq_len} patches, expected 1496")
    a30_32, _ = drive("fp32 30-s embed_audio (einsum route, no kernel)",
                      lambda: engine30_32.embed_audio(wavs30),
                      {k: 0 for k in launches()})
    cos30 = float(cosine_rows(a30, a30_32).min())
    print(f"  cosine bf16 (K3) vs fp32 (einsum) at 30 s ({N_CLIPS_30} clips, min) {cos30:.7f} "
          f"(≥ 0.999)")
    check(cos30 >= 0.999, "30-s bf16 path disagrees with fp32")
    del engine30_32

    variant_paths, variants = variant_paths_phase(cfg, model, engine, engine30, wavs, wavs30)
    path.update(variant_paths)
    _, grads = grad_phase(cfg, model, wavs)

    errs.update(attention_phase())
    path["K4"], train_bf16 = train_bf16_phase(cfg, rs)
    path["K7"] = path["K4"]
    _, train_fp32 = train_fp32_phase(cfg, rs)
    path["K5"], train_30 = train_30s_phase(cfg, rs)

    print("phase 13: timings")
    bench = [(0.1 * rs.randn(10 * 16000)).astype(np.float32) for _ in range(4 * BATCH)]
    rates = clips_per_s(engine, bench)
    engine_k8 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                           dtype=torch.bfloat16, fused_frontend=True)
    rates_k8 = clips_per_s(engine_k8, bench)
    del engine_k8
    print(f"  embed_audio {rates[0]:.1f} / {rates[1]:.1f} clips/s (10-s clips, bf16, "
          f"batch {BATCH}, {len(bench)} clips per run; {label}); with fused_frontend=True (K8) "
          f"{rates_k8[0]:.1f} / {rates_k8[1]:.1f}")
    engine32 = CacoEngine(cfg, model, tokenizer=tok, device=DEVICE, batch_size=BATCH,
                          dtype=torch.float32)
    rates32 = clips_per_s(engine32, bench)
    print(f"  embed_audio {rates32[0]:.1f} / {rates32[1]:.1f} clips/s (10-s clips, fp32, "
          f"batch {BATCH}, {len(bench)} clips per run; {label})")
    del engine32
    bench30 = [(0.1 * rs.randn(30 * 16000)).astype(np.float32) for _ in range(3 * BATCH)]
    rates30 = clips_per_s(engine30, bench30)
    print(f"  embed_audio {rates30[0]:.1f} / {rates30[1]:.1f} clips/s (30-s clips, bf16, "
          f"batch {BATCH}, {len(bench30)} clips per run; {label})")
    times, bounds, host = timing_phase(blk, label)
    times["k8"], bounds["k8"] = times["log_mel_1000"], bounds["log_mel_1000"]
    times["k8_fast"], bounds["k8_fast"] = times["log_mel_fast_1000"], bounds["log_mel_fast_1000"]
    links = links_phase(blk, label)

    print(f"  K7 / SDPA backward alone (B=16, S=500): {links['k7']['ms']:.4f} / "
          f"{links['k7']['library_ms']:.4f} ms = {links['k7']['ms'] / links['k7']['library_ms']:.2f}; "
          f"the K5 call (B=4, S=1500) / SDPA at K5's shape: {times['k5'][0]:.4f} / "
          f"{links['k5']['library_ms']:.4f} ms = {times['k5'][0] / links['k5']['library_ms']:.2f} ({label})")
    print(f"  bf16 10-s training step {train_bf16['median_step_ms']:.2f} ms/step (median of 6, "
          f"B={TRAIN_BATCH}), device busy {train_bf16['device_busy_ms']:.2f} ms/step, "
          f"peak {train_bf16['peak_gib']:.2f} GiB ({label})")
    print(f"  fp32 10-s training step {np.median(train_fp32['step_ms']):.2f} ms/step (median of 3, "
          f"B={TRAIN_BATCH}); bf16 30-s step {np.median(train_30['step_ms']):.2f} ms/step (median "
          f"of 3, B={TRAIN_BATCH_30}), peak {train_30['peak_gib']:.2f} GiB ({label})")
    caption_launches, caption = caption_engine_phase(cfg, model, tok, wavs, label)
    caption_launches["decode"], caption["decode"] = decode_rate_phase(cfg, model, tok, label)
    caption_launches["prefill"], caption["continuous"] = continuous_phase(
        cfg, model, tok, wavs[:CAPTION_CLIPS], label)
    caption["gallery"] = gallery_phase(label)
    ckpt_launches, ckpt = checkpoint_phase(cfg, model, wavs, a_emb, tok)
    del engine, engine30, model
    tmp = tempfile.mkdtemp(prefix="caco_smoke_runner_")
    try:
        data, tok_dir = write_runner_data(tmp, rs)
        run_launches, resume_launches, runner_summary = runner_phase(cfg, label, tmp, data, tok_dir)
        remat_launches, remat = remat_phase(cfg, rs)
        mae_model, masked, recon16, mae_errs, recon_launches, recon = mae_recon_phase(rs, label)
        for key, err in mae_errs.items():  # K1's errors are kept under its chain's key
            key = "k1_layer" if key == "K1" else key
            errs[key] = max(errs[key], err)
        step_launches, mae_train = mae_train_phase(rs, label)
        stage1_launches, stage1 = mae_checkpoint_phase(mae_model, masked, recon16, label, tmp,
                                                       data, tok_dir)
        del mae_model, masked, recon16
    finally:
        shutil.rmtree(tmp)
    print(f"  runner step {runner_summary['median_step_ms']:.1f} ms (median of the intervals, "
          f"B={TRAIN_BATCH}; with a batch's decode {runner_summary['step_ms'][1]:.1f} ms); "
          f"checkpoint {ckpt['file_bytes']} bytes written in "
          f"{ckpt['write_s']:.2f} s, loaded in {ckpt['load_s']:.2f} s ({label})")
    print(f"  stage 1: mae_recon_clips_per_s {recon['mae_recon_clips_per_s']:.1f} (bf16, "
          f"B={MAE_BATCH}); stage-1 step {mae_train['bfloat16']['median_step_ms']:.2f} ms bf16 / "
          f"{mae_train['float32']['median_step_ms']:.2f} ms fp32 (B={MAE_TRAIN_BATCH}), peak "
          f"{mae_train['bfloat16']['peak_gib']:.2f} / {mae_train['float32']['peak_gib']:.2f} GiB "
          f"({label})")
    eval_launches, hear_launches, eval_hear = eval_hear_phase(label)
    par_launches, par = parallel_phase(cfg, tok, wavs, a_emb, train_bf16["median_step_ms"], label)
    tp_errs, tp_launches, tp = tp_phase(cfg, label)
    for key, err in tp_errs.items():  # K4, K5 and K7 at 4 heads
        errs[key] = max(errs[key], err)
    err_key = {"K1": "k1_layer", "K2": "K2", "K3": "K3", "K3′": "K3′", "K4": "K4", "K5": "K5",
               "K6": "K6", "K7": "K7", "K8": "K8", "K8′": "K8′"}
    time_key = {"K1": "k1_layer", "K2": "k2_block", "K3": "k3_block", "K3′": "k3_layer", "K4": "k4",
                "K5": "k5", "K6": "k6_attn", "K7": "k7", "K8": "k8", "K8′": "k8_fast"}
    # one PyTorch call computes K4's, K5's and K7's function; the chains and
    # K8 / K8′ have none (their links' library times are under "links")
    lib_key = {"K4": "k4", "K5": "k5", "K7": "k7"}
    # launches on the stage-1 paths (phase 15): K1 a bf16 reconstruction
    # forward, K2 an fp32 one, K4 and K7 over MAE_STEPS bf16 steps
    mae_path = {"K1": recon_launches["bf16"], "K2": recon_launches["fp32"],
                "K4": step_launches["bfloat16"], "K7": step_launches["bfloat16"]}
    # launches on the captioning paths (phase 16): K1 / K2 / K8 in one
    # CacoEngine.caption audio pass (bf16, fp32, bf16 with the fused
    # frontend); K1 in one 256-stream decode call and in the continuous
    # captioner's prefill
    caption_path = {"K1": caption_launches["caption"], "K2": caption_launches["caption_fp32"],
                    "K8": caption_launches["caption_fused_frontend"]}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": path[name][key], "max_abs_err": errs[err_key[name]],
                "ms": times[time_key[name]][0], "plain_ms": times[time_key[name]][1],
                "bound_ms": bounds[time_key[name]][0], "bound_by": bounds[time_key[name]][1],
                "library_ms": links[lib_key[name]]["library_ms"] if name in lib_key else None,
                "mae_launches": mae_path[name][key] if name in mae_path else 0,
                "caption_launches": caption_path[name][key] if name in caption_path else 0,
                "decode_launches": caption_launches["decode"][key],
                "prefill_launches": caption_launches["prefill"][key],
                # phase 17: every eval CLI run on its paths (zs fp32 and bf16,
                # ar bf16 and fp32, caption bf16), and both HEAR runners
                "eval_launches": sum(got[key] for got in eval_launches.values()),
                "hear_launches": sum(got[key] for got in hear_launches.values()),
                # phase 18: the runner from HF files, the dp step and the dp engine
                "parallel_launches": sum(got[key] for got in par_launches.values()),
                # phase 19: rank 0's launches in the tp steps (bf16, fp32, 30 s, stage 1)
                "tp_launches": sum(got[key] for got in tp_launches.values())}
               for name, (src, replaces, key) in TPU_KERNELS.items()]
    return {"kernels": kernels,
            "k1_parts": {k: {"source": src, "launches": path["K1"][k], "max_abs_err": errs[k],
                             "ms": times[k][0], "plain_ms": times[k][1]}
                         for k, src in K1_PARTS.items()},
            "log_mel_3000": {"ms": times["log_mel_3000"][0], "plain_ms": times["log_mel_3000"][1]},
            "log_mel_fast_3000": {"ms": times["log_mel_fast_3000"][0],
                                  "plain_ms": times["log_mel_fast_3000"][1]},
            "table_grad": {"source": CSRC + "table_grad.cu", "max_rel_err": errs["table_grad"],
                           "train_bf16_launches": path["K4"]["table_grad"],
                           "ms": times["table_grad"][0], "plain_ms": times["table_grad"][1],
                           "bound_ms": bounds["table_grad"][0],
                           "bound_by": bounds["table_grad"][1]},
            "links": links, "attention_host": host, "hgmma": hgmma, "res_usage": res_usage,
            "silu_epilogue_mismatches": silu_bad,
            "variant_paths": variants, "inference_grads": grads,
            "clips_per_s": {"10s_bf16": rates, "10s_bf16_fused_frontend": rates_k8,
                            "10s_fp32": rates32, "30s_bf16": rates30},
            "tiny_engine_cosine": tiny_cos,
            "train": {"bf16_10s": train_bf16, "fp32_10s": train_fp32, "bf16_30s": train_30},
            "checkpoint_runner": {
                "checkpoint": ckpt, "runner": runner_summary, "remat": remat,
                "launches": {"loaded_engine_k1": ckpt_launches["k1_layer"],
                             "runner_k4": run_launches["k4"], "runner_k7": run_launches["k7"],
                             "resumed_k4": resume_launches["k4"],
                             "resumed_k7": resume_launches["k7"],
                             "remat_k4": remat_launches[True]["k4"],
                             "plain_k4": remat_launches[False]["k4"]}},
            "mae": {"recon": recon, "train": mae_train, "checkpoint_runner": stage1,
                    "launches": {"recon_bf16_k1": recon_launches["bf16"]["k1_layer"],
                                 "recon_fp32_k1": recon_launches["fp32"]["k1_layer"],
                                 "recon_fp32_k2": recon_launches["fp32"]["k2_block"],
                                 "step_bf16_k4": step_launches["bfloat16"]["k4"],
                                 "step_bf16_k7": step_launches["bfloat16"]["k7"],
                                 "step_fp32_k4": step_launches["float32"]["k4"],
                                 "step_fp32_k7": step_launches["float32"]["k7"],
                                 "loaded_k1": stage1_launches["loaded"]["k1_layer"],
                                 "runner_mae_k4": stage1_launches["runner_mae"]["k4"],
                                 "runner_mae_k7": stage1_launches["runner_mae"]["k7"],
                                 "runner_init_k4": stage1_launches["runner_init"]["k4"]}},
            "caption": caption,
            "eval_hear": dict(eval_hear, launches={
                "eval": {run: {k: got[k] for k in ("k1_layer", "k2_block", "k3_block")}
                         for run, got in eval_launches.items()},
                "hear": {run: got["k2_block"] for run, got in hear_launches.items()}}),
            "parallel": dict(par, launches={
                run: {k: got[k] for k in ("k1_layer", "k4", "k7")}
                for run, got in par_launches.items()}),
            "tensor_parallel": dict(tp, launches={
                run: {k: got[k] for k in ("k4", "k5", "k7")} for run, got in tp_launches.items()}),
            "gpu": label}


def main() -> int:
    try:
        summary = run()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
