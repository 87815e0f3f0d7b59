"""What the card tests share: the `cuda` fixture, one table of bounds, the
kernels' launch counts around a call, and the synthetic data they make
from seeds.

The card tests are `tests/test_torch_cuda*.py` and the `cuda`-marked tests
of `test_torch_profiling.py` and `test_torch_text_pooler.py`.  Each needs an
NVIDIA GPU with nvcc and skips through `cuda` on a machine without one.
None imports JAX, so they run on a machine that has none:

    python -m pytest tests/test_torch_cuda*.py tests/test_torch_profiling.py \\
        tests/test_torch_text_pooler.py -m cuda --noconftest

(tests/conftest.py configures JAX, hence --noconftest.)  `-m "cuda and not
slow"` leaves out the files module and the tp ranks (about four of the
suite's eight minutes on an H100).  `chip_smoke.py` runs the same modules
and prints every path `drive` recorded; `scripts/kernel_times.py` loads
this file for its data writers.  The bounds of the card modules are
stated here, except those of `test_torch_cuda.py` that one test alone
holds (a ragged or degenerate case's), which stay beside it.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.data.pipeline import device_train_frontend
from cacophony_tpu_torch.data.tokenizer import _bytes_to_unicode
from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples, wav_to_patches
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea

# |card − plain| ≤ atol + rtol·|plain|, elementwise, against the plain
# PyTorch version on the same inputs.
# - kernel: one kernel; bf16 rounds its output (8 mantissa bits, 2^-8
#   relative) after fp32 sums taken in another order; fp32 differs by the
#   summation order only.
# - chain: a layer (K1, K2, K3, K3′, K6), seven such roundings compounded.
# - k7: P and dS are rounded to bf16 before their products, so a rounding
#   step of either moves a gradient by one more.
# - clamp: logits far above the clamp of 80 (q and k of scale 8): logits of
#   a few hundred carry ~1e-5 of absolute rounding into p in fp32.
TOL = {
    "bfloat16": {"kernel": (2e-2, 1e-2), "chain": (6e-2, 3e-2), "k7": (3e-2, 2e-2),
                 "clamp": (6e-2, 2e-2)},
    "float32": {"kernel": (1e-4, 1e-4), "chain": (5e-4, 5e-4), "k7": (1e-4, 1e-4),
                "clamp": (5e-3, 1e-4)},
}
# K8 and K8′ against their plain versions (atol, rtol): fp32 sums in another
# order, and the log scales a mel error δ by 0.2/(mel + 1e-5).  K8′ against
# exact K8: JAX's bound on its bf16×3 DFT (tests/test_fused_frontend.py),
# held where the plain bf16×3 DFT meets it; elsewhere K8′ may be no farther
# from K8 than the plain version is, plus LOG_MEL (over millions of values
# the bf16×3 DFT itself misses 2e-4 on about one in a million, a mel value
# whose few DFT bins nearly cancel).
LOG_MEL, FAST_DFT = (1e-4, 0.0), 2e-4
# Least cosine between embeddings (or reconstructed patch rows): fp32 on the
# card against the CPU's plain path; bf16 against fp32, and a variant route
# (K6, K3′) against the default one, which moves bf16 rounding points; the
# fused frontend against the unfused one (a few bf16 flips of patch values
# that lie within ~1e-6 of a rounding boundary); the same weights loaded
# from a file through the same kernels.
COS = {"fp32": 0.9999, "bf16": 0.999, "fused_frontend": 0.9999, "loaded": 0.99999}
# fp32 on the card against the same function on the CPU, relative: the loss,
# and the gradients in L2 (sums in another order through every layer and
# its backward).
STEP_TOL = {"loss": 1e-5, "grads": 1e-4}
# The frequency table's gradient against its plain version, relative L2:
# both fp32 sums of the same rows in another order.
TABLE_GRAD_TOL = 2e-5
# The engine's scores against exp(s)·A@Tᵀ in numpy (rtol, atol): fp32
# products in another order.
SCORE_TOL = (1e-4, 1e-4)
# |‖embedding‖ − 1| at most: the unit normalisation in fp32.
NORM_TOL = 1e-3
# fp32 stepwise decode logits against teacher forcing, max |Δ| / max |ref|
# over the live stream-steps: the same fp32 math, attention over the cache
# instead of the causal bias.
DECODE_REL = 1e-4
# Near-greedy sampling (T 1e-6) may differ from batch decode only where the
# top-two logits lie closer than this: a gap of 1e-4 flips a draw with
# probability e^-100.
TOP2_GAP = 1e-4
# Least share of a T-1.0 decode's ids other than 0 after the first: EOS is
# one id in 50 265, so about 0.3 of 256 streams end early, each leaving
# zeros behind it; zeros elsewhere mean broken logits.
WRITTEN = 0.99
# Absolute, fp32 sums in another order: the gallery's scores of unit rows
# against numpy's, and `resample_fft` on the card against the host's.
GALLERY_ATOL, RESAMPLE_ATOL = 1e-5, 1e-5
# The eval CLI's retrieval metrics against numpy's from the same scores:
# float64 means of the same hits.
METRIC_ATOL = 1e-12
# tp 2 against the one-process step.  bf16: losses 1e-2 and grad_norm 2e-2
# relative (the bounds tests/test_torch_train_step.py holds bf16 to: a
# row-parallel layer rounds each rank's partial product to bf16 before the
# bf16 sum, where one process rounds once), and no parameter farther than
# two Adam steps of opposite signs, 4·lr·1.05 (an Adam step moves an
# element by about lr whatever its gradient; bf16's K7 sums dQ with float
# atomics, so not even the one-process step repeats itself bit for bit).
# fp32: losses and grad_norm 1e-5 relative, parameters 1e-5 relative in
# L2 (sums split over two ranks), also for one process resumed from tp's
# train state.
TP_LR = 1e-4
TP_TOL = {torch.float32: {"loss": 1e-5, "grad_norm": 1e-5, "params_rel_l2": 1e-5},
          torch.bfloat16: {"loss": 1e-2, "grad_norm": 2e-2, "params_max": 4 * TP_LR * 1.05}}
# The launch counts of training: none of the serving kernels.
NO_SERVING = {"k1_layer": 0, "k2_block": 0, "k3_block": 0, "k3_layer": 0, "k6_attn": 0,
              "attention": 0, "gemm": 0, "layer_norm": 0, "log_mel": 0, "log_mel_fast": 0}
SEED = 0


@pytest.fixture(scope="module")
def cuda():
    """The card, with TF32 off (the fp32 plain versions are exact references
    only without it); skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tol(dtype, kind: str):
    """(atol, rtol) of TOL for a torch dtype or its name."""
    return TOL[dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")][kind]


def check_close(got, want, bound):
    """got finite and within bound = (atol, rtol) of want, elementwise."""
    got = got.cpu()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), want.float().cpu().numpy(),
                               atol=bound[0], rtol=bound[1])


def reset_launches() -> None:
    kern.reset_launches()
    for k in ea.LAYER_LAUNCHES:
        ea.LAYER_LAUNCHES[k] = 0


def launches() -> dict:
    return dict(kern.LAUNCHES, **ea.LAYER_LAUNCHES)


# (path, launch counts) of every path driven in this process, in order;
# the path is the test's id.  chip_smoke.py prints them.
PATHS = []


def record(got: dict, part: str = "") -> None:
    test = os.environ.get("PYTEST_CURRENT_TEST", "").rsplit(" (", 1)[0]
    PATHS.append((test + (f" {part}" if part else ""), dict(got)))


def drive(fn, expect: dict):
    """fn() with every launch count at 0 before it → (its result, the counts
    after it), recorded in PATHS; each count in `expect` must equal its
    value there (None: at least once)."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = launches()
    record(got)
    for k, want in expect.items():
        assert (got[k] > 0 if want is None else got[k] == want), (k, got[k], want)
    return out, got


def cosine_rows(a, b) -> float:
    """The least cosine between the rows of two arrays."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float((a * b).sum(-1).min())


def check_embeddings(emb, n: int, cfg) -> None:
    assert emb.shape == (n, cfg.projection_size) and np.isfinite(emb).all()
    assert np.abs(np.linalg.norm(emb, axis=-1) - 1.0).max() <= NORM_TOL


def clips(rs, n: int, lo: float, hi: float):
    """n clips of 0.1·randn at 16 kHz, lo to hi seconds long."""
    return [(0.1 * rs.randn(k)).astype(np.float32)
            for k in rs.randint(int(lo * 16000), int(hi * 16000) + 1, size=n)]


def audio_batch(rs, b: int, seconds: int, seq_len: int):
    """A training patch batch: clips of 3 s to `seconds` s through
    `device_train_frontend` (every patch of the buffer, then a sorted
    random subset of seq_len)."""
    front = configs.FrontendConfig()
    samples = seconds * front.sample_rate
    lens = rs.randint(3 * front.sample_rate, samples + 1, size=b).astype(np.int32)
    bufs = np.zeros((b, samples), np.float32)
    for i, n in enumerate(lens):
        bufs[i, :n] = 0.1 * rs.randn(n)
    full = num_patches_for_samples(samples, front, configs.PatchConfig())
    frontend = device_train_frontend(front, configs.PatchConfig(patches_seq_len=max(full, seq_len)),
                                     seq_len)
    batch = frontend(torch.Generator(device="cuda").manual_seed(SEED),
                     torch.from_numpy(bufs).cuda(), torch.from_numpy(lens).cuda())
    assert batch["audio_patches"].shape == (b, seq_len, 256)
    return batch


def train_batch(cfg, rs, b: int, seconds: int, seq_len: int):
    """A stage-2 batch: `audio_batch`'s patches and captions of 8 to 100
    tokens."""
    batch = audio_batch(rs, b, seconds, seq_len)
    tmask = (np.arange(100)[None] < rs.randint(8, 101, size=b)[:, None]).astype(np.int32)
    ids = np.where(tmask > 0, rs.randint(4, cfg.text.vocab_size, size=(b, 100)), 1)
    batch["text_input_ids"] = torch.from_numpy(ids.astype(np.int32)).cuda()
    batch["text_mask"] = torch.from_numpy(tmask).cuda()
    return batch


def decode_batch(n: int, seed: int, dtype=torch.bfloat16):
    """bench.py's decode input: n 10-s buffers of 0.1·randn through the
    frontend at 500 patches, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bufs = 0.1 * torch.randn(n, 160_000, generator=g, device="cuda")
    lens = torch.full((n,), 160_000, dtype=torch.int32, device="cuda")
    return wav_to_patches(bufs, lens, configs.FrontendConfig(),
                          configs.PatchConfig(patches_seq_len=500), dtype=dtype)


MAE_ARGS = ("patches", "mask", "time_inds", "freq_inds", "restore_time_inds",
            "restore_freq_inds", "restore_mask")  # audiomae_apply's inputs, in order


def mae_input(b: int, mask_ratio: float):
    """The stage-1 reconstruction's input at its benchmark shape: b 10-s
    buffers of 0.1·randn at 500 patches on the card, the last clip 1.5 s
    (72 valid patches, fewer than the 100 visible at ratio 0.8, so padding
    lies inside its visible set), masked by the port's masking."""
    from cacophony_tpu_torch.train import train

    rs = np.random.RandomState(SEED)
    bufs = (0.1 * rs.randn(b, 160_000)).astype(np.float32)
    lens = np.full(b, 160_000, np.int32)
    lens[-1] = 24_000
    bufs[-1, 24_000:] = 0.0
    grid = wav_to_patches(torch.from_numpy(bufs).cuda(), torch.from_numpy(lens).cuda(),
                          configs.FrontendConfig(), configs.PatchConfig(patches_seq_len=500))
    noise = train.mae_noise(torch.Generator(device="cuda").manual_seed(SEED), grid["audio_mask"])
    return train.mae_random_masking(noise, grid, mask_ratio)


def gallery_data(rows_n: int, dim: int, queries: int):
    """Unit rows, queries near rows, and 1 % of the rows to delete."""
    rs = np.random.default_rng(SEED)
    rows = rs.standard_normal((rows_n, dim), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    q = rows[rs.choice(rows_n, queries, replace=False)] + \
        0.05 * rs.standard_normal((queries, dim), dtype=np.float32)
    return rows, q, rs.choice(rows_n, rows_n // 100, replace=False)


def no_text_dropout(cfg):
    text = dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0)
    dec = dataclasses.replace(cfg.decoder, hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(cfg, text=text, decoder=dec)


def byte_vocab() -> dict:
    """The specials and all 256 byte symbols: a byte-level BPE vocabulary."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in _bytes_to_unicode().values():
        vocab[c] = len(vocab)
    return vocab


def write_tokenizer(path: str) -> str:
    """A tokenizer directory holding byte_vocab() and no merges."""
    os.makedirs(path)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(byte_vocab(), f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return path


def write_pcm16(path, sr: int, x) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sr, (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16))


def write_runner_data(root: str, rs, n: int = 48):
    """n clips of 3-10 s in three formats (PCM16 mono 16 kHz, PCM16 stereo
    44.1 kHz, float32 48 kHz; clip01 10 s at 44.1 kHz) with two captions
    each in captions.csv, and a tokenizer directory → (data, tokenizer)."""
    from scipy.io import wavfile

    data = os.path.join(root, "data")
    os.makedirs(data)
    rows = [["file_name", "caption"]]
    for i in range(n):
        seconds = 10.0 if i == 1 else rs.uniform(3, 10)
        kind = i % 3
        sr = (16000, 44100, 48000)[kind]
        x = (0.1 * rs.randn(int(seconds * sr), 2 if kind == 1 else 1)).astype(np.float32)
        name = f"clip{i:02d}.wav"
        if kind == 2:
            wavfile.write(os.path.join(data, name), sr, x[:, 0])
        else:
            wavfile.write(os.path.join(data, name), sr, (x * 32767).astype(np.int16).squeeze())
        rows += [[name, f"sound number {i}"], [name, f"another take of sound {i}"]]
    with open(os.path.join(data, "captions.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return data, write_tokenizer(os.path.join(root, "tok"))


def write_esc50(root: str, rs, categories, per_category: int, seconds):
    """The ESC-50 layout that eval/processors.py reads: per_category clips
    at 44.1 kHz of each category, seconds() long."""
    os.makedirs(os.path.join(root, "audio"))
    rows = [["filename", "fold", "target", "category"]]
    for c, cat in enumerate(categories):
        for k in range(per_category):
            name = f"{1 + k % 5}-{100 * c + k}-A-{c}.wav"
            write_pcm16(os.path.join(root, "audio", name), 44100,
                        0.1 * rs.randn(int(seconds() * 44100)))
            rows.append([name, str(1 + k % 5), str(c), cat])
    with open(os.path.join(root, "esc50.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return root


def write_hear_task(tasks: str, task: str, kind: str, ptype: str, splits: dict, scores,
                    labels, rs, seconds, duration: float = 10.0) -> None:
    """One task in the HEAR layout (hear/runner.py): splits maps a split to
    its clip count, each clip 16 kHz and seconds() long; an event clip has
    two events of its label."""
    path = os.path.join(tasks, task)
    os.makedirs(path)
    with open(os.path.join(path, "task_metadata.json"), "w") as f:
        json.dump({"task_name": task.split("-")[0], "embedding_type": kind,
                   "prediction_type": ptype, "splits": list(splits), "evaluation": scores,
                   "sample_duration": duration}, f)
    with open(os.path.join(path, "labelvocabulary.csv"), "w", newline="") as f:
        csv.writer(f).writerows([["idx", "label"]] + [[str(i), lab] for i, lab in enumerate(labels)])
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


def write_models(root: str, seed: int):
    """caco_base and audiomae_base from seeds seed and seed + 1, written as
    released-layout files by the port → (caco dir, stage-1 dir)."""
    from cacophony_tpu_torch.checkpoints import bridge, convert, msgpack
    from cacophony_tpu_torch.models.audio import audiomae_init
    from cacophony_tpu_torch.models.caco import caco_init

    cfg = configs.caco_base()
    model = caco_init(cfg, torch.Generator().manual_seed(seed))
    ref = convert.caco_params_to_reference(bridge.params_to_jax(model), cfg.audio.num_heads)
    caco_dir = os.path.join(root, "caco")
    msgpack.save_checkpoint(caco_dir, {"0": {"params": ref}}, step=0)
    del model, ref
    mcfg = configs.audiomae_base()
    mae = audiomae_init(mcfg.encoder, mcfg.decoder, torch.Generator().manual_seed(seed + 1))
    ref = convert.audiomae_params_to_reference(bridge.params_to_jax(mae), mcfg.encoder.num_heads,
                                               mcfg.decoder.num_heads)
    mae_dir = os.path.join(root, "mae")
    msgpack.save_checkpoint(mae_dir, {"0": {"params": ref}}, step=0)
    return caco_dir, mae_dir
