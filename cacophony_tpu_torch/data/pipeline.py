"""Training data pipeline: host decode → device frontend → batch
(cacophony_tpu/data/pipeline.py).

- `CacoTrainLoader` (host): the native C++ decoder at each file's own rate,
  `resample_fft_host` to 16 kHz, zero-padded buffers, a seeded caption
  choice and tokenization padded to `max_text_len`;
- `prefetch_to_device`: `size` batches in flight, each filled into pinned
  host tensors and copied with `non_blocking=True`;
- `device_train_frontend` (device): waveform buffers → patches → a random
  sorted subset of `seq_len` patches per clip.  For clips with at most
  `seq_len` valid patches the subset is the first N plus padding (the eval
  path's patches); longer clips keep a uniformly random sorted subset, as
  the reference training pipeline does (dataset.py:78-87), drawn from an
  explicit `torch.Generator` on the batch's device.

`DECODE_COUNTS` counts the files decoded by the native decoder and by the
per-file fallback, so a run can show which path its data took.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.data.audio_io import load_audio, pad_to_buffer
from cacophony_tpu_torch.frontend.dsp import resample_fft_host
from cacophony_tpu_torch.frontend.patchify import wav_to_patches
from cacophony_tpu_torch.native import wavio
from cacophony_tpu_torch.utils.profiling import span

DECODE_COUNTS = {"native": 0, "fallback": 0}


@dataclasses.dataclass(frozen=True)
class TrainDataConfig:
    batch_size: int = 32
    buffer_seconds: float = 10.0
    patches_seq_len: int = 500
    max_text_len: int = 100
    synthetic_prob: float = 0.8
    seed: int = 0
    sample_rate: int = 16_000


def subsample_patches(generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
                      seq_len: int) -> Dict[str, torch.Tensor]:
    """Batched random patch subsampling: leaves (B, S_full, ...) → (B, seq_len, ...).
    Invalid patches sort last (noise 2.0, stable sort), so a clip with at
    most seq_len valid patches keeps them all, in order, then padding."""
    x, mask = batch["audio_patches"], batch["audio_mask"]
    b, s_full, _ = x.shape
    noise = torch.rand((b, s_full), generator=generator, device=x.device)
    noise = torch.where(mask > 0, noise, 2.0)
    chosen = torch.argsort(noise, dim=1, stable=True)[:, :seq_len].sort(dim=1).values
    new_mask = mask.gather(1, chosen)
    return {
        "audio_patches": x.gather(1, chosen[..., None].expand(-1, -1, x.shape[-1]))
        * new_mask[..., None].to(x.dtype),
        "audio_time_inds": batch["audio_time_inds"].gather(1, chosen) * new_mask,
        "audio_freq_inds": batch["audio_freq_inds"].gather(1, chosen) * new_mask,
        "audio_mask": new_mask,
    }


def device_train_frontend(front: FrontendConfig, full_patch: PatchConfig, seq_len: int):
    """→ fn(generator, bufs (B, samples), lens (B,)) → the training patch
    batch: every patch of the buffer (`full_patch`), then `subsample_patches`
    (span `train.frontend`, utils/profiling.py)."""

    def fn(generator: Optional[torch.Generator], bufs: torch.Tensor, lens: torch.Tensor):
        with span("train.frontend", device=bufs.device):
            return subsample_patches(generator, wav_to_patches(bufs, lens, front, full_patch),
                                     seq_len)

    return fn


class CacoTrainLoader:
    """Host-side iterator: (filepaths, captions) → numpy batches of padded
    waveform buffers + tokenized text, ready for the device frontend.
    Yields dicts: audio_bufs (B, buffer) f32, audio_lens (B,) i32,
    text_input_ids and text_mask (B, max_text_len) i32.

    Semantics of the JAX loader: a fresh permutation per epoch seeded by
    `seed + epoch`; the caption choice seeded by the global batch index;
    `start_batch` skips batches without decoding them, so a resumed stream
    continues where it stopped."""

    # Native decode runs at the file's own rate into a buffer sized for up to
    # 3 × the model rate (48 kHz at 16 kHz), so such a clip is not cut short
    # before its resample.
    MAX_SOURCE_RATE_RATIO = 3

    def __init__(self, filepaths: Sequence[str], captions: Dict[str, List[str]], tokenizer,
                 cfg: TrainDataConfig = TrainDataConfig(),
                 synthetic_captions: Optional[Dict[str, List[str]]] = None,
                 shuffle: bool = True):
        self.filepaths = list(filepaths)
        self.captions = captions
        self.synthetic = synthetic_captions or {}
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.shuffle = shuffle
        self.start_batch = 0  # set before iterating to resume a stream
        self.buffer_samples = int(round(cfg.buffer_seconds * cfg.sample_rate))

    @staticmethod
    def _name(path: str) -> str:
        return os.path.basename(path).split(".wav")[0]

    def _decode(self, paths: Sequence[str]):
        bufs = np.zeros((len(paths), self.buffer_samples), np.float32)
        lens = np.zeros((len(paths),), np.int32)
        raw, raw_lens, rates = wavio.decode_batch(
            list(paths), self.buffer_samples * self.MAX_SOURCE_RATE_RATIO)
        for i, r in enumerate(rates):
            if r == 0 or r > self.cfg.sample_rate * self.MAX_SOURCE_RATE_RATIO:
                # per file: r == 0 is a format the decoder refuses; a rate above
                # the buffer's ratio would have been cut short — never train on
                # truncated or silent rows
                wav = load_audio(paths[i], target_sr=self.cfg.sample_rate)
                bufs[i], lens[i] = pad_to_buffer(wav, self.buffer_samples)
                DECODE_COUNTS["fallback"] += 1
                continue
            DECODE_COUNTS["native"] += 1
            n = int(raw_lens[i])
            wav = raw[i, :n]
            if r != self.cfg.sample_rate:
                wav = resample_fft_host(wav, round(n * self.cfg.sample_rate / r))
            k = min(len(wav), self.buffer_samples)
            bufs[i, :k] = wav[:k]
            lens[i] = k
        return bufs, lens

    def _pick_text(self, rng: np.random.RandomState, name: str) -> str:
        caps = self.captions[name]
        text = caps[rng.randint(len(caps))]
        syn = self.synthetic.get(name)
        if syn and rng.rand() < self.cfg.synthetic_prob:
            text = syn[rng.randint(len(syn))]
        return text

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.cfg.batch_size
        if len(self.filepaths) < bs:
            raise ValueError(
                f"{len(self.filepaths)} usable files < batch_size {bs} — "
                "check that captions.csv file_name values match the wavs")
        batches_per_epoch = len(self.filepaths) // bs
        start = self.start_batch
        epoch = start // batches_per_epoch
        while True:
            # a fresh permutation per epoch: an in-place cumulative shuffle
            # would make epoch k depend on replaying epochs 0..k-1
            order = np.arange(len(self.filepaths))
            if self.shuffle:
                np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
            for b in range(batches_per_epoch):
                if epoch * batches_per_epoch + b < start:
                    continue
                paths = [self.filepaths[j] for j in order[b * bs:(b + 1) * bs]]
                bufs, lens = self._decode(paths)
                rng = np.random.RandomState(
                    self.cfg.seed * 1_000_003 + epoch * batches_per_epoch + b)
                texts = [self._pick_text(rng, self._name(p)) for p in paths]
                tok = self.tokenizer(texts, padding="max_length", truncation=True,
                                     max_length=self.cfg.max_text_len, return_tensors="np")
                yield {
                    "audio_bufs": bufs,
                    "audio_lens": lens,
                    "text_input_ids": np.asarray(tok["input_ids"], np.int32),
                    "text_mask": np.asarray(tok["attention_mask"], np.int32),
                }
            epoch += 1


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Keep `size` batches decoded and copied ahead of the step that takes
    them: on a card each array is filled into a pinned host tensor and
    copied with non_blocking=True (the caching host allocator keeps the
    pinned block until its copy is done); on the CPU the arrays are
    wrapped without a copy.  The next batch is decoded on the caller's
    thread when a batch is taken, so it overlaps only what the card still
    has queued then (the stage-2 step waits for its gradient norm)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    queue = collections.deque()

    def put(batch):
        host = {k: torch.from_numpy(x) for k, x in batch.items()}
        if pin:
            host = {k: x.pin_memory() for k, x in host.items()}
        queue.append({k: x.to(device, non_blocking=pin) for k, x in host.items()})

    it = iter(iterator)
    for batch in itertools.islice(it, size):
        put(batch)
    while queue:
        yield queue.popleft()
        try:
            put(next(it))
        except StopIteration:
            pass
