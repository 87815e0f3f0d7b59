"""HEAR embedding extraction: models + on-disk embedding store
(cacophony_tpu/hear/embeddings.py).

Mirrors the reference subsystem's data contract
(src/eval/heareval/embeddings/): per-clip `.embedding.npy` +
`.target-labels.json` (+ `.timestamps.json` for event tasks), then one
memmapped `{split}.embeddings.npy` + pickled labels + dimension json per
split.  Embedding definitions (caco_embeddings.py:124-131,
audiomae_embeddings.py:157-163):

- CACO scene = L2-normalized pooled joint-space embedding (768-d)
- CACO event = avg-pool(hidden states, k=8, s=8) over the patch sequence
  (8 freq patches per time step → one vector per 160 ms time patch) with
  linspace timestamps in ms
- AudioMAE scene = mean over hidden-state sequence; event = same avg-pool

Execution model: clips are decoded and resampled on the host, then each
batch is one forward on the model's device (the card, or the CPU when the
model was loaded there): the log-mel frontend and patchify, then the
encoder in the model's `cfg.dtype`, every layer on `layer_route`'s route
(at 10 s and 16 kHz, 500 patches: K2 in fp32, K1 in bf16).  The pools
average the whole padded patch sequence, padding rows included, as the
reference does.  The files are byte-compatible with the JAX package's.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cacophony_tpu_torch.configs import AudioMAEConfig, CacoConfig, FrontendConfig, PatchConfig
from cacophony_tpu_torch.data.audio_io import load_audio
from cacophony_tpu_torch.frontend import wav_to_patches
from cacophony_tpu_torch.models.audio import AudioMAE, audio_encoder_apply
from cacophony_tpu_torch.models.caco import CacoModel, get_audio_embedding


class _BaseEmbedder:
    def __init__(self, params: torch.nn.Module, *, sample_rate: int = 16_000,
                 audio_max_len_s: float = 10.0, batch_size: int = 8):
        self.params = params.eval()
        self.device = next(params.parameters()).device
        self.sample_rate = sample_rate
        self.audio_max_len_s = audio_max_len_s
        self.batch_size = batch_size
        self.front = FrontendConfig(sample_rate=sample_rate)
        buffer = int(round(audio_max_len_s * sample_rate))
        self.buffer_samples = buffer
        seq = buffer * (self.front.num_mels // 16) // self.front.hop_length // 16
        self.patch = PatchConfig(patches_seq_len=seq)

    def _batch(self, paths: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Host decode into zero-padded buffers → the device patch dict."""
        bufs = np.zeros((len(paths), self.buffer_samples), np.float32)
        lens = np.zeros((len(paths),), np.int32)
        for i, p in enumerate(paths):
            wav = load_audio(p, target_sr=self.sample_rate)
            n = min(len(wav), self.buffer_samples)
            bufs[i, :n] = wav[:n]
            lens[i] = n
        return wav_to_patches(torch.from_numpy(bufs).to(self.device),
                              torch.from_numpy(lens).to(self.device), self.front, self.patch)

    def scene_embeddings(self, paths: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def event_embeddings(self, paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """→ (embeddings (B, T, D), timestamps_ms (B, T))."""
        raise NotImplementedError

    @staticmethod
    def _mean(x: torch.Tensor, dim: int) -> np.ndarray:
        """Mean summed in fp32 and rounded to x's dtype (as jnp.mean of a
        bf16 array), as a float32 numpy array."""
        return x.float().mean(dim=dim).to(x.dtype).float().cpu().numpy()

    @classmethod
    def _avg_pool_seq(cls, hidden: torch.Tensor, k: int = 8) -> np.ndarray:
        """Non-overlapping average pool along the sequence axis (VALID)."""
        b, s, d = hidden.shape
        t = s // k
        return cls._mean(hidden[:, : t * k].reshape(b, t, k, d), 2)

    def _timestamps(self, n: int) -> np.ndarray:
        return np.linspace(0, self.audio_max_len_s * 1000, n)

    def _events(self, hidden: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        pooled = self._avg_pool_seq(hidden)
        ts = np.tile(self._timestamps(pooled.shape[1]), (pooled.shape[0], 1))
        return pooled, ts


class CacoHearEmbedder(_BaseEmbedder):
    def __init__(self, cfg: CacoConfig, params: CacoModel, **kw):
        super().__init__(params, **kw)
        self.cfg = cfg

    @torch.inference_mode()
    def _fwd(self, paths):
        batch = self._batch(paths)
        return get_audio_embedding(self.params, self.cfg, batch["audio_patches"],
                                   batch["audio_time_inds"], batch["audio_freq_inds"],
                                   batch["audio_mask"])

    def scene_embeddings(self, paths):
        emb, _ = self._fwd(paths)
        return emb.float().cpu().numpy()

    def event_embeddings(self, paths):
        _, hidden = self._fwd(paths)
        return self._events(hidden)


class AudioMAEHearEmbedder(_BaseEmbedder):
    def __init__(self, cfg: AudioMAEConfig, params: AudioMAE, **kw):
        super().__init__(params, **kw)
        self.cfg = cfg

    @torch.inference_mode()
    def _fwd(self, paths):
        batch = self._batch(paths)
        return audio_encoder_apply(self.params.encoder, self.cfg.encoder,
                                   batch["audio_patches"], batch["audio_time_inds"],
                                   batch["audio_freq_inds"], batch["audio_mask"],
                                   dtype=self.cfg.dtype)

    def scene_embeddings(self, paths):
        return self._mean(self._fwd(paths), 1)

    def event_embeddings(self, paths):
        return self._events(self._fwd(paths))


# ------------------------------------------------------------ disk contract

def save_scene(outdir: str, filenames, embeddings: np.ndarray, labels):
    assert np.isfinite(embeddings).all()
    os.makedirs(outdir, exist_ok=True)
    for i, name in enumerate(filenames):
        np.save(os.path.join(outdir, f"{name}.embedding.npy"), embeddings[i])
        with open(os.path.join(outdir, f"{name}.target-labels.json"), "w") as f:
            json.dump(labels[i], f)


def save_event(outdir: str, filenames, embeddings, timestamps, labels):
    os.makedirs(outdir, exist_ok=True)
    for i, name in enumerate(filenames):
        np.save(os.path.join(outdir, f"{name}.embedding.npy"), embeddings[i])
        with open(os.path.join(outdir, f"{name}.timestamps.json"), "w") as f:
            json.dump(np.asarray(timestamps[i]).tolist(), f)
        with open(os.path.join(outdir, f"{name}.target-labels.json"), "w") as f:
            json.dump(labels[i], f)


def labels_for_timestamps(event_lists: List[List[dict]], timestamps: np.ndarray):
    """Per-timestamp active labels; events are {'start','end','label'} in ms;
    end is inclusive (+0.0001 in the reference, emb_utils.py:61)."""
    out = []
    for events, ts in zip(event_lists, timestamps):
        rows = []
        for t in ts:
            rows.append([e["label"] for e in events
                         if e["start"] <= t <= e["end"] + 1e-4])
        out.append(rows)
    return out


def memmap_split(outdir: str, embed_task_dir: str, split_name: str,
                 split_data: Dict, embedding_type: str, seed: int = 0):
    """Concatenate per-clip npy files into {split}.embeddings.npy (memmap) +
    pickled labels (+ filename-timestamps for event tasks), shuffled with a
    fixed seed like the reference (embeddings/runner.py:127-128)."""
    files = [os.path.join(outdir, f"{name}.embedding.npy") for name in split_data]
    random.Random(seed).shuffle(files)

    n, dim = 0, None
    for f in files:
        emb = np.load(f)
        if embedding_type == "scene":
            n += 1
            dim = emb.shape[0]
        else:
            n += emb.shape[0]
            dim = emb.shape[1]

    with open(os.path.join(embed_task_dir,
                           f"{split_name}.embedding-dimensions.json"), "w") as fp:
        json.dump((n, dim), fp)

    mm = np.memmap(os.path.join(embed_task_dir, f"{split_name}.embeddings.npy"),
                   dtype=np.float32, mode="w+", shape=(n, dim))
    labels, fname_ts, idx = [], [], 0
    for f in files:
        emb = np.load(f).astype(np.float32)
        with open(f.replace("embedding.npy", "target-labels.json")) as fp:
            lbl = json.load(fp)
        if embedding_type == "scene":
            mm[idx] = emb
            labels.append(lbl)
            idx += 1
        else:
            mm[idx: idx + emb.shape[0]] = emb
            labels += lbl
            with open(f.replace("embedding.npy", "timestamps.json")) as fp:
                ts = json.load(fp)
            slug = f.replace(".embedding.npy", "")
            fname_ts += [(slug, t) for t in ts]
            idx += emb.shape[0]
    mm.flush()

    with open(os.path.join(embed_task_dir, f"{split_name}.target-labels.pkl"), "wb") as fp:
        pickle.dump(labels, fp)
    if embedding_type == "event":
        with open(os.path.join(embed_task_dir,
                               f"{split_name}.filename-timestamps.json"), "w") as fp:
            json.dump(fname_ts, fp)
