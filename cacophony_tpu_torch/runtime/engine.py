"""CacoEngine: batched inference entry points on one device
(cacophony_tpu/runtime/engine.py: embed_audio, embed_texts, score).

- fixed-size batch buckets (pad + mask + slice): every audio bucket is
  `batch_size` clips of `buffer_seconds`, the tail bucket padded with
  zero-length clips whose mask is all zero;
- text length bucketing to {16, 32, 64, max_text_len};
- everything under `torch.inference_mode()`.

On a CUDA device every audio-encoder layer runs the K1 kernel chain; on the
CPU the plain versions.  Not ported yet: the mesh (data parallelism), the
fused frontend kernel (K8, off by default in the JAX engine), captioning
and embed_audio_long.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from cacophony_tpu_torch.configs import CacoConfig, FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples, wav_to_patches
from cacophony_tpu_torch.models.caco import (
    CacoModel,
    contrastive_logits,
    get_audio_embedding,
    get_text_embedding,
)

TEXT_BUCKETS = (16, 32, 64)


class CacoEngine:
    def __init__(self, cfg: CacoConfig, params: CacoModel, *, tokenizer=None,
                 device="cpu", buffer_seconds: float = 10.0, max_text_len: int = 100,
                 batch_size: int = 32, dtype: Optional[torch.dtype] = None):
        """dtype overrides cfg.dtype as the compute dtype; parameters stay
        fp32.  `params` is moved to `device` in place.  On CUDA the fp32
        products (frontend, fp32 path) must be full fp32, so TF32 is turned
        off for matmuls and cuDNN in this process."""
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.front = FrontendConfig()
        self.buffer_samples = int(round(buffer_seconds * self.front.sample_rate))
        # every valid patch of the buffer fits (reference eval_caco.py:321,351)
        self.patch = PatchConfig(patches_seq_len=num_patches_for_samples(
            self.buffer_samples, self.front, PatchConfig()))
        self.max_text_len = max_text_len
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.params = params.to(self.device).eval()

    # ------------------------------------------------------------- helpers

    def _bucket_iter(self, wavs: Iterable[np.ndarray]):
        """One bucket (batch_size zero-padded clips + lengths) at a time."""
        it = iter(wavs)
        while True:
            bufs = np.zeros((self.batch_size, self.buffer_samples), np.float32)
            lens = np.zeros((self.batch_size,), np.int32)
            count = 0
            for w in it:
                k = min(len(w), self.buffer_samples)
                bufs[count, :k] = np.asarray(w, np.float32)[:k]
                lens[count] = k
                count += 1
                if count == self.batch_size:
                    break
            if count == 0:
                return
            yield bufs, lens, count
            if count < self.batch_size:
                return

    def _audio_bucket(self, bufs: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        cfg = self.cfg
        batch = wav_to_patches(torch.from_numpy(bufs).to(self.device),
                               torch.from_numpy(lens).to(self.device),
                               self.front, self.patch, dtype=cfg.dtype)
        emb, _ = get_audio_embedding(self.params, cfg, batch["audio_patches"],
                                     batch["audio_time_inds"], batch["audio_freq_inds"],
                                     batch["audio_mask"])
        return emb

    # -------------------------------------------------------------- public

    @torch.inference_mode()
    def embed_audio(self, wavs: Iterable[np.ndarray]) -> np.ndarray:
        """16 kHz fp32 waveforms → L2-normalized embeddings (n, proj)."""
        out, total = [], 0
        for bufs, lens, count in self._bucket_iter(wavs):
            total += count
            out.append(self._audio_bucket(bufs, lens).cpu().numpy())
        if not out:
            return np.zeros((0, self.cfg.projection_size), np.float32)
        return np.concatenate(out)[:total]

    @torch.inference_mode()
    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize (pad to max_text_len), trim to the smallest length bucket
        covering the longest prompt, embed; → (n, proj) normalized."""
        if self.tokenizer is None:
            raise ValueError("engine needs a tokenizer for text")
        tok = self.tokenizer(list(texts), padding="max_length", truncation=True,
                             max_length=self.max_text_len, return_tensors="np")
        ids = np.asarray(tok["input_ids"], np.int32)
        mask = np.asarray(tok["attention_mask"], np.int32)
        longest = int(mask.sum(axis=1).max()) if len(ids) else 1
        bucket = next((b for b in TEXT_BUCKETS if b >= longest and b < self.max_text_len),
                      self.max_text_len)
        ids, mask = ids[:, :bucket], mask[:, :bucket]
        n = len(ids)
        n_pad = -(-n // self.batch_size) * self.batch_size
        if n_pad != n:
            pad = n_pad - n
            ids = np.concatenate([ids, np.ones((pad, ids.shape[1]), np.int32)])
            mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), np.int32)])
            mask[n:, 0] = 1  # avoid fully-masked softmax rows in padding
        out = []
        for i in range(0, n_pad, self.batch_size):
            emb, _ = get_text_embedding(
                self.params, self.cfg,
                torch.from_numpy(ids[i:i + self.batch_size]).to(self.device),
                torch.from_numpy(mask[i:i + self.batch_size]).to(self.device))
            out.append(emb.cpu().numpy())
        return np.concatenate(out)[:n]

    @torch.inference_mode()
    def score(self, audio_emb: np.ndarray, text_emb: np.ndarray) -> np.ndarray:
        """exp(logit_scale)·A@Tᵀ over the full gallery, on the device."""
        a = torch.as_tensor(np.asarray(audio_emb, np.float32), device=self.device)
        t = torch.as_tensor(np.asarray(text_emb, np.float32), device=self.device)
        return contrastive_logits(self.params, a, t).cpu().numpy()
