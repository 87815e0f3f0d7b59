"""CacoEngine: batched inference entry points on one device
(cacophony_tpu/runtime/engine.py: embed_audio, embed_audio_long,
audio_patch_batch, embed_texts, score, caption).

- fixed-size batch buckets (pad + mask + slice): every audio bucket is
  `batch_size` clips of `buffer_seconds`, the tail bucket padded with
  zero-length clips whose mask is all zero;
- the patch budget is `patches_seq_len` (by default the buffer's patch
  count) rounded up as the JAX engine rounds it (`preferred_seq_len`): a
  30-s buffer has 1496 patches and runs at 1536 in bf16 at caco_base
  width, the extra slots masked;
- a bounded dispatch window: at most DISPATCH_WINDOW buckets in flight,
  each filled in pinned host memory and copied with non_blocking=True, so
  filling the next bucket overlaps the device's work on earlier ones;
- text length bucketing to {16, 32, 64, max_text_len};
- on a card an audio bucket's device work (the copy of its buffers into
  the graph's inputs, the frontend, the encoder, the pooler, the
  normalisation) and the text tower each run as one CUDA graph per shape,
  (rows, buffer samples) or (rows, bucket), captured on the shape's first
  use and replayed for every bucket or chunk after it: the host's launches
  of a bucket's ~280 kernels or a chunk's ~730 were slower than the card.
  A replay casts the live fp32 parameters, so an in-place update of them
  is seen; a parameter tensor replaced by another is not.  The kernels'
  launch counts (`ops/_kernels.py:LAUNCHES`,
  `ops/encoder_attention.py:LAYER_LAUNCHES`) read as eager mode's
  (`CountedGraph`);
- everything under `torch.inference_mode()`;
- spans and counters (utils/profiling.py) while the recorder records:
  `engine.embed_audio` (a request each call) over `engine.fill`,
  `engine.launch` (on the CPU `engine.frontend`, then the model's
  `audio.encoder` and `audio.pooler`; on a card these three fire only
  while a shape is captured, and `engine.launch` holds the replay and the
  copy back) and `engine.retire` per bucket; `engine.embed_texts` (a
  request each call) over `engine.tokenize`, `engine.text_tower` and
  `engine.copy_back`; the counters `engine.buckets`, `engine.clips`,
  `engine.rows` (padding included), `engine.valid_patches`,
  `engine.patch_slots`, `engine.text_prompts` and `engine.text_rows`, and
  on a card `engine.audio_graph_captures` and `engine.text_graph_captures`
  (one a shape), `engine.audio_graph_replays` (one a bucket) and
  `engine.text_graph_replays` (one a chunk).

Each audio-encoder layer takes the JAX package's route for the compute
dtype and sequence length (`ops.encoder_attention.layer_route`): K1, K2 or
K3 on a CUDA device, their plain versions on the CPU, or the einsum layer.
`fused_frontend=True` runs the log-mel through K8 (frontend/fused.py).
`caption` decodes every clip in one batch with KV caches (models/caco.py:
`decode`; a CUDA graph per step on the card).

`mesh=` (a `parallel.make_mesh` mesh) serves data-parallel, as JAX's
`_data_parallel` does: every rank holds rank 0's parameters whole
(`replicate_params`; serving folds tp into data parallelism, as JAX's
engine splits its batch over every mesh axis), runs the single-device
program, kernels included, on its contiguous rows of each bucket — the
batch split over all dp·tp ranks in rank order — and the outputs are
gathered in row order over the whole group, so every rank returns the
whole result.  `score`
and `caption` run unsharded.  Every rank must make the same calls.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from cacophony_tpu_torch.configs import CacoConfig, FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend.fused import fused_batch_wav_to_patches
from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples, wav_to_patches
from cacophony_tpu_torch.models.caco import (
    CacoModel,
    GraphedStep,
    contrastive_logits,
    decode,
    get_audio_embedding,
    get_text_embedding,
)
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.ops.encoder_attention import preferred_seq_len
from cacophony_tpu_torch.parallel.mesh import gather_rows, mesh_rows, replicate_params
from cacophony_tpu_torch.utils.profiling import active, count, span

TEXT_BUCKETS = (16, 32, 64)
DISPATCH_WINDOW = 4  # audio buckets in flight (JAX engine.py:273)
LAUNCH_COUNTS = (kern.LAUNCHES, ea.LAYER_LAUNCHES)  # the kernels' launch counts


class CountedGraph:
    """A `GraphedStep` of fn whose kernel launch counts (`LAUNCH_COUNTS`)
    read as eager mode's: its warm-up and its capture leave them as they
    found them, and each replay adds what the captured call launched."""

    def __init__(self, fn, *inputs: torch.Tensor):
        before = [dict(c) for c in LAUNCH_COUNTS]
        launched = []

        def counted(*xs):  # the last call is the capture's
            start = [dict(c) for c in LAUNCH_COUNTS]
            out = fn(*xs)
            launched[:] = [(c, k, c[k] - s[k]) for c, s in zip(LAUNCH_COUNTS, start)
                           for k in c if c[k] != s[k]]
            return out

        try:
            self.graph = GraphedStep(counted, *inputs)
        finally:
            for c, b in zip(LAUNCH_COUNTS, before):
                c.update(b)
        self.launched = launched

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        out = self.graph(*inputs)
        for c, k, n in self.launched:
            c[k] += n
        return out


def _patch_batch(bufs: torch.Tensor, lens: torch.Tensor, *, front: FrontendConfig,
                 patch: PatchConfig, fused_frontend: bool, dtype: torch.dtype,
                 device: torch.device):
    """Host or device buffers → device patch dict: K8 or the unfused chain."""
    with span("engine.frontend"):
        bufs = bufs.to(device, non_blocking=True)
        lens = lens.to(device, non_blocking=True)
        if fused_frontend:
            return fused_batch_wav_to_patches(bufs, lens, front, patch)
        return wav_to_patches(bufs, lens, front, patch, dtype=dtype)


# The engine's steps hold no reference to the engine: the graphs that keep
# them go with the engine.

def _audio_step(params: CacoModel, cfg: CacoConfig, patches):
    """bufs, lens → unit embeddings on the device through `patches` (a
    `_patch_batch`)."""

    def step(bufs, lens):
        return get_audio_embedding(params, cfg, **patches(bufs, lens))[0]

    return step


def _text_step(params: CacoModel, cfg: CacoConfig):
    """ids, mask → unit embeddings."""

    def step(ids, mask):
        return get_text_embedding(params, cfg, ids, mask)[0]

    return step


class CacoEngine:
    def __init__(self, cfg: CacoConfig, params: CacoModel, *, tokenizer=None,
                 device="cuda", buffer_seconds: float = 10.0,
                 patches_seq_len: Optional[int] = None, max_text_len: int = 100,
                 batch_size: int = 32, dtype: Optional[torch.dtype] = None,
                 fused_frontend: bool = False, mesh=None):
        """dtype overrides cfg.dtype as the compute dtype; parameters stay
        fp32.  `params` is moved to `device` in place.  The engine runs on
        the card unless it is given device="cpu"; with no card it raises.
        On CUDA the fp32 products (frontend, fp32 path) must be full fp32,
        so TF32 is turned off for matmuls and cuDNN in this process, and
        bf16 products outside the kernels sum in fp32 as XLA's do.

        patches_seq_len: the patch budget of every clip (None: every valid
        patch of the buffer fits), rounded by `preferred_seq_len` as the JAX
        engine rounds it with `flash_attention` on — the port always takes
        the kernel routes.  A smaller budget keeps a clip's first patches.

        fused_frontend: compute the log-mel with K8 instead of the unfused
        chain (the same values up to the order of fp32 sums).

        mesh: serve data-parallel over the mesh's ranks (module docstring);
        batch_size must divide over them."""
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"CacoEngine on {self.device}: no CUDA device; pass "
                                   f'device="cpu" to run on the CPU')
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.front = FrontendConfig()
        self.buffer_samples = int(round(buffer_seconds * self.front.sample_rate))
        # by default every valid patch of the buffer fits (reference
        # eval_caco.py:321,351); the whole pipeline runs at the blocked
        # kernel's padded length, the extra slots masked (JAX engine.py:75-89)
        if patches_seq_len is None:
            patches_seq_len = num_patches_for_samples(self.buffer_samples, self.front,
                                                      PatchConfig())
        self.patch = PatchConfig(patches_seq_len=preferred_seq_len(
            patches_seq_len, cfg.audio.hidden_size, cfg.dtype))
        self.max_text_len = max_text_len
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.fused_frontend = fused_frontend
        self.params = params.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            if batch_size % mesh.size() != 0:
                raise ValueError(
                    f"batch_size {batch_size} must divide evenly over the "
                    f"{mesh.size()}-device mesh (each device runs the full model "
                    f"on its batch shard)")
            replicate_params(self.params)
        self.peak_in_flight = 0  # most audio buckets in flight in the last embed_audio
        self._patches = functools.partial(_patch_batch, front=self.front, patch=self.patch,
                                          fused_frontend=fused_frontend, dtype=cfg.dtype,
                                          device=self.device)
        self._audio_step = _audio_step(self.params, cfg, self._patches)
        self._text_step = _text_step(self.params, cfg)
        self._audio_graphs = {}  # (rows, buffer samples) → CountedGraph on a card
        self._text_graphs = {}  # (rows, bucket) → CountedGraph on a card

    # ------------------------------------------------------------- helpers

    def _host(self, shape, dtype) -> torch.Tensor:
        """Uninitialised host tensor, pinned when the device is a card."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _fill(self, wavs: Sequence[np.ndarray], rows: int):
        """(rows, buffer) zero-padded clips + (rows,) lengths in host memory."""
        with span("engine.fill"):
            bufs, lens = self._host((rows, self.buffer_samples), torch.float32), \
                self._host((rows,), torch.int32)
            b, n = bufs.numpy(), lens.numpy()
            n[:] = 0
            for i, w in enumerate(wavs):
                k = min(len(w), self.buffer_samples)
                b[i, :k] = np.asarray(w, np.float32)[:k]
                b[i, k:] = 0.0
                n[i] = k
            b[len(wavs):] = 0.0
        return bufs, lens

    def _bucket_iter(self, wavs: Iterable[np.ndarray]):
        """One bucket (batch_size zero-padded clips + lengths) at a time."""
        it = iter(wavs)
        while True:
            clips = [w for _, w in zip(range(self.batch_size), it)]
            if not clips:
                return
            yield (*self._fill(clips, self.batch_size), len(clips))
            if len(clips) < self.batch_size:
                return

    def _rows(self, n: int) -> slice:
        """This rank's contiguous block of n rows over the whole mesh (all
        of them without a mesh)."""
        return slice(0, n) if self.mesh is None else mesh_rows(n, self.mesh)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh is None else gather_rows(x)

    def _graphed(self, graphs: dict, kind: str, step, *inputs: torch.Tensor) -> torch.Tensor:
        """step(*inputs) on a card as the replay of its CUDA graph for the
        first input's shape, captured on that shape's first use (counters
        `engine.<kind>_graph_captures`, `engine.<kind>_graph_replays`)."""
        key = tuple(inputs[0].shape)
        graph = graphs.get(key)
        if graph is None:
            count(f"engine.{kind}_graph_captures")
            graph = graphs[key] = CountedGraph(step, *(x.to(self.device) for x in inputs))
        count(f"engine.{kind}_graph_replays")
        return graph(*inputs)

    def _count_bucket(self, lens: torch.Tensor, clips: int) -> None:
        """The recorder's counters of one bucket of this rank's rows: valid
        patches from the host lengths, slots of the patch budget."""
        n = lens.numpy()
        count("engine.buckets")
        count("engine.clips", clips)
        count("engine.rows", len(n))
        count("engine.valid_patches", int(np.minimum(
            num_patches_for_samples(n, self.front, self.patch), self.patch.patches_seq_len).sum()))
        count("engine.patch_slots", len(n) * self.patch.patches_seq_len)

    def _audio_bucket(self, bufs: torch.Tensor, lens: torch.Tensor):
        """Launch one bucket → (host embeddings, event or None).  On the
        CPU `_audio_step` runs eagerly; on a card it is the replay of its
        CUDA graph for the bucket's shape (`_graphed`), and the copy back is
        queued behind it without waiting; the event says when it has
        landed.  Under a mesh this rank embeds its rows and the embeddings
        are gathered, outside the graph."""
        with span("engine.launch", device=self.device):
            rows = self._rows(bufs.shape[0])
            if self.device.type != "cuda":
                return self._gather(self._audio_step(bufs[rows], lens[rows])), None
            # the copy back queues behind the replay, before the next replay
            # can overwrite the graph's output
            emb = self._gather(self._graphed(self._audio_graphs, "audio", self._audio_step,
                                             bufs[rows], lens[rows]))
            host = self._host(emb.shape, emb.dtype)
            host.copy_(emb, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return host, done

    @staticmethod
    def _retire(launched) -> np.ndarray:
        host, done = launched
        with span("engine.retire"):
            if done is not None:
                done.synchronize()
            return host.numpy()

    # -------------------------------------------------------------- public

    @torch.inference_mode()
    def embed_audio(self, wavs: Iterable[np.ndarray]) -> np.ndarray:
        """16 kHz fp32 waveforms (a list or any iterable) → L2-normalized
        embeddings (n, proj).

        Buckets are consumed lazily with at most DISPATCH_WINDOW in flight
        (JAX engine.py:266-284): the host fills the next bucket while the
        device works, and waits for a bucket's embeddings only when the
        window is full.  One stream runs the buckets in order, so waiting on
        a bucket's own event (not a blocking copy, which would wait for
        every later bucket too) is what keeps the others in flight."""
        with span("engine.embed_audio", request=True):
            pending, out, total = collections.deque(), [], 0
            self.peak_in_flight = 0
            for bufs, lens, clips in self._bucket_iter(wavs):
                total += clips
                if active():
                    self._count_bucket(lens[self._rows(len(lens))], clips)
                if len(pending) == DISPATCH_WINDOW:
                    out.append(self._retire(pending.popleft()))
                pending.append(self._audio_bucket(bufs, lens))
                self.peak_in_flight = max(self.peak_in_flight, len(pending))
            out.extend(self._retire(p) for p in pending)
            if not out:
                return np.zeros((0, self.cfg.projection_size), np.float32)
            return np.concatenate(out)[:total]

    @torch.inference_mode()
    def audio_patch_batch(self, wavs: Sequence[np.ndarray]):
        """Device patch dict for the clips padded to a multiple of
        batch_size, and the clip count (captioning / HEAR paths)."""
        n = len(wavs)
        bufs, lens = self._fill(wavs, -(-n // self.batch_size) * self.batch_size)
        rows = self._rows(bufs.shape[0])
        batch = self._patches(bufs[rows], lens[rows])
        return {k: self._gather(v) for k, v in batch.items()}, n

    def embed_audio_long(self, wavs: Sequence[np.ndarray], *,
                         overlap_seconds: float = 0.0) -> np.ndarray:
        """Clips of any length: cut each into engine-sized windows (hop =
        buffer − overlap), embed every window, average a clip's normalized
        embeddings and renormalize (JAX engine.py:326-353).  A clip no
        longer than the buffer reduces to embed_audio."""
        hop = self.buffer_samples - int(round(overlap_seconds * self.front.sample_rate))
        if hop <= 0:
            raise ValueError(f"overlap {overlap_seconds} s leaves no hop in a "
                             f"{self.buffer_samples}-sample buffer")
        wavs = list(wavs)  # owners index into the input; chunk views stream
        owners = []

        def chunk_iter():
            for i, w in enumerate(wavs):
                n = max(1, -(-max(len(w) - self.buffer_samples, 0) // hop) + 1)
                for c in range(n):
                    owners.append(i)
                    yield w[c * hop: c * hop + self.buffer_samples]

        emb = self.embed_audio(chunk_iter())
        out = np.zeros((len(wavs), emb.shape[1]), np.float32)
        counts = np.zeros(len(wavs))
        for e, o in zip(emb, owners):
            out[o] += e
            counts[o] += 1
        out /= counts[:, None]
        return out / np.linalg.norm(out, axis=-1, keepdims=True)

    def _text_batch(self, texts: Sequence[str]):
        """Tokenize (pad to max_text_len), trim to the smallest length bucket
        covering the longest prompt, pad the rows to a multiple of
        batch_size → (ids, mask) int32 (rows, bucket) and the prompt count."""
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
        return ids, mask, n

    def _text_tower(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """This rank's rows of one chunk → their embeddings on the device.
        On the CPU `get_text_embedding` runs eagerly; on a card, as the
        replay of a CUDA graph captured on the shape's first use (`_graphed`).
        The graph casts the live parameters in every replay, so an in-place
        update of them is seen without a new capture."""
        ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
        if self.device.type != "cuda":
            return self._text_step(ids, mask)
        return self._graphed(self._text_graphs, "text", self._text_step, ids, mask)

    @torch.inference_mode()
    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Texts → (n, proj) normalized embeddings, batch_size rows at a
        time (`_text_batch`, `_text_tower`)."""
        if self.tokenizer is None:
            raise ValueError("engine needs a tokenizer for text")
        with span("engine.embed_texts", request=True):
            with span("engine.tokenize"):
                ids, mask, n = self._text_batch(texts)
            count("engine.text_prompts", n)
            count("engine.text_rows", len(ids))
            out = []
            for i in range(0, len(ids), self.batch_size):
                with span("engine.text_tower", device=self.device):
                    rows = self._rows(self.batch_size)
                    emb = self._gather(self._text_tower(ids[i:i + self.batch_size][rows],
                                                        mask[i:i + self.batch_size][rows]))
                with span("engine.copy_back"):
                    out.append(emb.cpu().numpy())
            return np.concatenate(out)[:n]

    @torch.inference_mode()
    def score(self, audio_emb: np.ndarray, text_emb: np.ndarray) -> np.ndarray:
        """exp(logit_scale)·A@Tᵀ over the full gallery, on the device."""
        a = torch.as_tensor(np.asarray(audio_emb, np.float32), device=self.device)
        t = torch.as_tensor(np.asarray(text_emb, np.float32), device=self.device)
        return contrastive_logits(self.params, a, t).cpu().numpy()

    @torch.inference_mode()
    def caption(self, wavs: Sequence[np.ndarray], *, max_length: int = 100,
                temperature: float = 0.1, seed: int = 42) -> List[str]:
        """AR captioning with the reference's eval defaults (max 100, T = 0.1,
        seed 42; eval_caco.py:261,271): one patch batch of all clips, decode
        with caches in the compute dtype, sampled from a generator on the
        engine's device seeded with `seed` (torch cannot draw JAX's
        numbers: only near-greedy captions match the JAX engine's)."""
        if self.tokenizer is None:
            raise ValueError("engine needs a tokenizer for captioning")
        batch, n = self.audio_patch_batch(wavs)
        ids = decode(self.params, self.cfg, batch, max_length=max_length, temperature=temperature,
                     bos_id=self.tokenizer.bos_token_id, eos_id=self.tokenizer.eos_token_id,
                     pad_id=self.tokenizer.pad_token_id,
                     generator=torch.Generator(device=self.device).manual_seed(seed))
        return self.tokenizer.batch_decode(ids[:n].cpu().numpy(), skip_special_tokens=True)
