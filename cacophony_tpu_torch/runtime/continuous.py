"""Continuous-batching captioning: a slotted AR decode server
(cacophony_tpu/runtime/continuous.py).

The reference decodes one batch at a time, so a batch waits for its slowest
caption (caco.py:154-230).  Here `num_slots` decode slots advance together,
each with its own cache index and token stream, and a finished slot is
refilled from the request stream without stopping the others.

- `_encode_many`: the audio encoder and the cross K/V of a group of new
  requests, launched as soon as they are pulled, so the device runs them
  behind the decode window in flight.
- `_scatter_many`: places encoded requests into free slots (their caches
  zeroed, BOS at position 0, index 0, active).
- `_step`: one token for every slot with a per-slot (B,) index.  Inactive
  slots feed pad and do not advance; the id write is guarded (a finished
  row never changes, unlike batch decode's `sampled * g`); a slot stops at
  EOS or when its next index would reach max_length − 1.
- A window of `drain_every` steps runs without a host sync; then the host
  reads the (B,) active flags once, and the ids once if a slot finished.

On a CUDA device the step's model half is one CUDA graph
(models/caco.py:GraphedStep) over the whole slot state, which lives in
fixed buffers written in place; sampling runs outside the graph.  Every
slot shares one index with both caches.  JAX advances the cache indices of
inactive slots too (their writes past the end are dropped); no output
depends on an inactive slot's cache, and here its index stays where it is,
so every cache write stays in range.  Groups are encoded at their own size:
the trash row of the JAX server, which let one compiled shape take any
refill count, has nothing to do here.

Requests shorter than the server's audio budget are zero-padded with a zero
mask (how the engine pads within a bucket); longer ones raise ValueError.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cacophony_tpu_torch.configs import CacoConfig
from cacophony_tpu_torch.models.caco import (
    CacoModel,
    GraphedStep,
    get_audio_embedding,
    init_decode_state,
    sample_logits,
    step_logits,
)
from cacophony_tpu_torch.models.layers import cast_dense
from cacophony_tpu_torch.models.text import KVCache, precompute_cross_kv

_PATCH_KEYS = ("audio_patches", "audio_time_inds", "audio_freq_inds", "audio_mask")


class SlotState(NamedTuple):
    """The server's state on the device, written in place."""

    text_cache: KVCache        # (L, B, T, E) merged; index (B,) shared
    dec_cache: KVCache
    cross_kv: Tuple[torch.Tensor, torch.Tensor]  # (L, B, H, S_audio, Dh)
    audio_mask: torch.Tensor   # (B, S_audio)
    input_ids: torch.Tensor    # (B, max_length) int32
    index: torch.Tensor        # (B,) int32, the per-slot decode position
    active: torch.Tensor       # (B,) int32, 1 = generating


class ContinuousCaptioner:
    def __init__(self, cfg: CacoConfig, params: CacoModel, tokenizer, *, num_slots: int = 16,
                 max_length: int = 100, temperature: float = 0.1, seed: int = 42,
                 drain_every: int = 8, audio_seq_len: Optional[int] = None,
                 device="cuda"):
        """drain_every: tokens decoded per host sync (1 syncs every token; a
        finished slot idles at most drain_every − 1 steps before refill).
        audio_seq_len: the audio patch budget; None takes the first
        request's (shorter later requests are padded, longer rejected).
        Runs on the card unless given device="cpu"; with no card it raises.
        On CUDA, TF32 and reduced-precision bf16 reductions are turned off
        for this process, as CacoEngine does.  `params` moves to `device`
        in place."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"ContinuousCaptioner on {self.device}: no CUDA device; "
                                   f'pass device="cpu" to run on the CPU')
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.cfg = cfg
        self.params = params.to(self.device).eval()
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        self.max_length = max_length
        self.temperature = temperature
        self.drain_every = drain_every
        self.audio_seq_len = audio_seq_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.tokens_generated = 0  # tokens sampled for active slots in the last run
        self.state: Optional[SlotState] = None

    # ---------------------------------------------------------------- state

    def init_state(self, audio_seq_len: int) -> SlotState:
        b, cfg, ld = self.num_slots, self.cfg, self.cfg.decoder
        ds = init_decode_state(cfg, b, self.max_length, self.tokenizer.bos_token_id,
                               self.device, per_slot=True)
        ds.input_ids.zero_()
        ds.is_generating.zero_()
        shape = (ld.num_layers, b, ld.num_heads, audio_seq_len, ld.head_dim)
        cross = (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=cfg.dtype, device=self.device))
        mask = torch.zeros((b, audio_seq_len), dtype=torch.int32, device=self.device)
        return SlotState(ds.text_cache, ds.dec_cache, cross, mask, ds.input_ids, ds.index,
                         ds.is_generating)

    def _indices(self, values: List[int]) -> torch.Tensor:
        """A small int64 index tensor on the device, copied without a sync."""
        t = torch.tensor(values, dtype=torch.int64)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -------------------------------------------------------------- prefill

    def _encode_many(self, batch: Dict[str, torch.Tensor]) -> dict:
        """Audio encoder + cross K/V for P clips (independent of the slots)."""
        _, hidden = get_audio_embedding(self.params, self.cfg, *(batch[k] for k in _PATCH_KEYS),
                                        normalize=False)
        k, v = precompute_cross_kv(self.params.decoder.blocks, self.cfg.decoder, hidden,
                                   self.cfg.dtype)
        return {"k": k, "v": v, "audio_mask": batch["audio_mask"]}

    def _scatter_many(self, slots: List[int], rows: List[int], enc: dict) -> None:
        """Encoded rows `rows` into free slots `slots`: caches zeroed, the
        cross K/V and audio mask placed, ids = BOS then zeros, index 0,
        active."""
        st, sl, rw = self.state, self._indices(slots), self._indices(rows)
        for cache in (st.text_cache, st.dec_cache):
            cache.k.index_fill_(1, sl, 0)
            cache.v.index_fill_(1, sl, 0)
        st.cross_kv[0].index_copy_(1, sl, enc["k"].index_select(1, rw).to(st.cross_kv[0].dtype))
        st.cross_kv[1].index_copy_(1, sl, enc["v"].index_select(1, rw).to(st.cross_kv[1].dtype))
        st.audio_mask.index_copy_(0, sl, enc["audio_mask"].index_select(0, rw).to(torch.int32))
        st.input_ids.index_fill_(0, sl, 0)
        st.input_ids[:, 0].index_fill_(0, sl, self.tokenizer.bos_token_id)
        st.index.index_fill_(0, sl, 0)
        st.active.index_fill_(0, sl, 1)

    # ----------------------------------------------------------------- step

    def _model_step(self):
        """current (B,) → fp32 logits: the graph on a card, eager on the CPU."""
        cfg, st = self.cfg, self.state
        text_p, dec_p = cast_dense(self.params.text, cfg.dtype), \
            cast_dense(self.params.decoder, cfg.dtype)

        def step(current):
            return step_logits(text_p, dec_p, cfg, st, current, st.cross_kv, st.audio_mask)

        if self.device.type == "cuda":
            return GraphedStep(step, st.input_ids[:, 0])
        return step

    def _step(self, model_step, tokens: torch.Tensor) -> None:
        """One token for every active slot, in place (JAX `_step_body`)."""
        st, t = self.state, self.max_length
        g = st.active
        pad, eos = self.tokenizer.pad_token_id, self.tokenizer.eos_token_id
        current = st.input_ids.gather(1, st.index.long()[:, None])[:, 0]
        current = current * g + (1 - g) * pad
        logits = model_step(current)
        sampled = sample_logits(self.generator, logits, temperature=self.temperature)
        new_index = st.index + g
        at = new_index.clamp(max=t - 1).long()[:, None]
        old = st.input_ids.gather(1, at)
        st.input_ids.scatter_(1, at, torch.where(g[:, None] > 0, sampled[:, None], old))
        still = (sampled != eos) & (new_index < t - 1)
        tokens.add_(g.sum())
        st.active.mul_(still.to(torch.int32))
        st.index.copy_(new_index)

    # ---------------------------------------------------------------- serve

    def _prefill_sizes(self) -> List[int]:
        """Group sizes for encoding: a full fill, and a small one for
        trickle refills (JAX's compiled prefill shapes)."""
        return sorted({max(1, self.num_slots // 8), self.num_slots})

    def _pad_request(self, req: dict, seq: int) -> dict:
        """Zero-pad a (1, S, ...) patch dict to the server's audio budget
        (mask 0 on the padding, as the engine pads a bucket)."""
        s = req["audio_patches"].shape[1]
        if s > seq:
            raise ValueError(f"request audio seq {s} exceeds the server budget {seq}; "
                             f"construct the server with audio_seq_len>={s}")
        if s == seq:
            return req
        out = {}
        for k in _PATCH_KEYS:
            x = req[k]
            if isinstance(x, np.ndarray):
                out[k] = np.pad(x, [(0, 0), (0, seq - s)] + [(0, 0)] * (x.ndim - 2))
            else:
                out[k] = F.pad(x, (0, 0) * (x.dim() - 2) + (0, seq - s))
        return out

    def _stack_requests(self, reqs: List[dict], seq: int) -> Dict[str, torch.Tensor]:
        """Padded requests stacked into one (P, ...) batch on the device:
        numpy requests stacked on the host and copied once per field."""
        reqs = [self._pad_request(r, seq) for r in reqs]
        out = {}
        for k in _PATCH_KEYS:
            if all(isinstance(r[k], np.ndarray) for r in reqs):
                t = torch.from_numpy(np.concatenate([r[k] for r in reqs], axis=0))
                if self.device.type == "cuda":
                    t = t.pin_memory()
                out[k] = t.to(self.device, non_blocking=True)
            else:
                out[k] = torch.cat([torch.as_tensor(r[k]).to(self.device) for r in reqs])
        return out

    @torch.inference_mode()
    def run(self, patch_batches: Iterable[dict]) -> List[str]:
        """Caption a stream of single-clip patch dicts (leading dim 1 each:
        slices of CacoEngine.audio_patch_batch, torch tensors on any device,
        or numpy dicts).  Requests are pulled lazily as slots free up; a
        full fill of lookahead is encoded ahead; captions come back in
        arrival order."""
        it = iter(patch_batches)
        results: List[Optional[str]] = []
        slot_owner = [-1] * self.num_slots
        queue: List[dict] = []       # pulled, not yet encoded (arrival order)
        queue_idx: List[int] = []
        pending: List[list] = []     # encoded groups: [enc, request ids, placed flags]
        exhausted = False
        sizes = self._prefill_sizes()
        self.state, model_step = None, None
        tokens = torch.zeros((), dtype=torch.int64, device=self.device)

        def pull(target: int):
            nonlocal exhausted
            while not exhausted and len(queue) < target:
                try:
                    req = next(it)
                except StopIteration:
                    exhausted = True
                    return
                queue.append(req)
                queue_idx.append(len(results))
                results.append(None)

        def encode_ahead(seq: int):
            nonlocal queue, queue_idx
            while queue:
                n = min(len(queue), sizes[-1])
                p = next(sz for sz in sizes if sz >= n)
                if p > n and not exhausted and pending:
                    break  # wait for a fuller group unless the stream ended
                group, queue = queue[:n], queue[n:]
                gidx, queue_idx = queue_idx[:n], queue_idx[n:]
                enc = self._encode_many(self._stack_requests(group, seq))
                pending.append([enc, gidx, [False] * n])

        def scatter_pending(free: List[int]):
            for entry in pending:
                if not free:
                    break
                enc, gidx, placed = entry
                slots, rows = [], []
                for i in range(len(gidx)):
                    if not placed[i] and free:
                        s = free.pop(0)
                        slots.append(s)
                        rows.append(i)
                        placed[i] = True
                        slot_owner[s] = gidx[i]
                if slots:
                    self._scatter_many(slots, rows, enc)
            pending[:] = [e for e in pending if not all(e[2])]

        pull(self.num_slots)
        while True:
            free = [s for s in range(self.num_slots) if slot_owner[s] < 0]
            pull(max(1, self.num_slots - sum(len(e[1]) for e in pending)))
            if not queue and not pending and exhausted and all(o < 0 for o in slot_owner):
                break
            if self.state is None:
                self.state = self.init_state(self.audio_seq_len
                                             or queue[0]["audio_patches"].shape[1])
            encode_ahead(self.state.audio_mask.shape[1])
            scatter_pending(free)
            if model_step is None:
                model_step = self._model_step()
            for _ in range(self.drain_every):
                self._step(model_step, tokens)
            active = self.state.active.cpu().numpy()  # the window's one sync
            finished = [s for s in range(self.num_slots) if slot_owner[s] >= 0 and active[s] == 0]
            if finished:
                ids = self.state.input_ids.cpu().numpy()
                caps = self.tokenizer.batch_decode(ids[finished], skip_special_tokens=True)
                for s, cap in zip(finished, caps):
                    results[slot_owner[s]] = cap.strip()
                    slot_owner[s] = -1
        self.tokens_generated = int(tokens)
        return results
