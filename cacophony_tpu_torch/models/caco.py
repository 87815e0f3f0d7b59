"""CACO top-level model: the joint audio-text embedding space and the
caption decoder's parameters (cacophony_tpu/models/caco.py).

- `logit_scale`, `text_proj` and a multi-head single-query audio attention
  pooler (reference caco.py:19-69);
- get_audio_embedding: audio encoder → pooler → L2 normalize;
- get_text_embedding: text encoder → pooler → text_proj → normalize;
- normalization is bug-compatible with the reference: x / ||x + eps||;
- scoring rule exp(logit_scale) · A @ Tᵀ.

With `train=True` the embeddings run the towers' training paths (dropout
from a `torch.Generator`; the stage-2 step in train/train.py).

Captioning (reference caco.py:154-230, JAX caco.py:138-275): teacher-forced
`caption_logits`, and batched KV-cached decode, in which the full text
tower runs (cached) inside every step because the caption decoder reads
text-encoder hidden states.  The JAX loop ends on the device; here the
steps run in windows of DECODE_WINDOW with one host sync per window (steps past
the point where every stream has finished write the 0 that JAX leaves
there), on a CUDA device as one CUDA graph per step (token ids and index
in, fp32 logits out, the caches written in place), sampled outside the
graph from an explicit `torch.Generator`.  The Dense weights of the towers
are cast to the compute dtype once per batch (`cast_dense`).
"""

from __future__ import annotations

import gc
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from cacophony_tpu_torch.configs import CacoConfig
from cacophony_tpu_torch.models.audio import AudioEncoder, audio_encoder_apply
from cacophony_tpu_torch.models.layers import Dense, cast_dense, dense, normal_init
from cacophony_tpu_torch.parallel.tensor import copy_to_tp, gather_from_tp, tp_shard
from cacophony_tpu_torch.utils.profiling import span
from cacophony_tpu_torch.models.text import (
    CaptionDecoder,
    KVCache,
    TextEncoder,
    caption_decoder_apply,
    make_kv_cache,
    precompute_cross_kv,
    text_encoder_apply,
)

NORM_EPS = 1e-10  # reference caco.py:9


class AudioPooler(nn.Module):
    def __init__(self, cfg: CacoConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.audio.hidden_size
        self.kv = Dense(d, 2 * d, generator)
        self.query = nn.Parameter(normal_init((d,), generator, 0.02))
        self.out = Dense(d, cfg.projection_size or d, generator)


class CacoModel(nn.Module):
    """Parameters of the model; names mirror the JAX tree."""

    def __init__(self, cfg: CacoConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.audio = AudioEncoder(cfg.audio, generator)
        self.text = TextEncoder(cfg.text, generator)
        self.audio_pool = AudioPooler(cfg, generator)
        self.text_proj = Dense(cfg.text.hidden_size, cfg.projection_size, generator)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init, dtype=torch.float32))
        if cfg.use_decoder:
            self.decoder = CaptionDecoder(cfg.decoder, generator)


def caco_init(cfg: CacoConfig, generator: torch.Generator) -> CacoModel:
    """Random fp32 parameters drawn from `generator` (on the CPU)."""
    return CacoModel(cfg, generator)


def audio_pooler_apply(p: AudioPooler, cfg: CacoConfig, hidden: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Multi-head single-query attention pool in cfg.dtype; softmax in fp32
    (reference caco.py:19-54).  Under tensor parallelism (`kv` tp-sharded)
    each rank pools its block of the heads: its part of the replicated
    `query` through `copy_to_tp` (the query's gradient is summed over tp),
    the heads' outputs gathered over tp before the replicated `out`."""
    m, hd = cfg.num_attention_pool_heads, cfg.pool_head_dim
    query, tp = p.query, tp_shard(p.kv)
    if tp is not None:
        if m % tp.size:
            raise ValueError(f"tp={tp.size} does not divide {m} pool heads")
        m //= tp.size
        query = copy_to_tp(query, tp.group)[tp.block(query.shape[0])]
    kv = dense(p.kv, hidden, cfg.dtype)
    k, v = kv.chunk(2, dim=-1)
    b, s, _ = k.shape
    k = k.reshape(b, s, m, hd)
    v = v.reshape(b, s, m, hd)
    q = query.reshape(m, hd).to(hidden.dtype)
    # sqrt(hd) in q's dtype, as a Python number (a small tensor copied to the
    # card would wait for the device)
    q = q / float(torch.tensor(float(hd), dtype=q.dtype).sqrt())
    logits = torch.einsum("hd,bjhd->bhj", q, k)
    if mask is not None:
        logits = torch.where(mask[:, None] > 0, logits.float(), torch.finfo(torch.float32).min)
    w = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
    out = torch.einsum("bhj,bjhd->bhd", w, v).reshape(b, m * hd)
    if tp is not None:
        out = gather_from_tp(out, tp.group)
    return dense(p.out, out, cfg.dtype)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Bug-compatible L2 normalize in fp32: x / ||x + eps|| (reference caco.py:91)."""
    x = x.float()
    return x / torch.linalg.vector_norm(x + NORM_EPS, dim=-1, keepdim=True)


def get_audio_embedding(p: CacoModel, cfg: CacoConfig, audio_patches, audio_time_inds,
                        audio_freq_inds, audio_mask, *, normalize: bool = True,
                        train: bool = False, generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (embedding (B, proj), hidden (B, S, D)).  Reference caco.py:72-96.
    Spans `audio.encoder` and `audio.pooler` (utils/profiling.py)."""
    with span("audio.encoder"):
        hidden = audio_encoder_apply(p.audio, cfg.audio, audio_patches, audio_time_inds,
                                     audio_freq_inds, audio_mask, dtype=cfg.dtype, train=train,
                                     generator=generator)
    with span("audio.pooler"):
        emb = audio_pooler_apply(p.audio_pool, cfg, hidden, audio_mask)
    return (_normalize(emb) if normalize else emb), hidden


def get_text_embedding(p: CacoModel, cfg: CacoConfig, text_input_ids, text_mask, *,
                       normalize: bool = True, train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (embedding (B, proj), hidden (B, S, D)).  Reference caco.py:99-123.
    text_proj runs without a dtype, so a bf16 pooled vector promotes to fp32."""
    pooled, hidden = text_encoder_apply(p.text, cfg.text, text_input_ids, text_mask,
                                        dtype=cfg.dtype, train=train, generator=generator)
    emb = dense(p.text_proj, pooled)
    return (_normalize(emb) if normalize else emb), hidden


def contrastive_logits(p: CacoModel, audio_emb: torch.Tensor,
                       text_emb: torch.Tensor) -> torch.Tensor:
    """exp(logit_scale) · A @ Tᵀ (embeddings must be normalized)."""
    return torch.exp(p.logit_scale) * audio_emb @ text_emb.T


def caption_logits(p: CacoModel, cfg: CacoConfig, text_input_ids, text_mask, audio_hidden,
                   audio_mask, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Teacher-forced caption logits (B, S, V) in fp32: the causal text
    encoder, then the cross-attention decoder (JAX caco.py:125-150)."""
    _, text_hidden = text_encoder_apply(p.text, cfg.text, text_input_ids, text_mask, pool=False,
                                        dtype=cfg.dtype, train=train, generator=generator)
    logits = caption_decoder_apply(p.decoder, cfg.decoder, text_hidden, text_mask, audio_hidden,
                                   audio_mask, train=train, generator=generator, dtype=cfg.dtype)
    return logits.float()


# ------------------------------------------------------------------ decode

DECODE_WINDOW = 16  # decode steps between two host checks for finished streams


class DecodeState(NamedTuple):
    """Decode state, written in place.  The caches share `index`."""

    text_cache: KVCache
    dec_cache: KVCache
    input_ids: torch.Tensor      # (B, max_length) int32
    index: torch.Tensor          # () int32, or (B,) per slot (runtime/continuous.py)
    is_generating: torch.Tensor  # (B,) int32


def init_decode_state(cfg: CacoConfig, batch: int, max_length: int, bos_id: int, device,
                      per_slot: bool = False) -> DecodeState:
    """Zeroed caches in the compute dtype, ids with BOS at position 0, every
    stream generating; one index, scalar or per slot."""
    index = torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device)
    ids = torch.zeros((batch, max_length), dtype=torch.int32, device=device)
    ids[:, 0] = bos_id
    return DecodeState(make_kv_cache(cfg.text, batch, max_length, cfg.dtype, device, index),
                       make_kv_cache(cfg.decoder, batch, max_length, cfg.dtype, device, index),
                       ids, index, torch.ones(batch, dtype=torch.int32, device=device))


def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature, then top-k (ties at the k-th value kept), then nucleus
    (the smallest sorted prefix whose cumulative probability reaches top_p,
    the best always kept), written as JAX writes them (caco.py:163-186):
    the logits with every token outside the admissible set at -inf."""
    logits = logits / temperature
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample_logits(generator: Optional[torch.Generator], logits: torch.Tensor, *,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """A categorical draw over `filter_logits`, made as jax.random.categorical
    makes it: the argmax of the logits plus Gumbel noise, here drawn from
    `generator` (no host sync) → (B,) int32."""
    logits = filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def step_logits(text_p, dec_p, cfg: CacoConfig, state: DecodeState, current: torch.Tensor,
                cross_kv, audio_mask: torch.Tensor) -> torch.Tensor:
    """The model half of one step: the (B,) current tokens at the state's
    index through the cached text tower and decoder → fp32 logits (B, V);
    both caches written at the index, which is left as it is."""
    b = current.shape[0]
    ones = torch.ones((b, 1), dtype=torch.int32, device=current.device)
    pos = state.index.expand(b)[:, None]
    _, text_hidden = text_encoder_apply(text_p, cfg.text, current[:, None], ones,
                                        position_ids=pos, cache=state.text_cache, pool=False,
                                        dtype=cfg.dtype)
    logits = caption_decoder_apply(dec_p, cfg.decoder, text_hidden, ones, None, audio_mask,
                                   cache=state.dec_cache, cross_kv=cross_kv, dtype=cfg.dtype)
    return logits[:, 0].float()


class GraphedStep:
    """fn(*inputs) → output, captured once in a CUDA graph after one warm-up
    call on a side stream.  Calling it copies each input into the graph's
    buffer for it (a host tensor without waiting for the card) and replays;
    the output comes back in the graph's output buffer, overwritten by the
    next replay.  fn must read and write only tensors that outlive the
    graph (decode: the caches, the index, the cross K/V, the weights; the
    engine's audio bucket and text tower: the parameters, read live, and
    the frontend's device tables, cached for the process): the graph keeps
    fn, and with it what fn's closure holds.  A capture that fails raises."""

    def __init__(self, fn: Callable[..., torch.Tensor], *inputs: torch.Tensor):
        self.fn = fn  # keeps what the graph reads alive (the weights in fn's closure)
        self.inputs = tuple(x.clone() for x in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # No cyclic garbage collection during capture: freeing another
        # object's CUDA graph there is an operation capture forbids, and it
        # invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.output = fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x, non_blocking=True)
        self.graph.replay()
        return self.output


def decode_step(step: Callable[[torch.Tensor], torch.Tensor], state: DecodeState, *,
                temperature: float, eos_id: int, pad_id: int,
                generator: Optional[torch.Generator], top_k: Optional[int] = None,
                top_p: Optional[float] = None) -> torch.Tensor:
    """One AR step on a scalar-index state, in place (JAX caco.py:191-222;
    reference loop body caco.py:178-202): finished streams feed pad_id;
    `step` maps the current tokens to fp32 logits; the sampled id times the
    generating flag goes to index + 1 (bug-compatible with reference
    caco.py:199: a finished stream writes id 0, not pad); a stream stops at
    EOS; the index advances.  No host sync.  → the step's logits."""
    g = state.is_generating
    b = g.shape[0]
    here = state.index.long().view(1, 1).expand(b, 1)
    current = state.input_ids.gather(1, here)[:, 0]
    current = current * g + (1 - g) * pad_id
    logits = step(current)
    sampled = sample_logits(generator, logits, temperature=temperature, top_k=top_k,
                            top_p=top_p)
    state.input_ids.scatter_(1, here + 1, (sampled * g)[:, None])
    g.mul_((sampled != eos_id).to(torch.int32))
    state.index.add_(1)
    return logits


class BatchDecoder:
    """Batched KV-cached decode of one audio batch (JAX `decode`,
    caco.py:225-275).  Building it runs the audio pass (the audio encoder's
    kernels) and the cross K/V, zeroes the caches and, on a CUDA device
    unless cuda_graph=False, captures the step in a CUDA graph.  `steps(n)`
    runs up to n steps without a host sync; `finished()` is one sync."""

    def __init__(self, p: CacoModel, cfg: CacoConfig, audio_batch: dict, *, max_length: int,
                 temperature: float, bos_id: int, eos_id: int, pad_id: int,
                 generator: Optional[torch.Generator], top_k: Optional[int] = None,
                 top_p: Optional[float] = None, cuda_graph: Optional[bool] = None):
        _, audio_hidden = get_audio_embedding(
            p, cfg, audio_batch["audio_patches"], audio_batch["audio_time_inds"],
            audio_batch["audio_freq_inds"], audio_batch["audio_mask"], normalize=False)
        self.audio_mask = audio_batch["audio_mask"]
        device = audio_hidden.device
        b = audio_hidden.shape[0]
        self.cross_kv = precompute_cross_kv(p.decoder.blocks, cfg.decoder, audio_hidden,
                                            cfg.dtype)
        self.state = init_decode_state(cfg, b, max_length, bos_id, device)
        self.max_length = max_length
        self.steps_done = 0
        self.logits = None
        self.sampling = dict(temperature=temperature, eos_id=eos_id, pad_id=pad_id,
                             generator=generator, top_k=top_k, top_p=top_p)
        text_p, dec_p = cast_dense(p.text, cfg.dtype), cast_dense(p.decoder, cfg.dtype)
        state, cross_kv, audio_mask = self.state, self.cross_kv, self.audio_mask

        def step(current):  # holds no reference to self: the graph is freed with it
            return step_logits(text_p, dec_p, cfg, state, current, cross_kv, audio_mask)

        if cuda_graph is None:
            cuda_graph = device.type == "cuda"
        self.step = GraphedStep(step, self.state.input_ids[:, 0]) if cuda_graph else step

    @property
    def steps_left(self) -> int:
        return self.max_length - 1 - self.steps_done

    def steps(self, n: int) -> None:
        """Up to n more steps (never past max_length − 1 in all)."""
        for _ in range(min(n, self.steps_left)):
            self.logits = decode_step(self.step, self.state, **self.sampling)
            self.steps_done += 1

    def finished(self) -> bool:
        return self.steps_left == 0 or not bool(self.state.is_generating.any())

    def run(self) -> torch.Tensor:
        """Windows of DECODE_WINDOW steps until every stream has finished or
        the ids are full → ids (B, max_length) int32."""
        while not self.finished():
            self.steps(DECODE_WINDOW)
        return self.state.input_ids


def decode(p: CacoModel, cfg: CacoConfig, audio_batch: dict, *, max_length: int,
           temperature: float, bos_id: int, eos_id: int, pad_id: int,
           generator: Optional[torch.Generator], top_k: Optional[int] = None,
           top_p: Optional[float] = None, cuda_graph: Optional[bool] = None) -> torch.Tensor:
    """Batched temperature (top-k, top-p) sampling with KV caches → ids
    (B, max_length) int32, BOS first (reference caco.py:154-230)."""
    return BatchDecoder(p, cfg, audio_batch, max_length=max_length, temperature=temperature,
                        bos_id=bos_id, eos_id=eos_id, pad_id=pad_id, generator=generator,
                        top_k=top_k, top_p=top_p, cuda_graph=cuda_graph).run()
