"""Causal RoBERTa-style text encoder, its attention pooler, and the caption
decoder (cacophony_tpu/models/text.py), in full-sequence mode and in the
KV-cached single-token mode of decode.

- embeddings = word + absolute position (arange; past the table's last row
  the position clamps to it, as JAX's gather does) + token-type row 0,
  LayerNorm (eps 1e-5), dropout, cast to the compute dtype (reference
  :92-129);
- post-LN blocks: self-attention → LN(dropout(h) + x) → [cross-attention
  → LN(dropout(h) + x)] → gelu-exact MLP → LN(dropout(h) + x) (reference
  :295-428), causal by default (reference :385);
- single learned-query attention pooler (reference :510-536);
- the caption decoder: text-encoder hidden states through cross-attention
  blocks over the audio hidden states, then the vocab projection (:606-627).

The text towers run no kernel: the JAX package keeps their attention on the
einsum path with an additive causal bias (`TEXT_ATTN_KERNEL = False`,
text.py:90, :417-418), and so does the port.  With `train=True` the
attention probabilities and the hidden states go through dropout drawn
from a `torch.Generator`.

Decode keeps JAX's merged cache layout, (L, B, T, E) k and v per tower in
the compute dtype, but as a `KVCache` of preallocated tensors written in
place (the JAX functions return a new cache): layer l writes its (B, 1, E)
k/v slice right after its own attention, which is what JAX's single write
after the stack computes, since each layer reads only its own cache.  The
towers read and write at `cache.index` and leave it as it is; the decode
step advances it once, after both towers.  The cross-attention K/V of the
decoder are computed once per utterance (`precompute_cross_kv`) and kept
head-major, (L, B, H, S_mem, Dh), where JAX keeps merged rows.

Under tensor parallelism (`parallel.shard_params`) the full-sequence
blocks run Megatron's split through `multi_head_attention` and `dense`
(each rank's heads, its block of the MLP's hidden features), and a
vocabulary head that tp divides gives each rank its block of the logits
(train/losses.py takes the cross-entropy over the blocks).  Decode runs
on whole parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from cacophony_tpu_torch.configs import TextConfig
from cacophony_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    act_dense,
    dense,
    dropout,
    gelu_exact,
    layer_norm,
    mask_to_bias,
    normal_init,
)
from cacophony_tpu_torch.ops.attention import (
    Attention,
    CrossAttention,
    attend,
    multi_head_attention,
)

_STD = 0.02


class TextBlock(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        self.attn = Attention(d, generator, _STD)
        self.ln_attn = LayerNorm(d)
        self.mlp_in = Dense(d, cfg.intermediate_size, generator, _STD)
        self.mlp_out = Dense(cfg.intermediate_size, d, generator, _STD)
        self.ln_mlp = LayerNorm(d)
        if cfg.cross_attention:
            self.cross = CrossAttention(d, generator, _STD)
            self.ln_cross = LayerNorm(d)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        self.word = nn.Parameter(normal_init((cfg.vocab_size, d), generator, _STD))
        self.position = nn.Parameter(normal_init((cfg.max_position_embeddings, d), generator, _STD))
        self.token_type = nn.Parameter(normal_init((cfg.type_vocab_size, d), generator, _STD))
        self.ln = LayerNorm(d)


class TextPooler(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        self.key = Dense(d, d, generator, _STD)
        self.value = Dense(d, d, generator, _STD)
        self.query = nn.Parameter(normal_init((1, d), generator, _STD))


class TextEncoder(nn.Module):
    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg, generator)
        self.blocks = nn.ModuleList(TextBlock(cfg, generator) for _ in range(cfg.num_layers))
        self.pooler = TextPooler(cfg, generator)


class CaptionDecoder(nn.Module):
    """Cross-attention text blocks and the vocab projection (JAX
    `caption_decoder_init`, text.py:141-147)."""

    def __init__(self, cfg: TextConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.cross_attention:
            raise ValueError("the caption decoder needs cross_attention=True")
        self.blocks = nn.ModuleList(TextBlock(cfg, generator) for _ in range(cfg.num_layers))
        self.vocab_proj = Dense(cfg.hidden_size, cfg.vocab_size, generator, 0.01)


class KVCache(NamedTuple):
    """A tower's decode cache: k, v (L, B, T, E) in the compute dtype and the
    int32 write index, () or per sample (B,), all written in place."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor


def make_kv_cache(cfg: TextConfig, batch: int, max_length: int,
                  dtype: torch.dtype = torch.float32, device=None,
                  index: Optional[torch.Tensor] = None) -> KVCache:
    """Zeroed merged (L, B, T, E) k/v (JAX text.py:150-168) with the given
    index tensor (shared between towers and the decode state), or a new
    scalar one at 0."""
    shape = (cfg.num_layers, batch, max_length, cfg.hidden_size)
    if index is None:
        index = torch.zeros((), dtype=torch.int32, device=device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), index)


def _write_kv(cache: KVCache, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Layer `layer`'s (B, 1, E) k/v into the cache at cache.index: one
    position for a scalar index, one row per sample for a (B,) index (JAX
    text.py:294-313).  The index stays on the device: no host sync."""
    idx = cache.index
    for buf, new in ((cache.k[layer], k), (cache.v[layer], v)):
        new = new.to(buf.dtype)
        if idx.dim() == 0:
            buf.index_copy_(1, idx.view(1).long(), new)
        else:
            rows = torch.arange(buf.shape[0], device=buf.device)
            buf[rows, idx.long()] = new[:, 0]


def _post_ln_residual(ln: LayerNorm, h, residual, eps: float, generator, rate: float,
                      det: bool):
    """RoBERTa post-LN wrapper: LN(dropout(h) + residual) (reference
    :295-312, :363-380)."""
    return layer_norm(ln, dropout(generator, h, rate, det) + residual, eps)


def _text_block(p: TextBlock, x, cfg: TextConfig, bias, dtype, *, memory=None,
                memory_bias=None, kv_cache=None, cross_kv=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
    """Post-LN block (JAX `_text_block`, text.py:179-250).  Decode mode
    (`kv_cache` = the layer's (B, T, E) k/v): S == 1, → (x, (k, v) slice);
    `cross_kv` = the layer's precomputed (B, H, S_mem, Dh) cross K/V, used
    in place of `memory`.  Full mode → x."""
    det = not train
    eps = cfg.layer_norm_eps
    attn_rate = 0.0 if det else cfg.attention_dropout
    h = multi_head_attention(p.attn, x, num_heads=cfg.num_heads, bias=bias, kv_cache=kv_cache,
                             dtype=dtype, dropout_rate=attn_rate, generator=generator)
    if kv_cache is not None:
        h, kv_slice = h
    x = _post_ln_residual(p.ln_attn, h, x, eps, generator, cfg.hidden_dropout, det)
    if cross_kv is not None:
        q = dense(p.cross.q, x, dtype)
        h = attend(q, cross_kv[0].to(q.dtype), cross_kv[1].to(q.dtype), memory_bias,
                   cfg.num_heads)
        h = dense(p.cross.o, h, dtype)
        x = _post_ln_residual(p.ln_cross, h, x, eps, generator, cfg.hidden_dropout, det)
    elif memory is not None:
        h = multi_head_attention(p.cross, x, num_heads=cfg.num_heads, bias=memory_bias,
                                 memory=memory, dtype=dtype, dropout_rate=attn_rate,
                                 generator=generator)
        x = _post_ln_residual(p.ln_cross, h, x, eps, generator, cfg.hidden_dropout, det)
    h = act_dense(p.mlp_out, dense(p.mlp_in, x, dtype), gelu_exact, dtype)
    x = _post_ln_residual(p.ln_mlp, h, x, eps, generator, cfg.hidden_dropout, det)
    return (x, kv_slice) if kv_cache is not None else x


def _run_blocks(blocks, x, cfg: TextConfig, bias, dtype, *, cache: Optional[KVCache] = None,
                cross_kv=None, **kw):
    """The layer stack; with a cache, each layer's k/v slice is written
    right after the layer (the index is left for the caller to advance)."""
    for layer, blk in enumerate(blocks):
        if cache is None:
            x = _text_block(blk, x, cfg, bias, dtype, **kw)
            continue
        ckv = None if cross_kv is None else (cross_kv[0][layer], cross_kv[1][layer])
        x, (k, v) = _text_block(blk, x, cfg, bias, dtype, kv_cache=(cache.k[layer],
                                                                    cache.v[layer]),
                                cross_kv=ckv, **kw)
        _write_kv(cache, layer, k, v)
    return x


def _causal_bias(text_mask: torch.Tensor) -> torch.Tensor:
    """Padding mask ∧ causal triangle → (B, 1, S, S) additive bias (reference :210-218)."""
    s = text_mask.shape[-1]
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=text_mask.device))
    combined = causal[None] & (text_mask[:, None, :] > 0)
    return mask_to_bias(combined)[:, None]


def _decode_bias(max_length: int, index: torch.Tensor) -> torch.Tensor:
    """Single-position decode over a read-only cache: cached positions
    strictly below the write index are valid (the current token's k/v is
    attended inside the attention op).  index () → (1, 1, 1, T); index (B,)
    → (B, 1, 1, T) (JAX text.py:325-336)."""
    pos = torch.arange(max_length, device=index.device)
    if index.dim() == 0:
        return mask_to_bias(pos < index)[None, None, None, :]
    return mask_to_bias(pos[None, :] < index[:, None])[:, None, None, :]


def text_pooler_apply(p: TextPooler, hidden: torch.Tensor, mask: Optional[torch.Tensor],
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Single learned-query attention pool; softmax statistics in fp32."""
    d = hidden.shape[-1]
    # √d in hidden's dtype, a 0-d tensor filled on hidden's device: a
    # small tensor copied to the card would wait for it, and a CUDA graph
    # cannot capture the copy; a Python divisor would multiply by its
    # reciprocal on the card, where a tensor divides
    key = dense(p.key, hidden, dtype) / torch.full(
        (), float(d), dtype=hidden.dtype, device=hidden.device).sqrt()
    value = dense(p.value, hidden, dtype)
    logits = torch.einsum("mh,bnh->bmn", p.query.to(hidden.dtype), key)
    if mask is not None:
        logits = torch.where(mask[:, None] > 0, logits.float(), torch.finfo(torch.float32).min)
    w = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
    return torch.einsum("bmn,bnh->bmh", w, value)[:, 0]


def text_encoder_apply(p: TextEncoder, cfg: TextConfig, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       position_ids: Optional[torch.Tensor] = None, *,
                       cache: Optional[KVCache] = None, pool: bool = True,
                       dtype: torch.dtype = torch.float32, train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """→ (pooled (B, D) or None, hidden (B, S, D)); causal unless
    cfg.causal is False (then padding-only masking).  Positions are arange,
    or `position_ids` (B, S); a position past the table reads its last row,
    as JAX's clamping gather does (text.py:380-393).

    Decode mode (`cache` given, JAX text.py:356-433): S == 1, attends over
    the cache's positions below cache.index and writes this token's k/v
    there in every layer; the index is left for the caller to advance."""
    ids = input_ids.long()
    emb = p.embeddings
    s, rows = ids.shape[-1], emb.position.shape[0]
    if position_ids is None and s <= rows:
        pos = emb.position[:s]
    else:
        if position_ids is None:
            position_ids = torch.arange(s, device=ids.device)
        pos = emb.position[position_ids.long().clamp(max=rows - 1)]
    x = emb.word[ids] + pos + emb.token_type[0]
    x = layer_norm(emb.ln, x, cfg.layer_norm_eps)
    x = dropout(generator, x, cfg.hidden_dropout, not train).to(dtype)
    if cache is not None:
        if not cfg.causal:
            raise ValueError("KV-cached decode needs a causal tower")
        bias = _decode_bias(cache.k.shape[2], cache.index)
    elif cfg.causal:
        bias = _causal_bias(attention_mask)
    else:
        bias = mask_to_bias(attention_mask)[:, None, None, :]
    x = _run_blocks(p.blocks, x, cfg, bias, dtype, cache=cache, train=train,
                    generator=generator)
    pooled = text_pooler_apply(p.pooler, x, attention_mask, dtype=dtype) if pool else None
    return pooled, x


def precompute_cross_kv(blocks, cfg: TextConfig, memory: torch.Tensor,
                        dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K/V from the audio hidden
    states, once per utterance (JAX text.py:436-457) → (k, v), each
    (L, B, H, S_mem, Dh) in the compute dtype.  JAX keeps (L, B, S_mem, E)
    rows for the TPU's lanes; head-major here lets every step's per-head
    products read the K/V in place, where the merged rows would be copied
    to that layout in every step (at 256 streams and 500 patches those
    copies were about 40 % of a step's time on an H100; PERF.md §6)."""
    b, s, _ = memory.shape
    kv = [dense(blk.cross.kv, memory, dtype).split(cfg.hidden_size, dim=-1) for blk in blocks]

    def heads(t):
        return t.reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)

    return (torch.stack([heads(k) for k, _ in kv]), torch.stack([heads(v) for _, v in kv]))


def caption_decoder_apply(p: CaptionDecoder, cfg: TextConfig, text_hidden: torch.Tensor,
                          attention_mask: torch.Tensor, audio_hidden: Optional[torch.Tensor],
                          audio_mask: torch.Tensor, *, cache: Optional[KVCache] = None,
                          cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          train: bool = False, generator: Optional[torch.Generator] = None,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """→ vocab logits (B, S, V) (JAX `caption_decoder_apply`, text.py:460-492).
    Full mode: causal self-attention over the text hidden states,
    cross-attention to the audio hidden states.  Decode mode (`cache`,
    with `cross_kv` from precompute_cross_kv in place of audio_hidden): one
    position over the cache, as text_encoder_apply's decode mode."""
    if cache is not None:
        bias = _decode_bias(cache.k.shape[2], cache.index)
    else:
        bias = _causal_bias(attention_mask)
    memory_bias = mask_to_bias(audio_mask)[:, None, None, :]
    x = _run_blocks(p.blocks, text_hidden, cfg, bias, dtype, cache=cache, cross_kv=cross_kv,
                    memory=audio_hidden if cross_kv is None else None,
                    memory_bias=memory_bias, train=train, generator=generator)
    return dense(p.vocab_proj, x, dtype)
