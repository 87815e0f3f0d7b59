"""Plain reference of `caco_base` (Cacophony stage 2, arXiv 2402.06986):
its parameter leaves in the port's layout, and the audio embedding — the
log-mel patch grid, the 12-layer ViT, the attention pooler and the
normalisation — in fp32 (portbench/plain.py)."""

from __future__ import annotations

import math
from typing import List

import torch

from portbench import plain


def _text_leaves(prefix: str, t: dict) -> List[plain.Leaf]:
    d, ffn = t["hidden_size"], t["intermediate_size"]
    out = []
    for i in range(t["num_layers"]):
        p = f"{prefix}.blocks.{i}"
        out += (plain.dense_leaves(f"{p}.attn.qkv", d, 3 * d, 0.02)
                + plain.dense_leaves(f"{p}.attn.o", d, d, 0.02) + plain.ln_leaves(f"{p}.ln_attn", d)
                + plain.dense_leaves(f"{p}.mlp_in", d, ffn, 0.02)
                + plain.dense_leaves(f"{p}.mlp_out", ffn, d, 0.02)
                + plain.ln_leaves(f"{p}.ln_mlp", d))
        if t["cross_attention"]:
            out += (plain.dense_leaves(f"{p}.cross.q", d, d, 0.02)
                    + plain.dense_leaves(f"{p}.cross.kv", d, 2 * d, 0.02)
                    + plain.dense_leaves(f"{p}.cross.o", d, d, 0.02)
                    + plain.ln_leaves(f"{p}.ln_cross", d))
    return out


def leaves(cfg: dict) -> List[plain.Leaf]:
    a, t, dec = cfg["audio"], cfg["text"], cfg["decoder"]
    d, proj = a["hidden_size"], cfg["projection_size"]
    td = t["hidden_size"]
    out = [("logit_scale", (), 0.0, cfg["logit_scale_init"]),
           ("audio.freq_pos_embed", (a["num_freq_patches"], d), 0.02, 0.0)]
    out += plain.dense_leaves("audio.patch_proj", a["patch_size"], d)
    out += plain.vit_leaves("audio", a) + plain.ln_leaves("audio.ln_f", d)
    out += [("text.embeddings.word", (t["vocab_size"], td), 0.02, 0.0),
            ("text.embeddings.position", (t["max_position_embeddings"], td), 0.02, 0.0),
            ("text.embeddings.token_type", (t["type_vocab_size"], td), 0.02, 0.0)]
    out += plain.ln_leaves("text.embeddings.ln", td) + _text_leaves("text", t)
    out += [("text.pooler.query", (1, td), 0.02, 0.0)]
    out += plain.dense_leaves("text.pooler.key", td, td, 0.02)
    out += plain.dense_leaves("text.pooler.value", td, td, 0.02)
    out += [("audio_pool.query", (d,), 0.02, 0.0)]
    out += plain.dense_leaves("audio_pool.kv", d, 2 * d) + plain.dense_leaves("audio_pool.out", d, proj)
    out += plain.dense_leaves("text_proj", td, proj)
    if cfg["use_decoder"]:
        out += _text_leaves("decoder", dec)
        out += plain.dense_leaves("decoder.vocab_proj", dec["hidden_size"], dec["vocab_size"], 0.01)
    return out


def embed_audio(W, cfg: dict, bufs: torch.Tensor, lens: torch.Tensor, seq: int,
                P=plain.Exact) -> torch.Tensor:
    """(B, samples) fp32 waveforms and their lengths → (B, proj) unit rows."""
    g = plain.patch_grid(bufs, lens, cfg["frontend"], seq)
    hidden = plain.audio_encoder(W, "audio", cfg["audio"], g, P)
    return plain.normalize(plain.audio_pool(W, "audio_pool", cfg["num_attention_pool_heads"],
                                            hidden, g["mask"], P))


# ------------------------------------------------------------ text towers

LN_EPS_TEXT = 1e-5
NEG = -1e10  # the released text towers' additive mask value


class Drops:
    """Dropout masks in the order a training step draws them, drawn ahead
    for the whole batch from a generator state: the text tower's
    embeddings, then per layer its attention probabilities and the two
    residual branches; then per decoder layer self-attention, its branch,
    cross-attention, its branch and the MLP's branch.  `rows` selects a
    block of the batch.  Without a state nothing is dropped."""

    def __init__(self, cfg: dict, state, b: int, s: int, s_mem: int, device):
        self.masks, self.at, self.rows = [], 0, slice(None)
        if state is None:
            return
        t, dec = cfg["text"], cfg["decoder"]
        g = torch.Generator(device=device)
        g.set_state(state)
        d, h = t["hidden_size"], t["num_heads"]

        def draw(shape, rate):
            self.masks.append((torch.rand(shape, generator=g, device=device) < 1.0 - rate, rate))

        draw((b, s, d), t["hidden_dropout"])
        for _ in range(t["num_layers"]):
            draw((b, h, s, s), t["attention_dropout"])
            draw((b, s, d), t["hidden_dropout"])
            draw((b, s, d), t["hidden_dropout"])
        s1, dh = s - 1, dec["num_heads"]
        for _ in range(dec["num_layers"]):
            draw((b, dh, s1, s1), dec["attention_dropout"])
            draw((b, s1, dec["hidden_size"]), dec["hidden_dropout"])
            draw((b, dh, s1, s_mem), dec["attention_dropout"])
            draw((b, s1, dec["hidden_size"]), dec["hidden_dropout"])
            draw((b, s1, dec["hidden_size"]), dec["hidden_dropout"])

    def block(self, rows: slice) -> "Drops":
        self.at, self.rows = 0, rows
        return self

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.masks:
            return x
        keep, rate = self.masks[self.at]
        self.at += 1
        return torch.where(keep[self.rows], x / (1.0 - rate), 0.0)


def _attend(q, k, v, bias, heads: int, drop, P):
    b, s, d = q.shape
    hd = d // heads
    q, k, v = (x.reshape(b, x.shape[1], heads, hd).transpose(1, 2) for x in (q, k, v))
    w = torch.softmax(P.mm(q / math.sqrt(hd), k.transpose(-1, -2)) + bias, -1)
    return P.mm(drop(w), v).transpose(1, 2).reshape(b, s, d)


def _text_stack(W, prefix: str, t: dict, x, mask, drop, P, memory=None, memory_mask=None):
    """RoBERTa post-LN blocks, causal over the valid tokens; with `memory`
    each block also attends to it (the caption decoder)."""
    s = x.shape[1]
    allowed = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None] & mask[:, None, :]
    bias = torch.where(allowed, 0.0, NEG)[:, None]
    heads, d = t["num_heads"], t["hidden_size"]
    for i in range(t["num_layers"]):
        p = f"{prefix}.blocks.{i}"
        q, k, v = plain.dense(W, f"{p}.attn.qkv", x, P).split(d, -1)
        h = plain.dense(W, f"{p}.attn.o", _attend(q, k, v, bias, heads, drop, P), P)
        x = plain.layer_norm(W, f"{p}.ln_attn", drop(h) + x, LN_EPS_TEXT)
        if memory is not None:
            q = plain.dense(W, f"{p}.cross.q", x, P)
            k, v = plain.dense(W, f"{p}.cross.kv", memory, P).split(d, -1)
            mbias = torch.where(memory_mask, 0.0, NEG)[:, None, None, :]
            h = plain.dense(W, f"{p}.cross.o", _attend(q, k, v, mbias, heads, drop, P), P)
            x = plain.layer_norm(W, f"{p}.ln_cross", drop(h) + x, LN_EPS_TEXT)
        h = plain.dense(W, f"{p}.mlp_out", torch.nn.functional.gelu(
            plain.dense(W, f"{p}.mlp_in", x, P)), P)
        x = plain.layer_norm(W, f"{p}.ln_mlp", drop(h) + x, LN_EPS_TEXT)
    return x


def text_hidden(W, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, drop=None, P=plain.Exact):
    """The causal text tower's hidden states (B, S, D)."""
    drop = drop or (lambda x: x)
    e = "text.embeddings"
    x = W[f"{e}.word"][ids.long()] + W[f"{e}.position"][:ids.shape[1]] + W[f"{e}.token_type"][0]
    x = drop(plain.layer_norm(W, f"{e}.ln", x, LN_EPS_TEXT))
    return _text_stack(W, "text", cfg["text"], x, mask.bool(), drop, P)


def text_embed(W, cfg: dict, hidden: torch.Tensor, mask: torch.Tensor, P=plain.Exact):
    """One learned query over the valid tokens (keys scaled by 1/√D), the
    projection, the normalisation → (B, proj)."""
    d = hidden.shape[-1]
    key = plain.dense(W, "text.pooler.key", hidden, P) / math.sqrt(d)
    value = plain.dense(W, "text.pooler.value", hidden, P)
    logits = P.mm(W["text.pooler.query"].expand(hidden.shape[0], -1, -1), key.transpose(-1, -2))
    logits = logits.masked_fill(~mask.bool()[:, None, :], -math.inf)
    pooled = P.mm(torch.softmax(logits, -1), value)[:, 0]
    return plain.normalize(plain.dense(W, "text_proj", pooled, P))


def audio_hidden_embed(W, cfg: dict, g: dict, P=plain.Exact):
    hidden = plain.audio_encoder(W, "audio", cfg["audio"], g, P)
    emb = plain.normalize(plain.audio_pool(W, "audio_pool", cfg["num_attention_pool_heads"],
                                           hidden, g["mask"], P))
    return hidden, emb


def caption_sum_loss(W, cfg: dict, t_hidden, ids, mask, a_hidden, a_mask, drop, P=plain.Exact):
    """Teacher-forced caption cross-entropy summed over the valid next
    tokens: the decoder over the text tower's states but the last, the
    audio states as memory."""
    x = _text_stack(W, "decoder", cfg["decoder"], t_hidden[:, :-1], mask[:, :-1].bool(), drop, P,
                    memory=a_hidden, memory_mask=a_mask)
    logits = plain.dense(W, "decoder.vocab_proj", x, P)
    ce = torch.nn.functional.cross_entropy(logits.flatten(0, 1), ids[:, 1:].flatten().long(),
                                           reduction="none").view(ids.shape[0], -1)
    return (ce * mask[:, 1:]).sum()
