"""The plain reference: the published models' math in fp32 PyTorch.

No kernel, cache or batching trick of the program, and nothing of the
program is imported: the log-mel frontend (tfio semantics), the patch grid,
the pre-LN ViT, the attention pooler and clip-by-global-norm AdamW (the
text towers and the caption loss in configs/caco_base_ref.py) are written
out here from the published descriptions.  Every product goes through a `Prec`, so the same code serves
as the reference (`Exact`: fp32 with TF32 off) and as the lower-precision
control (`Fp8`: each product's operands rounded to float8 e4m3, the
backward's incoming gradient to e5m2, per-tensor scaled).

Weights are a dict name → fp32 tensor in the port's layout (a Dense is
`w` (d_in, d_out) and `b`, a LayerNorm `scale` and `bias`), made by
`make_weights` from a seed on the card in one draw.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Leaf = Tuple[str, Tuple[int, ...], float, float]  # name, shape, std, mean

LN_EPS_AUDIO = 1e-6


# ----------------------------------------------------------------- weights

def dense_leaves(name: str, d_in: int, d_out: int, std: float = None) -> List[Leaf]:
    """A Dense: lecun-normal weight (or N(0, std²)) and a small random bias."""
    return [(f"{name}.w", (d_in, d_out), math.sqrt(1.0 / d_in) if std is None else std, 0.0),
            (f"{name}.b", (d_out,), 0.02, 0.0)]


def ln_leaves(name: str, d: int) -> List[Leaf]:
    return [(f"{name}.scale", (d,), 0.05, 1.0), (f"{name}.bias", (d,), 0.05, 0.0)]


def vit_leaves(prefix: str, blocks: dict) -> List[Leaf]:
    h, ffn = blocks["hidden_size"], blocks["intermediate_size"]
    out = []
    for i in range(blocks["num_layers"]):
        p = f"{prefix}.blocks.{i}"
        out += (ln_leaves(f"{p}.ln1", h) + dense_leaves(f"{p}.attn.qkv", h, 3 * h)
                + dense_leaves(f"{p}.attn.o", h, h) + ln_leaves(f"{p}.ln2", h)
                + dense_leaves(f"{p}.mlp.w1", h, ffn) + dense_leaves(f"{p}.mlp.w2", ffn, h))
    return out


def make_weights(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from ONE normal draw of a generator on `device` seeded
    with `seed`: leaf = mean + std · z, as views of one fp32 buffer."""
    total = sum(int(np.prod(s)) for _, s, _, _ in leaves)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, std, mean in leaves:
        n = int(np.prod(shape))
        out[name] = z[at:at + n].view(shape).mul_(std).add_(mean)
        at += n
    return out


# -------------------------------------------------------------- precision

def _fq(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to a float8 `dtype` under a per-tensor scale (amax → the
    format's largest finite value), back in fp32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fq(a, torch.float8_e4m3fn), _fq(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fq(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class Exact:
    """fp32 products (the caller turns TF32 off)."""

    name = "fp32"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b


class Fp8:
    """The control: every product in float8 (e4m3 operands, e5m2 gradients)."""

    name = "fp8"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8MatMul.apply(a, b)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------- frontend

def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_matrix(front: dict) -> np.ndarray:
    """TF's linear_to_mel_weight_matrix: HTK mel scale, triangles in mel
    space, the DC bin's row zero; (fft_size/2 + 1, num_mels)."""
    nbins = front["fft_size"] // 2 + 1
    fmax = front["mel_fmax"] or front["sample_rate"] / 2
    spec_mel = _hz_to_mel(np.linspace(0.0, front["sample_rate"] / 2, nbins)[1:])[:, None]
    edges = np.linspace(_hz_to_mel(front["mel_fmin"]), _hz_to_mel(fmax), front["num_mels"] + 2)
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    w = np.maximum(0.0, np.minimum((spec_mel - lo) / (mid - lo), (hi - spec_mel) / (hi - mid)))
    return np.pad(w, [[1, 0], [0, 0]]).astype(np.float32)


def log_mel(bufs: torch.Tensor, front: dict) -> torch.Tensor:
    """(B, N) waveforms → (B, ceil(N/hop), mels): frames of `window_length`
    every `hop_length`, end-padded, periodic Hann, |rfft(n=fft_size)|, mel,
    log(· + offset)·scale + bias, all fp32."""
    hop, win, nfft = front["hop_length"], front["window_length"], front["fft_size"]
    frames = -(-bufs.shape[-1] // hop)
    x = torch.nn.functional.pad(bufs.float(), (0, (frames - 1) * hop + win - bufs.shape[-1]))
    n = torch.arange(win, device=bufs.device, dtype=torch.float64)
    hann = (0.5 - 0.5 * torch.cos(2 * math.pi * n / win)).float()
    spec = torch.fft.rfft(x.unfold(-1, win, hop) * hann, n=nfft).abs()
    mel = spec @ torch.from_numpy(mel_matrix(front)).to(bufs.device)
    return torch.log(mel + front["log_offset"]) * front["log_scale"] + front["log_bias"]


def patch_grid(bufs: torch.Tensor, lens: torch.Tensor, front: dict, seq: int,
               tp: int = 16, fp: int = 16) -> Dict[str, torch.Tensor]:
    """Waveforms → the time-major 16×16 patch grid of the log-mel: the first
    `seq` patches (zero rows past the buffer's), a mask of the clip's valid
    ones ((ceil(len/hop) // 16) · mels/16), and their time / freq indices."""
    spec = log_mel(bufs, front)
    b, f, mels = spec.shape
    t1, f1 = f // tp, mels // fp
    x = spec[:, :t1 * tp].reshape(b, t1, tp, f1, fp).permute(0, 1, 3, 2, 4)
    x = x.reshape(b, t1 * f1, tp * fp)
    x = x[:, :seq] if t1 * f1 >= seq else torch.nn.functional.pad(x, (0, 0, 0, seq - t1 * f1))
    valid = (-(-lens.long() // front["hop_length"]) // tp) * f1
    pos = torch.arange(seq, device=bufs.device)
    mask = pos[None] < valid[:, None]
    inds = pos[None] * mask
    return {"patches": x * mask[..., None], "time": inds // f1, "freq": inds % f1, "mask": mask}


# ------------------------------------------------------------------ layers

def dense(W, name: str, x: torch.Tensor, P) -> torch.Tensor:
    return P.mm(x, W[f"{name}.w"]) + W[f"{name}.b"]


def layer_norm(W, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * W[f"{name}.scale"] + W[f"{name}.bias"]


def sincos(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin, cos] of pos · 10000^(−2i/dim) (the audio tower's time embedding)."""
    i = torch.arange(dim // 2, device=pos.device, dtype=torch.float64)
    ang = pos.double()[..., None] * torch.pow(10000.0, -2.0 * i / dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).float()


def self_attention(W, name: str, x: torch.Tensor, key_mask: torch.Tensor, heads: int,
                   P) -> torch.Tensor:
    """Multi-head self-attention, masked keys left out, softmax in fp32."""
    b, s, d = x.shape
    hd = d // heads
    q, k, v = dense(W, f"{name}.qkv", x, P).view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    logits = P.mm(q / math.sqrt(hd), k.transpose(-1, -2))
    logits = logits.masked_fill(~key_mask[:, None, None, :], -math.inf)
    out = P.mm(torch.softmax(logits, -1), v).transpose(1, 2).reshape(b, s, d)
    return dense(W, f"{name}.o", out, P)


def vit_stack(W, prefix: str, blocks: dict, x: torch.Tensor, mask: torch.Tensor,
              P) -> torch.Tensor:
    """Pre-LN blocks x + attn(LN(x)), x + W2·silu(W1·LN(x)), then ln_f."""
    for i in range(blocks["num_layers"]):
        p = f"{prefix}.blocks.{i}"
        x = x + self_attention(W, f"{p}.attn", layer_norm(W, f"{p}.ln1", x, LN_EPS_AUDIO),
                               mask, blocks["num_heads"], P)
        h = dense(W, f"{p}.mlp.w1", layer_norm(W, f"{p}.ln2", x, LN_EPS_AUDIO), P)
        x = x + dense(W, f"{p}.mlp.w2", torch.nn.functional.silu(h), P)
    return layer_norm(W, f"{prefix}.ln_f", x, LN_EPS_AUDIO)


def add_positions(W, prefix: str, x: torch.Tensor, time: torch.Tensor,
                  freq: torch.Tensor) -> torch.Tensor:
    return x + sincos(time, x.shape[-1]) + W[f"{prefix}.freq_pos_embed"][freq]


def audio_encoder(W, prefix: str, enc: dict, g: Dict[str, torch.Tensor], P) -> torch.Tensor:
    """Patch projection + sin-cos time + learned freq embedding, the blocks."""
    x = add_positions(W, prefix, dense(W, f"{prefix}.patch_proj", g["patches"], P),
                      g["time"], g["freq"])
    return vit_stack(W, prefix, enc, x, g["mask"], P)


def audio_pool(W, prefix: str, heads: int, hidden: torch.Tensor, mask: torch.Tensor,
               P) -> torch.Tensor:
    """One learned query per head over the valid patches, then `out`."""
    b, s, d = hidden.shape
    hd = d // heads
    k, v = dense(W, f"{prefix}.kv", hidden, P).view(b, s, 2, heads, hd).permute(2, 0, 3, 1, 4)
    q = (W[f"{prefix}.query"] / math.sqrt(hd)).view(1, heads, 1, hd)
    logits = P.mm(q.expand(b, -1, -1, -1), k.transpose(-1, -2))
    logits = logits.masked_fill(~mask[:, None, None, :], -math.inf)
    out = P.mm(torch.softmax(logits, -1), v).reshape(b, d)
    return dense(W, f"{prefix}.out", out, P)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ‖x + 1e-10‖ (the released model's normalisation)."""
    return x / torch.linalg.vector_norm(x + 1e-10, dim=-1, keepdim=True)


# ---------------------------------------------------------------- training

def decayed(name: str, shape) -> bool:
    """The released optimizer's weight-decay mask: leaves of rank ≥ 2, where
    a layer stack's leaves carry the layer axis (so every block's biases
    and LayerNorms are decayed, top-level ones are not)."""
    return len(shape) + ("blocks" in name.split(".")) >= 2


def lr_at(count: int, peak: float, warmup: int, total: int) -> float:
    """Linear warm-up from 0 over `warmup` steps, then cosine decay to 0."""
    if count < warmup:
        return peak * count / warmup
    return peak * 0.5 * (1 + math.cos(math.pi * min(count - warmup, total - warmup)
                                      / (total - warmup)))


class AdamW:
    """Clip by global norm, then AdamW (b1 0.9, b2 0.999, eps 1e-8), fp32."""

    def __init__(self, W: Dict[str, torch.Tensor], opt: dict):
        self.opt = opt
        self.mu = {k: torch.zeros_like(v) for k, v in W.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in W.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, W, grads) -> Dict[str, torch.Tensor]:
        """Update W in place; → the clipped gradients the moments took."""
        o = self.opt
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        f = float(min(1.0, o["max_grad_norm"] / float(norm)))
        lr = lr_at(self.count, o["learning_rate"], o["warmup_steps"], o["total_steps"])
        self.count += 1
        c1, c2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        clipped = {}
        for k, p in W.items():
            g = grads[k] * f
            clipped[k] = g
            self.mu[k].mul_(0.9).add_(g, alpha=0.1)
            self.nu[k].mul_(0.999).addcmul_(g, g, value=0.001)
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + 1e-8)
            if decayed(k, p.shape):
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
        return clipped
