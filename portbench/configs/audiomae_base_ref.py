"""Plain reference of `audiomae_base` (Cacophony stage 1, arXiv 2402.06986):
its parameter leaves in the port's layout, the random masking from a
step's noise, and the masked reconstruction loss — the encoder over the
visible patches, the decoder with every position restored to its place in
the patch grid — in fp32 (portbench/plain.py).

The masking is MAE's: each clip keeps round(S · (1 − mask_ratio)) patches,
its valid patches with the least noise first (padding after every valid
patch, ties by position); the loss is the mean over the masked valid
patches of each patch's mean squared error against the log-mel patch."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import plain


def leaves(cfg: dict) -> List[plain.Leaf]:
    enc, dec = cfg["encoder"], cfg["decoder"]
    d, dd = enc["hidden_size"], dec["hidden_size"]
    out = plain.dense_leaves("encoder.patch_proj", enc["patch_size"], d)
    out += [("encoder.freq_pos_embed", (enc["num_freq_patches"], d), 0.02, 0.0)]
    out += plain.vit_leaves("encoder", enc) + plain.ln_leaves("encoder.ln_f", d)
    out += plain.dense_leaves("decoder.in_proj", d, dd)
    out += [("decoder.freq_pos_embed", (dec["num_freq_patches"], dd), 0.02, 0.0),
            ("decoder.mask_token", (dd,), 0.02, 0.0)]
    out += plain.vit_leaves("decoder", dec) + plain.ln_leaves("decoder.ln_f", dd)
    out += plain.dense_leaves("decoder.out_proj", dd, dec["patch_size"])
    return out


def noise(state, b: int, s: int, device) -> torch.Tensor:
    """The masking noise a step draws first from its generator: U[0, 1) of
    the patch grid's (B, S) shape, from the generator's state before the
    step."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return torch.rand((b, s), generator=g, device=device)


def visible(cfg: dict, noise: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, keep) grid positions the encoder sees."""
    keep = max(1, int(round(noise.shape[1] * (1.0 - cfg["mask_ratio"]))))
    rank = noise + (~mask).float()  # padding after every valid patch
    return torch.argsort(rank, dim=1, stable=True)[:, :keep]


def masked(g: Dict[str, torch.Tensor], vis: torch.Tensor) -> torch.Tensor:
    """(B, S) the valid patches the encoder does not see: the loss's."""
    return g["mask"] & ~torch.zeros_like(g["mask"]).scatter(1, vis, True)


def masked_sum_loss(W: Dict[str, torch.Tensor], cfg: dict, g: Dict[str, torch.Tensor],
                    vis: torch.Tensor, P=plain.Exact) -> torch.Tensor:
    """Σ over the masked valid patches of their MSE, for one block of the
    batch: the patch grid `g` (plain.patch_grid) and the visible positions
    `vis`."""
    enc, dec = cfg["encoder"], cfg["decoder"]

    def at(x):
        return torch.take_along_dim(x, vis[..., None] if x.dim() == 3 else vis, dim=1)

    x = plain.add_positions(W, "encoder", plain.dense(W, "encoder.patch_proj", at(g["patches"]), P),
                            at(g["time"]), at(g["freq"]))
    hidden = plain.vit_stack(W, "encoder", enc, x, at(g["mask"]), P)
    b, s = g["mask"].shape
    full = W["decoder.mask_token"].expand(b, s, -1)
    seen = plain.dense(W, "decoder.in_proj", hidden, P)
    full = full.scatter(1, vis[..., None].expand(-1, -1, full.shape[-1]), seen)
    full = plain.add_positions(W, "decoder", full, g["time"], g["freq"])
    out = plain.dense(W, "decoder.out_proj", plain.vit_stack(W, "decoder", dec, full, g["mask"], P),
                      P)
    return ((out - g["patches"]).square().mean(-1) * masked(g, vis)).sum()
