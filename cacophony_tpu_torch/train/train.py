"""The training steps of both stages (cacophony_tpu/train/train.py:36-255).

    step = make_caco_train_step(cfg, tc)     # stage 2, a CacoModel
    step = make_mae_train_step(mae_cfg, tc)  # stage 1, an AudioMAE
    state = init_train_state(model, tc)
    state, metrics = step(state, batch, generator)

Stage 1 masks a patch grid (`mae_random_masking`: the visible set goes
through the encoder, the masked positions to the decoder's restore set) and
takes the reconstruction MSE over the masked patches that are not padding;
`metrics` holds `loss` and `grad_norm`.  The masking noise is drawn by
`mae_noise` from the step's generator, then the dropout masks, in order.

Loss = symmetric contrastive + `caption_loss_weight` × teacher-forced
caption cross-entropy; the caption branch reuses the text tower's hidden
states `t_hidden[:, :-1]` (the tower is causal, so they equal a pass over
`ids[:, :-1]`).  `metrics` holds `loss`, `contrastive`, `caption` and
`grad_norm` (the global norm before clipping), as 0-d tensors.

The optimizer is the JAX package's optax chain, written out:
clip_by_global_norm → AdamW (b1 0.9, b2 0.999, eps 1e-8) with
`warmup_cosine_decay_schedule(0, lr, warmup, total_steps)` and the weight-
decay mask of `make_optimizer` (checkpoints/bridge.py:decay_mask: by the
rank of the JAX leaf, so block biases and LayerNorms are decayed).  With
`adam_mu_dtype="bfloat16"` the first moment is stored in bf16 in optax's
order: the update uses the new fp32 moment, and only then is the moment
rounded for storage.  The new moment is 0.1·g + b1′·mu in fp32 with
b1′ = 0.9 rounded to bf16 (0.8984375): JAX casts the weakly typed 0.9 to
mu's dtype, and under `jit` XLA keeps the product in fp32 (measured
against the jitted optax update; eagerly, optax would round it to bf16).
The schedule is 0 at step 0, so the first step moves no parameter.

Parameters stay fp32 and are cast to the compute dtype at each use.  The
port updates parameters and moments in place (JAX donates the state);
`init_train_state` keeps a reference to the model.  The in-step random
numbers (dropout) come from the `torch.Generator` passed to the step, on
the parameters' device.  On a card, the step factory turns off TF32 and
reduced-precision bf16 reductions for this process, as the engine does.

Under a dp mesh (`mesh=`, parallel/mesh.py) each rank steps on its rows of
the global batch and the step optimizes the global batch's loss, as
GSPMD's does in JAX: rank r's objective is L_con/dp (the contrastive loss,
whose gathered embeddings' backward already sums over the ranks) plus its
share of each masked mean (train/losses.py); the gradients are then summed
over dp, coalesced, so the norm, the clip and AdamW run on the same
gradients on every rank and the replicas stay equal.  The logged `loss`,
`contrastive`, `caption` and `grad_norm` are the global ones.  The MAE
noise is drawn at the global batch's shape and sliced, so a dp step masks
what a one-device step masks; dropout and drop-path draw per rank (as
JAX's `rbg` keys do per shard).

Under a mesh with tp > 1 the model is sharded by `parallel.shard_params`
(Megatron: each rank runs its heads and its block of every MLP, the
vocabulary head vocab-parallel where tp divides it) and the tp ranks of a
dp group step on the same rows.  The gradients of the sharded leaves are
this rank's blocks; those of the replicated leaves come out whole and
equal on every tp rank (the collectives' backward sums what the ranks'
blocks contribute).  The dp sum is unchanged; the global norm sums the
sharded leaves' squares over tp and counts each replicated leaf once; AdamW
updates the local blocks.  Dropout in the replicated region draws the same
masks on every tp rank (the same generator, the same shapes); in the
sharded region (attention probabilities, the audio MLP's hidden features)
the mask is drawn at the global shape and sliced, so a tp step draws what
a one-process step draws and the replicas cannot drift.  tp must divide
every tower's heads (ValueError otherwise).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from cacophony_tpu_torch.checkpoints.bridge import decay_mask
from cacophony_tpu_torch.configs import AudioMAEConfig, CacoConfig
from cacophony_tpu_torch.models.audio import audiomae_apply
from cacophony_tpu_torch.models.caco import get_audio_embedding, get_text_embedding
from cacophony_tpu_torch.models.text import caption_decoder_apply
from cacophony_tpu_torch.parallel.mesh import coalesced, dp_rows
from cacophony_tpu_torch.parallel.tensor import all_reduce, group_size, tp_shard
from cacophony_tpu_torch.train.losses import (
    caption_cross_entropy,
    clip_contrastive_loss,
    mae_reconstruction_loss,
)
from cacophony_tpu_torch.utils.profiling import span

_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    total_steps: int = 100_000
    max_grad_norm: float = 1.0
    caption_loss_weight: float = 1.0
    # recompute the audio encoder's forward in the backward (activation memory)
    remat_encoder: bool = False
    # Adam first-moment storage dtype; None keeps it fp32
    adam_mu_dtype: Optional[str] = "bfloat16"


def learning_rate(tc: TrainConfig, count: int) -> float:
    """optax `warmup_cosine_decay_schedule(0, lr, warmup, total_steps)` at
    `count`, in fp32 arithmetic as optax evaluates it."""
    f32 = np.float32
    warmup = min(tc.warmup_steps, max(0, tc.total_steps - 1))
    peak = f32(tc.learning_rate)
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float(-peak * frac + peak)
    decay_steps = f32(tc.total_steps - warmup)
    c = min(f32(count - warmup), decay_steps)
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / decay_steps))
    return float(peak * cosine)


class AdamWState(NamedTuple):
    mu: List[torch.Tensor]  # first moments, in adam_mu_dtype
    nu: List[torch.Tensor]  # second moments, fp32
    count: int


class AdamW:
    """clip_by_global_norm → optax.adamw with the JAX decay mask, over the
    model's parameters in `named_parameters()` order."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.mu_dtype = _DTYPES[tc.adam_mu_dtype]
        self.b1_mu = float(torch.tensor(self.b1, dtype=self.mu_dtype))  # see the module docstring

    def init(self, model: torch.nn.Module) -> AdamWState:
        ps = [p for _, p in model.named_parameters()]
        return AdamWState([torch.zeros_like(p, dtype=self.mu_dtype) for p in ps],
                          [torch.zeros_like(p) for p in ps], 0)

    @torch.no_grad()
    def update(self, model: torch.nn.Module, grads: List[torch.Tensor], state: AdamWState,
               grad_norm: torch.Tensor) -> AdamWState:
        """Apply one update to the model's parameters in place; → the new state."""
        tc, b1, b2 = self.tc, self.b1, self.b2
        named = list(model.named_parameters())
        params = [p for _, p in named]
        if not bool(grad_norm < tc.max_grad_norm):  # optax: select(norm < max, g, g / norm · max)
            grads = torch._foreach_div(grads, grad_norm)
            torch._foreach_mul_(grads, tc.max_grad_norm)
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, state.mu, alpha=self.b1_mu)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, sq)
        torch._foreach_copy_(state.mu, mu)  # stored moment: rounded after the update uses it
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - np.power(f32(b1), f32(count)))
        bc2 = float(f32(1) - np.power(f32(b2), f32(count)))
        torch._foreach_div_(mu, bc1)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu, denom)  # mu is now the Adam update
        mask = decay_mask(model)
        decayed = [i for i, (name, _) in enumerate(named) if mask[name]]
        if decayed:
            wd = torch._foreach_mul([params[i] for i in decayed], tc.weight_decay)
            torch._foreach_add_([mu[i] for i in decayed], wd)
        torch._foreach_mul_(mu, -learning_rate(tc, state.count))
        torch._foreach_add_(params, mu)
        return AdamWState(state.mu, state.nu, count)


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(tc)


class TrainState(NamedTuple):
    params: torch.nn.Module  # a CacoModel or an AudioMAE
    opt_state: AdamWState
    step: int


def init_train_state(params: torch.nn.Module, tc: TrainConfig) -> TrainState:
    return TrainState(params, make_optimizer(tc).init(params), 0)


def global_norm(tensors: List[torch.Tensor], sharded: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over all tensors (optax.global_norm).  Under tp,
    `sharded` marks the tensors that are this rank's blocks of a leaf:
    their squares are summed over the tp `group`, and each replicated
    tensor is counted once."""
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))

    def squares(flag):
        return torch.stack(torch._foreach_norm(
            [t for t, s in zip(tensors, sharded) if s == flag])).square().sum()

    return torch.sqrt(all_reduce(squares(True), group) + squares(False))


def _dp_group(mesh):
    """The mesh's dp process group, or None without a mesh."""
    return None if mesh is None else mesh.get_group("dp")


def check_tp_heads(heads: Dict[str, int], mesh) -> None:
    """ValueError where the mesh's tp does not divide a tower's heads."""
    tp = 1 if mesh is None else mesh["tp"].size()
    for name, h in heads.items():
        if h % tp:
            raise ValueError(f"tp={tp} does not divide the {h} heads of {name}")


def _global(x: torch.Tensor, group) -> torch.Tensor:
    """A rank's share summed over the group (no gradient)."""
    return all_reduce(x.detach().clone(), group)


def make_caco_loss(cfg: CacoConfig, tc: TrainConfig, mesh=None):
    """→ loss_fn(model, batch, generator) → (objective, metrics): the
    stage-2 objective of `make_caco_train_step` without the optimizer.
    Without a mesh the objective is the loss; under one it is this rank's
    objective, and metrics hold the global values."""
    group = _dp_group(mesh)
    check_tp_heads({"the audio tower": cfg.audio.num_heads, "the text tower": cfg.text.num_heads,
                    "the decoder": cfg.decoder.num_heads,
                    "the audio pooler": cfg.num_attention_pool_heads}, mesh)

    def audio(model, batch, generator):
        arrays = (batch["audio_patches"], batch["audio_time_inds"], batch["audio_freq_inds"],
                  batch["audio_mask"])
        if not tc.remat_encoder:
            return get_audio_embedding(model, cfg, *arrays, train=True, generator=generator)
        # The recomputation in the backward must draw the same dropout masks:
        # both passes run on a copy of the generator's state at this point,
        # and the generator then continues from where the first pass ended.
        start = generator.get_state() if generator is not None else None
        end = []

        def fwd(*xs):
            g = None
            if start is not None:
                g = torch.Generator(device=generator.device)
                g.set_state(start)
            out = get_audio_embedding(model, cfg, *xs, train=True, generator=g)
            if g is not None:
                end.append(g.get_state())
            return out

        out = checkpoint(fwd, *arrays, use_reentrant=False)
        if end:
            generator.set_state(end[0])
        return out

    def loss_fn(model, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
        a_emb, a_hidden = audio(model, batch, generator)
        ids, tmask = batch["text_input_ids"], batch["text_mask"]
        t_emb, t_hidden = get_text_embedding(model, cfg, ids, tmask, train=True,
                                             generator=generator)
        l_con = clip_contrastive_loss(a_emb, t_emb, model.logit_scale, group)
        logits = caption_decoder_apply(model.decoder, cfg.decoder, t_hidden[:, :-1],
                                       tmask[:, :-1], a_hidden, batch["audio_mask"], train=True,
                                       generator=generator, dtype=cfg.dtype)
        l_cap = caption_cross_entropy(logits.float(), ids[:, 1:], tmask[:, 1:], group,
                                      tp=tp_shard(model.decoder.vocab_proj))
        if group is None:
            loss = l_con + tc.caption_loss_weight * l_cap
            return loss, {"loss": loss, "contrastive": l_con, "caption": l_cap}
        objective = l_con / group_size(group) + tc.caption_loss_weight * l_cap
        cap = _global(l_cap, group)
        return objective, {"loss": l_con.detach() + tc.caption_loss_weight * cap,
                           "contrastive": l_con, "caption": cap}

    return loss_fn


def _make_step(loss_fn, tc: TrainConfig, mesh=None):
    """→ step(state, batch, generator) → (state, metrics): loss_fn's
    gradients (summed over dp under a mesh), their global norm (over tp's
    blocks too), one AdamW update in place.  Spans (utils/profiling.py):
    `train.forward`, `train.backward`, `train.grad_norm` (the dp all-reduce
    included) and `train.optimizer`."""
    group = _dp_group(mesh)
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    opt = make_optimizer(tc)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]):
        model = state.params
        for p in model.parameters():
            p.grad = None
        dev = p.device
        with span("train.forward", device=dev):
            loss, metrics = loss_fn(model, batch, generator)
        with span("train.backward", device=dev):
            loss.backward()
        with span("train.grad_norm", device=dev):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in model.parameters()]
            if group is not None and group_size(group) > 1:
                coalesced(grads, lambda flat: dist.all_reduce(flat, group=group))
            layout, shard = getattr(model, "tp_layout", {}), getattr(model, "tp_shard", None)
            norm = global_norm(grads, [name in layout for name, _ in model.named_parameters()],
                               shard.group if shard is not None else None)
        with span("train.optimizer", device=dev):
            opt_state = opt.update(model, grads, state.opt_state, norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = norm
        return TrainState(model, opt_state, state.step + 1), metrics

    return step


def make_caco_train_step(cfg: CacoConfig, tc: TrainConfig, mesh=None):
    """→ step(state, batch, generator) → (state, metrics).  batch:
    audio_patches / audio_time_inds / audio_freq_inds / audio_mask and
    text_input_ids / text_mask, on the parameters' device; under a dp mesh
    this rank's rows (`shard_batch`) of the global batch."""
    return _make_step(make_caco_loss(cfg, tc, mesh), tc, mesh)


# --------------------------------------------------------------- stage 1

def mae_noise(generator: Optional[torch.Generator], mask: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """The masking noise: U[0, 1) of the patch grid's (B, S) shape, from
    `generator` on the mask's device.  Under a dp mesh `mask` is this
    rank's rows: the noise is drawn at the global (B·dp, S) shape and this
    rank's rows are returned."""
    if mesh is None:
        return torch.rand(mask.shape, generator=generator, device=mask.device)
    b, s = mask.shape
    noise = torch.rand((b * mesh["dp"].size(), s), generator=generator, device=mask.device)
    return noise[dp_rows(noise.shape[0], mesh)]


def mae_random_masking(noise: torch.Tensor, patch_batch: Dict[str, torch.Tensor],
                       mask_ratio: float) -> Dict[str, torch.Tensor]:
    """Split a patch grid into the visible and the masked set by the
    argsorted noise (JAX `mae_random_masking`, train.py:195-225): padding
    gets noise + 1, so the visible set is real patches first; the first
    n_keep = round(S·(1 − ratio)) of the stable order are kept, the rest go
    to the decoder's restore set with their (time, freq) indices.
    `target_patches` is [keep, drop] and `loss_mask` [0 … 0, restore mask]."""
    x = patch_batch["audio_patches"]
    b, s, _ = x.shape
    n_keep = max(1, int(round(s * (1.0 - mask_ratio))))
    noise = torch.where(patch_batch["audio_mask"] > 0, noise, noise + 1.0)
    order = torch.argsort(noise, dim=1, stable=True)
    keep, drop = order[:, :n_keep], order[:, n_keep:]

    def take(a, idx):
        return torch.take_along_dim(a, idx[..., None] if a.dim() == 3 else idx, dim=1)

    kept, dropped = take(x, keep), take(x, drop)
    restore_mask = take(patch_batch["audio_mask"], drop)
    return {
        "patches": kept,
        "time_inds": take(patch_batch["audio_time_inds"], keep),
        "freq_inds": take(patch_batch["audio_freq_inds"], keep),
        "mask": take(patch_batch["audio_mask"], keep),
        "restore_time_inds": take(patch_batch["audio_time_inds"], drop),
        "restore_freq_inds": take(patch_batch["audio_freq_inds"], drop),
        "restore_mask": restore_mask,
        "target_patches": torch.cat([kept, dropped], dim=1),
        "loss_mask": torch.cat([torch.zeros((b, n_keep), dtype=torch.int32, device=x.device),
                                restore_mask.to(torch.int32)], dim=1),
    }


def make_mae_loss(cfg: AudioMAEConfig, tc: TrainConfig, mesh=None):
    """→ loss_fn(model, batch, generator) → (objective, metrics): the
    stage-1 objective of `make_mae_train_step` without the optimizer (this
    rank's share under a mesh; metrics hold the global loss).  The loss
    keeps JAX's type promotion: a bf16 reconstruction minus the fp32 target
    is fp32."""
    group = _dp_group(mesh)
    check_tp_heads({"the encoder": cfg.encoder.num_heads, "the decoder": cfg.decoder.num_heads},
                   mesh)

    def loss_fn(model, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        # without a mesh, mae_noise keeps its two-argument call
        noise = (mae_noise(generator, batch["audio_mask"]) if mesh is None
                 else mae_noise(generator, batch["audio_mask"], mesh))
        m = mae_random_masking(noise, batch, cfg.mask_ratio)
        pred = audiomae_apply(model, cfg.encoder, cfg.decoder, m["patches"], m["mask"],
                              m["time_inds"], m["freq_inds"], m["restore_time_inds"],
                              m["restore_freq_inds"], m["restore_mask"], dtype=cfg.dtype,
                              train=True, generator=generator)
        loss = mae_reconstruction_loss(pred, m["target_patches"], m["loss_mask"], group=group)
        return loss, {"loss": loss if group is None else _global(loss, group)}

    return loss_fn


def make_mae_train_step(cfg: AudioMAEConfig, tc: TrainConfig, mesh=None):
    """Stage-1 masked-reconstruction step → step(state, batch, generator) →
    (state, metrics).  batch: audio_patches / audio_time_inds /
    audio_freq_inds / audio_mask, on the parameters' device (this rank's
    rows under a dp mesh)."""
    return _make_step(make_mae_loss(cfg, tc, mesh), tc, mesh)
