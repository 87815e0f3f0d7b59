"""Checkpoint IO: released Flax-msgpack checkpoints in, the port's own
checkpoints and training state in and out (cacophony_tpu/checkpoints/io.py).

- `load_caco(path)`: the released Cacophony file (read by
  `checkpoints/msgpack.py`, no flax) → the JAX-layout tree
  (`convert.convert_caco_params`) → a `CacoModel` through
  `bridge.params_from_jax`, on the card unless `device="cpu"`.  Parameter
  counts are asserted against the published sizes (85.26 M audio / 125.23 M
  text / 76.46 M decoder, reference README.md:59-70).  With `cfg=None`
  every shape-recoverable dimension is inferred from the checkpoint.
- `save_params` / `load_params`: a model's state dict with `torch.save` /
  `torch.load(weights_only=True)` (orbax in the JAX package).
- `save_train_state` / `latest_step` / `load_train_state`: a `TrainState`
  under `path/step_%08d/` with keep-N pruning — the model's state dict,
  AdamW's `mu` (in its own dtype, bf16 by default) and `nu` in
  `named_parameters()` order, `count` and `step`.  Under a dp mesh the
  replicas are equal: rank 0 alone writes, then every rank waits at a
  barrier; every rank reads on resume.  Under tp the parameters and both
  moments are gathered over tp into whole leaves before rank 0 writes, and
  a sharded model keeps its blocks of them on load.  The file is a
  one-device run's, so a run of any (dp, tp) resumes on one device and the
  other way round.

- `load_audiomae(path)`: a released-layout stage-1 file (`AudioEncoder_0`,
  `AudioDecoder_0`) → an `AudioMAE` on the card unless `device="cpu"`, the
  encoder held to 85.26 M and the decoder to 85.85 M (± 0.01 M); with
  `cfg=None` both towers' widths are inferred from the shapes.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from cacophony_tpu_torch.checkpoints.bridge import params_from_jax
from cacophony_tpu_torch.checkpoints.convert import convert_audiomae_params, convert_caco_params
from cacophony_tpu_torch.checkpoints.msgpack import restore_checkpoint
from cacophony_tpu_torch.parallel.mesh import gather_tensors, shard_tensors
from cacophony_tpu_torch.configs import (
    AudioDecoderConfig,
    AudioEncoderConfig,
    AudioMAEConfig,
    CacoConfig,
    TextConfig,
    audiomae_base,
    caco_base,
)
from cacophony_tpu_torch.models.caco import CacoModel

# Published parameter counts (reference README.md:59-70), in millions.
PUBLISHED_PARAM_COUNTS_M = {"audio": 85.26, "text": 125.23, "decoder": 76.46}
# The stage-1 reconstruction decoder (reference README.md:60): 768-d, 12
# layers, 3072 MLP give 85,850,368 parameters exactly.
PUBLISHED_MAE_DECODER_M = 85.85

TRAIN_STATE_FILE = "train_state.pt"


# ----------------------------------------- shape-driven config inference
#
# Not recoverable from shapes (kept from `base`): the attention-pool head
# count (the query is stored flat), the text tower's head count (2-D fused
# kernels), dropout rates, the logit-scale init, the compute dtype.

def _shape(x) -> tuple:
    return tuple(x.shape)


def infer_audio_encoder_config(ref_audio: dict, base: Optional[AudioEncoderConfig] = None,
                               ) -> AudioEncoderConfig:
    """Raw reference audio-tower tree → config.  The head count comes from
    the flax per-head MHA kernel (D, H, Dh)."""
    base = base or AudioEncoderConfig()
    patch_size, hidden = _shape(ref_audio["Dense_0"]["kernel"])
    layer0 = ref_audio["AudioEncoderLayer_0"]
    _, heads, _ = _shape(layer0["MultiHeadDotProductAttention_0"]["query"]["kernel"])
    return dataclasses.replace(
        base,
        hidden_size=int(hidden),
        patch_size=int(patch_size),
        num_layers=sum(1 for k in ref_audio if k.startswith("AudioEncoderLayer_")),
        num_heads=int(heads),
        intermediate_size=int(_shape(layer0["MLP_0"]["Dense_0"]["kernel"])[1]),
        num_freq_patches=int(_shape(ref_audio["freq_positional_embedding"])[0]),
    )


def infer_audio_decoder_config(ref_dec: dict, base: Optional[AudioDecoderConfig] = None,
                               ) -> AudioDecoderConfig:
    """Raw stage-1 decoder tree → config (heads from the per-head kernel)."""
    base = base or AudioDecoderConfig()
    layer0 = ref_dec["AudioEncoderLayer_0"]
    _, heads, _ = _shape(layer0["MultiHeadDotProductAttention_0"]["query"]["kernel"])
    return dataclasses.replace(
        base,
        hidden_size=int(_shape(ref_dec["Dense_0"]["kernel"])[1]),
        num_layers=sum(1 for k in ref_dec if k.startswith("AudioEncoderLayer_")),
        num_heads=int(heads),
        intermediate_size=int(_shape(layer0["MLP_0"]["Dense_0"]["kernel"])[1]),
        patch_size=int(_shape(ref_dec["Dense_1"]["kernel"])[1]),
        num_freq_patches=int(_shape(ref_dec["freq_positional_embedding"])[0]),
    )


def infer_text_config(ref_text: dict, base: Optional[TextConfig] = None, *,
                      cross_attention: bool = False) -> TextConfig:
    """Raw reference RoBERTa tree (scan-stacked or numbered layers) →
    config.  RoBERTa's 64-d heads are assumed when the hidden size differs
    from `base`."""
    base = base or TextConfig()
    layer = ref_text["encoder"]["layer"]
    if "ScanFlaxRobertaLayer_0" in layer:
        stacked = layer["ScanFlaxRobertaLayer_0"]
        q_kernel = stacked["attention"]["self"]["query"]["kernel"]
        num_layers, hidden = (int(d) for d in _shape(q_kernel)[:2])
        inter = int(_shape(stacked["intermediate"]["dense"]["kernel"])[2])
        has_cross = "crossattention" in stacked
    else:
        num_layers = len(layer)
        layer0 = layer[sorted(layer, key=int)[0]]
        hidden = int(_shape(layer0["attention"]["self"]["query"]["kernel"])[0])
        inter = int(_shape(layer0["intermediate"]["dense"]["kernel"])[1])
        has_cross = "crossattention" in layer0
    # the caption decoder has no embedding table: its vocabulary comes from
    # decoder_proj, max_position stays at base
    emb = ref_text.get("embeddings")
    if emb is not None:
        vocab = int(_shape(emb["word_embeddings"]["embedding"])[0])
        max_pos = int(_shape(emb["position_embeddings"]["embedding"])[0])
    else:
        vocab = (int(_shape(ref_text["decoder_proj"]["kernel"])[1])
                 if "decoder_proj" in ref_text else base.vocab_size)
        max_pos = base.max_position_embeddings
    heads = base.num_heads if hidden == base.hidden_size else max(1, hidden // 64)
    return dataclasses.replace(
        base,
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=num_layers,
        num_heads=heads,
        intermediate_size=inter,
        max_position_embeddings=max_pos,
        cross_attention=cross_attention or has_cross,
    )


def infer_caco_config(ref_params: dict, base: Optional[CacoConfig] = None) -> CacoConfig:
    """Raw released-CACO tree (`state['0']['params']`) → config.  The
    attention-pool head count stays at `base` (8, the JAX loader's value)."""
    base = base or caco_base()
    dec_tree = ref_params.get("decoder_module")
    return dataclasses.replace(
        base,
        audio=infer_audio_encoder_config(ref_params["audio_module"], base.audio),
        text=infer_text_config(ref_params["text_module"], base.text),
        decoder=(infer_text_config(dec_tree, base.decoder, cross_attention=True)
                 if dec_tree is not None else base.decoder),
        use_decoder=dec_tree is not None,
        projection_size=int(_shape(ref_params["text_proj"]["kernel"])[1]),
    )


def infer_audiomae_config(ref_params: dict, base: Optional[AudioMAEConfig] = None,
                          ) -> AudioMAEConfig:
    """Raw stage-1 tree (`AudioEncoder_0` / `AudioDecoder_0`) → config; the
    decoder stays at `base` where the tree has none."""
    base = base or audiomae_base()
    out = dataclasses.replace(
        base, encoder=infer_audio_encoder_config(ref_params["AudioEncoder_0"], base.encoder))
    if "AudioDecoder_0" in ref_params:
        out = dataclasses.replace(out, decoder=infer_audio_decoder_config(
            ref_params["AudioDecoder_0"], base.decoder))
    return out


# --------------------------------------------------- released checkpoints

def _restore_msgpack(path: str):
    state = restore_checkpoint(path, target=None)
    if state is None:
        raise FileNotFoundError(f"no checkpoint found at {path}")
    return state


def count_params(module: torch.nn.Module) -> int:
    """What the JAX package's `count_params` counts: every parameter
    element (the port's modules hold no buffers)."""
    return sum(p.numel() for p in module.parameters())


def _check_counts(model: CacoModel, strict: bool):
    for key, published in PUBLISHED_PARAM_COUNTS_M.items():
        if not hasattr(model, key):
            continue
        ours = count_params(getattr(model, key)) / 1e6
        if abs(ours - published) > 0.02 and strict:
            raise ValueError(
                f"param count mismatch for {key}: {ours:.2f}M vs published "
                f"{published}M — wrong checkpoint or layout drift"
            )


def load_caco(ckpt_path: str, cfg: Optional[CacoConfig] = None, *,
              strict_counts: bool = True, device="cuda"):
    """Released Cacophony checkpoint → (cfg, CacoModel on `device`).

    A file is read as it is; a directory is resolved to its newest
    `checkpoint_<N>`.  With `cfg=None` the configuration is inferred from
    the checkpoint's shapes.  The model runs on the card unless
    device="cpu" is given; without a card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f'load_caco on {device}: no CUDA device; pass device="cpu"')
    state = _restore_msgpack(ckpt_path)
    ref = state["0"]["params"]
    cfg = cfg or infer_caco_config(ref)
    model = params_from_jax(convert_caco_params(ref), cfg)
    _check_counts(model, strict_counts)
    return cfg, model.to(device)


def _check_mae_counts(model):
    enc_m = count_params(model.encoder) / 1e6
    if abs(enc_m - PUBLISHED_PARAM_COUNTS_M["audio"]) > 0.01:
        raise ValueError(f"MAE encoder param count {enc_m:.2f}M != "
                         f"{PUBLISHED_PARAM_COUNTS_M['audio']}M")
    if hasattr(model, "decoder"):
        dec_m = count_params(model.decoder) / 1e6
        if abs(dec_m - PUBLISHED_MAE_DECODER_M) > 0.01:
            raise ValueError(f"MAE decoder param count {dec_m:.2f}M != "
                             f"{PUBLISHED_MAE_DECODER_M}M (reference README.md:60)")


def load_audiomae(ckpt_path: str, cfg: Optional[AudioMAEConfig] = None, *,
                  strict_counts: bool = True, device="cuda"):
    """Released-layout stage-1 AudioMAE checkpoint → (cfg, AudioMAE on
    `device`).  With `cfg=None` the encoder's and the decoder's widths are
    inferred from the checkpoint.  Runs on the card unless device="cpu" is
    given; without a card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f'load_audiomae on {device}: no CUDA device; pass device="cpu"')
    ref = _restore_msgpack(ckpt_path)["0"]["params"]
    cfg = cfg or infer_audiomae_config(ref)
    model = params_from_jax(convert_audiomae_params(ref), cfg)
    if strict_counts:
        _check_mae_counts(model)
    return cfg, model.to(device)


# ------------------------------------------------------- our own checkpoints

def save_params(model: torch.nn.Module, path: str) -> None:
    """A model's state dict to `path` (torch.save; orbax in the JAX package)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict(), path)


def load_params(path: str, like: Optional[torch.nn.Module] = None):
    """→ the saved state dict, or `like` with it loaded (strict) when given."""
    device = next(like.parameters()).device if like is not None else "cpu"
    state = torch.load(path, map_location=device, weights_only=True)
    if like is None:
        return state
    like.load_state_dict(state)
    return like


# ---------------------------------------------------- training state resume

def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in (re.fullmatch(r"step_(\d+)", d)
                                             for d in os.listdir(path)) if m)


def _train_state_payload(state) -> dict:
    """What a train-state file holds, with whole leaves: a tp-sharded
    model's parameters and moments are gathered over tp (a collective)."""
    model, opt = state.params, state.opt_state
    names = [n for n, _ in model.named_parameters()]
    params, mu, nu = [p.detach() for _, p in model.named_parameters()], list(opt.mu), list(opt.nu)
    if getattr(model, "tp_layout", None):
        params, mu, nu = (gather_tensors(model, ts) for ts in (params, mu, nu))
    sd = model.state_dict()
    sd.update(zip(names, params))
    return {"params": sd, "names": names, "mu": mu, "nu": nu, "count": int(opt.count),
            "step": int(state.step)}


def save_train_state(state, path: str, *, keep: int = 3, mesh=None) -> str:
    """A TrainState (train/train.py) to `path/step_%08d/`, written through a
    temporary directory and a rename; prunes all but the newest `keep`.
    Under a mesh rank 0 writes (whole leaves, gathered over tp) and every
    rank returns after a barrier."""
    payload = _train_state_payload(state)
    final = os.path.join(path, f"step_{payload['step']:08d}")
    if mesh is None or dist.get_rank() == 0:
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, TRAIN_STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if keep:
            for old in _steps(path)[:-keep]:
                shutil.rmtree(os.path.join(path, f"step_{old:08d}"), ignore_errors=True)
    if mesh is not None:
        dist.barrier()
    return final


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return steps[-1] if steps else None


def load_train_state(path: str, like, step: Optional[int] = None):
    """Restore a TrainState saved by save_train_state into `like` (a
    TrainState of the same model and optimizer): the parameters and the
    moments are copied in place, each keeping its device and dtype; a
    tp-sharded model takes its blocks of the whole leaves."""
    from cacophony_tpu_torch.train.train import AdamWState, TrainState

    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no train-state checkpoints under {path}")
    model = like.params
    device = next(model.parameters()).device
    saved = torch.load(os.path.join(path, f"step_{step:08d}", TRAIN_STATE_FILE),
                       map_location=device, weights_only=True)
    names = [n for n, _ in model.named_parameters()]
    if saved["names"] != names:
        raise ValueError("the saved optimizer state is for another model: its parameter "
                         "names differ")
    params = saved["params"]
    params.update(zip(names, shard_tensors(model, [params[n] for n in names])))
    model.load_state_dict(params)
    opt = like.opt_state
    moments = shard_tensors(model, saved["mu"]) + shard_tensors(model, saved["nu"])
    for mine, theirs in zip(list(opt.mu) + list(opt.nu), moments):
        if mine.dtype != theirs.dtype or mine.shape != theirs.shape:
            raise ValueError(f"saved moment {tuple(theirs.shape)} {theirs.dtype} vs "
                             f"{tuple(mine.shape)} {mine.dtype}")
        mine.copy_(theirs)
    return TrainState(model, AdamWState(opt.mu, opt.nu, int(saved["count"])), int(saved["step"]))

