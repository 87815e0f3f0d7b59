"""JAX parameter tree ↔ the port's modules, leaf for leaf.

The JAX package keeps parameters as nested dicts of arrays with each layer
stack's leaves stacked on axis 0 (cacophony_tpu/models/layers.py:48).  The
port's module names mirror those keys, so the map is by name: stacked leaves
under `blocks` are unstacked into the `nn.ModuleList` entries
(`audio/blocks/ln1/scale[i]` → `audio.blocks.{i}.ln1.scale`).

`params_from_jax` builds a `CacoModel` from a CACO tree or, given an
`AudioMAEConfig`, an `AudioMAE` from a stage-1 tree `{encoder, decoder}`
(encoder only where the tree has no decoder).  Every leaf must land on a
parameter of the same shape and every parameter must be filled; an unknown
key raises.  `params_to_jax` is the inverse
(blocks stacked again), and `decay_mask` gives the JAX optimizer's weight-
decay mask, which is taken from the rank of the JAX leaf: a parameter under
`blocks` has one axis more there than in the port.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from cacophony_tpu_torch.configs import AudioMAEConfig, CacoConfig
from cacophony_tpu_torch.models.audio import AudioMAE
from cacophony_tpu_torch.models.caco import CacoModel


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def jax_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """Flatten a JAX parameter tree (numpy leaves) to the port's
    state_dict names: stacked `blocks` leaves are split on axis 0."""
    out = {}
    for name, leaf in _flatten(tree).items():
        parts = name.split(".")
        if "blocks" in parts:
            i = parts.index("blocks")
            for layer in range(leaf.shape[0]):
                out[".".join(parts[:i + 1] + [str(layer)] + parts[i + 1:])] = leaf[layer]
        else:
            out[name] = leaf
    return out


def params_from_jax(tree: Mapping, cfg: Union[CacoConfig, AudioMAEConfig]):
    """Build the model for `cfg` (a CacoModel, or an AudioMAE for a stage-1
    config) holding exactly the tree's parameters."""
    flat = jax_state_dict(tree)
    if isinstance(cfg, AudioMAEConfig):
        model = AudioMAE(cfg.encoder, cfg.decoder if "decoder" in tree else None)
    else:
        model = CacoModel(cfg)
    state = model.state_dict()
    unknown = sorted(set(flat) - set(state))
    missing = sorted(set(state) - set(flat))
    if unknown or missing:
        raise KeyError(f"JAX tree does not match the model: unknown {unknown[:8]}, "
                       f"missing {missing[:8]}")
    for name, leaf in flat.items():
        if tuple(leaf.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: JAX shape {leaf.shape} vs model {tuple(state[name].shape)}")
        state[name] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    model.load_state_dict(state)
    return model


def _jax_name(name: str) -> str:
    """Port parameter name → its JAX leaf's name (the layer index dropped)."""
    parts = name.split(".")
    if "blocks" in parts:
        i = parts.index("blocks")
        del parts[i + 1]
    return ".".join(parts)


def params_to_jax(model: nn.Module) -> dict:
    """The port's parameters as a JAX-layout nested dict of fp32 numpy
    arrays, each `blocks` stack's layers stacked on axis 0."""
    stacks: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        layer = int(parts[parts.index("blocks") + 1]) if "blocks" in parts else 0
        stacks.setdefault(_jax_name(name), {})[layer] = t.detach().float().cpu().numpy()
    tree: dict = {}
    for name, layers in stacks.items():
        leaf = (np.stack([layers[i] for i in range(len(layers))])
                if ".blocks." in f".{name}." else layers[0])
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """JAX `make_optimizer`'s weight-decay mask, `jnp.ndim(leaf) >= 2`
    (train/train.py:108-112), over the port's parameter names.  Because
    the JAX leaves of a layer stack carry the layer axis, every block bias
    and block LayerNorm scale and bias IS decayed there (the comment beside
    the mask says otherwise); top-level biases, `ln_f`, `embeddings.ln` and
    `logit_scale` are not.  The port reproduces that."""
    return {name: p.dim() + ("blocks" in name.split(".")) >= 2
            for name, p in model.named_parameters()}
