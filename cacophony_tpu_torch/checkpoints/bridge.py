"""JAX parameter tree → the port's modules, leaf for leaf.

The JAX package keeps parameters as nested dicts of arrays with each layer
stack's leaves stacked on axis 0 (cacophony_tpu/models/layers.py:48).  The
port's module names mirror those keys, so the map is by name: stacked leaves
under `blocks` are unstacked into the `nn.ModuleList` entries
(`audio/blocks/ln1/scale[i]` → `audio.blocks.{i}.ln1.scale`).

Every leaf must land on a parameter of the same shape and every parameter
must be filled; an unknown key raises.  The `decoder` subtree (the caption
decoder) is accepted and left unused until the decoder is ported.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cacophony_tpu_torch.configs import CacoConfig
from cacophony_tpu_torch.models.caco import CacoModel

UNUSED_SUBTREES = ("decoder",)


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
        if name.split(".")[0] in UNUSED_SUBTREES:
            continue
        parts = name.split(".")
        if "blocks" in parts:
            i = parts.index("blocks")
            for layer in range(leaf.shape[0]):
                out[".".join(parts[:i + 1] + [str(layer)] + parts[i + 1:])] = leaf[layer]
        else:
            out[name] = leaf
    return out


def params_from_jax(tree: Mapping, cfg: CacoConfig) -> CacoModel:
    """Build a CacoModel for `cfg` holding exactly the tree's parameters."""
    flat = jax_state_dict(tree)
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
