"""A local HuggingFace RoBERTa directory → the text tower's weights
(the port's counterpart of `FlaxRobertaModel.from_pretrained(dir)` +
`convert_hf_roberta` in cacophony_tpu/train/runner.py:138-144).

    load_hf_text_tower(model, "path/to/roberta-base")  # a CacoModel

Paper stage 2 starts its text tower from RoBERTa.  The directory is read
with no hub access; a name that is not a directory raises.  Weights are
taken from the first of these files that exists:

1. `flax_model.msgpack` (a `FlaxRobertaModel` or `…ForMaskedLM` save), read
   by `checkpoints/msgpack.py`; a top-level `roberta` key is stripped;
2. `model.safetensors`, read by `read_safetensors` below (F32, F16, BF16);
3. `pytorch_model.bin`, read with `torch.load(weights_only=True)`.

The torch formats' names (`roberta.` prefix or none; `lm_head.*`,
`pooler.*` and the `embeddings.*_ids` buffers ignored) are mapped to the
Flax tree: a Linear's `(out, in)` weight is transposed to the `kernel`,
LayerNorm `weight`/`gamma` → `scale` and `bias`/`beta` → `bias`,
`*_embeddings.weight` → `embedding`.  `config.json`, where present, and
every shape are checked against the text tower's widths (vocabulary,
positions, token types, hidden size, layers, MLP width): a mismatch
raises here rather than as a shape error later.  Only `embeddings` and
`blocks` of `model.text` are replaced, as JAX's `{**params["text"],
**imported}` does; the pooler, `text_proj`, the decoder and the audio
tower keep their values.  RoBERTa's 514 position rows are copied whole.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from cacophony_tpu_torch.checkpoints.bridge import jax_state_dict
from cacophony_tpu_torch.checkpoints.convert import convert_hf_roberta
from cacophony_tpu_torch.checkpoints.msgpack import loads

FORMATS = ("flax_model.msgpack", "model.safetensors", "pytorch_model.bin")
_IGNORED_PREFIXES = ("lm_head.", "pooler.")
_IGNORED = {"embeddings.position_ids", "embeddings.token_type_ids"}
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file → {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header of `dtype`, `shape` and `data_offsets`
    (relative to the end of the header), then the bytes.  `__metadata__`
    is ignored, and so are tensors of other dtypes (integer buffers).  The
    tensors are views of one buffer holding the file's data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__" or info["dtype"] not in _SAFETENSORS_DTYPES:
            continue
        dtype, (lo, hi) = _SAFETENSORS_DTYPES[info["dtype"]], info["data_offsets"]
        if hi == lo:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(data, dtype=torch.uint8, offset=lo, count=hi - lo)
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def _flax_leaf(parent: str, leaf: str, t: torch.Tensor):
    """A torch-format leaf → (Flax leaf name, numpy array)."""
    x = t.detach().float().numpy() if t.dtype != torch.float32 else t.detach().numpy()
    if parent == "LayerNorm":
        return {"weight": "scale", "gamma": "scale", "bias": "bias", "beta": "bias"}[leaf], x
    if parent.endswith("_embeddings"):
        return "embedding", x
    return ("kernel", x.T) if leaf == "weight" else ("bias", x)


def torch_to_flax(state: Dict[str, torch.Tensor]) -> dict:
    """A RoBERTa state dict (torch names) → the FlaxRobertaModel tree."""
    tree: dict = {}
    for name, t in state.items():
        if name.startswith("roberta."):
            name = name[len("roberta."):]
        if name.startswith(_IGNORED_PREFIXES) or name in _IGNORED:
            continue
        *path, parent, leaf = name.split(".")
        node = tree
        for k in path + [parent]:
            node = node.setdefault(k, {})
        key, x = _flax_leaf(parent, leaf, t)
        node[key] = np.ascontiguousarray(x)
    return tree


def read_hf_roberta(path: str) -> dict:
    """A local HF RoBERTa directory → the FlaxRobertaModel parameter tree
    (numpy leaves), from the first format of FORMATS it holds."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a directory: the HF RoBERTa files must be local (a directory "
            f"holding one of {', '.join(FORMATS)}); nothing is downloaded")
    for fmt in FORMATS:
        file = os.path.join(path, fmt)
        if not os.path.exists(file):
            continue
        if fmt == "flax_model.msgpack":
            with open(file, "rb") as f:
                tree = loads(f.read())
            return tree.get("roberta", tree)
        if fmt == "model.safetensors":
            return torch_to_flax(read_safetensors(file))
        return torch_to_flax(torch.load(file, map_location="cpu", weights_only=True))
    raise FileNotFoundError(f"{path} holds none of {', '.join(FORMATS)}")


def _text_widths(text: torch.nn.Module) -> dict:
    """The text tower's widths, read from its parameters."""
    word = text.embeddings.word
    return {"vocab_size": word.shape[0], "max_position_embeddings": text.embeddings.position.shape[0],
            "type_vocab_size": text.embeddings.token_type.shape[0], "hidden_size": word.shape[1],
            "num_hidden_layers": len(text.blocks),
            "intermediate_size": text.blocks[0].mlp_in.w.shape[1]}


def check_hf_config(path: str, text: torch.nn.Module) -> None:
    """`config.json`'s widths, where the file is there, against the tower's."""
    file = os.path.join(path, "config.json")
    if not os.path.exists(file):
        return
    with open(file) as f:
        hf = json.load(f)
    bad = {k: (hf[k], v) for k, v in _text_widths(text).items() if k in hf and hf[k] != v}
    if bad:
        raise ValueError(f"{file} does not fit the text tower (file, model): {bad}")


def load_hf_text_tower(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Replace `model.text`'s embeddings and blocks with a local HF RoBERTa
    directory's, in place, cast to the parameters' dtype (fp32 master
    weights) on their device.  → model."""
    text = model.text
    check_hf_config(path, text)
    flat = jax_state_dict(convert_hf_roberta(read_hf_roberta(path)))
    params = dict(text.named_parameters())
    replaced = {n for n in params if n.startswith(("embeddings.", "blocks."))}
    unknown, missing = sorted(set(flat) - replaced), sorted(replaced - set(flat))
    if unknown or missing:
        raise ValueError(f"HF tree does not fit the text tower ({len(text.blocks)} layers): "
                         f"unknown {unknown[:8]}, missing {missing[:8]}")
    for name, leaf in flat.items():
        if tuple(leaf.shape) != tuple(params[name].shape):
            raise ValueError(f"text.{name}: HF shape {tuple(leaf.shape)} vs model "
                             f"{tuple(params[name].shape)}")
    with torch.no_grad():
        for name, leaf in flat.items():
            params[name].copy_(torch.from_numpy(np.array(leaf)))  # the reader's views are read-only
    return model
