"""Released-checkpoint layout ↔ the JAX-layout parameter tree, in numpy
(a copy of cacophony_tpu/checkpoints/convert.py:29-196 and :209-365).

The released Cacophony checkpoint is a Flax msgpack tree with layout
`state['0']['params']` (reference src/caco/load_model.py:15-20):

- top level: `audio_module`, `text_module`, `decoder_module`,
  `logit_scale`, `text_proj`, `audio_attention_pool`;
- audio encoder: flax auto-names — `Dense_0` patch projection,
  `freq_positional_embedding`, `AudioEncoderLayer_{i}` × L each with
  `LayerNorm_0/1`, `MultiHeadDotProductAttention_0` (per-head kernels
  (D, H, Dh)), `MLP_0/{Dense_0,Dense_1}`, a final `LayerNorm_0`;
- text towers: HF-style names under `encoder/layer`, either scan-stacked
  along a leading layer axis under `ScanFlaxRobertaLayer_0` or numbered
  `'0'..'L-1'`; both load.

The JAX layout (what `checkpoints/bridge.py:params_from_jax` takes): fused
QKV, merged-head 2-D kernels, each layer stack's leaves stacked (L, ...).
Every function is a pure tree → tree map.  A leaf may be a numpy array or,
for a bfloat16 checkpoint, a torch tensor (numpy has no bfloat16): it
becomes fp32 numpy here, which is exact and is what the bridge stores.

The stage-1 AudioMAE file holds `AudioEncoder_0` (the audio tower's
layout) and `AudioDecoder_0` (the same layer names, `Dense_0` in_proj,
`restore_patch` mask token, `Dense_1` out_proj); `convert_audiomae_params`
and `audiomae_params_to_reference` map it both ways, and
`transplant_audiomae_encoder` starts a CacoModel's audio tower from a
stage-1 encoder.  `convert_hf_roberta` takes an HF `FlaxRobertaModel`
tree (what `checkpoints/hf.py` reads from a local HF directory) to the text
tower's `embeddings` and `blocks`.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x)


def _tree_map(fn: Callable, *trees):
    """jax.tree_util.tree_map over nested dicts (same keys in every tree)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _dense(t):
    return {"w": _np(t["kernel"]), "b": _np(t["bias"])}


def _ln(t):
    return {"scale": _np(t["scale"]), "bias": _np(t["bias"])}


def _merge_heads_kernel(k):
    """flax MHA per-head kernel (D, H, Dh) → (D, H*Dh)."""
    return k.reshape(k.shape[0], -1)


def _stack(trees):
    return _tree_map(lambda *xs: np.stack([_np(x) for x in xs], axis=0), *trees)


# ------------------------------------------------------------- audio tower

def _audio_block(layer):
    mha = layer["MultiHeadDotProductAttention_0"]
    wq = _merge_heads_kernel(_np(mha["query"]["kernel"]))
    wk = _merge_heads_kernel(_np(mha["key"]["kernel"]))
    wv = _merge_heads_kernel(_np(mha["value"]["kernel"]))
    bq = _np(mha["query"]["bias"]).reshape(-1)
    bk = _np(mha["key"]["bias"]).reshape(-1)
    bv = _np(mha["value"]["bias"]).reshape(-1)
    d = wq.shape[0]
    wo = _np(mha["out"]["kernel"]).reshape(-1, d)  # (H, Dh, D) → (H*Dh, D)
    return {
        "ln1": _ln(layer["LayerNorm_0"]),
        "attn": {
            "qkv": {"w": np.concatenate([wq, wk, wv], axis=-1),
                    "b": np.concatenate([bq, bk, bv])},
            "o": {"w": wo, "b": _np(mha["out"]["bias"])},
        },
        "ln2": _ln(layer["LayerNorm_1"]),
        "mlp": {"w1": _dense(layer["MLP_0"]["Dense_0"]),
                "w2": _dense(layer["MLP_0"]["Dense_1"])},
    }


def convert_audio_encoder(ref: dict) -> dict:
    num_layers = sum(1 for k in ref if k.startswith("AudioEncoderLayer_"))
    return {
        "patch_proj": _dense(ref["Dense_0"]),
        "freq_pos_embed": _np(ref["freq_positional_embedding"]),
        "blocks": _stack([_audio_block(ref[f"AudioEncoderLayer_{i}"])
                          for i in range(num_layers)]),
        "ln_f": _ln(ref["LayerNorm_0"]),
    }


def convert_audio_decoder(ref: dict) -> dict:
    num_layers = sum(1 for k in ref if k.startswith("AudioEncoderLayer_"))
    return {
        "in_proj": _dense(ref["Dense_0"]),
        "freq_pos_embed": _np(ref["freq_positional_embedding"]),
        "mask_token": _np(ref["restore_patch"]),
        "blocks": _stack([_audio_block(ref[f"AudioEncoderLayer_{i}"])
                          for i in range(num_layers)]),
        "ln_f": _ln(ref["LayerNorm_0"]),
        "out_proj": _dense(ref["Dense_1"]),
    }


# -------------------------------------------------------------- text towers

def _roberta_layers(encoder_tree: dict) -> dict:
    """The layer tree with leaves stacked (L, ...), whichever layout the
    checkpoint uses (scan-stacked or numbered)."""
    layer = encoder_tree["layer"]
    if "ScanFlaxRobertaLayer_0" in layer:
        return layer["ScanFlaxRobertaLayer_0"]
    indices = sorted(int(k) for k in layer.keys())
    return _stack([layer[str(i)] for i in indices])


def _text_blocks(stacked: dict) -> dict:
    sa = stacked["attention"]["self"]
    blocks = {
        "attn": {
            "qkv": {"w": np.concatenate([_np(sa["query"]["kernel"]),
                                         _np(sa["key"]["kernel"]),
                                         _np(sa["value"]["kernel"])], axis=-1),
                    "b": np.concatenate([_np(sa["query"]["bias"]),
                                         _np(sa["key"]["bias"]),
                                         _np(sa["value"]["bias"])], axis=-1)},
            "o": _dense(stacked["attention"]["output"]["dense"]),
        },
        "ln_attn": _ln(stacked["attention"]["output"]["LayerNorm"]),
        "mlp_in": _dense(stacked["intermediate"]["dense"]),
        "mlp_out": _dense(stacked["output"]["dense"]),
        "ln_mlp": _ln(stacked["output"]["LayerNorm"]),
    }
    if "crossattention" in stacked:
        ca = stacked["crossattention"]["self"]
        blocks["cross"] = {
            "q": _dense(ca["query"]),
            "kv": {"w": np.concatenate([_np(ca["key"]["kernel"]),
                                        _np(ca["value"]["kernel"])], axis=-1),
                   "b": np.concatenate([_np(ca["key"]["bias"]),
                                        _np(ca["value"]["bias"])], axis=-1)},
            "o": _dense(stacked["crossattention"]["output"]["dense"]),
        }
        blocks["ln_cross"] = _ln(stacked["crossattention"]["output"]["LayerNorm"])
    return blocks


def convert_text_encoder(ref: dict) -> dict:
    emb = ref["embeddings"]
    return {
        "embeddings": {
            "word": _np(emb["word_embeddings"]["embedding"]),
            "position": _np(emb["position_embeddings"]["embedding"]),
            "token_type": _np(emb["token_type_embeddings"]["embedding"]),
            "ln": _ln(emb["LayerNorm"]),
        },
        "blocks": _text_blocks(_roberta_layers(ref["encoder"])),
        "pooler": {
            "key": _dense(ref["pooler"]["key_proj"]),
            "value": _dense(ref["pooler"]["value_proj"]),
            "query": _np(ref["pooler"]["attention_pool_query"]),
        },
    }


def convert_caption_decoder(ref: dict) -> dict:
    return {
        "blocks": _text_blocks(_roberta_layers(ref["encoder"])),
        "vocab_proj": _dense(ref["decoder_proj"]),
    }


# ------------------------------------------------------------------- models

def convert_caco_params(ref_params: dict) -> dict:
    """Full released-CACO tree (`state['0']['params']`) → the JAX-layout tree."""
    expected = {"audio_module", "text_module", "audio_attention_pool",
                "text_proj", "logit_scale"}
    missing = expected - set(ref_params)
    if missing:
        raise KeyError(
            f"checkpoint layout drift: missing top-level keys {sorted(missing)} "
            f"(found {sorted(ref_params)}). Expected the released Cacophony "
            "msgpack layout state['0']['params'] (reference load_model.py:15-20)."
        )
    pool = ref_params["audio_attention_pool"]
    out = {
        "audio": convert_audio_encoder(ref_params["audio_module"]),
        "text": convert_text_encoder(ref_params["text_module"]),
        "audio_pool": {
            "kv": _dense(pool["Dense_0"]),
            "query": _np(pool["query"]),
            "out": _dense(pool["Dense_1"]),
        },
        "text_proj": _dense(ref_params["text_proj"]),
        "logit_scale": _np(ref_params["logit_scale"]),
    }
    if "decoder_module" in ref_params:
        out["decoder"] = convert_caption_decoder(ref_params["decoder_module"])
    return out


def convert_audiomae_params(ref_params: dict) -> dict:
    """Stage-1 AudioMAE tree (`state['0']['params']`) → {encoder, decoder}."""
    out = {"encoder": convert_audio_encoder(ref_params["AudioEncoder_0"])}
    if "AudioDecoder_0" in ref_params:
        out["decoder"] = convert_audio_decoder(ref_params["AudioDecoder_0"])
    return out


# --------------------------------------------------- inverse (export) maps

def _unstack(tree: dict):
    """Split a stacked (L, ...) block tree into per-layer trees."""
    num = _leaves(tree)[0].shape[0]
    return [_tree_map(lambda x: np.asarray(x)[i], tree) for i in range(num)]


def _split_heads_kernel(w, num_heads):
    d_in, d_out = w.shape
    return w.reshape(d_in, num_heads, d_out // num_heads)


def _audio_block_to_reference(block: dict, num_heads: int) -> dict:
    wq, wk, wv = np.split(block["attn"]["qkv"]["w"], 3, axis=-1)
    bq, bk, bv = np.split(block["attn"]["qkv"]["b"], 3)
    d = wq.shape[0]
    hd = d // num_heads
    return {
        "LayerNorm_0": {"scale": block["ln1"]["scale"], "bias": block["ln1"]["bias"]},
        "MultiHeadDotProductAttention_0": {
            "query": {"kernel": _split_heads_kernel(wq, num_heads),
                      "bias": bq.reshape(num_heads, hd)},
            "key": {"kernel": _split_heads_kernel(wk, num_heads),
                    "bias": bk.reshape(num_heads, hd)},
            "value": {"kernel": _split_heads_kernel(wv, num_heads),
                      "bias": bv.reshape(num_heads, hd)},
            "out": {"kernel": block["attn"]["o"]["w"].reshape(num_heads, hd, d),
                    "bias": block["attn"]["o"]["b"]},
        },
        "LayerNorm_1": {"scale": block["ln2"]["scale"], "bias": block["ln2"]["bias"]},
        "MLP_0": {
            "Dense_0": {"kernel": block["mlp"]["w1"]["w"], "bias": block["mlp"]["w1"]["b"]},
            "Dense_1": {"kernel": block["mlp"]["w2"]["w"], "bias": block["mlp"]["w2"]["b"]},
        },
    }


def audio_encoder_to_reference(params: dict, num_heads: int) -> dict:
    out = {
        "Dense_0": {"kernel": np.asarray(params["patch_proj"]["w"]),
                    "bias": np.asarray(params["patch_proj"]["b"])},
        "freq_positional_embedding": np.asarray(params["freq_pos_embed"]),
        "LayerNorm_0": {"scale": np.asarray(params["ln_f"]["scale"]),
                        "bias": np.asarray(params["ln_f"]["bias"])},
    }
    for i, block in enumerate(_unstack(params["blocks"])):
        out[f"AudioEncoderLayer_{i}"] = _audio_block_to_reference(block, num_heads)
    return out


def _text_blocks_to_reference(blocks: dict) -> dict:
    """Stacked text blocks → scan layout (leaves keep the (L, ...) axis)."""
    wq, wk, wv = (np.asarray(x) for x in np.split(
        np.asarray(blocks["attn"]["qkv"]["w"]), 3, axis=-1))
    bq, bk, bv = (np.asarray(x) for x in np.split(
        np.asarray(blocks["attn"]["qkv"]["b"]), 3, axis=-1))
    out = {
        "attention": {
            "self": {
                "query": {"kernel": wq, "bias": bq},
                "key": {"kernel": wk, "bias": bk},
                "value": {"kernel": wv, "bias": bv},
            },
            "output": {
                "dense": {"kernel": np.asarray(blocks["attn"]["o"]["w"]),
                          "bias": np.asarray(blocks["attn"]["o"]["b"])},
                "LayerNorm": {"scale": np.asarray(blocks["ln_attn"]["scale"]),
                              "bias": np.asarray(blocks["ln_attn"]["bias"])},
            },
        },
        "intermediate": {"dense": {"kernel": np.asarray(blocks["mlp_in"]["w"]),
                                   "bias": np.asarray(blocks["mlp_in"]["b"])}},
        "output": {
            "dense": {"kernel": np.asarray(blocks["mlp_out"]["w"]),
                      "bias": np.asarray(blocks["mlp_out"]["b"])},
            "LayerNorm": {"scale": np.asarray(blocks["ln_mlp"]["scale"]),
                          "bias": np.asarray(blocks["ln_mlp"]["bias"])},
        },
    }
    if "cross" in blocks:
        ck, cv = np.split(np.asarray(blocks["cross"]["kv"]["w"]), 2, axis=-1)
        cbk, cbv = np.split(np.asarray(blocks["cross"]["kv"]["b"]), 2, axis=-1)
        out["crossattention"] = {
            "self": {
                "query": {"kernel": np.asarray(blocks["cross"]["q"]["w"]),
                          "bias": np.asarray(blocks["cross"]["q"]["b"])},
                "key": {"kernel": ck, "bias": cbk},
                "value": {"kernel": cv, "bias": cbv},
            },
            "output": {
                "dense": {"kernel": np.asarray(blocks["cross"]["o"]["w"]),
                          "bias": np.asarray(blocks["cross"]["o"]["b"])},
                "LayerNorm": {"scale": np.asarray(blocks["ln_cross"]["scale"]),
                              "bias": np.asarray(blocks["ln_cross"]["bias"])},
            },
        }
    return out


def text_encoder_to_reference(params: dict) -> dict:
    emb = params["embeddings"]
    return {
        "embeddings": {
            "word_embeddings": {"embedding": np.asarray(emb["word"])},
            "position_embeddings": {"embedding": np.asarray(emb["position"])},
            "token_type_embeddings": {"embedding": np.asarray(emb["token_type"])},
            "LayerNorm": {"scale": np.asarray(emb["ln"]["scale"]),
                          "bias": np.asarray(emb["ln"]["bias"])},
        },
        "encoder": {"layer": {"ScanFlaxRobertaLayer_0":
                              _text_blocks_to_reference(params["blocks"])}},
        "pooler": {
            "key_proj": {"kernel": np.asarray(params["pooler"]["key"]["w"]),
                         "bias": np.asarray(params["pooler"]["key"]["b"])},
            "value_proj": {"kernel": np.asarray(params["pooler"]["value"]["w"]),
                           "bias": np.asarray(params["pooler"]["value"]["b"])},
            "attention_pool_query": np.asarray(params["pooler"]["query"]),
        },
    }


def caption_decoder_to_reference(params: dict) -> dict:
    return {
        "encoder": {"layer": {"ScanFlaxRobertaLayer_0":
                              _text_blocks_to_reference(params["blocks"])}},
        "decoder_proj": {"kernel": np.asarray(params["vocab_proj"]["w"]),
                         "bias": np.asarray(params["vocab_proj"]["b"])},
    }


def caco_params_to_reference(params: dict, audio_num_heads: int) -> dict:
    """The JAX-layout CACO tree → the released-checkpoint layout (the exact
    inverse of convert_caco_params)."""
    out = {
        "audio_module": audio_encoder_to_reference(params["audio"], audio_num_heads),
        "text_module": text_encoder_to_reference(params["text"]),
        "audio_attention_pool": {
            "Dense_0": {"kernel": np.asarray(params["audio_pool"]["kv"]["w"]),
                        "bias": np.asarray(params["audio_pool"]["kv"]["b"])},
            "query": np.asarray(params["audio_pool"]["query"]),
            "Dense_1": {"kernel": np.asarray(params["audio_pool"]["out"]["w"]),
                        "bias": np.asarray(params["audio_pool"]["out"]["b"])},
        },
        "text_proj": {"kernel": np.asarray(params["text_proj"]["w"]),
                      "bias": np.asarray(params["text_proj"]["b"])},
        "logit_scale": np.asarray(params["logit_scale"]),
    }
    if "decoder" in params:
        out["decoder_module"] = caption_decoder_to_reference(params["decoder"])
    return out


def audio_decoder_to_reference(params: dict, num_heads: int) -> dict:
    out = {
        "Dense_0": {"kernel": np.asarray(params["in_proj"]["w"]),
                    "bias": np.asarray(params["in_proj"]["b"])},
        "freq_positional_embedding": np.asarray(params["freq_pos_embed"]),
        "restore_patch": np.asarray(params["mask_token"]),
        "LayerNorm_0": {"scale": np.asarray(params["ln_f"]["scale"]),
                        "bias": np.asarray(params["ln_f"]["bias"])},
        "Dense_1": {"kernel": np.asarray(params["out_proj"]["w"]),
                    "bias": np.asarray(params["out_proj"]["b"])},
    }
    for i, block in enumerate(_unstack(params["blocks"])):
        out[f"AudioEncoderLayer_{i}"] = _audio_block_to_reference(block, num_heads)
    return out


def audiomae_params_to_reference(params: dict, enc_num_heads: int, dec_num_heads: int) -> dict:
    """The JAX-layout AudioMAE tree → the released stage-1 layout
    (`AudioEncoder_0` / `AudioDecoder_0`, reference load_model.py:69)."""
    out = {"AudioEncoder_0": audio_encoder_to_reference(params["encoder"], enc_num_heads)}
    if "decoder" in params:
        out["AudioDecoder_0"] = audio_decoder_to_reference(params["decoder"], dec_num_heads)
    return out


# ------------------------------------------- pretrained-weight transplants

def convert_hf_roberta(hf_params: dict) -> dict:
    """HuggingFace FlaxRobertaModel params → the text tower's `embeddings`
    and stacked `blocks` (reference roberta_update_pretrained_parameters,
    roberta_text_model.py:680-734).  The HF tree: embeddings/{word_,
    position_,token_type_embeddings, LayerNorm}, encoder/layer/{'0'..'L-1'}.
    The HF pooler is a dense-tanh head, not the attention pooler: it is not
    taken, and the caller keeps its pooler's own values."""
    layer_tree = hf_params["encoder"]["layer"]
    stacked = _stack([layer_tree[str(i)] for i in range(len(layer_tree))])
    emb = hf_params["embeddings"]
    return {
        "embeddings": {
            "word": _np(emb["word_embeddings"]["embedding"]),
            "position": _np(emb["position_embeddings"]["embedding"]),
            "token_type": _np(emb["token_type_embeddings"]["embedding"]),
            "ln": _ln(emb["LayerNorm"]),
        },
        "blocks": _text_blocks(stacked),
    }


def transplant_audiomae_encoder(caco_model: torch.nn.Module, mae_model: torch.nn.Module):
    """Start a CacoModel's audio tower from a stage-1 AudioMAE's encoder
    (reference ast_update_pretrained_parameters, mae.py:227-234): the
    encoder's parameters are copied into `caco_model.audio` in place, each
    keeping the CacoModel's device; the rest is left as it is.  → caco_model."""
    caco_model.audio.load_state_dict(mae_model.encoder.state_dict())
    return caco_model
