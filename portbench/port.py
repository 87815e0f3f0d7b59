"""The program under test, as the drivers build it: the port's typed
configurations from a configuration file's groups, and its model with the
harness's weights loaded on the card."""

from __future__ import annotations

import torch

from cacophony_tpu_torch import configs as pc

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def caco_config(c: dict, dtype: str) -> "pc.CacoConfig":
    return pc.CacoConfig(audio=pc.AudioEncoderConfig(**c["audio"]),
                         text=pc.TextConfig(**c["text"]), decoder=pc.TextConfig(**c["decoder"]),
                         logit_scale_init=c["logit_scale_init"],
                         num_attention_pool_heads=c["num_attention_pool_heads"],
                         projection_size=c["projection_size"], use_decoder=c["use_decoder"],
                         dtype=DTYPES[dtype])


def frontend_config(c: dict) -> "pc.FrontendConfig":
    return pc.FrontendConfig(**c["frontend"])


def build(module_cls, args, weights: dict, device) -> torch.nn.Module:
    """The port's parameter module built on `device` (zeros), then the
    harness's weights copied in by name (strict: the layouts must agree)."""
    with torch.device(device):
        model = module_cls(*args)
    model.load_state_dict(weights, strict=True)
    return model
