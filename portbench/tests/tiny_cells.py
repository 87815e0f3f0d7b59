"""The benchmark's cells cut to a size a CPU test can hold: the real
cell's files with the widths of `caco_tiny` and short, small traffic.
Only the harness's logic is tested at this size; no number of it is a
device number."""

from __future__ import annotations

import dataclasses
import json
import os

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def caco() -> dict:
    c = _config("caco_base")
    c["audio"].update(SMALL)
    for k in ("text", "decoder"):
        c[k].update(SMALL, vocab_size=128, max_position_embeddings=64)
    c["num_attention_pool_heads"], c["projection_size"] = 2, 32
    return c


TRAIN = dict(batch=4, seq_len=48, buffer_seconds=0.5, pool_clips=16, clip_seconds=[0.3, 0.5],
             reference_rows=2, profile_steps=2)
TINY = {
    "caco_base.embed_10s": (caco, dict(buffer_seconds=1.0, batch_size=4, pool_clips=10, passes=1,
                                       short_seconds=[0.3, 1.0], check_clips=4, profile_calls=1)),
    "caco_base.train_10s": (caco, dict(TRAIN, text_len=12, caption_tokens=[4, 10])),
    "caco_base.text_query": (caco, dict(batch_size=4, text_len=12, prompts=16, prompt_tokens=[3, 10],
                                        gallery_rows=5000, slab_rows=1024, profile_queries=3,
                                        check_queries=8)),
}


def cell(name: str, **traffic) -> harness.Cell:
    make, over = TINY[name]
    real = harness.resolve(ROOT, name)
    return dataclasses.replace(real, config=make(), traffic=dict(real.traffic, **over, **traffic))


def context(name: str, seed: int = 2 ** 31 + 77, seconds: float = 0.3, trace: bool = False,
            **traffic) -> harness.Context:
    return harness.Context(cell(name, **traffic), seed, seconds, trace, device="cpu")
