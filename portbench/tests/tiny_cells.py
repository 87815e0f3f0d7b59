"""The benchmark's cells cut to a size a CPU test can hold: the real
cell's files with small widths and short, small traffic.  Each cell's CPU
form is a file of its own, tiny/<cell>.py, with `config()` (the
configuration at those widths) and `TRAFFIC` (what it changes in the
cell's mix).  Only the harness's logic is tested at this size; no number
of it is a device number."""

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
    """`caco_base` at caco_tiny's widths."""
    c = _config("caco_base")
    c["audio"].update(SMALL)
    for k in ("text", "decoder"):
        c[k].update(SMALL, vocab_size=128, max_position_embeddings=64)
    c["num_attention_pool_heads"], c["projection_size"] = 2, 32
    return c


TRAIN = dict(batch=4, seq_len=48, buffer_seconds=0.5, pool_clips=16, clip_seconds=[0.3, 0.5],
             reference_rows=2, profile_steps=2)


def tiny_file(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "portbench", "tests", "tiny", f"{name}.py")


def form(name: str, root: str = ROOT):
    """The cell's CPU form: its tiny file, loaded."""
    return harness.load_file(tiny_file(name, root))


def cell(name: str, root: str = ROOT, **traffic) -> harness.Cell:
    tiny = form(name, root)
    real = harness.resolve(root, name)
    return dataclasses.replace(real, config=tiny.config(),
                               traffic=dict(real.traffic, **tiny.TRAFFIC, **traffic))


def context(name: str, seed: int = 2 ** 31 + 77, seconds: float = 0.3, trace: bool = False,
            **traffic) -> harness.Context:
    return harness.Context(cell(name, **traffic), seed, seconds, trace, device="cpu")
