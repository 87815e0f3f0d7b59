"""The plain reference against the port at caco_tiny widths on the CPU:
with the program in fp32 every compared number is at rounding level, so
the reference computes the program's function (the frontend, the patch
grid, the encoder, the poolers, the text towers
with their dropout masks, the caption loss and AdamW)."""

import pytest

from tiny_cells import context

FP32 = {
    "caco_base.embed_10s": {"embed_gap": 1e-5},
    "caco_base.train_10s": {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-2},
    "caco_base.text_query": {"text_gap": 1e-5, "search_gap": 1e-5},
}


@pytest.mark.parametrize("name", list(FP32))
def test_reference_is_the_programs_function(name):
    """(The change after three steps differs by the program's bf16 Adam
    first moment, its decay rounded to bf16: 1e-2 of the median leaf's.)"""
    ctx = context(name, dtype="float32")
    res = ctx.cell.driver().run(ctx)
    for key, tol in FP32[name].items():
        assert res["checks"][key] < tol, (key, res["checks"])
