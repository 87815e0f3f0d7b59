"""The plain reference against the port at caco_tiny widths on the CPU:
with the program in fp32 every compared number is at rounding level, so
the reference computes the program's function (the frontend, the patch
grid, the encoder, the poolers, the text towers
with their dropout masks, the caption loss, the MAE masking, decoder and
reconstruction loss, and AdamW)."""

import pytest

from tiny_cells import context

FP32 = {
    "caco_base.embed_10s": {"embed_gap": 1e-5},
    "caco_base.train_10s": {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-2},
    "caco_base.text_query": {"text_gap": 1e-5, "search_gap": 1e-5},
    "audiomae_base.pretrain_10s": {"loss_gap": 1e-4, "grad_gap": 1e-5, "change_gap": 1e-2,
                                   "grad_elem_gap": 1e-5, "loss_step_gap": 1e-5},
}

# cells whose `grad_elem_gap` reads the first gradient from Adam's first
# moment, which the program stores in bf16 unless told otherwise: here it
# is kept in fp32, so that this number too is at rounding level
MOMENT_FP32 = {"audiomae_base.pretrain_10s"}


@pytest.mark.parametrize("name", list(FP32))
def test_reference_is_the_programs_function(name):
    """(The change after three steps differs by the program's bf16 Adam
    first moment, its decay rounded to bf16: 1e-2 of the median leaf's;
    so does the third step's loss, which follows the first update: the
    stage-1 cell's reads 1e-5 to 2e-5 there, its first two 1e-7.)"""
    ctx = context(name, dtype="float32")
    if name in MOMENT_FP32:
        ctx.cell.traffic["optimizer"] = dict(ctx.cell.traffic["optimizer"], adam_mu_dtype=None)
    res = ctx.cell.driver().run(ctx)
    for key, tol in FP32[name].items():
        assert res["checks"][key] < tol, (key, res["checks"])
