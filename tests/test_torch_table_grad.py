"""The gather from the learned frequency table and its fp32 gradient
(`models/audio.py:table_rows`, `_TableRows`; `ops/_kernels.py:table_grad`).

The forward gives the bits of `table.to(dtype)[inds]`, the gradient of
the layer input is untouched, and the table's gradient is the fp32 sum of
the upstream rows: against an fp64 `index_add_` it is off by fp32
rounding alone (relative 1e-5 over 8 000 rows a table row), where the
gather's own backward in bf16 is off by most of the norm.  On the CPU the
plain sum runs; the kernel is held to it on the card
(tests/test_torch_cuda.py).  Stage-1 sized: 64 000 rows into 8 at D=64.
"""

import pytest
import torch

from cacophony_tpu_torch.models import audio
from cacophony_tpu_torch.models.layers import sincos_time_embedding
from cacophony_tpu_torch.ops import _kernels as kern

N_ROWS, WIDTH, B, S = 8, 64, 128, 500


def _inputs(dtype, seed=0, offset=0.5):
    """A table, stage-1-like indices (time-major patches over 8 frequency
    rows, each clip's padding at index 0) and an upstream gradient with a
    component common to every patch, as a loss gives."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(N_ROWS, WIDTH, generator=gen)
    inds = (torch.arange(S) % N_ROWS).repeat(B, 1).to(torch.int32)
    lengths = torch.randint(S // 4, S + 1, (B,), generator=gen)
    inds[torch.arange(S)[None, :] >= lengths[:, None]] = 0
    g = (torch.randn(B, S, WIDTH, generator=gen) + offset).to(dtype)
    return table, inds, g


def _fp64_sum(g, inds):
    return torch.zeros(N_ROWS, g.shape[-1], dtype=torch.float64).index_add_(
        0, inds.reshape(-1).long(), g.reshape(-1, g.shape[-1]).double())


def _rel(got, ref):
    return float((got.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_is_the_gather_bit_for_bit(dtype):
    table, inds, _ = _inputs(dtype)
    got = audio.table_rows(table.requires_grad_(True), inds, dtype)
    assert type(got.grad_fn).__name__ == "_TableRowsBackward"
    want = table.detach().to(dtype)[inds.long()]
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_positions_keep_x_and_its_gradient(dtype):
    """`_add_positions` against the expression it had: the same output bits
    and the same gradient of x."""
    table, inds, g = _inputs(dtype, seed=1)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(B, S, WIDTH, generator=gen).to(dtype)
    time_inds = torch.arange(S).repeat(B, 1) // N_ROWS
    x_new, x_old = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    t_new, t_old = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    y_new = audio._add_positions(x_new, t_new, time_inds, inds)
    y_old = x_old + sincos_time_embedding(time_inds, WIDTH).to(dtype)
    y_old = y_old + t_old.to(dtype)[inds.long()]
    assert torch.equal(y_new, y_old)
    y_new.backward(g)
    y_old.backward(g)
    assert torch.equal(x_new.grad, x_old.grad)
    assert t_new.grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_table_gradient_is_the_fp32_sum(dtype):
    table, inds, g = _inputs(dtype, seed=3)
    table.requires_grad_(True)
    audio.table_rows(table, inds, dtype).backward(g)
    assert table.grad.dtype == torch.float32
    assert _rel(table.grad, _fp64_sum(g, inds)) <= 1e-5


def test_the_bf16_gather_backward_loses_the_sum():
    """Fault C-1 as it stood: the gather's own backward adds 8 000 bf16 rows
    a table row in bf16, and the running sum stalls far below the total."""
    table, inds, g = _inputs(torch.bfloat16, seed=4)
    table.requires_grad_(True)
    table.to(torch.bfloat16)[inds.long()].backward(g)
    assert _rel(table.grad, _fp64_sum(g, inds)) > 0.1


def test_mask_token_rows_broadcast():
    """The MAE decoder's restore set: one mask token broadcast over every
    row, plus the positions; both gradients are the fp32 sums."""
    table, inds, g = _inputs(torch.bfloat16, seed=5)
    table.requires_grad_(True)
    token = torch.randn(WIDTH, requires_grad=True)
    time_inds = torch.arange(S).repeat(B, 1) // N_ROWS
    audio._add_positions(token.to(torch.bfloat16)[None, None, :], table, time_inds,
                         inds).backward(g)
    assert _rel(table.grad, _fp64_sum(g, inds)) <= 1e-5
    assert token.grad.shape == (WIDTH,)


def test_no_grad_takes_the_gather(monkeypatch):
    """Inference, or a table that takes no gradient, runs the expression
    as it was and never reaches the Function."""
    def refuse(*args):
        raise AssertionError("the Function ran where nothing takes a gradient")

    monkeypatch.setattr(audio._TableRows, "apply", refuse)
    table, inds, _ = _inputs(torch.bfloat16, seed=6)
    want = table.to(torch.bfloat16)[inds.long()]
    with torch.no_grad():
        assert torch.equal(audio.table_rows(table.requires_grad_(True), inds, torch.bfloat16),
                           want)
    with torch.inference_mode():
        assert torch.equal(audio.table_rows(table, inds, torch.bfloat16), want)
    assert torch.equal(audio.table_rows(table.detach(), inds, torch.bfloat16), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_is_one_table_grad(monkeypatch, dtype):
    """The backward hands the wrapper the flattened gradient and indices
    once (the wrapper launches the kernel on the card or raises), and the
    table takes what it returns."""
    calls = []

    def spy(g, inds, n_rows):
        calls.append((g.shape, g.dtype, inds.shape, n_rows))
        return kern.table_grad_plain(g, inds, n_rows)

    monkeypatch.setattr(kern, "table_grad", spy)
    table, inds, g = _inputs(dtype, seed=7)
    table.requires_grad_(True)
    audio.table_rows(table, inds, dtype).backward(g)
    assert calls == [((B * S, WIDTH), dtype, (B * S,), N_ROWS)]
    assert torch.equal(table.grad, kern.table_grad_plain(g.reshape(-1, WIDTH),
                                                         inds.reshape(-1), N_ROWS))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_wrapper_runs_the_plain_sum_on_the_cpu(index_dtype):
    _, inds, g = _inputs(torch.float32, seed=9)
    got = kern.table_grad(g.reshape(-1, WIDTH), inds.reshape(-1).to(index_dtype), N_ROWS)
    assert got.dtype == torch.float32 and got.shape == (N_ROWS, WIDTH)
    assert _rel(got, _fp64_sum(g, inds)) <= 1e-5
