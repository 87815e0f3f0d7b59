"""Tensor parallelism's collectives, written out where GSPMD inserts them
for the JAX package (Megatron-LM's f and g operators).

A Dense that `shard_params` sharded over 'tp' carries a `TPShard` as its
`tp_shard` attribute: this rank's place in the tp group and whether the
layer is column-parallel (it holds a block of the output features) or
row-parallel (the matching block of the input features).  `dense`
(models/layers.py) reads it:

- column-parallel: `copy_to_tp(x)` before the product, identity forward,
  the input gradient summed over tp in the backward (each rank's columns
  give a partial gradient of the replicated input);
- row-parallel: `reduce_from_tp(x @ w)` after the product, the partial
  products summed over tp forward, identity backward; the replicated bias
  is added once, after the sum.

`gather_from_tp` concatenates the ranks' last-axis blocks of a tensor whose
consumer is replicated (the audio pooler's heads); its backward keeps this
rank's block of the gradient, which every rank computes whole.

A group of one rank skips its collective (a collective over one rank is a
copy): `all_reduce` and `all_gather` here are the port's entry points to
torch.distributed for every group that may hold one rank.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist


class TPShard(NamedTuple):
    """This rank's place in the tp group, and the layout of one Dense."""

    group: Any
    rank: int
    size: int
    column: bool = True  # column-parallel (output features) or row-parallel

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n features."""
        return slice(self.rank * n // self.size, (self.rank + 1) * n // self.size)


def tp_shard(module) -> Optional[TPShard]:
    """The module's TPShard, or None where it holds whole parameters."""
    return getattr(module, "tp_shard", None)


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over the group; skipped for a group of one rank."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's x, in rank order (the list form, which gloo takes for
    CUDA tensors)."""
    n = group_size(group)
    if n == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return torch.cat(all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is summed over the group."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Summed over the group forward; identity backward."""
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' last-axis blocks concatenated in rank order; the backward
    keeps this rank's block."""
    return _GatherFromTP.apply(x, group)
