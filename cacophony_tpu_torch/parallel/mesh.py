"""The device mesh and its layout rules (cacophony_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the process
group, one rank a device, with the named dims

    dp: data parallel (the batch's leading axis; gradients summed over dp)
    tp: tensor parallel (Megatron: column-parallel QKV / MLP-in, row-
        parallel attention-out / MLP-out, a vocab-parallel head)

Where the JAX package places parameters and batches and lets GSPMD insert
the collectives, the port's programs call them: every replica starts from
rank 0's parameters (`shard_params`), each rank keeps its block of the
batch's rows (`shard_batch`), and the training step (train/train.py)
gathers the contrastive embeddings and sums the gradients over dp.

Under tp > 1, `param_specs` (JAX's rules, leaf for leaf) decides which
leaves are sharded, and `shard_params` keeps this rank's block of each:
a column-parallel leaf its heads' q, k and v columns (`qkv`: heads
[r·H/tp, (r+1)·H/tp) of each of the three; `kv`: of k and v) or a
contiguous block of columns (MLP-in, the vocabulary head), a row-parallel
leaf the matching block of rows (`o`, MLP-out).  The layout on a rank is
not JAX's contiguous P(None, 'tp'): what equals JAX's is the gathered
tree, `gather_params`, the exact inverse.  The sharded Denses carry their
`TPShard` (parallel/tensor.py), which the model's functions read.

Where JAX's `make_mesh` warns and leaves devices idle (dp·tp below the
device count), the port raises: a rank outside the mesh would wait forever
in the first collective of the ranks inside it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from cacophony_tpu_torch.parallel.tensor import TPShard, all_gather, group_size

_BUCKET_BYTES = 1 << 28  # flat buffer of a coalesced collective


def make_mesh(dp: Optional[int] = None, tp: int = 1, device="cuda") -> DeviceMesh:
    """A ('dp', 'tp') mesh over every rank of the process group; dp
    defaults to world // tp.  With no process group (one process, no
    launcher), a one-rank group over a HashStore is made first: NCCL for
    "cuda", gloo for "cpu", so `make_mesh(dp=1)` works in one process as
    JAX's does on one device.  dp·tp must equal the world size."""
    device_type = torch.device(device).type
    if not dist.is_initialized():
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('make_mesh on cuda: no CUDA device; pass device="cpu"')
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if dp is None:
        if world % tp:
            raise ValueError(f"tp={tp} does not divide the {world} ranks of the process group")
        dp = world // tp
    if dp * tp > world:
        raise ValueError(f"mesh {dp}×{tp} needs {dp * tp} ranks, have {world}")
    if dp * tp != world:
        raise ValueError(f"mesh {dp}×{tp} uses {dp * tp} of {world} ranks; the rest would "
                         "wait forever in its collectives (launch dp·tp processes)")
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


# Port parameter path, the layer index dropped and '/'-joined (the JAX
# tree's path) → the trailing dims' axes, as cacophony_tpu's _TP_RULES.
_TP_RULES = [
    # fused QKV / cross-KV / MLP-in: column-parallel (shard output features)
    (re.compile(r".*/(qkv|kv)/w$|.*/mlp_in/w$|.*/mlp/w1/w$"), (None, "tp")),
    (re.compile(r".*/(qkv|kv)/b$|.*/mlp_in/b$|.*/mlp/w1/b$"), ("tp",)),
    # attention-out / MLP-out: row-parallel (shard input features)
    (re.compile(r".*/o/w$|.*/mlp_out/w$|.*/mlp/w2/w$"), ("tp", None)),
    # vocab head: vocab-parallel
    (re.compile(r".*vocab_proj/w$"), (None, "tp")),
    (re.compile(r".*vocab_proj/b$"), ("tp",)),
]


def _jax_path(name: str) -> str:
    parts = name.split(".")
    if "blocks" in parts:
        del parts[parts.index("blocks") + 1]
    return "/".join(parts)


def _tp_size(mesh) -> Optional[int]:
    if mesh is None:
        return None
    if isinstance(mesh, DeviceMesh):
        return mesh["tp"].size()
    return dict(mesh)["tp"] if isinstance(mesh, dict) else tuple(mesh)[1]


def param_specs(model: torch.nn.Module,
                mesh: Union[DeviceMesh, Dict[str, int], Sequence[int], None] = None,
                ) -> Dict[str, Optional[int]]:
    """For each parameter name, the dim sharded over 'tp' or None
    (replicated), by JAX's rules.  The port's layers are a ModuleList, so a
    block's parameter has no stacked layer axis.  Given the mesh (or its
    sizes, {"dp": 4, "tp": 2} or (4, 2)), a dim that tp does not divide is
    replicated, as JAX's `_drop_indivisible` does (the odd vocabulary of
    50 265 leaves the head replicated)."""
    tp = _tp_size(mesh)
    out = {}
    for name, p in model.named_parameters():
        path, dim = _jax_path(name), None
        for rx, trailing in _TP_RULES:
            if rx.match(path):
                dim = p.dim() - len(trailing) + trailing.index("tp")
                break
        if dim is not None and tp is not None and p.shape[dim] % tp:
            dim = None
        out[name] = dim
    return out


def coalesced(tensors, fn) -> None:
    """Apply the in-place collective `fn(flat)` to `tensors` through flat
    buffers of at most _BUCKET_BYTES, one dtype and device each."""
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        bucket, size = [], 0
        for t in ts + [None]:
            if t is None or (bucket and size + t.numel() * t.element_size() > _BUCKET_BYTES):
                flat = _flatten_dense_tensors(bucket)
                fn(flat)
                for dst, src in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                    dst.copy_(src)
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += t.numel() * t.element_size()


def _tp_groups(name: str) -> int:
    """How many column groups a leaf's sharded dim holds: 3 for a fused
    QKV (q | k | v), 2 for a fused K|V, else 1."""
    owner = name.rsplit(".", 1)[0].rsplit(".", 1)[-1]
    return {"qkv": 3, "kv": 2}.get(owner, 1)


def tp_layout(model: torch.nn.Module, mesh) -> Dict[str, Tuple[int, int]]:
    """name → (sharded dim, column groups) of every leaf `param_specs`
    shards over tp; raises ValueError where tp does not split a group
    (the heads of a fused QKV) evenly."""
    tp = _tp_size(mesh)
    shapes = {name: p.shape for name, p in model.named_parameters()}
    out = {}
    for name, dim in param_specs(model, mesh).items():
        if dim is None or tp == 1:
            continue
        groups = _tp_groups(name)
        if shapes[name][dim] % (groups * tp):
            raise ValueError(f"tp={tp} does not split {name} {tuple(shapes[name])} into "
                             f"{groups} equal groups of whole blocks")
        out[name] = (dim, groups)
    return out


def local_block(full: torch.Tensor, dim: int, groups: int, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s block of `full` along `dim`: of each of its `groups`
    equal column groups, the rank's contiguous 1/size."""
    x = full.movedim(dim, 0)
    rest = x.shape[1:]
    x = x.reshape(groups, size, x.shape[0] // (groups * size), *rest)[:, rank]
    return x.reshape(-1, *rest).movedim(0, dim).contiguous()


def join_blocks(parts: Sequence[torch.Tensor], dim: int, groups: int) -> torch.Tensor:
    """The inverse of `local_block` over the ranks' blocks, in rank order."""
    xs = [p.movedim(dim, 0) for p in parts]
    rest = xs[0].shape[1:]
    x = torch.stack([t.reshape(groups, -1, *rest) for t in xs], dim=1)
    return x.reshape(-1, *rest).movedim(0, dim).contiguous()


def shard_tensors(model: torch.nn.Module, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Whole tensors in `named_parameters()` order (parameters or optimizer
    moments) → this rank's blocks, by the layout `shard_params` gave the
    model; unchanged where the model is not sharded."""
    layout, shard = getattr(model, "tp_layout", {}), getattr(model, "tp_shard", None)
    return [local_block(t, *layout[name], shard.rank, shard.size) if name in layout else t
            for (name, _), t in zip(model.named_parameters(), tensors)]


def gather_tensors(model: torch.nn.Module, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """This rank's blocks in `named_parameters()` order → the whole
    tensors, gathered over tp (every rank of the tp group must call)."""
    layout, shard = getattr(model, "tp_layout", {}), getattr(model, "tp_shard", None)
    return [join_blocks(all_gather(t, shard.group), *layout[name]) if name in layout else t
            for (name, _), t in zip(model.named_parameters(), tensors)]


def replicate_params(model: torch.nn.Module) -> torch.nn.Module:
    """Every rank takes rank 0's parameters (the counterpart of JAX's
    `device_put` of its one host tree).  In place; → model."""
    if group_size(None) > 1:
        coalesced([p.data for p in model.parameters()], lambda flat: dist.broadcast(flat, src=0))
    return model


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Place the parameters on the mesh: every rank takes rank 0's values,
    then under tp > 1 keeps its block of each leaf `param_specs` shards
    (module docstring).  Each sharded Dense gets its `tp_shard`, the model
    its `tp_layout` (name → (dim, column groups)) and `tp_shard`.  In place;
    → model."""
    replicate_params(model)
    tp = mesh["tp"].size()
    if tp == 1:
        return model
    if getattr(model, "tp_layout", None):
        raise ValueError("the model is already sharded")
    layout = tp_layout(model, mesh)
    shard = TPShard(mesh.get_group("tp"), mesh.get_local_rank("tp"), tp)
    named = dict(model.named_parameters())
    for name, (dim, groups) in layout.items():
        p = named[name]
        p.data = local_block(p.data, dim, groups, shard.rank, tp)
        if name.endswith(".w"):
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            owner.tp_shard = shard._replace(column=dim == p.dim() - 1)
    model.tp_layout, model.tp_shard = layout, shard
    return model


@torch.no_grad()
def gather_params(model: torch.nn.Module, mesh: Optional[DeviceMesh] = None) -> torch.nn.Module:
    """The exact inverse of `shard_params` at tp > 1: every leaf whole
    again on every rank, the tp attributes removed (a no-op on a model
    that is not sharded).  In place; → model."""
    shard = getattr(model, "tp_shard", None)
    if shard is None:
        return model
    if mesh is not None and mesh["tp"].size() != shard.size:
        raise ValueError(f"the model is sharded over tp={shard.size}, the mesh has "
                         f"tp={mesh['tp'].size()}")
    params = list(model.parameters())
    for p, t in zip(params, gather_tensors(model, [p.data for p in params])):
        p.data = t
    for m in model.modules():
        m.__dict__.pop("tp_shard", None)
    del model.tp_layout
    return model


def batch_spec() -> tuple:
    """The batch layout: the leading axis split over 'dp' (JAX P('dp'))."""
    return ("dp",)


def mesh_rows(n: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous block of n rows over every rank of the mesh,
    in rank order (serving folds tp into data parallelism)."""
    size = mesh.size()
    if n % size:
        raise ValueError(f"leading axis {n} does not divide over the {size}-rank mesh")
    r = dist.get_rank()
    return slice(r * n // size, (r + 1) * n // size)


def dp_rows(n: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous block of n rows over 'dp'."""
    dp = mesh["dp"].size()
    if n % dp:
        raise ValueError(f"leading axis {n} does not divide over dp={dp}")
    r = mesh.get_local_rank("dp")
    return slice(r * n // dp, (r + 1) * n // dp)


def shard_batch(batch, mesh: DeviceMesh):
    """Each rank keeps rows [r·B/dp, (r+1)·B/dp) of every leaf's leading
    axis (tensors or numpy arrays, in dicts, lists or tuples), the block
    layout of P('dp'); B must divide over dp."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch[dp_rows(batch.shape[0], mesh)]


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' x concatenated on axis 0 in rank order (no gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class GatherRows(torch.autograd.Function):
    """gather_rows whose backward sums the gathered gradient over the ranks
    and keeps this rank's rows (a reduce-scatter): `GatherRows.apply(x,
    group)`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        if group_size(ctx.group) == 1:
            return g, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None
