"""A device-resident retrieval gallery with incremental inserts
(cacophony_tpu/runtime/gallery.py).

The reference recomputes a full similarity matrix per evaluation run
(eval_caco.py:223-225).  For serving, the gallery's rows live on the card
and a top-k query is one logit-scaled product and a top-k, with no host
round trip of the gallery:

- capacity doubles from `slab`, and growth copies the store on the device;
- inserts write into the reserved capacity in place;
- `delete` masks rows out of every search without compaction (idempotent,
  with a live-row count);
- `save` / `load` keep the rows, the validity mask and the labels in an npz
  file with the JAX package's keys, so each package loads the other's.

Equal scores come out lower row index first, as `lax.top_k` orders them
(`topk_lowest_first`: `torch.topk` chooses among ties at random, so its k
results are reordered and a row whose k-th score ties with a row left out
is sorted whole).

`mesh=` shards the rows over 'dp' in contiguous blocks of the capacity
(rank r holds rows [r·C/dp, (r+1)·C/dp)), as JAX's `P("dp")` does; growth
gathers the old blocks and keeps that layout.  `search` takes a top-k on
each rank's block, gathers the scores and global row indices, and merges
them, so it returns what the one-device gallery returns.  `save` gathers
to rank 0, which writes the same npz; `load(…, mesh=)` splits it.  Every
rank must make the same calls with the same arguments.

`search` records spans (utils/profiling.py) while the recorder records:
`gallery.search` over `gallery.product` (the scaled product and the mask),
`gallery.topk` and `gallery.copy_back`, and counts `gallery.rows_scanned`
(this rank's rows scored, times the queries).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cacophony_tpu_torch.parallel.mesh import gather_rows
from cacophony_tpu_torch.utils.profiling import count, span


def _order(vals: torch.Tensor, idx: torch.Tensor):
    """Sort each row's candidates by score, descending, the lower index
    first among equal scores."""
    o = torch.argsort(idx, dim=-1, stable=True)
    vals, idx = torch.gather(vals, -1, o), torch.gather(idx, -1, o)
    o = torch.argsort(vals, dim=-1, descending=True, stable=True)
    return torch.gather(vals, -1, o), torch.gather(idx, -1, o)


def topk_lowest_first(scores: torch.Tensor, k: int):
    """`torch.topk` over the last axis with `lax.top_k`'s order: equal
    scores lower index first, and where the k-th score ties with a column
    left out, the lowest-indexed of the tied columns taken (those rows are
    sorted whole).  A k-th score of -inf is left as it falls."""
    vals, idx = torch.topk(scores, k, dim=-1)
    vals, idx = _order(vals, idx)
    kth = vals[:, -1:]
    short = ((scores == kth).sum(-1) > (vals == kth).sum(-1)) & (kth[:, 0] > -torch.inf)
    if bool(short.any()):
        rows = short.nonzero()[:, 0]
        whole = torch.sort(scores[rows], dim=-1, descending=True, stable=True)
        vals[rows], idx[rows] = whole.values[:, :k], whole.indices[:, :k]
    return vals, idx


class GalleryIndex:
    def __init__(self, dim: int, *, logit_scale: float = 0.0, slab: int = 4096,
                 device="cuda", mesh=None):
        """dim: embedding size; logit_scale: log-scale applied to the scores
        (pass the model's logit_scale for the reference's logits); slab:
        the first capacity (capacity doubles past it); mesh: shard the rows
        over its 'dp' dim.  The store lives on the card unless given
        device="cpu"; with no card it raises.  On CUDA, TF32 is turned off
        for this process (the scores are fp32 products)."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"GalleryIndex on {self.device}: no CUDA device; pass "
                                   f'device="cpu" to run on the CPU')
            torch.backends.cuda.matmul.allow_tf32 = False
        self.dim = dim
        self.logit_scale = float(logit_scale)
        self.slab = slab
        self.mesh = mesh
        self._group = mesh.get_group("dp") if mesh is not None else None
        self._dp = mesh["dp"].size() if mesh is not None else 1
        self._rank = mesh.get_local_rank("dp") if mesh is not None else 0
        self.size = 0
        self.num_deleted = 0
        self._capacity = 0
        self._store: Optional[torch.Tensor] = None  # (capacity / dp, dim) fp32: this rank's block
        self._valid: Optional[torch.Tensor] = None  # (capacity / dp,) bool
        self._labels: List = []

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def labels(self) -> List:
        """Row labels in insertion order (a copy)."""
        return list(self._labels)

    @property
    def _lo(self) -> int:
        """The first global row of this rank's block."""
        return self._rank * (self._capacity // self._dp)

    def _whole(self):
        """The whole store and validity (every rank's block, in order)."""
        if self.mesh is None:
            return self._store, self._valid
        valid = gather_rows(self._valid.to(torch.uint8), self._group)
        return gather_rows(self._store, self._group), valid.bool()

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = max(self.slab, self.capacity)
        while new_cap < needed:
            new_cap *= 2
        if new_cap % self._dp:
            raise ValueError(f"gallery capacity {new_cap} does not divide over dp={self._dp}")
        block = new_cap // self._dp
        store = torch.zeros((block, self.dim), dtype=torch.float32, device=self.device)
        valid = torch.zeros((block,), dtype=torch.bool, device=self.device)
        if self._store is not None:
            old_store, old_valid = self._whole()
            lo = self._rank * block
            n = max(0, min(block, self.capacity - lo))
            store[:n] = old_store[lo:lo + n]
            valid[:n] = old_valid[lo:lo + n]
        self._store, self._valid, self._capacity = store, valid, new_cap

    def add(self, embeddings: np.ndarray, labels: Optional[Sequence] = None) -> None:
        """Append L2-normalized embeddings (n, dim), with labels (default:
        the row numbers).  Under a mesh each rank writes the rows of its
        block."""
        emb = np.asarray(embeddings, np.float32)
        n = emb.shape[0]
        if labels is not None and len(labels) != n:
            raise ValueError(f"{len(labels)} labels for {n} rows")
        self._labels.extend(labels if labels is not None else range(self.size, self.size + n))
        self._ensure_capacity(self.size + n)
        lo = self._lo
        a, b = max(self.size, lo), min(self.size + n, lo + self._capacity // self._dp)
        if a < b:
            self._store[a - lo:b - lo] = torch.from_numpy(emb[a - self.size:b - self.size]).to(
                self.device)
            self._valid[a - lo:b - lo] = True
        self.size += n

    def delete(self, indices: Sequence[int]) -> None:
        """Mask rows out of every later search (no compaction).  Deleting a
        row twice counts it once."""
        idx = np.asarray(sorted(set(int(i) for i in indices)), np.int64)
        if len(idx) == 0:
            return
        if idx[0] < 0 or idx[-1] >= self.size:
            raise IndexError(f"row index out of range [0, {self.size})")
        lo = self._lo
        mine = idx[(idx >= lo) & (idx < lo + self._capacity // self._dp)] - lo
        rows = torch.from_numpy(mine).to(self.device)
        count = self._valid[rows].sum()
        if self.mesh is not None:
            dist.all_reduce(count, group=self._group)
        self.num_deleted += int(count)
        self._valid[rows] = False

    @torch.inference_mode()
    def search(self, queries: np.ndarray, k: int = 10) -> Tuple[np.ndarray, np.ndarray, List]:
        """→ (scores (nq, k), row indices (nq, k), labels per row):
        exp(logit_scale) · q @ storeᵀ, deleted rows at -inf, k at most the
        live-row count, equal scores lower index first."""
        if self.size <= self.num_deleted:
            raise ValueError("empty gallery")
        with span("gallery.search", device=self.device):
            with span("gallery.product", device=self.device):
                q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
                k = min(k, self.size - self.num_deleted)
                scale = torch.exp(torch.tensor(self.logit_scale, dtype=torch.float32))
                scores = float(scale) * q @ self._store.T
                scores = torch.where(self._valid[None, :], scores, -torch.inf)
            count("gallery.rows_scanned", scores.shape[0] * scores.shape[1])
            with span("gallery.topk", device=self.device):
                top_scores, top_idx = topk_lowest_first(scores, min(k, scores.shape[1]))
            if self.mesh is not None:  # merge the ranks' candidates
                cand_s = gather_rows(top_scores[None], self._group)
                cand_i = gather_rows((top_idx + self._lo)[None], self._group)
                nq = q.shape[0]
                top_scores, top_idx = _order(cand_s.permute(1, 0, 2).reshape(nq, -1),
                                             cand_i.permute(1, 0, 2).reshape(nq, -1))
                top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
            with span("gallery.copy_back"):
                top_scores = top_scores.cpu().numpy()
                top_idx = top_idx.cpu().numpy().astype(np.int32)
            labels = [[self._labels[j] for j in row] for row in top_idx]
            return top_scores, top_idx, labels

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        """Rows, validity and labels (an object array) in an npz file; under
        a mesh the blocks are gathered and rank 0 writes."""
        store, valid = self._whole() if self.size else (None, None)
        if self.mesh is None or dist.get_rank() == 0:
            store = store[: self.size].cpu().numpy() if self.size else \
                np.zeros((0, self.dim), np.float32)
            valid = valid[: self.size].cpu().numpy() if self.size else np.zeros((0,), np.bool_)
            np.savez(path, store=store, valid=valid,
                     labels=np.asarray(self._labels, dtype=object),
                     logit_scale=self.logit_scale, dim=self.dim, slab=self.slab)
        if self.mesh is not None:
            dist.barrier()

    @classmethod
    def load(cls, path: str, *, device="cuda", mesh=None) -> "GalleryIndex":
        """A gallery saved by `save` here or by the JAX package's GalleryIndex
        (the labels are unpickled: load only files this program wrote);
        under a mesh each rank keeps its block."""
        data = np.load(path, allow_pickle=True)
        g = cls(int(data["dim"]), logit_scale=float(data["logit_scale"]),
                slab=int(data["slab"]), device=device, mesh=mesh)
        store, valid = data["store"], data["valid"]
        if len(store):
            g.add(store, labels=list(data["labels"]))
            dead = np.nonzero(~valid)[0]
            if len(dead):
                g.delete(dead)
        return g
