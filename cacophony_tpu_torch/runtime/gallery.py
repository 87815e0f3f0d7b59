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

`torch.topk` may order equal scores differently from `lax.top_k`.  The
`mesh` argument (rows sharded over 'dp') comes with the port's mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class GalleryIndex:
    def __init__(self, dim: int, *, logit_scale: float = 0.0, slab: int = 4096,
                 device="cuda"):
        """dim: embedding size; logit_scale: log-scale applied to the scores
        (pass the model's logit_scale for the reference's logits); slab:
        the first capacity (capacity doubles past it).  The store lives on
        the card unless given device="cpu"; with no card it raises.  On
        CUDA, TF32 is turned off for this process (the scores are fp32
        products)."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"GalleryIndex on {self.device}: no CUDA device; pass "
                                   f'device="cpu" to run on the CPU')
            torch.backends.cuda.matmul.allow_tf32 = False
        self.dim = dim
        self.logit_scale = float(logit_scale)
        self.slab = slab
        self.size = 0
        self.num_deleted = 0
        self._store: Optional[torch.Tensor] = None  # (capacity, dim) fp32
        self._valid: Optional[torch.Tensor] = None  # (capacity,) bool
        self._labels: List = []

    @property
    def capacity(self) -> int:
        return 0 if self._store is None else self._store.shape[0]

    @property
    def labels(self) -> List:
        """Row labels in insertion order (a copy)."""
        return list(self._labels)

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = max(self.slab, self.capacity)
        while new_cap < needed:
            new_cap *= 2
        store = torch.zeros((new_cap, self.dim), dtype=torch.float32, device=self.device)
        valid = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
        if self._store is not None:
            store[: self.capacity] = self._store
            valid[: self.capacity] = self._valid
        self._store, self._valid = store, valid

    def add(self, embeddings: np.ndarray, labels: Optional[Sequence] = None) -> None:
        """Append L2-normalized embeddings (n, dim), with labels (default:
        the row numbers)."""
        emb = torch.as_tensor(np.asarray(embeddings, np.float32))
        n = emb.shape[0]
        if labels is not None and len(labels) != n:
            raise ValueError(f"{len(labels)} labels for {n} rows")
        self._labels.extend(labels if labels is not None else range(self.size, self.size + n))
        self._ensure_capacity(self.size + n)
        self._store[self.size: self.size + n] = emb.to(self.device)
        self._valid[self.size: self.size + n] = True
        self.size += n

    def delete(self, indices: Sequence[int]) -> None:
        """Mask rows out of every later search (no compaction).  Deleting a
        row twice counts it once."""
        idx = np.asarray(sorted(set(int(i) for i in indices)), np.int64)
        if len(idx) == 0:
            return
        if idx[0] < 0 or idx[-1] >= self.size:
            raise IndexError(f"row index out of range [0, {self.size})")
        rows = torch.from_numpy(idx).to(self.device)
        self.num_deleted += int(self._valid[rows].sum())
        self._valid[rows] = False

    @torch.inference_mode()
    def search(self, queries: np.ndarray, k: int = 10) -> Tuple[np.ndarray, np.ndarray, List]:
        """→ (scores (nq, k), row indices (nq, k), labels per row):
        exp(logit_scale) · q @ storeᵀ, deleted rows at -inf, k at most the
        live-row count."""
        if self.size <= self.num_deleted:
            raise ValueError("empty gallery")
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        k = min(k, self.size - self.num_deleted)
        scale = torch.exp(torch.tensor(self.logit_scale, dtype=torch.float32))
        scores = float(scale) * q @ self._store.T
        scores = torch.where(self._valid[None, :], scores, -torch.inf)
        top_scores, top_idx = torch.topk(scores, k, dim=-1)
        top_scores, top_idx = top_scores.cpu().numpy(), top_idx.cpu().numpy().astype(np.int32)
        labels = [[self._labels[j] for j in row] for row in top_idx]
        return top_scores, top_idx, labels

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        """Rows, validity and labels (an object array) in an npz file."""
        store = self._store[: self.size].cpu().numpy() if self.size else \
            np.zeros((0, self.dim), np.float32)
        valid = self._valid[: self.size].cpu().numpy() if self.size else np.zeros((0,), np.bool_)
        np.savez(path, store=store, valid=valid, labels=np.asarray(self._labels, dtype=object),
                 logit_scale=self.logit_scale, dim=self.dim, slab=self.slab)

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "GalleryIndex":
        """A gallery saved by `save` here or by the JAX package's GalleryIndex
        (the labels are unpickled: load only files this program wrote)."""
        data = np.load(path, allow_pickle=True)
        g = cls(int(data["dim"]), logit_scale=float(data["logit_scale"]),
                slab=int(data["slab"]), device=device)
        store, valid = data["store"], data["valid"]
        if len(store):
            g.add(store, labels=list(data["labels"]))
            dead = np.nonzero(~valid)[0]
            if len(dead):
                g.delete(dead)
        return g
