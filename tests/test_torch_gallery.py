"""The port's GalleryIndex against the JAX package's: add, top-k search,
delete, growth past the slab, and npz files saved by one package loaded by
the other.  Random unit rows have no tied scores, so `torch.topk` and
`lax.top_k` must return the same rows in the same order.  Scores: 1e-5
absolute (|score| ≤ exp(logit_scale) ≤ 4.5; fp32 products summed in
another order)."""

import numpy as np
import pytest
import torch

from cacophony_tpu.runtime.gallery import GalleryIndex as JaxGallery
from cacophony_tpu_torch.runtime.gallery import GalleryIndex

torch.set_num_threads(2)


def _normed(rs, n, d):
    e = rs.randn(n, d).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _same(a, b, queries, k):
    sa, ia, la = a.search(queries, k=k)
    sb, ib, lb = b.search(queries, k=k)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(sb, sa, rtol=0, atol=1e-5)
    assert lb == la
    return ib


@pytest.mark.parametrize("slab", [4, 64])
def test_add_search_delete_growth_match_jax(slab):
    rs = np.random.RandomState(0)
    dim = 16
    ours = GalleryIndex(dim, logit_scale=1.5, slab=slab, device="cpu")
    ref = JaxGallery(dim, logit_scale=1.5, slab=slab)
    queries = _normed(rs, 6, dim)
    for i, n in enumerate((3, 5, 1, 20, 9)):
        rows = _normed(rs, n, dim)
        labels = [f"b{i}r{j}" for j in range(n)] if i % 2 else None
        ours.add(rows, labels=labels)
        ref.add(rows, labels=labels)
        assert ours.size == ref.size and ours.capacity == ref.capacity
        assert ours.labels == ref.labels
        _same(ref, ours, queries, k=5)
    gone = set()
    for dead in ([0, 7], [7, 30], [37]):
        ours.delete(dead)
        ref.delete(dead)
        gone |= set(dead)
        assert ours.num_deleted == ref.num_deleted == len(gone)
        idx = _same(ref, ours, queries, k=10)
        assert not set(idx.ravel().tolist()) & gone
    assert ours.num_deleted == 4  # deleting row 7 twice counts it once
    _same(ref, ours, queries, k=100)  # k clipped to the live rows
    assert ours.search(queries, k=100)[0].shape == (6, 34)


def test_errors():
    g = GalleryIndex(8, device="cpu")
    with pytest.raises(ValueError, match="empty gallery"):
        g.search(np.ones((1, 8), np.float32))
    g.add(_normed(np.random.RandomState(1), 3, 8))
    with pytest.raises(IndexError):
        g.delete([3])
    with pytest.raises(ValueError):
        g.add(np.ones((2, 8), np.float32), labels=["a"])
    g.delete([0, 1, 2])
    with pytest.raises(ValueError, match="empty gallery"):
        g.search(np.ones((1, 8), np.float32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_across_packages(tmp_path, writer):
    rs = np.random.RandomState(2)
    dim = 12
    rows = _normed(rs, 30, dim)
    labels = [f"x{i}" for i in range(30)]
    ours = GalleryIndex(dim, logit_scale=0.7, slab=8, device="cpu")
    ref = JaxGallery(dim, logit_scale=0.7, slab=8)
    for g in (ours, ref):
        g.add(rows, labels=labels)
        g.delete([3, 11, 29])
    path = str(tmp_path / "gallery.npz")
    (ours if writer == "port" else ref).save(path)
    loaded_port, loaded_jax = GalleryIndex.load(path, device="cpu"), JaxGallery.load(path)
    queries = _normed(rs, 4, dim)
    for g in (loaded_port, loaded_jax):
        assert g.size == 30 and g.num_deleted == 3 and g.logit_scale == pytest.approx(0.7)
        assert g.labels == labels
    idx = _same(ref, loaded_port, queries, k=8)
    _same(ref, loaded_jax, queries, k=8)
    assert not set(idx.ravel().tolist()) & {3, 11, 29}


def test_empty_save_round_trip(tmp_path):
    path = str(tmp_path / "empty.npz")
    GalleryIndex(5, slab=4, device="cpu").save(path)
    for g in (GalleryIndex.load(path, device="cpu"), JaxGallery.load(path)):
        assert g.size == 0 and g.dim == 5 and g.slab == 4


def test_gallery_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GalleryIndex(8)
