"""Every traffic generator is deterministic in the seed, and gives every
seed the same set of sizes in another order."""

import json
import os

import numpy as np
import torch

from portbench import harness, training
from tiny_cells import ROOT, cell


def _driver(kind):
    return harness.load_file(os.path.join(ROOT, "portbench", "drivers", f"{kind}.py"))


def _traffic(mix):
    with open(os.path.join(ROOT, "portbench", "traffic", f"{mix}.json")) as f:
        return json.load(f)


def test_embed_pool():
    d, t = _driver("embed"), _traffic("embed_10s")
    t = dict(t, pool_clips=20)

    def pool(seed):
        _, tseed, rng = d.seeds(seed)
        return d.make_pool(t, 16_000, tseed, rng, "cpu")

    a, b, c = pool(2 ** 31 + 5), pool(2 ** 31 + 5), pool(2 ** 31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(map(len, a)) == sorted(map(len, c)) and [len(x) for x in a] != [len(x) for x in c]
    assert sum(len(x) == 160_000 for x in a) == 16  # 80 % of the pool at the buffer's length
    assert min(map(len, a)) >= 16_000


def test_training_pool_and_captions():
    t = dict(_traffic("train_10s"), pool_clips=24)
    d = _driver("caco_train")

    def make(seed):
        _, tseed, _, rng = d.seeds(seed)
        pool, lens, host = training.make_pool(t, 16_000, tseed, rng, "cpu")
        ids, mask = d.make_captions(t, {"text": {"vocab_size": 50_265, "pad_token_id": 1,
                                                 "bos_token_id": 0, "eos_token_id": 2}},
                                    len(host), rng, "cpu")
        return pool, host, ids, mask

    a, b, c = make(9), make(9), make(10)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert sorted(a[1]) == sorted(c[1]) and not np.array_equal(a[1], c[1])
    assert sorted(a[3].sum(1).tolist()) == sorted(c[3].sum(1).tolist())
    assert a[3].sum(1).min() >= 8 and a[3].sum(1).max() <= 48
    assert (a[2][:, 0] == 0).all() and int(a[2].max()) < 50_265


def test_text_prompts_and_gallery():
    d, t = _driver("text_query"), dict(_traffic("text_query"), gallery_rows=3000, slab_rows=1024)
    cfg = cell("caco_base.text_query").config

    def make(seed):
        _, gseed, rng = d.seeds(seed)
        return d.make_prompts(t, cfg, rng), torch.cat(list(d.gallery_slabs(t, 32, gseed, "cpu")))

    (p1, g1), (p2, g2), (p3, g3) = make(4), make(4), make(5)
    assert p1 == p2 and torch.equal(g1, g2) and not torch.equal(g1, g3)
    assert sorted(map(len, p1)) == sorted(map(len, p3)) and p1 != p3
    assert min(map(len, p1)) == 4 and max(map(len, p1)) == 30
    assert {len(p) <= 16 for p in p1} == {True, False}  # both text buckets occur
    assert torch.allclose(g1.norm(dim=1), torch.ones(3000))


def test_pretrain_pool_and_masking_noise():
    """The stage-1 pool: 10-s clips, as AudioSet's, whose audio and levels
    are the seed's; the step generator, and with it each step's masking
    noise, is the seed's."""
    t = dict(_traffic("pretrain_10s"), pool_clips=24)
    d = _driver("mae_train")
    ref = harness.load_file(os.path.join(ROOT, "portbench", "configs", "audiomae_base_ref.py"))

    def make(seed):
        _, tseed, gseed, rng = d.seeds(seed)
        pool, _, host = training.make_pool(t, 16_000, tseed, rng, "cpu")
        gen = torch.Generator().manual_seed(gseed)
        return pool, host, ref.noise(gen.get_state(), 4, t["seq_len"], "cpu")

    a, b, c = make(2 ** 31 + 9), make(2 ** 31 + 9), make(2 ** 31 + 10)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert set(a[1]) == set(c[1]) == {160_000} and a[0].shape == (24, 160_000)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[2], c[2])
    level = 20 * torch.log10(a[0].square().mean(1).sqrt())
    assert level.max() - level.min() > 25  # the clips' levels spread over tens of dB
