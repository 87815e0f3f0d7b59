"""The engine's CUDA graphs without a card: `CountedGraph`'s counting rule
and `_graphed`'s keys and counters with `GraphedStep` stubbed, and the CPU
engine, which captures nothing and embeds each bucket eagerly.  The graphs
themselves are held on the card by tests/test_torch_cuda_engine.py."""

import numpy as np
import pytest
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.models.caco import caco_init, get_audio_embedding
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.runtime import engine as engine_mod
from cacophony_tpu_torch.utils import profiling


class FakeGraph:
    """GraphedStep's calls of fn without a card: once to warm up, once to
    capture; a replay copies the inputs in and returns the captured output."""

    def __init__(self, fn, *inputs):
        self.inputs = tuple(x.clone() for x in inputs)
        fn(*self.inputs)
        self.output = fn(*self.inputs)

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        return self.output


def launches():
    return dict(kern.LAUNCHES, **ea.LAYER_LAUNCHES)


@pytest.fixture
def fake_graphs(monkeypatch):
    """GraphedStep stubbed by FakeGraph; the launch counts restored after."""
    monkeypatch.setattr(engine_mod, "GraphedStep", FakeGraph)
    saved = [dict(c) for c in engine_mod.LAUNCH_COUNTS]
    yield
    for c, s in zip(engine_mod.LAUNCH_COUNTS, saved):
        c.update(s)


def test_counted_graph_adds_the_captured_launches_once_a_replay(fake_graphs):
    calls = []

    def step(x):
        calls.append(x.clone())
        kern.LAUNCHES["gemm"] += 3
        ea.LAYER_LAUNCHES["k1_layer"] += 2
        return x * 2

    kern.LAUNCHES["gemm"] = 5
    before = launches()
    graph = engine_mod.CountedGraph(step, torch.ones(3))
    assert len(calls) == 2 and launches() == before  # warm-up and capture leave no count
    for i in (1, 2):
        out = graph(torch.full((3,), 7.0))
        assert torch.equal(out, torch.full((3,), 2.0))  # FakeGraph hands the captured output
        want = dict(before, gemm=5 + 3 * i, k1_layer=before["k1_layer"] + 2 * i)
        assert launches() == want
    assert len(calls) == 2  # a replay runs no Python step


def test_counted_graph_that_fails_leaves_the_counts(fake_graphs):
    def step(x):
        kern.LAUNCHES["attention"] += 1
        raise RuntimeError("capture refused")

    before = launches()
    with pytest.raises(RuntimeError, match="capture refused"):
        engine_mod.CountedGraph(step, torch.ones(2))
    assert launches() == before


@pytest.fixture(scope="module")
def tiny():
    cfg = configs.caco_tiny()
    model = caco_init(cfg, torch.Generator().manual_seed(3))
    return engine_mod.CacoEngine(cfg, model, device="cpu", buffer_seconds=1.0, batch_size=4)


def test_graphed_captures_once_a_shape_and_replays_every_call(tiny, fake_graphs):
    graphs, seen = {}, []

    def step(x, y):
        seen.append(tuple(x.shape))
        kern.LAUNCHES["layer_norm"] += 1
        return x.sum(-1) + y

    before = launches()
    with profiling.recording() as rec:
        for rows in (4, 4, 2, 4):
            x = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
            got = tiny._graphed(graphs, "audio", step, x, torch.ones(rows))
            assert torch.equal(got, x.sum(-1) + 1)
    assert list(graphs) == [(4, 3), (2, 3)] and seen == [(4, 3)] * 2 + [(2, 3)] * 2
    assert rec.counters == {"engine.audio_graph_captures": 2, "engine.audio_graph_replays": 4}
    assert launches() == dict(before, layer_norm=before["layer_norm"] + 4)


@torch.inference_mode()
def eager(engine, wavs):
    """get_audio_embedding of audio_patch_batch, a bucket at a time."""
    out = []
    for i in range(0, len(wavs), engine.batch_size):
        batch, n = engine.audio_patch_batch(wavs[i:i + engine.batch_size])
        out.append(get_audio_embedding(engine.params, engine.cfg, **batch)[0][:n].numpy())
    return np.concatenate(out)


def test_cpu_engine_embeds_eagerly_and_counts_no_graph(tiny):
    """6 clips, batch 4: the tail bucket is 2 clips and 2 of padding."""
    rs = np.random.RandomState(4)
    wavs = [(0.1 * rs.randn(n)).astype(np.float32)
            for n in (16_000, 4_000, 9_000, 20_000, 100, 12_000)]
    with profiling.recording() as rec:
        got = tiny.embed_audio(wavs)
    assert np.array_equal(got, eager(tiny, wavs))
    assert rec.counters["engine.buckets"] == 2
    assert not [k for k in rec.counters if "graph" in k] and tiny._audio_graphs == {}
