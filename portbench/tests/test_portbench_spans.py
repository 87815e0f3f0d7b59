"""The per-layer metrics that read the program's spans and counters
(portbench/spans.py): the tiny traced cells on the CPU record the
program's spans and counters but report none of these metrics; on a
synthetic stretch, one stream simulated with a known clock, the join
gives each kernel to the span that launched it, recovers the host's clock
past the marker's error, and leaves the Trace and every existing reader's
value as they were."""

import copy
import json
import os

import pytest

import contract
from cacophony_tpu_torch.utils import profiling
from cacophony_tpu_torch.utils.profiling import Recording, Span
from portbench import harness, run, spans
from tiny_cells import ROOT, context

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NEW = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in contract.THIRTEEN}


def test_the_thirteen_entries():
    contract.check_thirteen(BENCH)


@pytest.mark.parametrize("cell", ["caco_base.embed_10s", "caco_base.text_query",
                                  "caco_base.train_10s", "audiomae_base.pretrain_10s"])
def test_tiny_traced_cells_record_but_report_nothing_on_the_cpu(cell, monkeypatch):
    """The program records its spans and counters in a tiny traced stretch
    on the CPU, and none of the new metrics is read from it."""
    taken = []
    take = profiling.take
    monkeypatch.setattr(profiling, "take", lambda: taken.append(take()) or taken[-1])
    ctx = context(cell, trace=True)
    got = run.execute(ctx)["metrics"]
    assert not set(got) & set(NEW) and len(taken) == 1
    names = {s.name for s in taken[0].spans}
    if cell == "caco_base.embed_10s":
        assert {"engine.fill", "engine.launch", "engine.retire"} <= names
        c = taken[0].counters
        assert 0 < c["engine.valid_patches"] < c["engine.patch_slots"]
    if cell == "caco_base.text_query":
        assert {"engine.text_tower", "gallery.search"} <= names
        assert taken[0].counters["engine.text_rows"] == 4 * taken[0].counters[
            "engine.text_prompts"]  # batch 4
    if ctx.cell.traffic["kind"].endswith("_train"):
        assert {"train.frontend", "train.forward", "train.backward", "train.optimizer"} <= names


# ------------------------------------------------------- a synthetic stretch

H_US = 5_000.0     # the kernels' clock = host µs + H_US
MARKER_US = 400.0  # the harness's marker places host times this much late


def _stretch(rate=0.0, fill_us=4_000.0):
    """Two embedding calls on one stream: per bucket a host fill, then a
    launch of three kernels; the card runs each kernel when launched and
    free; the edges fire likewise, read on a clock `rate` slower than the
    kernels'.  → (Trace, Recording, {kernel: span}, first edge)."""
    sp, kernels, owner, free = [], [], {}, 0.0
    ids = iter(range(1, 10 ** 6))
    edges = []

    def host(us):  # host µs → ns on the perf clock
        return int(us * 1e3)

    def fire(at_host_us):
        nonlocal free
        at = max(at_host_us + H_US + 2.0, free)
        free = at
        return at

    now, harness_spans = 1_000.0, []
    for call in range(2):
        top = Span("engine.embed_audio", host(now), 0, next(ids), None, call + 1, 7)
        sp.append(top)
        h0 = now
        now += 50
        for bucket in range(3):
            fill = Span("engine.fill", host(now), host(now + fill_us), next(ids), top.id,
                        top.request, 7)
            sp.append(fill)
            now += fill_us
            launch = Span("engine.launch", host(now), 0, next(ids), top.id, top.request, 7)
            a = fire(now)
            for k in range(3):
                now += 300
                start = max(now + H_US + 5.0, free)
                free = start + 500.0 + 100 * k
                kernels.append((f"k{bucket}{k}", start, free))
                owner[(start, free)] = launch
            now += 200
            b = fire(now)
            launch.end_ns = host(now)
            edges.append((launch, a, b))
            sp.append(launch)
            now += 10
        top.end_ns = host(now)
        harness_spans.append(("portbench.embed_audio", h0 - 5 + H_US + MARKER_US,
                              now + 3 + H_US + MARKER_US))
        now += 2_000
    first = min(a for _, a, _ in edges)
    for s, a, b in edges:
        s.device_us = ((a - first) / (1 + rate), (b - first) / (1 + rate))
    rec = Recording(sorted(sp, key=lambda s: s.start_ns),
                    {"engine.valid_patches": 91, "engine.patch_slots": 100}, 0, (0, 0))
    trace = harness.Trace(sorted(kernels, key=lambda k: k[1]), harness_spans,
                          (now - 1_000) / 1e6)
    return trace, rec, owner, first


def _idle_in(trace, rec, name):
    """The share of idle µs between kernels whose true host innermost span
    is `name` or inside it, at 1-µs steps."""
    by = {s.id: s for s in rec.spans}
    hit = total = 0
    ks = trace.kernels
    for (_, _, end), (_, start, _) in zip(ks, ks[1:]):
        for t in range(int(end) + 1, int(start)):
            host_ns = (t - H_US) * 1e3
            inside = [s for s in rec.spans if s.start_ns <= host_ns <= s.end_ns]
            total += 1
            s = max(inside, key=lambda s: s.start_ns) if inside else None
            while s is not None and s.name != name:
                s = by.get(s.parent)
            hit += s is not None
    return 100.0 * hit / total


def _readers(cell):
    c = harness.resolve(ROOT, cell)
    return {m["name"]: c.reader(m["name"]) for m in c.per_layer}


@pytest.mark.parametrize("rate, fill_us", [(2e-4, 100.0), (1.5e-3, 100.0)])
def test_the_join_when_the_events_clock_runs_slow(monkeypatch, rate, fill_us):
    """A busy stream (the host fills in 0.1 ms, the card runs 1.8 ms a
    bucket) read on a slow events' clock: the rate is fitted and every
    kernel still goes to the span that launched it."""
    trace, rec, owner, first = _stretch(rate, fill_us)
    monkeypatch.setattr(profiling, "take", lambda: rec)
    p = spans.program({"trace": trace})
    for i, k in enumerate(p.kernels):
        assert p.owner[i] is owner[(k[1], k[2])]
    assert sorted(p.device_ms("engine.launch").values()) == pytest.approx([1.8] * 6)
    assert 0 < p.dev_rate < 2 * rate  # 12 edges over 30 ms pin it loosely


def test_the_join_on_a_synthetic_stretch(monkeypatch):
    trace, rec, owner, first = _stretch()
    monkeypatch.setattr(profiling, "take", lambda: rec)
    p = spans.program({"trace": trace})
    assert p.dev_off == pytest.approx(first, abs=1.0)
    assert abs(p.host_off - H_US) < 3.0 and abs(p.marker_off - H_US - MARKER_US) < 6.0
    for i, k in enumerate(p.kernels):
        assert p.owner[i] is owner[(k[1], k[2])]
    assert sorted(p.device_ms("engine.launch").values()) == pytest.approx([1.8] * 6)
    assert p.unclaimed_share().startswith("0.000 %")
    for name in ("engine.fill", "engine.launch", "engine.embed_audio"):
        assert p.idle_share(name) == pytest.approx(_idle_in(trace, rec, name), abs=0.2)
    assert p.idle_share("engine.fill") > 60 and p.idle_share("engine.launch") > 5


def test_readers_leave_the_trace_and_the_existing_metrics_unchanged(monkeypatch):
    trace, rec, _, _ = _stretch()
    readers = _readers("caco_base.embed_10s")
    ctx = {"trace": trace, "profiled_clips": 64, "attention_least_s": 0.01,
           "gemm_least_s": 0.02, "units_per_s": 2500.0, "flops_per_unit": 9.5e10,
           "device_name": "NVIDIA H100 80GB HBM3"}
    old = {n: r.read(ctx) for n, r in readers.items() if n not in NEW}
    shape = (copy.deepcopy(trace.kernels), copy.deepcopy(trace.spans), trace.wall_s,
             trace.busy_s(), trace.top_ops(), trace.idle_gaps())
    monkeypatch.setattr(profiling, "take", lambda: rec)
    new = {n: readers[n].read(ctx) for n in readers if n in NEW}
    assert all(v is not None for v in new.values()), new
    assert new["embed.patch_useful_share"] == pytest.approx(91.0)
    assert new["embed.fill_ms"] == pytest.approx(4.0)
    assert {n: r.read(ctx) for n, r in readers.items() if n not in NEW} == old
    assert (trace.kernels, trace.spans, trace.wall_s, trace.busy_s(), trace.top_ops(),
            trace.idle_gaps()) == shape


def test_no_recorder_no_stretch_no_number(monkeypatch):
    trace, _, _, _ = _stretch()
    monkeypatch.setattr(profiling, "take", lambda: Recording())
    for name in NEW:
        reader = harness.load_file(os.path.join(ROOT, "portbench", "metrics", f"{name}.py"))
        assert reader.read({}) is None and reader.read({"trace": trace}) is None
