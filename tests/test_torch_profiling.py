"""The port's recorder (utils/profiling.py): spans that nest per thread
with their parents and request ids, self time, counters, the bounded
buffer, the off path (no clock read, nothing allocated), the clock against
`torch.profiler`'s, and the spans and counters the engine, the gallery, the
training frontend and the training step record at caco_tiny on the CPU.

The card test (marker `cuda`) places spans on a profiler session's clock
on the card: each kernel's launch lies inside its span and the kernel
starts on the card after the span began.  The file imports no JAX:

    python -m pytest tests/test_torch_profiling.py --noconftest -q
"""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.data import tokenizer as tok
from cacophony_tpu_torch.data.pipeline import device_train_frontend
from cacophony_tpu_torch.frontend.patchify import num_patches_for_samples
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.gallery import GalleryIndex
from cacophony_tpu_torch.train import train
from cacophony_tpu_torch.utils import profiling
from cacophony_tpu_torch.utils.profiling import Recorder


def _names(rec):
    return [s.name for s in rec.spans]


def test_spans_nest_per_thread_with_parents_and_requests():
    r = Recorder()

    def other():
        with r.span("other", request=True):
            pass

    with r.recording() as rec:
        with r.span("outer", request=True):
            with r.span("inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                with r.span("leaf"):
                    pass
        with r.span("free"):
            pass
    assert not t.is_alive()
    assert _names(rec) == ["outer", "inner", "other", "leaf", "free"]
    outer, inner, o, leaf, free = rec.spans
    assert inner.parent == outer.id and leaf.parent == inner.id and free.parent is None
    assert outer.request is not None and inner.request == leaf.request == outer.request
    assert free.request is None
    # another thread: its own stack, its own request
    assert o.parent is None and o.request not in (None, outer.request)
    assert o.thread != outer.thread == inner.thread
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns <= inner.end_ns \
        <= outer.end_ns <= free.start_ns
    assert rec.anchor is not None and r.take().spans == []  # the outermost block cleared it


def test_self_time_report_and_counters(monkeypatch):
    r = Recorder()
    ticks = iter(range(0, 10 ** 9, 10 ** 6))  # each clock read 1 ms after the last
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    with r.recording() as rec:
        for _ in range(2):
            with r.span("stage"):
                with r.span("part"):
                    pass
        r.count("rows", 32)
        r.count("rows", 32)
        r.count("prompts")
    # stage: 3 ms each (its 4 reads: start, part's start and end, end);
    # part: 1 ms each
    assert rec.self_ms("stage") == [2.0, 2.0] and rec.self_ms("part") == [1.0, 1.0]
    assert rec.counters == {"rows": 64, "prompts": 1}
    text = profiling.report(rec).splitlines()
    assert text[0] == "stage: 0.006s (2 calls, 3.0 ms/call)"
    assert text[1] == "part: 0.002s (2 calls, 1.0 ms/call)"
    assert text[2:] == ["prompts: 1", "rows: 64"]


def test_bounded_buffer_counts_what_it_drops():
    r = Recorder(capacity=3)
    with r.recording() as rec:
        for i in range(5):
            with r.span(f"s{i}"):
                pass
    assert _names(rec) == ["s0", "s1", "s2"] and rec.dropped == 2
    assert "dropped spans: 2" in profiling.report(rec)


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    reads = []
    monkeypatch.setattr(profiling, "_clock", lambda: reads.append(1) or 0)
    r = Recorder()
    assert not r.active()
    first = r.span("off")
    for _ in range(2):  # the second pass runs warm
        tracemalloc.start()
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with r.span("off", device=torch.device("cpu"), request=True):
                pass
            r.count("n", 3)
        after = tracemalloc.take_snapshot()
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "lineno")
                if d.traceback[0].filename == profiling.__file__)
    assert reads == [] and grown == 0 and r.span("off") is first
    assert r.take().spans == [] and r.take().counters == {}


def test_recording_inside_a_profiler_session_leaves_the_spans_for_it():
    r = Recorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert r.active()
        with r.span("session"):
            pass
        with r.recording() as rec:
            with r.span("block"):
                pass
    assert not r.active()
    assert _names(rec) == ["block"] and _names(r.take()) == ["session", "block"]


def test_spans_lie_on_the_profilers_clock():
    """A CPU op run inside a span, placed by the session's trace_start_ns,
    lies inside that span."""
    x = torch.randn(256, 256)
    profiling.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with profiling.span("matmul"):
                x @ x
            time.sleep(0.002)
    rec = profiling.take()
    placed = rec.placed(prof.profiler.kineto_results.trace_start_ns())
    ops = sorted((e.time_range for e in prof.events() if e.name == "aten::mm"),
                 key=lambda r: r.start)
    assert len(placed) == len(ops) == 5
    for (s, a, b), op in zip(placed, ops):
        assert s.name == "matmul" and a <= op.start <= op.end <= b


# ------------------------------------------------------- the program's spans

def _byte_tokenizer():
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in tok._bytes_to_unicode().values():
        vocab[c] = len(vocab)
    return tok.ByteLevelBPETokenizer(vocab, [])


@pytest.fixture(scope="module")
def tiny():
    cfg = configs.caco_tiny(vocab_size=300)
    model = caco_init(cfg, torch.Generator().manual_seed(0))
    engine = CacoEngine(cfg, model, tokenizer=_byte_tokenizer(), device="cpu",
                        buffer_seconds=1.0, max_text_len=24, batch_size=4)
    return cfg, model, engine


def test_engine_audio_spans_and_counters(tiny):
    _, _, engine = tiny
    rng = np.random.default_rng(0)
    lens = [16000, 3000, 100, 16000, 9000, 16000]
    wavs = [rng.standard_normal(n).astype(np.float32) for n in lens]
    with profiling.recording() as rec:
        engine.embed_audio(wavs)
    top = [s for s in rec.spans if s.parent is None]
    assert _names(rec)[0] == "engine.embed_audio" and len(top) == 1 and top[0].request
    assert {s.request for s in rec.spans} == {top[0].request}
    by = {n: [s for s in rec.spans if s.name == n] for n in set(_names(rec))}
    assert {n: len(v) for n, v in by.items()} == {
        "engine.embed_audio": 1, "engine.fill": 2, "engine.launch": 2, "engine.frontend": 2,
        "audio.encoder": 2, "audio.pooler": 2, "engine.retire": 2}
    ids = {s.id: s.name for s in rec.spans}
    assert {ids[s.parent] for n in ("engine.frontend", "audio.encoder", "audio.pooler")
            for s in by[n]} == {"engine.launch"}
    seq = engine.patch.patches_seq_len
    padded = np.array(lens + [0, 0])
    batches = [engine.audio_patch_batch(wavs[i:i + 4])[0]["audio_mask"] for i in (0, 4)]
    valid = int(sum(int(m.sum()) for m in batches))
    assert valid == int(np.minimum(num_patches_for_samples(padded, engine.front, engine.patch),
                                   seq).sum())
    assert rec.counters == {"engine.buckets": 2, "engine.clips": 6, "engine.rows": 8,
                            "engine.valid_patches": valid, "engine.patch_slots": 8 * seq}


def test_engine_text_and_gallery_spans_and_counters(tiny):
    _, _, engine = tiny
    gallery = GalleryIndex(engine.cfg.projection_size, slab=16, device="cpu")
    rows = np.random.default_rng(1).standard_normal((40, engine.cfg.projection_size))
    gallery.add((rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(np.float32))
    with profiling.recording() as rec:
        emb = engine.embed_texts(["a dog barking"])
        gallery.search(emb, k=5)
    assert _names(rec) == ["engine.embed_texts", "engine.tokenize", "engine.text_tower",
                           "engine.copy_back", "gallery.search", "gallery.product",
                           "gallery.topk", "gallery.copy_back"]
    assert rec.counters == {"engine.text_prompts": 1, "engine.text_rows": 4,
                            "gallery.rows_scanned": gallery.capacity}
    assert rec.spans[0].request and rec.spans[4].request is None


def test_train_step_and_frontend_spans(tiny):
    cfg, _, _ = tiny
    model = caco_init(cfg, torch.Generator().manual_seed(1))
    tc = train.TrainConfig(warmup_steps=1)
    step = train.make_caco_train_step(cfg, tc)
    front = configs.FrontendConfig()
    frontend = device_train_frontend(front, configs.PatchConfig(patches_seq_len=48), 48)
    gen = torch.Generator().manual_seed(2)
    bufs = torch.randn(2, 8000, generator=gen)
    ids = torch.randint(4, 300, (2, 12), generator=gen, dtype=torch.int32)
    with profiling.recording() as rec:
        batch = frontend(gen, bufs, torch.tensor([8000, 5000], dtype=torch.int32))
        batch["text_input_ids"], batch["text_mask"] = ids, torch.ones_like(ids)
        step(train.init_train_state(model, tc), batch, gen)
    top = [s.name for s in rec.spans if s.parent is None]
    assert top == ["train.frontend", "train.forward", "train.backward", "train.grad_norm",
                   "train.optimizer"]
    assert [s.name for s in rec.spans if s.parent == rec.spans[1].id] == ["audio.encoder",
                                                                          "audio.pooler"]


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_kernels_launch_inside_their_spans_on_the_card():
    """20 rounds: sleep 1 ms, then one kernel launched inside a span, under
    a CUDA-only profiler session (as the benchmark's traced stretch runs).
    Each kernel's launch, from the kineto events, lies inside its span on
    the session's clock, and the kernel starts on the card after the span
    began."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(1 << 20, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    profiling.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            time.sleep(0.001)
            with profiling.span(f"round{i}"):
                x.add_(1)
        torch.cuda.synchronize()
    rec = profiling.take()
    placed = {s.name: (a, b) for s, a, b in
              rec.placed(prof.profiler.kineto_results.trace_start_ns())}
    kernels = [k for k in profiling.join(prof, rec) if "elementwise" in k[0]]
    assert len(kernels) == 20, kernels
    for i, (name, start, end, launched, span) in enumerate(kernels):
        a, b = placed[f"round{i}"]
        assert launched is not None and a <= launched <= b, (i, a, launched, b)
        assert span.name == f"round{i}" and start > a, (i, span, a, start)
