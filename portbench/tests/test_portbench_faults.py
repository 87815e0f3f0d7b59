"""`correct` comes out false for the control and for the faults each cell
can have, on cells cut to the CPU and held to the cells' own limits: the
harness's look for a chip is skipped and the rest of a run is driven with
the timed path broken underneath."""

import pytest
import torch

from portbench import harness, plain
from tiny_cells import context

# each training cell and the step factory its driver calls
TRAINING = {"caco_base.train_10s": "make_caco_train_step",
            "audiomae_base.pretrain_10s": "make_mae_train_step"}


def _ctx(name, seconds=0.3):
    """The program in fp32 at this size, so that a failure is the fault's."""
    return context(name, seconds=seconds, dtype="float32")


def _correct(ctx) -> bool:
    res = ctx.cell.driver().run(ctx)
    ok, _ = harness.judge(ctx.cell.limits, res["checks"])
    return ok and res["failed"] == 0


@pytest.mark.parametrize("name", ["caco_base.embed_10s", "caco_base.text_query"] + list(TRAINING))
def test_control_fails(name):
    """The plain reference in lower precision (fp8 products; the gallery's
    scores in TF32, which the CPU computes in fp32) in the program's place
    fails at least one of the cell's numbers; the program itself passes.
    The window is long enough that the sample holds several requests or
    calls however slow the CPU is: one short prompt alone can read under
    the limit at these widths."""
    ctx = _ctx(name, seconds=2.0)
    res = ctx.cell.driver().run(ctx)
    lower = res["control"](plain.Fp8)
    ok_program, _ = harness.judge(ctx.cell.limits, res["checks"])
    ok_control, _ = harness.judge(ctx.cell.limits, lower)
    assert ok_program and not ok_control, (res["checks"], lower)


def test_altered_embedding_fails(monkeypatch):
    from cacophony_tpu_torch.runtime import engine

    real = engine.get_audio_embedding

    def altered(*args, **kw):
        emb, hidden = real(*args, **kw)
        emb = emb.clone()
        emb[0] = torch.roll(emb[0], 1)
        return emb, hidden

    monkeypatch.setattr(engine, "get_audio_embedding", altered)
    assert not _correct(_ctx("caco_base.embed_10s"))


@pytest.mark.parametrize("what", ["embedding", "search"])
def test_altered_query_answer_fails(monkeypatch, what):
    from cacophony_tpu_torch.runtime import engine, gallery

    if what == "embedding":
        real = engine.CacoEngine.embed_texts
        monkeypatch.setattr(engine.CacoEngine, "embed_texts",
                            lambda self, texts: real(self, texts)[:, ::-1].copy())
    else:
        real = gallery.GalleryIndex.search

        def shifted(self, q, k=10):
            s, i, labels = real(self, q, k + 1)
            return s[:, 1:], i[:, 1:], [row[1:] for row in labels]

        monkeypatch.setattr(gallery.GalleryIndex, "search", shifted)
    assert not _correct(_ctx("caco_base.text_query"))


@pytest.mark.parametrize("name", list(TRAINING))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_fails(monkeypatch, name, fault):
    """A step that returns its state unchanged; a step that leaves out half
    of the batch and takes the mean over the rest."""
    from cacophony_tpu_torch.train import train

    real = getattr(train, TRAINING[name])

    def broken(cfg, tc, mesh=None):
        step = real(cfg, tc)

        def run(state, batch, gen):
            if fault == "half_batch":
                half = batch["audio_mask"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()}, gen)
            saved = [p.detach().clone() for p in state.params.parameters()]
            _, metrics = step(state, batch, gen)
            with torch.no_grad():
                for p, q in zip(state.params.parameters(), saved):
                    p.copy_(q)
                for m, v in zip(state.opt_state.mu, state.opt_state.nu):
                    m.zero_()
                    v.zero_()
            return state, metrics

        return run

    monkeypatch.setattr(train, TRAINING[name], broken)
    assert not _correct(_ctx(name))

