"""The mesh on the card: data parallelism at world 1 over NCCL (a one-rank
group in this process, no launcher) for the stage-2 step, the engine and
the gallery, each against the same call without a mesh; and tensor
parallelism at (dp, tp) = (1, 2) with two ranks spawned on the one card
over a gloo group on CUDA tensors (NCCL takes one rank a card), held to
the one-process step.  Marked `cuda`; the tp test is `slow`."""

import dataclasses
import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.checkpoints import io as ckpt_io
from cacophony_tpu_torch.models.audio import audiomae_init
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.parallel import make_mesh, shard_params
from cacophony_tpu_torch.parallel.mesh import coalesced, gather_params
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.gallery import GalleryIndex
from cacophony_tpu_torch.train import train
from torch_card import (NO_SERVING, SEED, TP_LR, TP_TOL, audio_batch, check_close, clips,  # noqa: F401
                        cuda, drive, gallery_data, launches, no_text_dropout, record,
                        reset_launches, tol, train_batch)

pytestmark = pytest.mark.cuda

LAYERS, TP = 12, 2
TC = train.TrainConfig(warmup_steps=1, total_steps=100)


@pytest.fixture(scope="module")
def mesh(cuda):
    """A one-rank NCCL mesh, its process group destroyed afterwards."""
    m = make_mesh(dp=1, device="cuda")
    assert dist.get_backend() == "nccl"
    yield m
    dist.destroy_process_group()


def max_diff(a, b) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


@pytest.mark.parametrize("dtype,k7", [(torch.bfloat16, LAYERS), (torch.float32, 0)])
def test_dp_step_at_world_1_is_the_step_without_a_mesh(mesh, dtype, k7):
    """3 steps at caco_base (B=16, 500 patches) from the same parameters and
    generator without the mesh, with it, and without it again: the losses
    before the first update (the rate is 0 at step 0) are the same bits;
    where the step repeats itself bit for bit (fp32 at 500 patches runs no
    K7; bf16's K7 sums dQ with float atomics and does not), the mesh's
    losses and parameters are the same bits too."""
    cfg = dataclasses.replace(configs.caco_base(), dtype=dtype)
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).cuda()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(cfg, np.random.RandomState(SEED + 18), 16, 10, 500)

    def run(m):
        model.load_state_dict(init)
        state = train.init_train_state(model, TC)
        step = train.make_caco_train_step(cfg, TC, mesh=m)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        losses = []
        for _ in range(3):
            state, met = step(state, batch, gen)
            losses.append(float(met["loss"]))
        return losses, {k: v.clone() for k, v in model.state_dict().items()}

    ref = run(None)
    got, _ = drive(lambda: run(mesh), {"k4": 3 * LAYERS, "k7": 3 * k7, "k5": 0, **NO_SERVING})
    again = run(None)
    assert got[0][:2] == ref[0][:2]
    if ref[0] == again[0] and max_diff(ref[1], again[1]) == 0.0:
        assert got[0] == ref[0] and max_diff(got[1], ref[1]) == 0.0
    else:
        assert dtype == torch.bfloat16


def test_gradient_all_reduce_at_world_1_is_a_copy(mesh):
    """One bf16 backward's gradients through the step's coalesced all-reduce
    over the one-rank dp group: the same bits."""
    cfg = dataclasses.replace(configs.caco_base(), dtype=torch.bfloat16)
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).cuda()
    batch = train_batch(cfg, np.random.RandomState(SEED + 18), 16, 10, 500)
    loss, _ = train.make_caco_loss(cfg, TC)(model, batch,
                                            torch.Generator(device="cuda").manual_seed(SEED))
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    coalesced(grads, lambda flat: dist.all_reduce(flat, group=mesh.get_group("dp")))
    assert all(torch.equal(g, p.grad) for g, p in zip(grads, model.parameters()))


def test_dp_engine_at_world_1_is_the_engine_without_a_mesh(mesh):
    """The bf16 10-s engine with the mesh on 70 clips: K1 on every layer of
    every bucket, embeddings bit for bit the engine's without it."""
    cfg = configs.caco_base()
    model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    wavs = clips(np.random.RandomState(SEED), 70, 3, 10)
    ref = CacoEngine(cfg, model, batch_size=32, dtype=torch.bfloat16).embed_audio(wavs)
    engine = CacoEngine(cfg, model, batch_size=32, dtype=torch.bfloat16, mesh=mesh)
    got, _ = drive(lambda: engine.embed_audio(wavs),
                   {"k1_layer": 3 * LAYERS, "k2_block": 0, "k3_block": 0, "log_mel": 0})
    assert np.array_equal(got, ref)


def test_dp_gallery_at_world_1_is_the_gallery_without_a_mesh(mesh):
    """262 144 × 768 rows added in four parts, 1 % deleted, 1024 queries:
    the mesh's search equals the search without it."""
    rows_n, dim = 262_144, 768
    rows, queries, dead = gallery_data(rows_n, dim, 1024)
    out = []
    for m in (None, mesh):
        g = GalleryIndex(dim, logit_scale=1.7, slab=131_072, device="cuda", mesh=m)
        for i in range(0, rows_n, rows_n // 4):
            g.add(rows[i:i + rows_n // 4])
        g.delete(dead)
        assert g.num_deleted == len(dead)
        out.append(g.search(queries, k=10))
    (s0, i0, l0), (s1, i1, l1) = out
    assert np.array_equal(s0, s1) and np.array_equal(i0, i1) and l0 == l1


# ---- tensor parallelism: two ranks on the one card over gloo ---------------

TP_STEPS = 3
TP_TC = train.TrainConfig(learning_rate=TP_LR, warmup_steps=1, total_steps=100)


@torch.inference_mode()
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_at_a_tp_ranks_shapes(cuda, dtype):
    """K4 (both dtypes), K7 and K5 (bf16) at the shapes a rank gives them
    under tp 2: 4 of the 8 heads of Dh 96; K5 on the plan of the full 768
    width."""
    gen = torch.Generator().manual_seed(SEED + 19)
    heads, width = 4, 384

    def inputs(b, s, w, lengths):
        x = (1.5 * torch.randn(b, s, w, generator=gen)).to("cuda", dtype)
        return x, (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to("cuda", torch.int32)

    qkv, mask = inputs(16, 500, 3 * width, [500, 400, 300, 500, 100, 250, 0, 17] * 2)
    check_close(kern.attention_k4(qkv, mask, heads), kern.attention_plain(qkv, mask, heads),
                tol(dtype, "kernel"))
    if dtype == torch.float32:
        return
    g = torch.randn(16, 500, width, generator=gen).to("cuda", dtype)
    check_close(kern.attention_bwd(qkv, mask, g, heads), kern.attention_bwd_plain(qkv, mask, g, heads),
                tol(dtype, "k7"))
    assert ea.kernel_plan(1500, 768, torch.bfloat16) == ("blocked", 1536, 256)
    q, mask = inputs(4, 1500, width, [1500, 1200, 37, 0])
    kv, _ = inputs(4, 1500, 2 * width, [1500, 1200, 37, 0])
    check_close(ea.encoder_attention_blocked(q, kv, mask, heads, width=768),
                ea.encoder_attention_blocked_plain(q, kv, mask, heads), tol(dtype, "kernel"))


def replicated_equal(model) -> bool:
    """Every leaf tp does not shard is the same bits on both ranks."""
    mine = [p.detach() for n, p in model.named_parameters() if n not in model.tp_layout]
    theirs = [t.clone() for t in mine]
    coalesced(theirs, lambda flat: dist.broadcast(flat, src=0))
    ok = torch.tensor([float(all(torch.equal(a, b) for a, b in zip(mine, theirs)))], device="cuda")
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def tp_steps(step, state, batch, n: int, first: int = 0):
    """n steps, step i drawing from a generator seeded SEED + i."""
    metrics = []
    for i in range(first, first + n):
        state, m = step(state, batch, torch.Generator(device="cuda").manual_seed(SEED + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def params_rel_l2(got: dict, ref: dict) -> float:
    num = sum(float((got[k].double() - ref[k].double()).square().sum()) for k in ref)
    return (num / sum(float(ref[k].double().square().sum()) for k in ref)) ** 0.5


def tp_run(make_step, cfg, model, init, batch, mesh, n, rank, reference):
    """n steps of make_step(cfg, tc, mesh) from `init` at tp 2 (both ranks),
    then on rank 0 the same steps without a mesh on `reference` → a
    summary of the launches, metrics and parameters."""
    model.load_state_dict(init)
    shard_params(model, mesh)
    reset_launches()
    state, metrics = tp_steps(make_step(cfg, TP_TC, mesh), train.init_train_state(model, TP_TC),
                              batch, n)
    out = {"launches": launches(), "metrics": metrics, "replicated_equal": replicated_equal(model)}
    del state
    gather_params(model, mesh)
    if rank == 0:
        reference.load_state_dict(init)
        state, out["ref_metrics"] = tp_steps(make_step(cfg, TP_TC),
                                             train.init_train_state(reference, TP_TC), batch, n)
        del state
        got, ref = model.state_dict(), reference.state_dict()
        out["params"] = {"rel_l2": params_rel_l2(got, ref), "max_abs": max_diff(got, ref)}
    dist.barrier()
    return out


def tp_resume(cfg, model, init, batch, mesh, rank, reference, tmp):
    """TP_STEPS fp32 steps at tp 2, the train state saved (whole leaves, rank
    0 writes), one more step; one process resumes the file and takes the
    same step → its loss and parameters against tp's."""
    model.load_state_dict(init)
    shard_params(model, mesh)
    step = train.make_caco_train_step(cfg, TP_TC, mesh)
    state, _ = tp_steps(step, train.init_train_state(model, TP_TC), batch, TP_STEPS)
    ck = os.path.join(tmp, "checkpoints")
    path = ckpt_io.save_train_state(state, ck, mesh=mesh)
    state, after = tp_steps(step, state, batch, 1, TP_STEPS)
    del state
    gather_params(model, mesh)
    out = {"tp_loss": after[0]["loss"]}
    if rank == 0:
        resumed = ckpt_io.load_train_state(ck, train.init_train_state(reference, TP_TC))
        saved = torch.load(os.path.join(path, ckpt_io.TRAIN_STATE_FILE), map_location="cpu")
        whole = all(tuple(saved["params"][n].shape) == tuple(p.shape)
                    for n, p in reference.named_parameters())
        state, one = tp_steps(train.make_caco_train_step(cfg, TP_TC), resumed, batch, 1, TP_STEPS)
        del state, saved
        out.update(one_loss=one[0]["loss"], whole_leaves=whole and resumed.step == TP_STEPS,
                   params_rel_l2=params_rel_l2(model.state_dict(), reference.state_dict()))
    dist.barrier()
    return out


def tp_rank(rank: int, tmp: str):
    """One rank (a process of its own, spawned; both on card 0): every run's
    summary to tmp/tp_rank{rank}.pt."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern.load_library()  # built by the parent before the spawn
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=TP, timeout=datetime.timedelta(seconds=600))
    out = {}
    try:
        mesh = make_mesh(dp=1, tp=TP, device="cuda")
        out["mesh"] = (tuple(mesh.shape), dist.get_backend())
        data = torch.load(os.path.join(tmp, "batches.pt"))
        on = lambda b: {k: v.cuda() for k, v in b.items()}  # noqa: E731
        base = configs.caco_base()
        model = caco_init(base, torch.Generator().manual_seed(SEED)).cuda()
        init = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        reference = caco_init(base, torch.Generator()).cuda() if rank == 0 else None
        batch = on(data["caco"])
        for name, dtype, dropout in (("bf16", torch.bfloat16, False), ("fp32", torch.float32, False),
                                     ("bf16_dropout", torch.bfloat16, True),
                                     ("fp32_dropout", torch.float32, True)):
            cfg = dataclasses.replace(base if dropout else no_text_dropout(base), dtype=dtype)
            out[name] = tp_run(train.make_caco_train_step, cfg, model, init, batch, mesh, TP_STEPS,
                               rank, reference)
        out["resume"] = tp_resume(no_text_dropout(base), model, init, batch, mesh, rank, reference,
                                  tmp)
        out["bf16_30s"] = tp_run(train.make_caco_train_step,
                                 dataclasses.replace(base, dtype=torch.bfloat16), model, init,
                                 on(data["caco30"]), mesh, 2, rank, reference)
        del model, reference, init
        mae_cfg = configs.audiomae_base()
        mae = audiomae_init(mae_cfg.encoder, mae_cfg.decoder,
                            torch.Generator().manual_seed(SEED)).cuda()
        mae_init = {k: v.to("cpu", copy=True) for k, v in mae.state_dict().items()}
        mae_ref = (audiomae_init(mae_cfg.encoder, mae_cfg.decoder, torch.Generator()).cuda()
                   if rank == 0 else None)
        out["mae_fp32"] = tp_run(train.make_mae_train_step, mae_cfg, mae, mae_init, on(data["mae"]),
                                 mesh, TP_STEPS, rank, mae_ref)
    finally:
        torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))
        dist.destroy_process_group()


@pytest.mark.slow
def test_tp_steps_on_two_ranks_match_one_process(cuda, tmp_path):
    """At (dp, tp) = (1, 2), two ranks on the card over gloo: the stage-2
    step at caco_base (B=16, 500 patches, 100 tokens, 3 steps) in bf16 and
    fp32, without and with the configs' dropout; the 30-s bf16 step (B=4, 2
    steps); the fp32 stage-1 step at audiomae_base (mask 0.8).  Each is
    held to the step rank 0 runs alone from the same parameters and
    generators (TP_TOL); the ranks' metrics are equal, every replicated
    leaf is the same bits on both; K4 once a layer a step, K7 once in bf16
    and never in fp32 (the stage-1 encoder's 100 patches take it in fp32),
    K5 once a layer in the 30-s step.  A train state written at tp 2 holds
    whole leaves, and one process resumed from it takes tp's next step."""
    rs = np.random.RandomState(SEED + 19)
    cfg = configs.caco_base()
    cpu = lambda b: {k: v.cpu() for k, v in b.items()}  # noqa: E731
    torch.save({"caco": cpu(train_batch(cfg, rs, 16, 10, 500)),
                "caco30": cpu(train_batch(cfg, rs, 4, 30, 1500)),
                "mae": cpu(audio_batch(rs, 16, 10, 500))}, str(tmp_path / "batches.pt"))
    kern.load_library()
    torch.cuda.empty_cache()
    torch.multiprocessing.spawn(tp_rank, args=(str(tmp_path),), nprocs=TP, join=True)
    got = [torch.load(str(tmp_path / f"tp_rank{r}.pt"), weights_only=False) for r in range(TP)]
    assert got[0]["mesh"] == ((1, TP), "gloo")
    mae_layers = configs.audiomae_base().encoder.num_layers
    k4 = {"k4": LAYERS * TP_STEPS, "k5": 0}
    runs = {"bf16": (torch.bfloat16, {**k4, "k7": LAYERS * TP_STEPS}),
            "fp32": (torch.float32, {**k4, "k7": 0}),
            "bf16_dropout": (torch.bfloat16, {**k4, "k7": LAYERS * TP_STEPS}),
            "fp32_dropout": (torch.float32, {**k4, "k7": 0}),
            "bf16_30s": (torch.bfloat16, {"k5": LAYERS * 2, "k4": 0, "k7": 0}),
            "mae_fp32": (torch.float32, {"k4": 2 * mae_layers * TP_STEPS, "k5": 0,
                                         "k7": mae_layers * TP_STEPS})}
    for name, (dtype, expect) in runs.items():
        r0, r1 = got[0][name], got[1][name]
        record(r0["launches"], f"rank 0, {name}")
        for res in (r0, r1):
            assert {k: res["launches"][k] for k in expect} == expect, name
            assert all(res["launches"][k] == v for k, v in NO_SERVING.items()), name
            assert np.isfinite([m["loss"] for m in res["metrics"]]).all(), name
            assert res["replicated_equal"], name
        assert r0["metrics"] == r1["metrics"], name
        bound = TP_TOL[dtype]
        for k in ("loss", "grad_norm"):
            rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(r0["metrics"], r0["ref_metrics"]))
            assert rel <= bound[k], (name, k, rel)
        if "params_rel_l2" in bound:
            assert r0["params"]["rel_l2"] <= bound["params_rel_l2"], name
        else:
            assert r0["params"]["max_abs"] <= bound["params_max"], name
    res = got[0]["resume"]
    assert res["whole_leaves"]
    assert abs(res["tp_loss"] - res["one_loss"]) <= TP_TOL[torch.float32]["loss"] * abs(res["one_loss"])
    assert res["params_rel_l2"] <= TP_TOL[torch.float32]["params_rel_l2"]
