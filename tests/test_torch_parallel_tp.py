"""Tensor parallelism in the port on the CPU: gloo ranks spawned as
tests/test_torch_parallel.py spawns them (a `file://` rendezvous under the
test's temporary directory, one thread a rank, no JAX in the ranks; the
JAX package's references are computed here in the parent on its virtual
CPU devices, the ranks' results come back through files).

- the layout: `shard_params` then `gather_params` is the identity bit for
  bit at tp 2 and tp 4; each rank's fused QKV block holds the q, k and v
  columns of its heads, its o block the matching rows; caco_base's layout
  by shapes on the meta device;
- the caco_tiny stage-2 step in fp32 at (dp, tp) = (1, 2) and (2, 2),
  dropout 0, two steps: against the port's one-process step and JAX's
  `make_caco_train_step` on `make_mesh(dp, tp)`; with the configs'
  dropout at (1, 2) against the one-process step with the same generator;
  the vocabulary head vocab-parallel at 128 words and replicated at 301;
- the stage-1 step at (2, 2) against one process and JAX's
  `make_mae_train_step` on `make_mesh(2, 2)`;
- the routes at caco_base width on a tp-2 attention layer: decided on the
  full width (fp32 at 500 patches: K4 and no K7; bf16 at 500: K7; bf16 at
  1496: K5 on the plan JAX makes at 768, q-block 256; fp32 at 1496: the
  einsum route), the outputs and input gradients against the whole layer;
- a tp that does not divide a tower's heads raises ValueError.

Tolerances are those of tests/test_torch_parallel.py, for the same
reasons: against the one-process step the losses and grad_norm 1e-6
relative (the same products summed in another order: a row-parallel
layer's two partial products, the norm's squares by rank; measured ≤ 3e-7)
and the parameters 1e-5 relative in L2 (an element whose gradient is near
Adam's eps, the key biases, turns rounding into a move of a few 1e-6;
measured 4.8e-6 at (1, 2)); against JAX the losses 1e-5 relative and the
parameters by the quantiles of tests/test_torch_train_step.py.  The
attention layer: fp32 1e-5 of the output's largest value (the o-projection
summed in two parts), bf16 2e-2 (each part rounded to bf16 before their
bf16 sum: three roundings of 2^-9 where the whole layer makes one).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.models.audio import AudioMAE, audiomae_init
from cacophony_tpu_torch.models.caco import CacoModel, caco_init
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.ops.attention import Attention, multi_head_attention
from cacophony_tpu_torch.parallel import make_mesh, shard_batch, shard_params
from cacophony_tpu_torch.parallel.mesh import (
    dp_rows,
    gather_params,
    join_blocks,
    local_block,
    tp_layout,
)
from cacophony_tpu_torch.parallel.multihost import initialize_multihost
from cacophony_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

LR, STEPS, B = 1e-3, 2, 8
MESHES = {2: (1, 2), 4: (2, 2)}


def _no_dropout(cfg):
    text = dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0)
    dec = dataclasses.replace(cfg.decoder, hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(cfg, text=text, decoder=dec)


def _tc():
    return ttrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)


def _cfg(vocab=128, dropout=False):
    cfg = tcfg.caco_tiny(vocab_size=vocab)
    return cfg if dropout else _no_dropout(cfg)


def _four_heads():
    """caco_tiny with 4 heads in every tower and the pooler (tp 4 divides them)."""
    cfg = tcfg.caco_tiny()
    return dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, num_heads=4),
        text=dataclasses.replace(cfg.text, num_heads=4),
        decoder=dataclasses.replace(cfg.decoder, num_heads=4), num_attention_pool_heads=4)


def _mae_cfg():
    enc = tcfg.AudioEncoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                  intermediate_size=64, num_freq_patches=8)
    dec = tcfg.AudioDecoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                  intermediate_size=64, num_freq_patches=8)
    return tcfg.AudioMAEConfig(encoder=enc, decoder=dec, mask_ratio=0.75)


def _batch(s=24, t=10, seed=0, vocab=128):
    rs = np.random.RandomState(seed)
    lens = np.array([24, 20, 16, 9, 24, 13, 5, 24])[:B]
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None] * mask
    tlens = np.array([10, 8, 5, 10, 3, 7, 10, 6])[:B]
    tmask = (np.arange(t)[None] < tlens[:, None]).astype(np.int32)
    ids = rs.randint(4, vocab, (B, t)).astype(np.int32)
    return {"audio_patches": (rs.randn(B, s, 256) * mask[..., None]).astype(np.float32),
            "audio_time_inds": inds // 8, "audio_freq_inds": inds % 8, "audio_mask": mask,
            "text_input_ids": np.where(tmask > 0, ids, 1).astype(np.int32), "text_mask": tmask}


def _torch_batch(**kw):
    return {k: torch.from_numpy(v) for k, v in _batch(**kw).items()}


def _mae_noise():
    """The masking noise of every stage-1 step, global (B, 24): JAX's step
    is jitted once, so its patched draw is one array for all steps."""
    return torch.from_numpy(np.random.RandomState(40).rand(B, 24).astype(np.float32))


def _steps(step, state, batch, n=STEPS, seed=0):
    metrics = []
    for i in range(n):
        state, m = step(state, batch, torch.Generator().manual_seed(seed + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _caco_run(cfg, mesh=None, vocab=128):
    """STEPS stage-2 steps from caco_init(seed 0) → (metrics, whole parameters)."""
    model = caco_init(cfg, torch.Generator().manual_seed(0))
    batch = _torch_batch(vocab=vocab)
    if mesh is not None:
        shard_params(model, mesh)
        batch = shard_batch(batch, mesh)
    _, metrics = _steps(ttrain.make_caco_train_step(cfg, _tc(), mesh),
                        ttrain.init_train_state(model, _tc()), batch)
    return metrics, gather_params(model, mesh).state_dict()


def _mae_run(mesh=None):
    mcfg = _mae_cfg()
    mae = audiomae_init(mcfg.encoder, mcfg.decoder, torch.Generator().manual_seed(7))
    batch = {k: v for k, v in _torch_batch().items() if k.startswith("audio")}
    if mesh is not None:
        shard_params(mae, mesh)
        batch = shard_batch(batch, mesh)
    _, metrics = _steps(ttrain.make_mae_train_step(mcfg, _tc(), mesh),
                        ttrain.init_train_state(mae, _tc()), batch)
    return metrics, gather_params(mae, mesh).state_dict()


def _fixed_noise(generator, mask, mesh=None):
    """mae_noise replaced by _mae_noise(), this rank's dp rows."""
    noise = _mae_noise()
    return noise if mesh is None else noise[dp_rows(noise.shape[0], mesh)]


# ------------------------------------------------------------ spawned ranks

def _rank_main(rank, world, root):
    torch.set_num_threads(1)
    initialize_multihost(f"file://{root}/rendezvous_{world}", world, rank, device="cpu")
    out = {}
    try:
        mesh = make_mesh(*MESHES[world], device="cpu")
        out["layout"] = _layout_checks(mesh, _cfg())
        out["caco"] = _caco_run(_cfg(), mesh)
        if world == 2:
            out["dropout"] = _caco_run(_cfg(dropout=True), mesh)
            out["odd_vocab"] = _caco_run(_cfg(vocab=301), mesh, vocab=301)
            out["routes"] = _route_checks(mesh)
            out["indivisible"] = _errors(mesh)
        else:
            ttrain.mae_noise = _fixed_noise
            out["mae"] = _mae_run(mesh)
            out["layout_tp4"] = _layout_checks(make_mesh(1, 4, device="cpu"), _four_heads())
    finally:
        torch.save(out, os.path.join(root, f"rank{world}_{rank}.pt"))
        dist.destroy_process_group()


def _layout_checks(mesh, cfg):
    """shard_params ∘ gather_params is the identity; the QKV and o blocks
    are this rank's heads' columns and rows."""
    model = caco_init(cfg, torch.Generator().manual_seed(3))
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    shard_params(model, mesh)
    tp, r = mesh["tp"].size(), mesh.get_local_rank("tp")
    d, h = cfg.audio.hidden_size, cfg.audio.num_heads
    hd, mine = d // h, range(r * h // tp, (r + 1) * h // tp)
    cols = [g * d + i * hd + j for g in range(3) for i in mine for j in range(hd)]
    qkv = model.audio.blocks[0].attn.qkv
    heads_ok = (torch.equal(qkv.w, whole["audio.blocks.0.attn.qkv.w"][:, cols])
                and torch.equal(qkv.b, whole["audio.blocks.0.attn.qkv.b"][cols])
                and torch.equal(model.audio.blocks[0].attn.o.w,
                                whole["audio.blocks.0.attn.o.w"][cols[:len(cols) // 3]]))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    gather_params(model, mesh)
    identity = all(torch.equal(v, whole[k]) for k, v in model.state_dict().items())
    return {"heads": heads_ok, "identity": identity, "shapes": shapes,
            "attrs_gone": not any(hasattr(m, "tp_shard") for m in model.modules())}


def _errors(mesh):
    out = {}
    for name, cfg in (("pool", dataclasses.replace(_cfg(), num_attention_pool_heads=1)),
                      ("mae", dataclasses.replace(_mae_cfg(), encoder=dataclasses.replace(
                          _mae_cfg().encoder, num_heads=1, hidden_size=32)))):
        make = ttrain.make_caco_train_step if name == "pool" else ttrain.make_mae_train_step
        try:
            make(cfg, _tc(), mesh)
        except ValueError as e:
            out[name] = str(e)
    return out


ROUTE_CASES = ((torch.float32, 500), (torch.bfloat16, 500), (torch.bfloat16, 1496),
               (torch.float32, 1496))


def _route_checks(mesh):
    """A caco_base-width attention layer (768 wide, 8 heads of 96) whole
    and sharded over tp 2: which kernels run, the plans' widths, the
    outputs and the input gradients."""
    calls = []
    spies = {"k4": kern.attention_k4, "k5": kern.attention_k5, "k7": kern.attention_bwd}
    heads_arg = {"k4": 2, "k5": 3, "k7": 3}

    def spy(name):
        def run(*a, **kw):
            calls.append((name, a[heads_arg[name]]))
            return spies[name](*a, **kw)
        return run

    plan = ea.kernel_plan
    saved = (kern.attention_k4, kern.attention_k5, kern.attention_bwd, ea.kernel_plan)
    kern.attention_k4, kern.attention_k5, kern.attention_bwd = spy("k4"), spy("k5"), spy("k7")
    ea.kernel_plan = lambda s, d, dt: calls.append(("plan", (s, d), plan(s, d, dt))) or plan(s, d, dt)
    try:
        holder = nn.Module()
        holder.attn = Attention(768, torch.Generator().manual_seed(5))
        whole = Attention(768)
        whole.load_state_dict(holder.attn.state_dict())
        shard_params(holder, mesh)
        out = {}
        for dtype, s in ROUTE_CASES:
            g = torch.Generator().manual_seed(s)
            x = torch.randn(1, s, 768, generator=g)
            mask = (torch.arange(s)[None] < s - 37).to(torch.int32)
            res = []
            for layer in (whole, holder.attn):
                calls.clear()
                xx = x.clone().requires_grad_()
                y = multi_head_attention(layer, xx, num_heads=8, dtype=dtype, flash_mask=mask)
                y.float().square().sum().backward()
                res.append((y.detach().float(), xx.grad.clone(), list(calls)))
            out[(str(dtype), s)] = res
        return out
    finally:
        kern.attention_k4, kern.attention_k5, kern.attention_bwd, ea.kernel_plan = saved


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn (1, 2) and (2, 2); → {world: [each rank's results]}."""
    root = str(tmp_path_factory.mktemp("tp"))
    out = {}
    for world in (2, 4):
        mp.spawn(_rank_main, args=(world, root), nprocs=world, join=True)
        out[world] = [torch.load(os.path.join(root, f"rank{world}_{r}.pt"), weights_only=False)
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def one_process():
    return {"caco": _caco_run(_cfg()), "dropout": _caco_run(_cfg(dropout=True)),
            "odd_vocab": _caco_run(_cfg(vocab=301), vocab=301)}


def _rel_l2(got, ref):
    diff = sum(float((got[k].double() - ref[k].double()).square().sum()) for k in ref)
    return (diff / sum(float(ref[k].double().square().sum()) for k in ref)) ** 0.5


def _close_to_one_process(results, ref, keys=("loss", "contrastive", "caption", "grad_norm")):
    metrics, params = ref
    for res in results[1:]:  # the ranks' gathered trees and metrics are the same
        for k, v in results[0][1].items():
            assert torch.equal(res[1][k], v), k
        assert res[0] == results[0][0]
    for got, want in zip(results[0][0], metrics):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    rel = _rel_l2(results[0][1], params)
    assert rel <= 1e-5, rel


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("world", [2, 4])
def test_shard_then_gather_is_the_identity(ranks, world):
    for key in ("layout", "layout_tp4") if world == 4 else ("layout",):
        for res in ranks[world]:
            assert res[key]["heads"] and res[key]["identity"] and res[key]["attrs_gone"], key
    shapes = ranks[world][0]["layout"]["shapes"]
    assert shapes["audio.blocks.0.attn.qkv.w"] == (32, 48)  # 3 × 16 of 32 per rank at tp 2
    assert shapes["audio.blocks.0.attn.o.w"] == (16, 32)
    assert shapes["decoder.vocab_proj.w"] == (32, 64) and shapes["decoder.blocks.0.cross.q.w"] == (32, 32)
    assert shapes["audio_pool.kv.w"] == (32, 32) and shapes["audio_pool.out.w"] == (32, 32)


def test_caco_base_layout_by_shapes():
    with torch.device("meta"):
        model = CacoModel(tcfg.caco_base())
    layout = tp_layout(model, (1, 2))
    named = dict(model.named_parameters())
    shapes = {k: tuple(local_block(named[k], *layout[k], 0, 2).shape) for k in layout}
    assert shapes["audio.blocks.0.attn.qkv.w"] == (768, 1152)
    assert shapes["audio.blocks.0.attn.o.w"] == (384, 768)
    assert shapes["audio.blocks.0.mlp.w1.w"] == (768, 1536)
    assert shapes["text.blocks.0.mlp_out.w"] == (1536, 768)
    assert shapes["decoder.blocks.0.cross.kv.w"] == (768, 768)
    assert "decoder.vocab_proj.w" not in layout  # 50 265 words: replicated, as JAX's
    assert "decoder.blocks.0.cross.q.w" not in layout and "audio_pool.out.w" not in layout
    sharded = sum(named[k].numel() for k in layout)
    assert 0.45 < sharded / sum(p.numel() for p in model.parameters()) < 0.75


def test_blocks_round_trip_in_one_process():
    x = torch.arange(2 * 24, dtype=torch.float32).reshape(2, 24)
    for groups in (1, 2, 3):
        for size in (2, 4):
            parts = [local_block(x, 1, groups, r, size) for r in range(size)]
            assert torch.equal(join_blocks(parts, 1, groups), x)
            assert torch.equal(parts[1][:, :24 // (groups * size)],
                               x[:, 24 // (groups * size):2 * 24 // (groups * size)])
    with pytest.raises(ValueError, match="does not split"):  # 96 QKV columns, 32 a group
        tp_layout(CacoModel(tcfg.caco_tiny()), (1, 3))


@pytest.mark.parametrize("world", [2, 4])
def test_caco_step_matches_one_process(ranks, one_process, world):
    _close_to_one_process([r["caco"] for r in ranks[world]], one_process["caco"])


def test_dropout_step_draws_the_one_process_masks(ranks, one_process):
    results = [r["dropout"] for r in ranks[2]]
    _close_to_one_process(results, one_process["dropout"])
    # dropout masks apply: the step differs from the step without dropout
    assert results[0][0][0]["loss"] != one_process["caco"][0][0]["loss"]


def test_odd_vocabulary_head_is_replicated(ranks, one_process):
    _close_to_one_process([r["odd_vocab"] for r in ranks[2]], one_process["odd_vocab"])


def test_heads_that_tp_does_not_divide_raise(ranks):
    for res in ranks[2]:
        assert "does not divide the 1 heads of the audio pooler" in res["indivisible"]["pool"]
        assert "does not divide the 1 heads of the encoder" in res["indivisible"]["mae"]


def test_routes_are_decided_on_the_full_width(ranks):
    for res in ranks[2]:
        for (dtype, s), (whole, shard) in res["routes"].items():
            (y1, g1, c1), (y2, g2, c2) = whole, shard
            plans = [c for c in c2 if c[0] == "plan"]
            assert plans and all(p[1] == (s, 768) for p in plans), plans
            assert [c[2] for c in c1 if c[0] == "plan"] == [p[2] for p in plans]
            kernels = [(name, heads) for name, heads in ((c[0], c[1]) for c in c2) if name != "plan"]
            if s == 500:
                want = ["k4", "k7"] if dtype == "torch.bfloat16" else ["k4"]
                assert [n for n, _ in kernels] == want, kernels
                assert all(h == 4 for _, h in kernels)  # 4 of the 8 heads
            elif dtype == "torch.bfloat16":
                assert [n for n, _ in kernels] == ["k5"] and plans[0][2] == ("blocked", 1536, 256)
            else:
                assert kernels == [] and plans[0][2] is None  # the einsum route, as at 768
            tol = 1e-5 if dtype == "torch.float32" else 2e-2
            assert float((y1 - y2).abs().max()) <= tol * float(y1.abs().max()), (dtype, s)
            assert float((g1 - g2).abs().max()) <= tol * float(g1.abs().max()), (dtype, s)


def test_mae_step_matches_one_process_and_jax(ranks, monkeypatch):
    import jax
    import jax.numpy as jnp

    from cacophony_tpu import configs as jcfg
    from cacophony_tpu import parallel as jpar
    from cacophony_tpu.train import train as jtrain
    from cacophony_tpu_torch.checkpoints.bridge import params_to_jax

    results = [r["mae"] for r in ranks[4]]
    monkeypatch.setattr(ttrain, "mae_noise", _fixed_noise)
    _close_to_one_process(results, _mae_run(), keys=("loss", "grad_norm"))
    mcfg = _mae_cfg()
    jmc = jcfg.AudioMAEConfig(encoder=jcfg.AudioEncoderConfig(**dataclasses.asdict(mcfg.encoder)),
                              decoder=jcfg.AudioDecoderConfig(**dataclasses.asdict(mcfg.decoder)),
                              mask_ratio=mcfg.mask_ratio)
    j_tc = jtrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    init = audiomae_init(mcfg.encoder, mcfg.decoder, torch.Generator().manual_seed(7))
    noise, uniform = jnp.asarray(_mae_noise().numpy()), jax.random.uniform
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **kw: (
        noise if tuple(shape) == noise.shape else uniform(key, shape, *a, **kw)))
    with pytest.warns(UserWarning, match="idle"):
        mesh = jpar.make_mesh(dp=2, tp=2)
    with mesh:
        state = jtrain.init_train_state(jpar.shard_params(jax.tree_util.tree_map(
            jnp.asarray, params_to_jax(init)), mesh), j_tc)
        batch = jpar.shard_batch({k: jnp.asarray(v) for k, v in _batch().items()
                                  if k.startswith("audio")}, mesh)
        step = jtrain.make_mae_train_step(jmc, j_tc)
        jm = []
        for i in range(STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            jm.append({k: float(v) for k, v in m.items()})
    _close_to_jax(results[0], jm, state.params, AudioMAE(mcfg.encoder, mcfg.decoder),
                  keys=("loss",))


def _close_to_jax(result, jax_metrics, jax_params, like, keys):
    import jax

    from cacophony_tpu_torch.checkpoints.bridge import params_to_jax

    for got, ref in zip(result[0], jax_metrics):
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
    like.load_state_dict(result[1])
    got, ref = params_to_jax(like), jax.tree_util.tree_map(np.asarray, jax_params)
    diff = np.concatenate([np.abs(g - r).ravel() for g, r in zip(
        jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref))])
    for q, bound in {0.5: 2e-6, 0.999: 2e-5, 1.0: 2e-4}.items():  # test_torch_train_step's fp32
        assert np.quantile(diff, q) <= bound, (q, np.quantile(diff, q))


@pytest.mark.parametrize("world", [2, 4])
def test_caco_step_matches_jax_on_a_tp_mesh(ranks, world):
    import jax
    import jax.numpy as jnp

    from cacophony_tpu import configs as jcfg
    from cacophony_tpu import parallel as jpar
    from cacophony_tpu.train import train as jtrain
    from cacophony_tpu_torch.checkpoints.bridge import params_to_jax

    jc = _no_dropout(jcfg.caco_tiny())
    j_tc = jtrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    init = caco_init(_cfg(), torch.Generator().manual_seed(0))
    with pytest.warns(UserWarning, match="idle"):
        mesh = jpar.make_mesh(*MESHES[world])
    with mesh:
        state = jtrain.init_train_state(jpar.shard_params(
            jax.tree_util.tree_map(jnp.asarray, params_to_jax(init)), mesh), j_tc)
        batch = jpar.shard_batch({k: jnp.asarray(v) for k, v in _batch().items()}, mesh)
        step = jtrain.make_caco_train_step(jc, j_tc)
        jm = []
        for i in range(STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            jm.append({k: float(v) for k, v in m.items()})
    _close_to_jax(ranks[world][0]["caco"], jm, state.params, CacoModel(_cfg()),
                  keys=("loss", "contrastive", "caption"))
