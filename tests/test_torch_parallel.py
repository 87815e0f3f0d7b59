"""Data parallelism in the port (`cacophony_tpu_torch.parallel`) on the CPU:
gloo process groups of spawned ranks (`torch.multiprocessing.spawn`, a
`file://` rendezvous under the test's temporary directory, one thread a
rank).  The ranks import no JAX: the JAX package's references are computed
here in the parent and the ranks' results come back through files.

- `param_specs` against JAX's leaf for leaf, caco_tiny and caco_base at
  (4, 2) and (8, 1) (the odd 50 265 vocabulary head replicated under tp 2);
- `make_mesh`: the one-rank group in one process, and its errors (more
  ranks than the world; fewer, where JAX would leave devices idle);
  `initialize_multihost` with and without a rendezvous; `shard_batch`'s
  row blocks; `shard_params` at tp 2 keeps a rank's block, and a step
  whose heads tp does not divide raises (tests/test_torch_parallel_tp.py
  holds tp against one process and JAX);
- the caco_tiny stage-2 step in fp32 at dropout 0 for dp = 2 and 4 over the
  same global batch of 8, two steps (the rate is 0 at step 0): every
  rank's parameters equal, against the port's one-process step and JAX's
  `make_caco_train_step` on `make_mesh(dp)`;
- the stage-1 step at dp = 2: the same masking and loss as one device.

Tolerances.  Against the one-process step the losses and grad_norm agree
to 1e-6 relative (the same products at other batch sizes and the gradient
summed in another order, fp32; measured ≤ 1e-7).  Parameters after the
steps: 1e-5 relative in L2 over all elements, ‖θ_dp − θ_1‖ / ‖θ_1‖
(measured 6.9e-7 at dp 2): an Adam step moves an element by about ±lr
whatever its gradient, so an element whose gradient is near Adam's eps
turns the other order's rounding into a move of up to a few 1e-6 (the
key biases, whose exact gradient is 0); every other element agrees to
fp32 rounding.  Against JAX: losses 1e-5 relative and parameters by
quantiles of |Δ|, as tests/test_torch_train_step.py holds the one-device
step.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.models.audio import audiomae_init
from cacophony_tpu_torch.models.caco import CacoModel, caco_init
from cacophony_tpu_torch.parallel import make_mesh, param_specs, shard_batch, shard_params
from cacophony_tpu_torch.parallel.multihost import initialize_multihost
from cacophony_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

LR, STEPS, B = 1e-3, 2, 8


def _no_dropout(cfg):
    text = dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0)
    dec = dataclasses.replace(cfg.decoder, hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(cfg, text=text, decoder=dec)


def _tc():
    return ttrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)


def _cfg():
    return _no_dropout(tcfg.caco_tiny())


def _mae_cfg():
    enc = tcfg.AudioEncoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                  intermediate_size=64, num_freq_patches=8)
    dec = tcfg.AudioDecoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                  intermediate_size=64, num_freq_patches=8)
    return tcfg.AudioMAEConfig(encoder=enc, decoder=dec, mask_ratio=0.75)


def _batch(s=24, t=10, seed=0):
    """A global batch of 8: mixed audio and caption lengths (each rank of
    dp 2 and 4 holds a different count of valid tokens)."""
    rs = np.random.RandomState(seed)
    lens = np.array([24, 20, 16, 9, 24, 13, 5, 24])[:B]
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None] * mask
    tlens = np.array([10, 8, 5, 10, 3, 7, 10, 6])[:B]
    tmask = (np.arange(t)[None] < tlens[:, None]).astype(np.int32)
    ids = rs.randint(4, 128, (B, t)).astype(np.int32)
    return {"audio_patches": (rs.randn(B, s, 256) * mask[..., None]).astype(np.float32),
            "audio_time_inds": inds // 8, "audio_freq_inds": inds % 8, "audio_mask": mask,
            "text_input_ids": np.where(tmask > 0, ids, 1).astype(np.int32), "text_mask": tmask}


def _steps(step, state, batch, n=STEPS):
    metrics = []
    for i in range(n):
        state, m = step(state, batch, torch.Generator().manual_seed(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


# ------------------------------------------------------------ spawned ranks

def _rank_main(rank, world, root):
    """Runs in each spawned rank: join the group through the file
    rendezvous, run the checks and steps, write what they gave."""
    torch.set_num_threads(1)
    out = {"info": initialize_multihost(f"file://{root}/rendezvous_{world}", world, rank,
                                        device="cpu")}
    try:
        mesh = make_mesh(dp=world, device="cpu")
        out["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names)
        tc = _tc()
        batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(root, "batch.npz")).items()}
        if world == 2:
            _mesh_checks(mesh, out)
        cfg = _cfg()
        model = caco_init(cfg, torch.Generator().manual_seed(100 + rank))  # differs by rank
        if rank == 0:
            model.load_state_dict(torch.load(os.path.join(root, "caco_init.pt")))
        shard_params(model, mesh)
        _, out["caco_metrics"] = _steps(ttrain.make_caco_train_step(cfg, tc, mesh),
                                        ttrain.init_train_state(model, tc), shard_batch(batch, mesh))
        out["caco_params"] = model.state_dict()
        if world == 2:
            mcfg = _mae_cfg()
            mae = audiomae_init(mcfg.encoder, mcfg.decoder, torch.Generator().manual_seed(7))
            mbatch = shard_batch({k: v for k, v in batch.items() if k.startswith("audio")}, mesh)
            out["mae_noise"] = ttrain.mae_noise(torch.Generator().manual_seed(3),
                                                mbatch["audio_mask"], mesh)
            _, out["mae_metrics"] = _steps(ttrain.make_mae_train_step(mcfg, tc, mesh),
                                           ttrain.init_train_state(mae, tc), mbatch)
            out["mae_params"] = mae.state_dict()
    finally:
        torch.save(out, os.path.join(root, f"rank{world}_{rank}.pt"))
        dist.destroy_process_group()


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type and message are checked in the parent
        return type(e).__name__, str(e)
    return None


def _mesh_checks(mesh, out):
    out["more_than_world"] = _error(lambda: make_mesh(dp=4, device="cpu"))
    out["idle_ranks"] = _error(lambda: make_mesh(dp=1, device="cpu"))
    tp_mesh = make_mesh(dp=1, tp=2, device="cpu")
    sharded = shard_params(caco_init(tcfg.caco_tiny(), torch.Generator()), tp_mesh)
    out["tp_shard"] = tuple(sharded.audio.blocks[0].attn.qkv.w.shape)
    out["tp_step"] = _error(lambda: ttrain.make_caco_train_step(
        dataclasses.replace(tcfg.caco_tiny(), num_attention_pool_heads=1), _tc(), tp_mesh))
    rows = shard_batch({"t": torch.arange(8)[:, None], "n": [np.arange(8), np.arange(16)]}, mesh)
    out["rows"] = (rows["t"][:, 0].tolist(), rows["n"][0].tolist(), rows["n"][1].tolist())
    out["indivisible"] = _error(lambda: shard_batch({"x": torch.zeros(3)}, mesh))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn dp = 2 and dp = 4; → (root, {world: [each rank's results]},
    the one-process step's (metrics, parameters), the initial tree)."""
    root = str(tmp_path_factory.mktemp("dp"))
    cfg = _cfg()
    model = caco_init(cfg, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), os.path.join(root, "caco_init.pt"))
    np.savez(os.path.join(root, "batch.npz"), **_batch())
    out = {}
    for world in (2, 4):
        mp.spawn(_rank_main, args=(world, root), nprocs=world, join=True)
        out[world] = [torch.load(os.path.join(root, f"rank{world}_{r}.pt"), weights_only=False)
                      for r in range(world)]
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    init = {k: v.clone() for k, v in model.state_dict().items()}
    _, metrics = _steps(ttrain.make_caco_train_step(cfg, _tc()),
                        ttrain.init_train_state(model, _tc()), batch)
    return root, out, (metrics, model.state_dict()), init


def test_ranks_joined_the_group(ranks):
    _, out, _, _ = ranks
    for world, results in out.items():
        for r, res in enumerate(results):
            assert res["info"] == {"process_index": r, "process_count": world,
                                   "local_devices": 1, "global_devices": world}
            assert res["mesh"] == ((world, 1), ("dp", "tp"))


def test_mesh_errors_and_row_blocks(ranks):
    res = ranks[1][2]
    for r, got in enumerate(res):
        assert got["more_than_world"][0] == "ValueError" and "needs 4 ranks" in got["more_than_world"][1]
        assert got["idle_ranks"][0] == "ValueError" and "uses 1 of 2" in got["idle_ranks"][1]
        assert got["tp_shard"] == (32, 48)  # 3 × 16 QKV columns of 32: one head of two a rank
        assert got["tp_step"][0] == "ValueError" and "does not divide the 1 heads" in got["tp_step"][1]
        assert got["rows"] == (list(range(4 * r, 4 * r + 4)), list(range(4 * r, 4 * r + 4)),
                               list(range(8 * r, 8 * r + 8)))
        assert got["indivisible"][0] == "ValueError"


def _rel_l2(got, ref):
    """‖got − ref‖ / ‖ref‖ over every parameter element."""
    diff = sum(float((got[k].double() - ref[k].double()).square().sum()) for k in ref)
    return (diff / sum(float(ref[k].double().square().sum()) for k in ref)) ** 0.5


def _median_move(params, init):
    return float(torch.cat([(params[k] - init[k]).abs().flatten() for k in init]).median())


@pytest.mark.parametrize("world", [2, 4])
def test_caco_step_matches_one_process(ranks, world):
    _, out, (ref_metrics, ref_params), init = ranks
    results = out[world]
    for res in results[1:]:  # every replica holds rank 0's parameters
        for k, v in results[0]["caco_params"].items():
            assert torch.equal(res["caco_params"][k], v), k
        assert res["caco_metrics"] == results[0]["caco_metrics"]
    for got, ref in zip(results[0]["caco_metrics"], ref_metrics):
        for k in ("loss", "contrastive", "caption", "grad_norm"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert _median_move(ref_params, init) > 0.5 * LR  # the steps moved the parameters
    rel = _rel_l2(results[0]["caco_params"], ref_params)
    assert rel <= 1e-5, rel


def test_mae_step_matches_one_device(ranks):
    _, out, _, _ = ranks
    results = out[2]
    mcfg, tc = _mae_cfg(), _tc()
    batch = {k: torch.from_numpy(v) for k, v in _batch().items() if k.startswith("audio")}
    noise = ttrain.mae_noise(torch.Generator().manual_seed(3), batch["audio_mask"])
    assert torch.equal(torch.cat([r["mae_noise"] for r in results]), noise)
    mae = audiomae_init(mcfg.encoder, mcfg.decoder, torch.Generator().manual_seed(7))
    init = {k: v.clone() for k, v in mae.state_dict().items()}
    _, ref_metrics = _steps(ttrain.make_mae_train_step(mcfg, tc),
                            ttrain.init_train_state(mae, tc), batch)
    for res in results:
        for got, ref in zip(res["mae_metrics"], ref_metrics):
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
            np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-6)
    assert _median_move(mae.state_dict(), init) > 0.5 * LR
    rel = _rel_l2(results[0]["mae_params"], mae.state_dict())
    assert rel <= 1e-5, rel
    for k, v in results[0]["mae_params"].items():
        assert torch.equal(results[1]["mae_params"][k], v), k


@pytest.mark.parametrize("world", [2, 4])
def test_caco_step_matches_jax_on_a_dp_mesh(ranks, world):
    import jax
    import jax.numpy as jnp

    from cacophony_tpu import configs as jcfg
    from cacophony_tpu import parallel as jpar
    from cacophony_tpu.train import train as jtrain
    from cacophony_tpu_torch.checkpoints.bridge import params_to_jax

    _, out, _, init = ranks
    jc = _no_dropout(jcfg.caco_tiny())
    j_tc = jtrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    init_model = CacoModel(_cfg())
    init_model.load_state_dict(init)
    tree = params_to_jax(init_model)
    with pytest.warns(UserWarning, match="idle"):
        mesh = jpar.make_mesh(dp=world)
    with mesh:
        state = jtrain.init_train_state(jpar.shard_params(
            jax.tree_util.tree_map(jnp.asarray, tree), mesh), j_tc)
        batch = jpar.shard_batch({k: jnp.asarray(v) for k, v in _batch().items()}, mesh)
        step = jtrain.make_caco_train_step(jc, j_tc)
        jm = []
        for i in range(STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            jm.append({k: float(v) for k, v in m.items()})
    for got, ref in zip(out[world][0]["caco_metrics"], jm):
        for k in ("loss", "contrastive", "caption"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
    got_model = CacoModel(_cfg())
    got_model.load_state_dict(out[world][0]["caco_params"])
    got, ref = params_to_jax(got_model), jax.tree_util.tree_map(np.asarray, state.params)
    diff = np.concatenate([np.abs(g - r).ravel() for g, r in zip(
        jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref))])
    for q, bound in {0.5: 2e-6, 0.999: 2e-5, 1.0: 2e-4}.items():  # test_torch_train_step's fp32
        assert np.quantile(diff, q) <= bound, (q, np.quantile(diff, q))


@pytest.mark.parametrize("model", ["caco_tiny", "caco_base"])
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_param_specs_match_jax(model, shape):
    import jax

    from cacophony_tpu import configs as jcfg
    from cacophony_tpu.models.caco import caco_init as jax_caco_init
    from cacophony_tpu.parallel import make_mesh as jax_make_mesh
    from cacophony_tpu.parallel import param_specs as jax_param_specs
    from cacophony_tpu_torch.checkpoints.bridge import _jax_name

    shapes = jax.eval_shape(lambda k: jax_caco_init(k, getattr(jcfg, model)()),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    specs = jax_param_specs(tree, jax_make_mesh(dp=shape[0], tp=shape[1]))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    with torch.device("meta"):
        port = CacoModel(getattr(tcfg, model)())
    ours = param_specs(port, {"dp": shape[0], "tp": shape[1]})
    assert ours == param_specs(port, shape)
    assert len(ours) == sum(1 for _ in port.parameters())
    for name, dim in ours.items():
        spec = flat[_jax_name(name).replace(".", "/")]
        stacked = ".blocks." in f".{name}."
        spec = spec[1:] if stacked and len(spec) else spec  # JAX's stacked layer axis
        want = spec.index("tp") if "tp" in spec else None
        assert dim == want, (name, dim, spec)
    if model == "caco_base" and shape[1] == 2:
        assert ours["decoder.vocab_proj.w"] is None and ours["decoder.vocab_proj.b"] is None
        assert ours["text.blocks.0.attn.qkv.w"] == 1 and ours["text.blocks.0.attn.o.w"] == 0
    if model == "caco_base" and shape[1] == 1:  # tp 1 divides everything: the rules stand
        assert ours["decoder.vocab_proj.w"] == 1


def test_one_rank_group_and_multihost_without_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert initialize_multihost(device="cpu") == {"process_index": 0, "process_count": 1,
                                                   "local_devices": 1, "global_devices": 1}
    with pytest.raises(ValueError, match="2 processes expected"):
        initialize_multihost(num_processes=2, device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(dp=1, device="cpu")  # a one-rank group over a HashStore
        assert dist.get_world_size() == 1 and mesh["dp"].size() == 1 and mesh.size() == 1
        assert make_mesh(device="cpu").shape == (1, 1)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(dp=2, device="cpu")
        assert initialize_multihost(device="cpu")["process_count"] == 1  # already initialized
        x = {"a": torch.arange(6)}
        assert torch.equal(shard_batch(x, mesh)["a"], x["a"])
    finally:
        dist.destroy_process_group()
