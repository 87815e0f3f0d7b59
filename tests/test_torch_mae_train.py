"""The port's stage-1 training step against the JAX package's
`make_mae_train_step`: three steps from the same parameters on the same
patch grid, at a tiny MAE (encoder and decoder 32-wide, 2 layers, 2 heads,
MLP 64; dropout rates 0, as in the published configs).

torch cannot reproduce `jax.random.uniform`, so each port step is given the
masking noise JAX's jitted step draws from its key (`mae_noise` replaced);
the rest of the step is deterministic.  The grid holds a clip shorter than
a fifth of it, so the encoder sees padded keys.  JAX kernels reached: K4
(`encoder_attention`, Pallas interpret mode) in every layer of both towers
with the Pallas backward K7 (`bwd_fits_vmem` holds at 8 and 40 patches).

Tolerances and quantile rules are those of tests/test_torch_train_step.py
(see its docstring for the reasons): fp32 losses 1e-5 and grad_norm 1e-4
relative, parameters median 2e-6, 99.9 % 2e-5, maximum 2e-4; bf16 losses
1e-2 and grad_norm 2e-2 relative, parameters median 2e-5, 99 % 5e-4,
maximum 4·lr·1.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.models.audio import audiomae_init as jax_audiomae_init
from cacophony_tpu.train import train as jtrain
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax, params_to_jax
from cacophony_tpu_torch.models.audio import audiomae_init
from cacophony_tpu_torch.ops import encoder_attention as tea
from cacophony_tpu_torch.train import losses as tlosses
from cacophony_tpu_torch.train import train as ttrain
from test_torch_mae_model import patch_grid, tiny_mae

torch.set_num_threads(2)

LR = 1e-3
STEPS = 3

TOL = {"float32": dict(loss=1e-5, norm=1e-4, quantiles={0.5: 2e-6, 0.999: 2e-5, 1.0: 2e-4}),
       "bfloat16": dict(loss=1e-2, norm=2e-2,
                        quantiles={0.5: 2e-5, 0.99: 5e-4, 1.0: 4 * LR * 1.05})}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@jax.jit
def _jax_step_noise(key):
    """The noise `make_mae_train_step`'s loss draws from the step key."""
    rng = jtrain._rewrap_rng(key, jtrain.TrainConfig().rng_impl)
    r_mask, _ = jax.random.split(rng)
    return jax.random.uniform(r_mask, (3, 40))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_mae_steps_match_jax(dtype, monkeypatch):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jc = dataclasses.replace(tiny_mae(jcfg), dtype=jd)
    tc = dataclasses.replace(tiny_mae(tcfg), dtype=td)
    for s in (8, 40):  # the visible set and the decoder's length: K4 and K7 on both sides
        assert tea.kernel_plan(s, 32, td)[0] == "one_shot" and tea.bwd_fits_vmem(s, 32, td)
    j_tc = jtrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    t_tc = ttrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)

    tree = jax.tree_util.tree_map(
        np.asarray, jax_audiomae_init(jax.random.PRNGKey(0), jc.encoder, jc.decoder))
    model = params_from_jax(tree, tc)
    batch = patch_grid(5)
    noise = [np.asarray(_jax_step_noise(jax.random.PRNGKey(i))) for i in range(STEPS)]
    drawn = iter(noise)
    monkeypatch.setattr(ttrain, "mae_noise",
                        lambda generator, mask: torch.from_numpy(next(drawn).copy()))

    jstep = jtrain.make_mae_train_step(jc, j_tc)
    jstate = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), j_tc)
    tstep = ttrain.make_mae_train_step(tc, t_tc)
    tstate = ttrain.init_train_state(model, t_tc)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = TOL[dtype]
    for i in range(STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, tbatch, torch.Generator().manual_seed(i))
        assert set(tm) == {"loss", "grad_norm"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=tol["loss"],
                                   err_msg=f"step {i} loss")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=tol["norm"], err_msg=f"step {i} grad_norm")
    assert tstate.step == STEPS
    ref, got, init = _leaves(jstate.params), _leaves(params_to_jax(tstate.params)), _leaves(tree)
    assert set(ref) == set(got)
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    for q, bound in tol["quantiles"].items():
        assert np.quantile(diff, q) <= bound, (q, np.quantile(diff, q))
    moved = np.concatenate([np.abs(ref[k] - init[k]).ravel() for k in ref])
    assert np.median(moved) > 0.5 * LR  # the steps did move the parameters


def test_mae_loss_promotes_a_bf16_reconstruction_to_fp32():
    """A bf16 prediction minus the fp32 target is fp32, as in JAX; the MSE
    counts only the positions the loss mask marks."""
    rs = np.random.RandomState(0)
    pred = torch.from_numpy(rs.randn(2, 6, 4).astype(np.float32)).to(torch.bfloat16)
    target = torch.from_numpy(rs.randn(2, 6, 4).astype(np.float32))
    lmask = torch.tensor([[0, 0, 1, 1, 0, 1], [0, 0, 1, 0, 0, 0]], dtype=torch.int32)
    loss = tlosses.mae_reconstruction_loss(pred, target, lmask)
    assert loss.dtype == torch.float32
    err = ((pred.float() - target) ** 2).mean(-1)
    assert torch.allclose(loss, (err * lmask).sum() / lmask.sum(), rtol=1e-6)


def test_mae_step_draws_masks_from_the_generator():
    """Two port steps from the same parameters and generator seed are
    identical; another seed masks other patches."""
    tc = tiny_mae(tcfg)
    t_tc = ttrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(v) for k, v in patch_grid(6).items()}
    losses = []
    for seed in (0, 0, 1):
        model = audiomae_init(tc.encoder, tc.decoder, torch.Generator().manual_seed(9))
        step = ttrain.make_mae_train_step(tc, t_tc)
        _, m = step(ttrain.init_train_state(model, t_tc), batch,
                    torch.Generator().manual_seed(seed))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] and losses[0] != losses[2]
