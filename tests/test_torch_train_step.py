"""The port's stage-2 training step against the JAX package's
`make_caco_train_step`, three steps from the same parameters on the same
batch, at caco_tiny with every dropout rate 0 (the two frameworks draw
different random numbers, so only the deterministic step compares).

JAX kernels reached: at 100 patches the audio attention takes K4
(`encoder_attention`, Pallas interpret mode) with the Pallas backward K7
(`bwd_fits_vmem` holds); at 1400 patches in fp32 the blocked plan pads to
1536 and takes K5 (`encoder_attention_blocked`) with its XLA backward.
The text towers run the einsum path in both (`TEXT_ATTN_KERNEL = False`).

Tolerances, each with its reason.  The schedule's rate is 0 at step 0, so
two steps of lr = 1e-3 move the parameters; an Adam step moves an element
by lr·m/(√v + eps), about ±lr whatever the gradient's size, so an element
whose gradient is rounding noise moves by up to ±lr in either framework.
The key biases are such elements: their exact gradient is 0 (a softmax is
invariant to a shift of a row's logits).  So the parameters are held by
quantiles of |port − JAX| over all elements, and the maximum by the bound
of two Adam steps.
- fp32: losses 1e-5 relative and grad_norm 1e-4 relative (fp32 sums in
  another order; measured ≤ 2e-5 for grad_norm).  Parameters: median
  2e-6, 99.9 % 2e-5 (measured 1e-6, 8e-6: gradients agree to ~1e-6 of each
  leaf's largest), maximum 2e-4 (a key bias, measured 1e-4).
- bf16: losses 1e-2 relative and grad_norm 2e-2 relative (measured 2e-3
  and 4e-3): the towers round every product and elementwise chain to bf16
  at other places than XLA (gelu, silu, the softmax's cast), a few bf16
  steps (2^-8 each) per layer.  Parameters: median 2e-5, 99 % 5e-4
  (measured 4e-6, 1.2e-4); maximum 4·lr·1.05: two Adam steps of
  opposite signs (measured 3.8e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu.train import train as jtrain
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax, params_to_jax
from cacophony_tpu_torch.ops import encoder_attention as tea
from cacophony_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

LR = 1e-3
STEPS = 3


def _no_dropout(cfg):
    text = dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0)
    dec = dataclasses.replace(cfg.decoder, hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(cfg, text=text, decoder=dec)


def _batch(s, b=3, t=12, seed=0):
    rs = np.random.RandomState(seed)
    lens = [s, s * 2 // 3, s // 5][:b]
    mask = (np.arange(s)[None] < np.array(lens)[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None] * mask
    tlens = [t, 8, 5][:b]
    ids = rs.randint(4, 128, (b, t)).astype(np.int32)
    tmask = (np.arange(t)[None] < np.array(tlens)[:, None]).astype(np.int32)
    return {"audio_patches": (rs.randn(b, s, 256) * mask[..., None]).astype(np.float32),
            "audio_time_inds": inds // 8, "audio_freq_inds": inds % 8, "audio_mask": mask,
            "text_input_ids": np.where(tmask > 0, ids, 1).astype(np.int32), "text_mask": tmask}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


TOL = {"float32": dict(loss=1e-5, norm=1e-4, quantiles={0.5: 2e-6, 0.999: 2e-5, 1.0: 2e-4}),
       "bfloat16": dict(loss=1e-2, norm=2e-2,
                        quantiles={0.5: 2e-5, 0.99: 5e-4, 1.0: 4 * LR * 1.05})}


@pytest.mark.parametrize("dtype,patches,route", [("float32", 100, "one_shot"),
                                                  ("bfloat16", 100, "one_shot"),
                                                  ("float32", 1400, "blocked")])
def test_three_steps_match_jax(dtype, patches, route):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jc = _no_dropout(dataclasses.replace(jcfg.caco_tiny(), dtype=jd))
    tc = _no_dropout(dataclasses.replace(tcfg.caco_tiny(), dtype=td))
    plan = tea.kernel_plan(patches, tc.audio.hidden_size, td)
    assert plan[0] == route
    if route == "one_shot":
        assert tea.bwd_fits_vmem(patches, tc.audio.hidden_size, td)  # K7 on both sides
    j_tc = jtrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    t_tc = ttrain.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)

    tree = jax.tree_util.tree_map(np.asarray, jax_caco_init(jax.random.PRNGKey(0), jc))
    model = params_from_jax(tree, tc)
    batch = _batch(patches)

    jstep = jtrain.make_caco_train_step(jc, j_tc)
    jstate = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), j_tc)
    tstep = ttrain.make_caco_train_step(tc, t_tc)
    tstate = ttrain.init_train_state(model, t_tc)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = TOL[dtype]
    for i in range(STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, tbatch, torch.Generator().manual_seed(i))
        for k in ("loss", "contrastive", "caption"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol["loss"],
                                       err_msg=f"step {i} {k}")
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
