"""Training on the card at published width (random weights from the seed):
the stage-2 step at caco_base in bf16 and fp32 at 10 s and in bf16 at
30 s, with their launch counts, fp32 against the same step on the CPU,
`remat_encoder`; stage 1 at audiomae_base: the reconstruction forward's
routes, its kernels on the first layers' real inputs, the step in both
dtypes, fp32 against the CPU.  Marked `cuda`; the bounds are
tests/torch_card.py's."""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.models.audio import (
    LN_EPS,
    audio_decoder_input,
    audio_encoder_apply,
    audio_input_embedding,
    audiomae_apply,
    audiomae_init,
)
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.models.layers import dense, layer_norm
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.train import train
from torch_card import (COS, MAE_ARGS, NO_SERVING, SEED, STEP_TOL, audio_batch, check_close, cuda,  # noqa: F401
                        drive, mae_input, no_text_dropout, tol, train_batch)

pytestmark = pytest.mark.cuda

LAYERS, H = 12, 8
TC = train.TrainConfig(warmup_steps=1, total_steps=100)


def grads_of(net):
    return torch.cat([p.grad.flatten().double().cpu() for p in net.parameters()])


def card_against_cpu(make, loss_fn, batch):
    """One loss and backward of the model make() on the card and on the CPU
    from the same parameters → (relative loss gap, relative L2 gradient gap)."""
    out = []
    for device in ("cuda", "cpu"):
        net = make().to(device)
        loss, _ = loss_fn(net, {k: v.to(device) for k, v in batch.items()}, None)
        loss.backward()
        out.append((float(loss.detach()), grads_of(net)))
        del net
    (l_card, g_card), (l_cpu, g_cpu) = out
    return abs(l_card - l_cpu) / abs(l_cpu), float((g_card - g_cpu).norm() / g_cpu.norm())


def test_bf16_10s_step(cuda):
    """B=16, 500 patches from `device_train_frontend`, 100 tokens, 5 steps
    on one batch: K4 and K7 once a layer a step, `table_grad` once a step,
    no K5 and none of the serving kernels; finite losses and norms, the
    loss falls from step 1 to step 4."""
    cfg = dataclasses.replace(configs.caco_base(), dtype=torch.bfloat16)
    state = train.init_train_state(caco_init(cfg, torch.Generator().manual_seed(SEED)).cuda(), TC)
    step = train.make_caco_train_step(cfg, TC)
    batch = train_batch(cfg, np.random.RandomState(SEED), 16, 10, 500)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    metrics = []

    def steps():
        nonlocal state
        for _ in range(5):
            state, m = step(state, batch, gen)
            metrics.append({k: float(v) for k, v in m.items()})

    drive(steps, {"k4": 5 * LAYERS, "k7": 5 * LAYERS, "k5": 0, "table_grad": 5, **NO_SERVING})
    losses = [m["loss"] for m in metrics]
    assert np.isfinite(losses + [m["grad_norm"] for m in metrics]).all()
    assert losses[4] < losses[1], losses


def test_fp32_10s_step_matches_the_cpu(cuda):
    """fp32, text dropout off: K4 once a layer and no K7 (500 patches fail
    fp32's `bwd_fits_vmem`); loss and gradients at B=2 against the same
    step on the CPU through the plain versions."""
    cfg = no_text_dropout(dataclasses.replace(configs.caco_base(), dtype=torch.float32))
    make = lambda: caco_init(cfg, torch.Generator().manual_seed(SEED))  # noqa: E731
    batch = train_batch(cfg, np.random.RandomState(SEED), 16, 10, 500)
    state = train.init_train_state(make().cuda(), TC)
    (_, m), _ = drive(lambda: train.make_caco_train_step(cfg, TC)(state, batch, None),
                      {"k4": LAYERS, "k7": 0, "k5": 0, **NO_SERVING})
    assert np.isfinite([float(m["loss"]), float(m["grad_norm"])]).all()
    del state
    l_err, g_err = card_against_cpu(make, train.make_caco_loss(cfg, TC),
                                    {k: v[:2] for k, v in batch.items()})
    assert l_err <= STEP_TOL["loss"] and g_err <= STEP_TOL["grads"], (l_err, g_err)


def test_bf16_30s_step_runs_k5(cuda):
    """B=4, 1500 patches on the blocked plan (1536): K5 once a layer, no K4
    or K7."""
    cfg = dataclasses.replace(configs.caco_base(), dtype=torch.bfloat16)
    assert ea.kernel_plan(1500, 768, torch.bfloat16) == ("blocked", 1536, 256)
    state = train.init_train_state(caco_init(cfg, torch.Generator().manual_seed(SEED)).cuda(), TC)
    batch = train_batch(cfg, np.random.RandomState(SEED), 4, 30, 1500)
    (_, m), _ = drive(lambda: train.make_caco_train_step(cfg, TC)(
        state, batch, torch.Generator(device="cuda").manual_seed(SEED)),
        {"k5": LAYERS, "k4": 0, "k7": 0, **NO_SERVING})
    assert np.isfinite([float(m["loss"]), float(m["grad_norm"])]).all()


def test_remat_encoder_keeps_the_loss_and_gradients(cuda):
    """One bf16 10-s loss and backward (B=16) with `remat_encoder` on and
    off, from the same parameters and generator state: K4 twice a layer
    with it and once without, K7 once; equal losses, gradients within the
    bf16 chain bound."""
    cfg = dataclasses.replace(configs.caco_base(), dtype=torch.bfloat16)
    model = caco_init(cfg, torch.Generator().manual_seed(SEED)).cuda()
    batch = train_batch(cfg, np.random.RandomState(SEED), 16, 10, 500)
    out = {}
    for remat in (True, False):
        loss_fn = train.make_caco_loss(cfg, train.TrainConfig(remat_encoder=remat))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model.zero_grad(set_to_none=True)

        def step():
            loss, _ = loss_fn(model, batch, gen)
            loss.backward()
            return float(loss.detach())

        loss, _ = drive(step, {"k4": LAYERS * (2 if remat else 1), "k7": LAYERS, "k5": 0,
                               **NO_SERVING})
        out[remat] = (loss, [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                             for p in model.parameters()])
    (l_r, g_r), (l_p, g_p) = out[True], out[False]
    atol, rtol = tol(torch.bfloat16, "chain")
    assert l_r == l_p
    assert max(float(((a - b).abs() - rtol * b.abs()).max()) for a, b in zip(g_r, g_p)) <= atol


# ---- stage 1 at audiomae_base ----------------------------------------------

@pytest.fixture(scope="module")
def mae(cuda):
    """audiomae_base from the seed (a CPU copy and a card copy) and its
    input at the reconstruction benchmark's shape, B=64 (`mae_input`)."""
    cfg = configs.audiomae_base()
    cpu_model = audiomae_init(cfg.encoder, cfg.decoder, torch.Generator().manual_seed(SEED))
    return cfg, cpu_model, copy.deepcopy(cpu_model).cuda(), mae_input(64, cfg.mask_ratio)


def recon(cfg, net, m, dtype, rows=slice(None)):
    with torch.inference_mode():
        return audiomae_apply(net, cfg.encoder, cfg.decoder,
                              *(m[k][rows].to(next(net.parameters()).device) for k in MAE_ARGS),
                              dtype=dtype)


def row_cosine(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(0, -2), b.float().flatten(0, -2).to(a.device), dim=-1).min())


def test_mae_reconstruction_routes_and_agreement(mae):
    """The encoder at 100 visible patches and the decoder at 500 take
    `layer_route`'s routes: bf16 K1 on all 24 layers, fp32 K1 on the
    encoder's 12 and K2 on the decoder's 12; finite (64, 500, 256) rows;
    fp32 on the card against the CPU's plain path on a full and the short
    clip, bf16 against fp32 (least cosine over patch rows)."""
    cfg, cpu_model, model, m = mae
    enc, dec = cfg.encoder, cfg.decoder
    assert (m["patches"].shape[1], m["target_patches"].shape[1]) == (100, 500)
    assert 0 < int(m["mask"][-1].sum()) < 100
    routes = {dt: (ea.layer_route(100, enc.hidden_size, enc.intermediate_size, dt)[0],
                   ea.layer_route(500, dec.hidden_size, dec.intermediate_size, dt)[0])
              for dt in (torch.bfloat16, torch.float32)}
    assert routes == {torch.bfloat16: ("k1", "k1"), torch.float32: ("k1", "k2")}
    none = {"k4": 0, "k5": 0, "k7": 0, "k3_block": 0, "k3_layer": 0, "k6_attn": 0}
    chain = dict.fromkeys(("layer_norm", "gemm", "attention"))
    out16, _ = drive(lambda: recon(cfg, model, m, torch.bfloat16),
                     {"k1_layer": 24, "k2_block": 0, **none, **chain})
    out32, _ = drive(lambda: recon(cfg, model, m, torch.float32),
                     {"k1_layer": 12, "k2_block": 12, **none, **chain})
    for out in (out16, out32):
        assert out.shape == (64, 500, 256) and torch.isfinite(out).all()
    pick = [0, 63]
    cpu = recon(cfg, cpu_model, m, torch.float32, rows=pick)
    assert row_cosine(out32[pick].cpu(), cpu) >= COS["fp32"]
    assert row_cosine(out16, out32) >= COS["bf16"]


@torch.inference_mode()
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mae_kernels_on_the_first_layers_inputs(mae, dtype):
    """On the real inputs of each tower's first layer: K1 at the encoder's
    100 patches and (bf16) at the decoder's 500, K2 at the decoder's 500
    (fp32); K4 at the training batch's 16 clips in both towers, and K7
    where `bwd_fits_vmem` holds (fp32: the encoder only)."""
    cfg, _, model, m = mae
    enc, dec = cfg.encoder, cfg.decoder
    gen = torch.Generator().manual_seed(SEED + 15)
    x = audio_input_embedding(model.encoder, enc, m["patches"], m["time_inds"], m["freq_inds"],
                              dtype)
    blk = model.encoder.blocks[0]
    check_close(ea.fused_layer(blk, x, m["mask"], enc.num_heads, LN_EPS),
                ea.fused_layer_plain(blk, x, m["mask"], enc.num_heads, LN_EPS), tol(dtype, "chain"))
    h = audio_encoder_apply(model.encoder, enc, m["patches"], m["time_inds"], m["freq_inds"],
                            m["mask"], dtype=dtype)
    xd, full = audio_decoder_input(model.decoder, h, *(m[k] for k in MAE_ARGS[1:]), dtype)
    dblk = model.decoder.blocks[0]
    if dtype == torch.bfloat16:
        check_close(ea.fused_layer(dblk, xd, full, dec.num_heads, LN_EPS),
                    ea.fused_layer_plain(dblk, xd, full, dec.num_heads, LN_EPS), tol(dtype, "chain"))
    else:
        got = ea.fused_block_attention(dblk, xd, full, dec.num_heads, LN_EPS, ("one_shot",))
        ref = ea.fused_block_attention_plain(dblk, xd, full, dec.num_heads, LN_EPS, ("one_shot",))
        for a, b in zip(got, ref):
            check_close(a, b, tol(dtype, "chain"))
    for layer, xs, mask in ((blk, x, m["mask"]), (dblk, xd, full)):
        xs, mask = xs[:16], mask[:16].contiguous()
        s = xs.shape[1]
        qkv = dense(layer.attn.qkv, layer_norm(layer.ln1, xs, LN_EPS), dtype).contiguous()
        check_close(kern.attention_k4(qkv, mask, H), kern.attention_plain(qkv, mask, H),
                    tol(dtype, "kernel"))
        if ea.bwd_fits_vmem(s, 768, dtype):
            g = torch.randn(16, s, 768, generator=gen).to("cuda", dtype)
            check_close(kern.attention_bwd(qkv, mask, g, H), kern.attention_bwd_plain(qkv, mask, g, H),
                        tol(dtype, "k7"))
    assert not ea.bwd_fits_vmem(500, 768, torch.float32)


@contextlib.contextmanager
def fixed_mae_noise(noise):
    """The stage-1 loss masks by `noise` (moved to the batch's device)."""
    draw = train.mae_noise
    train.mae_noise = lambda generator, mask: noise.to(mask.device)
    try:
        yield
    finally:
        train.mae_noise = draw


@pytest.mark.parametrize("dtype,k7,steps", [(torch.bfloat16, 24, 4), (torch.float32, 12, 1)])
def test_mae_train_step(cuda, dtype, k7, steps):
    """The stage-1 step at audiomae_base, B=16, 500 patches, a generator
    seeded alike each step (one masking): K4 on all 24 layers, K7 on all of
    them in bf16 and on the encoder's 12 in fp32 (the decoder's 500 patches
    fail fp32's `bwd_fits_vmem`), `table_grad` 3 times a step (the
    encoder's gather, and the decoder's for the visible and the restore
    set); finite; the bf16 loss falls over 4 steps."""
    cfg = dataclasses.replace(configs.audiomae_base(), dtype=dtype)
    state = train.init_train_state(
        audiomae_init(cfg.encoder, cfg.decoder, torch.Generator().manual_seed(SEED)).cuda(), TC)
    step = train.make_mae_train_step(cfg, TC)
    batch = audio_batch(np.random.RandomState(SEED), 16, 10, 500)
    metrics = []

    def run_steps():
        nonlocal state
        for _ in range(steps):
            state, mt = step(state, batch, torch.Generator(device="cuda").manual_seed(SEED))
            metrics.append({k: float(v) for k, v in mt.items()})

    drive(run_steps, {"k4": 24 * steps, "k7": k7 * steps, "table_grad": 3 * steps, "k5": 0,
                      **NO_SERVING})
    losses = [mt["loss"] for mt in metrics]
    assert np.isfinite(losses + [mt["grad_norm"] for mt in metrics]).all()
    if steps > 1:
        assert losses[-1] < losses[1], losses


def test_mae_fp32_step_matches_the_cpu(cuda):
    """The fp32 stage-1 loss and gradients at B=2 under one masking noise,
    card against the CPU's plain versions."""
    cfg = dataclasses.replace(configs.audiomae_base(), dtype=torch.float32)
    batch = {k: v[:2] for k, v in audio_batch(np.random.RandomState(SEED), 16, 10, 500).items()}
    noise = train.mae_noise(torch.Generator().manual_seed(SEED), batch["audio_mask"].cpu())
    with fixed_mae_noise(noise):
        l_err, g_err = card_against_cpu(
            lambda: audiomae_init(cfg.encoder, cfg.decoder, torch.Generator().manual_seed(SEED)),
            train.make_mae_loss(cfg, TC), batch)
    assert l_err <= STEP_TOL["loss"] and g_err <= STEP_TOL["grads"], (l_err, g_err)
