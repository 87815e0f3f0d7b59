"""The port's stage-1 AudioMAE against the JAX package: the reconstruction
decoder, the whole reconstruction forward and the patch masking, same
weights (bridged from a JAX `audiomae_init`) and same numpy inputs, at a
tiny MAE (encoder and decoder 32-wide, 2 layers, 2 heads, MLP 64).

JAX kernels reached: every encoder and decoder layer takes K1
(`try_fused_layer`, Pallas interpret mode) at inference, on the decoder's
concatenated length.  The batches hold a clip shorter than a fifth of the
grid, so padding lies inside the visible set and the encoder sees masked
keys.

Tolerances: fp32 1e-5 relative to the output's largest value (fp32 sums in
another order through four layers).  bf16: the bound of the encoder's bf16
hidden states in tests/test_torch_models.py, 3e-2 absolute plus 2^-6
relative (XLA and PyTorch round bf16 elementwise chains such as silu and
the embedding sums at other places, a bf16 step where they differ), and
the relative L2 distance within 1e-2: measured 4.9e-3 between the
packages, where each package's bf16 lies 9.3e-3 from its fp32 (so the two
share most of their roundings).  The masking is a pure function of the
noise, so indices and gathers are held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.models import audio as jaudio
from cacophony_tpu.train import train as jtrain
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import decay_mask, params_from_jax, params_to_jax
from cacophony_tpu_torch.models import audio as taudio
from cacophony_tpu_torch.models.audio import AudioMAE
from cacophony_tpu_torch.ops import encoder_attention as tea
from cacophony_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (atol as a share of max |ref|, atol, rtol, relative L2)
TOL = {"float32": (1e-5, 0.0, 0.0, 1e-5), "bfloat16": (0.0, 3e-2, 2.0 ** -6, 1e-2)}
GRID, LENGTHS = 40, [40, 23, 5]  # 5 valid patches < n_keep = 8: padding in the visible set


def tiny_mae(module):
    """The runner's --tiny-model MAE in either package's config module."""
    enc = module.AudioEncoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                    intermediate_size=64)
    dec = module.AudioDecoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                    intermediate_size=64)
    return module.AudioMAEConfig(encoder=enc, decoder=dec)


@pytest.fixture(scope="module")
def mae():
    jc, tc = tiny_mae(jcfg), tiny_mae(tcfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jaudio.audiomae_init(jax.random.PRNGKey(0), jc.encoder, jc.decoder))
    return jc, tc, tree, params_from_jax(tree, tc)


def patch_grid(seed, s=GRID, lengths=LENGTHS):
    rs = np.random.RandomState(seed)
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    inds = np.arange(s, dtype=np.int32)[None, :] * mask
    return {"audio_patches": (rs.randn(len(lengths), s, 256) * mask[..., None]).astype(np.float32),
            "audio_time_inds": inds // 8, "audio_freq_inds": inds % 8, "audio_mask": mask}


def jax_masking(batch, ratio=0.8, key=0):
    out = jtrain.mae_random_masking(jax.random.PRNGKey(key),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, ratio)
    return {k: np.asarray(v) for k, v in out.items()}


_APPLY_ARGS = ("patches", "mask", "time_inds", "freq_inds", "restore_time_inds",
               "restore_freq_inds", "restore_mask")


def _close(got, ref, dtype):
    ref = np.asarray(ref).astype(np.float32)
    got = got.detach().float().numpy()
    share, atol, rtol, rel_l2 = TOL[dtype]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=share * np.abs(ref).max() + atol, rtol=rtol)
    assert np.linalg.norm(got - ref) <= rel_l2 * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audiomae_apply_matches_jax(mae, dtype):
    jc, tc, tree, model = mae
    jd, td = DTYPES[dtype]
    m = jax_masking(patch_grid(0))
    assert m["mask"][2].sum() == 5 and m["mask"].shape[1] == 8  # padding is visible
    ref = jaudio.audiomae_apply(tree, jc.encoder, jc.decoder,
                                *(jnp.asarray(m[k]) for k in _APPLY_ARGS), dtype=jd)
    with torch.no_grad():
        got = taudio.audiomae_apply(model, tc.encoder, tc.decoder,
                                    *(torch.from_numpy(m[k].copy()) for k in _APPLY_ARGS), dtype=td)
    assert got.dtype == td and got.shape == (3, GRID, 256)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_decoder_matches_jax(mae, dtype):
    """The decoder alone on given encoder states (not the encoder's output)."""
    jc, tc, tree, model = mae
    jd, td = DTYPES[dtype]
    m = jax_masking(patch_grid(1), key=1)
    hidden = np.random.RandomState(2).randn(3, m["mask"].shape[1], 32).astype(np.float32)
    args = [m[k] for k in _APPLY_ARGS[1:]]
    ref = jaudio.audio_decoder_apply(tree["decoder"], jc.decoder, jnp.asarray(hidden, jd),
                                     *map(jnp.asarray, args), dtype=jd)
    with torch.no_grad():
        got = taudio.audio_decoder_apply(model.decoder, tc.decoder,
                                         torch.from_numpy(hidden).to(td),
                                         *(torch.from_numpy(a.copy()) for a in args), dtype=td)
    _close(got, ref, dtype)


def test_decoder_route_is_decided_on_the_concatenated_length(mae, monkeypatch):
    """The decoder's layers take the route of S_vis + S_masked (JAX runs the
    fused routes under the combined mask), the encoder's that of S_vis."""
    _, tc, _, model = mae
    seen = []
    route = tea.layer_route
    monkeypatch.setattr(tea, "layer_route", lambda s, *a: seen.append(s) or route(s, *a))
    m = jax_masking(patch_grid(0))
    with torch.no_grad():
        taudio.audiomae_apply(model, tc.encoder, tc.decoder,
                              *(torch.from_numpy(m[k].copy()) for k in _APPLY_ARGS))
    assert seen == [8, GRID]


@pytest.mark.parametrize("s,lengths,ratio", [(GRID, LENGTHS, 0.8),
                                             (37, [37, 30, 3], 0.8),
                                             (13, [13, 1, 0], 0.75),
                                             (500, [500, 496, 60], 0.8)])
def test_mae_random_masking_matches_jax(s, lengths, ratio):
    """From JAX's own noise, the port's masking gives the same indices and
    gathers bit for bit, padding pushed to the masked end."""
    batch = patch_grid(3, s, lengths)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.uniform(key, (len(lengths), s)))
    ref = jax_masking(batch, ratio, key=7)
    got = ttrain.mae_random_masking(torch.from_numpy(noise.copy()),
                                    {k: torch.from_numpy(v) for k, v in batch.items()}, ratio)
    assert set(got) == set(ref)
    n_keep = max(1, int(round(s * (1.0 - ratio))))
    assert got["patches"].shape[1] == n_keep
    for k, v in ref.items():
        g = got[k].numpy()
        assert g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    # real patches fill the visible set first
    for i, n in enumerate(lengths):
        assert got["mask"][i].sum() == min(n, n_keep)


def test_mae_noise_draws_from_the_generator():
    mask = torch.ones(2, 9, dtype=torch.int32)
    a = ttrain.mae_noise(torch.Generator().manual_seed(3), mask)
    b = ttrain.mae_noise(torch.Generator().manual_seed(3), mask)
    assert a.shape == (2, 9) and a.dtype == torch.float32 and torch.equal(a, b)
    assert ((a >= 0) & (a < 1)).all()


def test_mae_tree_bridges_leaf_for_leaf(mae):
    """The stage-1 tree → AudioMAE → the same tree; unknown and missing
    leaves raise; a tree without a decoder builds an encoder-only AudioMAE."""
    _, tc, tree, model = mae
    back = params_to_jax(model)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat) == set(got)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)
    assert model.decoder.mask_token.shape == (32,)
    with pytest.raises(KeyError, match="unknown"):
        params_from_jax({**tree, "extra": np.zeros(1, np.float32)}, tc)
    dec = {k: v for k, v in tree["decoder"].items() if k != "mask_token"}
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({**tree, "decoder": dec}, tc)
    enc_only = params_from_jax({"encoder": tree["encoder"]}, tc)
    assert isinstance(enc_only, AudioMAE) and not hasattr(enc_only, "decoder")


def test_mae_decay_mask_is_jax_rank_rule(mae):
    """JAX decays a leaf of rank >= 2; a stacked block leaf has one axis more
    there.  The 1-D mask token is not decayed, the frequency table is."""
    _, _, tree, model = mae
    mask = decay_mask(model)
    assert not mask["decoder.mask_token"] and mask["decoder.freq_pos_embed"]
    assert mask["decoder.blocks.0.ln1.scale"] and not mask["decoder.ln_f.scale"]
    assert not mask["decoder.out_proj.b"] and mask["encoder.blocks.1.attn.qkv.b"]


def test_audiomae_base_counts():
    """audiomae_base() has the published stage-1 sizes: 85,259,520 encoder
    parameters (85.26 M) and 85,850,368 decoder parameters (85.85 M)."""
    cfg = tcfg.audiomae_base()
    assert cfg.mask_ratio == 0.8 and cfg.dtype == torch.float32
    assert cfg.encoder.max_time_ind == 1000
    j = dataclasses.asdict(jcfg.audiomae_base().decoder)
    assert dataclasses.asdict(cfg.decoder) == {k: j[k] for k in dataclasses.asdict(cfg.decoder)}
    with torch.device("meta"):
        model = taudio.audiomae_init(cfg.encoder, cfg.decoder, None)
    assert sum(p.numel() for p in model.encoder.parameters()) == 85_259_520
    assert sum(p.numel() for p in model.decoder.parameters()) == 85_850_368
