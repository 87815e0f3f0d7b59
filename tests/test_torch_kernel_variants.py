"""K6, K3′'s gates and K8′ in the port against the JAX package.

JAX kernels reached, in Pallas interpret mode as the JAX package's own
tests run them: K6 `_pallas_fused_ln`, K8′ `fused_log_mel(fast_dft=True)`,
and through `_vit_block` (forced onto its narrow fallback) K6 again.  The
gates `try_fused_layer` / `try_fused_block_attention` /
`try_fused_ln_attention` are compared by the variant each runs, with the
kernels themselves stubbed on both sides.  Inputs come from numpy with a
fixed seed.

Tolerances: K6 bit-equal in bf16 (the plain chain rounds where the Pallas
kernel rounds: K1's numerics up to the attention) and 1e-6 in fp32 (sums
in another order); K8′ 1e-4 on the log-mel (fp32 sums of exact bf16
products in another order; the log scales a mel error δ by
0.2/(mel + 1e-5)), with a quiet and a silent clip; the layer through route
"k6" as the other MLP-outside layers: fp32 5e-5, bf16 2^-6 absolute plus
2^-6 relative (silu's rounding points in bf16 belong to XLA's backend).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cacophony_tpu.configs import FrontendConfig as JFront
from cacophony_tpu.configs import PatchConfig as JPatch
from cacophony_tpu.frontend import fused as jfused
from cacophony_tpu.models import audio as jaudio
from cacophony_tpu.ops import encoder_attention as jea
from cacophony_tpu_torch.configs import FrontendConfig, PatchConfig
from cacophony_tpu_torch.frontend import fused
from cacophony_tpu_torch.models.audio import ViTBlock, encoder_layer
from cacophony_tpu_torch.ops import _kernels as kern
from cacophony_tpu_torch.ops import encoder_attention as tea
from tests.test_torch_encoder_attention import _block_params, _mask
from tests.test_torch_fused_frontend import _bufs

torch.set_num_threads(2)

EPS = 1e-6
FRONT = FrontendConfig()
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_pallas_fused_ln(dtype):
    """B=3, S=48, D=64, H=4; clip 2 has no valid key (exactly 0)."""
    rs = np.random.RandomState(0)
    tree, blk = _block_params(rs, 64, 256)
    x = rs.randn(3, 48, 64).astype(np.float32)
    mask = _mask([48, 30, 0], 48)
    jd, td = DTYPES[dtype]
    ref = jea._pallas_fused_ln(jax.tree_util.tree_map(jnp.asarray, tree["ln1"]),
                               jax.tree_util.tree_map(jnp.asarray, tree["attn"]["qkv"]),
                               jnp.asarray(x, jd), jnp.asarray(mask), 4, EPS, interpret=True)
    kern.reset_launches()
    tea.LAYER_LAUNCHES["k6_attn"] = 0
    with torch.no_grad():
        got = tea.fused_ln_attention(blk.ln1, blk.attn.qkv, torch.from_numpy(x).to(td),
                                     torch.from_numpy(mask), 4, EPS)
    assert tea.LAYER_LAUNCHES["k6_attn"] == 0 and not any(kern.LAUNCHES.values())
    assert got.dtype == td and got.shape == (3, 48, 64)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert (got[2] == 0).all()
    plain = tea.fused_ln_attention_plain(blk.ln1, blk.attn.qkv, torch.from_numpy(x).to(td),
                                         torch.from_numpy(mask), 4, EPS)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("frames", [200, 1000])
def test_k8_prime_plain_matches_pallas_fast_dft(frames):
    """Noise, a quiet clip (1e-4) and a silent one; and the bf16 halves of
    the DFT matrix equal JAX's `_split_bf16`."""
    bufs, _ = _bufs(frames // 100, [frames * 160, frames * 160, 0], seed=frames)
    rows = fused.buffer_to_rows(torch.from_numpy(bufs), frames, FRONT)
    ref = jfused.fused_log_mel(jnp.asarray(rows.numpy()), JFront(), frames, interpret=True,
                               fast_dft=True)
    kern.reset_launches()
    got = fused.fused_log_mel(rows, FRONT, frames, fast_dft=True)
    assert not any(kern.LAUNCHES.values())
    assert got.shape == (3, frames, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    exact = fused.fused_log_mel(rows, FRONT, frames)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=2e-4)  # JAX's bound on bf16×3
    assert not torch.equal(got, exact)
    hi, lo = jfused._split_bf16(fused._padded_matrices(FRONT)[0])
    t_hi, t_lo = fused._device_split_matrices(FRONT, torch.device("cpu"))
    np.testing.assert_array_equal(t_hi.float().numpy(), np.asarray(hi, np.float32))
    np.testing.assert_array_equal(t_lo.float().numpy(), np.asarray(lo, np.float32))


@pytest.mark.parametrize("seconds,seq", [(10, 496), (30, 1536)])
def test_fused_batch_wav_to_patches_fast_dft_matches_jax(seconds, seq):
    """fast_dft takes effect where JAX runs its kernel (`fits_vmem`: 10 s);
    at 30 s JAX takes its exact chain, and the port's patches equal its
    exact path."""
    n = seconds * 16_000
    bufs, lens = _bufs(seconds, [n, n // 3, 0], seed=seconds)
    patch = PatchConfig(patches_seq_len=seq)
    assert fused.fits_vmem(seconds * 100, FRONT) == jfused.fits_vmem(seconds * 100, JFront())
    assert fused.fits_vmem(seconds * 100, FRONT) == (seconds == 10)
    ref = jfused.fused_batch_wav_to_patches(jnp.asarray(bufs), jnp.asarray(lens), JFront(),
                                            JPatch(patches_seq_len=seq), interpret=True,
                                            fast_dft=True)
    args = (torch.from_numpy(bufs), torch.from_numpy(lens), FRONT, patch)
    got = fused.fused_batch_wav_to_patches(*args, fast_dft=True)
    exact = fused.fused_batch_wav_to_patches(*args)
    for k in ("audio_mask", "audio_time_inds", "audio_freq_inds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["audio_patches"].numpy(), np.asarray(ref["audio_patches"]),
                               atol=1e-4)
    same = torch.equal(got["audio_patches"], exact["audio_patches"])
    assert same == (seconds == 30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_route_matches_jax_vit_block(dtype, monkeypatch):
    """JAX's `_vit_block` forced onto its narrow fallback (K6, dense(o),
    the residual, LN2, the act_dense MLP) by its own flags; the port's
    route "k6", which the same budget gives its `layer_route`."""
    monkeypatch.setattr(jea, "FUSED_BLOCK_MLP", False)
    monkeypatch.setattr(jea, "BLOCK_KERNEL_BUDGET", 0)
    monkeypatch.setattr(tea, "BLOCK_KERNEL_BUDGET", 0)
    rs = np.random.RandomState(5)
    tree, blk = _block_params(rs, 64, 256)
    x = rs.randn(3, 48, 64).astype(np.float32)
    mask = _mask([48, 20, 0], 48)
    jd, td = DTYPES[dtype]
    assert tea.layer_route(48, 64, 256, td) == ("k6", 48)
    ref = jaudio._vit_block(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x, jd), None,
                            num_heads=4, dropout_rate=0.0, drop_path_rate=0.0, dtype=jd,
                            flash_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = encoder_layer(blk, torch.from_numpy(x).to(td), torch.from_numpy(mask), 4, "k6", td)
    assert got.dtype == td and torch.isfinite(got).all()
    atol, rtol = {"float32": (5e-5, 0), "bfloat16": (2 ** -6, 2 ** -6)}[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


SEQS = sorted(set(range(8, 2400, 41)) | {48, 200, 496, 500, 600, 1000, 1496, 1500, 1536, 2000})


@pytest.mark.parametrize("width,inter", [(32, 64), (768, 3072)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gates_decline_where_jax_declines(width, inter, dtype, monkeypatch):
    """The three gates over S = 8…2400: each runs the variant JAX's runs
    and returns None exactly where JAX's does (the kernels stubbed to
    report their variant; K6 has none)."""
    # stand-ins that report which kernel variant the gate chose
    for name in ("fused_layer", "fused_block_attention"):
        monkeypatch.setattr(jea, name, lambda *a: a[5])
        monkeypatch.setattr(tea, name, lambda *a: a[5])
    monkeypatch.setattr(jea, "fused_ln_attention", lambda *a: "k6")
    monkeypatch.setattr(tea, "fused_ln_attention", lambda *a: "k6")
    jd, td = DTYPES[dtype]
    blk = ViTBlock(width, inter)
    tree = {"ln1": None, "attn": {"qkv": None}, "ln2": None,
            "mlp": {"w1": {"w": np.zeros((width, inter), np.float32)}}}
    taken = set()
    for s in SEQS:
        x, tx = jnp.zeros((1, s, width), jd), torch.zeros(1, s, width, dtype=td)
        m, tm = jnp.ones((1, s), jnp.int32), torch.ones(1, s, dtype=torch.int32)
        for allow in (False, True):
            want = jea.try_fused_layer(tree, x, m, 2, EPS, jd, allow_blocked=allow)
            got = tea.try_fused_layer(blk, tx, tm, 2, EPS, td, allow_blocked=allow)
            assert got == want, (s, allow, got, want)
            taken.add(("layer", got))
        want = jea.try_fused_block_attention(tree, x, m, 2, EPS, jd)
        assert tea.try_fused_block_attention(blk, tx, tm, 2, EPS, td) == want, s
        want = jea.try_fused_ln_attention(tree["ln1"], tree["attn"], x, m, 2, EPS, jd)
        assert tea.try_fused_ln_attention(blk.ln1, blk.attn, tx, tm, 2, EPS, td) == want, s
    assert {("layer", None), ("layer", ("one_shot",))} <= taken  # the sweep crosses the gate
