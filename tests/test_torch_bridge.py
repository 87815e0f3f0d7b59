"""The PyTorch port's package boundary: the JAX→torch parameter bridge, the
port importing without JAX or Triton, and the K1 launch counters.

No JAX kernel is reached here: the bridge test only initializes JAX
parameters (`caco_init`), and the rest never runs the JAX package.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cacophony_tpu import configs as jcfg
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu.models.layers import count_params as jax_count_params
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints.bridge import jax_state_dict, params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_tiny_tree():
    return _numpy_tree(jax_caco_init(jax.random.PRNGKey(0), jcfg.caco_tiny(vocab_size=300)))


def test_bridge_round_trip_caco_tiny(jax_tiny_tree):
    """Every leaf equal (exactly), every parameter filled, counts match
    (the decoder subtree is accepted and left out)."""
    model = params_from_jax(jax_tiny_tree, tcfg.caco_tiny(vocab_size=300))
    state = model.state_dict()
    flat = jax_state_dict(jax_tiny_tree)
    assert set(state) == set(flat)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), leaf, err_msg=name)
    no_decoder = {k: v for k, v in jax_tiny_tree.items() if k != "decoder"}
    assert sum(p.numel() for p in model.parameters()) == jax_count_params(no_decoder)
    # unstacking: layer i of a stacked leaf is blocks.{i}
    stacked = jax_tiny_tree["audio"]["blocks"]["attn"]["qkv"]["w"]
    np.testing.assert_array_equal(model.audio.blocks[1].attn.qkv.w.detach().numpy(), stacked[1])


def test_bridge_rejects_unknown_and_missing_keys(jax_tiny_tree):
    cfg = tcfg.caco_tiny(vocab_size=300)
    extra = dict(jax_tiny_tree, surprise={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="surprise"):
        params_from_jax(extra, cfg)
    missing = {k: v for k, v in jax_tiny_tree.items() if k != "text_proj"}
    with pytest.raises(KeyError, match="text_proj"):
        params_from_jax(missing, cfg)


def test_bridge_rejects_shape_mismatch(jax_tiny_tree):
    # the same tree against a wider config
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(jax_tiny_tree, tcfg.caco_tiny(vocab_size=301))


_IMPORT_ALL = r"""
import builtins, importlib, pkgutil, sys
real_import = builtins.__import__
def guard(name, *args, **kwargs):
    if name.split(".")[0] in ("jax", "jaxlib", "triton", "cacophony_tpu"):
        raise ImportError("blocked: " + name)
    return real_import(name, *args, **kwargs)
builtins.__import__ = guard
import cacophony_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cacophony_tpu_torch.__path__, "cacophony_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(len(names))
"""


def test_port_imports_without_jax_or_triton():
    """Every module of the port imports with jax, triton and the JAX
    package blocked (the card has none of them): the guard refuses every
    import statement naming them, cached or not."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 15


def test_cpu_tensors_leave_launch_counters_at_zero():
    """The wrappers run the plain versions for CPU tensors and launch
    nothing: every counter stays 0 through a whole encoder layer."""
    from cacophony_tpu_torch.models.audio import ViTBlock
    from cacophony_tpu_torch.ops import _kernels as kern
    from cacophony_tpu_torch.ops import encoder_attention as ea

    kern.reset_launches()
    ea.LAYER_LAUNCHES["k1_layer"] = 0
    blk = ViTBlock(32, 64, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 32)
    mask = torch.ones(2, 16, dtype=torch.int32)
    with torch.inference_mode():
        out = ea.fused_layer(blk, x, mask, 2, 1e-6)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert all(v == 0 for v in kern.LAUNCHES.values())
    assert ea.LAYER_LAUNCHES["k1_layer"] == 0
