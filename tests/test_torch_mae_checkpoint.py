"""The port's stage-1 checkpoints against the JAX package's: `load_audiomae`
of a flax-written released-layout file (`AudioEncoder_0` /
`AudioDecoder_0`), `infer_audiomae_config`, the published count guards,
the port's writer read back through flax, and
`transplant_audiomae_encoder`.  Parameters must be equal bit for bit.

Files are written as the released checkpoints are: Flax's legacy msgpack
(`save_checkpoint` with orbax checkpointing turned off for the write).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import config as flax_config
from flax import serialization as flax_ser
from flax.training import checkpoints as flax_checkpoints

from cacophony_tpu import configs as jcfg
from cacophony_tpu.checkpoints import convert as jconvert
from cacophony_tpu.checkpoints import io as jio
from cacophony_tpu.models.audio import audiomae_init as jax_audiomae_init
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints import convert, io
from cacophony_tpu_torch.checkpoints import msgpack as mp
from cacophony_tpu_torch.checkpoints.bridge import params_from_jax, params_to_jax
from cacophony_tpu_torch.models.audio import AudioMAE
from test_torch_checkpoint_io import _assert_trees_equal
from test_torch_mae_model import tiny_mae

torch.set_num_threads(2)


def _flax_write(ckpt_dir, ref, step=0):
    with flax_config.temp_flip_flag("use_orbax_checkpointing", False):
        flax_checkpoints.save_checkpoint(str(ckpt_dir), {"0": {"params": ref}}, step=step,
                                         overwrite=True)


@pytest.fixture(scope="module")
def jax_mae():
    cfg = tiny_mae(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jax_audiomae_init(jax.random.PRNGKey(4), cfg.encoder, cfg.decoder))
    ref = jconvert.audiomae_params_to_reference(params, cfg.encoder.num_heads,
                                                cfg.decoder.num_heads)
    return cfg, params, ref


def _assert_configs_agree(ours, theirs):
    """Every field of the port's config (dtype aside) equals JAX's (JAX's
    encoder and decoder configs also carry a flash_attention switch, which
    the port leaves out)."""
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    a.pop("dtype")
    assert a == {k: ({f: b[k][f] for f in v} if isinstance(v, dict) else b[k])
                 for k, v in a.items()}


@pytest.mark.parametrize("with_decoder", [True, False])
def test_load_audiomae_equals_jax_bit_for_bit(tmp_path, jax_mae, with_decoder):
    """A flax-written stage-1 file loads through the port's load_audiomae
    (config inferred): every parameter equals JAX's load_audiomae leaf for
    leaf, and the inferred configs agree.  An encoder-only file gives an
    AudioMAE without a decoder."""
    _, _, ref = jax_mae
    if not with_decoder:
        ref = {"AudioEncoder_0": ref["AudioEncoder_0"]}
    _flax_write(tmp_path, ref)
    jc_loaded, jparams = jio.load_audiomae(str(tmp_path), strict_counts=False)
    cfg, model = io.load_audiomae(str(tmp_path), strict_counts=False, device="cpu")
    assert isinstance(model, AudioMAE) and next(model.parameters()).device.type == "cpu"
    assert hasattr(model, "decoder") == with_decoder
    _assert_trees_equal(params_to_jax(model), jax.tree_util.tree_map(np.asarray, jparams))
    _assert_configs_agree(cfg, jc_loaded)


def test_infer_audiomae_config_matches_jax(jax_mae):
    jc, _, ref = jax_mae
    ours, theirs = io.infer_audiomae_config(ref), jio.infer_audiomae_config(ref)
    _assert_configs_agree(ours, theirs)
    assert ours.encoder.hidden_size == jc.encoder.hidden_size == ours.decoder.hidden_size
    # at the published widths nothing changes from audiomae_base
    base = jcfg.audiomae_base()
    shapes = jax.eval_shape(
        lambda: jax_audiomae_init(jax.random.PRNGKey(0), base.encoder, base.decoder))
    ref_base = jconvert.audiomae_params_to_reference(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
        base.encoder.num_heads, base.decoder.num_heads)
    assert io.infer_audiomae_config(ref_base) == tcfg.audiomae_base()
    assert io.infer_audio_decoder_config(ref_base["AudioDecoder_0"]) == tcfg.AudioDecoderConfig()


def test_strict_counts(tmp_path, jax_mae):
    """The tiny MAE is refused with the published guards on (as JAX refuses
    it); an audiomae_base model (built on the meta device) passes them."""
    _flax_write(tmp_path, jax_mae[2])
    with pytest.raises(ValueError, match="MAE encoder param count"):
        jio.load_audiomae(str(tmp_path))
    with pytest.raises(ValueError, match="MAE encoder param count"):
        io.load_audiomae(str(tmp_path), device="cpu")
    base = tcfg.audiomae_base()
    with torch.device("meta"):
        model = AudioMAE(base.encoder, base.decoder)
    io._check_mae_counts(model)
    assert abs(io.count_params(model.decoder) / 1e6 - io.PUBLISHED_MAE_DECODER_M) <= 0.01
    with torch.device("meta"):
        wide = AudioMAE(base.encoder, dataclasses.replace(base.decoder, num_layers=11))
    with pytest.raises(ValueError, match="MAE decoder param count"):
        io._check_mae_counts(wide)


def test_load_audiomae_raises_without_a_card(tmp_path, jax_mae, monkeypatch):
    _flax_write(tmp_path, jax_mae[2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        io.load_audiomae(str(tmp_path), strict_counts=False)


def test_port_writer_reads_back_through_flax(tmp_path, jax_mae):
    """The port's export (params_to_jax → audiomae_params_to_reference → its
    msgpack writer) equals JAX's export of the same parameters, flax reads
    the file back identically, and the file is the bytes flax writes."""
    jc, params, ref = jax_mae
    model = params_from_jax(params, tiny_mae(tcfg))
    ours = convert.audiomae_params_to_reference(params_to_jax(model), jc.encoder.num_heads,
                                                jc.decoder.num_heads)
    _assert_trees_equal(ours, ref)
    path = mp.save_checkpoint(str(tmp_path), {"0": {"params": ours}}, step=3)
    back = flax_checkpoints.restore_checkpoint(str(tmp_path), target=None)
    _assert_trees_equal(back["0"]["params"], ref)
    with open(path, "rb") as f:
        assert f.read() == flax_ser.to_bytes({"0": {"params": ours}})
    _assert_trees_equal(convert.convert_audiomae_params(ours),
                        jax.tree_util.tree_map(np.asarray, jconvert.convert_audiomae_params(ref)))


def test_transplant_audiomae_encoder_equals_jax(tmp_path, jax_mae):
    """The CACO tree after the port's transplant equals JAX's: the audio
    tower is the MAE's encoder, every other leaf is left as it was."""
    _, params, ref = jax_mae
    jc = jcfg.caco_tiny()
    caco_tree = jax.tree_util.tree_map(np.asarray, jax_caco_init(jax.random.PRNGKey(1), jc))
    want = jconvert.transplant_audiomae_encoder(caco_tree, params)
    caco_model = params_from_jax(caco_tree, tcfg.caco_tiny())
    _flax_write(tmp_path, ref)
    _, mae = io.load_audiomae(str(tmp_path), strict_counts=False, device="cpu")
    assert convert.transplant_audiomae_encoder(caco_model, mae) is caco_model
    _assert_trees_equal(params_to_jax(caco_model), jax.tree_util.tree_map(np.asarray, want))
