"""The port's checkpoint IO against the JAX package's: the Flax msgpack
format (its own reader and writer, no flax or msgpack in the port),
`load_caco` of a released-layout file in both text layouts, config
inference, the published count guards, and the port's own `save_params`.

Files are written as the released checkpoint is: Flax's legacy msgpack
(`save_checkpoint` with orbax checkpointing turned off for the write; flax
0.12 writes orbax directories by default).  Parameters must be equal bit
for bit; the CPU engines' embeddings from the two loaded models within
1e-6 (fp32 sums in another order; JAX's Pallas kernels in interpret mode).
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
from cacophony_tpu.models.caco import caco_init as jax_caco_init
from cacophony_tpu.runtime import CacoEngine as JaxEngine
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.checkpoints import convert, io
from cacophony_tpu_torch.checkpoints import msgpack as mp
from cacophony_tpu_torch.checkpoints.bridge import params_to_jax
from cacophony_tpu_torch.models.caco import CacoModel
from cacophony_tpu_torch.runtime import CacoEngine

torch.set_num_threads(2)

VOCAB = 300


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def _numbered(ref):
    """The released tree with the text towers' layers numbered '0'..'L-1'
    instead of scan-stacked under ScanFlaxRobertaLayer_0."""
    out = dict(ref)
    for tower in ("text_module", "decoder_module"):
        stacked = ref[tower]["encoder"]["layer"]["ScanFlaxRobertaLayer_0"]
        n = jax.tree_util.tree_leaves(stacked)[0].shape[0]
        layers = {str(i): jax.tree_util.tree_map(lambda x, i=i: np.asarray(x)[i], stacked)
                  for i in range(n)}
        out[tower] = dict(ref[tower], encoder={"layer": layers})
    return out


def _flax_write(ckpt_dir, ref, step=0):
    with flax_config.temp_flip_flag("use_orbax_checkpointing", False):
        flax_checkpoints.save_checkpoint(str(ckpt_dir), {"0": {"params": ref}}, step=step,
                                         overwrite=True)


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = jcfg.caco_tiny(vocab_size=VOCAB)
    params = jax.tree_util.tree_map(np.asarray, jax_caco_init(jax.random.PRNGKey(3), cfg))
    return cfg, params, jconvert.caco_params_to_reference(params, cfg.audio.num_heads)


def _assert_configs_agree(ours, theirs):
    """Every field of the port's config (dtype aside) equals JAX's (JAX's
    AudioEncoderConfig also has a flash_attention switch, which the port
    leaves out)."""
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    a.pop("dtype")
    assert a == {k: ({f: b[k][f] for f in v} if isinstance(v, dict) else b[k])
                 for k, v in a.items()}


@pytest.mark.parametrize("layout", ["scan", "numbered"])
def test_load_caco_equals_jax_bit_for_bit(tmp_path, jax_tiny, layout):
    """A flax-written caco_tiny file loads through the port's load_caco
    (config inferred): every parameter equals the JAX package's load_caco
    leaf for leaf, and the inferred configs agree."""
    _, _, ref = jax_tiny
    _flax_write(tmp_path, ref if layout == "scan" else _numbered(ref))
    jcfg_loaded, jparams = jio.load_caco(str(tmp_path), strict_counts=False)
    cfg, model = io.load_caco(str(tmp_path), strict_counts=False, device="cpu")
    assert isinstance(model, CacoModel) and next(model.parameters()).device.type == "cpu"
    _assert_trees_equal(params_to_jax(model), jax.tree_util.tree_map(np.asarray, jparams))
    _assert_configs_agree(cfg, jcfg_loaded)


def test_infer_caco_config_matches_jax(jax_tiny):
    jc, _, ref = jax_tiny
    for tree in (ref, _numbered(ref)):
        ours, theirs = io.infer_caco_config(tree), jio.infer_caco_config(tree)
        _assert_configs_agree(ours, theirs)
        assert ours.audio.hidden_size == jc.audio.hidden_size and ours.use_decoder
    # at the published widths nothing changes from caco_base
    base = jcfg.caco_base()
    shapes = jax.eval_shape(lambda: jax_caco_init(jax.random.PRNGKey(0), base))
    ref_base = jconvert.caco_params_to_reference(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), base.audio.num_heads)
    assert io.infer_caco_config(ref_base) == tcfg.caco_base()


def test_port_writer_reads_back_through_flax(tmp_path, jax_tiny):
    """The port's export (params_to_jax → caco_params_to_reference → its
    msgpack writer) equals JAX's export of the same parameters, flax's
    restore_checkpoint reads the file back identically, and the file is the
    bytes flax itself writes for that tree."""
    jc, params, ref = jax_tiny
    _flax_write(tmp_path / "src", ref)
    _, model = io.load_caco(str(tmp_path / "src"), strict_counts=False, device="cpu")
    ours = convert.caco_params_to_reference(params_to_jax(model), jc.audio.num_heads)
    _assert_trees_equal(ours, ref)
    path = mp.save_checkpoint(str(tmp_path / "out"), {"0": {"params": ours}}, step=7)
    assert path.endswith("checkpoint_7")
    back = flax_checkpoints.restore_checkpoint(str(tmp_path / "out"), target=None)
    _assert_trees_equal(back["0"]["params"], ref)
    with open(path, "rb") as f:
        assert f.read() == flax_ser.to_bytes({"0": {"params": ours}})


def test_bf16_leaves_and_chunked_arrays_round_trip(tmp_path, monkeypatch):
    """A bfloat16 leaf (a torch tensor in the port, ml_dtypes in flax) and
    arrays above the chunk size (lowered to 4 KB here) round-trip through
    the port's writer and reader, and between the port and flax both ways,
    byte for byte."""
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 4096)
    rs = np.random.RandomState(0)
    bf16 = torch.from_numpy(rs.randn(40, 33).astype(np.float32)).to(torch.bfloat16)
    big_bf16 = torch.from_numpy(rs.randn(3000).astype(np.float32)).to(torch.bfloat16)
    tree = {"w": bf16, "big": rs.randn(70, 50).astype(np.float32), "big_bf16": big_bf16,
            "ints": np.arange(-3, 9, dtype=np.int64), "half": rs.randn(5).astype(np.float16),
            "scalar": np.float32(2.5), "zero_d": np.asarray(-1.25, np.float32), "n": 12}
    data = mp.dumps(tree)
    back = mp.loads(data)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], bf16)
    assert torch.equal(back["big_bf16"], big_bf16)
    np.testing.assert_array_equal(back["big"], tree["big"])
    assert back["ints"].dtype == np.int64 and back["half"].dtype == np.float16
    assert back["scalar"] == np.float32(2.5) and isinstance(back["scalar"], np.float32)
    assert back["zero_d"].shape == () and back["n"] == 12
    # flax reads the port's bytes, and writes the same bytes for the same tree
    theirs = flax_ser.msgpack_restore(data)
    np.testing.assert_array_equal(np.asarray(theirs["w"]).view(np.uint16),
                                  bf16.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(theirs["big"], tree["big"])
    flax_tree = dict(tree, w=jax.numpy.asarray(np.asarray(theirs["w"])),
                     big_bf16=jax.numpy.asarray(np.asarray(theirs["big_bf16"])))
    flax_bytes = flax_ser.to_bytes(flax_tree)
    assert flax_bytes == data
    assert torch.equal(mp.loads(flax_bytes)["big_bf16"], big_bf16)


def test_directory_resolves_to_newest_checkpoint(tmp_path):
    for step in (2, 10, 9):
        mp.save_checkpoint(str(tmp_path), {"step": step}, step=step)
    assert mp.restore_checkpoint(str(tmp_path))["step"] == 10  # by number, not by name
    assert mp.restore_checkpoint(str(tmp_path / "checkpoint_9"))["step"] == 9  # a file as it is
    assert mp.restore_checkpoint(str(tmp_path / "missing")) is None
    with pytest.raises(FileExistsError):
        mp.save_checkpoint(str(tmp_path), {}, step=2)
    with pytest.raises(FileNotFoundError):
        io.load_caco(str(tmp_path / "missing"), device="cpu")


def test_strict_counts(tmp_path, jax_tiny):
    """caco_tiny is refused with the published guards on; a caco_base
    model (built on the meta device) passes them, each count within 0.02 M
    of the published one, as JAX's count_params counts."""
    _flax_write(tmp_path, jax_tiny[2])
    with pytest.raises(ValueError, match="param count mismatch"):
        io.load_caco(str(tmp_path), device="cpu")
    with torch.device("meta"):
        model = CacoModel(tcfg.caco_base())
    io._check_counts(model, strict=True)
    for key, published in io.PUBLISHED_PARAM_COUNTS_M.items():
        assert abs(io.count_params(getattr(model, key)) / 1e6 - published) <= 0.02


def test_convert_rejects_layout_drift():
    with pytest.raises(KeyError, match="layout drift"):
        convert.convert_caco_params({"something_else": {}})


def test_save_and_load_params(tmp_path, jax_tiny):
    _flax_write(tmp_path / "src", jax_tiny[2])
    cfg, model = io.load_caco(str(tmp_path / "src"), strict_counts=False, device="cpu")
    io.save_params(model, str(tmp_path / "ours" / "params.pt"))
    state = io.load_params(str(tmp_path / "ours" / "params.pt"))
    fresh = io.load_params(str(tmp_path / "ours" / "params.pt"), like=CacoModel(cfg))
    for name, t in model.state_dict().items():
        assert torch.equal(state[name], t) and torch.equal(fresh.state_dict()[name], t)


def test_loaded_engine_embeddings_match_jax(tmp_path, jax_tiny):
    """The CPU engine on the port's loaded model against JAX's CacoEngine on
    the JAX package's loaded parameters, the same file, fp32."""
    _flax_write(tmp_path, jax_tiny[2])
    jc, jparams = jio.load_caco(str(tmp_path), strict_counts=False)
    cfg, model = io.load_caco(str(tmp_path), strict_counts=False, device="cpu")
    rs = np.random.RandomState(1)
    wavs = [(0.1 * rs.randn(n)).astype(np.float32) for n in (16_000, 5_000, 11_000)]
    kw = dict(buffer_seconds=1.0, batch_size=4)
    ref = JaxEngine(jc, jparams, **kw).embed_audio(wavs)
    got = CacoEngine(cfg, model, device="cpu", **kw).embed_audio(wavs)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
