"""The text tower from local HF RoBERTa files: the port's
`convert_hf_roberta` against the JAX package's, and `load_hf_text_tower`
on directories written here by `transformers` (no hub access) against
JAX's runner path, `convert_hf_roberta(FlaxRobertaModel.from_pretrained(
dir[, from_pt=True]).params)`, bit for bit in all three formats; then
runner `--init-text-from-hf`.  Widths: caco_tiny's text tower (hidden 32,
2 layers, 2 heads, MLP 64, vocabulary 128, 64 positions)."""

import json
import os

import numpy as np
import pytest
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.checkpoints import convert, hf
from cacophony_tpu_torch.checkpoints.bridge import jax_state_dict
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.train import runner
from test_torch_runner import _args, data  # noqa: F401  (a fixture; tests/ is on sys.path)

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64, type_vocab_size=1)


def _synthetic_hf(seed=0, d=8, inter=16, layers=2):
    """An HF Flax-layout tree, numbered layers (tests/test_pipeline_transplant.py)."""
    rng = np.random.RandomState(seed)

    def dense(i, o):
        return {"kernel": rng.randn(i, o).astype(np.float32), "bias": rng.randn(o).astype(np.float32)}

    def ln():
        return {"scale": rng.randn(d).astype(np.float32), "bias": rng.randn(d).astype(np.float32)}

    def layer():
        return {"attention": {"self": {"query": dense(d, d), "key": dense(d, d), "value": dense(d, d)},
                              "output": {"dense": dense(d, d), "LayerNorm": ln()}},
                "intermediate": {"dense": dense(d, inter)},
                "output": {"dense": dense(inter, d), "LayerNorm": ln()}}

    return {"embeddings": {"word_embeddings": {"embedding": rng.randn(32, d).astype(np.float32)},
                           "position_embeddings": {"embedding": rng.randn(10, d).astype(np.float32)},
                           "token_type_embeddings": {"embedding": rng.randn(1, d).astype(np.float32)},
                           "LayerNorm": ln()},
            "encoder": {"layer": {str(i): layer() for i in range(layers)}},
            "pooler": {"dense": dense(d, d)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_convert_hf_roberta_equals_jax():
    from cacophony_tpu.checkpoints.convert import convert_hf_roberta as jax_convert

    tree = _synthetic_hf()
    ours, ref = _flat(convert.convert_hf_roberta(tree)), _flat(jax_convert(tree))
    assert set(ours) == set(ref) and "pooler" not in str(sorted(ours))
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


def _hf_config():
    from transformers import RobertaConfig

    return RobertaConfig(**TINY)


def _write(fmt, root, seed=0):
    """A caco_tiny-width RoBERTa saved by transformers in one format."""
    path = str(root / fmt)
    if fmt == "flax_model.msgpack":
        from transformers import FlaxRobertaModel

        FlaxRobertaModel(_hf_config(), seed=seed).save_pretrained(path)
    else:
        from transformers import RobertaModel

        torch.manual_seed(seed)
        RobertaModel(_hf_config()).save_pretrained(
            path, safe_serialization=fmt == "model.safetensors")
    assert fmt in os.listdir(path)
    return path


def _jax_import(path, fmt):
    """JAX's runner path (cacophony_tpu/train/runner.py:138-144)."""
    import jax
    from transformers import FlaxRobertaModel

    from cacophony_tpu.checkpoints.convert import convert_hf_roberta as jax_convert

    model = FlaxRobertaModel.from_pretrained(path, from_pt=fmt != "flax_model.msgpack")
    return jax_state_dict(jax_convert(jax.device_get(model.params)))


def _tiny_model(seed=1):
    return caco_init(configs.caco_tiny(), torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("fmt", hf.FORMATS)
def test_load_hf_text_tower_equals_jax(fmt, tmp_path):
    path = _write(fmt, tmp_path)
    ref = _jax_import(path, fmt)
    model = _tiny_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hf.load_hf_text_tower(model, path)
    text = model.text.state_dict()
    for name, leaf in ref.items():
        assert torch.equal(text[name], torch.from_numpy(np.asarray(leaf, np.float32))), name
    for name, t in model.state_dict().items():  # only embeddings and blocks of text change
        if not name.startswith(("text.embeddings.", "text.blocks.")):
            assert torch.equal(t, before[name]), name
    assert text["embeddings.position"].shape == (64, 32)  # every position row copied


def test_prefixes_heads_and_bf16_are_read(tmp_path):
    """`roberta.`-prefixed keys with an `lm_head` (a ForMaskedLM save), old
    `gamma` / `beta` LayerNorm names and a `position_ids` buffer in a
    `.bin`, and BF16 in a safetensors file."""
    from transformers import RobertaForMaskedLM

    torch.manual_seed(3)
    mlm = RobertaForMaskedLM(_hf_config())
    mlm.save_pretrained(str(tmp_path / "mlm"))
    plain = {k[len("roberta."):]: v for k, v in mlm.state_dict().items() if k.startswith("roberta.")}
    ref = hf.torch_to_flax(plain)
    assert "pooler" not in ref and set(ref) == {"embeddings", "encoder"}
    got = hf.read_hf_roberta(str(tmp_path / "mlm"))
    assert _flat(got).keys() == _flat(ref).keys()
    for k, v in _flat(ref).items():
        assert np.array_equal(_flat(got)[k], v), k
    old = {(k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta")
            if "LayerNorm" in k else k): v for k, v in mlm.state_dict().items()}
    old["roberta.embeddings.position_ids"] = torch.arange(64)[None]
    os.makedirs(tmp_path / "old")
    torch.save(old, tmp_path / "old" / "pytorch_model.bin")
    for k, v in _flat(hf.read_hf_roberta(str(tmp_path / "old"))).items():
        assert np.array_equal(v, _flat(ref)[k]), k
    from safetensors.torch import save_file

    os.makedirs(tmp_path / "bf16")
    save_file({k: v.to(torch.bfloat16).contiguous() for k, v in plain.items()},
              str(tmp_path / "bf16" / "model.safetensors"), metadata={"format": "pt"})
    got16 = _flat(hf.read_hf_roberta(str(tmp_path / "bf16")))
    for k, v in _flat(ref).items():
        want = torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16).float().numpy()
        assert np.array_equal(got16[k], want), k


def test_mismatches_and_missing_files_raise(tmp_path):
    path = _write("model.safetensors", tmp_path)
    model = _tiny_model()
    cfg = json.load(open(os.path.join(path, "config.json")))
    json.dump(dict(cfg, intermediate_size=128), open(os.path.join(path, "config.json"), "w"))
    with pytest.raises(ValueError, match="intermediate_size"):
        hf.load_hf_text_tower(model, path)
    os.remove(os.path.join(path, "config.json"))  # the shapes are checked without it
    from transformers import RobertaConfig, RobertaModel

    RobertaModel(RobertaConfig(**dict(TINY, num_hidden_layers=3))).save_pretrained(path)
    os.remove(os.path.join(path, "config.json"))
    with pytest.raises(ValueError, match="unknown"):
        hf.load_hf_text_tower(model, path)
    with pytest.raises(FileNotFoundError, match="must be local"):
        hf.read_hf_roberta("roberta-base")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="none of"):
        hf.read_hf_roberta(str(tmp_path / "empty"))


def test_runner_init_text_from_hf(data, tmp_path):  # noqa: F811
    """One runner step with --init-text-from-hf and --warmup-steps 1 (the
    rate is 0 at step 0): the saved text tower's embeddings and blocks are
    the import; everything else, the text pooler included, is what a run
    without the flag holds (a fresh init)."""
    from transformers import RobertaConfig, RobertaModel

    torch.manual_seed(5)
    path = str(tmp_path / "hf")  # the tiny runner's vocabulary: max(300, the tokenizer's)
    RobertaModel(RobertaConfig(**dict(TINY, vocab_size=300))).save_pretrained(path)
    plain = runner.main(_args(data, str(tmp_path / "plain"), 1))
    state = runner.main(_args(data, str(tmp_path / "init"), 1) + ["--init-text-from-hf", path])
    imported = jax_state_dict(convert.convert_hf_roberta(hf.read_hf_roberta(path)))
    text = state.params.text.state_dict()
    for name, leaf in imported.items():
        assert torch.equal(text[name], torch.from_numpy(np.asarray(leaf))), name
    for name, t in plain.params.state_dict().items():
        if not name.startswith(("text.embeddings.", "text.blocks.")):
            assert torch.equal(state.params.state_dict()[name], t), name
