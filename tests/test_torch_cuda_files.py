"""Files in, files out, through the user's entry points on the card, at
published width from seeds: a caco_base released-layout checkpoint (~1.16
GB) written and served through `load_caco`; the stage-2 runner from 48
audio files and its resumed run; an audiomae_base stage-1 file through
`load_audiomae`, and the runner's `--stage mae` and
`--init-audio-from-mae`; the eval CLI (zero-shot, retrieval, captioning)
and both HEAR runners with the prediction runner on synthetic datasets;
the HF RoBERTa import at roberta-base width and `--init-text-from-hf`.
Every test here writes and reads files of a published model's size; the
module takes about two minutes on the card, hence `slow`.  Marked `cuda`; the
bounds are tests/torch_card.py's."""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.checkpoints import bridge, convert, hf, msgpack
from cacophony_tpu_torch.checkpoints import io as ckpt_io
from cacophony_tpu_torch.data import pipeline
from cacophony_tpu_torch.eval import cli as eval_cli
from cacophony_tpu_torch.hear import embeddings as hear_emb
from cacophony_tpu_torch.hear import predictions as hear_pred
from cacophony_tpu_torch.hear import predictions_runner
from cacophony_tpu_torch.hear import runner as hear_runner
from cacophony_tpu_torch.models.audio import LN_EPS, audio_input_embedding, audiomae_apply, audiomae_init
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.train import runner
from torch_card import (COS, MAE_ARGS, METRIC_ATOL, NO_SERVING, SCORE_TOL, SEED, check_close,  # noqa: F401
                        check_embeddings, clips, cosine_rows, cuda, drive, mae_input, tol,
                        write_esc50, write_hear_task, write_models, write_pcm16,
                        write_runner_data)

pytestmark = [pytest.mark.cuda, pytest.mark.slow]

LAYERS, BATCH = 12, 32
PER_STEP = {"k5": 0, **NO_SERVING}  # a training step's launches besides K4 and K7


def run_quiet(fn, *args, **kw):
    """fn(*args, **kw) with its standard output captured → (result, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def runner_data(cuda, tmp_path_factory):
    """48 clips of 3-10 s in three formats with captions, and a tokenizer."""
    return write_runner_data(str(tmp_path_factory.mktemp("runner")), np.random.RandomState(SEED))


def runner_argv(data, work, *extra):
    return ["--data-dir", data, "--workdir", work, "--batch-size", "16", "--buffer-seconds", "10",
            "--patches-seq-len", "500", "--log-every", "1", "--dtype", "bfloat16",
            "--device", "cuda", *extra]


def test_released_checkpoint_round_trip_serves_through_k1(cuda, tmp_path):
    """caco_base through `caco_params_to_reference` and the port's msgpack
    writer (a released-layout file), read back by `load_caco` onto the card
    with the config inferred and the published counts guarded: every
    tensor identical, the config caco_base(); a bf16 10-s engine on it runs
    K1 on every layer and gives the source model's embeddings."""
    cfg = configs.caco_base()
    model = caco_init(cfg, torch.Generator().manual_seed(SEED))
    ref = convert.caco_params_to_reference(bridge.params_to_jax(model), cfg.audio.num_heads)
    msgpack.save_checkpoint(str(tmp_path), {"0": {"params": ref}}, step=0)
    del ref
    cfg_loaded, loaded = ckpt_io.load_caco(str(tmp_path))
    assert cfg_loaded == cfg
    src = model.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(src)
    assert not [k for k, t in got.items() if not torch.equal(t.cpu(), src[k])]
    shutil.rmtree(tmp_path)
    wavs = clips(np.random.RandomState(SEED), 40, 3, 10)
    want = CacoEngine(cfg, model, batch_size=BATCH, dtype=torch.bfloat16).embed_audio(wavs)
    emb, _ = drive(lambda: CacoEngine(cfg_loaded, loaded, batch_size=BATCH,
                                      dtype=torch.bfloat16).embed_audio(wavs),
                   {"k1_layer": LAYERS * 2, "k2_block": 0, "k3_block": 0})
    check_embeddings(emb, len(wavs), cfg)
    assert cosine_rows(emb, want) >= COS["loaded"]


def test_runner_from_files_and_its_resumed_run(runner_data, tmp_path):
    """`train.runner.main --stage caco` at caco_base in bf16 (B=16, 500
    patches): 3 steps (every file decoded natively once, K4 and K7 once a
    layer a step, step_00000003 written), then resumed to step 5 (the
    batches trained on skipped without decoding them); every logged loss
    finite; a 10-s clip at 44.1 kHz decodes to 160 000 samples."""
    data, tok = runner_data
    work = str(tmp_path / "work")
    argv = runner_argv(data, work, "--stage", "caco", "--tokenizer", tok, "--total-steps", "5",
                       "--checkpoint-every", "0")
    for k in pipeline.DECODE_COUNTS:
        pipeline.DECODE_COUNTS[k] = 0
    (state, _), _ = drive(lambda: run_quiet(runner.main, argv + ["--steps", "3"]),
                          {"k4": 3 * LAYERS, "k7": 3 * LAYERS, **PER_STEP})
    assert pipeline.DECODE_COUNTS == {"native": 48, "fallback": 0}
    assert state.step == 3
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == ["step_00000003"]
    del state
    for k in pipeline.DECODE_COUNTS:
        pipeline.DECODE_COUNTS[k] = 0
    (state, out), _ = drive(lambda: run_quiet(runner.main, argv + ["--steps", "5"]),
                            {"k4": 2 * LAYERS, "k7": 2 * LAYERS, **PER_STEP})
    assert "resumed from step 3" in out
    assert pipeline.DECODE_COUNTS == {"native": 2 * 16, "fallback": 0}
    assert state.step == 5
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == list(range(5))
    assert np.isfinite([r["loss"] for r in rows]).all()
    shutil.rmtree(work)
    loader = pipeline.CacoTrainLoader([], {}, None, pipeline.TrainDataConfig())
    assert loader._decode([os.path.join(data, "clip01.wav")])[1].tolist() == [160000]


def test_stage1_file_and_the_runners_mae_entry_points(runner_data, tmp_path):
    """audiomae_base as a released-layout stage-1 file, read back by
    `load_audiomae` onto the card (strict counts, config inferred): every
    tensor identical, its bf16 reconstruction (K1 on all 24 layers) the
    source model's bit for bit; `runner --stage mae` for 2 steps (K4 and K7
    on all 24 layers a step); `runner --stage caco --init-audio-from-mae`
    for 1 step, after which (the rate is 0 at step 0) the audio tower is
    the file's encoder."""
    data, tok = runner_data
    cfg = configs.audiomae_base()
    enc, dec = cfg.encoder, cfg.decoder
    model = audiomae_init(enc, dec, torch.Generator().manual_seed(SEED)).cuda()
    ck = str(tmp_path / "mae_ckpt")
    ref = convert.audiomae_params_to_reference(bridge.params_to_jax(model), enc.num_heads,
                                               dec.num_heads)
    path = msgpack.save_checkpoint(ck, {"0": {"params": ref}}, step=0)
    del ref
    cfg_loaded, loaded = ckpt_io.load_audiomae(ck)
    assert cfg_loaded == cfg
    src = model.state_dict()
    assert set(loaded.state_dict()) == set(src)
    assert not [k for k, t in loaded.state_dict().items() if not torch.equal(t, src[k])]
    m = mae_input(8, cfg.mask_ratio)

    def recon(net):
        with torch.inference_mode():
            return audiomae_apply(net, enc, dec, *(m[k] for k in MAE_ARGS), dtype=torch.bfloat16)

    again, _ = drive(lambda: recon(loaded), {"k1_layer": 24, "k2_block": 0})
    assert torch.equal(again, recon(model))
    del loaded, again
    work = str(tmp_path / "mae_work")
    (state, _), _ = drive(lambda: run_quiet(runner.main, runner_argv(
        data, work, "--stage", "mae", "--steps", "2", "--checkpoint-every", "0")),
        {"k4": 48, "k7": 48, **PER_STEP})
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert state.step == 2 and [r["step"] for r in rows] == [0, 1]
    assert np.isfinite([r["loss"] for r in rows]).all()
    del state
    (state, _), _ = drive(lambda: run_quiet(runner.main, runner_argv(
        data, str(tmp_path / "caco_from_mae"), "--stage", "caco", "--tokenizer", tok, "--steps", "1",
        "--total-steps", "5", "--warmup-steps", "1", "--checkpoint-every", "0",
        "--init-audio-from-mae", path)),
        {"k4": LAYERS, "k7": LAYERS, **PER_STEP})
    audio = state.params.audio.state_dict()
    assert not [k for k, t in model.encoder.state_dict().items() if not torch.equal(audio[k], t)]
    shutil.rmtree(tmp_path)


# ---- the eval CLI and HEAR ---------------------------------------------------

ESC_CATEGORIES = ("dog", "rain", "siren", "crying baby", "church bells")
CLOTHO_CLIPS = 40
NO_VARIANTS = {"k3_layer": 0, "k6_attn": 0, "log_mel": 0, "log_mel_fast": 0}


@pytest.fixture(scope="module")
def files(cuda, tmp_path_factory):
    """caco_base and audiomae_base written from seeds as released-layout
    files, a tokenizer, an ESC-50 of 5 categories × 8 clips of 2-5 s at
    44.1 kHz (two buckets of 32, the second ragged) and a Clotho of 40
    clips of 15-30 s with 5 captions each."""
    import csv

    from torch_card import write_tokenizer

    root = str(tmp_path_factory.mktemp("eval"))
    caco_dir, mae_dir = write_models(root, SEED + 17)
    rs = np.random.RandomState(SEED + 17)
    esc = write_esc50(os.path.join(root, "esc50"), rs, ESC_CATEGORIES, 8, lambda: rs.uniform(2, 5))
    clotho = os.path.join(root, "clotho")
    os.makedirs(os.path.join(clotho, "evaluation"))
    rows = [["file_name"] + [f"caption_{j}" for j in range(1, 6)]]
    for i in range(CLOTHO_CLIPS):
        write_pcm16(os.path.join(clotho, "evaluation", f"clip_{i:02d}.wav"), 16000,
                    0.1 * rs.randn(int(rs.uniform(15, 30) * 16000)))
        rows.append([f"clip_{i:02d}.wav"] + [f"sound {i} of the set heard in take {j}"
                                              for j in range(5)])
    with open(os.path.join(clotho, "clotho_captions_evaluation.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return {"root": root, "caco": caco_dir, "mae": mae_dir, "esc": esc, "clotho": clotho,
            "tok": write_tokenizer(os.path.join(root, "tok"))}


@pytest.fixture
def eval_env(files, monkeypatch):
    monkeypatch.setenv("CACOPHONY_ESC50_DIR", files["esc"])
    monkeypatch.setenv("CACOPHONY_CLOTHO16K_DIR", files["clotho"])
    return ["--ckpt_path", files["caco"], "--tokenizer", files["tok"], "--batch_size", str(BATCH),
            "--device", "cuda"]


@pytest.mark.parametrize("dtype,expect", [("float32", {"k2_block": 2 * LAYERS, "k1_layer": 0}),
                                          ("bfloat16", {"k1_layer": 2 * LAYERS, "k2_block": 0})])
def test_eval_zero_shot(eval_env, tmp_path, dtype, expect):
    """`python -m cacophony_tpu_torch.eval --task zs` on ESC-50: fp32 on K2,
    bf16 on K1, every layer of both buckets; top-1 in [0, 1], the same in
    --output_json.  fp32: `--expect` with the run's own top-1 passes, and
    with a value moved past its atol exits non-zero."""
    zs = eval_env + ["--task", "zs", "--dataset", "esc50"]
    path = str(tmp_path / "zs.json")
    (res, _), _ = drive(lambda: run_quiet(eval_cli.main, zs + ["--dtype", dtype, "--output_json", path]),
                        {**expect, "k3_block": 0, **NO_VARIANTS})
    with open(path) as f:
        assert json.load(f) == {"task": "zs", "top1_accuracy": res}
    acc = res["esc50"]
    assert 0.0 <= acc <= 1.0
    if dtype == "bfloat16":
        return
    golden = str(tmp_path / "golden.json")
    with open(golden, "w") as f:
        json.dump({"atol": 1e-9, "expect": {"esc50": acc}}, f)
    run_quiet(eval_cli.main, zs + ["--expect", golden])
    with open(golden, "w") as f:
        json.dump({"atol": 0.01, "expect": {"esc50": acc + 0.5 if acc < 0.5 else acc - 0.5}}, f)
    with pytest.raises(SystemExit) as e:
        run_quiet(eval_cli.main, zs + ["--expect", golden])
    assert e.value.code not in (None, 0)


def numpy_retrieval(sim, n_caps):
    """R@1/5/10 and mAP@10 both ways from an (audio, text) score matrix
    whose text j describes audio j // n_caps."""
    n_audio, n_text = sim.shape
    owner = np.arange(n_text) // n_caps
    ta = np.argsort(-sim.T, axis=-1)[:, :10] == owner[:, None]
    at = owner[np.argsort(-sim, axis=-1)[:, :10]] == np.arange(n_audio)[:, None]
    out = {}
    for name, hits in (("text_to_audio", ta), ("audio_to_text", at)):
        ranks = np.arange(1, 11)
        ap = [float((np.cumsum(h)[h] / ranks[h]).mean()) if h.any() else 0.0 for h in hits]
        out[name] = {"R1": hits[:, :1].any(1).mean(), "R5": hits[:, :5].any(1).mean(),
                     "R10": hits.any(1).mean(), "mAP10": float(np.mean(ap))}
    return out


@pytest.mark.parametrize("dtype,expect", [("bfloat16", {"k3_block": 2 * LAYERS, "k1_layer": 0}),
                                          ("float32", {"k3_block": 0, "k1_layer": 0})])
def test_eval_retrieval(eval_env, monkeypatch, dtype, expect):
    """`--task ar --dataset clotho`: bf16 on K3 at 1536 patches, fp32 on the
    einsum route (no kernel); the engine's scores are exp(s)·A@Tᵀ and the
    task's metrics equal numpy's from them."""
    scores = []
    score = CacoEngine.score

    def spy(self, *args, **kw):
        out = score(self, *args, **kw)
        scores.append((args, out))
        return out

    monkeypatch.setattr(CacoEngine, "score", spy)
    (res, _), _ = drive(lambda: run_quiet(eval_cli.main, eval_env + [
        "--dataset", "clotho", "--task", "ar", "--dtype", dtype]),
        {**expect, "k2_block": 0, **NO_VARIANTS})
    ((a, t), sim), = scores
    cfg = configs.caco_base()
    assert a.shape == (CLOTHO_CLIPS, cfg.projection_size) and sim.shape == (CLOTHO_CLIPS,
                                                                             5 * CLOTHO_CLIPS)
    np.testing.assert_allclose(sim, np.exp(cfg.logit_scale_init) * (a.astype(np.float64) @ t.T),
                               rtol=SCORE_TOL[0], atol=SCORE_TOL[1])
    ref = numpy_retrieval(sim, 5)
    assert max(abs(res[d][m]["estimate"] - ref[d][m]) for d in ref for m in ref[d]) <= METRIC_ATOL


def test_eval_captioning(eval_env, tmp_path):
    """`--task caption --dataset clotho` in bf16: K3 in each bucket's audio
    pass; predictions.csv and gt.csv in the reference's format, a row a
    clip."""
    caps = str(tmp_path / "captions")
    ((preds, gts), _), _ = drive(lambda: run_quiet(eval_cli.main, eval_env + [
        "--dataset", "clotho", "--task", "caption", "--dtype", "bfloat16", "--output_dir", caps]),
        {"k3_block": 2 * LAYERS, "k1_layer": 0, "k2_block": 0, **NO_VARIANTS})
    with open(os.path.join(caps, "predictions.csv")) as f:
        pred_csv = f.read()
    with open(os.path.join(caps, "gt.csv")) as f:
        gt_lines = f.read().splitlines()
    assert len(preds) == len(gts) == CLOTHO_CLIPS
    assert pred_csv == "file_name,caption_predicted\n" + "".join(f"{i},{p}\n" for i, p in enumerate(preds))
    assert gt_lines[0] == "file_name," + ",".join(f"caption_reference_{i:02d}" for i in range(1, 6))
    assert len(gt_lines) == CLOTHO_CLIPS + 1


HEAR_SPLITS = {"scene": {"train": 32, "valid": 16, "test": 16}, "event": {"train": 6, "valid": 4, "test": 4}}


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def test_hear_runners_and_probes_on_the_card(files):
    """`hear.runner.run` (caco and audiomae) on a scene task (multiclass, 3
    labels, clips of 2-10 s) and an event task (10-s clips), batches of 8 at
    500 patches in fp32 (K2 on every layer of every batch): 768-d scene
    embeddings, (62, 768) event embeddings at linspace(0, 10000, 62) ms, all
    finite; 2 clips' scene embeddings against the CPU's plain path; K2 on
    caco's first layer's real inputs against its plain version on the
    padded rows (which the event pool averages);
    `predictions_runner.run(grid="faster")` with every probe on the card,
    every score in its range, scikit-learn never imported."""
    root = files["root"]
    tasks = os.path.join(root, "tasks")
    rs = np.random.RandomState(SEED + 19)
    write_hear_task(tasks, "scene-v1.0.0-full", "scene", "multiclass", HEAR_SPLITS["scene"],
                    ["top1_acc", "mAP", "d_prime", "aucroc"], ("dog", "rain", "siren"), rs,
                    lambda: rs.uniform(2, 10))
    write_hear_task(tasks, "event-v1.0.0-full", "event", "multilabel", HEAR_SPLITS["event"],
                    ["segment_1s_er", "event_onset_200ms_fms"], ("beep", "hiss"), rs, lambda: 10.0)
    emb_root = os.path.join(root, "embeddings")
    batches = sum(-(-k // 8) for s in HEAR_SPLITS.values() for k in s.values())
    for name in ("caco", "audiomae"):
        drive(lambda: run_quiet(hear_runner.run, files["caco" if name == "caco" else "mae"], tasks,
                                emb_root, embedding_name=name, batch_size=8, device="cuda"),
              {"k2_block": LAYERS * batches, "k1_layer": 0, "k3_block": 0, "k3_layer": 0})
        for task in os.listdir(tasks):
            d = os.path.join(emb_root, name, task)
            meta = read_json(d, "task_metadata.json")
            for split in meta["splits"]:
                rows, dim = read_json(d, f"{split}.embedding-dimensions.json")
                mm = np.memmap(os.path.join(d, f"{split}.embeddings.npy"), dtype=np.float32,
                               mode="r", shape=(rows, dim))
                assert dim == 768 and np.isfinite(mm).all()
            if meta["embedding_type"] == "event":
                clip = os.path.join(d, "test", "test_00.wav")
                assert np.load(clip + ".embedding.npy").shape == (62, 768)
                assert np.array_equal(read_json(clip + ".timestamps.json"), np.linspace(0, 10000, 62))
    scene = os.path.join(tasks, "scene-v1.0.0-full", "16000", "test")
    names = sorted(os.listdir(scene))[:2]
    paths = [os.path.join(scene, f) for f in names]
    for name, load, cls in (("caco", ckpt_io.load_caco, hear_emb.CacoHearEmbedder),
                            ("audiomae", ckpt_io.load_audiomae, hear_emb.AudioMAEHearEmbedder)):
        mcfg, model = load(files["caco" if name == "caco" else "mae"], device="cpu")
        ref = cls(mcfg, model).scene_embeddings(paths)
        got = np.stack([np.load(os.path.join(emb_root, name, "scene-v1.0.0-full", "test",
                                             f + ".embedding.npy")) for f in names])
        assert cosine_rows(got, ref) >= COS["fp32"], name
        if name == "caco":
            padded_rows_check(mcfg, model, paths)
    trained = []
    train_batch = hear_pred.MLPProbe.train_batch

    def spy(self, *args, **kw):
        trained.append(self)
        return train_batch(self, *args, **kw)

    hear_pred.MLPProbe.train_batch = spy
    try:
        run_quiet(predictions_runner.run, emb_root, grid="faster", device="cuda")
    finally:
        hear_pred.MLPProbe.train_batch = train_batch
    assert trained and {str(next(p.parameters()).device) for p in trained} == {"cuda:0"}
    for name in ("caco", "audiomae"):
        for task in sorted(os.listdir(tasks)):
            d = os.path.join(emb_root, name, task)
            assert os.path.exists(os.path.join(d, "prediction-done.json"))
            res = read_json(d, "test.predicted-scores.json")["test"]
            assert set(res) == set(read_json(d, "task_metadata.json")["evaluation"])
            for score, v in res.items():
                assert (np.isfinite(v) if score == "d_prime" else
                        v >= 0.0 if score == "segment_1s_er" else 0.0 <= v <= 1.0), (name, task, score)
    assert "sklearn" not in sys.modules


@torch.inference_mode()
def padded_rows_check(cfg, cpu_model, paths):
    """K2 on the first layer's real inputs at 500 patches, clips of 2-10 s
    padded to 10 s, against its plain version: the padded query rows."""
    import copy

    model = copy.deepcopy(cpu_model).cuda()
    batch = hear_emb.CacoHearEmbedder(cfg, model)._batch(paths)
    mask = batch["audio_mask"]
    x = audio_input_embedding(model.audio, cfg.audio, batch["audio_patches"],
                              batch["audio_time_inds"], batch["audio_freq_inds"], torch.float32)
    blk, heads = model.audio.blocks[0], cfg.audio.num_heads
    got = ea.fused_block_attention(blk, x, mask, heads, LN_EPS, ("one_shot",))
    ref = ea.fused_block_attention_plain(blk, x, mask, heads, LN_EPS, ("one_shot",))
    pad = mask == 0
    assert pad.any()
    for g, r in zip(got, ref):
        check_close(g[pad], r[pad], tol(torch.float32, "chain"))


# ---- the HF RoBERTa import -----------------------------------------------------

SAFETENSORS_DTYPE = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}


def roberta_tree(cfg, rs):
    """A FlaxRobertaModel tree at cfg's widths, seeded (numpy fp32)."""
    d, inter = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return rs.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def ln():
        return {"scale": 1 + normal(d), "bias": normal(d)}

    def layer():
        return {"attention": {"self": {"query": dense(d, d), "key": dense(d, d),
                                       "value": dense(d, d)},
                              "output": {"dense": dense(d, d), "LayerNorm": ln()}},
                "intermediate": {"dense": dense(d, inter)},
                "output": {"dense": dense(inter, d), "LayerNorm": ln()}}

    return {"embeddings": {"word_embeddings": {"embedding": normal(cfg.vocab_size, d)},
                           "position_embeddings": {"embedding": normal(cfg.max_position_embeddings, d)},
                           "token_type_embeddings": {"embedding": normal(cfg.type_vocab_size, d)},
                           "LayerNorm": ln()},
            "encoder": {"layer": {str(i): layer() for i in range(cfg.num_layers)}},
            "pooler": {"dense": dense(d, d)}}


def roberta_state_dict(tree, prefix="roberta."):
    """The tree in the torch layout: (out, in) Linear weights, LayerNorm
    weight / bias, `*_embeddings.weight`, a position_ids buffer."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(k, k)
            out[prefix + ".".join(path + [leaf])] = torch.from_numpy(
                np.ascontiguousarray(v.T if k == "kernel" else v))

    walk(tree, [])
    out[prefix + "embeddings.position_ids"] = torch.arange(
        tree["embeddings"]["position_embeddings"]["embedding"].shape[0])[None]
    return out


def write_safetensors(path, tensors):
    """The safetensors layout: an 8-byte little-endian header length, a JSON
    header (dtype, shape, data_offsets), then the tensors' bytes."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    tensors = {k: t.contiguous() for k, t in tensors.items() if t.dtype in SAFETENSORS_DTYPE}
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": SAFETENSORS_DTYPE[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.view(-1).view(torch.uint8).numpy().data)


def write_hf_dir(root, cfg, tree, fmt):
    """One HF directory of format fmt with its config.json."""
    d = os.path.join(root, fmt.split(".")[0])
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "roberta", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "type_vocab_size": cfg.type_vocab_size}, f)
    path = os.path.join(d, fmt)
    if fmt == "flax_model.msgpack":
        with open(path, "wb") as f:
            msgpack.dump(tree, f)
    elif fmt == "model.safetensors":
        write_safetensors(path, roberta_state_dict(tree, prefix=""))
    else:
        torch.save(roberta_state_dict(tree), path)
    return d


def test_hf_roberta_import_and_init_text_from_hf(runner_data, tmp_path):
    """A seeded RoBERTa tree at roberta-base width (12 × 768, 12 heads, MLP
    3072, 50 265 words, 514 positions, the HF pooler) in the three HF formats,
    each loaded onto the card into caco_base by `load_hf_text_tower`: the
    tower equals the source bit for bit, the text pooler is kept.  Then
    `runner --init-text-from-hf` for 2 bf16 steps (K4 and K7 once a layer a
    step; two train states written): after step 1 (the rate is 0 at step 0)
    the saved text tower equals the import."""
    data, tok = runner_data
    cfg = configs.caco_base()
    tree = roberta_tree(cfg.text, np.random.default_rng(SEED + 18))
    source = bridge.jax_state_dict(convert.convert_hf_roberta(tree))
    model = caco_init(cfg, torch.Generator().manual_seed(SEED + 18)).cuda()
    pooler = {k: v.clone() for k, v in model.text.pooler.state_dict().items()}
    dirs = {}
    for fmt in hf.FORMATS:
        dirs[fmt] = write_hf_dir(str(tmp_path), cfg.text, tree, fmt)
        with torch.no_grad():
            for k, p in model.text.named_parameters():
                if k.startswith(("embeddings.", "blocks.")):
                    p.zero_()
        hf.load_hf_text_tower(model, dirs[fmt])
        params = dict(model.text.named_parameters())
        assert all(torch.equal(params[k].detach().cpu(), torch.from_numpy(np.asarray(v)))
                   for k, v in source.items()), fmt
    assert all(torch.equal(model.text.pooler.state_dict()[k], v) for k, v in pooler.items())
    del model
    work = str(tmp_path / "work")
    (state, _), _ = drive(lambda: run_quiet(runner.main, runner_argv(
        data, work, "--stage", "caco", "--tokenizer", tok, "--steps", "2", "--total-steps", "5",
        "--warmup-steps", "1", "--checkpoint-every", "1",
        "--init-text-from-hf", dirs["flax_model.msgpack"])),
        {"k4": 2 * LAYERS, "k7": 2 * LAYERS, **PER_STEP})
    assert state.step == 2
    del state
    saved = torch.load(os.path.join(work, "checkpoints", "step_00000001", ckpt_io.TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True, mmap=True)["params"]
    assert all(torch.equal(saved[f"text.{k}"], torch.from_numpy(np.asarray(v)))
               for k, v in source.items())
    del saved
    shutil.rmtree(work)
