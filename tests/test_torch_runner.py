"""The port's training runner on the CPU (`cacophony_tpu_torch.train.runner`,
the counterpart of cacophony_tpu/train/runner.py: stage 2, stage 1 with
`--stage mae`, and stage 2 started from a stage-1 file with
`--init-audio-from-mae`), its train-state checkpoints (save / keep-N /
latest_step / resume) and the metrics and timing utilities — as
tests/test_utils_resume.py holds the JAX package's.

Resume is exact on the CPU in both stages: four steps straight and two
steps plus a resumed two end with the same parameters and AdamW state, bit
for bit (each step's generator is seeded by (seed, step), the loader skips
the batches trained on, AdamW's count and the bf16 first moment
round-trip).
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.checkpoints import bridge, convert, msgpack
from cacophony_tpu_torch.checkpoints.io import latest_step, load_train_state, save_train_state
from cacophony_tpu_torch.data.tokenizer import _bytes_to_unicode
from cacophony_tpu_torch.models.audio import AudioMAE, audiomae_init
from cacophony_tpu_torch.models.caco import caco_init
from cacophony_tpu_torch.train import runner
from cacophony_tpu_torch.train.train import TrainConfig, init_train_state, make_caco_train_step
from cacophony_tpu_torch.utils import MetricsLogger, profiling, trace

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 clips of 0.5-1 s (16-kHz PCM16 and 48-kHz float32) with captions,
    and a byte-level tokenizer directory."""
    root = tmp_path_factory.mktemp("runner")
    d = root / "data"
    d.mkdir()
    rows = [["file_name", "caption"]]
    for i in range(8):
        rs = np.random.RandomState(i)
        sr = 48000 if i % 2 else 16000
        wav = (rs.randn(int(sr * (0.5 + 0.07 * i))) * 0.1).astype(np.float32)
        wavfile.write(str(d / f"c{i}.wav"), sr, wav if i % 2 else (wav * 32767).astype(np.int16))
        rows.append([f"c{i}.wav", f"sound {i}"])
        rows.append([f"c{i}.wav", f"another sound {i}"])
    with open(d / "captions.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    tok = root / "tok"
    tok.mkdir()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in _bytes_to_unicode().values():
        vocab[c] = len(vocab)
    (tok / "vocab.json").write_text(json.dumps(vocab))
    (tok / "merges.txt").write_text("#version: 0.2\n")
    return str(d), str(tok)


def _args(data, workdir, steps):
    data_dir, tok = data
    return ["--stage", "caco", "--data-dir", data_dir, "--workdir", workdir, "--tokenizer", tok,
            "--steps", str(steps), "--total-steps", "4", "--batch-size", "4",
            "--buffer-seconds", "0.5", "--patches-seq-len", "16", "--tiny-model",
            "--device", "cpu", "--warmup-steps", "1", "--checkpoint-every", "0",
            "--log-every", "1"]


def test_runner_two_steps_writes_finite_metrics(data, tmp_path):
    work = str(tmp_path / "work")
    state = runner.main(_args(data, work, 2))
    assert state.step == 2 and state.opt_state.count == 2
    rows = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("loss", "contrastive", "caption", "grad_norm"))
    assert latest_step(os.path.join(work, "checkpoints")) == 2


def test_resumed_run_equals_an_unbroken_one(data, tmp_path, capsys):
    straight = runner.main(_args(data, str(tmp_path / "a"), 4))
    runner.main(_args(data, str(tmp_path / "b"), 2))
    capsys.readouterr()
    resumed = runner.main(_args(data, str(tmp_path / "b"), 4))
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == straight.step == 4
    assert resumed.opt_state.count == straight.opt_state.count == 4
    for (name, a), b in zip(straight.params.state_dict().items(),
                            resumed.params.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.opt_state.mu + straight.opt_state.nu,
                    resumed.opt_state.mu + resumed.opt_state.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert straight.opt_state.mu[0].dtype == torch.bfloat16
    rows = [json.loads(line) for line in open(tmp_path / "b" / "metrics.jsonl")]
    ref = [json.loads(line) for line in open(tmp_path / "a" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert [r["loss"] for r in rows] == [r["loss"] for r in ref]


@pytest.mark.parametrize("argv,message", [(["--init-text-from-hf", "roberta-base"], "HF")])
def test_unported_options_exit_with_a_message(data, tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message):
        runner.main(_args(data, str(tmp_path / "w"), 1) + argv)


@pytest.fixture(scope="module")
def wavs_only(data, tmp_path_factory):
    """The fixture's clips without captions.csv (the MAE stage needs none)."""
    d = tmp_path_factory.mktemp("wavs_only")
    for name in os.listdir(data[0]):
        if name.endswith(".wav"):
            shutil.copy(os.path.join(data[0], name), d / name)
    return str(d)


def _mae_args(data_dir, workdir, steps, dtype="float32"):
    return ["--stage", "mae", "--data-dir", data_dir, "--workdir", workdir,
            "--steps", str(steps), "--total-steps", "4", "--batch-size", "4",
            "--buffer-seconds", "0.5", "--patches-seq-len", "16", "--tiny-model",
            "--device", "cpu", "--warmup-steps", "1", "--checkpoint-every", "0",
            "--log-every", "1", "--dtype", dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mae_stage_writes_finite_metrics(wavs_only, tmp_path, dtype):
    """`--stage mae --tiny-model` trains the tiny AudioMAE from wavs alone
    (no captions, no tokenizer) and logs finite losses."""
    work = str(tmp_path / "work")
    state = runner.main(_mae_args(wavs_only, work, 2, dtype))
    assert isinstance(state.params, AudioMAE) and state.step == 2
    assert state.params.encoder.ln_f.scale.shape == (32,)
    rows = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) >= {"loss", "grad_norm"} and "caption" not in r
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["loss"] > 0
    assert latest_step(os.path.join(work, "checkpoints")) == 2


def test_resumed_mae_run_equals_an_unbroken_one(wavs_only, tmp_path, capsys):
    straight = runner.main(_mae_args(wavs_only, str(tmp_path / "a"), 4))
    runner.main(_mae_args(wavs_only, str(tmp_path / "b"), 2))
    capsys.readouterr()
    resumed = runner.main(_mae_args(wavs_only, str(tmp_path / "b"), 4))
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == straight.step == 4
    for (name, a), b in zip(straight.params.state_dict().items(),
                            resumed.params.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.opt_state.mu + straight.opt_state.nu,
                    resumed.opt_state.mu + resumed.opt_state.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rows = [json.loads(line) for line in open(tmp_path / "b" / "metrics.jsonl")]
    ref = [json.loads(line) for line in open(tmp_path / "a" / "metrics.jsonl")]
    assert [r["loss"] for r in rows] == [r["loss"] for r in ref]


def test_init_audio_from_mae_transplants_the_encoder(data, tmp_path):
    """Stage 2 started from a released-layout stage-1 file: after one step
    (the schedule's rate is 0 at step 0, so no parameter moves) the audio
    tower is the file's encoder bit for bit; the text tower is the seed's."""
    cfg = runner._tiny_mae()
    mae = audiomae_init(cfg.encoder, cfg.decoder, torch.Generator().manual_seed(11))
    ref = convert.audiomae_params_to_reference(bridge.params_to_jax(mae), cfg.encoder.num_heads,
                                               cfg.decoder.num_heads)
    path = msgpack.save_checkpoint(str(tmp_path / "mae"), {"0": {"params": ref}}, step=0)
    plain = runner.main(_args(data, str(tmp_path / "plain"), 1))
    state = runner.main(_args(data, str(tmp_path / "init"), 1) + ["--init-audio-from-mae", path])
    for name, t in mae.encoder.state_dict().items():
        assert torch.equal(state.params.audio.state_dict()[name], t), name
        assert not torch.equal(plain.params.audio.state_dict()[name], t) or t.dim() == 1
    for (name, a), b in zip(plain.params.text.state_dict().items(),
                            state.params.text.state_dict().values()):
        assert torch.equal(a, b), name


def _tiny_state(seed=0):
    cfg = configs.caco_tiny()
    tc = TrainConfig(warmup_steps=0, total_steps=50)
    return cfg, tc, init_train_state(caco_init(cfg, torch.Generator().manual_seed(seed)), tc)


def _tiny_batch(b=4, s=16, t=8, vocab=128):
    rs = np.random.RandomState(0)
    return {
        "audio_patches": torch.from_numpy(rs.randn(b, s, 256).astype(np.float32)),
        "audio_time_inds": (torch.arange(s) // 8).repeat(b, 1),
        "audio_freq_inds": (torch.arange(s) % 8).repeat(b, 1),
        "audio_mask": torch.ones(b, s, dtype=torch.int32),
        "text_input_ids": torch.from_numpy(rs.randint(0, vocab, (b, t)).astype(np.int32)),
        "text_mask": torch.ones(b, t, dtype=torch.int32),
    }


def test_train_state_save_resume(tmp_path):
    """Two steps, save, one more step directly and one from the reloaded
    state: identical parameters and moments."""
    cfg, tc, state = _tiny_state()
    step = make_caco_train_step(cfg, tc)
    batch = _tiny_batch()
    for i in range(2):
        state, _ = step(state, batch, torch.Generator().manual_seed(i))
    ckdir = str(tmp_path / "ck")
    save_train_state(state, ckdir)
    assert latest_step(ckdir) == 2
    direct, _ = step(state, batch, torch.Generator().manual_seed(99))
    resumed = load_train_state(ckdir, _tiny_state(seed=1)[2])
    assert resumed.step == 2 and resumed.opt_state.count == 2
    assert resumed.opt_state.mu[0].dtype == torch.bfloat16
    cont, _ = step(resumed, batch, torch.Generator().manual_seed(99))
    for a, b in zip(direct.params.parameters(), cont.params.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_pruning_and_latest_step(tmp_path):
    _, _, state = _tiny_state()
    ckdir = str(tmp_path / "ck")
    assert latest_step(ckdir) is None
    for s in range(5):
        save_train_state(state._replace(step=s), ckdir, keep=2)
    assert sorted(os.listdir(ckdir)) == ["step_00000003", "step_00000004"]
    assert latest_step(ckdir) == 4
    with pytest.raises(FileNotFoundError):
        load_train_state(str(tmp_path / "none"), state)


def test_metrics_logger(tmp_path, capsys):
    path = str(tmp_path / "m" / "metrics.jsonl")
    log = MetricsLogger(path)
    log.log(step=1, loss=torch.tensor(0.5), lr=1e-4, n=np.int32(3))
    log.log(step=2, loss=0.4)
    rows = [json.loads(line) for line in open(path)]
    assert rows[0]["step"] == 1 and rows[0]["loss"] == 0.5 and rows[0]["n"] == 3
    assert rows[1]["step"] == 2
    assert "step=1 loss=0.5" in capsys.readouterr().out


def test_stage_timer_and_trace(tmp_path):
    """The recorder's report (per-name totals, calls, ms per call) and its
    spans in `trace`'s Chrome trace, on their own track."""
    x = torch.ones(8, 8)
    with profiling.recording() as rec:
        for _ in range(2):
            with profiling.span("matmul"):
                with profiling.span("mm"):
                    x @ x
    assert [s.name for s in rec.spans] == ["matmul", "mm", "matmul", "mm"]
    text = profiling.report(rec)
    assert "matmul: " in text and "2 calls" in text and "ms/call" in text
    with trace(str(tmp_path / "trace")):
        with profiling.span("region"):
            x @ x
    doc = json.load(open(tmp_path / "trace" / "trace.json"))
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["region"] and mine[0]["pid"] == "program spans"
