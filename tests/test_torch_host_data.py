"""The port's host data path against the JAX package's: `resample_fft_host`,
the native WAV / FLAC decoder (the port's own copy, built into
cacophony_tpu_torch/_build/), `read_wav` / `load_audio`, `CacoTrainLoader`
and `prefetch_to_device` on the CPU.

Everything here is compared bit for bit with the JAX package.  Against
scipy.signal.resample the resample is held to 2e-6 on unit-variance input:
scipy 1.17 scales the spectrum before its inverse FFT where both
packages scale the output after it, which moves a few float32 roundings.
"""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import scipy.signal
import torch
from scipy.io import wavfile

if shutil.which("g++") is None:  # pragma: no cover
    pytest.skip("no C++ toolchain", allow_module_level=True)

from test_native import _encode_flac  # noqa: E402  (the repo's FLAC test encoder)

from cacophony_tpu.data import audio_io as jaudio  # noqa: E402
from cacophony_tpu.data import pipeline as jpipe  # noqa: E402
from cacophony_tpu.data import tokenizer as jtok  # noqa: E402
from cacophony_tpu.frontend.dsp import resample_fft_host as jax_resample  # noqa: E402
from cacophony_tpu.native import wavio as jwavio  # noqa: E402
from cacophony_tpu_torch.data import audio_io, pipeline  # noqa: E402
from cacophony_tpu_torch.data import tokenizer as ttok  # noqa: E402
from cacophony_tpu_torch.frontend.dsp import resample_fft_host  # noqa: E402
from cacophony_tpu_torch.native import wavio  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("n_in,n_out", [(44100, 16000), (48000, 16000), (22050, 16000),
                                        (16000, 48000), (1000, 1001), (1001, 500),
                                        (441000, 160000), (999, 1000), (16000, 16000)])
def test_resample_fft_host_matches_jax_and_scipy(n_in, n_out):
    x = np.random.RandomState(n_in + n_out).randn(n_in).astype(np.float32)
    ours = resample_fft_host(x, n_out)
    assert ours.dtype == np.float32 and ours.shape == (n_out,)
    np.testing.assert_array_equal(ours, jax_resample(x, n_out))
    np.testing.assert_allclose(ours, scipy.signal.resample(x, n_out), atol=2e-6, rtol=0)


@pytest.fixture(scope="module")
def audio_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    rs = np.random.RandomState(0)
    x = (rs.randn(22050, 2) * 0.1).astype(np.float32)
    files = {}
    files["pcm16_stereo"] = str(d / "s16.wav")
    wavfile.write(files["pcm16_stereo"], 44100, (x * 32767).astype(np.int16))
    files["pcm16"] = str(d / "m16.wav")
    wavfile.write(files["pcm16"], 16000, (x[:16000, 0] * 32767).astype(np.int16))
    files["pcm32"] = str(d / "m32.wav")
    wavfile.write(files["pcm32"], 8000, (x[:8000, 0] * 2 ** 31).astype(np.int32))
    files["float32"] = str(d / "f32.wav")
    wavfile.write(files["float32"], 48000, x[:, 0])
    ints = [(rs.randn(1500) * 3000).astype(np.int64) for _ in range(2)]
    files["flac_mono"] = str(d / "mono.flac")
    with open(files["flac_mono"], "wb") as f:
        f.write(_encode_flac([ints[0]], 16000, 256, ["verbatim", "fixed2", "fixed1"]))
    files["flac_stereo"] = str(d / "stereo.flac")
    with open(files["flac_stereo"], "wb") as f:
        f.write(_encode_flac(ints, 22050, 512, ["fixed1"], stereo_mode="mid_side", porder=2))
    return files


def test_native_decode_equals_jax(audio_files):
    """The port's decoder (built from its own copy of the sources) gives the
    JAX package's samples and rates bit for bit, file by file and batched."""
    assert os.path.basename(wavio.library_path()).startswith("libcaco_wavio_")
    for name, path in audio_files.items():
        ours, sr = wavio.read_wav(path)
        theirs, jsr = jwavio.read_wav(path)
        assert sr == jsr and ours.dtype == np.float32, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    paths = list(audio_files.values()) + ["/nonexistent.wav"]
    for a, b in zip(wavio.decode_batch(paths, 20000), jwavio.decode_batch(paths, 20000)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="native wav decode failed"):
        wavio.read_wav("/nonexistent.wav")


def test_read_wav_and_load_audio_equal_jax(audio_files, tmp_path):
    for name, path in audio_files.items():
        a, sr = audio_io.read_wav(path)
        b, jsr = jaudio.read_wav(path)
        assert sr == jsr
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(audio_io.load_audio(path), jaudio.load_audio(path))
    # the configured rate takes precedence over the header's, with a warning
    path = audio_files["float32"]
    with pytest.warns(UserWarning, match="configured rate"):
        ours = audio_io.load_audio(path, expected_sr=44100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = jaudio.load_audio(path, expected_sr=44100)
    assert len(ours) == round(22050 * 16000 / 44100)
    np.testing.assert_array_equal(ours, theirs)
    # a file the native decoder refuses (64-bit PCM) is read by scipy, as in
    # the JAX package
    odd = str(tmp_path / "pcm64.wav")
    wavfile.write(odd, 16000, np.arange(-50, 50, dtype=np.int64) * 2 ** 40)
    with pytest.raises(ValueError):
        wavio.read_wav(odd)
    a, sr = audio_io.read_wav(odd)
    b, jsr = jaudio.read_wav(odd)
    assert sr == jsr == 16000 and a.shape == (100,)
    np.testing.assert_array_equal(a, b)
    buf, n = audio_io.pad_to_buffer(np.ones(10, np.float32), 16)
    jbuf, jn = jaudio.pad_to_buffer(np.ones(10, np.float32), 16)
    assert n == jn == 10
    np.testing.assert_array_equal(buf, jbuf)


@pytest.fixture(scope="module")
def train_files(tmp_path_factory):
    """10 clips: 16-kHz PCM16 mono, 44.1-kHz PCM16 stereo, 48-kHz float32,
    and a 96-kHz clip (above 3 × 16 kHz: the per-file fallback); 1-3
    captions each, synthetic captions for some; a tokenizer directory."""
    d = tmp_path_factory.mktemp("train")
    rs = np.random.RandomState(1)
    paths, captions, synthetic = [], {}, {}
    rates = [16000, 44100, 48000, 16000, 44100, 48000, 96000, 16000, 44100, 48000]
    for i, sr in enumerate(rates):
        n = int(sr * rs.uniform(0.2, 0.6))
        x = (rs.randn(n, 2 if sr == 44100 else 1) * 0.1).astype(np.float32)
        path = str(d / f"clip{i}.wav")
        if sr == 48000:
            wavfile.write(path, sr, x[:, 0])
        else:
            wavfile.write(path, sr, (x * 32767).astype(np.int16).squeeze())
        paths.append(path)
        captions[f"clip{i}"] = [f"sound number {i} take {k}" for k in range(1 + i % 3)]
        if i % 2:
            synthetic[f"clip{i}"] = [f"synthetic {i}"]
    tok = d / "tok"
    tok.mkdir()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in ttok._bytes_to_unicode().values():
        vocab[c] = len(vocab)
    (tok / "vocab.json").write_text(json.dumps(vocab))
    (tok / "merges.txt").write_text("#version: 0.2\n")
    return paths, captions, synthetic, str(tok)


@pytest.mark.parametrize("start_batch", [0, 2])
def test_train_loader_equals_jax(train_files, start_batch):
    """The same files, seed and tokenizer directory give the same batches
    as JAX's CacoTrainLoader, across an epoch boundary and resumed at
    start_batch=2 (batches 0 and 1 skipped without decoding them)."""
    paths, captions, synthetic, tok_dir = train_files
    kw = dict(batch_size=3, buffer_seconds=0.5, max_text_len=12, seed=5)
    ours = pipeline.CacoTrainLoader(paths, captions, ttok.load_tokenizer(tok_dir),
                                    pipeline.TrainDataConfig(**kw), synthetic_captions=synthetic)
    theirs = jpipe.CacoTrainLoader(paths, captions, jtok.load_tokenizer(tok_dir),
                                   jpipe.TrainDataConfig(**kw), synthetic_captions=synthetic)
    ours.start_batch = theirs.start_batch = start_batch
    before = dict(pipeline.DECODE_COUNTS)
    n_batches = 5
    for a, b in zip(_take(ours, n_batches), _take(theirs, n_batches)):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    decoded = {k: pipeline.DECODE_COUNTS[k] - before[k] for k in before}
    assert sum(decoded.values()) == n_batches * 3  # skipped batches are not decoded
    assert decoded["fallback"] >= 1  # the 96-kHz clip went through load_audio


def _take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def test_prefetch_to_device_on_the_cpu():
    batches = [{"a": np.full((2, 3), i, np.float32), "b": np.arange(4, dtype=np.int32) + i}
               for i in range(5)]
    out = list(pipeline.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, o in enumerate(out):
        assert o["a"].dtype == torch.float32 and o["b"].dtype == torch.int32
        np.testing.assert_array_equal(o["a"].numpy(), batches[i]["a"])
        np.testing.assert_array_equal(o["b"].numpy(), batches[i]["b"])


def test_ten_seconds_at_44_1_khz_come_out_at_160000_samples(tmp_path):
    path = str(tmp_path / "long.wav")
    wavfile.write(path, 44100, (np.random.RandomState(2).randn(441000, 2) * 3000).astype(np.int16))
    loader = pipeline.CacoTrainLoader([path], {"long": ["x"]}, None,
                                      pipeline.TrainDataConfig(batch_size=1, buffer_seconds=10.0))
    bufs, lens = loader._decode([path])
    assert lens.tolist() == [160000]
    ref = jpipe.CacoTrainLoader([path], {"long": ["x"]}, None,
                                jpipe.TrainDataConfig(batch_size=1, buffer_seconds=10.0))
    np.testing.assert_array_equal(bufs, ref._decode([path])[0])
