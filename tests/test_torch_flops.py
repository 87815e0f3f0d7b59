"""The port's FLOP counters (`cacophony_tpu_torch/utils/flops.py`) against
the JAX package's: every counter gives JAX's integer on caco_tiny,
caco_base and audiomae_base's encoder, at several lengths, with
`remat_encoder` on and off; the bf16 peaks by device name; the kernels'
least times (`bound`, `attn_flops`) against the benchmark's frozen copy."""

import numpy as np
import pytest

from cacophony_tpu import configs as jcfg
from cacophony_tpu.utils import flops as jflops
from cacophony_tpu_torch import configs as tcfg
from cacophony_tpu_torch.utils import flops as tflops
from portbench import frozen

MODELS = ["caco_tiny", "caco_base"]
SEQS = [1, 100, 496, 1536]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("seq", SEQS)
def test_model_counters_equal_jax(model, seq):
    j, t = getattr(jcfg, model)(), getattr(tcfg, model)()
    assert tflops.encoder_matmul_flops(t.audio, seq) == jflops.encoder_matmul_flops(j.audio, seq)
    assert tflops.pooler_matmul_flops(t, seq) == jflops.pooler_matmul_flops(j, seq)
    assert tflops.text_pooler_matmul_flops(t, seq) == jflops.text_pooler_matmul_flops(j, seq)
    for memory in (0, seq, 500):
        assert (tflops.text_matmul_flops(t.text, seq, memory)
                == jflops.text_matmul_flops(j.text, seq, memory))
        assert (tflops.text_matmul_flops(t.decoder, seq, memory_seq=memory)
                == jflops.text_matmul_flops(j.decoder, seq, memory_seq=memory))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("audio_seq,text_seq", [(100, 12), (500, 100), (1536, 64)])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_counter_equals_jax(model, audio_seq, text_seq, remat):
    j, t = getattr(jcfg, model)(), getattr(tcfg, model)()
    got = tflops.caco_train_step_matmul_flops(t, audio_seq, text_seq, remat_encoder=remat)
    assert got == jflops.caco_train_step_matmul_flops(j, audio_seq, text_seq, remat_encoder=remat)
    assert isinstance(got, int) and got > 0


@pytest.mark.parametrize("seconds,seq", [(1, 48), (10, 496), (10, 500), (30, 1536)])
def test_frontend_and_pipeline_counters_equal_jax(seconds, seq):
    jf, tf = jcfg.FrontendConfig(), tcfg.FrontendConfig()
    n = seconds * jf.sample_rate + 123
    assert tflops.frontend_matmul_flops(tf, n) == jflops.frontend_matmul_flops(jf, n)
    for model in MODELS:
        j, t = getattr(jcfg, model)(), getattr(tcfg, model)()
        assert (tflops.pipeline_matmul_flops(t, tf, tcfg.PatchConfig(patches_seq_len=seq), n)
                == jflops.pipeline_matmul_flops(j, jf, jcfg.PatchConfig(patches_seq_len=seq), n))


@pytest.mark.parametrize("seq", [100, 500])
def test_audiomae_encoder_counter_equals_jax(seq):
    j, t = jcfg.audiomae_base(), tcfg.audiomae_base()
    assert (tflops.encoder_matmul_flops(t.encoder, seq)
            == jflops.encoder_matmul_flops(j.encoder, seq))


def test_device_peaks():
    assert tflops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tflops.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert tflops.device_peak_flops("NVIDIA H100 NVL") == 835e12
    assert tflops.device_peak_flops("cpu") is None
    for kind in ("TPU v5e", "TPU v5 lite", "TPU v4", "TPU v6e", "TPU v5p", "TPU v3", "cpu"):
        assert tflops.device_peak_flops(kind) == jflops.device_peak_flops(kind), kind


# K1's QKV link at the 10-s bucket (bf16, M = 32·496), K2's in fp32, and
# K7 at the training step's (B=16, S=500, 8 heads of Dh 96): operations,
# bytes (each input read once, each output written once) and key lengths.
M10, D = 32 * 496, 768
LINKS = {
    "k1_qkv": ("bf16", 2 * M10 * 3 * D * D, 2 * (M10 * D + D * 3 * D + M10 * 3 * D) + 4 * 3 * D),
    "k2_qkv": ("fp32", 2 * M10 * 3 * D * D, 4 * (M10 * D + D * 3 * D + M10 * 3 * D)),
}


@pytest.mark.parametrize("link", sorted(LINKS))
def test_bound_equals_the_frozen_least_time(link):
    kind, ops, nbytes = LINKS[link]
    ms, by = tflops.bound({kind: ops}, nbytes)
    assert ms == frozen.least_seconds(ops, nbytes, kind) * 1e3
    assert by == ("operations" if ops / frozen.PEAK[kind] >= nbytes / frozen.HBM_BYTES_PER_S
                  else "bytes")
    assert tflops.PEAK == frozen.PEAK and tflops.HBM_BYTES_PER_S == frozen.HBM_BYTES_PER_S


@pytest.mark.parametrize("b,s,heads,hd,products", [(32, 496, 8, 96, 2), (16, 500, 8, 96, 5)])
def test_attn_flops_equals_the_frozen_count(b, s, heads, hd, products):
    """The K1 attention link at the 10-s bucket and K7 at the step's shape,
    over ragged key lengths; K7's bound over its bytes as the frozen copy
    takes it."""
    valid = np.random.RandomState(0).randint(s // 10, s + 1, size=b)
    ops = tflops.attn_flops(heads, hd, s, valid, products)
    assert ops == frozen.attn_flops(heads, hd, s, int(valid.sum()), products)
    nbytes = 2 * b * s * 7 * heads * hd
    assert tflops.bound({"bf16": ops}, nbytes)[0] == frozen.least_seconds(ops, nbytes, "bf16") * 1e3
