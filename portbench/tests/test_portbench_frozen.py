"""The frozen counters and peaks against the port's and the model code."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.utils import flops
from portbench import frozen
from tiny_cells import _config


def test_counters_equal_the_ports():
    c = configs.caco_base()
    d = _config("caco_base")
    front = configs.FrontendConfig()
    assert frozen.pipeline_matmul_flops(d, d["frontend"], 496, 160_000) == \
        flops.pipeline_matmul_flops(c, front, configs.PatchConfig(patches_seq_len=496), 160_000) \
        == 95_169_253_888
    assert frozen.caco_train_step_matmul_flops(d, 500, 100) == \
        flops.caco_train_step_matmul_flops(c, 500, 100) == 398_260_090_368
    for s in (100, 496, 1536):
        assert frozen.encoder_matmul_flops(d["audio"], s) == flops.encoder_matmul_flops(c.audio, s)
        assert frozen.text_matmul_flops(d["text"], s) == flops.text_matmul_flops(c.text, s)


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA H100 PCIe", 756e12), ("NVIDIA H100 NVL", 835e12),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_peaks(name, peak):
    assert frozen.device_peak_flops(name) == peak
    if peak is not None:
        assert frozen.device_peak_flops(name) == flops.device_peak_flops(name)


def test_stage1_counter_against_the_model():
    """3 × the matmul FLOP torch counts in the port's stage-1 forward, one
    clip of 500 valid patches (100 visible), equals the frozen counter."""
    from cacophony_tpu_torch.models.audio import AudioMAE, audiomae_apply

    cfg = configs.audiomae_base()
    model = AudioMAE(cfg.encoder, cfg.decoder)
    s, keep = 500, 100
    ones = torch.ones(1, keep, dtype=torch.int32)
    inds = torch.arange(s, dtype=torch.int32)[None]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        audiomae_apply(model, cfg.encoder, cfg.decoder, torch.zeros(1, keep, 256), ones,
                       inds[:, :keep] // 8, inds[:, :keep] % 8, inds[:, keep:] // 8,
                       inds[:, keep:] % 8, torch.ones(1, s - keep, dtype=torch.int32))
    counted = fc.get_total_flops()
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    assert 3 * counted == frozen.mae_train_step_matmul_flops(d, s, cfg.mask_ratio) == 335_580_364_800
