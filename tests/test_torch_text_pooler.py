"""The text pooler's 1/√d scale: `text_pooler_apply` fills √d on the
hidden states' device, where it once copied a host tensor there.  Against
the copied divisor it must be the same bits, in the output and in the
gradients, in bf16 as in fp32.  The `cuda` cases run the same on the card
(they skip without one; the file imports no JAX):

    python -m pytest tests/test_torch_text_pooler.py --noconftest -q
"""

import pytest
import torch

from cacophony_tpu_torch.configs import TextConfig
from cacophony_tpu_torch.models.layers import dense
from cacophony_tpu_torch.models.text import TextPooler, text_pooler_apply


def _copied_divisor_pooler(p, hidden, mask, dtype):
    """The pooler as it was: √d from a host tensor copied to hidden's device."""
    d = hidden.shape[-1]
    key = dense(p.key, hidden, dtype) / torch.sqrt(
        torch.tensor(float(d), dtype=hidden.dtype, device=hidden.device))
    value = dense(p.value, hidden, dtype)
    logits = torch.einsum("mh,bnh->bmn", p.query.to(hidden.dtype), key)
    logits = torch.where(mask[:, None] > 0, logits.float(), torch.finfo(torch.float32).min)
    w = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
    return torch.einsum("bmn,bnh->bmh", w, value)[:, 0]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,seed", [(48, 1), (768, 2)])
def test_pooler_scale_is_bit_identical_to_the_copied_divisor(d, seed, dtype, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(seed)
    cfg = TextConfig(vocab_size=16, hidden_size=d, num_layers=1, num_heads=1,
                     intermediate_size=d)
    pooler = TextPooler(cfg, gen).to(device)
    hidden = (3 * torch.randn(5, 19, d, generator=gen)).to(device, dtype)
    mask = (torch.arange(19)[None] < torch.tensor([19, 7, 1, 12, 3])[:, None]).to(device,
                                                                                torch.int32)
    cot = torch.randn(5, d, generator=gen).to(device, dtype)
    out, grads = {}, {}
    for name, fn in (("filled", lambda: text_pooler_apply(pooler, h, mask, dtype)),
                     ("copied", lambda: _copied_divisor_pooler(pooler, h, mask, dtype))):
        pooler.zero_grad(set_to_none=True)
        h = hidden.clone().requires_grad_()
        out[name] = fn()
        (out[name] * cot).sum().backward()
        grads[name] = [pooler.key.w.grad, pooler.key.b.grad, h.grad]
    assert out["filled"].dtype == dtype
    assert torch.equal(out["filled"], out["copied"])
    for got, want in zip(grads["filled"], grads["copied"]):
        assert got is not None and torch.equal(got, want)
