#!/usr/bin/env python3
"""The port's smoke on a card: every `cuda`-marked test in this process,
then each kernel's time, then two JSON lines.

    python3 chip_smoke.py [pytest arguments, e.g. -m "cuda and not slow"]

The tests are the card modules (`CARD_MODULES`, run with --noconftest:
tests/conftest.py configures JAX, which the card's machine lacks); the
checks and their bounds are theirs.  Every main path a test drives through
`tests/torch_card.py:drive` is recorded with its launch counts, zeroed just
before it and read just after.  The times are `scripts/kernel_times.py`'s
kernel rows on this tree.

The line before the last is {"kernels": [...], "rows": [...]}: for each
TPU kernel (K1, K2, K3, K3′, K4, K5, K6, K7, K8, K8′) and `table_grad`,
its sources, the Pallas function it replaces, its launch counter, the
paths that launched it ([test id, launches] in the order run), and the
`TIMES` of kernel_times' row named in `row` (a chain's `device_ms` is the
card's time, its `ms` may be the host's pace); "rows" holds every
kernel_times row.  The last line is
{"ok": true, "device": {...}}.  A failed test ends the run with exit
code 1 and neither line.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD_MODULES = ["tests/test_torch_cuda.py", "tests/test_torch_cuda_engine.py",
                "tests/test_torch_cuda_train.py", "tests/test_torch_cuda_files.py",
                "tests/test_torch_cuda_parallel.py", "tests/test_torch_profiling.py",
                "tests/test_torch_text_pooler.py"]
CSRC = "cacophony_tpu_torch/csrc/"
CHAIN = ", ".join(CSRC + f for f in ("layer_norm.cu", "gemm.cu", "attention.cu"))
EA, FRONT = "cacophony_tpu/ops/encoder_attention.py", "cacophony_tpu/frontend/fused.py"
# name → (sources, the Pallas function it replaces, launch counter, kernel_times row)
KERNELS = {
    "K1": (CHAIN, f"{EA}:594", "k1_layer", "K1"),  # _pallas_fused_block, with_mlp=True
    "K2": (CHAIN, f"{EA}:594", "k2_block", "K2"),  # the same, with_mlp=False
    "K3": (CHAIN, f"{EA}:763", "k3_block", "K3"),  # _pallas_fused_block_blocked
    "K3′": (CHAIN, f"{EA}:763", "k3_layer", "K3′"),  # the same, with_mlp=True
    "K4": (CSRC + "attention.cu", f"{EA}:317", "k4", "K4 bf16"),  # _pallas_forward
    "K5": (CSRC + "attention.cu", f"{EA}:351", "k5", "K5"),  # _pallas_forward_blocked
    "K6": (CHAIN, f"{EA}:411", "k6_attn", "K6"),  # _pallas_fused_ln
    "K7": (CSRC + "attention_bwd.cu", f"{EA}:1147", "k7", "K7"),  # _pallas_backward
    "K8": (CSRC + "log_mel.cu", f"{FRONT}:153", "log_mel", "K8 1000"),
    "K8′": (CSRC + "log_mel.cu", f"{FRONT}:153", "log_mel_fast", "K8′ 1000"),
    "table_grad": (CSRC + "table_grad.cu", "none: the gather's backward", "table_grad",
                   "table_grad"),
}
TIMES = ("ms", "device_ms", "host_us", "plain_ms", "library_ms", "bound_ms", "bound_by", "share")


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import pytest
    import torch
    import torch_card  # the module the tests import, so its PATHS are theirs

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    rc = pytest.main([os.path.join(ROOT, m) for m in CARD_MODULES]
                     + ["-m", "cuda", "--noconftest", "-p", "no:cacheprovider", "-q"]
                     + sys.argv[1:])
    if rc != 0:
        print(f"FAIL: the card tests exited {rc}", file=sys.stderr)
        return 1
    gc.collect()
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "kernel_times", os.path.join(ROOT, "scripts", "kernel_times.py"))
    kt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kt)
    rows = []
    kt.measure(ROOT, ["kernels"], rows.append)
    by_name = {r["row"]: r for r in rows if "row" in r}
    kernels = []
    for name, (src, replaces, key, row) in KERNELS.items():
        paths = [[path, got[key]] for path, got in torch_card.PATHS if got.get(key)]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "counter": key, "launches": sum(n for _, n in paths), "paths": paths,
                        "row": row, **{k: by_name[row].get(k) for k in TIMES}})
    print(json.dumps({"kernels": kernels, "rows": rows}, default=float))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
