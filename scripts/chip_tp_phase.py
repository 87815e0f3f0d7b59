"""Phase 19 of chip_smoke.py alone: build the kernels, then the tensor-parallel phase.

    python3 scripts/chip_tp_phase.py [gloo|nccl]

gloo (the default) puts both ranks on card 0; nccl puts a rank a card and
needs a machine with two cards or more.  The phase's summary goes to
chiprun_out/p19_<backend>.json.
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from cacophony_tpu_torch import configs  # noqa: E402

if __name__ == "__main__":
    t0 = time.time()
    label = cs.gpu_label()
    backend = sys.argv[1] if len(sys.argv) > 1 else "gloo"
    print(f"gpu: {label}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} cards; {backend}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.kern.load_library()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    try:
        errs, launches, out = cs.tp_phase(configs.caco_base(), label, backend)
    except cs.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
    os.makedirs("chiprun_out", exist_ok=True)
    json.dump({"errs": errs, "launches": launches, "out": out}, open(f"chiprun_out/p19_{backend}.json", "w"),
              default=str, indent=1)
    print(f"total {time.time() - t0:.1f} s")
