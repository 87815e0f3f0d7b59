"""The import guard compares top-level names whole, and nothing of the
benchmark imports JAX or the JAX package."""

import subprocess
import sys
import types

from portbench import harness
from tiny_cells import ROOT


def test_guard_compares_whole_names(monkeypatch):
    for name in ("cacophony_tpu_torch_x", "cacophony_tpu_torch_x.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in harness.forbidden_modules()
                if m.startswith(("cacophony_tpu_torch_x", "jaxtyping", "flaxen"))]
    monkeypatch.setitem(sys.modules, "cacophony_tpu.models", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert {"cacophony_tpu.models", "jaxlib"} <= set(harness.forbidden_modules())


def test_the_benchmark_loads_no_jax():
    """Every module and file of the benchmark, and the program's modules a
    run imports, in a fresh process: no JAX, no JAX package."""
    code = (
        "import glob, os, sys\n"
        "from portbench import calibrate, frozen, harness, plain, port, run, training, work\n"
        "import cacophony_tpu_torch.runtime.engine, cacophony_tpu_torch.runtime.gallery\n"
        "import cacophony_tpu_torch.train.train, cacophony_tpu_torch.data.pipeline\n"
        "for f in sorted(glob.glob('portbench/*/*.py')):\n"
        "    if '/tests/' not in f: harness.load_file(f)\n"
        "bad = harness.forbidden_modules()\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_card_no_result(tmp_path):
    """Without a card (this machine), or in a directory without the
    program, a run exits 2 and prints no result."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "caco_base.embed_10s",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
