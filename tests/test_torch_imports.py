"""The port's import surface against the JAX package's: every name a JAX
`__init__` exports (its imports and its lazy top-level names) is exported
by the port's `__init__` of the same package, and resolves, except for the
explicit lists below.  Later slices shrink the lists as they port.

The names are read from the `__init__` sources with `ast`, so the JAX
packages are not imported; the port's are, to resolve every name.
"""

import ast
import importlib
import os

import pytest

import cacophony_tpu
import cacophony_tpu_torch

JAX_ROOT = os.path.dirname(cacophony_tpu.__file__)
PORT_ROOT = os.path.dirname(cacophony_tpu_torch.__file__)

# JAX subpackages the port has not reached (ROADMAP.md queue A): none left.
UNPORTED_PACKAGES = {}
# Names of a ported package that the port leaves out, and why.
LEFT_OUT = {
    "ops": {"attention_init": "JAX-only: the port's parameters are nn.Modules"},
    "utils": {"StageTimer": "the port's one recorder (utils/profiling.py: span, report) "
                            "replaces it: a stage timer synchronises the card",
              "annotate": "the port's one recorder: `span` in place of a profiler range"},
}
# Names the port exports where the JAX package has no counterpart.
PORT_ONLY = {
    "checkpoints": {"jax_state_dict", "params_from_jax"},  # the parameter bridge
}


def _exports(init_path):
    """Names an __init__ binds by import, and the names its module-level
    __getattr__ answers."""
    tree = ast.parse(open(init_path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and isinstance(sub.comparators[0], ast.Constant):
                    names.add(sub.comparators[0].value)
    names.discard("annotations")  # from __future__
    return names


def _subpackages(root):
    return sorted(d for d in os.listdir(root)
                  if os.path.isfile(os.path.join(root, d, "__init__.py")))


def test_unported_packages_are_the_listed_ones():
    missing = set(_subpackages(JAX_ROOT)) - set(_subpackages(PORT_ROOT))
    assert missing == set(UNPORTED_PACKAGES)


@pytest.mark.parametrize("package", [""] + [p for p in _subpackages(JAX_ROOT)
                                            if p not in UNPORTED_PACKAGES])
def test_package_exports_match_jax(package):
    jax_names = _exports(os.path.join(JAX_ROOT, package, "__init__.py"))
    port_names = _exports(os.path.join(PORT_ROOT, package, "__init__.py"))
    left_out = set(LEFT_OUT.get(package, {}))
    assert left_out <= jax_names  # a stale entry is a test failure too
    assert port_names - PORT_ONLY.get(package, set()) == jax_names - left_out
    module = importlib.import_module("cacophony_tpu_torch" + (f".{package}" if package else ""))
    for name in port_names:
        assert getattr(module, name) is not None, name


def test_lazy_top_level_names_resolve():
    from cacophony_tpu_torch.checkpoints.io import load_audiomae, load_caco
    from cacophony_tpu_torch.data.tokenizer import load_tokenizer
    from cacophony_tpu_torch.runtime.engine import CacoEngine

    assert cacophony_tpu_torch.load_audiomae is load_audiomae
    assert cacophony_tpu_torch.load_caco is load_caco
    assert cacophony_tpu_torch.load_tokenizer is load_tokenizer
    assert cacophony_tpu_torch.CacoEngine is CacoEngine
    with pytest.raises(AttributeError):
        cacophony_tpu_torch.no_such_name
