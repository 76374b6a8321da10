"""The port's rule, checked on every module: nothing of JAX, flax, optax or
the JAX package is imported by ``multimodal_av_model_tpu_torch`` or by
``chip_smoke.py``, not even a numpy-only module (the port keeps its own
copies).  The check reads each file's syntax tree, so an import inside a
function counts as well."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "multimodal_av_model_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodal_av_model_tpu")


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PACKAGE)):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources())
def test_port_module_imports_nothing_of_jax(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted(m for m in _imported(tree) if _forbidden(m))
    assert not bad, f"{path} imports {bad}"


def test_the_check_sees_what_it_must():
    tree = ast.parse("import jax.numpy as jnp\nfrom multimodal_av_model_tpu.ops import ctc\n"
                     "def f():\n    import optax\nfrom multimodal_av_model_tpu_torch import x\n"
                     "from . import y\n")
    assert sorted(m for m in _imported(tree) if _forbidden(m)) == \
        ["jax.numpy", "multimodal_av_model_tpu.ops", "optax"]
    assert len(_sources()) > 30 and "chip_smoke.py" in _sources()
