"""The port's rules, checked on every module: nothing of JAX, flax, optax or
the JAX package is imported by ``multimodal_av_model_tpu_torch`` or by
``chip_smoke.py``, not even a numpy-only module (the port keeps its own
copies); and the kernel layer, ``ops/``, imports nothing of the layers above
it.  The check reads each file's syntax tree, so an import inside a
function counts as well."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "multimodal_av_model_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodal_av_model_tpu")
# The port's layers above ops/, which no module of ops/ imports ...
ABOVE_OPS = ("models", "train", "infer", "parallel", "serve", "streaming")
# ... but ops/quantize.py, which walks the model's classes to pick each weight's
# layout: a model transform filed under ops/ as JAX files it (a ROADMAP debt).
OPS_MAY_IMPORT = {f"{PACKAGE}/ops/quantize.py": {"models"}}


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


def _port_imports(tree, path: str):
    """The port's modules that the module at ``path`` (under the package)
    imports, relative or absolute, as dotted names inside the package."""
    package = os.path.dirname(os.path.relpath(path, PACKAGE)).split(os.sep)
    package = [p for p in package if p]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name[len(PACKAGE) + 1:] for a in node.names
                        if a.name.startswith(PACKAGE + "."))
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                if node.module == PACKAGE:
                    yield from (a.name for a in node.names)
                elif node.module.startswith(PACKAGE + "."):
                    yield node.module[len(PACKAGE) + 1:]
                continue
            base = package[:len(package) - node.level + 1]
            if node.module:
                yield ".".join(base + [node.module])
            else:
                yield from (".".join(base + [a.name]) for a in node.names)


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


@pytest.mark.parametrize("path", [p for p in _sources() if p.startswith(f"{PACKAGE}/ops/")])
def test_ops_module_imports_nothing_above_it(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    above = {m.split(".")[0] for m in _port_imports(tree, path)} & set(ABOVE_OPS)
    assert above <= OPS_MAY_IMPORT.get(path, set()), f"{path} imports {sorted(above)}"


def test_the_layer_check_sees_what_it_must():
    tree = ast.parse("from ..models.layers import x\nfrom .. import tracing\n"
                     "def f():\n    from ..train import y\nfrom . import cuda_build\n"
                     f"import {PACKAGE}.serve\nfrom {PACKAGE} import infer\nimport torch\n")
    assert sorted(_port_imports(tree, f"{PACKAGE}/ops/k.py")) == \
        ["infer", "models.layers", "ops.cuda_build", "serve", "tracing", "train"]
