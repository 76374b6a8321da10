"""No module that a run of the harness loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``multimodal_av_model_tpu`` (compared whole: the port
is ``multimodal_av_model_tpu_torch``); the reference imports nothing of the
system under test; a run on a card, where there is one."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from avbench import harness

CHILD = """
import sys, json, torch
torch.set_num_threads(2)
from avbench import harness, run, calibrate
from avbench.tests.tiny import tiny_cell
for name in ("av_flagship.train_b8", "av_flagship.transcribe_b4"):
    harness.run(tiny_cell(name), 3, 0.3, True, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_a_run():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "multimodal_av_model_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_system():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                        else [])
                for m in mods:
                    assert m.split(".")[0] in ("torch", "numpy", "math", "__future__"), (name, m)


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "avbench.run", "--workload",
                          "av_flagship.transcribe_b4", "--seed", "2147483999", "--seconds", "2",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "avbench.run", "--workload",
                          "av_flagship.train_b8", "--seed", "1", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
