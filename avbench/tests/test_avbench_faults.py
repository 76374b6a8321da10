"""``correct`` must come out false when the timed path is broken underneath,
and for the control: a run at a tiny float32 size on the CPU (the look for a
card skipped) with one fault planted in the system, judged by the cell's own
limits.  Faults: a training step that leaves its state unchanged; half of
the batch left out, the mean taken over the rest; a token altered where the
decode produces it.  A single-chip cell has no exchange between chips to
leave out.  Control: the reference on float8 operands in the program's place
stands apart from the program here, and fails the cell's limits on the card
(a ``gpu`` test), on three seeds each; so does the program's own int8
serving path in the transcription cells."""

from __future__ import annotations

import pytest
import torch

from avbench import calibrate, harness
from avbench.faults import FAULTS, planted
from avbench.tests.tiny import tiny_cell

TRAIN = ["av_flagship.train_b8", "av_flagship_tf.train_b32"]
TRANSCRIBE = ["av_flagship.transcribe_b4", "av_flagship_tf.transcribe_b4"]


def run(name, seed=5):
    torch.set_num_threads(2)
    return harness.run(tiny_cell(name), seed, 0.5, False, "cpu")


@pytest.mark.parametrize("name", TRAIN + TRANSCRIBE)
def test_sound_run_is_correct(name):
    assert run(name)["correct"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAIN for f in FAULTS["train"]]
                         + [(n, f) for n in TRANSCRIBE for f in FAULTS["transcribe"]])
def test_fault_is_caught(name, fault):
    with planted(fault, "train" if name in TRAIN else "transcribe"):
        assert not run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN + TRANSCRIBE)
def test_control_stands_apart(name):
    """At this size the program computes in float32 on the CPU, far inside
    the cell's limits, and fp8's error is smaller than at full size: the
    control must read ten times the program on a compared number."""
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    for seed in (1, 2, 2**31 + 3):
        prog = {k: v["value"] for k, v in harness.run(cell, seed, 0.3, False, "cpu")[
            "checks"].items()}
        ctl = calibrate.controls(cell, seed, "cpu")["fp8"]
        assert any(ctl[k] > 10 * max(prog[k], 1e-6) for k in ctl if k in cell.limits["limits"]), \
            (seed, prog, ctl)


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAIN + TRANSCRIBE)
def test_control_fails_the_limits_on_the_card(name):
    """At the cell's own size on the card, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell.find(name)
    limits = cell.limits["limits"]
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        for kind, ctl in calibrate.controls(cell, seed, "cuda").items():
            assert any(ctl[k] > limits[k] for k in ctl if k in limits), (seed, kind, ctl)
