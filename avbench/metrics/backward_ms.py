"""The program's ``train.backward`` span: a training step's backward
(train/trainer.py:train_step, total.backward()). Device-stream time between the
span's CUDA events, ms per step of the window."""

from ._program import window_per_unit


def read(records: dict, kind: str | None):
    return window_per_unit(records, kind, "train.backward", "device_ms")
