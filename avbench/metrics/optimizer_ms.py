"""The program's ``train.optimizer`` span: a training step's gradient norm and
two-group Adam (train/trainer.py:GroupAdam.step). Device-stream time between
the span's CUDA events, ms per step of the window."""

from ._program import window_per_unit


def read(records: dict, kind: str | None):
    return window_per_unit(records, kind, "train.optimizer", "device_ms")
