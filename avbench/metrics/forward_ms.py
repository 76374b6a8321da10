"""The program's ``train.forward`` span: the model's forward of a training step
(train/trainer.py:_losses; the encoders, fusion and decoder). Device-stream
time between the span's CUDA events, ms per step of the window."""

from ._program import window_per_unit


def read(records: dict, kind: str | None):
    return window_per_unit(records, kind, "train.forward", "device_ms")
