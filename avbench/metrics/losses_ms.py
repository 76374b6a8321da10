"""The program's ``train.losses`` span: the loss terms of a training step
(train/trainer.py:_losses: contrastive x2, CTC x2 with F.ctc_loss's length
copies). Device-stream time between the span's CUDA events, ms per step of the
window."""

from ._program import window_per_unit


def read(records: dict, kind: str | None):
    return window_per_unit(records, kind, "train.losses", "device_ms")
