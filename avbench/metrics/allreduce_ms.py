"""The gradient all-reduce of a data-parallel training step
(train/trainer.py: ``MultiSpeakerTrainer._average_grads``: flatten, NCCL
all-reduce, copy back): device-stream time between CUDA events recorded
around the call on rank 0, ms per step of the traced window.  Rank 0's
all-reduce also waits there for the slowest rank."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "allreduce", kind)
