"""Training: the flagship train and eval steps, checkpoints, the finite guard."""

from .checkpoints import (
    CheckpointManager,
    graft_subtree,
    restore_checkpoint,
    save_checkpoint,
)
from .profiling import NonFiniteLossError, check_finite
from .trainer import GroupAdam, MultiSpeakerTrainer, TrainState, label_params, make_lr_schedule

__all__ = [
    "CheckpointManager",
    "GroupAdam",
    "MultiSpeakerTrainer",
    "NonFiniteLossError",
    "TrainState",
    "check_finite",
    "graft_subtree",
    "label_params",
    "make_lr_schedule",
    "restore_checkpoint",
    "save_checkpoint",
]
