"""Training: the flagship train and eval steps, the audio-only, visual-only,
SSL and legacy families, checkpoints, the finite guard."""

from .checkpoints import (
    CheckpointManager,
    graft_subtree,
    restore_checkpoint,
    save_checkpoint,
)
from .legacy import LegacyTrainer, load_legacy_sample, scan_legacy_root
from .profiling import NonFiniteLossError, check_finite
from .single_modality import SingleModalityTrainer, make_audio_trainer, make_visual_trainer
from .ssl_pretrain import MaskedAudioPretrainer, MaskedAudioPretrainModel, flagship_audio_params
from .trainer import GroupAdam, MultiSpeakerTrainer, TrainState, label_params, make_lr_schedule

__all__ = [
    "CheckpointManager",
    "GroupAdam",
    "LegacyTrainer",
    "MaskedAudioPretrainModel",
    "MaskedAudioPretrainer",
    "MultiSpeakerTrainer",
    "NonFiniteLossError",
    "SingleModalityTrainer",
    "TrainState",
    "check_finite",
    "flagship_audio_params",
    "graft_subtree",
    "label_params",
    "load_legacy_sample",
    "make_audio_trainer",
    "make_lr_schedule",
    "make_visual_trainer",
    "restore_checkpoint",
    "save_checkpoint",
    "scan_legacy_root",
]
