"""Interchange with the JAX package's checkpoints and the upstream reference's
torch checkpoints (``torch_import``)."""

from .from_jax import (
    audio_only_from_jax,
    from_jax_variables,
    legacy_from_jax,
    legacy_state_from_jax,
    single_modality_state_from_jax,
    ssl_pretrain_from_jax,
    ssl_state_from_jax,
    stacked_blocks_from_jax,
    train_state_from_jax,
    visual_only_from_jax,
)
from .torch_import import import_reference_checkpoint

__all__ = ["audio_only_from_jax", "from_jax_variables", "legacy_from_jax",
           "import_reference_checkpoint", "legacy_state_from_jax",
           "single_modality_state_from_jax",
           "ssl_pretrain_from_jax", "ssl_state_from_jax", "stacked_blocks_from_jax",
           "train_state_from_jax",
           "visual_only_from_jax"]
