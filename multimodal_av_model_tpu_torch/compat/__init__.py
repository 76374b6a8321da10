"""Interchange with the JAX package's checkpoints."""

from .from_jax import (
    audio_only_from_jax,
    from_jax_variables,
    single_modality_state_from_jax,
    ssl_pretrain_from_jax,
    ssl_state_from_jax,
    train_state_from_jax,
    visual_only_from_jax,
)

__all__ = ["audio_only_from_jax", "from_jax_variables", "single_modality_state_from_jax",
           "ssl_pretrain_from_jax", "ssl_state_from_jax", "train_state_from_jax",
           "visual_only_from_jax"]
