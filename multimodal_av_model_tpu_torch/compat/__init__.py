"""Interchange with the JAX package's checkpoints."""

from .from_jax import audio_only_from_jax, from_jax_variables, train_state_from_jax

__all__ = ["audio_only_from_jax", "from_jax_variables", "train_state_from_jax"]
