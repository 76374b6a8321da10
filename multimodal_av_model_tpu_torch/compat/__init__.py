"""Interchange with the JAX package's checkpoints."""

from .from_jax import from_jax_variables, train_state_from_jax

__all__ = ["from_jax_variables", "train_state_from_jax"]
