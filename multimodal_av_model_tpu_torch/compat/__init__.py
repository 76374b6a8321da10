"""Interchange with the JAX package's checkpoints."""

from .from_jax import from_jax_variables

__all__ = ["from_jax_variables"]
