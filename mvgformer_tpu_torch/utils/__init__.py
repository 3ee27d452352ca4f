"""Utilities: weights carried across from the JAX package."""
