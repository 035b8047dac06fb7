"""Utilities: the weight carrier from the JAX package and console meters."""
