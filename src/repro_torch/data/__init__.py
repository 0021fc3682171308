"""Synthetic key datasets (copied from the JAX package)."""
