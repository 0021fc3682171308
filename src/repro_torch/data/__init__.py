"""Synthetic key datasets, the DILI record store and the token pipelines
(copied from the JAX package)."""
