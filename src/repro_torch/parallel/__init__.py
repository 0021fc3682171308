"""Parallelism of the port on one card: the sharding rules (pure functions
of shapes and mesh sizes), the GPipe schedule as a loop over stages and
microbatches, and gradient compression with `psum_int8` over stacked
per-shard slices."""
