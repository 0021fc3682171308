"""Parallelism helpers of the port (gradient compression; the sharded and
pipelined training paths come with a later slice)."""
