"""Workload samplers (copied from `repro/workloads`).  Only the
key-popularity distributions are here so far: the YCSB update draw
(`zipfian_ranks` through `scatter_ranks`) that drives the maintenance
path of `chip_smoke.py`.  The stream generator, the oracle and the runner
wait for their slice (see ROADMAP.md)."""

from .distributions import (DEFAULT_THETA, DISTRIBUTIONS, ZetaCache,
                            sample_indices, scatter_ranks, zipfian_ranks)

__all__ = ["DEFAULT_THETA", "DISTRIBUTIONS", "ZetaCache", "sample_indices",
           "scatter_ranks", "zipfian_ranks"]
