"""YCSB-style workload engine + differential oracle (DESIGN.md section 11;
copied from `repro/workloads`).

Three pieces, composable but separable:

  * `generator`     — seeded, replayable op streams (`WorkloadSpec`,
                      `OpBatch`, `generate_stream`, `PRESETS`:
                      ycsb_a/b/c/e + dili_paper) over configurable
                      key-popularity distributions (`distributions`).
  * `oracle`        — `SortedOracle`, the ground-truth sorted-array model
                      speaking the facade's exact output shapes.
  * `runner`        — `WorkloadRunner` / `run_preset`, replaying a stream
                      through any `repro_torch.api.LearnedIndex` engine
                      with per-batch oracle diffing and off-the-clock
                      checking.
"""

from .distributions import (DEFAULT_THETA, DISTRIBUTIONS, ZetaCache,
                            sample_indices, scatter_ranks, zipfian_ranks)
from .generator import (OPS, PRESETS, OpBatch, WorkloadSpec,
                        generate_stream, stream_op_counts)
from .oracle import SortedOracle
from .runner import (WorkloadDivergence, WorkloadReport, WorkloadRunner,
                     run_preset)

__all__ = [
    "DEFAULT_THETA", "DISTRIBUTIONS", "OPS", "PRESETS", "OpBatch",
    "SortedOracle", "WorkloadDivergence", "WorkloadReport",
    "WorkloadRunner", "WorkloadSpec", "ZetaCache", "generate_stream",
    "run_preset", "sample_indices", "scatter_ranks", "stream_op_counts",
    "zipfian_ranks",
]
