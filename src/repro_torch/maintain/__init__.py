"""Adaptive maintenance subsystem (copied from `repro/maintain`; DESIGN.md
section 12): per-leaf accounting and its retrain and re-cluster plans,
the incremental splice flattener, and the background scheduler.  All of
it is numpy and threading code on the host, so the modules are the
reference's unchanged, importing the port's own `core`."""

from .accounting import (LeafAccount, LeafAccounting, fold_with_accounting,
                         ks_uniform, leaf_drift, run_reclusters,
                         run_retrains)
from .config import MaintenanceConfig
from .flattener import IncrementalFlattener, SegmentBlock, flatten_segment
from .scheduler import MaintenanceScheduler

__all__ = [
    "IncrementalFlattener", "LeafAccount", "LeafAccounting",
    "MaintenanceConfig", "MaintenanceScheduler", "SegmentBlock",
    "flatten_segment", "fold_with_accounting", "ks_uniform", "leaf_drift",
    "run_reclusters", "run_retrains",
]
