"""Online-update subsystem of the port (DESIGN.md section 8): the
tombstone overlay and its device mirror, the epoch-versioned
double-buffered snapshot publisher, the merge policy with its λ-pressure
trigger, and the `OnlineIndex` facade behind the local engine."""

from .overlay import (LIVE, TOMBSTONE, TombstoneOverlay, fold_overlay,
                      overlay_device_arrays)
from .epoch import EpochStats, SnapshotStore
from .merge import MergePolicy, OnlineIndex, adjust_pressure
from ..maintain import MaintenanceConfig

__all__ = ["LIVE", "TOMBSTONE", "TombstoneOverlay", "fold_overlay",
           "overlay_device_arrays", "EpochStats", "SnapshotStore",
           "MergePolicy", "OnlineIndex", "adjust_pressure",
           "MaintenanceConfig"]
