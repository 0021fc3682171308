"""Online-update pieces of the port: the tombstone overlay, its device
mirror, the merge policy and the λ-pressure trigger."""

from .overlay import (LIVE, TOMBSTONE, TombstoneOverlay, fold_overlay,
                      overlay_device_arrays)
from .merge import MergePolicy, adjust_pressure

__all__ = ["LIVE", "TOMBSTONE", "TombstoneOverlay", "fold_overlay",
           "overlay_device_arrays", "MergePolicy", "adjust_pressure"]
