"""`repro_torch.api` — the engine-agnostic public API of the port.

`LearnedIndex` builds, queries and mutates a DILI; `IndexConfig` (the
reference's fields and JSON) selects the engine (`LocalEngine`, the
default, or `KernelEngine` as "pallas"); `DeviceSnapshot` holds
the device tables as tensors.
"""

from .snapshot import DeviceSnapshot, from_numpy_tables
from .config import ENGINES, IndexConfig, manual_merge_policy
from .engines import ENGINE_CLASSES, KernelEngine, LocalEngine
from .index import LearnedIndex
from ..durability.config import DurabilityConfig
from ..maintain import MaintenanceConfig
from ..online.merge import MergePolicy

__all__ = [
    "DeviceSnapshot", "DurabilityConfig", "ENGINES", "ENGINE_CLASSES",
    "IndexConfig", "KernelEngine", "LearnedIndex", "LocalEngine",
    "MaintenanceConfig",
    "MergePolicy", "from_numpy_tables", "manual_merge_policy",
]
