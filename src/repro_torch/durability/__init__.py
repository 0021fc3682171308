"""Durability subsystem (DESIGN.md section 14): write-ahead log,
checkpointing, and crash recovery behind `api.IndexConfig.durability`
(port of `repro/durability`; the WAL and checkpoint formats are the
reference's, so a directory written by either package recovers in the
other).

Hard/soft state split: the overlay write stream is hard state — appended
to a per-shard CRC32 WAL before the engine acknowledges the write — and
everything derived (device snapshot, pair table, maintenance accounting)
is soft state, rebuilt at `recover()` time from the newest valid
checkpoint plus the WAL tail.
"""

from .config import DurabilityConfig, FSYNC_MODES
from .manager import DurabilityManager
from .recovery import recover
from .wal import OP_DELETE, OP_UPSERT, WalWriter, read_records

__all__ = [
    "DurabilityConfig",
    "DurabilityManager",
    "FSYNC_MODES",
    "OP_DELETE",
    "OP_UPSERT",
    "WalWriter",
    "read_records",
    "recover",
]
