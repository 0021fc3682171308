"""Epoch-versioned snapshot publisher (port of `repro/online/epoch.py`;
DESIGN.md section 8).

`SnapshotStore` owns the immutable device snapshots the read path serves
from.  Publishing is double-buffered: epoch N+1's tables are built and
uploaded into the *back* buffer while epoch N keeps serving from the front
buffer, then a single reference flip makes N+1 current.  A buffer holds
everything one epoch's readers need as one tuple: the host `FlatDILI`,
the padded pair table that ranges bisect (`core.search.pair_arrays`) and
the kernel tables the lookup kernel reads (`kernels.ops.kernel_arrays`,
keys of the store's dtype, int64 payloads).  A reader that captured
epoch N mid-batch keeps a consistent view after the flip, which only
retargets new readers.

Publishes come from the writer's thread or, with background maintenance,
from the maintenance worker, while reader threads launch lookups.  All of
them use the device's default stream: the upload is queued there, and
`torch.cuda.synchronize` waits for it (and for any reader kernel queued
before it) before the flip.  The previous epoch's tensors stay alive while
a reader holds its tuple, and the caching allocator hands their memory to
a later allocation only in that one stream's order, so no kernel reads a
freed table.  A side stream for the upload would need an event for
readers to wait on and `record_stream` on the old tables; the single
stream needs neither.

The reference uploads a whole `DeviceSnapshot` per epoch; here only the
two tables above live on the device, and `idx` uploads the whole snapshot
only when asked.  Its shapes, padded to powers of two, are still what
`EpochStats.retraced` compares (the reference re-traces its compiled
search when they change) and what `bytes_uploaded` counts
(`core.search.device_layout`), so both equal the reference's.  Per-epoch
stats also record overlay fill, merge lag, and the maintenance pipeline's
flatten kind, dirty fraction and retrains.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..core import search as S
from ..core.flat import FlatDILI
from ..device import resolve_device
from ..kernels import ops as K


@dataclass(frozen=True)
class EpochStats:
    epoch: int
    n_keys: int              # pairs in the snapshot
    n_nodes: int             # unpadded node-table rows
    n_slots: int             # unpadded slot-table rows
    bytes_uploaded: int      # DeviceSnapshot bytes (the reference's count)
    overlay_fill: float      # overlay full_fraction at publish time
    merge_lag: int           # writes absorbed since the previous publish
    publish_s: float         # wall time: upload + device synchronize
    retraced: bool           # padded shapes changed vs previous epoch
    merge_s: float = 0.0     # wall time: fold + flatten
    # maintenance observability (DESIGN.md section 12); defaults describe a
    # full flatten
    incremental: bool = False  # splice-flatten (vs full flatten())
    dirty_frac: float = 1.0  # slot rows re-materialized / total rows
    n_retrains: int = 0      # subtree rebuilds during this merge


@dataclass
class SnapshotStore:
    dtype: torch.dtype = torch.float64
    pad: bool = True
    device: torch.device | str = "cuda"
    epoch: int = 0
    history: list = field(default_factory=list)
    # (flat, pair table, kernel tables) per buffer
    _buf: list = field(default_factory=lambda: [None, None])
    _active: int = -1

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # -- read side -----------------------------------------------------------

    @property
    def flat(self) -> FlatDILI:
        return self._buf[self._active][0]

    @property
    def idx(self):
        """The current epoch's whole `api.DeviceSnapshot`, uploaded anew on
        each call (the store keeps only `pairs` and `kernel_tables` on the
        device)."""
        from ..api.snapshot import DeviceSnapshot   # lazy: api imports online
        return DeviceSnapshot.from_flat(self.flat, self.dtype, pad=self.pad,
                                        device=self.device)

    @property
    def pairs(self) -> dict:
        """The current epoch's padded pair table (`pair_key`, `pair_val`):
        what `core.search.range_query_batch` reads."""
        return self._buf[self._active][1]

    @property
    def kernel_tables(self) -> dict:
        """The current epoch's lookup-kernel tables (`ops.pack_tables`)."""
        return self._buf[self._active][2]

    @property
    def max_depth(self) -> int:
        return self.flat.max_depth

    @property
    def stats(self) -> EpochStats:
        return self.history[-1]

    # -- write side ----------------------------------------------------------

    def publish(self, flat: FlatDILI, *, overlay_fill: float = 0.0,
                merge_lag: int = 0, merge_s: float = 0.0,
                incremental: bool = False, dirty_frac: float = 1.0,
                n_retrains: int = 0) -> EpochStats:
        """Upload `flat` into the back buffer, flip, bump the epoch."""
        t0 = time.perf_counter()
        pairs = S.pair_arrays(flat, self.dtype, pad=self.pad,
                              device=self.device)
        tables = K.kernel_arrays(flat, device=self.device, dtype=self.dtype,
                                 val_dtype=torch.int64)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the upload has landed
        publish_s = time.perf_counter() - t0

        back = 1 - self._active if self._active >= 0 else 0
        layout = S.device_layout(flat, self.dtype, self.pad)
        retraced = (self._active < 0 or layout != S.device_layout(
            self.flat, self.dtype, self.pad))
        self._buf[back] = (flat, pairs, tables)
        self._active = back            # the flip: new readers see epoch N+1
        self.epoch += 1

        n_pairs = int((flat.tag == 1).sum())
        st = EpochStats(
            epoch=self.epoch, n_keys=n_pairs,
            n_nodes=flat.n_nodes, n_slots=flat.n_slots,
            bytes_uploaded=S.layout_nbytes(layout),
            overlay_fill=overlay_fill, merge_lag=merge_lag,
            publish_s=publish_s, retraced=retraced, merge_s=merge_s,
            incremental=incremental, dirty_frac=dirty_frac,
            n_retrains=n_retrains)
        self.history.append(st)
        return st
