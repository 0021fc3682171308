"""Merge policy + the `OnlineIndex` facade (port of
`repro/online/merge.py`; DESIGN.md section 8).

The merge is the only place writes cross the writer/reader boundary: the
overlay is folded through the host DILI with the paper's own machinery —
upserts via Algorithm 7, tombstones via Algorithm 8 — then ONE `flatten()`
produces the next epoch's snapshot and `SnapshotStore.publish` flips it in.
Between merges the read path serves snapshot+overlay fused lookups (one
launch of the f64 lookup kernel on the card), so results are exact at
every point in time.

Merge triggers (`OnlineIndex.should_merge`, checked after every write
batch; the `pallas` engine checks the same ones itself):
  * `max_fill`      — overlay `full_fraction` reached (bounded write buffer);
  * `max_writes`    — merge lag: writes absorbed since the last publish;
  * adjustment pressure — a λ-style per-leaf trigger: if any single host leaf
    has pending writes exceeding `pressure_lambda ×` its current pair count,
    merging early lets Algorithm 7's adjustment re-spread that region;
  * explicit `flush()`.

Merges run on the writer's thread.  The adaptive maintenance subsystem
(per-leaf accounting, the splice flattener, the background scheduler and
its merge retries) waits for its slice: `maintenance=` must be None (see
ROADMAP.md).
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..core.dili import DILI, LAMBDA, bulk_load
from ..core.flat import flatten
from ..device import resolve_device
from ..kernels import ops as K
from ..obs import NULL_TELEMETRY
from .epoch import EpochStats, SnapshotStore
from .overlay import (LIVE, TOMBSTONE, TombstoneOverlay, fold_overlay,
                      overlay_device_arrays)


@dataclass(frozen=True)
class MergePolicy:
    max_fill: float = 0.5          # overlay full_fraction trigger
    max_writes: int = 4096         # merge-lag trigger (writes since publish)
    pressure_lambda: float = LAMBDA  # per-leaf pending/omega trigger
    pressure_check_every: int = 256  # amortize the host-side leaf walk
    # absolute floor for the pressure trigger: a leaf only counts toward a
    # λ-pressure merge once it holds this many pending writes
    pressure_min_pending: int = 64


def adjust_pressure(dili: DILI, ov: TombstoneOverlay,
                    min_pending: int = 1) -> float:
    """max over host leaves of pending-writes / current-pairs — the overlay
    analogue of Alg. 7's Δ/Ω > λκ adjustment test.  Leaves with fewer than
    `min_pending` pending writes are ignored (policy floor)."""
    if ov.count == 0:
        return 0.0
    keys, _, _ = ov.entries()
    hits: Counter = Counter()
    omega: dict[int, int] = {}
    for k in keys:
        leaf, _ = dili.locate_leaf(float(k))
        lid = id(leaf)
        hits[lid] += 1
        omega[lid] = leaf.omega
    return max((c / max(omega[lid], 1)
                for lid, c in hits.items() if c >= min_pending),
               default=0.0)


class OnlineIndex:
    """Snapshot + overlay + merge lifecycle behind one read/write API.

    Writes land in the (host) tombstone overlay; reads run the fused
    snapshot+overlay lookup (`kernels.ops.search_with_overlay`: the f64
    kernel instance on the card, its plain version on the CPU); the merge
    policy decides when to fold the overlay through the host DILI and
    publish a fresh epoch.  `flatten()` runs exactly once per merge —
    never per write.  A merge freezes the overlay under a fresh live one
    and reads resolve live > frozen > snapshot until the flip, so they
    stay exact on either side of it; a merge that fails leaves the frozen
    overlay readable and the next merge reclaims it.

    Threading contract: ONE writer thread (writes, flush, stats) plus any
    number of reader threads (`lookup` / `get`).

    `kernel_stats` counts `lookups` (calls) and `lanes` (queries sent to
    the kernel) since build — port only.
    """

    def __init__(self, keys=None, vals=None, *, dili: DILI | None = None,
                 policy: MergePolicy | None = None, overlay_cap: int = 4096,
                 dtype=torch.float64, pad: bool = True,
                 early_exit: bool = True, maintenance=None, telemetry=None,
                 device="cuda", **bulk_kw):
        if maintenance is not None:
            raise NotImplementedError(
                "maintenance=MaintenanceConfig(...) is not ported yet; see "
                "ROADMAP.md (maintain/*)")
        if dtype != torch.float64:
            raise NotImplementedError(
                f"the local engine runs f64 keys only; dtype={dtype} waits "
                f"for an <float, int64> instance of the lookup kernel (see "
                f"ROADMAP.md)")
        self.device = resolve_device(device)
        if dili is None:
            dili = bulk_load(np.asarray(keys, np.float64), vals, **bulk_kw)
        self.dili = dili
        self.tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.policy = policy or MergePolicy()
        self.early_exit = early_exit
        self.store = SnapshotStore(dtype=dtype, pad=pad, device=self.device)
        self.overlay = TombstoneOverlay.empty(overlay_cap)
        self._overlay_cap0 = self.overlay.cap
        self.kernel_stats = dict(lookups=0, lanes=0)
        self._merging: TombstoneOverlay | None = None   # frozen, folding
        self._merge_failed = False           # frozen needs writer reclaim
        self._ov_cache: tuple | None = None  # (overlay, merging, arrays)
        self._writes_since_publish = 0
        self._writes_since_pressure = 0
        # incremental λ-pressure state: between merges the host DILI is never
        # mutated (writes only touch the overlay), so leaf identities are
        # stable and each written key needs locating exactly once
        self._leaf_hits: Counter = Counter()    # id(leaf) -> pending writes
        self._leaf_omega: dict[int, int] = {}   # id(leaf) -> omega
        self._unlocated_keys: list[float] = []  # written since last check
        self.n_flattens = 0            # one full flatten per epoch
        self.n_merges = 0
        self.merge_reasons: Counter = Counter()
        self._publish()

    # -- write path ----------------------------------------------------------

    def upsert(self, key: float, val: int) -> None:
        self.upsert_batch([key], [val])

    def upsert_batch(self, keys, vals) -> None:
        self.overlay = self.overlay.upsert_batch(keys, vals)
        self._unlocated_keys.extend(np.atleast_1d(keys).tolist())
        self._note_writes(len(np.atleast_1d(keys)))

    def delete(self, key: float) -> None:
        self.delete_batch([key])

    def delete_batch(self, keys) -> None:
        self.overlay = self.overlay.delete_batch(keys)
        self._unlocated_keys.extend(np.atleast_1d(keys).tolist())
        self._note_writes(len(np.atleast_1d(keys)))

    def _note_writes(self, n: int) -> None:
        self._writes_since_publish += n
        self._writes_since_pressure += n
        reason = self.should_merge()
        if reason:
            self.merge(reason)

    # -- merge trigger -------------------------------------------------------

    def should_merge(self) -> str | None:
        p = self.policy
        if self.overlay.full_fraction >= p.max_fill:
            return "fill"
        if self._writes_since_publish >= p.max_writes:
            return "lag"
        if self._writes_since_pressure >= p.pressure_check_every:
            self._writes_since_pressure = 0
            # skip the λ-pressure walk while a frozen overlay is pending
            # (the fill/lag triggers above stay live)
            if self._merging is None \
                    and self._incremental_pressure() > p.pressure_lambda:
                return "pressure"
        return None

    def _incremental_pressure(self) -> float:
        """λ-pressure over O(writes since last check) tree walks, not the
        whole overlay (duplicate writes to one key count once per write —
        a slight overestimate that only merges a hot region earlier)."""
        for k in self._unlocated_keys:
            leaf, _ = self.dili.locate_leaf(float(k))
            lid = id(leaf)
            self._leaf_hits[lid] += 1
            self._leaf_omega[lid] = leaf.omega
        self._unlocated_keys.clear()
        if not self._leaf_hits:
            return 0.0
        floor = self.policy.pressure_min_pending
        return max((c / max(self._leaf_omega[lid], 1)
                    for lid, c in self._leaf_hits.items() if c >= floor),
                   default=0.0)

    def flush(self) -> EpochStats:
        """Explicit merge+publish; with an empty overlay nothing is folded or
        republished and the current epoch's stats are returned."""
        return self.merge("flush")

    def merge(self, reason: str = "explicit") -> EpochStats:
        """Fold the overlay through the host DILI (Alg. 7/8) and publish."""
        if self._merging is not None:
            if not self._merge_failed:
                return self.store.stats   # one merge in flight: coalesce
            # a previous merge died mid-pipeline: reclaim its frozen writes
            # into the live overlay, newest entries winning, and retry.
            # Reads were exact the whole time: the frozen overlay stayed
            # visible.
            self.overlay = self._merging.merged_with(self.overlay)
            self._merging = None
            self._merge_failed = False
        if self.overlay.count == 0:    # nothing pending: keep current epoch
            return self.store.stats
        frozen = self.overlay
        self._merging = frozen         # readers: live > frozen > snapshot
        self._frozen_t0 = time.perf_counter()   # -> merge.frozen_dwell
        self.overlay = TombstoneOverlay.empty(self._overlay_cap0)
        # trigger counters reset at freeze time: the frozen writes are on
        # their way into the next epoch.  The stale λ-pressure leaf cache
        # goes with them (the fold invalidates it).
        lag = self._writes_since_publish
        self._writes_since_publish = 0
        self._writes_since_pressure = 0
        self._leaf_hits = Counter()
        self._leaf_omega = {}
        self._unlocated_keys = []
        t_sub = time.perf_counter()    # -> merge.queue_wait (submit -> start)
        return self._merge_impl(frozen, reason, lag, t_sub)

    def _merge_impl(self, frozen: TombstoneOverlay, reason: str, lag: int,
                    t_sub: float) -> EpochStats:
        """The merge pipeline, fold -> flatten -> publish, on the writer's
        thread.  A failure counts `maint.errors`, records a `merge.failed`
        span on the index's own registry, and leaves the frozen overlay
        installed (reads stay exact) and flagged for the next merge to
        reclaim."""
        t0 = time.perf_counter()
        try:
            return self._merge_steps(frozen, reason, lag, t_sub)
        except BaseException:
            # failure visibility is unconditional (not gated on `enabled`)
            # but only on the index's OWN registry — NULL_TELEMETRY is a
            # shared module global
            if self.tel is not NULL_TELEMETRY:
                self.tel.metrics.count("maint.errors")
                self.tel.spans.record("merge.failed",
                                      time.perf_counter() - t0,
                                      reason=reason, attempt=0)
            self._merge_failed = True
            raise

    def _merge_steps(self, frozen: TombstoneOverlay, reason: str,
                     lag: int, t_sub: float) -> EpochStats:
        t0 = time.perf_counter()
        self.tel.record_span("merge.queue_wait", t0 - t_sub, reason=reason)
        with self.tel.span("merge.fold", reason=reason,
                           pending=frozen.count):
            fold_overlay(self.dili, frozen)
        merge_s = time.perf_counter() - t0
        self.n_merges += 1
        self.merge_reasons[reason] += 1
        st = self._publish(overlay_fill=frozen.full_fraction,
                           merge_s=merge_s, merge_lag=lag)
        # drop the frozen overlay only AFTER the flip: between publish and
        # here readers re-apply already-folded entries — idempotent
        self._merging = None
        self.tel.record_span("merge.frozen_dwell",
                             time.perf_counter() - self._frozen_t0,
                             reason=reason)
        return st

    def _publish(self, overlay_fill: float = 0.0, merge_s: float = 0.0,
                 merge_lag: int = 0) -> EpochStats:
        t0 = time.perf_counter()
        with self.tel.span("merge.flatten"):
            flat = flatten(self.dili)  # the ONE full flatten per epoch
            self.dili.take_dirty()     # drain: nothing is dirty vs a fresh
            #                            full materialization
        merge_s += time.perf_counter() - t0
        self.n_flattens += 1
        self.tel.sample_publish(n_segments=flat.n_segments,
                                dirty_rows=flat.n_slots,
                                total_rows=flat.n_slots)
        with self.tel.span("merge.publish", epoch=self.store.epoch + 1):
            st = self.store.publish(flat, overlay_fill=overlay_fill,
                                    merge_lag=merge_lag, merge_s=merge_s)
        if st.retraced and self.tel.enabled:
            self.tel.metrics.count("publish.retraced")
        return st

    # -- read path -----------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.store.epoch

    def pending_entries(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, vals, tomb) of every pending write — the live overlay
        over the frozen (merging) one.  Callers composing this with the
        published snapshot must capture it BEFORE reading the snapshot:
        if a publish lands in between, the newer snapshot already contains
        the frozen entries and re-applying them is idempotent; the other
        order can lose them."""
        ov, mg = self.overlay, self._merging
        if mg is None:
            return ov.entries()
        return mg.merged_with(ov).entries()

    def _overlay_arrays(self) -> dict:
        """The device mirror of the live-over-frozen overlay, cached per
        (overlay, merging) pair."""
        ov, mg = self.overlay, self._merging
        c = self._ov_cache
        if c is not None and c[0] is ov and c[1] is mg:
            return c[2]
        eff = ov if mg is None else mg.merged_with(ov)
        arrs = overlay_device_arrays(eff, self.store.dtype,
                                     device=self.device)
        self._ov_cache = (ov, mg, arrs)
        return arrs

    def lookup(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Batched fused snapshot+overlay lookup -> (vals, found): one
        launch of the f64 kernel instance on the card (walk, dense probe
        and overlay resolve), depth-exact (trip count from the snapshot)."""
        # overlay BEFORE snapshot (see pending_entries for the ordering)
        ova = self._overlay_arrays()
        tables = self.store.kernel_tables
        q = torch.from_numpy(np.ascontiguousarray(
            np.atleast_1d(np.asarray(queries, np.float64)))).to(self.device)
        st = self.kernel_stats
        st["lookups"] += 1
        v, f = K.search_with_overlay(tables, ova, q,
                                     early_exit=self.early_exit, stats=st)
        return v.cpu().numpy(), f.cpu().numpy()

    def get(self, key: float) -> int | None:
        """Host-side exact point read (overlay state wins).  Resolves
        live overlay > frozen overlay > published pair table — never the
        mutable host tree, which a merge may be folding."""
        key = float(key)
        ov, mg = self.overlay, self._merging
        for o in ((ov,) if mg is None else (ov, mg)):
            state, v = o.get(key)
            if state == LIVE:
                return v
            if state == TOMBSTONE:
                return None
        flat = self.store.flat
        i = int(np.searchsorted(flat.pair_key, key))
        if i < flat.n_pairs and flat.pair_key[i] == key:
            return int(flat.pair_val[i])
        return None
