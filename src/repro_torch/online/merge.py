"""Merge policy + the `OnlineIndex` facade (port of
`repro/online/merge.py`; DESIGN.md section 8).

The merge is the only place writes cross the writer/reader boundary: the
overlay is folded through the host DILI with the paper's own machinery —
upserts via Algorithm 7, tombstones via Algorithm 8 — then ONE `flatten()`
produces the next epoch's snapshot and `SnapshotStore.publish` flips it in.
A merge whose writes only replaced existing payloads patches the published
snapshot instead (`core.flat.patch_payloads`): the same snapshot, bit for
bit, in O(writes) rather than O(tree).
Between merges the read path serves snapshot+overlay fused lookups (one
launch of the lookup kernel's f64/i64 or f32/i64 instance on the card),
so results are exact at every point in time.

Merge triggers (`OnlineIndex.should_merge`, checked after every write
batch; the `pallas` engine checks the same ones itself):
  * `max_fill`      — overlay `full_fraction` reached (bounded write buffer);
  * `max_writes`    — merge lag: writes absorbed since the last publish;
  * adjustment pressure — a λ-style per-leaf trigger: if any single host leaf
    has pending writes exceeding `pressure_lambda ×` its current pair count,
    merging early lets Algorithm 7's adjustment re-spread that region;
  * explicit `flush()`.

With a `MaintenanceConfig` the merge runs the adaptive pipeline of
`repro_torch.maintain` (fold with accounting, retrains, re-clusters, the
splice flattener), on the writer's thread or, with `background=True`, on
the `MaintenanceScheduler` worker.
"""

from __future__ import annotations

import random
import threading
import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..core import search as S
from ..core.dili import DILI, LAMBDA, bulk_load
from ..core.flat import flatten, patch_payloads
from ..device import resolve_device
from ..kernels import ops as K
from ..kernels.dili_search import overlay_filter
from ..maintain import (IncrementalFlattener, LeafAccounting,
                        MaintenanceConfig, MaintenanceScheduler,
                        fold_with_accounting, run_reclusters, run_retrains)
from ..obs import NULL_TELEMETRY
from ..obs.trace_export import current_trace_ids, trace_context
from .epoch import EpochStats, SnapshotStore
from .overlay import (LIVE, TOMBSTONE, TombstoneOverlay, fold_overlay,
                      overlay_device_arrays)


YIELD_S = 50e-6     # the worker's sleep while a write call runs


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
    snapshot+overlay lookup (`kernels.ops.search_with_overlay`: the
    kernel's f64/i64 instance, or its f32/i64 one at `dtype=float32`, on
    the card; its plain version on the CPU); the merge policy decides when
    to fold the overlay through the host DILI and publish a fresh epoch.
    `flatten()` runs exactly once per merge — never per write.

    With a `MaintenanceConfig` the merge becomes adaptive (DESIGN.md
    section 12): folding feeds per-leaf accounting, drifted or
    tombstone-heavy subtrees are retrained, hot segments are re-clustered,
    the flatten is the incremental splice (bit-identical to `flatten()`,
    O(dirty)), and with `background=True` the whole merge runs on a
    `MaintenanceScheduler` worker so the writer never blocks on a publish.
    A merge freezes the overlay under a fresh live one and reads resolve
    live > frozen > snapshot; the frozen overlay is dropped only AFTER the
    publish flip (re-applying already-folded entries is idempotent), so
    reads are exact on either side of it.  A merge that fails leaves the
    frozen overlay readable and the next merge on the writer's thread
    reclaims it.

    Threading contract: ONE writer thread (writes, flush, stats) plus any
    number of reader threads (`lookup` / `get`); the background worker
    runs one merge at a time.  The worker publishes on the same CUDA
    stream the readers launch on, so the epoch store's synchronize also
    waits for their kernels and no kernel can outlive the tables it reads.

    `kernel_stats` counts `lookups` (calls) and `lanes` (queries sent to
    the kernel) since build, under a lock (readers run concurrently), and
    `n_patched_flattens` the full flattens a payload patch stood in for —
    port only.
    """

    def __init__(self, keys=None, vals=None, *, dili: DILI | None = None,
                 policy: MergePolicy | None = None, overlay_cap: int = 4096,
                 dtype=torch.float64, pad: bool = True,
                 early_exit: bool = True,
                 maintenance: MaintenanceConfig | None = None,
                 telemetry=None, device="cuda", **bulk_kw):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the local engine's key dtype is float32 or "
                            f"float64, got {dtype}")
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
        # maintenance subsystem (all None => full-flatten merges)
        self.maint = maintenance
        m = maintenance
        self.flattener = (IncrementalFlattener()
                          if m is not None and m.incremental else None)
        # accounting carries both the retrain and the re-cluster plan;
        # re-clustering also needs the incremental flattener (its segment
        # row counts are the size signal), so without it nothing is planned
        self.accounting = (LeafAccounting(m)
                           if m is not None and (m.retrain or m.recluster)
                           else None)
        self.scheduler = (MaintenanceScheduler(m.max_queue)
                          if m is not None and m.background else None)
        self.on_publish = None         # post-publish hook (durability
        #                                checkpoints ride it; runs on
        #                                whichever thread published)
        self.maint_degraded = False    # background retries exhausted ->
        #                                merges run synchronously now
        self.kernel_stats = dict(lookups=0, lanes=0)
        self.n_patched_flattens = 0
        self._stats_lock = threading.Lock()
        self._merging: TombstoneOverlay | None = None   # frozen, folding
        # a write call is in progress: the worker's merge steps give it
        # the GIL (`_yield_to_writers`).  A flag, not a count: every
        # writer clears it last, so it can never stay set
        self._writing = False
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
        self.n_flattens = 0
        self.n_full_flattens = 0
        self.n_incremental_flattens = 0
        self.n_merges = 0
        self.n_retrains = 0
        self.n_reclusters = 0
        self.last_dirty_frac = 1.0
        self.merge_reasons: Counter = Counter()
        self._publish()

    # -- write path ----------------------------------------------------------

    def upsert(self, key: float, val: int) -> None:
        self.upsert_batch([key], [val])

    def upsert_batch(self, keys, vals) -> None:
        self._writing = True
        try:
            self.overlay = self.overlay.upsert_batch(keys, vals)
            self._unlocated_keys.extend(np.atleast_1d(keys).tolist())
            self._note_writes(len(np.atleast_1d(keys)))
        finally:
            self._writing = False

    def delete(self, key: float) -> None:
        self.delete_batch([key])

    def delete_batch(self, keys) -> None:
        self._writing = True
        try:
            self.overlay = self.overlay.delete_batch(keys)
            self._unlocated_keys.extend(np.atleast_1d(keys).tolist())
            self._note_writes(len(np.atleast_1d(keys)))
        finally:
            self._writing = False

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
            # while a merge is folding, the host tree is being mutated by
            # the worker: skip the λ-pressure walk until it finishes (the
            # fill/lag triggers above stay live)
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
        republished and the current epoch's stats are returned.  With
        background maintenance this is the synchronous barrier: it drains
        the worker and folds everything pending before returning."""
        if self.scheduler is None:
            return self.merge("flush")
        while True:
            self.scheduler.drain()
            if self.overlay.count == 0 and self._merging is None:
                return self.store.stats
            n_err = len(self.scheduler.errors)
            self.merge("flush")
            self.scheduler.drain()
            if len(self.scheduler.errors) > n_err and (
                    self.overlay.count or self._merging is not None):
                # the retry died too: surface it instead of spinning (the
                # pending writes stay readable through the overlay chain)
                raise RuntimeError(
                    "background merge keeps failing; pending writes "
                    "retained in the overlay:\n"
                    + self.scheduler.errors[-1])

    def merge(self, reason: str = "explicit") -> EpochStats:
        """Fold the overlay through the host DILI (Alg. 7/8) and publish —
        inline, or on the maintenance worker when background is on."""
        if self._merging is not None:
            if not self._merge_failed:
                return self.store.stats   # one merge in flight: coalesce
            # a previous merge died mid-pipeline: reclaim its frozen
            # writes HERE, on the writer thread (the worker must never
            # assign self.overlay — it races writer assignments), newest
            # entries winning, and retry below.  Reads were exact the
            # whole time: the frozen overlay stayed visible.
            self.overlay = self._merging.merged_with(self.overlay)
            self._merging = None
            self._merge_failed = False
        if self.overlay.count == 0:    # nothing pending: keep current epoch
            return self.store.stats
        frozen = self.overlay
        self._merging = frozen         # readers: live > frozen > snapshot
        self._frozen_t0 = time.perf_counter()   # -> merge.frozen_dwell
        self.overlay = TombstoneOverlay.empty(self._overlay_cap0)
        # trigger counters reset HERE, on the writer thread, at freeze
        # time: the frozen writes are on their way into the next epoch,
        # and the worker must never write these fields (a worker reset
        # would race the writer's own `+= n`).  The stale λ-pressure leaf
        # cache goes with them (the fold invalidates it).
        lag = self._writes_since_publish
        self._writes_since_publish = 0
        self._writes_since_pressure = 0
        self._leaf_hits = Counter()
        self._leaf_omega = {}
        self._unlocated_keys = []
        t_sub = time.perf_counter()    # -> merge.queue_wait (submit -> start)
        # causal tracing: the submitting thread's trace context rides to
        # the worker, so background merge.* spans link back to the
        # requests whose writes triggered them
        tids = current_trace_ids()
        if (self.scheduler is not None and not self.maint_degraded
                and self.scheduler.submit(
                    lambda: self._merge_on_worker(frozen, reason, lag,
                                                  t_sub, tids))):
            return self.store.stats
        return self._merge_impl(frozen, reason, lag, t_sub)  # sync/closed

    def _merge_on_worker(self, frozen, reason, lag, t_sub, tids):
        with trace_context(tids):
            return self._merge_impl(frozen, reason, lag, t_sub, retry=True)

    def _yield_to_writers(self) -> None:
        """Called by the worker's merge steps between units of work: while
        a write call runs, sleep (the GIL released) until it has returned.
        The worker's Python loops and long numpy calls would otherwise
        take the GIL back at each numpy call of the write that lets go of
        it, stalling the writer for a merge's worth of tens of ms."""
        while self._writing:
            time.sleep(YIELD_S)

    def _merge_impl(self, frozen: TombstoneOverlay, reason: str,
                    lag: int, t_sub: float,
                    retry: bool = False) -> EpochStats:
        """The merge pipeline: fold (+accounting) -> retrain -> recluster ->
        flatten -> publish, on the caller's thread or the worker.

        On the worker (`retry=True`) a failed attempt is retried up to
        `MaintenanceConfig.max_merge_retries` times with jittered
        exponential backoff: re-running the pipeline over the same frozen
        overlay is idempotent (a partly applied fold re-applies
        last-write-wins), though the dead attempt's counters and spans
        count twice.  Each failed attempt counts `maint.errors` and records
        a `merge.failed` span on the index's own registry.

        After the last attempt (or a failure on the writer's thread) the
        frozen overlay STAYS installed (reads keep resolving it) and is
        flagged; the next merge on the writer's thread reclaims it into
        the live overlay (newer wins) and retries.  A worker that runs out
        of retries also degrades the index to synchronous merges
        (`maint_degraded`).  The worker never assigns self.overlay or the
        trigger counters: that would race the writer's own updates."""
        m = self.maint
        attempts = 1 + (m.max_merge_retries if retry and m is not None
                        else 0)
        for attempt in range(attempts):
            t0 = time.perf_counter()
            try:
                return self._merge_steps(
                    frozen, reason, lag, t_sub,
                    self._yield_to_writers if retry else None)
            except BaseException:
                # failure visibility is unconditional (not gated on
                # `enabled`) but only on the index's OWN registry —
                # NULL_TELEMETRY is a shared module global
                if self.tel is not NULL_TELEMETRY:
                    self.tel.metrics.count("maint.errors")
                    self.tel.spans.record("merge.failed",
                                          time.perf_counter() - t0,
                                          reason=reason, attempt=attempt)
                if attempt == attempts - 1:
                    self._merge_failed = True
                    if retry:
                        self.maint_degraded = True
                    raise
                backoff = m.retry_backoff_s * (2 ** attempt)
                time.sleep(backoff * (0.5 + random.random()))
        raise AssertionError("unreachable")

    def _merge_steps(self, frozen: TombstoneOverlay, reason: str,
                     lag: int, t_sub: float, pause=None) -> EpochStats:
        """The pipeline's steps; `pause` (on the worker) is called between
        their units of work."""
        t0 = time.perf_counter()
        payloads = None     # (keys, vals) when the fold only replaced them
        self.tel.record_span("merge.queue_wait", t0 - t_sub, reason=reason)
        if self.accounting is not None:
            with self.tel.span("merge.fold", reason=reason,
                               pending=frozen.count):
                fold_with_accounting(self.dili, frozen, self.accounting,
                                     pause)
            with self.tel.span("merge.retrain"):
                retrains = run_retrains(self.dili, self.accounting)
            with self.tel.span("merge.recluster"):
                reclusters = run_reclusters(self.dili, self.accounting,
                                            self.flattener)
            if reclusters:
                self.n_reclusters += reclusters
                if self.tel.enabled:
                    self.tel.metrics.count("maint.reclusters", reclusters)
        else:
            with self.tel.span("merge.fold", reason=reason,
                               pending=frozen.count):
                inserted = fold_overlay(self.dili, frozen)
            retrains = 0
            if not inserted and frozen.n_tombstones == 0:
                payloads = frozen.entries()[:2]
        merge_s = time.perf_counter() - t0
        self.n_merges += 1
        self.n_retrains += retrains
        self.merge_reasons[reason] += 1
        st = self._publish(overlay_fill=frozen.full_fraction,
                           merge_s=merge_s, n_retrains=retrains,
                           merge_lag=lag, payloads=payloads, pause=pause)
        # drop the frozen overlay only AFTER the flip: between publish and
        # here readers re-apply already-folded entries — idempotent
        self._merging = None
        self.tel.record_span("merge.frozen_dwell",
                             time.perf_counter() - self._frozen_t0,
                             reason=reason)
        if self.on_publish is not None:   # durability checkpoints ride here
            self.on_publish()
        return st

    def _publish(self, overlay_fill: float = 0.0, merge_s: float = 0.0,
                 n_retrains: int = 0, merge_lag: int = 0,
                 payloads: tuple | None = None,
                 pause=None) -> EpochStats:
        """Flatten, upload and flip.  `payloads` are the (keys, vals) of a
        fold that only replaced existing payloads: where every key is a
        pair of the published flat, patching that flat gives what the
        full flatten would, and the stats record a full flatten."""
        t0 = time.perf_counter()
        fl = self.flattener
        stage = self.tel.spans.stage if self.tel.enabled else None
        with self.tel.span("merge.flatten"):
            if fl is not None:
                flat = fl.flatten(self.dili, self.dili.take_dirty(), stage,
                                  pause)
                incremental = fl.last_incremental
                dirty_frac = fl.last_dirty_rows / max(fl.last_total_rows, 1)
            else:
                flat = None
                if payloads is not None:
                    t_patch = time.perf_counter()
                    flat = patch_payloads(self.store.flat, *payloads)
                    if flat is not None:
                        self.n_patched_flattens += 1
                        if stage is not None:
                            stage("flatten.patch", t_patch,
                                  time.perf_counter())
                if flat is None:
                    # the ONE full flatten per epoch
                    flat = flatten(self.dili, stage)
                self.dili.take_dirty()     # drain: nothing is dirty vs a
                incremental = False        # fresh full materialization
                dirty_frac = 1.0
        merge_s += time.perf_counter() - t0
        self.n_flattens += 1
        if incremental:
            self.n_incremental_flattens += 1
        else:
            self.n_full_flattens += 1
        self.last_dirty_frac = dirty_frac
        self.tel.sample_publish(
            n_segments=flat.n_segments,
            dirty_rows=fl.last_dirty_rows if fl is not None else flat.n_slots,
            total_rows=fl.last_total_rows if fl is not None else flat.n_slots)
        if pause is not None:
            pause()
        with self.tel.span("merge.publish", epoch=self.store.epoch + 1):
            st = self.store.publish(flat, overlay_fill=overlay_fill,
                                    merge_lag=merge_lag, merge_s=merge_s,
                                    incremental=incremental,
                                    dirty_frac=dirty_frac,
                                    n_retrains=n_retrains)
        if st.retraced and self.tel.enabled:
            self.tel.metrics.count("publish.retraced")
        return st

    def close(self) -> None:
        """Stop the background worker (if any).  Does NOT flush: pending
        overlay writes stay readable, they are just no longer folded."""
        if self.scheduler is not None:
            self.scheduler.close()

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
        """The device mirror of the live-over-frozen overlay (keys of the
        store's dtype), cached per (overlay, merging) pair.  The writer
        sets `_merging` before it swaps in a fresh live overlay, and the
        worker clears it only after the flip, so a pair read with no
        frozen overlay was read when no merge was in flight or after that
        merge's flip: a snapshot read afterwards holds its entries."""
        ov, mg = self.overlay, self._merging
        c = self._ov_cache
        if c is not None and c[0] is ov and c[1] is mg:
            return c[2]
        eff = ov if mg is None else mg.merged_with(ov)
        arrs = overlay_device_arrays(eff, self.store.dtype,
                                     device=self.device)
        arrs["filter"] = overlay_filter(eff.keys,
                                        self.store.dtype).to(self.device)
        self._ov_cache = (ov, mg, arrs)
        return arrs

    def lookup(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Batched fused snapshot+overlay lookup -> (vals, found): one
        launch of the kernel instance for the store's dtype on the card
        (walk, dense probe and overlay resolve), depth-exact (trip count
        from the snapshot).  With telemetry on it records the stage spans
        `lookup.stage` (holding `lookup.overlay`), `lookup.upload` and
        `lookup.download`."""
        on = self.tel.enabled
        if on:
            t0 = time.perf_counter()
        # overlay BEFORE snapshot (see pending_entries for the ordering)
        ova = self._overlay_arrays()
        if on:
            t_ov = time.perf_counter()
        tables = self.store.kernel_tables
        x = S.host_cast(np.atleast_1d(np.asarray(queries, np.float64)),
                        self.store.dtype)
        if on:
            t1 = time.perf_counter()
        q = torch.from_numpy(x).to(self.device)
        if on:
            t2 = time.perf_counter()
        with self._stats_lock:
            self.kernel_stats["lookups"] += 1
            self.kernel_stats["lanes"] += q.shape[0]
        v, f = K.search_with_overlay(tables, ova, q,
                                     early_exit=self.early_exit)
        if on:
            t3 = time.perf_counter()
        out = v.cpu().numpy(), f.cpu().numpy()
        if on:
            spans = self.tel.spans
            spans.stage("lookup.stage", t0, t1)
            spans.stage("lookup.overlay", t0, t_ov)
            spans.stage("lookup.upload", t1, t2)
            spans.stage("lookup.download", t3, time.perf_counter())
        return out

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
