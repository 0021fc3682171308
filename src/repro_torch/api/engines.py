"""Engines behind `repro_torch.api.LearnedIndex` (port of
`repro/api/engines.py`).

The reference's three engines are ported:

  * `LocalEngine` (`IndexConfig()`'s default): f64 (or, with
    `dtype=float32`, f32) keys and int64 payloads over
    `online.OnlineIndex`'s overlay/merge lifecycle, with the adaptive
    maintenance pipeline and its background worker when configured; a
    lookup is one launch of the hand-written CUDA kernel's f64/i64 or
    f32/i64 instance (`kernels.ops.search_with_overlay`: walk, dense-leaf
    probe and overlay resolve), in place of the reference's fused XLA
    `search_with_overlay`; ranges bisect the epoch's pair table, the one
    part of the reference's `DeviceSnapshot` the store keeps on the
    device.
  * `KernelEngine`, the counterpart of the reference's `PallasEngine`:
    f32 keys, lookups through the f32 instance of the kernel
    (`kernels.ops.dili_search`, walk and dense-leaf probe in one launch)
    and the pair-table recheck, the tombstone overlay resolved over the
    kernel's result, ranges bisecting an f32 `DeviceSnapshot`; with
    `MaintenanceConfig(background=False)` its merges run the adaptive
    pipeline on the writer's thread.  Its `name` stays "pallas", so
    configs and `stats()` read as the reference's.

  * `ShardedEngine`: f64 (or f32) keys and int64 payloads over
    `core.distributed`'s range shards, all on one device: per-shard
    overlays and merges, and lookups that run one launch of the f64/i64
    (or f32/i64) instance per shard with the combined overlay resolved
    in it, on the reference's gather or a2a strategy.

Range queries are overlay-exact: the device bisects the key-sorted pair
table with enough headroom to cover pending tombstones, then the (small,
sorted) overlay window is merged host-side per query.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import distributed as D
from ..core import search as S
from ..core.dili import bulk_load, placement_dtype
from ..core.flat import flatten, merge_sorted_runs
from ..device import resolve_device
from ..kernels import ops as K
from ..maintain import (IncrementalFlattener, LeafAccounting,
                        fold_with_accounting, run_reclusters, run_retrains)
from ..obs import Telemetry
from ..online.merge import OnlineIndex, adjust_pressure
from ..online.overlay import (TombstoneOverlay, fold_overlay,
                              overlay_device_arrays)
from .config import IndexConfig
from .snapshot import DeviceSnapshot


# ---------------------------------------------------------------------------
# shared overlay-exact helpers
# ---------------------------------------------------------------------------


def _merged_items(snap_k: np.ndarray, snap_v: np.ndarray, ov_k: np.ndarray,
                  ov_v: np.ndarray, ov_t: np.ndarray):
    """Apply overlay entries over the key-sorted snapshot pair run and drop
    tombstones — the logical content of the index, independent of engine."""
    mk, (mv, mt) = merge_sorted_runs(
        np.asarray(snap_k, np.float64),
        (np.asarray(snap_v, np.int64), np.zeros(len(snap_k), np.int8)),
        np.asarray(ov_k, np.float64),
        (np.asarray(ov_v, np.int64), np.asarray(ov_t, np.int8)))
    live = mt == 0
    return mk[live], mv[live]


def _overlay_summary(overlays) -> dict:
    """The engine-independent overlay slice of `stats()`."""
    ovs = list(overlays)
    count = sum(ov.count for ov in ovs)
    tombs = sum(ov.n_tombstones for ov in ovs)
    return dict(pending_writes=count,
                overlay_live=count - tombs,
                overlay_tombstones=tombs,
                overlay_cap=sum(ov.cap for ov in ovs),
                overlay_fill=max((ov.full_fraction for ov in ovs),
                                 default=0.0))


class EngineTelemetryBase:
    """Shared `stats()` / `maint_timings()` / `metrics()` / `inspect()`:
    the same key trees as the reference's engines, composed from
    per-engine hooks:

      _stats_extra()      engine-specific keys (snapshot sizing, ...)
      _stats_overlays()   the overlays summarized for pending writes
                          (deduped during background merges)
      _timing_rows()      per-merge wall-time rows (build publish excluded)
      _queue_depth()      background scheduler depth (0 without one)
      _maint_error_list() background task failures (empty without one)
      _inspect_flats(), _inspect_flatteners(), _inspect_accounts()
                          what `obs.inspect.build_inspect` reads

    Engines also provide name, epoch, telemetry, n_flattens, n_merges,
    n_full_flattens, n_incremental_flattens, n_retrains and
    last_dirty_frac."""

    telemetry: Telemetry

    #: locality re-cluster count; engines with the maintenance subsystem
    #: override it
    n_reclusters: int = 0

    def _n_forced_full_flattens(self) -> int:
        """Unmappable-dirty-id fallbacks across the engine's flatteners."""
        return 0

    def _stats_extra(self) -> dict:
        return {}

    def _queue_depth(self) -> int:
        return 0

    def _maint_error_list(self) -> list:
        return []

    def _maint_degraded(self) -> bool:
        """Background retries exhausted -> merges run synchronously now
        (only the local engine's scheduler path can degrade)."""
        return False

    def close(self) -> None:
        pass

    # -- durability hooks (DESIGN.md section 14) ------------------------------

    #: shards the WAL fans out over (1 on every ported engine)
    n_wal_shards: int = 1

    def shard_ids(self, keys: np.ndarray) -> np.ndarray:
        """WAL shard routing for a write batch (all shard 0 on
        single-shard engines)."""
        return np.zeros(len(np.atleast_1d(keys)), np.int64)

    _on_publish = None

    def set_on_publish(self, cb) -> None:
        """Register a post-merge-publish callback (the durability manager
        checkpoints through it).  Runs on whichever thread published."""
        self._on_publish = cb

    def _notify_publish(self) -> None:
        if self._on_publish is not None:
            self._on_publish()

    def stats(self) -> dict:
        errors = self._maint_error_list()
        return dict(engine=self.name, epoch=self.epoch,
                    **self._stats_extra(),
                    **_overlay_summary(self._stats_overlays()),
                    n_flattens=self.n_flattens, n_merges=self.n_merges,
                    # the maintenance slice: flatten kinds, retrains and
                    # re-clusters, the last merge's dirty-row fraction, the
                    # background queue, and full re-flattens forced by an
                    # unmappable dirty id
                    n_full_flattens=self.n_full_flattens,
                    n_incremental_flattens=self.n_incremental_flattens,
                    n_retrains=self.n_retrains,
                    n_reclusters=self.n_reclusters,
                    n_forced_full_flattens=self._n_forced_full_flattens(),
                    dirty_row_fraction=self.last_dirty_frac,
                    maint_queue_depth=self._queue_depth(),
                    maint_errors=len(errors),
                    maint_degraded=self._maint_degraded(),
                    maint_error_logs=list(errors),
                    telemetry_enabled=self.telemetry.enabled,
                    ops_total=self.telemetry.ops_total)

    def maint_timings(self) -> list[dict]:
        """Per-merge wall times: merge_s (fold+retrain+flatten),
        publish_s (upload+flip), incremental, dirty_frac."""
        return self._timing_rows()

    def metrics(self) -> dict:
        """The JSON-able telemetry snapshot (`dili.metrics/1`)."""
        return dict(engine=self.name, **self.telemetry.snapshot())

    # -- index-health introspection (obs.inspect) -----------------------------

    def _inspect_flats(self) -> list:
        """Published FlatDILI snapshot(s)."""
        raise NotImplementedError

    def _inspect_flatteners(self) -> list:
        """Live IncrementalFlattener instances ([] = maintenance off)."""
        return []

    def _inspect_accounts(self) -> list:
        """Live LeafAccounting instances ([] = accounting off)."""
        return []

    def inspect(self) -> dict:
        """The engine-independent `dili.inspect/1` health document; the
        facade layers the WAL footprint on top."""
        from ..obs.inspect import build_inspect
        accounts = []
        for acct in self._inspect_accounts():
            accounts.extend(acct.accounts())
        ov = _overlay_summary(self._stats_overlays())
        return build_inspect(
            engine=self.name, epoch=self.epoch,
            flats=self._inspect_flats(),
            flatteners=self._inspect_flatteners(),
            accounts=accounts,
            overlay=dict(pending=ov["pending_writes"],
                         live=ov["overlay_live"],
                         tombstones=ov["overlay_tombstones"],
                         cap=ov["overlay_cap"],
                         fill=ov["overlay_fill"]))


def _reject_background(cfg: IndexConfig, engine: str) -> None:
    if cfg.maintenance is not None and cfg.maintenance.background:
        raise ValueError(
            f"background maintenance requires the local engine (its "
            f"double-buffered SnapshotStore); the {engine} engine "
            f"supports maintenance=MaintenanceConfig(background=False)")


def _merge_range_windows(ks, vs, cnt, lo, hi, ov_k, ov_v, ov_t,
                         max_hits: int):
    """Resolve overlay state over per-query snapshot range windows: each
    query merges its overlay slice [lo, hi) last-write-wins and truncates
    back to `max_hits`."""
    q_n = len(cnt)
    out_k = np.full((q_n, max_hits), np.inf)
    out_v = np.full((q_n, max_hits), -1, np.int64)
    out_c = np.zeros(q_n, np.int32)
    ks = np.asarray(ks, np.float64)
    vs = np.asarray(vs, np.int64)
    starts = np.searchsorted(ov_k, lo, side="left")
    ends = np.searchsorted(ov_k, hi, side="left")
    for i in range(q_n):
        mk, mv = _merged_items(ks[i][: cnt[i]], vs[i][: cnt[i]],
                               ov_k[starts[i]: ends[i]],
                               ov_v[starts[i]: ends[i]],
                               ov_t[starts[i]: ends[i]])
        c = min(len(mk), max_hits)
        out_k[i, :c] = mk[:c]
        out_v[i, :c] = mv[:c]
        out_c[i] = c
    return out_k, out_v, out_c


def _pair_table_recheck(pk, pv, q, v, f):
    """Comparison-exact patch for point-lookup miss lanes: a miss whose
    query is in the key-sorted pair table becomes a hit with its payload.
    Found lanes are always true hits (tag + key equality).  The reference
    needs it because compiled XLA may contract `a + b*q` into an FMA; the
    port rounds twice everywhere, so it is expected to change no lane."""
    i = torch.clamp(torch.searchsorted(pk, q), 0, pk.shape[0] - 1)
    hit = pk[i] == q
    v = v.to(pv.dtype)
    return torch.where(f, v, torch.where(hit, pv[i], v)), f | hit


def _tombstone_headroom(ov_k, ov_t, lo, hi) -> int:
    """Extra snapshot rows the device window must fetch so that dropping
    tombstoned keys still leaves `max_hits` live candidates."""
    tk = ov_k[np.asarray(ov_t) > 0]
    if len(tk) == 0:
        return 0
    return int(np.max(np.searchsorted(tk, hi, side="left")
                      - np.searchsorted(tk, lo, side="left")))


def _truncate_windows(ks, vs, cnt, max_hits: int):
    """No-overlay fast path: clip device windows fetched with headroom back
    to `max_hits` without a host merge."""
    ks = np.asarray(ks, np.float64)[:, :max_hits]
    vs = np.asarray(vs, np.int64)[:, :max_hits]
    cnt = np.minimum(np.asarray(cnt, np.int32), max_hits)
    pos = np.arange(max_hits)[None, :]
    ks = np.where(pos < cnt[:, None], ks, np.inf)
    vs = np.where(pos < cnt[:, None], vs, -1)
    return ks, vs, cnt


def _overlay_exact_range(entries, lo, hi, max_hits: int, device_range):
    """Size the device fetch with tombstone headroom, bisect on the device
    via `device_range(lo, hi, fetch)` (numpy out), then either truncate (no
    pending writes) or merge each query's overlay slice host-side."""
    ov_k, ov_v, ov_t = entries
    fetch = max_hits + _tombstone_headroom(ov_k, ov_t, lo, hi)
    if fetch > max_hits:
        # pow2-quantize the over-fetch (the reference's shapes); extra rows
        # are clipped by the truncate/merge step below
        fetch = max_hits + (1 << (fetch - max_hits - 1).bit_length())
    ks, vs, cnt = device_range(lo, hi, fetch)
    if len(ov_k) == 0:
        return _truncate_windows(ks, vs, cnt, max_hits)
    return _merge_range_windows(ks, vs, cnt, lo, hi, ov_k, ov_v, ov_t,
                                max_hits)


# ---------------------------------------------------------------------------
# LocalEngine
# ---------------------------------------------------------------------------


class LocalEngine(EngineTelemetryBase):
    """Single-process engine over the online-update lifecycle: writes land
    in the tombstone overlay, a lookup is ONE launch of the kernel's
    f64/i64 instance, or its f32/i64 one at `dtype=float32` (their plain
    version on a CPU device), merges follow the configured `MergePolicy`
    and `MaintenanceConfig`, background merges included (DESIGN.md
    sections 8-9 and 12).  At f32, as in the reference, the tree is built
    and placed in f64 and its tables are then cast to f32, so keys that
    f32 does not hold exactly may be missed.

    `kernel_stats` counts, since build, `lookups` (engine calls) and
    `lanes` (queries sent to the kernel), and gives `table_bytes`, the
    current epoch's kernel tables as uploaded — port only."""

    name = "local"

    def __init__(self, keys: np.ndarray, vals: np.ndarray, cfg: IndexConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.telemetry = Telemetry(enabled=cfg.telemetry)
        self.oi = OnlineIndex(keys, vals, policy=cfg.merge,
                              overlay_cap=cfg.overlay_cap,
                              dtype=cfg.resolved_dtype, pad=cfg.pad,
                              early_exit=cfg.early_exit,
                              maintenance=cfg.maintenance,
                              telemetry=self.telemetry, device=self.device,
                              **cfg.bulk_load_kw())

    # -- reads --------------------------------------------------------------

    def lookup(self, queries):
        return self.oi.lookup(queries)

    def range(self, lo, hi, max_hits):
        oi = self.oi

        def device_range(lo_, hi_, fetch):
            dt = oi.store.dtype
            out = S.range_query_batch(oi.store.pairs,
                                      S._t(lo_, dt, self.device),
                                      S._t(hi_, dt, self.device),
                                      max_hits=fetch)
            return tuple(x.cpu().numpy() for x in out)

        # pending entries captured BEFORE the snapshot is read in
        # device_range (see OnlineIndex.pending_entries)
        return _overlay_exact_range(oi.pending_entries(), lo, hi, max_hits,
                                    device_range)

    def get(self, key: float):
        return self.oi.get(key)

    @property
    def snapshot(self):
        """The current epoch's `DeviceSnapshot`, uploaded on each call
        (pending overlay writes are NOT in it)."""
        return self.oi.store.idx

    # -- writes -------------------------------------------------------------

    def upsert(self, keys, vals):
        self.oi.upsert_batch(keys, vals)

    def delete(self, keys):
        self.oi.delete_batch(keys)

    def flush(self):
        self.oi.flush()

    def close(self):
        self.oi.close()

    def set_on_publish(self, cb) -> None:
        # the OnlineIndex fires it itself at the end of every merge
        # pipeline run (writer thread or maintenance worker)
        self.oi.on_publish = cb

    def _maint_degraded(self) -> bool:
        return self.oi.maint_degraded

    def _inspect_flats(self) -> list:
        return [self.oi.store.flat]

    def _inspect_flatteners(self) -> list:
        fl = self.oi.flattener
        return [] if fl is None else [fl]

    def _inspect_accounts(self) -> list:
        acct = self.oi.accounting
        return [] if acct is None else [acct]

    # -- introspection ------------------------------------------------------

    def items(self):
        # pending entries BEFORE the flat (see OnlineIndex.pending_entries)
        ok, ovv, ott = self.oi.pending_entries()
        f = self.oi.store.flat
        return _merged_items(f.pair_key, f.pair_val, ok, ovv, ott)

    @property
    def kernel_stats(self) -> dict:
        return dict(self.oi.kernel_stats,
                    table_bytes=K.table_bytes(self.oi.store.kernel_tables))

    @property
    def host(self):
        return self.oi.dili

    @property
    def epoch(self) -> int:
        return self.oi.epoch

    @property
    def n_flattens(self) -> int:
        return self.oi.n_flattens

    @property
    def n_merges(self) -> int:
        return self.oi.n_merges

    @property
    def n_full_flattens(self) -> int:
        return self.oi.n_full_flattens

    @property
    def n_incremental_flattens(self) -> int:
        return self.oi.n_incremental_flattens

    @property
    def n_retrains(self) -> int:
        return self.oi.n_retrains

    @property
    def n_reclusters(self) -> int:
        return self.oi.n_reclusters

    def _n_forced_full_flattens(self) -> int:
        fl = self.oi.flattener
        return 0 if fl is None else fl.n_fallback_full

    @property
    def last_dirty_frac(self) -> float:
        return self.oi.last_dirty_frac

    def _timing_rows(self) -> list[dict]:
        return [dict(merge_s=st.merge_s, publish_s=st.publish_s,
                     incremental=st.incremental, dirty_frac=st.dirty_frac)
                for st in self.oi.store.history[1:]]

    def _stats_overlays(self):
        # while a frozen overlay is pending, summarize the DEDUPED view (a
        # key rewritten after the freeze is one distinct pending key)
        oi = self.oi
        pend = oi._merging
        return [oi.overlay] if pend is None else [pend.merged_with(oi.overlay)]

    def _queue_depth(self) -> int:
        sched = self.oi.scheduler
        return 0 if sched is None else sched.depth

    def _maint_error_list(self) -> list:
        sched = self.oi.scheduler
        return [] if sched is None else list(sched.errors)

    def _stats_extra(self) -> dict:
        store = self.oi.store
        return dict(max_depth=int(store.max_depth),
                    snapshot_keys=int(store.flat.n_pairs),
                    merge_reasons=dict(self.oi.merge_reasons),
                    device_bytes=store.stats.bytes_uploaded)


# ---------------------------------------------------------------------------
# KernelEngine
# ---------------------------------------------------------------------------


class KernelEngine(EngineTelemetryBase):
    """f32 kernel engine: lookups run the CUDA kernel (its plain version on
    a CPU device), ranges bisect an f32 `DeviceSnapshot`.  Keys are
    quantized to f32 at the boundary — duplicates after the cast collapse
    last-write-wins, the documented f32 tolerance rule.

    `kernel_stats` counts, since build: `lookups` (engine calls), `lanes`
    (queries sent to the kernel) and `recheck_changed` (miss lanes the
    pair-table recheck turned into hits)."""

    name = "pallas"

    def __init__(self, keys: np.ndarray, vals: np.ndarray, cfg: IndexConfig,
                 device="cuda"):
        _reject_background(cfg, self.name)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.telemetry = Telemetry(enabled=cfg.telemetry)
        self.kernel_stats = dict(lookups=0, lanes=0, recheck_changed=0)
        m = cfg.maintenance
        self.flattener = (IncrementalFlattener()
                          if m is not None and m.incremental else None)
        self.accounting = (LeafAccounting(m)
                           if m is not None and (m.retrain or m.recluster)
                           else None)
        k32, v64 = self._quantize(keys, vals)
        with placement_dtype(np.float32):
            self.dili = bulk_load(k32, v64, **cfg.bulk_load_kw())
        self.overlay = TombstoneOverlay.empty(cfg.overlay_cap)
        self._ov_mirror = None          # device overlay, rebuilt on write
        self.epoch = 0
        self.n_flattens = 0
        self.n_full_flattens = 0
        self.n_incremental_flattens = 0
        self.n_merges = 0
        self.n_retrains = 0
        self.n_reclusters = 0
        self.last_dirty_frac = 1.0
        self._timings: list[dict] = []
        self._writes_since_publish = 0
        self._writes_since_pressure = 0
        self._publish()

    def _n_forced_full_flattens(self) -> int:
        return 0 if self.flattener is None else self.flattener.n_fallback_full

    @staticmethod
    def _check_vals_i32(vals: np.ndarray) -> np.ndarray:
        """The kernel stores payloads as int32; reject out-of-range vals
        instead of silently wrapping."""
        vals = np.asarray(vals, np.int64)
        if len(vals) and (vals.max() >= 2**31 or vals.min() < -(2**31)):
            raise ValueError(
                "pallas engine payloads must fit int32 (the kernel's "
                "payload width); use the local or sharded engine for "
                ">=2^31 vals")
        return vals

    def _quantize(self, keys, vals) -> tuple[np.ndarray, np.ndarray]:
        """Cast keys to f32; collapse post-cast duplicates last-write-wins,
        with the reference's rate-limited `pallas_f32_collision` warning."""
        k32 = np.asarray(keys, np.float64).astype(np.float32)
        order = np.argsort(k32, kind="stable")
        k32, vals = k32[order], self._check_vals_i32(vals)[order]
        keep = np.ones(len(k32), bool)
        keep[:-1] = k32[:-1] != k32[1:]          # keep the LAST duplicate
        n_collapsed = int((~keep).sum())
        if n_collapsed:
            self.telemetry.metrics.warn(
                "pallas_f32_collision",
                f"pallas engine: {n_collapsed} of {len(k32)} build keys "
                f"collide after f32 quantization and were collapsed "
                f"last-write-wins. The kernel's f32 key domain represents "
                f"integers exactly only for |key| < 2**24 (16777216); "
                f"beyond that, adjacent keys closer than one f32 ulp alias "
                f"to the same value. Use the local or sharded engine for "
                f"full f64 key precision.", count=n_collapsed)
        return k32[keep].astype(np.float64), vals[keep]

    def _publish(self, merge_s: float = 0.0):
        t0 = time.perf_counter()
        fl = self.flattener
        with self.telemetry.span("merge.flatten"):
            if fl is not None:
                self.flat = fl.flatten(self.dili, self.dili.take_dirty())
                incremental = fl.last_incremental
                self.last_dirty_frac = (fl.last_dirty_rows
                                        / max(fl.last_total_rows, 1))
            else:
                self.flat = flatten(self.dili)
                self.dili.take_dirty()  # drain (unbounded growth otherwise)
                incremental = False
                self.last_dirty_frac = 1.0
        self.telemetry.sample_publish(
            n_segments=self.flat.n_segments,
            dirty_rows=(fl.last_dirty_rows if fl is not None
                        else self.flat.n_slots),
            total_rows=(fl.last_total_rows if fl is not None
                        else self.flat.n_slots))
        merge_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        with self.telemetry.span("merge.publish"):
            self.arrs = K.kernel_arrays(self.flat, device=self.device)
            self.snap = DeviceSnapshot.from_flat(
                self.flat, dtype=torch.float32, pad=self.cfg.pad,
                device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.n_flattens += 1
        if incremental:
            self.n_incremental_flattens += 1
        else:
            self.n_full_flattens += 1
        if self.epoch > 0:          # the build publish is not a merge row
            self._timings.append(dict(merge_s=merge_s,
                                      publish_s=time.perf_counter() - t0,
                                      incremental=incremental,
                                      dirty_frac=self.last_dirty_frac))
        self.epoch += 1

    def _f32(self, x) -> torch.Tensor:
        return torch.from_numpy(
            np.asarray(x, np.float64).astype(np.float32)).to(self.device)

    # -- reads --------------------------------------------------------------

    def lookup(self, queries):
        q32 = self._f32(queries)
        st = self.kernel_stats
        st["lookups"] += 1
        v, f = K.dili_search(self.arrs, q32, stats=st)
        arr = self.snap.arrays
        v, f2 = _pair_table_recheck(arr["pair_key"], arr["pair_val"], q32,
                                    v, f)
        st["recheck_changed"] += int((f2 & ~f).sum())
        f = f2
        if self.overlay.count:
            if self._ov_mirror is None:
                self._ov_mirror = overlay_device_arrays(
                    self.overlay, torch.float32, device=self.device)
            v, f = S.resolve_overlay(self._ov_mirror, q32, v, f)
        return (v.cpu().numpy().astype(np.int64, copy=False),
                f.cpu().numpy().astype(bool, copy=False))

    def range(self, lo, hi, max_hits):
        lo32 = np.asarray(lo, np.float64).astype(np.float32)
        hi32 = np.asarray(hi, np.float64).astype(np.float32)

        def device_range(lo_, hi_, fetch):
            out = S.range_query_batch(self.snap, self._f32(lo_),
                                      self._f32(hi_), max_hits=fetch)
            return tuple(x.cpu().numpy() for x in out)

        return _overlay_exact_range(self.overlay.entries(), lo32, hi32,
                                    max_hits, device_range)

    def get(self, key: float):
        k = float(np.float32(key))
        state, v = self.overlay.get(k)
        if state == 0:                      # LIVE
            return v
        if state == 1:                      # TOMBSTONE
            return None
        # the host walk must predict in the precision the tree was placed in
        with placement_dtype(np.float32):
            return self.dili.search(k)

    # -- writes -------------------------------------------------------------

    def _quantize_keys(self, keys) -> np.ndarray:
        """f32-quantize write keys, but REJECT integer-valued keys the cast
        moves (|key| >= 2**24: the write would land on a different logical
        key).  Fractional keys stay under the f32 tolerance rule."""
        k64 = np.atleast_1d(np.asarray(keys, np.float64))
        k32 = k64.astype(np.float32).astype(np.float64)
        moved = (k32 != k64) & (np.floor(k64) == k64) & np.isfinite(k64)
        if moved.any():
            raise ValueError(
                f"pallas engine: integer key {k64[moved][0]!r} is not "
                f"exactly representable in the kernel's f32 key domain "
                f"(integers are exact only for |key| < 2**24 = 16777216; "
                f"above that f32 spacing exceeds 1 and adjacent keys "
                f"alias) — the write would land on {k32[moved][0]!r}, a "
                f"different logical key. Use the local or sharded engine "
                f"for int64 keys at this magnitude.")
        return k32

    def upsert(self, keys, vals):
        # overlay reads resolve in int64, but a merge folds these into the
        # int32 kernel tables — enforce the width before accepting the write
        vals = self._check_vals_i32(np.atleast_1d(np.asarray(vals)))
        self.overlay = self.overlay.upsert_batch(self._quantize_keys(keys),
                                                 vals)
        self._ov_mirror = None
        self._note_writes(len(np.atleast_1d(keys)))

    def delete(self, keys):
        self.overlay = self.overlay.delete_batch(self._quantize_keys(keys))
        self._ov_mirror = None
        self._note_writes(len(np.atleast_1d(keys)))

    def _note_writes(self, n: int):
        self._writes_since_publish += n
        self._writes_since_pressure += n
        p = self.cfg.merge
        trigger = (self.overlay.full_fraction >= p.max_fill
                   or self._writes_since_publish >= p.max_writes)
        if not trigger and self._writes_since_pressure >= p.pressure_check_every:
            self._writes_since_pressure = 0
            with placement_dtype(np.float32):   # leaf walk predicts in f32
                trigger = (adjust_pressure(self.dili, self.overlay,
                                           p.pressure_min_pending)
                           > p.pressure_lambda)
        if trigger:
            self.flush()

    def flush(self):
        if self.overlay.count == 0:
            return
        t0 = time.perf_counter()
        tel = self.telemetry
        # the host walk (and any retrain's or split's bulk load) places
        # slots in the same f32 arithmetic the kernel searches with
        with placement_dtype(np.float32):
            if self.accounting is not None:
                with tel.span("merge.fold"):
                    fold_with_accounting(self.dili, self.overlay,
                                         self.accounting)
                with tel.span("merge.retrain"):
                    self.n_retrains += run_retrains(self.dili,
                                                    self.accounting)
                with tel.span("merge.recluster"):
                    r = run_reclusters(self.dili, self.accounting,
                                       self.flattener)
                if r:
                    self.n_reclusters += r
                    if tel.enabled:
                        tel.metrics.count("maint.reclusters", r)
            else:
                with tel.span("merge.fold"):
                    fold_overlay(self.dili, self.overlay)
        self.overlay = TombstoneOverlay.empty(self.cfg.overlay_cap)
        self._ov_mirror = None
        self.n_merges += 1
        self._writes_since_publish = 0
        self._writes_since_pressure = 0
        self._publish(merge_s=time.perf_counter() - t0)
        self._notify_publish()

    # -- introspection ------------------------------------------------------

    def items(self):
        ok, ovv, ott = self.overlay.entries()
        return _merged_items(self.flat.pair_key, self.flat.pair_val,
                             ok, ovv, ott)

    @property
    def host(self):
        return self.dili

    @property
    def snapshot(self):
        return self.snap

    def _timing_rows(self) -> list[dict]:
        return list(self._timings)

    def _stats_overlays(self):
        return [self.overlay]

    def _inspect_flats(self) -> list:
        return [self.flat]

    def _inspect_flatteners(self) -> list:
        return [] if self.flattener is None else [self.flattener]

    def _inspect_accounts(self) -> list:
        return [] if self.accounting is None else [self.accounting]

    def _stats_extra(self) -> dict:
        return dict(max_depth=self.flat.max_depth,
                    snapshot_keys=int(self.flat.n_pairs),
                    # the reference's column layout, as on every engine
                    table_bytes=K.column_bytes(self.arrs),
                    # the CUDA kernel serves every table size
                    kernel_eligible=self.device.type == "cuda",
                    device_bytes=self.snap.nbytes)


# ---------------------------------------------------------------------------
# ShardedEngine
# ---------------------------------------------------------------------------


class _ShardView(NamedTuple):
    """What a sharded read resolves against, published as one object: the
    shards' device copy and the per-shard overlays that go with it (a merge
    replaces both together, so a lock-free reader never pairs the old
    tables with the emptied overlays)."""
    arrs: dict
    overlays: tuple


class ShardedEngine(EngineTelemetryBase):
    """Range-sharded engine on one device: quantile range partitioning,
    per-shard tombstone overlays, lookups on the gather or a2a strategy
    with the combined overlay resolved in each shard's kernel launch
    (`core.distributed`), and single-shard merges + republish.  Query
    batches are padded to a shard multiple with +inf (guaranteed misses)
    and unpadded on the way out, so callers never see the shard count.

    The reference clamps its shard count to its mesh's device count; here
    every shard lives on the one card, so `n_shards` is honoured up to
    half the key count (each shard's bulk load needs 2 keys), and None
    gives one shard, as on a one-device reference process.

    `kernel_stats` counts, since build, `lookups` (engine calls),
    `launches` (shard searches: one kernel launch each on the card, the
    plain version on the CPU), `lanes` (queries sent to them) and
    `a2a_fallbacks` (a2a batches that overflowed and were answered on the
    gather path), and gives `table_bytes`, the shards' kernel records as
    uploaded — port only."""

    name = "sharded"

    def __init__(self, keys: np.ndarray, vals: np.ndarray, cfg: IndexConfig,
                 device="cuda"):
        self.cfg = cfg
        self.telemetry = Telemetry(enabled=cfg.telemetry)
        _reject_background(cfg, self.name)
        self.device = resolve_device(device)
        # every shard's bulk_load needs >= 2 keys; a tiny index (e.g. a
        # freshly warmed session table) clamps to fewer shards rather than
        # crashing — it grows back onto more shards at the next build
        n = max(1, min(cfg.n_shards or 1, len(keys) // 2))
        self.sd = D.build_sharded(keys, vals, n_shards=n,
                                  overlay_cap=cfg.overlay_cap,
                                  keep_host=True, **cfg.bulk_load_kw())
        m = cfg.maintenance
        self._flatteners = ([IncrementalFlattener() for _ in range(n)]
                            if m is not None and m.incremental else None)
        self._accounting = ([LeafAccounting(m) for _ in range(n)]
                            if m is not None and (m.retrain or m.recluster)
                            else None)
        self.n_flattens = n                      # build flattened every shard
        self.n_full_flattens = n
        self.n_incremental_flattens = 0
        self.n_merges = 0
        self.n_retrains = 0
        self.n_reclusters = 0
        self.last_dirty_frac = 1.0
        self.n_publishes = 1
        self._timings: list[dict] = []
        self._writes_since_publish = 0
        self._writes_since_pressure = 0
        self._stats = dict(lookups=0, launches=0, lanes=0, a2a_fallbacks=0)
        self._stats_lock = threading.Lock()
        self._view = _ShardView(
            D.to_device(self.sd, self.device, dtype=cfg.resolved_dtype),
            tuple(self.sd.overlays))

    @property
    def arrs(self) -> dict:
        """The published device copy (`core.distributed.to_device`)."""
        return self._view.arrs

    def _pad(self, x) -> tuple[np.ndarray, int]:
        x = np.atleast_1d(np.asarray(x, np.float64))
        pad = (-len(x)) % self.sd.n_shards
        if pad:
            x = np.concatenate([x, np.full(pad, np.inf)])
        return x, len(x) - pad

    # -- reads --------------------------------------------------------------

    def lookup(self, queries):
        q, n = self._pad(queries)
        dt = self.cfg.resolved_dtype
        qd = S._t(q, dt, self.device)
        view = self._view               # tables and overlays, read once
        ova = D.combined_overlay_arrays(self.sd, dt, self.device,
                                        overlays=view.overlays)
        arrs = view.arrs
        st = dict(lookups=1, a2a_fallbacks=0)
        out = D.sharded_lookup(arrs, qd, strategy=self.cfg.lookup_strategy,
                               overlay=ova, stats=st)
        if self.cfg.lookup_strategy == "a2a" and int(out[2].sum()) > 0:
            # a2a buckets are capacity-bounded; overflowed lanes come back
            # found=False.  The facade's contract is exact results, so a
            # skewed batch that overflows re-resolves on the (always-exact)
            # gather path instead of silently reporting misses.
            st["a2a_fallbacks"] = 1
            out = D.sharded_lookup(arrs, qd, strategy="gather", overlay=ova,
                                   stats=st)
        with self._stats_lock:          # readers may call from many threads
            for k, n in st.items():
                self._stats[k] += n
        v, f = out[0], out[1]
        return (v.cpu().numpy().astype(np.int64, copy=False)[:n],
                f.cpu().numpy().astype(bool, copy=False)[:n])

    def range(self, lo, hi, max_hits):
        lo_p, n = self._pad(lo)
        hi_p, _ = self._pad(hi)
        dt = self.cfg.resolved_dtype
        view = self._view               # tables and overlays, read once

        def device_range(_lo, _hi, fetch):
            # the shard-multiple padded batch, as the reference's
            # collective needs; results are sliced back to the caller's n
            ks, vs, cnt = D.sharded_range_query(
                view.arrs, S._t(lo_p, dt, self.device),
                S._t(hi_p, dt, self.device), max_hits=fetch)
            return (ks.cpu().numpy()[:n], vs.cpu().numpy()[:n],
                    cnt.cpu().numpy()[:n])

        return _overlay_exact_range(D.overlay_entries(view.overlays),
                                    lo_p[:n], hi_p[:n], max_hits,
                                    device_range)

    def get(self, key: float):
        k = float(key)
        r = int(D.shard_of(self.sd, np.array([k]))[0])
        state, v = self.sd.overlays[r].get(k)
        if state == 0:
            return v
        if state == 1:
            return None
        return self.sd.dilis[r].search(k)

    # -- writes -------------------------------------------------------------

    def upsert(self, keys, vals):
        D.sharded_upsert(self.sd, keys, vals)
        self._view = self._view._replace(overlays=tuple(self.sd.overlays))
        self._note_writes(len(np.atleast_1d(keys)))

    def delete(self, keys):
        D.sharded_delete(self.sd, keys)
        self._view = self._view._replace(overlays=tuple(self.sd.overlays))
        self._note_writes(len(np.atleast_1d(keys)))

    def _note_writes(self, n: int):
        p = self.cfg.merge
        self._writes_since_publish += n
        self._writes_since_pressure += n
        trigger = (self._writes_since_publish >= p.max_writes
                   or any(ov.full_fraction >= p.max_fill
                          for ov in self.sd.overlays))
        if (not trigger
                and self._writes_since_pressure >= p.pressure_check_every):
            self._writes_since_pressure = 0
            trigger = any(
                ov.count and (adjust_pressure(d, ov, p.pressure_min_pending)
                              > p.pressure_lambda)
                for d, ov in zip(self.sd.dilis, self.sd.overlays))
        if trigger:
            self.flush()

    def _fold_shard(self, r: int, dili, ov) -> None:
        # always the sharded_merge fold hook, so the per-shard fold (and
        # any retrains) land as per-shard merge.fold/retrain spans
        if self._accounting is None:
            with self.telemetry.span("merge.fold", shard=r):
                fold_overlay(dili, ov)
            return
        acct = self._accounting[r]
        with self.telemetry.span("merge.fold", shard=r):
            fold_with_accounting(dili, ov, acct)
        with self.telemetry.span("merge.retrain", shard=r):
            self.n_retrains += run_retrains(dili, acct)
        fl = self._flatteners[r] if self._flatteners is not None else None
        with self.telemetry.span("merge.recluster", shard=r):
            n = run_reclusters(dili, acct, fl)
        if n:
            self.n_reclusters += n
            if self.telemetry.enabled:
                self.telemetry.metrics.count("maint.reclusters", n)

    def _flatten_shard(self, r: int, dili):
        with self.telemetry.span("merge.flatten", shard=r):
            if self._flatteners is None:
                flat = flatten(dili)
                dili.take_dirty()   # drain (a full flatten supersedes it)
                self.n_full_flattens += 1
                return flat
            fl = self._flatteners[r]
            flat = fl.flatten(dili, dili.take_dirty())
        if fl.last_incremental:
            self.n_incremental_flattens += 1
        else:
            self.n_full_flattens += 1
        return flat

    def flush(self):
        """Fold every shard with pending writes and republish the device
        copy, re-packing only the merged shards' kernel records.  (A
        policy trigger folds all pending shards too — the merge itself is
        still per-shard row rewrites, no global rebuild.)"""
        t0 = time.perf_counter()
        merged = D.sharded_merge(self.sd, max_fill=0.0,
                                 fold_fn=self._fold_shard,
                                 flatten_fn=self._flatten_shard)
        if merged:
            incremental = False
            if self._flatteners is not None:
                fls = [self._flatteners[r] for r in merged]
                self.last_dirty_frac = (
                    sum(f.last_dirty_rows for f in fls)
                    / max(sum(f.last_total_rows for f in fls), 1))
                # honest labeling: a flush is incremental only if every
                # merged shard actually spliced (cold caches full-flatten)
                incremental = all(f.last_incremental for f in fls)
            total_slots = sum(f.n_slots for f in self.sd.flats)
            self.telemetry.sample_publish(
                n_segments=sum(f.n_segments for f in self.sd.flats),
                dirty_rows=(sum(f.last_dirty_rows
                                for f in self._flatteners)
                            if self._flatteners is not None
                            else total_slots),
                total_rows=(sum(f.last_total_rows
                                for f in self._flatteners)
                            if self._flatteners is not None
                            else total_slots))
            merge_s = time.perf_counter() - t0
            self.n_merges += 1
            self.n_flattens += len(merged)
            self._writes_since_publish = 0
            self._writes_since_pressure = 0
            t0 = time.perf_counter()
            with self.telemetry.span("merge.publish", shards=len(merged)):
                arrs = D.to_device(self.sd, self.device,
                                   dtype=self.cfg.resolved_dtype,
                                   prev=self.arrs, shards=merged)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                # readers saw the pre-merge tables with the pre-merge
                # overlays until here
                self._view = _ShardView(arrs, tuple(self.sd.overlays))
            self.n_publishes += 1
            self._timings.append(dict(
                merge_s=merge_s, publish_s=time.perf_counter() - t0,
                incremental=incremental,
                dirty_frac=self.last_dirty_frac))
            self._notify_publish()

    # -- introspection ------------------------------------------------------

    def _n_forced_full_flattens(self) -> int:
        if self._flatteners is None:
            return 0
        return sum(fl.n_fallback_full for fl in self._flatteners)

    @property
    def n_wal_shards(self) -> int:
        return self.sd.n_shards

    def shard_ids(self, keys: np.ndarray) -> np.ndarray:
        return np.asarray(
            D.shard_of(self.sd, np.atleast_1d(np.asarray(keys, np.float64))),
            np.int64)

    def items(self):
        snap_k = np.concatenate([f.pair_key for f in self.sd.flats])
        snap_v = np.concatenate([f.pair_val for f in self.sd.flats])
        ok, ovv, ott = D.overlay_entries(self.sd.overlays)
        return _merged_items(snap_k, snap_v, ok, ovv, ott)

    @property
    def kernel_stats(self) -> dict:
        with self._stats_lock:
            st = dict(self._stats)
        return dict(st, table_bytes=sum(
            K.table_bytes(t) for t in self.arrs["kernel"]))

    @property
    def host(self):
        return self.sd.dilis

    @property
    def epoch(self) -> int:
        # publish-count semantics, like the other engines (a fresh build
        # is epoch 1 and every effective flush bumps it); `sd.epoch`
        # (merge count) stays internal
        return self.n_publishes

    def _timing_rows(self) -> list[dict]:
        return list(self._timings)

    def _stats_overlays(self):
        return self.sd.overlays

    def _inspect_flats(self) -> list:
        return list(self.sd.flats)

    def _inspect_flatteners(self) -> list:
        return list(self._flatteners or ())

    def _inspect_accounts(self) -> list:
        return list(self._accounting or ())

    def _stats_extra(self) -> dict:
        return dict(max_depth=self.sd.max_depth,
                    n_shards=self.sd.n_shards,
                    snapshot_keys=sum(int(f.n_pairs) for f in self.sd.flats),
                    per_shard_pending=[ov.count for ov in self.sd.overlays],
                    n_publishes=self.n_publishes,
                    # the reference's stacked column upload
                    device_bytes=D.column_bytes(self.sd,
                                                self.cfg.resolved_dtype))


ENGINE_CLASSES = {"local": LocalEngine, "pallas": KernelEngine,
                  "sharded": ShardedEngine}
