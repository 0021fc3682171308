"""`LearnedIndex`: one index object, many engines (port of
`repro/api/index.py`).

    from repro_torch.api import IndexConfig, LearnedIndex

    ix = LearnedIndex.build(keys, vals)    # IndexConfig(): the local engine
    vals, found = ix.lookup(queries)
    ks, vs, cnt = ix.range(lo, hi, max_hits=64)
    ix.upsert(new_keys, new_vals)      # visible immediately (overlay)
    ix.delete(dead_keys)               # visible immediately (tombstones)
    ix.flush()                         # fold + republish (Alg. 7/8)

Two engines run: "local" (the default: f64 keys, or f32 with
`dtype=float32`, int64 payloads, one launch of the lookup kernel with the
overlay resolve fused in, and the adaptive maintenance pipeline with
background merges when `IndexConfig.maintenance` asks for it) and
"pallas" (f32 keys through the f32 kernel instance, maintenance on the
writer's thread).  `inspect()` returns the `dili.inspect/1` document and
`start_trace`/`dump_trace` export the `dili.trace/1` causal trace.  The
engine runs on CUDA unless `build(..., device="cpu")`.  The sharded
engine, durability, persistence (`save`/`load`) and crash recovery
(`recover`) raise NotImplementedError until their slices land (see
ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace

import numpy as np

from .config import IndexConfig
from .engines import ENGINE_CLASSES


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet; "
                               f"see ROADMAP.md ({item})")


class LearnedIndex:
    """Engine-agnostic DILI facade.  All inputs/outputs are host numpy;
    device placement, kernel dispatch and overlay/merge scheduling are the
    engine's business.

    Threading: ONE logical writer — `upsert`, `delete` and `flush`
    serialize on an internal RLock.  Reads (`lookup`/`range`/`get`/
    `items`) are lock-free: they resolve against the current published
    snapshot plus a functional overlay reference, which a publish (on the
    writer's thread or the maintenance worker) swaps atomically."""

    def __init__(self, engine, config: IndexConfig):
        self._engine = engine
        self.config = config
        self._write_lock = threading.RLock()

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, keys, vals=None, config: IndexConfig | None = None,
              device="cuda", **overrides) -> "LearnedIndex":
        """Bulk-load (Alg. 4) through the configured engine on `device`
        (the default config builds the local engine).  `overrides` are
        `IndexConfig` field replacements, e.g. `engine="pallas"`."""
        cfg = config or IndexConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        if cfg.engine not in ENGINE_CLASSES:
            raise _not_ported(f"engine={cfg.engine!r}",
                              "item 7, the sharded engine")
        if cfg.durability is not None:
            raise _not_ported("durability", "item 4, durability")
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        if vals is None:
            vals = np.arange(len(keys), dtype=np.int64)
        vals = np.atleast_1d(np.asarray(vals, np.int64))
        if len(keys) != len(vals):
            raise ValueError(f"{len(keys)} keys vs {len(vals)} vals")
        if len(keys) == 0:
            raise ValueError("cannot build an empty index")
        if not np.isfinite(keys).all():
            raise ValueError("keys must be finite")
        # the bulk loader requires sorted unique keys; duplicates collapse
        # last-write-wins, matching upsert semantics
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
        keep = np.ones(len(keys), bool)
        keep[:-1] = keys[:-1] != keys[1:]
        keys, vals = keys[keep], vals[keep]
        return cls(ENGINE_CLASSES[cfg.engine](keys, vals, cfg, device=device),
                   cfg)

    @classmethod
    def recover(cls, *args, **kw) -> "LearnedIndex":
        raise _not_ported("recover", "item 4, durability")

    # -- reads ---------------------------------------------------------------

    def _pad_batch(self, n: int) -> int:
        """pow2 lane count for a batch of n queries (0 = don't pad), at
        least 64 lanes; padded lanes repeat a real query and are sliced
        off.  Kept from the reference so both see the same batch shapes."""
        if not self.config.pad or n == 0:
            return 0
        return 1 << max(6, (n - 1).bit_length())

    def lookup(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Batched point lookups -> (vals int64, found bool); vals only
        valid where found."""
        q = np.atleast_1d(np.asarray(queries, np.float64))
        if not np.isfinite(q).all():
            raise ValueError("queries must be finite")
        n = len(q)
        lanes = self._pad_batch(n)
        if lanes > n:
            q = np.concatenate([q, np.full(lanes - n, q[0])])
        tel = self._engine.telemetry
        if tel.enabled:
            t0 = time.perf_counter()
            v, f = self._engine.lookup(q)
            self._record("lookup", tel, t0, n)
        else:
            tel.count_ops(n)
            v, f = self._engine.lookup(q)
        return (np.asarray(v, np.int64)[:n],
                np.asarray(f, bool)[:n])

    def range(self, lo, hi,
              max_hits: int | None = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """For each [lo, hi): the first `max_hits` live pairs ascending —
        (keys [Q,H] +inf-padded, vals [Q,H] -1-padded, counts [Q]
        saturating at `max_hits`).  Overlay-exact."""
        lo = np.atleast_1d(np.asarray(lo, np.float64))
        hi = np.atleast_1d(np.asarray(hi, np.float64))
        if lo.shape != hi.shape:
            raise ValueError(f"lo {lo.shape} vs hi {hi.shape}")
        if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
            raise ValueError("range bounds must be finite")
        if max_hits is None:
            max_hits = self.config.max_hits
        if max_hits < 1:
            raise ValueError(f"max_hits must be >= 1, got {max_hits}")
        n = len(lo)
        lanes = self._pad_batch(n)
        if lanes > n:
            lo = np.concatenate([lo, np.full(lanes - n, lo[0])])
            hi = np.concatenate([hi, np.full(lanes - n, hi[0])])
        tel = self._engine.telemetry
        if tel.enabled:
            t0 = time.perf_counter()
            ks, vs, cnt = self._engine.range(lo, hi, max_hits)
            self._record("range", tel, t0, n)
        else:
            tel.count_ops(n)
            ks, vs, cnt = self._engine.range(lo, hi, max_hits)
        if lanes > n:
            ks, vs, cnt = ks[:n], vs[:n], cnt[:n]
        return ks, vs, cnt

    def get(self, key: float) -> int | None:
        """Host-side exact point read (overlay state wins)."""
        return self._engine.get(float(key))

    # -- writes --------------------------------------------------------------

    @staticmethod
    def _record(op: str, tel, t0: float, n: int) -> None:
        """Time an op into the histograms and, while a trace is armed, add
        its `op.<name>` event on the facade track (not for a flush, whose
        merge spans the trace already holds, as in the reference)."""
        dur = time.perf_counter() - t0
        tel.record_op(op, dur, n)
        if tel.trace.enabled and op != "flush":
            tel.trace.add(f"op.{op}", t0=t0, dur_s=dur, track="facade",
                          n_ops=n)

    def _timed_write(self, op: str, n: int, fn, *args) -> None:
        tel = self._engine.telemetry
        with self._write_lock:
            if tel.enabled:
                t0 = time.perf_counter()
                fn(*args)
                self._record(op, tel, t0, n)
            else:
                tel.count_ops(n)
                fn(*args)

    def upsert(self, keys, vals) -> None:
        """Insert-or-update (Alg. 7 at merge time); visible immediately."""
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        vals = np.atleast_1d(np.asarray(vals, np.int64))
        if len(keys) != len(vals):
            raise ValueError(f"{len(keys)} keys vs {len(vals)} vals")
        if not np.isfinite(keys).all():
            raise ValueError("keys must be finite")
        self._timed_write("upsert", len(keys), self._engine.upsert, keys,
                          vals)

    def delete(self, keys) -> None:
        """Delete (Alg. 8 at merge time); visible immediately."""
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        if not np.isfinite(keys).all():
            raise ValueError("keys must be finite")
        self._timed_write("delete", len(keys), self._engine.delete, keys)

    def flush(self) -> dict:
        """Fold every pending write through the host tree and republish;
        returns `stats()` afterwards."""
        self._timed_write("flush", 1, self._engine.flush)
        return self.stats()

    def close(self) -> None:
        """Release engine resources; pending writes stay readable."""
        self._engine.close()

    def __enter__(self) -> "LearnedIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection -------------------------------------------------------

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """The full live (keys, vals) content, key-sorted (O(n))."""
        return self._engine.items()

    def stats(self) -> dict:
        return self._engine.stats()

    def maint_timings(self) -> list[dict]:
        return self._engine.maint_timings()

    def metrics(self) -> dict:
        """The JSON-able telemetry snapshot (`dili.metrics/1` key tree)."""
        return self._engine.metrics()

    @property
    def kernel_stats(self) -> dict:
        """The engine's kernel counters — port only: lookups and lanes on
        both engines; on "pallas" the lanes the pair-table recheck
        changed, on "local" the kernel tables' bytes."""
        return dict(self._engine.kernel_stats)

    def inspect(self) -> dict:
        """The `dili.inspect/1` index-health document: depth and fanout
        histograms, leaf fill, the per-leaf model prediction error,
        segment dirty-row and heat blocks, overlay footprint.  Computed
        from host-side columns (no device sync); the key tree is the
        reference's on every engine.  Its `wal` block is the unarmed one
        until durability is ported."""
        return self._engine.inspect()

    # -- causal tracing -------------------------------------------------------

    def start_trace(self) -> None:
        """Arm causal tracing (requires `config.telemetry`): facade ops and
        merge spans are collected into a bounded ring, linked to the
        requests that caused them.  Export with `dump_trace`."""
        self._engine.telemetry.start_trace()

    def stop_trace(self) -> None:
        self._engine.telemetry.stop_trace()

    def dump_trace(self, path: str) -> str:
        """Write the collected trace as Chrome-trace-event JSON
        (`dili.trace/1`, Perfetto-viewable).  Returns `path`."""
        return self._engine.telemetry.trace.dump(
            path, process_name=f"dili:{self.engine}")

    def save(self, path: str) -> None:
        raise _not_ported("save()", "item 4, durability")

    @classmethod
    def load(cls, *args, **kw) -> "LearnedIndex":
        raise _not_ported("load()", "item 4, durability")

    @property
    def telemetry(self):
        return self._engine.telemetry

    @property
    def engine(self) -> str:
        return self._engine.name

    @property
    def epoch(self) -> int:
        return self._engine.epoch

    @property
    def n_flattens(self) -> int:
        return self._engine.n_flattens

    @property
    def n_merges(self) -> int:
        return self._engine.n_merges

    @property
    def host(self):
        """The mutable host writer (introspection only)."""
        return self._engine.host

    @property
    def snapshot(self):
        """The engine's current `DeviceSnapshot`."""
        return self._engine.snapshot
