"""`LearnedIndex`: one index object, many engines (port of
`repro/api/index.py`).

    from repro_torch.api import IndexConfig, LearnedIndex

    ix = LearnedIndex.build(keys, vals)    # IndexConfig(): the local engine
    vals, found = ix.lookup(queries)
    ks, vs, cnt = ix.range(lo, hi, max_hits=64)
    ix.upsert(new_keys, new_vals)      # visible immediately (overlay)
    ix.delete(dead_keys)               # visible immediately (tombstones)
    ix.flush()                         # fold + republish (Alg. 7/8)

Two engines run: "local" (the default: f64 keys, int64 payloads, one
launch of the f64 lookup kernel with the overlay resolve fused in) and
"pallas" (f32 keys through the f32 kernel instance).  The engine runs on
CUDA unless `build(..., device="cpu")`.  The sharded engine, persistence
(`save`/`load`), crash recovery and durability, `inspect()` and the
causal trace export raise NotImplementedError until their slices land
(see ROADMAP.md).
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
    serialize on an internal RLock.  Reads resolve against the current
    published snapshot plus a functional overlay reference."""

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
            raise _not_ported(f"engine={cfg.engine!r}", "the sharded "
                              "engine")
        if cfg.durability is not None:
            raise _not_ported("durability", "durability")
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
        raise _not_ported("recover", "durability")

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
            tel.record_op("lookup", time.perf_counter() - t0, n)
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
            tel.record_op("range", time.perf_counter() - t0, n)
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

    def _timed_write(self, op: str, n: int, fn, *args) -> None:
        tel = self._engine.telemetry
        with self._write_lock:
            if tel.enabled:
                t0 = time.perf_counter()
                fn(*args)
                tel.record_op(op, time.perf_counter() - t0, n)
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
        raise _not_ported("inspect()", "obs/inspect.py")

    def start_trace(self, *args, **kw) -> None:
        raise _not_ported("causal trace export", "obs/inspect.py")

    stop_trace = dump_trace = start_trace

    def save(self, path: str) -> None:
        raise _not_ported("save()", "durability")

    @classmethod
    def load(cls, *args, **kw) -> "LearnedIndex":
        raise _not_ported("load()", "durability")

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
