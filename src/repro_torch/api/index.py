"""`LearnedIndex`: one index object, many engines (port of
`repro/api/index.py`).

    from repro_torch.api import IndexConfig, LearnedIndex

    ix = LearnedIndex.build(keys, vals)    # IndexConfig(): the local engine
    vals, found = ix.lookup(queries)
    ks, vs, cnt = ix.range(lo, hi, max_hits=64)
    ix.upsert(new_keys, new_vals)      # visible immediately (overlay)
    ix.delete(dead_keys)               # visible immediately (tombstones)
    ix.flush()                         # fold + republish (Alg. 7/8)
    ix.save("index.npz"); ix2 = LearnedIndex.load("index.npz")

Three engines run: "local" (the default: f64 keys, or f32 with
`dtype=float32`, int64 payloads, one launch of the lookup kernel with the
overlay resolve fused in, and the adaptive maintenance pipeline with
background merges when `IndexConfig.maintenance` asks for it), "pallas"
(f32 keys through the f32 kernel instance, maintenance on the writer's
thread) and "sharded" (the keys split into `n_shards` key ranges, all on
the one device, each searched by its own launch of the f64/i64 instance;
maintenance on the writer's thread).  `inspect()` returns the
`dili.inspect/1` document and `start_trace`/`dump_trace` export the
`dili.trace/1` causal trace.
`IndexConfig(durability=DurabilityConfig(dir=...))` arms the write-ahead
log and checkpoints, and `LearnedIndex.recover(dir)` rebuilds an index
after a crash; both use the reference's on-disk formats, as do
`save`/`load`.  The engine runs on CUDA unless `build(..., device="cpu")`
(`recover` and `load` take the same argument).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import replace

import numpy as np

from ..durability.wal import OP_DELETE, OP_UPSERT
from .config import IndexConfig
from .engines import ENGINE_CLASSES


class LearnedIndex:
    """Engine-agnostic DILI facade.  All inputs/outputs are host numpy;
    device placement, kernel dispatch and overlay/merge scheduling are the
    engine's business.

    Threading: ONE logical writer — `upsert`, `delete` and `flush`
    serialize on an internal RLock, which also keeps the WAL-append ->
    engine-apply pair atomic (the durability ordering contract).  Reads
    (`lookup`/`range`/`get`/`items`) are lock-free: they resolve against
    the current published snapshot plus a functional overlay reference,
    which a publish (on the writer's thread or the maintenance worker)
    swaps atomically."""

    def __init__(self, engine, config: IndexConfig):
        self._engine = engine
        self.config = config
        self._dur = None        # DurabilityManager when config.durability
        self._write_lock = threading.RLock()

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, keys, vals=None, config: IndexConfig | None = None,
              device="cuda", **overrides) -> "LearnedIndex":
        """Bulk-load (Alg. 4) through the configured engine on `device`
        (the default config builds the local engine).  `overrides` are
        `IndexConfig` field replacements, e.g. `engine="pallas"`.

        With `config.durability` set, a fresh WAL + base checkpoint are
        armed under `durability.dir` (any previous durability state there
        is superseded — use `LearnedIndex.recover` to resurrect it
        instead of rebuilding)."""
        cfg = config or IndexConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
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
        ix = cls(ENGINE_CLASSES[cfg.engine](keys, vals, cfg, device=device),
                 cfg)
        if cfg.durability is not None:
            ix._attach_durability(fresh=True)
        return ix

    def _attach_durability(self, *, fresh: bool,
                           resume_lsns: dict | None = None,
                           start_step: int = 0) -> None:
        """Arm the WAL + checkpoint subsystem for this index (DESIGN.md
        section 14) and hook merge publishes to checkpointing."""
        from ..durability.manager import DurabilityManager
        self._dur = DurabilityManager.attach(
            self.config.durability, self, fresh=fresh,
            resume_lsns=resume_lsns, start_step=start_step)
        self._engine.set_on_publish(self._dur.on_merge_publish)

    @classmethod
    def recover(cls, dur_dir: str, config: IndexConfig | None = None,
                engine: str | None = None,
                device="cuda") -> "LearnedIndex":
        """Rebuild on `device` from the durability directory after a
        crash: newest valid checkpoint + WAL tail replay
        (`repro_torch.durability.recover`)."""
        from ..durability.recovery import recover as _recover
        return _recover(dur_dir, config=config, engine=engine, device=device)

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
        tel = self._engine.telemetry
        on = tel.enabled
        if on:
            tc = time.perf_counter()
        q = np.atleast_1d(np.asarray(queries, np.float64))
        if not np.isfinite(q).all():
            raise ValueError("queries must be finite")
        n = len(q)
        lanes = self._pad_batch(n)
        if lanes > n:
            q = np.concatenate([q, np.full(lanes - n, q[0])])
        if on:
            t0 = time.perf_counter()
            tel.spans.stage("lookup.check", tc, t0)
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

    def _timed_write(self, op: str, n: int, fn, *args,
                     wal_op: int | None = None) -> None:
        """Run one write under the writer lock, timed into `op.<name>`
        when telemetry is on.  With `wal_op` the batch (`args`: keys and,
        for an upsert, vals) is appended to the WAL first, inside the lock
        and the timing."""
        tel = self._engine.telemetry
        with self._write_lock:
            if tel.enabled:
                t0 = time.perf_counter()
                if wal_op is not None:
                    self._log_write(wal_op, *args)
                fn(*args)
                self._mark_applied(wal_op)
                self._record(op, tel, t0, n)
            else:
                tel.count_ops(n)
                if wal_op is not None:
                    self._log_write(wal_op, *args)
                fn(*args)
                self._mark_applied(wal_op)

    def _mark_applied(self, wal_op: int | None) -> None:
        """After the engine applied a logged write: move the checkpoint
        watermark past it (`DurabilityManager.mark_applied`)."""
        if wal_op is not None and self._dur is not None:
            self._dur.mark_applied()

    def _log_write(self, op: int, keys: np.ndarray,
                   vals: np.ndarray | None = None) -> None:
        """WAL-before-apply: persist the batch before the engine (and
        thus the caller) sees it as accepted.  A crash between the append
        and the in-memory apply replays a write the engine never served —
        upsert/delete replay is idempotent, so that is safe; the reverse
        order would acknowledge writes a crash could lose."""
        if self._dur is None:
            return
        tr = self._engine.telemetry.trace
        t0 = time.perf_counter()
        self._dur.log(op, keys, vals, epoch=self._engine.epoch,
                      shard_ids=self._engine.shard_ids(keys))
        if tr.enabled:
            tr.add("wal.append", t0=t0, dur_s=time.perf_counter() - t0,
                   track="wal", n_ops=len(keys))

    def upsert(self, keys, vals) -> None:
        """Insert-or-update (Alg. 7 at merge time); visible immediately."""
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        vals = np.atleast_1d(np.asarray(vals, np.int64))
        if len(keys) != len(vals):
            raise ValueError(f"{len(keys)} keys vs {len(vals)} vals")
        if not np.isfinite(keys).all():
            raise ValueError("keys must be finite")
        self._timed_write("upsert", len(keys), self._engine.upsert, keys,
                          vals, wal_op=OP_UPSERT)

    def delete(self, keys) -> None:
        """Delete (Alg. 8 at merge time); visible immediately."""
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        if not np.isfinite(keys).all():
            raise ValueError("keys must be finite")
        self._timed_write("delete", len(keys), self._engine.delete, keys,
                          wal_op=OP_DELETE)

    def flush(self) -> dict:
        """Fold every pending write through the host tree and republish;
        returns `stats()` afterwards.  With background maintenance this is
        the synchronous barrier (drains the worker first); with
        durability armed it is also the WAL's fsync barrier."""
        with self._write_lock:
            self._timed_write("flush", 1, self._engine.flush)
            if self._dur is not None:
                self._dur.sync()
        return self.stats()

    def close(self) -> None:
        """Release engine resources (stops the background maintenance
        worker); pending writes stay readable.  With durability armed,
        the WAL gets a final fsync AFTER the engine drains (a draining
        background merge may still publish a checkpoint)."""
        self._engine.close()
        if self._dur is not None:
            self._dur.close()

    def abandon(self) -> None:
        """Crash simulation (tests/benchmarks): drop the index WITHOUT the
        final WAL fsync, as a SIGKILL would.  The engine's background
        worker is still stopped so the process can exit."""
        if self._dur is not None:
            self._dur.abandon()  # first: late publishes must no-op
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
        reference's on every engine.  With durability armed, its `wal`
        block gives the WAL's and the checkpoints' bytes and files."""
        doc = self._engine.inspect()
        if self._dur is not None:
            doc["wal"] = dict(doc["wal"], **self._wal_inspect())
        return doc

    def _wal_inspect(self) -> dict:
        """On-disk durability footprint (armed indexes only)."""
        def du(d):
            # recursive: WAL segments live under shard_NNNNN/ subdirs,
            # checkpoints under step_NNNNNNNN/ subdirs
            b = n = 0
            for root, _dirs, files in os.walk(d):
                for f in files:
                    try:
                        b += os.path.getsize(os.path.join(root, f))
                        n += 1
                    except OSError:
                        pass
            return b, n
        wal_b, wal_n = du(str(self._dur.wal_dir))
        ck_b, ck_n = du(str(self._dur.ckpt_dir))
        return dict(armed=True, n_shards=len(self._dur.writers),
                    wal_bytes=int(wal_b), n_wal_files=int(wal_n),
                    ckpt_bytes=int(ck_b), n_ckpt_files=int(ck_n))

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

    # -- persistence ---------------------------------------------------------

    @staticmethod
    def _npz_path(path: str) -> str:
        # np.savez appends .npz to bare paths; normalize on both sides so
        # save(p) -> load(p) always round-trips
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        """Persist the logical content (live keys/vals incl. pending
        writes) + config, in the reference's file format.  Load rebuilds
        the tree.  The write is atomic (tmp file + `os.replace`): a crash
        mid-save leaves either the previous file or the new one."""
        keys, vals = self.items()
        dst = self._npz_path(path)
        tmp = dst + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, keys=keys, vals=vals,
                         config=np.frombuffer(
                             json.dumps(self.config.to_json_dict()).encode(),
                             dtype=np.uint8))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dst)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path: str, config: IndexConfig | None = None,
             device="cuda") -> "LearnedIndex":
        """Rebuild from `save()` output (either package's) on `device`;
        `config` overrides the saved one."""
        with np.load(cls._npz_path(path)) as z:
            keys, vals = z["keys"], z["vals"]
            saved = json.loads(bytes(z["config"].tobytes()).decode())
        return cls.build(keys, vals,
                         config=config or IndexConfig.from_json_dict(saved),
                         device=device)

    @property
    def telemetry(self):
        return self._engine.telemetry

    @property
    def engine(self) -> str:
        return self._engine.name

    @property
    def device(self):
        """The torch device the engine's tables live on."""
        return self._engine.device

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
