"""`DurabilityManager`: the hard/soft state split behind one object.

The overlay write stream is HARD state: `LearnedIndex.upsert/delete`
append to the per-shard WAL *before* the engine applies the write, so an
acknowledged write is always replayable.  Everything derived — device
snapshot, flattened pair table, maintenance accounting — is SOFT state,
rebuilt at recovery from checkpoint + WAL tail and never persisted
directly.

Lifecycle:

  attach(cfg, index, fresh=True)   at build: wipe any previous durability
                                   state (a rebuild supersedes it — use
                                   `LearnedIndex.recover` to resurrect),
                                   write the base checkpoint, start one
                                   `WalWriter` per engine shard.
  attach(cfg, index, fresh=False,  at recovery: continue each shard's lsn
         resume_lsns=...)          sequence where the replayed log ended,
                                   write a fresh base checkpoint, keep old
                                   segments until retained watermarks pass.
  log(op, keys, vals, epoch, ...)  append one batch (routed per shard)
                                   before the engine acknowledges it.
  on_merge_publish()               engine callback after each merge
                                   publish: every `checkpoint_every_merges`
                                   merges, checkpoint + rotate + truncate.
  sync() / close() / abandon()     durability barrier / clean shutdown /
                                   crash simulation (no final fsync).

Threading: `log` runs on the writer thread; `on_merge_publish` may run on
the maintenance worker (background merges).  A single lock serializes
checkpointing against appends and against concurrent publish callbacks;
the watermark is sampled under that lock BEFORE `items()` so replay
overlap stays idempotent (see durability.checkpoint).  A batch appended
but not yet applied by the engine (`log` up to `mark_applied`) stays
below the watermark of a checkpoint taken on another thread meanwhile:
`items()` there does not hold it yet, so it has to be replayed.
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np

from . import checkpoint as ckpt
from . import hooks, wal
from .config import DurabilityConfig


class DurabilityManager:
    def __init__(self, cfg: DurabilityConfig, index, *,
                 start_lsns: dict[int, int] | None = None,
                 extra_lsns: dict[int, int] | None = None,
                 start_step: int = 0):
        self.cfg = cfg
        self.index = index
        self.wal_dir = os.path.join(cfg.dir, "wal")
        self.ckpt_dir = os.path.join(cfg.dir, "ckpt")
        self._lock = threading.Lock()
        self._closed = False
        self._step = start_step
        self._merges_since_ckpt = 0
        # watermarks carried for shard dirs WITHOUT an active writer (the
        # shard count shrank across a recovery); persisted into every
        # manifest so their stale segments age out with the checkpoints
        self._extra_lsns = dict(extra_lsns or {})
        start_lsns = start_lsns or {}
        n = getattr(index._engine, "n_wal_shards", 1)
        self.writers = {
            s: wal.WalWriter(wal.shard_dir(self.wal_dir, s),
                             fsync=cfg.fsync,
                             fsync_interval_s=cfg.fsync_interval_s,
                             start_lsn=start_lsns.get(s, 0))
            for s in range(n)}
        # (writer thread, each shard's lsn before its append) while a
        # logged batch waits to be applied, else None
        self._unapplied: tuple[int, dict[int, int]] | None = None

    # -- construction --------------------------------------------------------

    @classmethod
    def attach(cls, cfg: DurabilityConfig, index, *, fresh: bool,
               resume_lsns: dict[int, int] | None = None,
               start_step: int = 0) -> "DurabilityManager":
        """Create the manager for `index` and publish its base checkpoint.

        fresh=True (a new `build`) wipes any existing WAL/checkpoint state
        under `cfg.dir` first.  fresh=False (post-recovery) continues each
        shard's lsn numbering at `resume_lsns` and leaves old segments for
        the watermark GC; shard dirs beyond the rebuilt engine's shard
        count keep their replayed end-lsn as a manifest-carried watermark.
        """
        if fresh and os.path.isdir(cfg.dir):
            shutil.rmtree(os.path.join(cfg.dir, "wal"), ignore_errors=True)
            shutil.rmtree(os.path.join(cfg.dir, "ckpt"), ignore_errors=True)
        resume = dict(resume_lsns or {})
        n = getattr(index._engine, "n_wal_shards", 1)
        extra = {s: l for s, l in resume.items() if s >= n}
        mgr = cls(cfg, index, start_lsns=resume, extra_lsns=extra,
                  start_step=start_step)
        mgr.checkpoint()
        return mgr

    # -- the write path ------------------------------------------------------

    def log(self, op: int, keys: np.ndarray, vals: np.ndarray | None,
            epoch: int, shard_ids: np.ndarray) -> None:
        """Append one acknowledged-to-be batch, routed to each shard's
        log.  Within a shard the per-key order is append order; across
        shards the key ranges are disjoint, so no cross-log ordering is
        needed."""
        with self._lock:
            if self._closed:
                raise RuntimeError("durability manager is closed")
            if self._unapplied is None:
                self._unapplied = (threading.get_ident(), {
                    s: w.next_lsn for s, w in self.writers.items()})
            if len(self.writers) == 1:
                self.writers[0].append(op, keys, vals, epoch)
            else:
                for s in np.unique(shard_ids):
                    m = shard_ids == s
                    self.writers[int(s)].append(
                        op, keys[m], None if vals is None else vals[m],
                        epoch)
        hooks.crash_point("wal.append")

    def mark_applied(self) -> None:
        """The engine has applied every batch logged so far (the facade
        calls this after each write, under its writer lock)."""
        with self._lock:
            self._unapplied = None

    def sync(self) -> None:
        """Durability barrier: fsync every shard log (facade `flush()`)."""
        with self._lock:
            if self._closed:
                return
            for w in self.writers.values():
                w.sync()

    # -- checkpointing -------------------------------------------------------

    def on_merge_publish(self) -> None:
        """Engine callback after a merge publish; checkpoints every
        `checkpoint_every_merges`-th call."""
        if self._closed:
            return
        self._merges_since_ckpt += 1
        if self._merges_since_ckpt >= self.cfg.checkpoint_every_merges:
            self._merges_since_ckpt = 0
            self.checkpoint()

    def checkpoint(self) -> str | None:
        """Capture `items()` into a new published checkpoint, rotate every
        shard log, and truncate segments below the oldest retained
        watermark.  Serialized: concurrent callers coalesce."""
        with self._lock:
            if self._closed:
                return None
            # watermark BEFORE items(): records racing past this sample
            # end up both in the checkpoint and in the replayed tail —
            # idempotent; sampling after could lose them.  A batch still
            # on its way into the engine on another thread is replayed
            # too (on the writer's own thread, a merge inside the apply,
            # the engine already holds it)
            lsns = {s: w.next_lsn for s, w in self.writers.items()}
            if self._unapplied is not None \
                    and self._unapplied[0] != threading.get_ident():
                lsns.update(self._unapplied[1])
            lsns.update(self._extra_lsns)
            keys, vals = self.index.items()
            self._step += 1
            path = ckpt.write_checkpoint(
                self.ckpt_dir, self._step, keys, vals,
                epoch=self.index.epoch, wal_lsns=lsns,
                config=self.index.config.to_json_dict(),
                keep=self.cfg.keep_checkpoints)
            for w in self.writers.values():
                w.rotate()
            self._truncate()
            return path

    def _truncate(self) -> None:
        """Purge WAL segments below the MIN watermark over every retained
        valid checkpoint (so a corrupt newer checkpoint can still fall
        back to an older one and replay a longer tail)."""
        manifests = ckpt.retained_manifests(self.ckpt_dir)
        if not manifests:
            return
        for s, w in self.writers.items():
            marks = [int(m["wal_lsns"].get(str(s), 0)) for m in manifests]
            w.purge_upto(min(marks))
        for s, end in list(self._extra_lsns.items()):
            marks = [int(m["wal_lsns"].get(str(s), 0)) for m in manifests]
            d = wal.shard_dir(self.wal_dir, s)
            wal.purge_dir_upto(d, min(marks))
            if not wal.list_segments(d):
                shutil.rmtree(d, ignore_errors=True)
                del self._extra_lsns[s]

    # -- shutdown ------------------------------------------------------------

    def close(self) -> None:
        """Clean shutdown: final fsync, close every log.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for w in self.writers.values():
                w.close()

    def abandon(self) -> None:
        """Crash simulation (tests): stop WITHOUT the final fsync.  Acked
        records were flushed to the OS per append, so reopening the
        directory sees exactly what a SIGKILL would have left."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for w in self.writers.values():
                w.abandon()
