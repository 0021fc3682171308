"""`recover(dir)`: checkpoint + WAL-tail replay -> a serving index.

The recovery protocol (DESIGN.md section 14):

  1. load    — walk published checkpoints newest-first (`latest` pointer
               promoted), skipping corrupt/partial ones; a corrupt newest
               checkpoint falls back to the previous valid one, whose
               smaller watermark simply means a longer tail to replay
               (truncation keeps segments until EVERY retained
               checkpoint's watermark passes them).
  2. replay  — rebuild the engine from the checkpoint pair table (the
               normal `build` path: bulk load, re-shard elastically, soft
               state re-derived), then apply each shard's WAL tail from
               the checkpoint's watermark through the normal facade
               upsert/delete fold path, in lsn order.  A torn trailing
               record truncates the tail at the first bad CRC.
  3. publish — attach a fresh `DurabilityManager` (new base checkpoint,
               lsn numbering continued, old segments left to age out),
               re-arming the WAL for new writes.

Spans `recovery.load` / `recovery.replay` / `recovery.publish` and the
`recovery.*` counters are recorded UNCONDITIONALLY on the rebuilt index's
telemetry (bypassing the `enabled` gate): recovery is rare and its
observability is the point — a disabled-telemetry index still shows the
recovery in `metrics()`.
"""

from __future__ import annotations

import os
import time

from . import checkpoint as ckpt
from . import wal
from .config import DurabilityConfig


def recover(dur_dir: str, config=None, engine: str | None = None,
            device="cuda"):
    """Rebuild a `LearnedIndex` on `device` from the durability directory
    `dur_dir` (an `IndexConfig.durability.dir`).  `config` overrides the
    checkpoint-recorded `IndexConfig` (its `durability` field is forced
    back to this directory); `engine` is a convenience engine override.
    Raises FileNotFoundError when no valid checkpoint exists."""
    from ..api.config import IndexConfig
    from ..api.index import LearnedIndex
    from dataclasses import replace

    ckpt_dir = os.path.join(dur_dir, "ckpt")
    wal_dir = os.path.join(dur_dir, "wal")
    t0 = time.perf_counter()
    chosen = None
    for name, manifest, keys, vals in ckpt.iter_checkpoints(ckpt_dir):
        chosen = (name, manifest, keys, vals)
        break
    if chosen is None:
        raise FileNotFoundError(
            f"no valid checkpoint under {ckpt_dir!r}; nothing to recover")
    name, manifest, keys, vals = chosen
    if config is None:
        config = IndexConfig.from_json_dict(manifest["config"])
    if engine is not None:
        config = replace(config, engine=engine)
    dur_cfg = replace(config.durability or DurabilityConfig(dir=dur_dir),
                      dir=dur_dir)
    load_s = time.perf_counter() - t0

    # -- replay: rebuild (durability detached — the manager re-attaches
    # with the POST-replay base checkpoint) then fold the tails ----------
    t0 = time.perf_counter()
    ix = LearnedIndex.build(keys, vals, config=replace(config,
                                                       durability=None),
                            device=device)
    watermarks = {int(s): int(l)
                  for s, l in manifest["wal_lsns"].items()}
    resume_lsns: dict[int, int] = {}
    n_records = n_tail_shards = 0
    for s in sorted(_shard_ids_on_disk(wal_dir) | set(watermarks)):
        d = wal.shard_dir(wal_dir, s)
        from_lsn = watermarks.get(s, 0)
        recs = wal.read_records(d, from_lsn=from_lsn)
        for r in recs:
            if r["op"] == wal.OP_UPSERT:
                ix.upsert(r["keys"], r["vals"])
            else:
                ix.delete(r["keys"])
        n_records += len(recs)
        if recs:
            n_tail_shards += 1
        resume_lsns[s] = (recs[-1]["lsn"] + 1 if recs
                          else max(from_lsn, wal.end_lsn(d)))
    replay_s = time.perf_counter() - t0

    # -- publish: new base checkpoint, WAL re-armed ----------------------
    t0 = time.perf_counter()
    ix.config = replace(config, durability=dur_cfg)
    ix._attach_durability(fresh=False, resume_lsns=resume_lsns,
                          start_step=int(manifest["step"]))
    publish_s = time.perf_counter() - t0

    # recovery observability is unconditional (see module docstring)
    tel = ix.telemetry
    tel.spans.record("recovery.load", load_s, checkpoint=name)
    tel.spans.record("recovery.replay", replay_s, records=n_records,
                     shards=n_tail_shards)
    tel.spans.record("recovery.publish", publish_s)
    tel.metrics.count("recovery.count")
    tel.metrics.count("recovery.replayed_records", n_records)
    return ix


def _shard_ids_on_disk(wal_dir: str) -> set[int]:
    if not os.path.isdir(wal_dir):
        return set()
    return {int(n[6:]) for n in os.listdir(wal_dir)
            if n.startswith("shard_")}
