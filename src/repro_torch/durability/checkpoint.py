"""Index checkpoints: the durable base state the WAL tail replays onto.

Reuses `repro_torch.ft.checkpoint`'s atomic-publish protocol — stage into
`step_X.tmp/`, `os.replace` to publish, best-effort `latest` pointer,
newest-first corruption-fallback walk (`step_candidates`) — over a
different payload: the index's logical content (the key-sorted live
pair table from `items()`) plus a manifest binding it to the WAL:

    <ckpt_dir>/step_NNNNNNNN/
        state.npz        # keys f64[n], vals i64[n]
        manifest.json    # step, epoch, wal_lsns, checksums, config
    <ckpt_dir>/latest

`wal_lsns` maps shard id -> the shard's next lsn AT CAPTURE TIME, sampled
BEFORE `items()` is read: any record racing past the sample is both in
the checkpoint and replayed on top of it, and replay in lsn order is
idempotent (last-write-wins), so the overlap is harmless — the other
order could lose acked writes.

The only difference from `ft.publish_dir` is a crash-injection point
between the `os.replace` and the `latest` move (`ckpt.mid_publish`): the
published step is then fully valid but unpointed, which is exactly the
state the candidates walk must tolerate.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np

from ..ft import checkpoint as ftck
from . import hooks

MANIFEST_VERSION = "dili.ckpt/1"


def write_checkpoint(ckpt_dir: str, step: int, keys: np.ndarray,
                     vals: np.ndarray, *, epoch: int, wal_lsns: dict,
                     config: dict | None = None, keep: int = 3) -> str:
    """Stage + atomically publish one checkpoint; returns its path."""
    keys = np.ascontiguousarray(keys, np.float64)
    vals = np.ascontiguousarray(vals, np.int64)
    name = ftck.step_name(step)
    tmp = ftck.make_tmp_dir(ckpt_dir, name)
    np.savez(os.path.join(tmp, "state.npz"), keys=keys, vals=vals)
    manifest = dict(version=MANIFEST_VERSION, step=step, epoch=epoch,
                    n_pairs=int(len(keys)),
                    wal_lsns={str(s): int(l) for s, l in wal_lsns.items()},
                    checksums=dict(keys=zlib.crc32(keys.tobytes()),
                                   vals=zlib.crc32(vals.tobytes())),
                    config=config or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    hooks.crash_point("ckpt.pre_publish")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    hooks.crash_point("ckpt.mid_publish")
    ftck.write_latest(ckpt_dir, name)
    ftck.gc_steps(ckpt_dir, keep)
    return final


def _load_one(path: str):
    """(manifest, keys, vals) of one published step dir; raises IOError on
    any corruption (bad json, checksum mismatch, truncated npz)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "state.npz")) as z:
        keys = np.asarray(z["keys"], np.float64)
        vals = np.asarray(z["vals"], np.int64)
    if len(keys) != manifest["n_pairs"] or len(vals) != manifest["n_pairs"]:
        raise IOError(f"pair count mismatch in {path}")
    if (zlib.crc32(keys.tobytes()) != manifest["checksums"]["keys"]
            or zlib.crc32(vals.tobytes()) != manifest["checksums"]["vals"]):
        raise IOError(f"state checksum mismatch in {path}")
    return manifest, keys, vals


def iter_checkpoints(ckpt_dir: str):
    """Yield (name, manifest, keys, vals) for every VALID checkpoint,
    newest first (the `latest` pointer promoted), silently walking past
    corrupt or partial ones — the recovery fallback order."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in ftck.step_candidates(ckpt_dir):
        try:
            manifest, keys, vals = _load_one(os.path.join(ckpt_dir, name))
        except Exception:              # corrupt/partial: fall back
            continue
        yield name, manifest, keys, vals


def retained_manifests(ckpt_dir: str) -> list[dict]:
    """Manifests of every currently-valid checkpoint (any order) — the
    input to the WAL truncation watermark: a segment may only be purged
    once EVERY retained checkpoint's watermark has passed it, so a
    corrupt newest checkpoint can still fall back and replay further."""
    return [m for _, m, _, _ in iter_checkpoints(ckpt_dir)]
