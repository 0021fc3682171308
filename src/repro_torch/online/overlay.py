"""Tombstone-capable delta overlay: the write buffer of the online-update
subsystem (port of `repro/online/overlay.py`; DESIGN.md section 8).

A `TombstoneOverlay` is an immutable sorted run of pending writes — upserts
AND deletes — sitting in front of an immutable device snapshot, LSM-style.
Each entry is (key, val, tomb): `tomb != 0` marks a delete of a key that may
still exist in the snapshot.  Semantics:

  * last-write-wins: applying a batch dedupes by key keeping the newest
    entry, so upsert-then-delete leaves a tombstone and delete-then-upsert
    leaves a live pair;
  * capacity doubling: the backing arrays grow by powers of two, so the
    padded device mirror only changes shape on a doubling;
  * reads resolve overlay-hit / overlay-tombstone / snapshot-hit with
    `core.search.resolve_overlay` over the device mirror.

The structure is persistent (every write returns a new overlay) so a reader
holding one overlay mirror is never invalidated mid-lookup.  The class and
`fold_overlay` are the reference's numpy code, the fold's return value
aside.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.flat import merge_sorted_runs
from ..device import resolve_device

LIVE, TOMBSTONE = 0, 1


@dataclass(frozen=True)
class TombstoneOverlay:
    keys: np.ndarray    # f64 [cap], padded with +inf
    vals: np.ndarray    # i64 [cap]
    tomb: np.ndarray    # i8  [cap], 1 = tombstone
    count: int
    cap: int

    @staticmethod
    def empty(cap: int = 4096) -> "TombstoneOverlay":
        cap = max(int(cap), 1)
        return TombstoneOverlay(np.full(cap, np.inf),
                                np.zeros(cap, np.int64),
                                np.zeros(cap, np.int8), 0, cap)

    # -- writes (persistent: return a new overlay) --------------------------

    def _apply(self, k: np.ndarray, v: np.ndarray,
               t: np.ndarray) -> "TombstoneOverlay":
        if len(k) == 0 and self.count == 0:
            return self
        # the buffer is a sorted run: merge the batch in (last-write-wins)
        # instead of re-sorting the whole buffer on every write batch
        nk, (nv, nt) = merge_sorted_runs(
            self.keys[: self.count],
            (self.vals[: self.count], self.tomb[: self.count]),
            np.asarray(k, np.float64),
            (np.asarray(v, np.int64), np.asarray(t, np.int8)))
        cap = self.cap
        while len(nk) > cap:
            cap *= 2
        keys = np.full(cap, np.inf)
        vals = np.zeros(cap, np.int64)
        tomb = np.zeros(cap, np.int8)
        keys[: len(nk)] = nk
        vals[: len(nk)] = nv
        tomb[: len(nk)] = nt
        return TombstoneOverlay(keys, vals, tomb, len(nk), cap)

    def upsert_batch(self, k, v) -> "TombstoneOverlay":
        k = np.atleast_1d(np.asarray(k, np.float64))
        v = np.atleast_1d(np.asarray(v, np.int64))
        return self._apply(k, v, np.zeros(len(k), np.int8))

    def delete_batch(self, k) -> "TombstoneOverlay":
        k = np.atleast_1d(np.asarray(k, np.float64))
        return self._apply(k, np.zeros(len(k), np.int64),
                           np.ones(len(k), np.int8))

    def merged_with(self, newer: "TombstoneOverlay") -> "TombstoneOverlay":
        """One overlay equivalent to `self` with `newer` applied on top
        (newer wins per key).  Used by the background-merge read path: the
        frozen (merging) overlay under the live one."""
        return self._apply(*newer.entries())

    # -- host-side point state ----------------------------------------------

    def get(self, key: float) -> tuple[int, int | None]:
        """(state, val): state in {LIVE, TOMBSTONE, -1 absent}."""
        i = int(np.searchsorted(self.keys[: self.count], key))
        if i < self.count and self.keys[i] == key:
            if self.tomb[i]:
                return TOMBSTONE, None
            return LIVE, int(self.vals[i])
        return -1, None

    # -- introspection -------------------------------------------------------

    @property
    def full_fraction(self) -> float:
        return self.count / max(self.cap, 1)

    @property
    def n_tombstones(self) -> int:
        return int(self.tomb[: self.count].sum())

    @property
    def n_live(self) -> int:
        return self.count - self.n_tombstones

    def entries(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, vals, tomb) of the populated prefix, sorted by key."""
        return (self.keys[: self.count], self.vals[: self.count],
                self.tomb[: self.count])


def fold_overlay(dili, ov: TombstoneOverlay) -> bool:
    """Fold pending writes through the host DILI — the writer-boundary
    crossing shared by `OnlineIndex.merge` and `sharded_merge`: tombstones
    via Algorithm 8 (delete), live entries via Algorithm 7 (upsert).
    Returns whether any upsert inserted a key (port only: the reference
    returns None)."""
    keys, vals, tomb = ov.entries()
    inserted = False
    for k, v, t in zip(keys, vals, tomb):
        if t:
            dili.delete(float(k))
        elif dili.upsert(float(k), int(v)):
            inserted = True
    return inserted


# ---------------------------------------------------------------------------
# Device mirror
# ---------------------------------------------------------------------------


def overlay_device_arrays(ov: TombstoneOverlay, dtype=torch.float64,
                          device="cuda") -> dict:
    """Upload the overlay as tensors on `device` (CUDA unless asked
    otherwise).  Shapes are the (pow2) capacity."""
    device = resolve_device(device)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return dict(keys=torch.from_numpy(ov.keys.astype(np_dtype)).to(device),
                vals=torch.from_numpy(ov.vals.astype(np.int64)).to(device),
                tomb=torch.from_numpy(ov.tomb.astype(np.int8)).to(device))
