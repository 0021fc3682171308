"""The plain reference: a sorted-array key -> payload map in NumPy that
replays a window's op stream and works every answer out again.

It imports nothing of the program and takes nothing the program made: it
starts from the keys and payloads the benchmark generated and applies the
calls in the order the window sent them.  Semantics are the facade's
(`LearnedIndex`): an upsert inserts or updates and, within one call, the
later of two writes to a key wins; a delete removes the key; a lookup
answers (payload, found); a range [lo, hi) answers the first `max_hits`
live pairs ascending, keys padded with +inf, payloads with -1, and the
count saturating at `max_hits`.
"""

from __future__ import annotations

import numpy as np


def _last_wins(keys: np.ndarray, *cols: np.ndarray):
    """Sorted unique keys of one call, each with the columns of its last
    occurrence."""
    rev = slice(None, None, -1)
    u, first = np.unique(keys[rev], return_index=True)
    return (u, *(c[rev][first] for c in cols))


class SortedArrayMap:
    def __init__(self, keys, vals):
        k, v = _last_wins(np.asarray(keys, np.float64),
                          np.asarray(vals, np.int64))
        self.keys, self.vals = k, v

    def __len__(self) -> int:
        return len(self.keys)

    def lookup(self, q) -> tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, np.float64)
        pos = np.minimum(np.searchsorted(self.keys, q), len(self.keys) - 1)
        found = (self.keys[pos] == q) if len(self.keys) else \
            np.zeros(len(q), bool)
        vals = np.where(found, self.vals[pos], 0) if len(self.keys) else \
            np.zeros(len(q), np.int64)
        return vals.astype(np.int64), found

    def upsert(self, keys, vals) -> None:
        k, v = _last_wins(np.asarray(keys, np.float64),
                          np.asarray(vals, np.int64))
        pos = np.searchsorted(self.keys, k)
        hit = pos < len(self.keys)
        hit[hit] = self.keys[pos[hit]] == k[hit]
        self.vals[pos[hit]] = v[hit]
        if not hit.all():
            new_k, new_v = k[~hit], v[~hit]
            at = np.searchsorted(self.keys, new_k)
            self.keys = np.insert(self.keys, at, new_k)
            self.vals = np.insert(self.vals, at, new_v)

    def delete(self, keys) -> None:
        k = np.unique(np.asarray(keys, np.float64))
        self.vals = self.vals[~np.isin(self.keys, k)]
        self.keys = self.keys[~np.isin(self.keys, k)]

    def range(self, lo, hi, max_hits: int):
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        a = np.searchsorted(self.keys, lo, side="left")
        b = np.searchsorted(self.keys, hi, side="left")
        cnt = np.clip(b - a, 0, max_hits)
        ks = np.full((len(lo), max_hits), np.inf)
        vs = np.full((len(lo), max_hits), -1, np.int64)
        for i in range(len(lo)):
            ks[i, :cnt[i]] = self.keys[a[i]: a[i] + cnt[i]]
            vs[i, :cnt[i]] = self.vals[a[i]: a[i] + cnt[i]]
        return ks, vs, cnt.astype(np.int64)

    def apply(self, b, max_hits: int):
        """Replay one call (a `gen.generator.OpBatch`): its answer for a
        read, None for a write."""
        if b.op == "lookup":
            return self.lookup(b.keys)
        if b.op == "range":
            return self.range(b.lo, b.hi, max_hits)
        if b.op == "upsert":
            self.upsert(b.keys, b.vals)
        elif b.op == "delete":
            self.delete(b.keys)
        else:
            raise ValueError(f"unknown op {b.op!r}")
        return None


def wrong_lanes(op: str, got, want) -> int:
    """Lanes of one read call whose answer differs from the reference's: a
    lookup lane whose found flag differs, or whose payload differs where
    both found it; a range lane whose count, keys or payloads differ."""
    if op == "lookup":
        (gv, gf), (wv, wf) = got, want
        gv, gf = np.asarray(gv), np.asarray(gf, bool)
        if gf.shape != wf.shape:
            return len(wf)
        return int((gf != wf).sum() + (gf & wf & (gv != wv)).sum())
    if op == "range":
        (gk, gv, gc), (wk, wv, wc) = got, want
        if np.shape(gk) != wk.shape or np.shape(gc) != wc.shape:
            return len(wc)
        bad = ((np.asarray(gc) != wc) | (np.asarray(gk) != wk).any(1)
               | (np.asarray(gv) != wv).any(1))
        return int(bad.sum())
    raise ValueError(f"{op!r} has no answer to compare")
