"""Ground-truth oracle for differential workload checking.

`SortedOracle` is the simplest possible correct implementation of the
`LearnedIndex` read contract — a sorted key array plus a parallel value
array, mutated with numpy set operations — so any disagreement between it
and an engine is an engine bug (or a quantization-contract violation; see
the integer-key convention in `generator`).  Its `lookup` and `range`
return exactly the facade's shapes and padding conventions
(vals int64 / found bool; range keys +inf-padded, vals -1-padded, counts
int32 saturating at max_hits), so diffs are `np.testing.assert_array_equal`
— no tolerance knobs to hide bugs behind.
"""

from __future__ import annotations

import numpy as np

from ..core.flat import merge_sorted_runs


class SortedOracle:
    """Reference model: the exact logical content of the index."""

    def __init__(self, keys, vals=None):
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        if vals is None:
            vals = np.arange(len(keys), dtype=np.int64)
        vals = np.atleast_1d(np.asarray(vals, np.int64))
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
        keep = np.ones(len(keys), bool)
        keep[:-1] = keys[:-1] != keys[1:]       # last-write-wins, like build
        self.keys = keys[keep]
        self.vals = vals[keep]

    # -- writes --------------------------------------------------------------

    def upsert(self, keys, vals) -> None:
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        vals = np.atleast_1d(np.asarray(vals, np.int64))
        mk, (mv,) = merge_sorted_runs(self.keys, (self.vals,),
                                      keys, (vals,))
        self.keys, self.vals = mk, mv

    def delete(self, keys) -> None:
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        keep = ~np.isin(self.keys, keys)
        self.keys, self.vals = self.keys[keep], self.vals[keep]

    # -- reads (facade-shaped) ----------------------------------------------

    def lookup(self, queries) -> tuple[np.ndarray, np.ndarray]:
        q = np.atleast_1d(np.asarray(queries, np.float64))
        if len(self.keys) == 0:
            return np.full(len(q), -1, np.int64), np.zeros(len(q), bool)
        i = np.clip(np.searchsorted(self.keys, q), 0, len(self.keys) - 1)
        found = self.keys[i] == q
        vals = np.where(found, self.vals[i], -1)
        return vals.astype(np.int64), np.asarray(found, bool)

    def range(self, lo, hi, max_hits: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        lo = np.atleast_1d(np.asarray(lo, np.float64))
        hi = np.atleast_1d(np.asarray(hi, np.float64))
        q_n = len(lo)
        out_k = np.full((q_n, max_hits), np.inf)
        out_v = np.full((q_n, max_hits), -1, np.int64)
        out_c = np.zeros(q_n, np.int32)
        starts = np.searchsorted(self.keys, lo, side="left")
        ends = np.searchsorted(self.keys, hi, side="left")
        for i in range(q_n):
            c = min(int(ends[i] - starts[i]), max_hits)
            out_k[i, :c] = self.keys[starts[i]: starts[i] + c]
            out_v[i, :c] = self.vals[starts[i]: starts[i] + c]
            out_c[i] = c
        return out_k, out_v, out_c

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        return self.keys.copy(), self.vals.copy()

    def __len__(self) -> int:
        return len(self.keys)
