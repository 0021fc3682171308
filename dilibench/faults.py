"""Faults planted in the timed path, which the correctness check has to
find: each replaces one method of the program's `OnlineIndex`, under
which the facade's lookups and writes run.  Used by the fault tests at a
small size and by `control.py --fault` at a cell's own size; the
benchmark's own runs never plant one.

  unchanged — a write returns the state unchanged;
  half      — a lookup answers half of its batch and repeats those
              answers for the rest;
  altered   — one answer of each lookup is altered where it is produced.
"""

from __future__ import annotations

import numpy as np


def _unchanged(orig):
    def upsert_batch(self, keys, vals):
        """A write that returns the state unchanged."""
    return upsert_batch


def _half(orig):
    def lookup(self, queries):
        q = np.atleast_1d(np.asarray(queries, np.float64))
        h = max(1, len(q) // 2)
        v, f = orig(self, q[:h])
        reps = -(-len(q) // h)
        return np.tile(v, reps)[:len(q)], np.tile(f, reps)[:len(q)]
    return lookup


def _altered(orig):
    def lookup(self, queries):
        v, f = orig(self, queries)
        v = v.copy()
        v[len(v) // 3] += 1
        return v, f
    return lookup


FAULTS = {"unchanged": ("upsert_batch", _unchanged),
          "half": ("lookup", _half),
          "altered": ("lookup", _altered)}


def plant(name: str, setattr_=setattr) -> None:
    """Replace the method that fault `name` breaks (`setattr_` may be a
    test's `monkeypatch.setattr`, which undoes it)."""
    from repro_torch.online.merge import OnlineIndex
    attr, make = FAULTS[name]
    setattr_(OnlineIndex, attr, make(getattr(OnlineIndex, attr)))
