"""A configuration's data, made from the run's seed: the keys the index is
built on, their payloads, and the fresh keys a mix that inserts draws.

Kinds (the `data` block of `configs/<config>.json`):
  dataset — `gen.datasets.generate(name, n_keys, seed)`, the paper's
            synthetic datasets (section 7.1); payloads are row ids in a
            load order shuffled from the seed.
  ycsb    — YCSB's hashed record keys for records 0..n_keys-1
            (`gen.ycsb.record_keys`); the payload is the record number.
            The key set is the same for every seed, as YCSB's is for one
            `recordcount`; the seed drives the traffic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gen import datasets, ycsb


@dataclass(frozen=True)
class Data:
    keys: np.ndarray        # f64, sorted, unique
    vals: np.ndarray        # i64 payload of each key
    insert_pool: np.ndarray  # f64 fresh keys, disjoint from `keys`


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def make(spec: dict, seed: int, n_insert: int = 0) -> Data:
    """The keys, payloads and `n_insert` fresh keys of one data block."""
    kind, n = spec["kind"], int(spec["n_keys"])
    if kind == "dataset":
        keys = datasets.generate(spec["dataset"], n, seed)
        vals = _rng(seed, 1).permutation(len(keys)).astype(np.int64)
        pool = np.zeros(0)
        if n_insert:
            pool = datasets.generate(spec["dataset"], n_insert, seed + 1)
            pool = _rng(seed, 2).permutation(pool[~np.isin(pool, keys)])
    elif kind == "ycsb":
        keys = ycsb.record_keys(np.arange(n))
        vals = np.arange(n, dtype=np.int64)
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        pool = ycsb.record_keys(np.arange(n, n + n_insert))
        pool = pool[~np.isin(pool, keys)]
    else:
        raise ValueError(f"unknown data kind {kind!r}")
    if len(np.unique(keys)) != len(keys):
        raise ValueError(f"{kind} data has duplicate keys")
    return Data(keys, vals, pool)
