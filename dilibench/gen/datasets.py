# A frozen copy of the port's `src/repro_torch/data/datasets.py`, kept here so that a later
# change to the port's generator does not move the benchmark's inputs.
# Pinned by digests in dilibench/tests/test_bench_gen.py: do not edit.
"""Synthetic key datasets mirroring the paper's five workloads (section 7.1),
deterministic per (name, n, seed).  Real SOSD files are 200-800M uint64 keys;
these generators reproduce their distributional shapes at any scale:

  fb      — heavy-tail pareto mixture (Facebook user ids' skew)
  wikits  — near-sequential integer timestamps with bursts
  osm     — multi-modal clustered cell ids
  books   — smooth power-law (Amazon book popularity ranks)
  logn    — the paper's lognormal(0, 1)
"""

from __future__ import annotations

import zlib

import numpy as np


def generate(name: str, n: int, seed: int = 0) -> np.ndarray:
    # crc32, not hash(): str hashing is salted per process, which silently
    # made "deterministic" datasets differ between runs/CI jobs
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    over = int(n * 1.25) + 16
    if name == "logn":
        raw = rng.lognormal(0.0, 1.0, over)
    elif name == "fb":
        raw = np.concatenate([
            (rng.pareto(1.05, over // 2) + 1) * 1e6,
            rng.uniform(0, 5e6, over - over // 2)])
    elif name == "wikits":
        steps = rng.integers(1, 4, over).astype(np.float64)
        bursts = rng.random(over) < 0.01
        steps[bursts] += rng.integers(100, 10000, int(bursts.sum()))
        raw = 1.6e9 + np.cumsum(steps)
    elif name == "osm":
        centers = rng.uniform(0, 2**40, 64)
        raw = (centers[rng.integers(0, 64, over)]
               + rng.normal(0, 2**20, over))
    elif name == "books":
        raw = np.cumsum(rng.pareto(1.6, over) + 0.1) * 1e3
    else:
        raise ValueError(name)
    keys = np.unique(raw.astype(np.float64))
    rng.shuffle(keys)            # unique + sort below
    keys = np.sort(keys[:n])
    return keys


ALL_DATASETS = ("fb", "wikits", "osm", "books", "logn")
