# A frozen copy of the port's `src/repro_torch/workloads/distributions.py`, kept here so that a later
# change to the port's generator does not move the benchmark's inputs.
# Pinned by digests in dilibench/tests/test_bench_gen.py: do not edit.
"""Key-popularity distributions for the workload generator.

Every sampler answers one question — "which of the n currently-live keys
does this operation touch?" — by returning *indices into a popularity
ordering* of the live set.  The generator owns the mapping from those
indices to actual keys (hashed scatter for uniform/zipfian/hotspot,
recency order for latest), so the samplers stay pure: (rng, n, B) -> idx.

  * uniform — every live key equally likely (YCSB default request
    distribution for load phases).
  * zipfian — rank-frequency skew with parameter theta (YCSB's
    ZipfianGenerator, Gray et al. "Quickly Generating Billion-Record
    Synthetic Databases"): rank r is drawn in O(1) from the closed-form
    inverse CDF, no O(n) table per batch.  The harmonic normalizer
    zeta(n, theta) is memoized incrementally, so growing live sets only
    pay for the new terms.
  * latest — zipfian over recency ranks (rank 0 = newest key), YCSB's
    "latest" request distribution for feeds/timelines.
  * hotspot — a hot_frac fraction of the key space receives hot_weight
    of the traffic (YCSB hotspot), uniform within each side.

All sampling is vectorized and driven by a caller-owned
`np.random.Generator`, so a stream is exactly replayable from its seed.
"""

from __future__ import annotations

import numpy as np

DISTRIBUTIONS = ("uniform", "zipfian", "latest", "hotspot")

# YCSB's default zipfian constant: ~80% of accesses hit ~20% of keys.
DEFAULT_THETA = 0.99


class ZetaCache:
    """Incrementally-extended harmonic sums zeta(n, theta) = sum 1/i^theta.

    The live-set size n changes as the workload inserts and deletes, and
    zipfian sampling needs zeta(n) for the current n; recomputing the sum
    per batch would be O(n).  We keep the full prefix array so any n seen
    so far (including shrinks) is O(1), and growth appends only the new
    terms."""

    def __init__(self, theta: float):
        self.theta = float(theta)
        self._prefix = np.zeros(1)          # prefix[i] = zeta(i, theta)

    def __call__(self, n: int) -> float:
        if n >= len(self._prefix):
            i = np.arange(len(self._prefix), n + 1, dtype=np.float64)
            new = np.cumsum(i ** -self.theta) + self._prefix[-1]
            self._prefix = np.concatenate([self._prefix, new])
        return float(self._prefix[n])


def zipfian_ranks(rng: np.random.Generator, n: int, size: int,
                  theta: float, zeta: ZetaCache) -> np.ndarray:
    """Draw `size` ranks in [0, n) with P(rank=r) proportional to
    1/(r+1)^theta — the YCSB ZipfianGenerator recurrence, vectorized."""
    if n <= 1:
        return np.zeros(size, np.int64)
    zetan = zeta(n)
    alpha = 1.0 / (1.0 - theta)
    eta = ((1.0 - (2.0 / n) ** (1.0 - theta))
           / (1.0 - zeta(2) / zetan))
    u = rng.random(size)
    uz = u * zetan
    ranks = (n * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ranks = np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1,
                                           ranks))
    return np.clip(ranks, 0, n - 1)


def sample_indices(rng: np.random.Generator, dist: str, n: int, size: int,
                   *, theta: float = DEFAULT_THETA,
                   hot_frac: float = 0.2, hot_weight: float = 0.8,
                   zeta: ZetaCache | None = None) -> np.ndarray:
    """Popularity-rank indices in [0, n) for `size` operations."""
    if n <= 0:
        raise ValueError("cannot sample from an empty live set")
    if dist == "uniform":
        return rng.integers(0, n, size)
    if dist in ("zipfian", "latest"):
        # "latest" is zipfian over recency ranks; the generator maps rank 0
        # to the newest key instead of a hashed position
        return zipfian_ranks(rng, n, size, theta,
                             zeta if zeta is not None else ZetaCache(theta))
    if dist == "hotspot":
        n_hot = max(1, int(np.ceil(hot_frac * n)))
        hot = rng.random(size) < hot_weight
        idx = rng.integers(0, max(n - n_hot, 1), size) + n_hot
        idx[hot] = rng.integers(0, n_hot, int(hot.sum()))
        return np.clip(idx, 0, n - 1)
    raise ValueError(f"unknown distribution {dist!r}; "
                     f"expected one of {DISTRIBUTIONS}")


def scatter_ranks(ranks: np.ndarray, n: int) -> np.ndarray:
    """Map popularity ranks to positions in the live-key array with a
    multiplicative hash (Knuth's 2654435761), YCSB's scrambled-zipfian
    idea: hot keys are spread across the key space instead of clustering
    at one end, so skew stresses the whole tree, not one subtree."""
    if n <= 0:
        return ranks
    return (ranks.astype(np.uint64) * np.uint64(2654435761)
            % np.uint64(n)).astype(np.int64)
