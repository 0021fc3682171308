# A frozen copy of the port's `src/repro_torch/workloads/generator.py`, kept here so that a later
# change to the port's generator does not move the benchmark's inputs.
# Pinned by digests in dilibench/tests/test_bench_gen.py: do not edit.
"""Deterministic YCSB-style op-stream generator.

A `WorkloadSpec` names a mix (lookup / upsert / delete / range fractions),
a key-popularity distribution, and sizing; `generate_stream(spec, keys)`
expands it into a concrete list of `OpBatch`es — plain numpy arrays, no
index state — that any consumer (the differential `WorkloadRunner`, a
benchmark loop, a soak test) can replay byte-identically from the spec's
seed.

The generator tracks its own model of the live key set (loaded keys plus
its inserts minus its deletes) so op targets stay meaningful as the stream
mutates the index: lookups mostly hit live keys (a `miss_frac` slice
deliberately probes deleted/never-inserted keys), deletes always name live
keys, inserts draw fresh keys from a disjoint pool, and range scans start
at live keys.  Popularity is applied over that live set per the spec's
distribution (see `distributions`).

Named presets mirror the standard YCSB core workloads plus the paper's
read-heavy evaluation point:

  ycsb_a      50% lookup / 50% upsert-update, zipfian   (session store)
  ycsb_b      95% lookup /  5% upsert-update, zipfian   (photo tagging)
  ycsb_c     100% lookup,                     zipfian   (profile cache)
  ycsb_e      95% range  /  5% insert,        zipfian   (threaded feed)
  dili_paper  85% lookup / 5% upsert / 5% delete / 5% range, uniform —
              the read-heavy mixed point the DILI paper evaluates
              (Fig. 7/8: read-heavy with inserts AND deletes).
  shift_fb_logn  write-heavy with a mid-stream key-distribution shift:
              the first half inserts uniform fresh keys over the loaded
              range ("fb"-like), the second half draws from a disjoint
              lognormal-gap cluster beyond it ("logn"-like) while lookups
              chase the newest keys — the Fig. 9b/10 drift scenario as a
              replayable stream (exercises drift-triggered retrains).
  ttl_storm   insert waves followed by correlated delete storms: a
              deterministic wave schedule (wave_len) cycles upsert-only
              batches then delete batches whose victims are the OLDEST
              live keys (TTL expiry), stressing tombstone-density
              compaction and merge/publish latency.

Keys are integer-valued floats: exactly representable in f64 and — when
the universe stays below 2^24 — in f32 too, so one stream can drive the
pallas engine and a float oracle with zero quantization divergence
(the engine-equivalence convention, tests/test_api_engines.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .distributions import (DEFAULT_THETA, DISTRIBUTIONS, ZetaCache,
                            sample_indices, scatter_ranks)

OPS = ("lookup", "upsert", "delete", "range")


@dataclass(frozen=True)
class OpBatch:
    """One batch of homogeneous operations (replayed engine-batch-wise).

    op == "lookup": `keys` are the point queries.
    op == "upsert": `keys`/`vals` are the written pairs (inserts and
                    updates).
    op == "delete": `keys` name the victims (live at generation time).
    op == "range":  `lo`/`hi` are per-query [lo, hi) bounds.
    """
    op: str
    keys: np.ndarray | None = None
    vals: np.ndarray | None = None
    lo: np.ndarray | None = None
    hi: np.ndarray | None = None

    @property
    def n_ops(self) -> int:
        if self.op == "range":
            return len(self.lo)
        return len(self.keys)


@dataclass(frozen=True)
class WorkloadSpec:
    """A named, seeded, replayable workload definition.

    Mix fractions pick each *batch*'s op type (batches are homogeneous so
    the runner can drive engines with their natural batched calls); they
    must sum to 1.  `insert_frac` splits upsert batches between fresh-key
    inserts and updates of existing keys.  `miss_frac` of lookup lanes
    probe keys guaranteed absent (deleted or never inserted).  `scan_len`
    bounds the rank-span of range scans; `max_hits` is the per-query range
    window the runner requests (both sides of the diff truncate at it).

    Scenario shaping (PR 5):
      * `shift_frac` > 0 shifts the insert-key distribution mid-stream:
        after that fraction of batches, fresh keys come from a disjoint
        lognormal-gap cluster beyond the loaded range instead of the
        uniform odd-integer pool (fb -> logn drift).
      * `delete_policy` — "popular" samples victims by the spec's
        distribution; "oldest" expires the oldest live keys (TTL).
      * `wave_len` > 0 replaces the per-batch random op draw with a
        deterministic cycle of `wave_len` batches apportioned by the mix
        (insert waves, then delete storms — correlated, not interleaved).
    """
    name: str = "custom"
    n_ops: int = 10000
    batch_size: int = 256
    lookup: float = 1.0
    upsert: float = 0.0
    delete: float = 0.0
    range_: float = 0.0
    distribution: str = "zipfian"
    theta: float = DEFAULT_THETA
    hot_frac: float = 0.2
    hot_weight: float = 0.8
    insert_frac: float = 0.0
    miss_frac: float = 0.05
    scan_len: int = 100
    max_hits: int = 64
    shift_frac: float = 0.0
    delete_policy: str = "popular"
    wave_len: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.distribution not in DISTRIBUTIONS:
            raise ValueError(f"unknown distribution {self.distribution!r}; "
                             f"expected one of {DISTRIBUTIONS}")
        total = self.lookup + self.upsert + self.delete + self.range_
        if not np.isclose(total, 1.0):
            raise ValueError(f"mix fractions must sum to 1, got {total}")
        if self.n_ops < 1 or self.batch_size < 1:
            raise ValueError("n_ops and batch_size must be >= 1")
        if self.delete_policy not in ("popular", "oldest"):
            raise ValueError(f"unknown delete_policy "
                             f"{self.delete_policy!r}")
        if not 0.0 <= self.shift_frac < 1.0:
            raise ValueError("shift_frac must be in [0, 1)")
        if self.wave_len < 0:
            raise ValueError("wave_len must be >= 0")

    @property
    def mix(self) -> np.ndarray:
        return np.array([self.lookup, self.upsert, self.delete, self.range_])

    def scaled(self, n_ops: int | None = None,
               batch_size: int | None = None,
               seed: int | None = None) -> "WorkloadSpec":
        """The same workload at a different size/seed (presets are resized
        per consumer: CI smoke vs full bench vs tier-1 grid)."""
        return replace(self,
                       n_ops=self.n_ops if n_ops is None else n_ops,
                       batch_size=(self.batch_size if batch_size is None
                                   else batch_size),
                       seed=self.seed if seed is None else seed)


PRESETS: dict[str, WorkloadSpec] = {
    "ycsb_a": WorkloadSpec(name="ycsb_a", lookup=0.5, upsert=0.5,
                           distribution="zipfian"),
    "ycsb_b": WorkloadSpec(name="ycsb_b", lookup=0.95, upsert=0.05,
                           distribution="zipfian"),
    "ycsb_c": WorkloadSpec(name="ycsb_c", lookup=1.0,
                           distribution="zipfian"),
    "ycsb_e": WorkloadSpec(name="ycsb_e", lookup=0.0, range_=0.95,
                           upsert=0.05, insert_frac=1.0,
                           distribution="zipfian"),
    "dili_paper": WorkloadSpec(name="dili_paper", lookup=0.85, upsert=0.05,
                               delete=0.05, range_=0.05, insert_frac=0.5,
                               distribution="uniform"),
    "shift_fb_logn": WorkloadSpec(name="shift_fb_logn", lookup=0.4,
                                  upsert=0.5, delete=0.05, range_=0.05,
                                  insert_frac=0.8, distribution="latest",
                                  shift_frac=0.5, miss_frac=0.02),
    "ttl_storm": WorkloadSpec(name="ttl_storm", lookup=0.2, upsert=0.5,
                              delete=0.3, insert_frac=1.0,
                              distribution="uniform",
                              delete_policy="oldest", wave_len=10),
}


class _LiveSet:
    """The generator's model of the index content: a sorted key array for
    range endpoints/delete routing plus a recency array for the `latest`
    distribution.  O(n) per mutated batch — generation-time only, never on
    the serving path."""

    def __init__(self, keys: np.ndarray):
        self.sorted = np.sort(np.asarray(keys, np.float64))
        self.by_age = self.sorted.copy()        # loaded keys: age order
        self.dead: list[float] = []             # recently deleted (for
                                                # deliberate miss probes)

    def __len__(self) -> int:
        return len(self.sorted)

    def insert(self, keys: np.ndarray) -> None:
        self.sorted = np.union1d(self.sorted, keys)
        self.by_age = np.concatenate([self.by_age, keys])

    def delete(self, keys: np.ndarray) -> None:
        keys = np.unique(keys)
        self.sorted = self.sorted[~np.isin(self.sorted, keys)]
        self.by_age = self.by_age[~np.isin(self.by_age, keys)]
        self.dead.extend(keys.tolist())
        self.dead = self.dead[-4096:]           # bounded miss pool


def generate_stream(spec: WorkloadSpec, loaded_keys: np.ndarray,
                    insert_pool: np.ndarray | None = None,
                    val_base: int = 1_000_000) -> list[OpBatch]:
    """Expand `spec` into a replayable list of `OpBatch`es over an index
    bulk-loaded with `loaded_keys`.

    `insert_pool` supplies fresh keys for insert-flavored upserts, in pop
    order; it must be disjoint from `loaded_keys` (default: the odd
    integers between the loaded keys' min and beyond their max — with the
    even-integer universe convention the two never collide).  Values are a
    deterministic running sequence from `val_base`, so every written pair
    is attributable to its op position when a diff fires.

    The realized op count can fall marginally short of `spec.n_ops`:
    delete batches dedupe their victims (skewed sampling repeats keys, and
    a batch of deletes of one key is one delete), so consumers should
    treat `n_ops` as a target, not an exact invariant.
    """
    loaded_keys = np.asarray(loaded_keys, np.float64)
    if len(loaded_keys) < 2:
        raise ValueError("need >= 2 loaded keys to shape a workload")
    if insert_pool is None:
        lo = int(loaded_keys.min())
        insert_pool = np.arange(lo | 1, int(loaded_keys.max()) + 2 * spec.n_ops,
                                2, dtype=np.float64)
        insert_pool = insert_pool[~np.isin(insert_pool, loaded_keys)]
    else:
        insert_pool = np.asarray(insert_pool, np.float64)

    rng = np.random.default_rng(spec.seed)
    zeta = ZetaCache(spec.theta)
    live = _LiveSet(loaded_keys)
    batches: list[OpBatch] = []
    n_batches = max(1, -(-spec.n_ops // spec.batch_size))
    ops_left = spec.n_ops
    pool_i = 0
    val_seq = val_base

    # mid-stream distribution shift: after `shift_frac` of the batches,
    # fresh keys come from a disjoint odd-integer cluster beyond the
    # phase-1 pool, with lognormal gaps (the "logn" key shape) — still
    # integer-valued, so the f32 bit-exactness convention holds
    shift_at = (int(round(n_batches * spec.shift_frac))
                if spec.shift_frac > 0 else n_batches + 1)
    if spec.shift_frac > 0:
        base = (int(insert_pool.max()) if len(insert_pool)
                else int(loaded_keys.max()) + 2 * spec.n_ops) + 1 | 1
        gaps = np.maximum(rng.lognormal(0.0, 1.0, spec.n_ops), 1.0)
        shift_pool = base + 2 * np.cumsum(gaps.astype(np.int64))
        shift_pool = shift_pool.astype(np.float64)
        shift_pool = shift_pool[~np.isin(shift_pool, loaded_keys)]
    else:
        shift_pool = np.zeros(0, np.float64)
    shift_i = 0

    # deterministic wave schedule: `wave_len` batches per cycle,
    # apportioned by the mix in OPS order (upsert waves before the
    # correlated delete storm), every nonzero op class represented
    wave: list[str] = []
    if spec.wave_len:
        counts = np.floor(spec.mix * spec.wave_len).astype(int)
        counts[(spec.mix > 0) & (counts == 0)] = 1
        for op_name, c in zip(OPS, counts):
            wave += [op_name] * int(c)

    def pick_keys(size: int) -> np.ndarray:
        """Distribution-weighted live keys for this batch."""
        n = len(live)
        ranks = sample_indices(rng, spec.distribution, n, size,
                               theta=spec.theta, hot_frac=spec.hot_frac,
                               hot_weight=spec.hot_weight, zeta=zeta)
        if spec.distribution == "latest":
            # rank 0 = newest
            return live.by_age[len(live.by_age) - 1 - ranks]
        return live.sorted[scatter_ranks(ranks, n)]

    for b_i in range(n_batches):
        B = min(spec.batch_size, ops_left)
        ops_left -= B
        shifted = b_i >= shift_at
        op = (wave[b_i % len(wave)] if wave
              else OPS[rng.choice(4, p=spec.mix)])
        if op == "lookup":
            q = pick_keys(B)
            n_miss = int(round(B * spec.miss_frac))
            if n_miss:
                # absent keys: recently deleted first, else unseen pool keys
                pool = np.asarray(live.dead[-n_miss:], np.float64)
                if len(pool) < n_miss:
                    cur_pool, cur_i = ((shift_pool, shift_i) if shifted
                                       else (insert_pool, pool_i))
                    extra = cur_pool[cur_i: cur_i + (n_miss - len(pool))]
                    pool = np.concatenate([pool, extra])
                if len(pool):
                    q[rng.integers(0, B, len(pool))] = pool
            batches.append(OpBatch("lookup", keys=q))
        elif op == "upsert":
            n_new = int(round(B * spec.insert_frac))
            if shifted:
                n_new = min(n_new, len(shift_pool) - shift_i)
                new = shift_pool[shift_i: shift_i + n_new]
                shift_i += n_new
            else:
                n_new = min(n_new, len(insert_pool) - pool_i)
                new = insert_pool[pool_i: pool_i + n_new]
                pool_i += n_new
            upd = pick_keys(B - n_new)
            keys = np.concatenate([new, upd])
            vals = np.arange(val_seq, val_seq + len(keys), dtype=np.int64)
            val_seq += len(keys)
            batches.append(OpBatch("upsert", keys=keys, vals=vals))
            if n_new:
                live.insert(new)
        elif op == "delete":
            # never drain the live set below a floor: a workload that
            # deletes everything stops being a workload
            B_d = min(B, max(len(live) - 64, 0))
            if B_d == 0:
                batches.append(OpBatch("lookup", keys=pick_keys(B)))
                continue
            if spec.delete_policy == "oldest":     # TTL expiry order
                victims = np.unique(live.by_age[:B_d])
            else:
                victims = np.unique(pick_keys(B_d))
            batches.append(OpBatch("delete", keys=victims))
            live.delete(victims)
        else:                                    # range
            starts = pick_keys(B)
            spans = rng.integers(1, spec.scan_len + 1, B)
            pos = np.searchsorted(live.sorted, starts)
            end = np.minimum(pos + spans, len(live) - 1)
            # integer-valued keys: +1 makes the last rank inclusive under
            # the facade's half-open [lo, hi) contract
            batches.append(OpBatch("range", lo=starts,
                                   hi=live.sorted[end] + 1.0))
    return batches


def stream_op_counts(batches: list[OpBatch]) -> dict:
    out = {op: 0 for op in OPS}
    for b in batches:
        out[b.op] += b.n_ops
    return out
