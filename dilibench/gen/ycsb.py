"""YCSB's record keys (Cooper et al., SoCC 2010; YCSB core workloads with
`insertorder=hashed`): record number i is named by `Utils.fnvhash64(i)`,
FNV-1a 64 over the record number's eight bytes, lowest first, and
`Math.abs` of the result.  The index holds f64 keys, so each hash is masked
to its low 53 bits, which f64 holds exactly.

Also YCSB's key chooser for `requestdistribution=zipfian`, the scrambled
zipfian (`KEYCHOOSERS`), which picks the record numbers a run touches."""

from __future__ import annotations

import numpy as np

FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
KEY_BITS = 53


def fnvhash64(records: np.ndarray) -> np.ndarray:
    """YCSB's `Utils.fnvhash64` of each record number, as uint64 (Java's
    signed result after `Math.abs`, which leaves `Long.MIN_VALUE` as it
    is)."""
    val = np.asarray(records, np.int64).astype(np.uint64)
    h = np.full(val.shape, FNV_OFFSET_BASIS_64, np.uint64)
    prime = np.uint64(FNV_PRIME_64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= val & np.uint64(0xFF)
            val >>= np.uint64(8)
            h *= prime
        neg = h >= np.uint64(1 << 63)
        h[neg] = np.uint64(0) - h[neg]
    return h


def record_keys(records: np.ndarray) -> np.ndarray:
    """f64 keys of the given record numbers: the hash's low 53 bits."""
    mask = np.uint64((1 << KEY_BITS) - 1)
    return (fnvhash64(records) & mask).astype(np.float64)


# YCSB's ScrambledZipfianGenerator at its default constant: a zipfian over
# ITEM_COUNT items whose harmonic sum is the constant ZETAN, each draw
# hashed with fnvhash64 and taken modulo the record count.
ZIPFIAN_CONSTANT = 0.99
ITEM_COUNT = 10_000_000_000
ZETAN = 26.46902820178302


def scrambled_zipfian(rng: np.random.Generator, recordcount: int,
                      size: int) -> np.ndarray:
    """`size` record numbers in [0, recordcount), drawn as YCSB's
    CoreWorkload draws them for `requestdistribution=zipfian` with no
    inserts: `ScrambledZipfianGenerator(0, recordcount)` (a
    `ZipfianGenerator(0, ITEM_COUNT, 0.99, ZETAN)`, then
    `fnvhash64(rank) % (recordcount + 1)`), with a draw above the last
    loaded record drawn again, as `CoreWorkload.nextKeynum` does."""
    theta = ZIPFIAN_CONSTANT
    items = ITEM_COUNT + 1                 # ZipfianGenerator's max - min + 1
    zeta2 = 1.0 + 1.0 / 2.0 ** theta       # ZipfianGenerator.zeta(2, theta)
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / ZETAN)
    span = np.uint64(recordcount + 1)
    out: list[np.ndarray] = []
    left = size
    while left > 0:
        u = rng.random(left)
        uz = u * ZETAN
        rank = (items * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
        rank = np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1,
                                              rank))
        rec = (fnvhash64(rank) % span).astype(np.int64)
        rec = rec[rec < recordcount]
        out.append(rec)
        left -= len(rec)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


KEYCHOOSERS = {"scrambled_zipfian": scrambled_zipfian}
