"""The frozen generator copies under `dilibench/gen/` are pinned by digests
of the streams they make at a tiny size, so that the benchmark's inputs
stay put whatever later happens to the port's own generators.  The
digests were taken when the copies were made, on streams that were then
byte-identical to the port's."""

import hashlib
import json

import numpy as np
import pytest

from dilibench import manifest as M
from dilibench.gen import datasets, distributions, generator, ycsb

DIGESTS = {
    "dataset.fb": "cba3446db47e4abd3bb677b98036198e81a387d35efbb43155fbe170ba7ac0a1",
    "dataset.wikits": "5e1958bc397763af5f5ce3afe38265b59af501e8c8fc7bbb36ee3fe269ad7379",
    "dataset.osm": "c8570108ca08433cad99042a6f9f04494143d8d43cdfcc7812bdc4d383fa4dc2",
    "dataset.books": "465bbf0b0697556f24e3109600ca986c6a9638f13142ec59ed217cdcae9f89b9",
    "dataset.logn": "0d5a63ea738d8e4e129e1520d11402756b66e3174b8cdefe675a79a0e06ba347",
    "stream.ycsb_a": "f3d2c054f84bbef06d2021ea6b2146040e6d0e4a2681e239f07e1735e2ab7032",
    "stream.ycsb_c": "0606a7be98ba25675da3e3a4d329f4017b0774a42a118b16efbdbfedd406714c",
    "stream.ycsb_e": "63758215245cce21e042be384c9e4f7a4a8d137eecc4ac3826c6be6b3c2d9b8a",
    "stream.dili_paper": "f049a4d069727ef448ee8f91ee1ce24929b8622cc9a7e60e73d15968beef3ffc",
    "stream.ttl_storm": "cab66923c1b65c44b2566d0aa731cf3113e631b7a8c4624ec7d60c898f18d29f",
    "stream.shift_fb_logn": "216cef19883587096a84963f71e2ac02992ad0c58fe636c1bd4341d26bdbbe52",
    "dist.uniform": "95b2592079b93175de3b10c752b95a7b0c9d69a7165062e4608f794b56c3122d",
    "dist.zipfian": "b95c6147e59b8a943d0c8a8421602440aa517025b1d70575782e9226d9157931",
    "dist.latest": "b58938ded04eb84158d9209540350e659df372bca3f33189aee26a34e120670e",
    "dist.hotspot": "32f3d1d7477c0d0b874d6f9181950d23c5c73be0f45e9908a226840c78067b9d",
}
INSERTING = ("ycsb_e", "dili_paper", "ttl_storm", "shift_fb_logn")


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("name", datasets.ALL_DATASETS)
def test_dataset_digest(name):
    keys = datasets.generate(name, 1000, 7)
    assert _digest(keys.tobytes()) == DIGESTS[f"dataset.{name}"]


@pytest.mark.parametrize("preset", ["ycsb_a", "ycsb_c", *INSERTING])
def test_stream_digest(preset):
    loaded = (np.arange(4000) * 2.0 if preset in INSERTING
              else datasets.generate("logn", 2000, 3))
    spec = generator.PRESETS[preset].scaled(n_ops=3000, batch_size=64,
                                            seed=11)
    h = hashlib.sha256()
    for b in generator.generate_stream(spec, loaded):
        h.update(b.op.encode())
        for a in (b.keys, b.vals, b.lo, b.hi):
            if a is not None:
                h.update(np.ascontiguousarray(a).tobytes())
    assert _digest(h.digest()) == DIGESTS[f"stream.{preset}"]


def test_distribution_digests():
    rng = np.random.default_rng(5)
    for d in distributions.DISTRIBUTIONS:
        idx = distributions.sample_indices(rng, d, 5000, 3000)
        assert _digest(idx.tobytes()) == DIGESTS[f"dist.{d}"], d


def _java_fnvhash64(v: int) -> int:
    """YCSB's Utils.fnvhash64, line by line, on Python integers."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= v & 0xFF
        v >>= 8
        h = (h * 1099511628211) & (2**64 - 1)
    return 2**64 - h if h >= 2**63 else h


def test_ycsb_keys():
    recs = np.arange(2000)
    assert ycsb.fnvhash64(recs).tolist() == [_java_fnvhash64(int(r))
                                             for r in recs]
    keys = ycsb.record_keys(np.arange(250_000))
    assert len(np.unique(keys)) == 250_000
    assert keys.max() < 2.0**53
    assert _digest(ycsb.record_keys(np.arange(1000)).tobytes()) == \
        "a4aa3cd6e2ae7bcefa14cbfdda98267df4ed49526c2a20a3e242b2d84efc622a"


class _Draws:
    """A stand-in for `np.random.Generator` that hands out given draws."""

    def __init__(self, u):
        self.u, self.at = np.asarray(u, np.float64), 0

    def random(self, size):
        out = self.u[self.at:self.at + size]
        self.at += size
        return out


def _java_scrambled(u: float, recordcount: int) -> int:
    """YCSB's ScrambledZipfianGenerator(0, recordcount).nextValue() for one
    uniform draw u, line by line (ZipfianGenerator.nextLong, then
    `min + fnvhash64(ret) % itemcount`)."""
    theta, items, zetan = 0.99, ycsb.ITEM_COUNT + 1, ycsb.ZETAN
    zeta2theta = sum(1 / (i + 1) ** theta for i in range(2))
    alpha = 1.0 / (1.0 - theta)
    eta = (1 - (2.0 / items) ** (1 - theta)) / (1 - zeta2theta / zetan)
    uz = u * zetan
    if uz < 1.0:
        ret = 0
    elif uz < 1.0 + 0.5 ** theta:
        ret = 1
    else:
        ret = int(items * (eta * u - eta + 1) ** alpha)
    return _java_fnvhash64(ret) % (recordcount + 1)


def test_scrambled_zipfian_follows_ycsb():
    u = np.random.default_rng(9).random(5000)
    u[:3] = [0.001, 0.03, 0.05]         # ranks 0 and 1 by YCSB's shortcuts
    n = 97                              # so that some draws land on n
    want = [r for r in (_java_scrambled(float(x), n) for x in u) if r < n]
    assert len(want) < len(u)
    got = ycsb.scrambled_zipfian(_Draws(u), n, len(want))
    assert got.tolist() == want


def test_scrambled_zipfian_zetan_is_the_harmonic_sum():
    """ZETAN is zeta(ITEM_COUNT, 0.99): the first million terms summed,
    the rest by Euler-Maclaurin."""
    th, m, n = ycsb.ZIPFIAN_CONSTANT, 10**6, ycsb.ITEM_COUNT
    head = np.sum(np.arange(1, m + 1, dtype=np.float64) ** -th)
    tail = ((n ** (1 - th) - m ** (1 - th)) / (1 - th)
            + (n ** -th - m ** -th) / 2
            + (-th * n ** (-th - 1) + th * m ** (-th - 1)) / 12)
    assert abs(head + tail - ycsb.ZETAN) < 1e-9


def test_scrambled_zipfian_skew():
    """The hottest record takes about 1/ZETAN of the draws (3.8%), half
    what the port's zipfian over the records' own count gives it."""
    n, size = 250_000, 400_000
    rec = ycsb.scrambled_zipfian(np.random.default_rng(4), n, size)
    assert len(rec) == size and rec.min() >= 0 and rec.max() < n
    top = np.bincount(rec).max() / size
    assert abs(top - 1 / ycsb.ZETAN) < 0.002
    ranks = distributions.sample_indices(np.random.default_rng(4), "zipfian",
                                         n, size)
    assert np.bincount(ranks).max() / size > 1.7 * top
    assert _digest(ycsb.scrambled_zipfian(np.random.default_rng(7), 1000,
                                          3000).tobytes()) == \
        "8d6a2d15fae8eec770147262c93c367f5ac40da877034b53f4d9c569d1de37fd"


def test_keychooser_pool():
    """A mix with a `keychooser` touches loaded records only, the same
    ones for the same seed, in the spec's ops, sizes and payloads."""
    from dilibench import data as D, traffic as T
    mix = json.loads((M.HERE / "traffic" / "ycsb-a.json").read_text())
    mix["pool_calls"], mix["spec"]["batch_size"] = 40, 64
    d = D.make({"kind": "ycsb", "n_keys": 5000}, 3)
    pool = T.make_pool(mix, d, 2**33 + 5)
    again = T.make_pool(mix, d, 2**33 + 5)
    other = T.make_pool(mix, d, 2**33 + 6)
    assert [b.op for b in pool.batches] == ["lookup", "upsert"] * 20
    assert all(np.isin(b.keys, d.keys).all() and b.n_ops == 64
               for b in pool.batches)
    assert all(np.array_equal(a.keys, b.keys)
               for a, b in zip(pool.batches, again.batches))
    assert not all(np.array_equal(a.keys, b.keys)
                   for a, b in zip(pool.batches, other.batches))
    mix["spec"]["miss_frac"] = 0.05
    with pytest.raises(ValueError, match="keychooser"):
        T.make_pool(mix, d, 1)
