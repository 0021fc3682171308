"""The plain reference (`dilibench/reference.py`) against a Python dict on
small random streams, and the comparison that decides `correct`."""

import numpy as np
import pytest

from dilibench.gen.generator import OpBatch
from dilibench.reference import SortedArrayMap, wrong_lanes


class DictMap:
    """The facade's semantics, one key at a time."""

    def __init__(self, keys, vals):
        self.d = {}
        for k, v in zip(keys.tolist(), vals.tolist()):
            self.d[k] = v

    def apply(self, b, max_hits):
        if b.op == "upsert":
            for k, v in zip(b.keys.tolist(), b.vals.tolist()):
                self.d[k] = v
        elif b.op == "delete":
            for k in b.keys.tolist():
                self.d.pop(k, None)
        elif b.op == "lookup":
            found = np.array([k in self.d for k in b.keys.tolist()])
            vals = np.array([self.d.get(k, 0) for k in b.keys.tolist()],
                            np.int64)
            return vals, found
        else:
            items = sorted(self.d.items())
            ks = np.full((len(b.lo), max_hits), np.inf)
            vs = np.full((len(b.lo), max_hits), -1, np.int64)
            cnt = np.zeros(len(b.lo), np.int64)
            for i, (lo, hi) in enumerate(zip(b.lo.tolist(), b.hi.tolist())):
                hits = [(k, v) for k, v in items if lo <= k < hi][:max_hits]
                cnt[i] = len(hits)
                for j, (k, v) in enumerate(hits):
                    ks[i, j], vs[i, j] = k, v
            return ks, vs, cnt
        return None


def _stream(rng, universe, n_calls, batch):
    for i in range(n_calls):
        op = ("lookup", "upsert", "delete", "range")[rng.integers(4)]
        keys = rng.choice(universe, batch)          # duplicates within
        if op == "upsert":
            yield OpBatch("upsert", keys=keys,
                          vals=np.arange(i * batch, (i + 1) * batch))
        elif op == "range":
            lo = rng.choice(universe, batch)
            yield OpBatch("range", lo=lo, hi=lo + rng.integers(0, 40, batch))
        else:
            yield OpBatch(op, keys=keys)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_reference_matches_dict(seed, batch):
    rng = np.random.default_rng(seed)
    universe = np.arange(400, dtype=np.float64) * 1.5
    keys = rng.choice(universe, 150, replace=False)
    vals = rng.permutation(150).astype(np.int64)
    ref, truth = SortedArrayMap(keys, vals), DictMap(keys, vals)
    for b in _stream(rng, universe, 120, batch):
        got, want = ref.apply(b, 8), truth.apply(b, 8)
        if want is None:
            assert got is None
        else:
            assert wrong_lanes(b.op, got, want) == 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    assert ref.keys.tolist() == sorted(truth.d)
    assert ref.vals.tolist() == [truth.d[k] for k in sorted(truth.d)]


def test_wrong_lanes_counts_each_kind_of_difference():
    want = (np.array([5, 6, 0, 8]), np.array([True, True, False, True]))
    assert wrong_lanes("lookup", want, want) == 0
    # a payload changed, a hit lost, a miss turned into a hit
    got = (np.array([5, 7, 3, 0]), np.array([True, True, True, False]))
    assert wrong_lanes("lookup", got, want) == 3
    # a payload that differs where neither side found the key is no fault
    got = (np.array([5, 6, 9, 8]), want[1])
    assert wrong_lanes("lookup", got, want) == 0
    # an answer of the wrong length counts every lane
    assert wrong_lanes("lookup", (want[0][:2], want[1][:2]), want) == 4
    ks = np.array([[1.0, np.inf], [2.0, 3.0]])
    vs = np.array([[4, -1], [5, 6]])
    cnt = np.array([1, 2])
    assert wrong_lanes("range", (ks, vs, cnt), (ks, vs, cnt)) == 0
    assert wrong_lanes("range", (ks, vs + (vs == 6), cnt),
                       (ks, vs, cnt)) == 1
