"""Payload-only merges patch the published snapshot
(`core.flat.patch_payloads`) instead of re-flattening the whole tree.

On the CPU, over four key distributions, trees placed in f64 and in f32,
DILI and DILI-LO: the patched flat equals `flatten()` of the folded tree
field by field, dtypes included; the port's `OnlineIndex` and the JAX
package's, fed the same update-only batches, publish equal flats and
answer lookups alike after every merge; a merge with an insert, a
tombstone, a key the published flat lacks, or the splice flattener
configured takes the other path; a merge that dies mid-fold and is retried
still publishes the full flatten's flat; and the stats held to the
reference are the same whichever path ran.
"""
import dataclasses

import numpy as np
import pytest

from repro import online as J
from repro.core import dili as J_dili
from repro_torch import online as T
from repro_torch.api import IndexConfig, LearnedIndex
from repro_torch.core import dili as T_dili
from repro_torch.core.flat import flatten, patch_payloads
from repro_torch.maintain import MaintenanceConfig
from repro_torch.online import merge as T_merge
from repro_torch.online.overlay import TombstoneOverlay, fold_overlay
from tests.conftest import make_keys

DISTS = ["logn", "uniform", "fb", "wikits"]
N_KEYS = 3000
ARRAYS = ("a", "b", "base", "fo", "dense", "tag", "key", "val", "pair_key",
          "pair_val", "pair_slot")
SCALARS = ("root", "max_depth", "key_lo", "key_hi", "n_segments")
CASES = [(d, p, lo) for d in DISTS for p in ("f64", "f32")
         for lo in (False, True)]


def _id(case):
    d, p, lo = case
    return f"{d}-{p}" + ("-lo" if lo else "")


def _assert_flat_equal(want, got):
    for name in ARRAYS:
        x, y = getattr(got, name), getattr(want, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in SCALARS:
        assert getattr(got, name) == getattr(want, name), name


class _placed:
    """Both packages' placement dtype for the block (f32 or f64)."""

    def __init__(self, prec):
        dt = np.float32 if prec == "f32" else np.float64
        self.ctx = (J_dili.placement_dtype(dt), T_dili.placement_dtype(dt))

    def __enter__(self):
        for c in self.ctx:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctx):
            c.__exit__(*exc)


def _keys(dist, prec, seed=31):
    keys = make_keys(dist, N_KEYS, np.random.default_rng(seed))
    if prec == "f32":
        keys = np.unique(keys.astype(np.float32)).astype(np.float64)
    return keys


def _updates(keys, rng, n=150):
    """A batch of updates of existing keys (repeats included: the overlay
    keeps the last)."""
    return keys[rng.integers(0, len(keys), n)], rng.integers(0, 1 << 40, n)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_patch_equals_full_flatten(case):
    dist, prec, lo = case
    keys = _keys(dist, prec)
    rng = np.random.default_rng(5)
    with _placed(prec):
        d = T_dili.bulk_load(keys, rng.integers(0, 1 << 40, len(keys)),
                             local_optimized=not lo)
        flat = flatten(d)
        for _ in range(4):
            ov = TombstoneOverlay.empty(256).upsert_batch(*_updates(keys, rng))
            prev = {n: getattr(flat, n).copy() for n in ARRAYS}
            assert fold_overlay(d, ov) is False
            got = patch_payloads(flat, *ov.entries()[:2])
            _assert_flat_equal(flatten(d), got)
            for n in ARRAYS:           # the published flat is left as it was
                np.testing.assert_array_equal(getattr(flat, n), prev[n])
            flat = got


def test_patch_refuses_keys_that_are_not_exactly_one_pair():
    keys = _keys("logn", "f64")
    flat = flatten(T_dili.bulk_load(keys))
    hit = keys[:3]
    assert patch_payloads(flat, hit, [1, 2, 3]) is not None
    miss = np.array([hit[0], (keys[10] + keys[11]) / 2])
    assert patch_payloads(flat, miss, [1, 2]) is None
    assert patch_payloads(flat, [keys[-1] + 1.0], [1]) is None
    # a signed zero is another key to the tree's payload update
    zk = np.unique(np.concatenate([[0.0], keys]))
    zflat = flatten(T_dili.bulk_load(zk))
    assert patch_payloads(zflat, [0.0], [7]) is not None
    assert patch_payloads(zflat, [-0.0], [7]) is None
    # a key held twice in the pair table has no one row to patch
    twice = dataclasses.replace(
        flat, pair_key=np.sort(np.concatenate([flat.pair_key, hit[:1]])))
    assert patch_payloads(twice, hit[:1], [1]) is None


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_online_index_matches_the_reference(case):
    dist, prec, lo = case
    keys = _keys(dist, prec)
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 1 << 40, len(keys))
    policy = dict(max_writes=250, pressure_check_every=1 << 30)
    q = np.concatenate([keys[rng.integers(0, len(keys), 900)],
                        (keys[:-1] + keys[1:])[:124] / 2])
    with _placed(prec):
        kw = dict(local_optimized=not lo)
        j = J.OnlineIndex(dili=J_dili.bulk_load(keys, vals, **kw),
                          policy=J.MergePolicy(**policy))
        t = T.OnlineIndex(dili=T_dili.bulk_load(keys, vals, **kw),
                          policy=T.MergePolicy(**policy), device="cpu")
        for r in range(5):
            k, v = _updates(keys, rng)
            j.upsert_batch(k, v)
            t.upsert_batch(k, v)
            if r % 2 == 0:         # rounds 2 and 4 merge on the lag
                j.flush()
                t.flush()
            assert (j.epoch, j.n_flattens, j.n_full_flattens) == \
                (t.epoch, t.n_flattens, t.n_full_flattens)
            _assert_flat_equal(j.store.flat, t.store.flat)
            _assert_flat_equal(flatten(t.dili), t.store.flat)
            for x, y in zip(j.lookup(q), t.lookup(q)):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert t.n_patched_flattens == t.n_flattens - 1 == 3


def _online(keys, **kw):
    return T.OnlineIndex(keys, np.arange(len(keys)), device="cpu", **kw)


@pytest.mark.parametrize("kind", ["insert", "tombstone", "missing",
                                  "incremental"])
def test_other_writes_take_the_other_path(kind):
    keys = _keys("uniform", "f64")
    rng = np.random.default_rng(3)
    if kind == "incremental":
        t = _online(keys, maintenance=MaintenanceConfig(incremental=True))
    else:
        t = _online(keys)
    t.upsert_batch(*_updates(keys, rng))
    if kind == "insert":
        t.upsert_batch([(keys[7] + keys[8]) / 2], [1])
    elif kind == "tombstone":
        t.delete_batch([keys[9]])
    elif kind == "missing":
        # a key the tree holds but the published flat does not: the
        # update finds it in the tree, the patch cannot
        new = (keys[20] + keys[21]) / 2
        assert t.dili.insert(new, 5)
        t.upsert_batch([new], [6])
    before = (t.n_patched_flattens, t.n_full_flattens,
              t.n_incremental_flattens)
    t.flush()
    after = (t.n_patched_flattens, t.n_full_flattens,
             t.n_incremental_flattens)
    assert after[0] == before[0]
    if kind == "incremental":
        assert after[2] == before[2] + 1 and after[1] == before[1]
    else:
        assert after[1] == before[1] + 1
    _assert_flat_equal(flatten(t.dili), t.store.flat)
    # the next payload-only merge patches again
    t.upsert_batch(*_updates(keys, rng))
    t.flush()
    assert t.n_patched_flattens == before[0] + (kind != "incremental")
    _assert_flat_equal(flatten(t.dili), t.store.flat)


@pytest.mark.parametrize("retry_inserts", [False, True])
def test_merge_that_dies_mid_fold_is_retried_exactly(monkeypatch,
                                                     retry_inserts):
    """The first fold applies half the frozen writes, then raises; the
    next merge reclaims them and folds again.  A write the dead fold
    applied that the retry undoes (a delete, then a newer upsert of the
    same key) comes back as an insert, which takes the full flatten."""
    keys = _keys("fb", "f64")
    rng = np.random.default_rng(9)
    t = _online(keys)
    k, v = _updates(keys, rng)
    t.upsert_batch(k, v)
    gone = keys[0]
    if retry_inserts:
        t.delete_batch([gone])

    def dies(dili, ov):
        ks, vs, ts = ov.entries()
        half = TombstoneOverlay.empty(ov.cap)._apply(
            ks[: len(ks) // 2 + 1], vs[: len(ks) // 2 + 1],
            ts[: len(ks) // 2 + 1])
        fold_overlay(dili, half)
        raise RuntimeError("fold died")

    monkeypatch.setattr(T_merge, "fold_overlay", dies)
    with pytest.raises(RuntimeError):
        t.flush()
    monkeypatch.setattr(T_merge, "fold_overlay", fold_overlay)
    if retry_inserts:
        t.upsert_batch([gone], [99])
    patched = t.n_patched_flattens
    t.flush()
    assert t.n_patched_flattens == patched + (not retry_inserts)
    _assert_flat_equal(flatten(t.dili), t.store.flat)
    assert t.get(gone) == (99 if retry_inserts else 0)


TIMED = ("publish_s", "merge_s")


def _run_facade(keys, seed):
    ix = LearnedIndex.build(keys, np.arange(len(keys)),
                            config=IndexConfig(telemetry=True),
                            device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(3):
        ix.upsert(*_updates(keys, rng))
        ix.flush()
    oi = ix._engine.oi
    stats = {k: v for k, v in ix.stats().items()
             if k not in ("ops_total",)}
    hist = [{f.name: getattr(s, f.name) for f in dataclasses.fields(s)
             if f.name not in TIMED} for s in oi.store.history]
    gauges = {k: v for k, v in ix.metrics()["gauges"].items()
              if k.startswith("inspect.")}
    out = stats, hist, gauges, oi.n_patched_flattens, oi.dili.dirty_ids
    ix.close()
    return out


def test_stats_equal_whichever_path_ran(monkeypatch):
    keys = _keys("wikits", "f64")
    patched = _run_facade(keys, 4)
    monkeypatch.setattr(T_merge, "patch_payloads", lambda *a: None)
    full = _run_facade(keys, 4)
    assert patched[3] == 3 and full[3] == 0
    assert patched[0] == full[0]
    assert patched[1] == full[1]
    assert patched[2] == full[2] and patched[2]
    assert patched[4] == full[4] == set()
