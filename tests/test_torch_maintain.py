"""The port's adaptive maintenance subsystem (`repro_torch.maintain` and the
maintenance half of `OnlineIndex` and the engines) against the JAX
package's, on the CPU.

The scenarios of tests/test_maintain.py run on both packages with the same
seeded inputs: host trees, splice flatteners, `OnlineIndex`es (the port's
with `device="cpu"`) and facades.  After every merge the published
`FlatDILI` must be equal field by field, and so must lookups, ranges,
`items()` and the maintenance counters of `stats()`.  Dirty plumbing is
keyed on `id()`, which differs between the packages, so the comparisons
read outputs and counters, never ids.  Background merges are timed by a
worker thread; those tests hold the port to a numpy truth and to the
reference's final state after the `flush()` barrier.
"""
import threading

import numpy as np
import pytest

from repro import api as JA
from repro import maintain as JM
from repro import online as JO
from repro.core import dili as JD
from repro_torch import api as TA
from repro_torch import maintain as TM
from repro_torch import online as TO
from repro_torch.core import dili as TD
from repro_torch.core.flat import flatten as t_flatten

FLAT_FIELDS = ("a", "b", "base", "fo", "dense", "tag", "key", "val",
               "pair_key", "pair_val", "pair_slot")
NO_AUTO = dict(max_writes=1 << 40, pressure_check_every=1 << 40)

# stats() keys that differ by design: the reference's VMEM budget check
# against the CUDA kernel, which serves every table size
_VOLATILE = {"kernel_eligible"}


def flat_equal(got, want, msg=""):
    for f in FLAT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, (msg, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {f}")
    assert (got.root, got.max_depth) == (want.root, want.max_depth), msg
    assert (got.key_lo, got.key_hi) == (want.key_lo, want.key_hi), msg
    assert got.n_segments == want.n_segments, msg


def flattener_equal(t, j, msg=""):
    for name in ("last_incremental", "last_dirty_rows", "last_total_rows",
                 "last_dirty_segments", "last_total_segments",
                 "n_fallback_full"):
        assert getattr(t, name) == getattr(j, name), (msg, name)


def same(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def stats_equal(j, t):
    sj, st = j.stats(), t.stats()
    assert set(sj) == set(st)
    for k in sj:
        if k not in _VOLATILE:
            assert sj[k] == st[k], (k, sj[k], st[k])


def irregular_keys(rng, n=8000):
    return np.unique(rng.integers(0, 1 << 22, n)).astype(np.float64)


def online_pair(keys, cfg_kw=None, policy=NO_AUTO, **kw):
    """The same OnlineIndex in both packages (the port's on the CPU)."""
    jm = None if cfg_kw is None else JM.MaintenanceConfig(**cfg_kw)
    tm = None if cfg_kw is None else TM.MaintenanceConfig(**cfg_kw)
    j = JO.OnlineIndex(keys, policy=JO.MergePolicy(**policy),
                       maintenance=jm, **kw)
    t = TO.OnlineIndex(keys, policy=TO.MergePolicy(**policy),
                       maintenance=tm, device="cpu", **kw)
    return j, t


def online_state_equal(j, t, msg=""):
    flat_equal(t.store.flat, j.store.flat, msg)
    flat_equal(t.store.flat, t_flatten(t.dili), msg + " vs full flatten")
    for name in ("epoch", "n_flattens", "n_full_flattens",
                 "n_incremental_flattens", "n_merges", "n_retrains",
                 "n_reclusters", "last_dirty_frac"):
        assert getattr(t, name) == getattr(j, name), (msg, name)
    if j.flattener is not None:
        flattener_equal(t.flattener, j.flattener, msg)
    st, sj = t.store.stats, j.store.stats
    for name in ("epoch", "n_keys", "n_nodes", "n_slots", "bytes_uploaded",
                 "overlay_fill", "merge_lag", "retraced", "incremental",
                 "dirty_frac", "n_retrains"):
        assert getattr(st, name) == getattr(sj, name), (msg, name)


# ---------------------------------------------------------------------------
# incremental flattener: bit identity with the reference and with flatten()
# ---------------------------------------------------------------------------


def test_splice_flatten_bit_identical_across_folds():
    """Cold build, random upsert/delete/update rounds and retrains on both
    packages' host trees: after every round the port's splice equals its
    own full flatten() and the reference's splice, with the same dirty
    counters."""
    rng = np.random.default_rng(0)
    keys = irregular_keys(rng)
    dj, dt = (JD.bulk_load(keys, sample_stride=2),
              TD.bulk_load(keys, sample_stride=2))
    fj, ft = JM.IncrementalFlattener(), TM.IncrementalFlattener()
    out_t = ft.flatten(dt, dt.take_dirty())
    flat_equal(out_t, fj.flatten(dj, dj.take_dirty()), "cold")
    flat_equal(out_t, t_flatten(dt), "cold vs full")
    assert not ft.last_incremental
    for step in range(4):
        ins = np.setdiff1d(rng.integers(0, 1 << 22, 250).astype(np.float64),
                           keys)
        dels = keys[rng.integers(0, len(keys), 80)]
        upd = keys[rng.integers(0, len(keys), 150)]
        for d in (dj, dt):
            for i, k in enumerate(ins):
                d.upsert(float(k), 10_000 + i)
            for k in dels:
                d.delete(float(k))
            for i, k in enumerate(upd):
                d.upsert(float(k), 20_000 + i)
        out_t = ft.flatten(dt, dt.take_dirty())
        flat_equal(out_t, fj.flatten(dj, dj.take_dirty()), f"fold{step}")
        flat_equal(out_t, t_flatten(dt), f"fold{step} vs full")
        flattener_equal(ft, fj, f"fold{step}")
        assert ft.last_incremental and ft.n_fallback_full == 0
        assert ft.last_dirty_segments < ft.last_total_segments
    # retrains swap whole subtrees: the cache misses on identity and the
    # splice stays exact
    for d, mod in ((dj, JD), (dt, TD)):
        tops = d.root.children if isinstance(d.root, mod.Internal) \
            else [d.root]
        rebuilt = 0
        for c in list(tops):
            if not isinstance(c, mod.Internal) and c.omega >= 2:
                assert mod.rebuild_subtree(d, c) is not None
                rebuilt += 1
            if rebuilt == 4:
                break
        assert rebuilt
    out_t = ft.flatten(dt, dt.take_dirty())
    flat_equal(out_t, fj.flatten(dj, dj.take_dirty()), "retrain")
    flat_equal(out_t, t_flatten(dt), "retrain vs full")
    flattener_equal(ft, fj, "retrain")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splice_flatten_random_ops(seed):
    """The reference's hypothesis sweep, as seeded random op streams on
    both packages: interleaved upserts, deletes, leaf splits and folds at
    random points; every fold equal across packages and to flatten()."""
    base = np.unique(np.random.default_rng(3)
                     .integers(0, 1 << 20, 1500)).astype(np.float64)
    rng = np.random.default_rng(100 + seed)
    ops = rng.choice(["upsert", "delete", "fold", "split"], 60,
                     p=[0.45, 0.3, 0.15, 0.1])
    ks = rng.integers(0, 1 << 20, 60)
    trees = [(JD.bulk_load(base), JM.IncrementalFlattener(), JD),
             (TD.bulk_load(base), TM.IncrementalFlattener(), TD)]
    for d, fl, _ in trees:
        fl.flatten(d, d.take_dirty())

    def fold(msg):
        (dj, fj, _), (dt, ft, _) = trees
        out = ft.flatten(dt, dt.take_dirty())
        flat_equal(out, fj.flatten(dj, dj.take_dirty()), msg)
        flat_equal(out, t_flatten(dt), msg + " vs full")
        flattener_equal(ft, fj, msg)

    for i, (op, k) in enumerate(zip(ops, ks.tolist())):
        for d, _, mod in trees:
            if op == "upsert":
                d.upsert(float(k), i)
            elif op == "delete":
                d.delete(float(k))
            elif op == "split":
                tops = d.root.children if isinstance(d.root, mod.Internal) \
                    else [d.root]
                cands = [c for c in tops
                         if not isinstance(c, mod.Internal) and c.omega >= 4]
                if cands:
                    leaf = cands[k % len(cands)]
                    if mod.split_leaf(d, leaf, 2 + k % 7) is not None \
                            and k % 2:
                        d.dirty_ids.add(id(leaf))
        if op == "fold":
            fold(f"fold@{i}")
    fold("final")


# ---------------------------------------------------------------------------
# accounting, retrains, re-clusters
# ---------------------------------------------------------------------------


def test_ks_uniform_and_leaf_drift_equal():
    for x in (np.zeros(0), np.linspace(0.01, 0.99, 100), np.full(100, 0.5),
              np.random.default_rng(6).uniform(0, 1, 333)):
        assert TM.ks_uniform(x) == JM.ks_uniform(x)
    assert TM.ks_uniform(np.linspace(0.01, 0.99, 100)) < 0.05
    keys = np.unique(np.random.default_rng(6)
                     .integers(0, 1 << 20, 4000)).astype(np.float64)
    out = []
    for mod in (JD, TD):
        leaf, _ = mod.bulk_load(keys).locate_leaf(1000.0)
        ks = [p[0] for p in mod.collect_pairs(leaf)]
        arrivals = np.linspace(ks[0], ks[-1], 50)
        out.append((TM.leaf_drift(leaf, ks) if mod is TD
                    else JM.leaf_drift(leaf, ks),
                    TM.leaf_drift(leaf, arrivals) if mod is TD
                    else JM.leaf_drift(leaf, arrivals)))
    assert out[0] == out[1] and out[1][0] < 0.3


def test_drift_triggers_retrain_and_restores_layout():
    rng = np.random.default_rng(4)
    keys = irregular_keys(rng, 6000)
    j, t = online_pair(keys, dict(retrain_min_writes=32,
                                  drift_threshold=0.35),
                       overlay_cap=1 << 14)
    lo = float(keys[len(keys) // 2])
    band = np.setdiff1d(np.arange(lo + 1, lo + 400, 3, dtype=np.float64),
                        keys)
    for ix in (j, t):
        ix.upsert_batch(band, np.arange(len(band)))
        ix.flush()
    online_state_equal(j, t, "drift")
    assert t.n_retrains >= 1 and t.n_incremental_flattens >= 1
    for q in (band[:64], keys[:256]):
        v, f = t.lookup(q)
        same(j.lookup(q), (v, f))
        assert f.all()


def test_tombstone_density_triggers_compaction():
    rng = np.random.default_rng(5)
    keys = irregular_keys(rng, 6000)
    j, t = online_pair(keys, dict(retrain_min_writes=16,
                                  tombstone_trigger=0.2,
                                  drift_threshold=2.0),
                       overlay_cap=1 << 14)
    victims = keys[100: 1124: 2]
    for ix in (j, t):
        ix.delete_batch(victims)
        ix.flush()
    online_state_equal(j, t, "tombstones")
    assert t.n_retrains >= 1
    v, f = t.lookup(victims[:64])
    same(j.lookup(victims[:64]), (v, f))
    assert not f.any()


def _top_leaves(d, mod):
    tops = d.root.children if isinstance(d.root, mod.Internal) else [d.root]
    return [c for c in tops if not isinstance(c, mod.Internal)]


def test_split_leaf_bit_identity_and_refusals():
    rng = np.random.default_rng(11)
    keys = irregular_keys(rng, 8000)
    flats, segs = [], []
    for mod, fl in ((JD, JM.IncrementalFlattener()),
                    (TD, TM.IncrementalFlattener())):
        d = mod.bulk_load(keys, sample_stride=2)
        f0 = fl.flatten(d, d.take_dirty())
        leaf = max((c for c in _top_leaves(d, mod) if c.omega >= 32),
                   key=lambda c: c.omega)
        before = {float(p[0]): p[1] for p in mod.collect_pairs(leaf)}
        assert mod.split_leaf(d, leaf, 1) is None
        node = mod.split_leaf(d, leaf, 8)
        assert node is not None and len(node.children) == 8
        assert mod.split_leaf(d, leaf, 8) is None
        d.dirty_ids.add(id(leaf))
        f1 = fl.flatten(d, d.take_dirty())
        assert fl.n_fallback_full == 0 and fl.last_incremental
        flats.append(f1)
        segs.append((f0.n_segments, f1.n_segments))
        for k, v in before.items():
            assert d.search(k) == v
    flat_equal(flats[1], flats[0], "split")
    assert segs[0] == segs[1] and segs[1][1] >= segs[1][0] + 7


def test_recluster_pipeline_splits_hot_segment_and_cuts_dirty_rows():
    rng = np.random.default_rng(12)
    keys = irregular_keys(rng, 16000)
    j, t = online_pair(keys, dict(retrain=False, recluster_hot_streak=2,
                                  recluster_min_rows=64,
                                  recluster_target_pairs=8,
                                  recluster_max_per_merge=64),
                       sample_stride=2, overlay_cap=1 << 14)
    leaf = max(_top_leaves(t.dili, TD), key=lambda c: c.omega)
    assert leaf.omega >= 32
    lk = np.array([p[0] for p in TD.collect_pairs(leaf)], np.float64)
    hot = lk[:: max(1, len(lk) // 4)][:4]
    rows = []
    for r in range(4):
        for ix in (j, t):
            ix.upsert_batch(hot, np.full(len(hot), 1000 + r, np.int64))
            ix.flush()
        online_state_equal(j, t, f"merge {r}")
        rows.append(t.flattener.last_dirty_rows)
    assert t.n_reclusters >= 1
    assert rows[-1] < rows[1], rows
    v, f = t.lookup(hot)
    same(j.lookup(hot), (v, f))
    assert f.all() and (v == 1003).all()


def test_recluster_respects_budget_and_min_rows():
    """Planner contract in both packages: segments below
    `recluster_min_rows` never qualify, and one merge never splits more
    than `recluster_max_per_merge` leaves.  Under a budget that cuts
    between equally hot and equally large leaves, which of them split
    follows the iteration order of a set of `id()`s (`plan_reclusters`),
    which differs from run to run in the reference as in the port: the
    packages are held to the same split counts per merge and each to its
    own full flatten(), not to each other's trees."""
    rng = np.random.default_rng(13)
    keys = irregular_keys(rng, 16000)
    j, t = online_pair(keys, dict(retrain=False, recluster_hot_streak=1,
                                  recluster_min_rows=1 << 30,
                                  recluster_target_pairs=8),
                       sample_stride=2, overlay_cap=1 << 14)
    for r in range(3):
        for ix in (j, t):
            ix.upsert_batch(keys[::97], np.full(len(keys[::97]), r,
                                                np.int64))
            ix.flush()
        online_state_equal(j, t, f"min rows {r}")
    assert t.n_reclusters == j.n_reclusters == 0
    j, t = online_pair(keys, dict(retrain=False, recluster_hot_streak=1,
                                  recluster_min_rows=16,
                                  recluster_target_pairs=4,
                                  recluster_max_per_merge=2),
                       sample_stride=2, overlay_cap=1 << 14)
    seen = 0
    for r in range(2):
        for ix in (j, t):
            ix.upsert_batch(keys[::97], np.full(len(keys[::97]), r,
                                                np.int64))
            ix.flush()
        assert t.n_reclusters == j.n_reclusters
        assert t.n_reclusters - seen <= 2
        seen = t.n_reclusters
        flat_equal(t.store.flat, t_flatten(t.dili), f"budget {r}")
        q = keys[::50]
        v, f = t.lookup(q)
        same(j.lookup(q), (v, f))
        assert f.all()
    assert seen >= 1


def test_unmappable_dirty_id_counts_forced_full_flatten():
    U = np.arange(0, 8000, 2, dtype=np.float64)
    ixs = [pkg.LearnedIndex.build(U, config=pkg.IndexConfig(
        engine="local", overlay_cap=1 << 14,
        merge=pkg.MergePolicy(**NO_AUTO),
        maintenance=pkg.MaintenanceConfig()), **kw)
        for pkg, kw in ((JA, {}), (TA, {"device": "cpu"}))]
    for lo, leak in ((1, False), (101, True), (201, False)):
        for ix in ixs:
            ix.upsert(np.arange(lo, lo + 100, 2, dtype=np.float64),
                      np.arange(50, dtype=np.int64))
            if leak:
                ix._engine.oi.dili.dirty_ids.add(12345)
            ix.flush()
        stats_equal(*ixs)
        flat_equal(ixs[1]._engine.oi.store.flat,
                   ixs[0]._engine.oi.store.flat, f"lo={lo}")
    s = ixs[1].stats()
    assert s["n_forced_full_flattens"] == 1 and s["n_incremental_flattens"]
    v, f = ixs[1].lookup(np.arange(101, 301, 2, dtype=np.float64))
    assert f.all()
    for ix in ixs:
        ix.close()


# ---------------------------------------------------------------------------
# maintenance through the facade on both engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["local", "pallas"])
def test_facade_maintenance_rounds_equal(engine):
    """Write rounds under the default merge policy with the adaptive
    pipeline on: after every round the published flat, the lookups,
    ranges, `items()`, `stats()` (maintenance counters included),
    `maint_timings()`' kinds and the `dili.metrics/1` counters equal the
    reference's, and merges really splice and re-cluster (retrains are
    the drift and tombstone tests' subject)."""
    rng = np.random.default_rng(7)
    keys = irregular_keys(rng, 12000)
    mcfg = dict(recluster_hot_streak=1, recluster_min_rows=64,
                recluster_target_pairs=16, retrain_min_writes=32)
    j, t = [pkg.LearnedIndex.build(keys, config=pkg.IndexConfig(
        engine=engine, overlay_cap=1 << 10, telemetry=True,
        maintenance=pkg.MaintenanceConfig(**mcfg)), **kw)
        for pkg, kw in ((JA, {}), (TA, {"device": "cpu"}))]
    r = np.random.default_rng(8)
    for rnd in range(5):
        up = np.unique(r.integers(0, 1 << 22, 700)).astype(np.float64)
        dead = keys[r.integers(0, len(keys), 120)]
        for ix in (j, t):
            ix.upsert(up, np.arange(len(up), dtype=np.int64) + rnd)
            ix.delete(dead)
        fj, ft = ((ix._engine.oi.store.flat if engine == "local"
                   else ix._engine.flat) for ix in (j, t))
        flat_equal(ft, fj, f"round {rnd}")
        stats_equal(j, t)
        q = np.concatenate([up, dead, keys[:500]])
        same(j.lookup(q), t.lookup(q))
        same(j.range(keys[:64], keys[40:104], 16),
             t.range(keys[:64], keys[40:104], 16))
    same(j.items(), t.items())
    kinds = [[(m["incremental"], m["dirty_frac"]) for m in ix.maint_timings()]
             for ix in (j, t)]
    assert kinds[0] == kinds[1]
    st = t.stats()
    assert st["n_incremental_flattens"] >= 3 and st["n_reclusters"] > 0
    assert st["n_forced_full_flattens"] == 0 and st["maint_errors"] == 0
    cj, ct = (ix.metrics()["counters"] for ix in (j, t))
    assert cj == ct and ct["maint.reclusters"] == st["n_reclusters"]
    for ix in (j, t):
        ix.close()


@pytest.mark.parametrize("engine", ["local", "pallas"])
def test_on_publish_fires_after_each_merge(engine):
    """`set_on_publish`: the hook runs once per merge publish, after the
    flip (it sees the new epoch), on both engines, as in the reference."""
    keys = np.arange(0, 4000, 2, dtype=np.float64)
    seen = {}
    for pkg, kw in ((JA, {}), (TA, {"device": "cpu"})):
        ix = pkg.LearnedIndex.build(keys, config=pkg.IndexConfig(
            engine=engine, merge=pkg.MergePolicy(max_writes=300),
            maintenance=pkg.MaintenanceConfig()), **kw)
        epochs = []
        ix._engine.set_on_publish(lambda ix=ix: epochs.append(ix.epoch))
        for b in range(4):
            ix.upsert(np.arange(1 + 400 * b, 400 * (b + 1), 2.0),
                      np.arange(200))
        ix.flush()
        seen[pkg.__name__] = epochs
        ix.close()
    assert seen["repro.api"] == seen["repro_torch.api"]
    assert seen["repro_torch.api"] == list(range(2, 2 + len(
        seen["repro_torch.api"]))) and len(seen["repro_torch.api"]) >= 2


# ---------------------------------------------------------------------------
# scheduler, background merges, retries
# ---------------------------------------------------------------------------


def test_scheduler_runs_records_errors_and_closes():
    sched = TM.MaintenanceScheduler(max_queue=2)
    done = []
    assert sched.submit(lambda: done.append(1))
    sched.drain()
    assert done == [1] and sched.depth == 0
    assert sched.submit(lambda: 1 / 0)
    sched.drain()
    assert len(sched.errors) == 1 and "ZeroDivisionError" in sched.errors[0]
    sched.close()
    assert not sched.submit(lambda: done.append(2))
    sched.close()


def test_background_merge_never_blocks_correctness():
    """Reader threads hammer a stable probe set while the writer drives
    background merges (fold, retrain, splice, publish on the worker);
    every read is exact at every instant, and after the flush barrier the
    state equals the numpy truth and the reference's."""
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 21, 6000)).astype(np.float64) * 2
    vals = np.arange(len(keys), dtype=np.int64)
    cfgs = [pkg.IndexConfig(
        engine="local", overlay_cap=512, merge=pkg.MergePolicy(max_writes=256),
        maintenance=pkg.MaintenanceConfig(background=True,
                                          retrain_min_writes=64))
        for pkg in (JA, TA)]
    j = JA.LearnedIndex.build(keys, vals, config=cfgs[0])
    t = TA.LearnedIndex.build(keys, vals, config=cfgs[1], device="cpu")
    probe, want_v = keys[:512], vals[:512]
    stop = threading.Event()
    failures: list[str] = []

    def reader():
        while not stop.is_set():
            v, f = t.lookup(probe)
            if not (f.all() and np.array_equal(v, want_v)):
                failures.append("probe lookup diverged mid-publish")
                return

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for th in threads:
        th.start()
    tk, tv = keys.copy(), vals.copy()
    fresh = np.arange(keys.max() + 1, keys.max() + 4000, 2)
    try:
        for step in range(30):
            new = fresh[step * 64: (step + 1) * 64]
            nv = np.arange(len(new), dtype=np.int64) + step * 1000
            dead = keys[1000 + step * 16: 1000 + (step + 1) * 16]
            for ix in (j, t):
                ix.upsert(new, nv)
                ix.delete(dead)
            keep = ~np.isin(tk, dead)
            tk, tv = tk[keep], tv[keep]
            order = np.argsort(np.concatenate([tk, new]), kind="stable")
            tk = np.concatenate([tk, new])[order]
            tv = np.concatenate([tv, nv])[order]
            v, f = t.lookup(np.concatenate([new, dead]))
            assert f[:len(new)].all() and not f[len(new):].any()
            assert np.array_equal(v[:len(new)], nv)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert failures == []
    sj, st = j.flush(), t.flush()
    assert st["n_merges"] >= 1 and st["maint_errors"] == 0
    assert st["n_incremental_flattens"] >= 1 and not st["maint_degraded"]
    assert st["pending_writes"] == 0 and st["maint_queue_depth"] == 0
    k, v = t.items()
    assert np.array_equal(k, tk) and np.array_equal(v, tv)
    same(j.items(), (k, v))
    for ix in (j, t):
        ix.close()


def test_kernel_counters_lose_no_update_under_reader_threads():
    """`OnlineIndex.kernel_stats` is updated by every reader thread: with
    more readers than cores and a short switch interval, no increment is
    lost."""
    import sys
    keys = np.arange(0, 2000, 2, dtype=np.float64)
    oi = TO.OnlineIndex(keys, overlay_cap=64, device="cpu")
    q = keys[:32]
    n_threads, n_calls = 12, 25
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [oi.lookup(q) for _ in
                                                    range(n_calls)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert oi.kernel_stats == dict(lookups=n_threads * n_calls,
                                   lanes=n_threads * n_calls * len(q))


def test_background_rejected_off_local():
    U = np.arange(0, 400, 2, dtype=np.float64)
    with pytest.raises(ValueError, match="background maintenance"):
        TA.LearnedIndex.build(U, config=TA.IndexConfig(
            engine="pallas", maintenance=TA.MaintenanceConfig(
                background=True)), device="cpu")


def test_failed_merge_restores_pending_writes(monkeypatch):
    import repro_torch.online.merge as M
    keys = np.arange(0, 2000, 2, dtype=np.float64)
    oi = TO.OnlineIndex(keys, policy=TO.MergePolicy(**NO_AUTO),
                        overlay_cap=1 << 14, device="cpu")
    oi.upsert_batch(np.arange(1, 201, 2, dtype=np.float64),
                    np.arange(100, dtype=np.int64))
    monkeypatch.setattr(M, "fold_overlay",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(RuntimeError):
        oi.merge("explicit")
    assert oi._merging is not None and oi._merge_failed
    assert len(oi.pending_entries()[0]) == 100
    v, f = oi.lookup(np.arange(1, 201, 2, dtype=np.float64))
    assert f.all()
    monkeypatch.undo()
    st = oi.flush()
    assert oi._merging is None and not oi._merge_failed
    assert oi.overlay.count == 0 and st.n_keys == len(keys) + 100


def _background_pair(keys, **mkw):
    return [pkg.LearnedIndex.build(keys, config=pkg.IndexConfig(
        engine="local", overlay_cap=1 << 14, telemetry=True,
        merge=pkg.MergePolicy(**NO_AUTO),
        maintenance=pkg.MaintenanceConfig(background=True, **mkw)), **kw)
        for pkg, kw in ((JA, {}), (TA, {"device": "cpu"}))]


def test_worker_retries_then_succeeds(monkeypatch):
    """A worker merge that fails once is retried (no backoff, so no test
    reads the jitter): one `maint.errors`, one `merge.failed` span, not
    degraded, and the state equals the reference's run through the same
    fault."""
    import repro.online.merge as jm
    import repro_torch.online.merge as tm
    keys = np.arange(0, 4000, 2, dtype=np.float64)
    ixs = _background_pair(keys, max_merge_retries=2, retry_backoff_s=0.0)
    for mod, ix in zip((jm, tm), ixs):
        real, calls = mod.fold_with_accounting, []

        def flaky(*a, real=real, calls=calls):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("transient")
            return real(*a)

        monkeypatch.setattr(mod, "fold_with_accounting", flaky)
        ix.upsert(np.arange(1, 2001, 2, dtype=np.float64), np.arange(1000))
        ix.flush()
        assert len(calls) == 2
    stats_equal(*ixs)
    st = ixs[1].stats()
    assert st["maint_errors"] == 0 and not st["maint_degraded"]
    assert st["n_merges"] == 1 and st["pending_writes"] == 0
    for ix in ixs:
        m = ix.metrics()
        assert m["counters"]["maint.errors"] == 1
        assert m["spans"]["merge.failed"]["count"] == 1
    same(ixs[0].items(), ixs[1].items())
    for ix in ixs:
        ix.close()


def test_worker_exhausts_retries_and_degrades(monkeypatch):
    """A fold that always fails: the worker gives up after its retries
    and records the error, the index degrades to synchronous merges,
    `flush()` raises with the pending writes still readable, and once the
    fault clears a flush folds them — as in the reference."""
    import repro.online.merge as jm
    import repro_torch.online.merge as tm
    keys = np.arange(0, 4000, 2, dtype=np.float64)
    ixs = _background_pair(keys, max_merge_retries=1, retry_backoff_s=0.0)
    new = np.arange(1, 401, 2, dtype=np.float64)
    for mod, ix in zip((jm, tm), ixs):
        monkeypatch.setattr(mod, "fold_with_accounting",
                            lambda *a: (_ for _ in ()).throw(
                                RuntimeError("persistent")))
        ix.upsert(new, np.arange(200))
        with pytest.raises(RuntimeError, match="keeps failing"):
            ix.flush()
        v, f = ix.lookup(new)
        assert f.all() and np.array_equal(v, np.arange(200))
        monkeypatch.undo()
    sj, st = (ix.stats() for ix in ixs)
    assert st["maint_degraded"] and sj["maint_degraded"]
    assert st["maint_errors"] == sj["maint_errors"] >= 1
    assert "persistent" in st["maint_error_logs"][-1]
    for ix in ixs:
        ix.flush()                  # degraded: a synchronous merge
    st = ixs[1].stats()
    assert st["pending_writes"] == 0 and st["snapshot_keys"] == 2200
    same(ixs[0].items(), ixs[1].items())
    for ix in ixs:
        ix.close()


def test_flush_is_a_synchronous_barrier():
    U = np.arange(0, 4000, 2, dtype=np.float64)
    ixs = _background_pair(U)
    new = np.arange(1, 2000, 2, dtype=np.float64)
    for ix in ixs:
        ix.upsert(new, np.arange(len(new), dtype=np.int64))
        st = ix.flush()
        assert st["pending_writes"] == 0
        assert st["epoch"] == 2 and st["n_merges"] == 1
        assert st["snapshot_keys"] == len(U) + len(new)
    stats_equal(*ixs)
    flat_equal(ixs[1]._engine.oi.store.flat, ixs[0]._engine.oi.store.flat)
    for ix in ixs:
        ix.close()
