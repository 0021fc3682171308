"""The port's online-update subsystem (`repro_torch.online`: the epoch
snapshot store, `OnlineIndex` and its merge policy) against the JAX
package's, on the CPU.

Each scenario of tests/test_online.py (the SessionTable ones aside) runs
on `repro.online.OnlineIndex` and on `repro_torch.online.OnlineIndex(...,
device="cpu")` with the same seeded inputs; every answer must be equal at
every step, bit for bit (int64 payloads, bools, f64 keys copied), and the
scenario's own assertions hold on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as JS
from repro.core.dili import bulk_load as j_bulk_load
from repro.core.flat import flatten as j_flatten
from repro import online as J
from repro_torch import online as T
from repro_torch.api.snapshot import from_numpy_tables
from repro_torch.core import search as TS
from repro_torch.core.dili import bulk_load as t_bulk_load
from repro_torch.core.flat import flatten as t_flatten
from repro_torch.kernels import ops as T_ops
from tests.conftest import make_keys


def _pair(keys, vals=None, **kw):
    """The same OnlineIndex in both packages (the port's on the CPU)."""
    j = J.OnlineIndex(keys, vals, **kw)
    t = T.OnlineIndex(keys, vals, device="cpu", **kw)
    return j, t


def _policy(**kw):
    return J.MergePolicy(**kw), T.MergePolicy(**kw)


def _same(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


def _lookup_both(j, t, q):
    out = t.lookup(q)
    _same(j.lookup(q), out)
    return out


def _state_equal(j, t):
    assert (j.epoch, j.n_merges, j.n_flattens) == (t.epoch, t.n_merges,
                                                   t.n_flattens)
    assert dict(j.merge_reasons) == dict(t.merge_reasons)
    _same(j.overlay.entries(), t.overlay.entries())
    _same(j.pending_entries(), t.pending_entries())


def _fresh(rng, n=3000, dist="uniform", **kw):
    keys = make_keys(dist, n, rng)
    if "policy" in kw:
        jp, tp = kw.pop("policy")
        return (keys, J.OnlineIndex(keys, policy=jp, **kw),
                T.OnlineIndex(keys, policy=tp, device="cpu", **kw))
    return (keys, *_pair(keys, **kw))


# ---------------------------------------------------------------------------
# overlay
# ---------------------------------------------------------------------------


def test_overlay_last_write_wins_and_doubling():
    for pkg in (J, T):
        ov = pkg.TombstoneOverlay.empty(4)
        ov = ov.upsert_batch([5.0], [1]).upsert_batch([5.0], [2])
        assert ov.get(5.0) == (pkg.LIVE, 2)
        ov = ov.delete_batch([5.0])
        assert ov.get(5.0) == (pkg.TOMBSTONE, None)
        ov = ov.upsert_batch([5.0], [3]).upsert_batch([7.0, 7.0], [10, 11])
        assert ov.get(5.0) == (pkg.LIVE, 3) and ov.get(7.0) == (pkg.LIVE, 11)
        assert ov.upsert_batch([], []).count == ov.count == 2
        ov = ov.upsert_batch(np.arange(10, dtype=np.float64), np.arange(10))
        assert ov.cap == 16 and ov.count == 10    # 5.0, 7.0 overwritten
    jo = (J.TombstoneOverlay.empty(4).upsert_batch(np.arange(10.0),
                                                   np.arange(10))
          .delete_batch([3.0, 4.0, 20.0]))
    to = (T.TombstoneOverlay.empty(4).upsert_batch(np.arange(10.0),
                                                   np.arange(10))
          .delete_batch([3.0, 4.0, 20.0]))
    _same(jo.entries(), to.entries())
    assert (jo.cap, jo.n_live, jo.n_tombstones) == (to.cap, to.n_live,
                                                     to.n_tombstones)


# ---------------------------------------------------------------------------
# fused lookup, epoch store
# ---------------------------------------------------------------------------


def test_fused_lookup_precedence(rng):
    keys = make_keys("uniform", 4000, rng)
    jd, td = j_bulk_load(keys), t_bulk_load(keys)
    jstore, tstore = J.SnapshotStore(), T.SnapshotStore(device="cpu")
    jstore.publish(j_flatten(jd))
    tstore.publish(t_flatten(td))
    writes = [("upsert", [keys[10], keys[0] - 5.0], [777, 888]),
              ("delete", [keys[11]], None)]
    ovs = []
    for pkg in (J, T):
        ov = pkg.TombstoneOverlay.empty(64)
        for op, k, v in writes:
            ov = ov.upsert_batch(k, v) if op == "upsert" else \
                ov.delete_batch(k)
        ovs.append(ov)
    jova = J.overlay_device_arrays(ovs[0])
    tova = T.overlay_device_arrays(ovs[1], device="cpu")
    q = np.asarray([keys[10], keys[0] - 5.0, keys[11], keys[12]])
    want = [np.asarray(x) for x in
            JS.search_with_overlay(jstore.idx, jova, jnp.asarray(q))]
    # the port's plain composition over the DeviceSnapshot, and the f64
    # kernel instance's plain version over the epoch's kernel tables
    for got in (TS.search_with_overlay(tstore.idx, tova, torch.from_numpy(q)),
                T_ops.search_with_overlay(tstore.kernel_tables, tova,
                                          torch.from_numpy(q))):
        _same(want, [x.numpy() for x in got])
    v, f = want
    assert f[0] and v[0] == 777        # overlay overrides snapshot value
    assert f[1] and v[1] == 888        # overlay-only key found
    assert not f[2]                    # tombstone hides snapshot hit
    assert f[3] and v[3] == 12         # untouched snapshot key


@pytest.mark.parametrize("dist", ["logn", "uniform", "fb"])
@pytest.mark.parametrize("early_exit", [False, True])
def test_plain_search_with_overlay_matches_jax(dist, early_exit):
    """`core.search.search_with_overlay` over a padded f64 snapshot, with
    upserts and tombstones pending, at the snapshot's depth and one
    short."""
    rng = np.random.default_rng(51)
    keys = make_keys(dist, 6000, rng)
    jf = j_flatten(j_bulk_load(keys))
    jarr = JS.device_arrays(jf, jnp.float64)
    tarr = from_numpy_tables({k: np.asarray(v) for k, v in jarr.items()},
                             device="cpu")
    mids = (keys[:-1] + keys[1:]) / 2
    ovs = [pkg.TombstoneOverlay.empty(32)
           .upsert_batch(np.concatenate([keys[:40], mids[:40]]),
                         np.arange(80) + 2 ** 35)
           .delete_batch(keys[100:150]) for pkg in (J, T)]
    jova = J.overlay_device_arrays(ovs[0])
    tova = T.overlay_device_arrays(ovs[1], device="cpu")
    q = np.concatenate([keys[rng.integers(0, len(keys), 1500)],
                        mids[rng.integers(0, len(mids), 500)], keys[:200],
                        mids[:60], [np.inf, np.nan, -1e300, 1e300]])
    for md in (jf.max_depth, jf.max_depth - 1):
        want = JS.search_with_overlay(jarr, jova, jnp.asarray(q), md,
                                      early_exit=early_exit)
        got = TS.search_with_overlay(tarr, tova, torch.from_numpy(q), md,
                                     early_exit=early_exit)
        _same(want, [x.numpy() for x in got])


def test_snapshot_store_double_buffer(rng):
    keys = make_keys("uniform", 3000, rng)
    jd, td = j_bulk_load(keys), t_bulk_load(keys)
    jstore, tstore = J.SnapshotStore(), T.SnapshotStore(device="cpu")
    sts = [s.publish(f) for s, f in ((jstore, j_flatten(jd)),
                                     (tstore, t_flatten(td)))]
    assert tstore.epoch == 1 and sts[1].retraced    # first epoch always
    idx_n, pairs_n, tables_n = tstore.idx, tstore.pairs, tstore.kernel_tables
    for d in (jd, td):
        for k in keys[:5]:
            d.delete(float(k))
    sts = [s.publish(f, overlay_fill=0.25, merge_lag=5)
           for s, f in ((jstore, j_flatten(jd)), (tstore, t_flatten(td)))]
    for name in ("epoch", "n_keys", "n_nodes", "n_slots", "bytes_uploaded",
                 "overlay_fill", "merge_lag", "retraced", "incremental",
                 "dirty_frac", "n_retrains"):
        assert getattr(sts[0], name) == getattr(sts[1], name), name
    assert tstore.epoch == 2 and sts[1].publish_s >= 0
    # double buffering: epoch 1's tables are other, still-live objects
    assert tstore.pairs is not pairs_n and tstore.kernel_tables is not tables_n
    q = torch.from_numpy(keys[:5])
    assert bool(TS.search_batch(idx_n, q)[1].all())
    assert bool(T_ops.search_with_overlay(
        tables_n, T.overlay_device_arrays(T.TombstoneOverlay.empty(4),
                                          device="cpu"), q)[1].all())
    assert not TS.search_batch(tstore.idx, q)[1].any()   # sees the deletes


def test_snapshot_store_pow2_padding_stable(rng):
    """Small mutations keep the padded shapes (`retraced` False), in both
    packages."""
    keys = make_keys("uniform", 3000, rng)
    out = []
    for store, bulk, flat in ((J.SnapshotStore(), j_bulk_load, j_flatten),
                              (T.SnapshotStore(device="cpu"), t_bulk_load,
                               t_flatten)):
        d = bulk(keys)
        store.publish(flat(d))
        d.insert(float(keys[0]) + 0.5, 42)
        out.append(store.publish(flat(d)).retraced)
    assert out == [False, False]


def test_snapshot_store_retraces_on_growth(rng):
    """Doubling the keys changes the padded shapes: `retraced` and
    `bytes_uploaded` as the reference's, which uploads the whole
    snapshot, where the port's store keeps only the pair table and the
    kernel tables on the device."""
    keys = make_keys("uniform", 6000, rng)
    out = []
    for store, bulk, flat in ((J.SnapshotStore(), j_bulk_load, j_flatten),
                              (T.SnapshotStore(device="cpu"), t_bulk_load,
                               t_flatten)):
        d = bulk(keys[::2])
        store.publish(flat(d))
        for k in keys[1::2]:
            d.insert(float(k), 7)
        st = store.publish(flat(d))
        out.append((st.retraced, st.bytes_uploaded))
    assert out[0] == out[1] and out[1][0]
    tstore = store
    assert set(tstore.pairs) == {"pair_key", "pair_val"}
    snap = tstore.idx
    assert tstore.stats.bytes_uploaded == snap.nbytes
    for name in ("pair_key", "pair_val"):
        assert torch.equal(tstore.pairs[name], snap.arrays[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pad", [True, False])
def test_device_layout_is_device_arrays(dtype, pad, rng):
    """`device_layout` gives the shapes and dtypes `device_arrays`
    uploads, and `layout_nbytes` the snapshot's bytes, for a build and
    for one whose keys were all deleted (an empty pair table)."""
    emptied = t_bulk_load(np.arange(3.0))
    for k in range(3):
        emptied.delete(float(k))
    for d in (t_bulk_load(make_keys("logn", 3000, rng)), emptied):
        flat = t_flatten(d)
        arrs = TS.device_arrays(flat, dtype, pad=pad, device="cpu")
        arrs.pop("max_depth"), arrs.pop("has_dense")
        assert TS.device_layout(flat, dtype, pad) == {
            k: (tuple(v.shape), v.dtype) for k, v in arrs.items()}
        assert TS.layout_nbytes(TS.device_layout(flat, dtype, pad)) == \
            T.SnapshotStore(dtype=dtype, pad=pad, device="cpu") \
            .publish(flat).bytes_uploaded == sum(
                v.numel() * v.element_size() for v in arrs.values())


# ---------------------------------------------------------------------------
# merge policy
# ---------------------------------------------------------------------------


def test_empty_flush_keeps_epoch(rng):
    keys, j, t = _fresh(rng, n=500, overlay_cap=32)
    e0, fl0 = t.epoch, t.n_flattens
    sts = j.flush(), t.flush()                     # nothing pending
    assert t.epoch == e0 and t.n_flattens == fl0
    assert sts[0].epoch == sts[1].epoch == e0
    _state_equal(j, t)


def test_merge_trigger_fill(rng):
    keys, j, t = _fresh(rng, overlay_cap=64,
                        policy=_policy(max_fill=0.5, max_writes=10**9))
    new = keys[:-1] + np.diff(keys) / 2
    for i, k in enumerate(new[:31]):
        j.upsert(float(k), i)
        t.upsert(float(k), i)
    assert t.n_merges == 0                         # 31/64 < 0.5
    for ix in (j, t):
        ix.upsert(float(new[31]), 31)
    assert t.n_merges == 1 and t.merge_reasons["fill"] == 1
    assert t.overlay.count == 0                    # reset after the merge
    _state_equal(j, t)
    _lookup_both(j, t, new[:40])


def test_merge_trigger_lag(rng):
    keys, j, t = _fresh(rng, overlay_cap=4096,
                        policy=_policy(max_fill=1.1, max_writes=50))
    new = keys[:-1] + np.diff(keys) / 2
    for i, k in enumerate(new[:120]):
        j.upsert(float(k), i)
        t.upsert(float(k), i)
    assert t.n_merges == 2 and t.merge_reasons["lag"] == 2
    _state_equal(j, t)
    _lookup_both(j, t, new[:130])


def test_merge_trigger_pressure(rng):
    keys, j, t = _fresh(rng, overlay_cap=1 << 16,
                        policy=_policy(max_fill=1.1, max_writes=10**9,
                                       pressure_lambda=2.0,
                                       pressure_check_every=64))
    # hammer one tiny key interval: all pending writes land in one leaf
    hot = np.linspace(float(keys[100]), float(keys[101]), 200)[1:-1]
    for i, k in enumerate(hot):
        j.upsert(float(k), i)
        t.upsert(float(k), i)
    assert t.merge_reasons["pressure"] >= 1
    _state_equal(j, t)
    v, f = _lookup_both(j, t, hot)
    assert f.all() and np.array_equal(v, np.arange(len(hot)))


def test_explicit_flush_and_pressure_metric(rng):
    keys, j, t = _fresh(rng, overlay_cap=1024,
                        policy=_policy(max_fill=1.1, max_writes=10**9,
                                       pressure_check_every=10**9))
    assert T.adjust_pressure(t.dili, t.overlay) == 0.0
    for ix in (j, t):
        ix.upsert(float(keys[0]) + 0.25, 1)
    assert (T.adjust_pressure(t.dili, t.overlay)
            == J.adjust_pressure(j.dili, j.overlay) > 0.0)
    e0 = t.epoch
    sts = j.flush(), t.flush()
    assert t.epoch == e0 + 1 and sts[1].epoch == t.epoch == sts[0].epoch
    assert t.get(float(keys[0]) + 0.25) == j.get(float(keys[0]) + 0.25) == 1
    _state_equal(j, t)


# ---------------------------------------------------------------------------
# end-to-end: exact at every point between merges
# ---------------------------------------------------------------------------


def test_online_index_matches_oracle_between_merges(rng):
    keys = make_keys("logn", 4000, rng)
    jp, tp = _policy(max_fill=0.5, max_writes=300)
    j = J.OnlineIndex(keys, overlay_cap=128, policy=jp)
    t = T.OnlineIndex(keys, overlay_cap=128, policy=tp, device="cpu")
    oracle = {float(k): i for i, k in enumerate(keys)}
    universe = np.unique(np.concatenate(
        [keys, rng.uniform(keys[0], keys[-1], 1500)]))
    ops = rng.integers(0, 3, 900)
    picks = rng.integers(0, len(universe), 900)
    nxt = len(keys)
    for step, (op, pi) in enumerate(zip(ops, picks)):
        k = float(universe[pi])
        if op == 0:
            j.upsert(k, nxt)
            t.upsert(k, nxt)
            oracle[k] = nxt
            nxt += 1
        elif op == 1:
            j.delete(k)
            t.delete(k)
            oracle.pop(k, None)
        if step % 60 == 0:        # exactness probe at arbitrary mid-points
            qs = universe[rng.integers(0, len(universe), 256)]
            v, f = _lookup_both(j, t, qs)
            for i, q in enumerate(qs):
                want = oracle.get(float(q))
                assert f[i] == (want is not None), (step, q)
                if want is not None:
                    assert v[i] == want, (step, q)
            for q in qs[:16]:
                assert t.get(q) == j.get(q) == oracle.get(float(q))
            _state_equal(j, t)
    assert t.n_merges >= 1        # the workload actually crossed merges
    qs = np.asarray(list(oracle))
    v, f = _lookup_both(j, t, qs)
    assert f.all()
    assert all(v[i] == oracle[float(q)] for i, q in enumerate(qs))


def test_merge_upserts_overwrite_in_dense_leaves():
    """Merging an overlay upsert of an existing key replaces the payload
    even when that key lives in a dense (DILI-LO) leaf."""
    keys = np.arange(200, dtype=np.float64)
    jp, tp = _policy(max_fill=1.1, max_writes=10**9)
    j = J.OnlineIndex(dili=j_bulk_load(keys, local_optimized=False),
                      overlay_cap=64, policy=jp)
    t = T.OnlineIndex(dili=t_bulk_load(keys, local_optimized=False),
                      overlay_cap=64, policy=tp, device="cpu")
    assert t.store.flat.dense.any()
    for ix in (j, t):
        ix.upsert(5.0, 999)
        ix.flush()
    v, f = _lookup_both(j, t, [5.0, 6.0, 250.0])
    assert f[0] and v[0] == 999 and f[1] and not f[2]


def test_online_index_int64_payloads(rng):
    keys, j, t = _fresh(rng, n=1000, overlay_cap=64)
    big = 2**41 + 5
    k = float(keys[0]) + 0.5
    for ix in (j, t):
        ix.upsert(k, big)
    v, f = _lookup_both(j, t, [k])
    assert f[0] and int(v[0]) == big               # via the overlay
    for ix in (j, t):
        ix.flush()
    v, f = _lookup_both(j, t, [k])
    assert f[0] and int(v[0]) == big               # via the merged snapshot
    assert t.get(k) == big


def test_failed_merge_keeps_frozen_overlay_readable(rng, monkeypatch):
    """A fold that raises leaves the frozen overlay installed: reads stay
    exact (live > frozen > snapshot), `maint.errors` counts the failure,
    and the next merge reclaims the frozen writes — in both packages."""
    from repro.obs import Telemetry as JTel
    from repro_torch.obs import Telemetry as TTel
    import repro.online.merge as jm
    import repro_torch.online.merge as tm
    keys = make_keys("uniform", 2000, rng)
    jp, tp = _policy(max_fill=1.1, max_writes=10**9)
    j = J.OnlineIndex(keys, policy=jp, overlay_cap=64,
                      telemetry=JTel(enabled=True))
    t = T.OnlineIndex(keys, policy=tp, overlay_cap=64,
                      telemetry=TTel(enabled=True), device="cpu")
    new = keys[:20] + 0.5
    for ix in (j, t):
        ix.upsert_batch(new, np.arange(20))
        ix.delete_batch(keys[30:40])

    def boom(dili, ov):
        raise RuntimeError("fold failed")

    for mod, ix in ((jm, j), (tm, t)):
        monkeypatch.setattr(mod, "fold_overlay", boom)
        with pytest.raises(RuntimeError, match="fold failed"):
            ix.flush()
        monkeypatch.undo()
    assert t._merging is not None and t.overlay.count == 0
    q = np.concatenate([new, keys[25:45]])
    _same(j.pending_entries(), t.pending_entries())
    v, f = _lookup_both(j, t, q)
    assert f[:20].all() and not f[25:35].any()
    assert t.get(float(new[0])) == 0 and t.get(float(keys[30])) is None
    for ix in (j, t):
        ix.upsert_batch(new[:5], np.arange(5) + 100)    # newer than frozen
        ix.flush()
    assert t._merging is None and t.n_merges == j.n_merges == 1
    _state_equal(j, t)
    v, f = _lookup_both(j, t, q)
    assert np.array_equal(v[:5], np.arange(5) + 100)
    for ix in (j, t):
        assert ix.tel.metrics.snapshot()["counters"]["maint.errors"] == 1


def test_online_index_at_f32_matches_reference(rng):
    """`OnlineIndex(dtype=float32)`: the store keeps f32 kernel tables with
    int64 payloads (the f32/i64 instance's) and the overlay mirror's keys
    cast to f32, and every lookup and epoch equals the reference's at
    `jnp.float32`, misses on keys that f32 does not hold exactly included,
    across writes and merges."""
    keys = make_keys("logn", 8000, rng)
    jp, tp = _policy(max_fill=0.5, max_writes=700)
    j = J.OnlineIndex(keys, policy=jp, dtype=jnp.float32, overlay_cap=256)
    t = T.OnlineIndex(keys, policy=tp, dtype=torch.float32, overlay_cap=256,
                      device="cpu")
    kt = t.store.kernel_tables
    assert kt["key"].dtype == torch.float32
    assert kt["slot_rec"].dtype == torch.int64
    assert kt["node_rec"].dtype == torch.int32
    _, f = _lookup_both(j, t, keys)
    assert not f.all()
    mids = (keys[:-1] + keys[1:]) / 2
    for b in range(4):
        new = mids[b * 400: (b + 1) * 400]
        for ix in (j, t):
            ix.upsert_batch(new, np.arange(400) + 2 ** 35)
            ix.delete_batch(keys[b * 90: b * 90 + 30])
        assert t._overlay_arrays()["keys"].dtype == torch.float32
        _lookup_both(j, t, np.concatenate([keys, new]))
        _state_equal(j, t)
    assert t.n_merges >= 1
    for ix in (j, t):
        ix.flush()
    _state_equal(j, t)
    _lookup_both(j, t, np.concatenate([keys, mids]))
    assert t.store.stats.bytes_uploaded == j.store.stats.bytes_uploaded
