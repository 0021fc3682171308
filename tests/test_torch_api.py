"""The port's facade on the `local` and `pallas` engines against the JAX
package's.

One call sequence runs on `repro.api.LearnedIndex(engine=...)` and on
`repro_torch.api.LearnedIndex(engine=..., device="cpu")`; every answer
must be equal at every step (bit-exact: int64 payloads, bools, and keys
copied unchanged).  The facade tests run on both ported engines; the
f32-domain ones (key collisions, int32 payloads, `kernel_eligible`) are
the `pallas` engine's own.
"""
import json
import warnings

import numpy as np
import pytest

from repro import api as J
from repro_torch import api as T
from tests.conftest import make_keys


ENGINES = ("pallas", "local")


def _cfg(pkg, merge=None, engine="pallas", **kw):
    """`merge`: None (default policy), "manual", or MergePolicy kwargs."""
    if merge == "manual":
        kw["merge"] = pkg.manual_merge_policy()
    elif merge is not None:
        kw["merge"] = pkg.MergePolicy(**merge)
    return pkg.IndexConfig(engine=engine, **kw)


def _build(keys, vals=None, **kw):
    j = J.LearnedIndex.build(keys, vals, config=_cfg(J, **kw))
    t = T.LearnedIndex.build(keys, vals, config=_cfg(T, **kw), device="cpu")
    return j, t


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _both(j, t, method, *args, **kw):
    """Call `method` on both facades, require equal answers, return one."""
    out = getattr(t, method)(*args, **kw)
    _same(getattr(j, method)(*args, **kw), out)
    return out


def _stats_equal(j, t):
    sj, st = j.stats(), t.stats()
    assert set(sj) == set(st)
    for k in sj:
        if k != "kernel_eligible":
            assert sj[k] == st[k], k


def _key_tree(d, prefix=""):
    out = []
    for k in sorted(d):
        out.append(prefix + k)
        if isinstance(d[k], dict) and k != "jit_cache_entries":
            out += _key_tree(d[k], prefix + k + ".")
    return out


@pytest.fixture(scope="module", params=ENGINES)
def pair(request):
    rng = np.random.default_rng(41)
    keys = make_keys("logn", 6000, rng)
    keys = np.unique(keys.astype(np.float32)).astype(np.float64)
    vals = rng.integers(0, 1 << 30, len(keys)).astype(np.int64)
    j, t = _build(keys, vals, merge="manual", overlay_cap=256,
                  telemetry=True, engine=request.param)
    assert j.engine == t.engine == request.param
    return keys, vals, j, t


def _lookup_queries(keys, rng, n=1500):
    mids = ((keys[:-1] + keys[1:]) / 2)[rng.integers(0, len(keys) - 1, 300)]
    return np.concatenate([keys[rng.integers(0, len(keys), n)], mids,
                           [keys[0] - 1.0, keys[-1] * 3, 0.0]])


def test_lookup_hits_misses_ragged(pair):
    keys, vals, j, t = pair
    rng = np.random.default_rng(42)
    for q in (_lookup_queries(keys, rng), keys[5:6]):
        _both(j, t, "lookup", q)
    v, f = _both(j, t, "lookup", keys[:777])
    assert f.all() and np.array_equal(v, vals[:777])


def test_write_lifecycle(pair):
    keys, vals, j, t = pair
    rng = np.random.default_rng(43)
    up = keys[rng.integers(0, len(keys), 100)]
    new = np.unique(((keys[:-1] + keys[1:]) / 2)[
        rng.integers(0, len(keys) - 1, 100)].astype(np.float32)).astype(
            np.float64)
    new = np.setdiff1d(new, keys)
    dead = keys[rng.integers(0, len(keys), 150)]
    for ix in (j, t):
        ix.upsert(np.concatenate([up, new]),
                  np.arange(len(up) + len(new)) + 7_000_000)
        ix.delete(dead)
    probe = np.concatenate([up, new, dead, _lookup_queries(keys, rng, 400)])
    _both(j, t, "lookup", probe)
    v, f = _both(j, t, "lookup", new)
    assert f.all() and (v >= 7_000_000).all()              # visible now
    deleted = np.setdiff1d(dead, np.concatenate([up, new]))
    assert not _both(j, t, "lookup", deleted)[1].any()
    # ranges with pending tombstones and upserts
    starts = rng.integers(0, len(keys) - 300, 200)
    lo = keys[starts]
    hi = keys[starts + rng.integers(1, 280, 200)]
    for mh in (8, 128):
        _same(j.range(lo, hi, max_hits=mh), t.range(lo, hi, max_hits=mh))
    for k in (up[0], new[0], deleted[0], keys[1], keys[0] - 3.0):
        assert j.get(k) == t.get(k)
    _same(j.items(), t.items())
    _stats_equal(j, t)
    # fold + republish
    sj, st = j.flush(), t.flush()
    assert sj["epoch"] == st["epoch"] == 2
    _stats_equal(j, t)
    _both(j, t, "lookup", probe)
    assert not _both(j, t, "lookup", deleted)[1].any()
    _same(j.range(lo, hi, max_hits=64), t.range(lo, hi, max_hits=64))
    _same(j.items(), t.items())
    for k in (up[0], new[0], deleted[0], keys[1]):
        assert j.get(k) == t.get(k)


def test_metrics_key_tree(pair):
    keys, vals, j, t = pair
    j.lookup(keys[:10])
    t.lookup(keys[:10])
    mj, mt = j.metrics(), t.metrics()
    json.dumps(mt)
    assert _key_tree(mj) == _key_tree(mt)
    assert mj["ops_total"] == mt["ops_total"]
    for op in ("lookup", "range", "upsert", "delete", "flush"):
        assert mj["ops"][op]["count"] == mt["ops"][op]["count"], op
    assert mt["retrace"]["traces_since_build"] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_automatic_merge_triggers(engine):
    """max_writes and max_fill fire at the same writes on both packages."""
    rng = np.random.default_rng(44)
    keys = np.unique(make_keys("fb", 4000, rng).astype(np.float32)).astype(
        np.float64)
    j, t = _build(keys, merge=dict(max_writes=300, max_fill=0.75,
                                   pressure_check_every=64),
                  overlay_cap=128, engine=engine)
    epochs = []
    for step in range(12):
        batch = keys[rng.integers(0, len(keys), 50)]
        new = batch + np.float32(0.5)
        for ix in (j, t):
            ix.upsert(new, np.arange(50) + 100 * step)
            ix.delete(batch[:10])
        assert j.epoch == t.epoch
        epochs.append(t.epoch)
        _stats_equal(j, t)
    assert epochs[-1] > 1                   # merges fired on their own
    q = np.concatenate([keys[:500], keys[:500] + np.float32(0.5)])
    _same(j.lookup(q), t.lookup(q))
    _same(j.items(), t.items())
    assert [r["incremental"] for r in j.maint_timings()] == [
        r["incremental"] for r in t.maint_timings()]


def test_f32_collision_warning():
    keys = 2.0 ** 25 + np.arange(64, dtype=np.float64)   # collapse 4:1
    with pytest.warns(UserWarning, match="16777216"):
        j = J.LearnedIndex.build(keys, config=_cfg(J))
    with pytest.warns(UserWarning, match="16777216"):
        t = T.LearnedIndex.build(keys, config=_cfg(T), device="cpu")
    n = t.metrics()["counters"]["warn.pallas_f32_collision"]
    assert n == j.metrics()["counters"]["warn.pallas_f32_collision"] > 0
    _same(j.lookup(keys), t.lookup(keys))
    _same(j.items(), t.items())


def test_rejects_keys_and_payloads_outside_the_kernel_domain():
    U = np.arange(0, 4000, 2, dtype=np.float64)
    j, t = _build(U, merge="manual")
    bad = np.array([2.0 ** 25 + 1])            # f32 spacing here is 4
    for ix in (j, t):
        with pytest.raises(ValueError, match="16777216"):
            ix.upsert(bad, np.array([7]))
        with pytest.raises(ValueError, match="f32"):
            ix.delete(bad)
        with pytest.raises(ValueError, match="int32"):
            ix.upsert(np.array([3.0]), np.array([2 ** 31]))
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="int32"):
            pkg.LearnedIndex.build(U, np.full(len(U), 2 ** 40),
                                   config=_cfg(pkg), **kw)
    for ix in (j, t):
        ix.upsert(np.array([3.0, 2.0 ** 24 - 2.0]), np.array([1, 2]))
        ix.upsert(np.array([5.25]), np.array([3]))     # fractional: tolerated
    for k in (3.0, 2.0 ** 24 - 2.0, 5.25, 4.0, 7.0):
        assert j.get(k) == t.get(k)


@pytest.mark.parametrize("engine", ENGINES)
def test_config_json_round_trips_across_packages(engine):
    cfg = J.IndexConfig(engine=engine, overlay_cap=512, max_hits=32,
                        merge=J.MergePolicy(max_writes=99))
    d = cfg.to_json_dict()
    tcfg = T.IndexConfig.from_json_dict(json.loads(json.dumps(d)))
    assert tcfg.to_json_dict() == d
    assert J.IndexConfig.from_json_dict(tcfg.to_json_dict()) == cfg


def test_unported_paths_raise():
    """What is still to come raises NotImplementedError naming ROADMAP:
    the sharded engine, durability, save/load and recover.  Background
    maintenance on the pallas engine is a config error in both
    packages."""
    keys = np.arange(100, dtype=np.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.LearnedIndex.build(keys, engine="sharded", device="cpu")
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="background"):
            pkg.LearnedIndex.build(keys, config=_cfg(
                pkg, maintenance=pkg.MaintenanceConfig(background=True)),
                **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.LearnedIndex.build(keys, config=_cfg(
            T, durability=T.DurabilityConfig(dir="unused")), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.LearnedIndex.recover("unused")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.LearnedIndex.load("x.npz")
    for engine in ENGINES:
        t = T.LearnedIndex.build(keys, config=_cfg(T, engine=engine),
                                 device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t.save("x.npz")
    # what this list held before and runs now: the local engine at f32,
    # maintenance on both engines, inspect() and the trace export
    t = T.LearnedIndex.build(keys, dtype=np.float32, device="cpu")
    assert t.lookup(keys)[1].all()
    for engine in ENGINES:
        t = T.LearnedIndex.build(keys, config=_cfg(
            T, maintenance=T.MaintenanceConfig(), engine=engine,
            telemetry=True), device="cpu")
        assert t.inspect()["engine"] == engine
        t.start_trace()
        t.stop_trace()


def test_local_engine_at_f32_equals_reference():
    """`dtype=float32` on the local engine: a tree built in f64 whose
    tables are cast to f32, searched through the f32/i64 kernel instance's
    plain version.  f64 lognormal keys are not exact in f32, so the
    reference misses some of its own keys; the port misses exactly the
    same ones, through writes, an automatic merge, a flush and ranges,
    with >= 2^31 payloads."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(44)
    keys = np.unique(rng.lognormal(0, 1, 20_000))
    vals = np.arange(len(keys), dtype=np.int64) + 2 ** 33
    j = J.LearnedIndex.build(keys, vals, dtype=jnp.float32)
    t = T.LearnedIndex.build(keys, vals, dtype=torch.float32, device="cpu")
    assert j.engine == t.engine == "local"
    v, f = _both(j, t, "lookup", keys)
    assert 0.85 < f.mean() < 0.99                     # misses, as the ref
    # keys a few ulps apart share one f32 value: a hit may be a neighbour's
    assert (v[f] == vals[f]).mean() > 0.99
    mids = (keys[:-1] + keys[1:]) / 2
    for b in range(3):
        for ix in (j, t):
            ix.upsert(mids[b * 1500: (b + 1) * 1500],
                      np.arange(1500) + 2 ** 40)
            ix.delete(keys[b * 300: b * 300 + 100])
        _both(j, t, "lookup", np.concatenate([keys, mids[:5000]]))
    assert t.stats()["merge_reasons"] == j.stats()["merge_reasons"] != {}
    _stats_equal(j, t)
    lo, hi = keys[:500], keys[200:700]
    _both(j, t, "range", lo, hi, max_hits=32)
    j.flush(), t.flush()
    _both(j, t, "lookup", np.concatenate([keys, mids]))
    _both(j, t, "range", lo, hi, max_hits=32)
    _same(j.items(), t.items())
    _stats_equal(j, t)
    assert t.kernel_stats["table_bytes"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_cuda_is_the_default_device(monkeypatch, engine):
    """Without a card, the default device raises instead of dropping to
    the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.LearnedIndex.build(np.arange(10.0), config=_cfg(T, engine=engine))


@pytest.mark.parametrize("helper", ["kernel_arrays", "device_arrays",
                                    "from_flat", "from_numpy_tables",
                                    "overlay_device_arrays"])
def test_table_helpers_default_to_cuda(helper, monkeypatch):
    """The table uploaders put tensors on CUDA unless asked: without a card
    and without `device`, each raises instead of using the CPU."""
    import torch
    from repro_torch.api.snapshot import DeviceSnapshot, from_numpy_tables
    from repro_torch.core.dili import bulk_load
    from repro_torch.core.flat import flatten
    from repro_torch.core.search import device_arrays
    from repro_torch.kernels.ops import kernel_arrays
    from repro_torch.online.overlay import (TombstoneOverlay,
                                            overlay_device_arrays)
    flat = flatten(bulk_load(np.arange(50.0), np.arange(50)))
    call = {
        "kernel_arrays": lambda: kernel_arrays(flat),
        "device_arrays": lambda: device_arrays(flat),
        "from_flat": lambda: DeviceSnapshot.from_flat(flat),
        "from_numpy_tables": lambda: from_numpy_tables({"a": np.zeros(4)}),
        "overlay_device_arrays": lambda: overlay_device_arrays(
            TombstoneOverlay.empty(8)),
    }[helper]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("engine", ENGINES)
def test_context_manager_and_close(engine):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with T.LearnedIndex.build(np.arange(50.0), config=_cfg(
                T, engine=engine), device="cpu") as t:
            assert t.engine == engine
            assert t.lookup([3.0])[1].all()
            assert t.kernel_stats["lookups"] == 1


def test_default_config_builds_the_local_engine():
    """`IndexConfig()` builds the local engine in both packages: f64 keys
    that f32 would merge stay apart, and >= 2^31 payloads round-trip,
    through writes, an automatic merge and a flush."""
    keys = 1.0 + np.arange(3000) * 2.0 ** -30      # 2^-30 apart: f32 merges
    vals = np.arange(3000, dtype=np.int64) + 2 ** 40
    j = J.LearnedIndex.build(keys, vals)
    t = T.LearnedIndex.build(keys, vals, device="cpu")
    assert j.engine == t.engine == "local"
    v, f = _both(j, t, "lookup", keys)
    assert f.all() and np.array_equal(v, vals)
    new = keys[:-1] + 2.0 ** -31
    for ix in (j, t):
        for b in range(0, 2998, 1000):              # default policy merges
            ix.upsert(new[b: b + 1000], np.arange(len(new[b: b + 1000])))
            ix.delete(keys[b: b + 200])
    assert t.stats()["merge_reasons"] == j.stats()["merge_reasons"] != {}
    q = np.concatenate([keys, new])
    _same(j.lookup(q), t.lookup(q))
    _stats_equal(j, t)
    j.flush(), t.flush()
    _same(j.lookup(q), t.lookup(q))
    _same(j.items(), t.items())
    _same(j.range(keys[:100], keys[50:150], max_hits=16),
          t.range(keys[:100], keys[50:150], max_hits=16))
    _stats_equal(j, t)
    assert _key_tree(j.metrics()) == _key_tree(t.metrics())
