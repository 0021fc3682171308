"""The port's sharded engine (`repro_torch.core.distributed` and the
facade's "sharded" engine) against the JAX package's on an 8-device mesh.

The reference side runs once, in a module-scoped subprocess with 8 forced
host devices (the test process must keep seeing one JAX device, as
tests/test_distributed.py does), and writes its answers to an `.npz`.  The
port runs in the test process on the CPU with `n_shards=8` and must give
the same arrays bit for bit: values, found flags, the +inf pad lanes and
the edge lanes (+-inf, NaN, keys off both ends), the a2a overflow counts,
range keys, vals and counts, the facade's `stats()` (per-shard pending
counts that sum to the totals) and its `epoch`, at f64 and at f32.  A
durable 8-shard index writes byte-identical per-shard WAL segments in
both packages, and each package recovers the other's directory (the
reference in this one-device process elastically onto one shard).

The scenarios are the reference's `test_sharded_index_gather_and_a2a`,
`test_sharded_online_updates`, `test_sharded_range_query` and
`tests/test_api_engines.py::test_sharded_engine_multi_device_equivalence`,
at <= 30k keys.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.workloads.generator import PRESETS, generate_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS = 8


# -- seeded inputs (shared by both sides) -------------------------------------

def _edge_lanes(keys, boundaries):
    return np.concatenate([[-np.inf, np.inf, np.nan, keys[0] - 1.0,
                            keys[-1] + 1.0, 0.0], boundaries[1:-1],
                           np.nextafter(boundaries[1:-1], -np.inf)])


def _pad8(q):
    pad = (-len(q)) % N_SHARDS
    return np.concatenate([q, np.full(pad, np.inf)])


def _inputs():
    """Keys and queries of every scenario, from numpy seeds."""
    d = {}
    rng = np.random.default_rng(1)
    d["lookup_keys"] = keys = np.unique(rng.lognormal(0, 1, 24000))
    qi = rng.integers(0, len(keys), 4096)
    mids = ((keys[:-1] + keys[1:]) / 2)[rng.integers(0, len(keys) - 1, 512)]
    d["lookup_hits"] = qi
    d["lookup_q"] = np.concatenate([keys[qi], mids])
    lo_shard = keys[: len(keys) // N_SHARDS]            # all in shard 0
    d["skew_q"] = lo_shard[rng.integers(0, len(lo_shard), 1024)]

    rng = np.random.default_rng(2)
    d["online_keys"] = keys = np.unique(rng.lognormal(0, 1, 20000))
    qi = rng.integers(0, len(keys), 4096)
    d["online_q"] = keys[qi]
    new = np.setdiff1d(np.unique(rng.lognormal(0, 1, 3000)), keys)[:2048]
    d["online_new"] = new
    d["online_dels"] = np.unique(keys[qi[:512]])

    rng = np.random.default_rng(7)
    d["range_keys"] = keys = np.unique(rng.lognormal(0, 1, 30000))
    starts = rng.integers(0, len(keys) - 200, 512)
    widths = rng.integers(0, 180, 512)
    d["range_starts"], d["range_widths"] = starts, widths
    d["range_pick"] = rng.integers(0, N_SHARDS - 1, 64)

    rng = np.random.default_rng(5)
    d["facade_keys"] = keys = np.unique(
        rng.integers(0, 1 << 22, 20000)).astype(np.float64)
    d["facade_q"] = np.concatenate([keys[rng.integers(0, len(keys), 4000)],
                                    keys[:100] + 0.5])
    d["facade_lo"] = keys[rng.integers(0, len(keys) - 200, 256)]
    lo_shard = keys[keys < np.quantile(keys, 1.0 / 8)]
    d["facade_skew"] = lo_shard[rng.integers(0, len(lo_shard), 1024)]

    rng = np.random.default_rng(44)
    d["f32_keys"] = keys = np.unique(rng.lognormal(0, 1, 20000))
    d["f32_mids"] = (keys[:-1] + keys[1:]) / 2
    return d


def _range_windows(d, boundaries):
    keys = d["range_keys"]
    starts = d["range_starts"].copy()
    b_idx = np.searchsorted(keys, boundaries[1:-1])
    starts[:64] = np.clip(b_idx[d["range_pick"]] - 20, 0,
                          len(keys) - 200)             # straddle boundaries
    lo = keys[starts]
    hi = keys[np.minimum(starts + d["range_widths"], len(keys) - 1)]
    return lo, hi


# -- the facade scenario: the same calls on either package --------------------

def _facade_run(api, build_kw, d, out, prefix="", dtype=None):
    """The reference's multi-device equivalence scenario on `api`
    (`repro.api` or `repro_torch.api`); every answer goes into `out`."""
    keys = d["facade_keys"]
    cfg = api.IndexConfig(merge=api.manual_merge_policy(), engine="sharded",
                          n_shards=N_SHARDS)
    b = api.LearnedIndex.build(keys, config=cfg, **build_kw)
    q = d["facade_q"]
    out[prefix + "stats0"] = json.dumps(b.stats(), sort_keys=True)
    b.upsert(keys[:50] + 0.25, np.arange(50))
    b.delete(keys[100:150])
    out[prefix + "stats1"] = json.dumps(b.stats(), sort_keys=True)
    out[prefix + "v1"], out[prefix + "f1"] = b.lookup(q)
    lo = d["facade_lo"]
    for i, x in enumerate(b.range(lo, lo + 5000, max_hits=32)):
        out[f"{prefix}r1_{i}"] = x
    out[prefix + "items1_k"], out[prefix + "items1_v"] = b.items()
    b.flush()
    out[prefix + "stats2"] = json.dumps(b.stats(), sort_keys=True)
    out[prefix + "epoch2"] = np.int64(b.epoch)
    out[prefix + "v2"], out[prefix + "f2"] = b.lookup(q)
    for i, x in enumerate(b.range(lo, lo + 5000, max_hits=32)):
        out[f"{prefix}r2_{i}"] = x
    out[prefix + "items2_k"], out[prefix + "items2_v"] = b.items()
    c = api.LearnedIndex.build(keys, config=cfg, lookup_strategy="a2a",
                               **build_kw)
    out[prefix + "skew_v"], out[prefix + "skew_f"] = c.lookup(
        d["facade_skew"])
    out[prefix + "a2a_v"], out[prefix + "a2a_f"] = c.lookup(q)

    # the local engine at f32's scenario on the sharded engine
    fk, mids = d["f32_keys"], d["f32_mids"]
    vals = np.arange(len(fk), dtype=np.int64) + 2 ** 33
    e = api.LearnedIndex.build(fk, vals, config=api.IndexConfig(
        engine="sharded", n_shards=N_SHARDS, dtype=dtype), **build_kw)
    out[prefix + "f32_v0"], out[prefix + "f32_f0"] = e.lookup(fk)
    for r in range(3):
        e.upsert(mids[r * 1500: (r + 1) * 1500], np.arange(1500) + 2 ** 40)
        e.delete(fk[r * 300: r * 300 + 100])
    probe = np.concatenate([fk, mids[:5000]])
    out[prefix + "f32_v1"], out[prefix + "f32_f1"] = e.lookup(probe)
    for i, x in enumerate(e.range(fk[:500], fk[200:700], max_hits=32)):
        out[f"{prefix}f32_r_{i}"] = x
    e.flush()
    out[prefix + "f32_v2"], out[prefix + "f32_f2"] = e.lookup(probe)
    out[prefix + "f32_stats"] = json.dumps(e.stats(), sort_keys=True)


# -- the reference side (runs in the subprocess) ------------------------------

def reference_outputs(in_path: str, out_path: str) -> None:
    """Every scenario on the JAX package's 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from repro import api
    from repro.core import distributed as JD

    d = dict(np.load(in_path))
    mesh = jax.make_mesh((N_SHARDS,), ("data",))
    out = {}

    keys = d["lookup_keys"]
    sd = JD.build_sharded(keys, None, n_shards=N_SHARDS, sample_stride=4)
    q = _pad8(np.concatenate([d["lookup_q"],
                              _edge_lanes(keys, sd.boundaries)]))
    skew = d["skew_q"]
    for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        arrs = JD.to_mesh(sd, mesh, dtype=dt)
        v, f = JD.sharded_lookup(mesh, arrs, jnp.asarray(q, dt),
                                 sd.max_depth, strategy="gather")
        out[f"g_{name}_v"], out[f"g_{name}_f"] = v, f
        for tag, qq in (("a", q), ("skew", skew)):
            v, f, ovf = JD.sharded_lookup(mesh, arrs, jnp.asarray(qq, dt),
                                          sd.max_depth, strategy="a2a")
            out[f"{tag}_{name}_v"], out[f"{tag}_{name}_f"] = v, f
            out[f"{tag}_{name}_ovf"] = ovf

    keys = d["online_keys"]
    sd = JD.build_sharded(keys, None, n_shards=N_SHARDS, sample_stride=4)
    arrs = JD.to_mesh(sd, mesh)
    new, dels = d["online_new"], d["online_dels"]
    JD.sharded_upsert(sd, new, 5_000_000 + np.arange(len(new)))
    JD.sharded_delete(sd, dels)
    qs = dict(q=jnp.asarray(d["online_q"]), new=jnp.asarray(new[:1024]))
    for st in ("gather", "a2a"):
        for tag, qq in qs.items():
            res = JD.sharded_lookup_with_overlay(mesh, arrs, sd, qq,
                                                 sd.max_depth, strategy=st)
            for i, x in enumerate(res):
                out[f"ov_{st}_{tag}_{i}"] = x
    out["merged"] = np.asarray(JD.sharded_merge(sd))
    out["merge_epoch"] = np.int64(sd.epoch)
    arrs = JD.to_mesh(sd, mesh)
    for tag, qq in qs.items():
        res = JD.sharded_lookup_with_overlay(mesh, arrs, sd, qq,
                                             sd.max_depth)
        for i, x in enumerate(res):
            out[f"post_{tag}_{i}"] = x

    keys = d["range_keys"]
    sd = JD.build_sharded(keys, None, n_shards=N_SHARDS, sample_stride=4)
    arrs = JD.to_mesh(sd, mesh)
    lo, hi = _range_windows(d, sd.boundaries)
    for mh in (128, 16):
        res = JD.sharded_range_query(mesh, arrs, jnp.asarray(lo),
                                     jnp.asarray(hi), max_hits=mh)
        for i, x in enumerate(res):
            out[f"range{mh}_{i}"] = x

    _facade_run(api, {}, d, out, dtype=jnp.float32)
    out["dur_k"], out["dur_v"] = _durable_run(
        api, {}, os.path.join(os.path.dirname(in_path), "j", "dur"))
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


def _durable_run(api, build_kw, dur_dir):
    """The durability stream of tests/test_torch_durability.py on an
    8-shard durable index, a tail of writes, then a crash (`abandon`);
    returns the index's content at the crash."""
    from tests.test_torch_durability import _drive, _stream_keys
    keys = _stream_keys()
    spec = PRESETS["dili_paper"].scaled(n_ops=4800, batch_size=96, seed=3)
    cfg = api.IndexConfig(
        engine="sharded", n_shards=N_SHARDS, overlay_cap=128,
        merge=api.manual_merge_policy(),
        durability=api.DurabilityConfig(dir=dur_dir, fsync="always"))
    ix = api.LearnedIndex.build(keys, config=cfg, **build_kw)
    _drive(ix, generate_stream(spec, keys))
    tail = np.arange(1, 41, 2, dtype=np.float64) + 9000
    ix.upsert(tail, np.arange(len(tail), dtype=np.int64))
    ix.delete(keys[:16])
    items = ix.items()
    ix.abandon()
    return items


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_ENABLE_X64="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    code = ("from tests.test_torch_distributed import reference_outputs; "
            f"reference_outputs({str(tmp / 'in.npz')!r}, "
            f"{str(tmp / 'out.npz')!r})")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=900, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(tmp / "out.npz") as z:
        return d, dict(z), tmp


def _eq(ref_val, got, what):
    a, b = np.asarray(ref_val), np.asarray(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# -- the port side ------------------------------------------------------------

def test_sharded_index_gather_and_a2a(ref):
    from repro_torch.core import distributed as TD
    d, r = ref[:2]
    keys = d["lookup_keys"]
    sd = TD.build_sharded(keys, None, n_shards=N_SHARDS, sample_stride=4)
    q = _pad8(np.concatenate([d["lookup_q"],
                              _edge_lanes(keys, sd.boundaries)]))
    for name, dt, ndt in (("f64", torch.float64, np.float64),
                          ("f32", torch.float32, np.float32)):
        arrs = TD.to_device(sd, "cpu", dtype=dt)
        v, f = TD.sharded_lookup(arrs, torch.from_numpy(q.astype(ndt)),
                                 strategy="gather")
        _eq(r[f"g_{name}_v"], v.numpy(), f"gather {name} v")
        _eq(r[f"g_{name}_f"], f.numpy(), f"gather {name} f")
        for tag, qq in (("a", q), ("skew", d["skew_q"])):
            v, f, ovf = TD.sharded_lookup(
                arrs, torch.from_numpy(qq.astype(ndt)), strategy="a2a")
            _eq(r[f"{tag}_{name}_v"], v.numpy(), f"a2a {tag} {name} v")
            _eq(r[f"{tag}_{name}_f"], f.numpy(), f"a2a {tag} {name} f")
            _eq(r[f"{tag}_{name}_ovf"], ovf.numpy(), f"a2a {tag} ovf")
    # the reference test's own assertions, on the port's answers
    hits = d["lookup_hits"]
    nh = len(hits)
    assert r["g_f64_f"][:nh].all()
    assert np.array_equal(r["g_f64_v"][:nh], hits)
    ok = r["a_f64_f"][:nh]
    assert np.array_equal(r["a_f64_v"][:nh][ok], hits[ok]) and ok.mean() > 0.99
    assert r["skew_f64_ovf"].sum() > 0              # the skewed batch spills


def test_sharded_online_updates(ref):
    from repro_torch.core import distributed as TD
    d, r = ref[:2]
    keys = d["online_keys"]
    sd = TD.build_sharded(keys, None, n_shards=N_SHARDS, sample_stride=4)
    arrs = TD.to_device(sd, "cpu")
    new, dels = d["online_new"], d["online_dels"]
    TD.sharded_upsert(sd, new, 5_000_000 + np.arange(len(new)))
    TD.sharded_delete(sd, dels)
    qs = dict(q=torch.from_numpy(d["online_q"]),
              new=torch.from_numpy(new[:1024]))
    for st in ("gather", "a2a"):
        for tag, qq in qs.items():
            res = TD.sharded_lookup_with_overlay(arrs, sd, qq, strategy=st)
            for i, x in enumerate(res):
                _eq(r[f"ov_{st}_{tag}_{i}"], x.numpy(), f"{st} {tag} {i}")
    merged = TD.sharded_merge(sd)
    _eq(r["merged"], np.asarray(merged), "merged shards")
    assert sd.epoch == int(r["merge_epoch"]) == 1
    assert all(ov.count == 0 for ov in sd.overlays)
    arrs = TD.to_device(sd, "cpu", prev=arrs, shards=merged)
    for tag, qq in qs.items():
        res = TD.sharded_lookup_with_overlay(arrs, sd, qq)
        for i, x in enumerate(res):
            _eq(r[f"post_{tag}_{i}"], x.numpy(), f"post-merge {tag} {i}")
    # the re-pack of the merged shards equals a whole upload
    whole = TD.to_device(sd, "cpu")
    for a, b in zip(arrs["kernel"], whole["kernel"]):
        for k in ("node_rec", "slot_rec", "key"):
            assert torch.equal(a[k], b[k])
    deleted = np.isin(d["online_q"], dels)
    f = r["post_q_1"]
    assert not f[deleted].any() and f[~deleted].all()


def test_sharded_range_query(ref):
    from repro_torch.core import distributed as TD
    d, r = ref[:2]
    keys = d["range_keys"]
    sd = TD.build_sharded(keys, None, n_shards=N_SHARDS, sample_stride=4)
    arrs = TD.to_device(sd, "cpu")
    lo, hi = _range_windows(d, sd.boundaries)
    for mh in (128, 16):
        res = TD.sharded_range_query(arrs, torch.from_numpy(lo),
                                     torch.from_numpy(hi), max_hits=mh)
        for i, x in enumerate(res):
            _eq(r[f"range{mh}_{i}"], x.numpy(), f"range {mh} {i}")
    ks, vs, cnt = (r[f"range128_{i}"] for i in range(3))
    for i in range(0, 512, 7):
        m = (keys >= lo[i]) & (keys < hi[i])
        assert cnt[i] == min(m.sum(), 128)
        assert np.array_equal(ks[i][: cnt[i]], keys[m][:128])
        assert np.array_equal(vs[i][: cnt[i]], np.nonzero(m)[0][:128])
        assert np.all(ks[i][cnt[i]:] == np.inf)


@pytest.fixture(scope="module")
def port_facade(ref):
    from repro_torch import api
    out = {}
    _facade_run(api, {"device": "cpu"}, ref[0], out, dtype=torch.float32)
    return out


@pytest.mark.parametrize("part", ["f64", "f32"])
def test_sharded_engine_multi_device_equivalence(ref, port_facade, part):
    """The facade on 8 shards answers exactly as the reference's on an
    8-device mesh; at f32 the shards search through the f32/i64 instance
    with one FMA a prediction, as the reference's XLA does there."""
    d, r = ref[:2]
    out = port_facade
    names = [k for k in out if k.startswith("f32_") == (part == "f32")]
    assert names
    for k in names:
        if k.startswith("stats") or k == "f32_stats":
            sr, sp = json.loads(str(r[k])), json.loads(out[k])
            assert sr == sp, k
            continue
        _eq(r[k], out[k], k)
    if part == "f64":
        s1 = json.loads(out["stats1"])
        assert s1["n_shards"] == N_SHARDS
        assert s1["pending_writes"] == sum(s1["per_shard_pending"]) == 100
        assert len(s1["per_shard_pending"]) == N_SHARDS
        assert int(out["epoch2"]) == 2 and int(r["epoch2"]) == 2
        assert out["skew_f"].all()          # the a2a overflow fell back
    else:
        assert 0.85 < out["f32_f0"].mean() < 0.99   # misses, as the ref
        # two roundings a prediction would not be the reference's answer:
        # its XLA fuses `a + b*q` into one FMA inside `shard_map` as well
        assert not np.array_equal(_unfused_found(d["f32_keys"]),
                                  r["f32_f0"])


def _unfused_found(keys):
    """found flags of the 8-shard f32 lookup of `keys` with mul-then-add
    predictions (the plain search over each shard's f32 columns)."""
    from repro_torch.core import distributed as TD
    from repro_torch.core import search as TS
    sd = TD.build_sharded(keys, None, n_shards=N_SHARDS)
    q = torch.from_numpy(keys.astype(np.float32))
    bnd = torch.from_numpy(sd.boundaries.astype(np.float32))
    found = torch.zeros(len(keys), dtype=torch.bool)
    for r, fl in enumerate(sd.flats):
        idx = {k: torch.from_numpy(np.asarray(getattr(fl, k)))
               for k in ("base", "fo", "dense", "tag", "val")}
        idx.update({k: torch.from_numpy(getattr(fl, k).astype(np.float32))
                    for k in ("a", "b", "key")},
                   root=torch.tensor(fl.root, dtype=torch.int32))
        _, f = TS.search_batch(idx, q, max_depth=sd.max_depth)
        found |= f & (q >= bnd[r]) & (q < bnd[r + 1])
    return found.numpy()


def test_sharded_wal_segments_and_recovery_across_packages(ref, tmp_path):
    """Per-shard WAL segments byte-identical across packages, equal
    manifests and checkpoint arrays; the reference's 8-shard directory
    recovers in the port on 8 shards and on one, and the port's in the
    reference, whose one JAX device takes it onto one shard."""
    import shutil
    from repro import api as JA
    from repro_torch import api as TA
    from tests.test_torch_durability import _files, _manifest
    d, r = ref[:2]
    work = ref[2]
    dj, dt = str(work / "j" / "dur"), str(work / "t" / "dur")
    kt, vt = _durable_run(TA, {"device": "cpu"}, dt)
    _eq(r["dur_k"], kt, "content keys")
    _eq(r["dur_v"], vt, "content vals")
    assert _files(dt) == _files(dj)
    shards = {rel.split(os.sep)[1] for rel in _files(dt)
              if rel.endswith(".wal")}
    assert len(shards) == N_SHARDS
    for rel in _files(dt):
        pj, pt = os.path.join(dj, rel), os.path.join(dt, rel)
        if rel.endswith("manifest.json"):
            assert _manifest(pt) == _manifest(pj), rel
        elif rel.endswith("state.npz"):
            with np.load(pt) as zt, np.load(pj) as zj:
                for k in ("keys", "vals"):
                    np.testing.assert_array_equal(zt[k], zj[k])
        else:
            assert open(pt, "rb").read() == open(pj, "rb").read(), rel
    for src in ("j", "t"):
        for reader in ("j8", "j1", "t8", "t1"):
            shutil.copytree(work / src / "dur",
                            tmp_path / f"{src}_{reader}")
    for src in ("j", "t"):
        for reader, n in (("t8", N_SHARDS), ("t1", 1)):
            cfg = None if n == N_SHARDS else TA.IndexConfig(
                engine="sharded", merge=TA.manual_merge_policy(),
                overlay_cap=128)
            rx = TA.LearnedIndex.recover(str(tmp_path / f"{src}_{reader}"),
                                         config=cfg, device="cpu")
            try:
                assert rx.stats()["n_shards"] == n
                _eq(r["dur_k"], rx.items()[0], f"{src} by {reader}")
                _eq(r["dur_v"], rx.items()[1], f"{src} by {reader}")
            finally:
                rx.close()
        jx = JA.LearnedIndex.recover(str(tmp_path / f"{src}_j1"))
        try:
            assert jx.stats()["n_shards"] == 1
            _eq(r["dur_k"], jx.items()[0], f"{src} by the reference")
        finally:
            jx.close()


def test_sharded_counters_lose_no_update_under_reader_threads():
    """Lookups from several threads at once (reads are lock-free): the
    engine's counters add up exactly."""
    import threading
    from repro_torch import api
    keys = np.arange(0, 4000, 2, dtype=np.float64)
    ix = api.LearnedIndex.build(keys, engine="sharded", n_shards=4,
                                pad=False, device="cpu")
    q = keys[::7]
    want_v, want_f = ix.lookup(q)
    errors = []

    def reader():
        try:
            for _ in range(20):
                v, f = ix.lookup(q)
                assert np.array_equal(v, want_v) and np.array_equal(f,
                                                                    want_f)
        except BaseException as e:               # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not errors, errors[:2]
    st = ix.kernel_stats
    n = 1 + 4 * 20
    assert st["lookups"] == n and st["launches"] == 4 * n
    # the +inf lanes that pad the batch to a shard multiple own no shard
    assert st["lanes"] == n * len(q)


def test_sharded_reads_during_a_merge_see_the_folded_writes():
    """A lock-free read that lands while a merge folds shard after shard
    (here: from inside each shard's flatten, after the earlier shards'
    overlays were emptied and before the republish) answers from the
    pre-merge tables with the pre-merge overlays, so every pending write
    stays visible, and the read after the republish sees the same."""
    from repro_torch import api
    keys = np.arange(0, 4000, 2, dtype=np.float64)
    ix = api.LearnedIndex.build(keys, engine="sharded", n_shards=4,
                                pad=False, device="cpu")
    eng = ix._engine
    up = np.arange(1, 4000, 50, dtype=np.float64)      # new keys, all shards
    dead = keys[::97]
    ix.upsert(up, np.arange(len(up)) + 10_000)
    ix.delete(dead)
    want_v, want_f = ix.lookup(np.concatenate([up, dead, keys[1::97]]))
    seen = []
    flatten_shard = eng._flatten_shard

    def flatten_and_read(r, dili):
        flat = flatten_shard(r, dili)
        seen.append(ix.lookup(np.concatenate([up, dead, keys[1::97]])))
        return flat

    eng._flatten_shard = flatten_and_read
    before = eng.epoch
    ix.flush()
    assert eng.epoch == before + 1 and len(seen) == 4
    seen.append(ix.lookup(np.concatenate([up, dead, keys[1::97]])))
    for v, f in seen:
        assert np.array_equal(f, want_f) and np.array_equal(v, want_v)
    assert want_f[: len(up)].all() and not want_f[len(up): len(up)
                                                  + len(dead)].any()
