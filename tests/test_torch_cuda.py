"""The CUDA kernel, the port's facade and its LLM serve steps on a GPU,
against the plain PyTorch version on the CPU.  Needs an NVIDIA GPU and
nvcc; every test skips without one.  Imports no JAX, so it runs where
only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import IndexConfig, LearnedIndex, manual_merge_policy
from repro_torch.configs import get_config as get_llm_config, list_archs
from repro_torch.core import baselines as TB
from repro_torch.core.dili import bulk_load
from repro_torch.core.flat import flatten
from repro_torch.data.datasets import generate
from repro_torch.kernels import dili_search as T_kernel
from repro_torch.kernels import ops as K
from repro_torch.models import model as MDL
from repro_torch.online.overlay import TombstoneOverlay, overlay_device_arrays
from repro_torch.train import step as STEP

pytestmark = pytest.mark.cuda
# the assigned archs, and granite-8b's reduced config turned ssm and
# hybrid (no config in configs/ has either family)
LLM_ARCHS = list_archs() + ["ssm", "hybrid"]


def _llm_cfg(arch):
    import dataclasses
    cfg = get_llm_config("granite_8b" if arch in ("ssm", "hybrid")
                         else arch).reduced()
    if arch == "ssm":
        return dataclasses.replace(cfg, family="ssm", ssm_state=8)
    if arch == "hybrid":
        return dataclasses.replace(cfg, family="hybrid", ssm_state=8,
                                   ssm_heads=4, shared_attn_every=2,
                                   n_layers=5)
    return cfg


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def logn20k():
    d, keys32 = K.build_f32_index(generate("logn", 20_000, 3))
    return keys32, flatten(d)


def _pair(arrs, q, max_depth=None):
    md = arrs["max_depth"] if max_depth is None else max_depth
    return T_kernel.dili_search(arrs["node_rec"], arrs["slot_rec"],
                                arrs["key"], q, root=arrs["root"],
                                max_depth=md)


def _queries(keys32):
    mids = ((keys32[:-1].astype(np.float64) + keys32[1:]) / 2).astype(
        np.float32)
    return np.concatenate([keys32, mids, keys32[:777],
                           [np.inf, 3e9, -np.inf, 0.0, 1e30, np.nan]]).astype(
                               np.float32)


def test_kernel_matches_plain_version(gpu, logn20k):
    keys32, f = logn20k
    assert f.dense.any()
    q = _queries(keys32)
    cpu = _pair(K.kernel_arrays(f, device="cpu"), torch.from_numpy(q))
    before = T_kernel.kernel.launches
    out = _pair(K.kernel_arrays(f, device=gpu), torch.from_numpy(q).to(gpu))
    torch.cuda.synchronize()
    assert T_kernel.kernel.launches == before + 1
    for g, w in zip(out, cpu):
        assert torch.equal(g.cpu(), w)
    assert bool(cpu[1][:len(keys32)].all())


@pytest.mark.parametrize("max_depth_cut", [1, 2])
def test_kernel_matches_plain_version_short_depth(gpu, logn20k,
                                                  max_depth_cut):
    """Trips short of the snapshot's depth (lanes left standing on a dense
    leaf are probed on exit): equal to the plain version."""
    keys32, f = logn20k
    q = _queries(keys32)
    md = int(f.max_depth) - max_depth_cut
    cpu = _pair(K.kernel_arrays(f, device="cpu"), torch.from_numpy(q),
                max_depth=md)
    out = _pair(K.kernel_arrays(f, device=gpu), torch.from_numpy(q).to(gpu),
                max_depth=md)
    for g, w in zip(out, cpu):
        assert torch.equal(g.cpu(), w)


def test_kernel_rejects_mixed_devices(gpu, logn20k):
    keys32, f = logn20k
    arrs = K.kernel_arrays(f, device=gpu)
    with pytest.raises(ValueError):
        _pair(arrs, torch.from_numpy(keys32[:64]))       # queries on the CPU


def test_facade_on_gpu_matches_cpu(gpu):
    rng = np.random.default_rng(7)
    keys = np.unique(generate("fb", 20_000, 7).astype(np.float32)).astype(
        np.float64)
    cfg = IndexConfig(engine="pallas", merge=manual_merge_policy())
    ixs = [LearnedIndex.build(keys, config=cfg, device=d)
           for d in ("cpu", "cuda")]
    q = np.concatenate([keys[rng.integers(0, len(keys), 5000)],
                        (keys[:-1] + keys[1:])[:3000] / 2])
    lo, hi = keys[:500], keys[50:550]
    for ix in ixs:
        ix.upsert(keys[:100] + 0.5, np.arange(100))
        ix.delete(keys[200:300])
    for step in ("pending", "flushed"):
        (v0, f0), (v1, f1) = (ix.lookup(q) for ix in ixs)
        assert np.array_equal(f0, f1) and np.array_equal(v0, v1), step
        r0, r1 = (ix.range(lo, hi, max_hits=64) for ix in ixs)
        for a, b in zip(r0, r1):
            assert np.array_equal(a, b), step
        for ix in ixs:
            ix.flush()
    assert ixs[1].stats()["kernel_eligible"]
    assert ixs[1].kernel_stats["lookups"] == 2


# -- the f64/i64 instance with the overlay resolve (the local engine) -------


@pytest.fixture(scope="module", params=["logn", "dili_lo"])
def f64_case(request):
    """A 20k-key f64 build (standard, or DILI-LO where every leaf is
    dense) and an overlay of upserts, tombstones and re-upserts."""
    rng = np.random.default_rng(11)
    keys = generate("logn", 20_000, 11)
    f = flatten(bulk_load(keys, local_optimized=request.param != "dili_lo"))
    mids = (keys[:-1] + keys[1:]) / 2
    ov = (TombstoneOverlay.empty(64)
          .upsert_batch(np.concatenate([keys[:300], mids[:300]]),
                        np.arange(600) + 2 ** 40)
          .delete_batch(keys[rng.integers(0, len(keys), 300)])
          .upsert_batch(keys[1000:1010], np.arange(10)))
    q = np.concatenate([keys, mids, keys[:777],
                        [np.inf, -np.inf, np.nan, 1e300, -1e300, 0.0]])
    return request.param, f, ov, q


def test_f64_kernel_matches_plain_version(gpu, f64_case):
    kind, f, ov, q = f64_case
    assert bool(f.dense.any()) == (kind == "dili_lo")
    cpu = K.search_with_overlay(
        K.kernel_arrays(f, device="cpu", dtype=torch.float64),
        overlay_device_arrays(ov, device="cpu"), torch.from_numpy(q))
    before = T_kernel.kernel_f64.launches
    out = K.search_with_overlay(
        K.kernel_arrays(f, device=gpu, dtype=torch.float64),
        overlay_device_arrays(ov, device=gpu), torch.from_numpy(q).to(gpu))
    torch.cuda.synchronize()
    assert T_kernel.kernel_f64.launches == before + 1
    for g, w in zip(out, cpu):
        assert torch.equal(g.cpu(), w)
    assert bool(cpu[1][:20_000].sum() > 19_000)


def test_local_facade_on_gpu_matches_cpu(gpu):
    rng = np.random.default_rng(8)
    keys = generate("fb", 20_000, 8)
    ixs = [LearnedIndex.build(keys, config=IndexConfig(), device=d)
           for d in ("cpu", "cuda")]
    assert ixs[1].engine == "local"
    q = np.concatenate([keys[rng.integers(0, len(keys), 5000)],
                        (keys[:-1] + keys[1:])[:3000] / 2])
    lo, hi = keys[:500], keys[50:550]
    before = T_kernel.kernel_f64.launches
    for step in range(4):
        for ix in ixs:
            ix.upsert(keys[step * 700: step * 700 + 600] + 0.5,
                      np.arange(600) + 2 ** 33)
            ix.delete(keys[step * 700 + 600: step * 700 + 700])
        (v0, f0), (v1, f1) = (ix.lookup(q) for ix in ixs)
        assert np.array_equal(f0, f1) and np.array_equal(v0, v1), step
        r0, r1 = (ix.range(lo, hi, max_hits=64) for ix in ixs)
        for a, b in zip(r0, r1):
            assert np.array_equal(a, b), step
    assert ixs[1].stats()["merge_reasons"] == ixs[0].stats()["merge_reasons"]
    assert ixs[1].n_merges >= 1
    for ix in ixs:
        ix.flush()
    (v0, f0), (v1, f1) = (ix.lookup(q) for ix in ixs)
    assert np.array_equal(f0, f1) and np.array_equal(v0, v1)
    for a, b in zip(ixs[0].items(), ixs[1].items()):
        assert np.array_equal(a, b)
    assert T_kernel.kernel_f64.launches == before + 5


# -- the f32/i64 instance (the local engine at dtype=float32) ---------------


def test_f32_i64_kernel_matches_plain_version(gpu, f64_case):
    """The same builds placed in f64, as f32/i64 tables with an f32
    overlay mirror: the f32/i64 instance equals its plain version."""
    kind, f, ov, q = f64_case
    q32 = torch.from_numpy(q.astype(np.float32))
    cpu = K.search_with_overlay(
        K.kernel_arrays(f, device="cpu", dtype=torch.float32,
                        val_dtype=torch.int64),
        overlay_device_arrays(ov, torch.float32, device="cpu"), q32)
    before = T_kernel.kernel_f32_i64.launches
    out = K.search_with_overlay(
        K.kernel_arrays(f, device=gpu, dtype=torch.float32,
                        val_dtype=torch.int64),
        overlay_device_arrays(ov, torch.float32, device=gpu), q32.to(gpu))
    torch.cuda.synchronize()
    assert T_kernel.kernel_f32_i64.launches == before + 1
    for g, w in zip(out, cpu):
        assert torch.equal(g.cpu(), w)
    assert bool(cpu[1][:20_000].sum() > 15_000)


def test_local_facade_at_f32_on_gpu_matches_cpu(gpu):
    keys = generate("logn", 20_000, 9)
    ixs = [LearnedIndex.build(keys, dtype=torch.float32, device=d)
           for d in ("cpu", "cuda")]
    mids = (keys[:-1] + keys[1:]) / 2
    before = T_kernel.kernel_f32_i64.launches
    for step in range(3):
        for ix in ixs:
            ix.upsert(mids[step * 1500: (step + 1) * 1500],
                      np.arange(1500) + 2 ** 35)
            ix.delete(keys[step * 300: step * 300 + 100])
        (v0, f0), (v1, f1) = (ix.lookup(np.concatenate([keys, mids]))
                              for ix in ixs)
        assert np.array_equal(f0, f1) and np.array_equal(v0, v1), step
    assert ixs[1].n_merges >= 1
    assert T_kernel.kernel_f32_i64.launches == before + 3


# -- background maintenance and the locked build, with threads ---------------


def test_background_merge_with_reader_threads(gpu):
    """Two reader threads launch lookups on the card while the writer
    drives background merges (fold, retrain, re-cluster, splice and
    publish on the worker); every read equals the truth at that moment
    and the final state after the flush barrier equals the truth."""
    import threading
    from repro_torch.api import MaintenanceConfig, MergePolicy
    rng = np.random.default_rng(12)
    keys = np.unique(rng.integers(0, 1 << 24, 60_000)).astype(np.float64)
    vals = np.arange(len(keys), dtype=np.int64)
    ix = LearnedIndex.build(keys, vals, config=IndexConfig(
        overlay_cap=1024, merge=MergePolicy(max_writes=2048),
        maintenance=MaintenanceConfig(background=True)), device=gpu)
    probe, want = keys[:4096], vals[:4096]
    stop, failures, overlapped = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            overlapped.append(ix._engine.oi._merging is not None)
            v, f = ix.lookup(probe)
            if not (f.all() and np.array_equal(v, want)):
                failures.append("probe diverged")
                return

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for th in threads:
        th.start()
    truth = dict(zip(keys.tolist(), vals.tolist()))
    try:
        for step in range(24):
            new = keys[4096:][rng.integers(0, len(keys) - 4096, 600)] + 0.5
            nv = rng.integers(0, 1 << 40, len(new))
            dead = keys[4096:][rng.integers(0, len(keys) - 4096, 100)]
            ix.upsert(new, nv)
            ix.delete(dead)
            truth.update(zip(new.tolist(), nv.tolist()))
            for k in dead.tolist():
                truth.pop(k, None)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert failures == [] and any(overlapped)
    st = ix.flush()
    assert st["maint_errors"] == 0 and st["n_incremental_flattens"] >= 1
    tk = np.array(sorted(truth))
    k, v = ix.items()
    assert np.array_equal(k, tk)
    assert np.array_equal(v, np.array([truth[x] for x in tk.tolist()]))
    vv, ff = ix.lookup(tk)
    assert ff.all() and np.array_equal(vv, v)
    ix.close()


def test_first_build_is_locked_under_two_threads(gpu, tmp_path,
                                                 monkeypatch):
    """Two threads that meet an unbuilt library at once run nvcc once and
    load the same library."""
    import subprocess
    import threading
    runs = []
    real = subprocess.run

    def counting_run(cmd, *a, **kw):
        runs.append(cmd)
        return real(cmd, *a, **kw)

    monkeypatch.setattr(T_kernel, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(T_kernel.subprocess, "run", counting_run)
    lib = T_kernel._Library()
    got = []
    threads = [threading.Thread(target=lambda: got.append(lib.load()))
               for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert len(runs) == 1 and len(got) == 2 and got[0] is got[1]
    assert lib.ptxas_report


def test_durable_abandon_recover_on_gpu(gpu, tmp_path):
    """A durable build on the card, writes through the WAL, a crash
    (`abandon`: no final fsync) and `recover` onto the card: lookups
    through the f64 kernel equal `items()`, which equals the truth."""
    from repro_torch.api import DurabilityConfig
    rng = np.random.default_rng(14)
    keys = np.unique(rng.integers(0, 1 << 24, 30_000)).astype(np.float64)
    vals = np.arange(len(keys), dtype=np.int64)
    d = str(tmp_path / "dur")
    ix = LearnedIndex.build(keys, vals, config=IndexConfig(
        overlay_cap=1024, durability=DurabilityConfig(dir=d)), device=gpu)
    truth = dict(zip(keys.tolist(), vals.tolist()))
    for step in range(6):
        new = keys[rng.integers(0, len(keys), 900)] + 0.5
        nv = rng.integers(0, 1 << 40, len(new))
        dead = keys[rng.integers(0, len(keys), 100)]
        ix.upsert(new, nv)
        ix.delete(dead)
        truth.update(zip(new.tolist(), nv.tolist()))
        for k in dead.tolist():
            truth.pop(k, None)
    assert ix.n_merges >= 1
    ix.abandon()
    before = T_kernel.kernel_f64.launches
    rx = LearnedIndex.recover(d, device=gpu)
    try:
        assert rx.device.type == "cuda"
        assert rx.metrics()["counters"]["recovery.replayed_records"] >= 1
        tk = np.array(sorted(truth))
        k, v = rx.items()
        assert np.array_equal(k, tk)
        assert np.array_equal(v, np.array([truth[x] for x in tk.tolist()]))
        q = np.concatenate([tk, keys])
        vv, ff = rx.lookup(q)
        assert T_kernel.kernel_f64.launches > before
        assert ff[: len(tk)].all() and np.array_equal(vv[: len(tk)], v)
        dead_q = np.setdiff1d(keys, tk)
        assert not rx.lookup(dead_q)[1].any()
    finally:
        rx.close()


# -- the i64 instances at the edges of their Hopper design -----------------


def _mirrors(ov: dict) -> list:
    """The overlay mirror `ov` (on the card) with its membership filter,
    and without it: the kernel bisects the overlay on every lane then."""
    return [ov, {k: ov[k] for k in ("keys", "vals", "tomb")}]


@pytest.mark.parametrize("filtered", [True, False],
                         ids=["filter", "no_filter"])
def test_i64_instances_match_plain_version(gpu, f64_case, filtered):
    """Both i64 instances on the standard and the DILI-LO (all leaves
    dense) 20k builds, with the overlay mirror with and without its
    filter, equal the plain version, at the snapshot's depth and one
    short (a lane left standing on a node is probed if it is dense)."""
    from repro_torch.kernels.dili_search import overlay_filter
    kind, f, ov, q = f64_case
    for dtype, fn in ((torch.float64, T_kernel.dili_search_f64),
                      (torch.float32, T_kernel.dili_search_f32_i64)):
        npt = np.float64 if dtype == torch.float64 else np.float32
        arrs = K.kernel_arrays(f, device="cpu", dtype=dtype,
                               val_dtype=torch.int64)
        mirror = overlay_device_arrays(ov, dtype, device="cpu")
        if filtered:
            mirror["filter"] = overlay_filter(ov.keys, dtype)
        qq = torch.from_numpy(q.astype(npt))
        recs = (arrs["node_rec"], arrs["slot_rec"], arrs["key"])
        for md in (arrs["max_depth"], arrs["max_depth"] - 1):
            kw = dict(root=arrs["root"], max_depth=md)
            want = fn(*recs, qq, ov=mirror, **kw)
            got = fn(*(r.to(gpu) for r in recs), qq.to(gpu),
                     ov={k: v.to(gpu) for k, v in mirror.items()}, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (kind, dtype, md)


@pytest.fixture(scope="module")
def edge_build():
    """A 20k logn build, as f64/i64 and f32/i64 tables on the CPU."""
    keys = generate("logn", 20_000, 13)
    f = flatten(bulk_load(keys))
    return keys, {
        torch.float64: K.kernel_arrays(f, device="cpu", dtype=torch.float64),
        torch.float32: K.kernel_arrays(f, device="cpu", dtype=torch.float32,
                                       val_dtype=torch.int64)}


def _edge_overlay(keys, n, fill, dtype, rng):
    """An overlay mirror of capacity n whose first `fill` sorted keys are
    live entries, tombstones at positions 0, 31, 32, 33 and n - 1 (where
    filled), then +inf padding, with its membership filter."""
    npt = np.float64 if dtype == torch.float64 else np.float32
    mids = (keys[:-1] + keys[1:]) / 2
    pool = np.unique(np.concatenate([
        keys, mids, rng.uniform(keys[0], keys[-1], n)]).astype(npt))
    k = np.full(n, np.inf, npt)
    k[:fill] = np.sort(rng.choice(pool, fill, replace=False))
    tomb = np.zeros(n, np.int8)
    edges = [p for p in (0, 31, 32, 33, n - 1) if p < fill]
    tomb[edges] = 1
    vals = np.where(np.arange(n) < fill, np.arange(n) + 2 ** 41, 0)
    return dict(keys=torch.from_numpy(k), vals=torch.from_numpy(vals),
                tomb=torch.from_numpy(tomb),
                filter=T_kernel.overlay_filter(k, dtype)), k[:fill]


@pytest.mark.parametrize("n", [1, 64, 4096, 65536])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64_i64", "f32_i64"])
def test_overlay_edges_match_plain_version(gpu, edge_build, dtype, n):
    """The f64/i64 and f32/i64 instances equal the plain version with an
    overlay empty (all +inf), partly filled and full
    (no padding), live entries and tombstones at positions 0, 31, 32, 33
    and n - 1, with its membership filter and without, on the overlay's
    keys, their neighbours, snapshot keys, +-0 and +-inf and NaN
    lanes."""
    keys, tables = edge_build
    arrs = tables[dtype]
    npt = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(n)
    fn = (T_kernel.dili_search_f64 if dtype == torch.float64
          else T_kernel.dili_search_f32_i64)
    for fill in sorted({0, min(n, 40), n}):
        ov, live = _edge_overlay(keys, n, fill, dtype, rng)
        q = np.concatenate([
            live, np.nextafter(live, npt(np.inf)),
            np.nextafter(live, npt(-np.inf)),
            keys[rng.integers(0, len(keys), 3000)].astype(npt),
            np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e30, -1e30],
                     npt)]).astype(npt)
        q = torch.from_numpy(q)
        recs = (arrs["node_rec"], arrs["slot_rec"], arrs["key"])
        kw = dict(root=arrs["root"], max_depth=arrs["max_depth"])
        want = fn(*recs, q, ov=ov, **kw)
        for mirror in _mirrors({k: v.to(gpu) for k, v in ov.items()}):
            got = fn(*(r.to(gpu) for r in recs), q.to(gpu), ov=mirror, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (fill, len(mirror))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64_i64", "f32_i64"])
def test_filter_finds_signed_zero(gpu, edge_build, dtype):
    """An overlay key -0.0 is found by a +0.0 query and the reverse, with
    the filter consulted: the filter hashes q + 0, which makes -0 +0."""
    keys, tables = edge_build
    arrs = tables[dtype]
    npt = np.float64 if dtype == torch.float64 else np.float32
    fn = (T_kernel.dili_search_f64 if dtype == torch.float64
          else T_kernel.dili_search_f32_i64)
    recs = (arrs["node_rec"], arrs["slot_rec"], arrs["key"])
    kw = dict(root=arrs["root"], max_depth=arrs["max_depth"])
    for zero in (-0.0, 0.0):
        k = np.array([zero, 2.0] + [np.inf] * 30, npt)
        ov = dict(keys=torch.from_numpy(k),
                  vals=torch.arange(32, dtype=torch.int64) + 5,
                  tomb=torch.zeros(32, dtype=torch.int8),
                  filter=T_kernel.overlay_filter(k, dtype))
        q = torch.from_numpy(np.array([0.0, -0.0, 2.0, 1.0], npt))
        want = fn(*recs, q, ov=ov, **kw)
        assert want[1][:3].all() and want[0][:2].tolist() == [5, 5]
        for mirror in _mirrors({k: v.to(gpu) for k, v in ov.items()}):
            got = fn(*(r.to(gpu) for r in recs), q.to(gpu), ov=mirror, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (zero, len(mirror))


def test_tables_beyond_the_l2_match_plain_version(gpu):
    """Synthetic f64 tables whose node records (2M, 64 MB) and slot
    records (64 MB) each outgrow the 50 MB L2, with the overlay's filter
    and without: a root
    of 2^21 CHILD slots (each carrying its child's base and fanout) over
    leaves of two PAIR slots.  The kernel sets no L2 persisting window, so
    no window bounds what it reads."""
    leaves = 1 << 21
    keys = np.arange(2 * leaves, dtype=np.float64)
    fo = np.concatenate([[leaves], np.full(leaves, 2)]).astype(np.int32)
    base = np.concatenate([[0], leaves + 2 * np.arange(leaves)]).astype(
        np.int32)
    a = np.concatenate([[0.0], -2.0 * np.arange(leaves)])
    b = np.concatenate([[0.5], np.ones(leaves)])
    tag = np.concatenate([np.full(leaves, 2), np.full(2 * leaves, 1)])
    from repro_torch.core.flat import TAG_CHILD, TAG_PAIR
    tag = np.where(tag == 2, TAG_CHILD, TAG_PAIR).astype(np.int8)
    key = np.concatenate([np.zeros(leaves), keys])
    val = np.concatenate([np.arange(1, leaves + 1),
                          np.arange(2 * leaves) * 3]).astype(np.int64)
    arrs = K.pack_tables(dict(a=a, b=b, base=base, fo=fo,
                              dense=np.zeros(leaves + 1, np.int8), tag=tag,
                              key=key, val=val, root=0, max_depth=2),
                         device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(15)
    q = np.concatenate([keys[rng.integers(0, len(keys), 200_000)],
                        keys[:5000] + 0.5, [np.inf, -np.inf, np.nan]])
    q = torch.from_numpy(q)
    ov_keys = np.array([3.0, 5.0] + [np.inf] * 62)
    ov = dict(keys=torch.from_numpy(ov_keys),
              vals=torch.arange(64, dtype=torch.int64),
              tomb=torch.tensor([1, 0] + [0] * 62, dtype=torch.int8),
              filter=T_kernel.overlay_filter(ov_keys))
    recs = (arrs["node_rec"], arrs["slot_rec"], arrs["key"])
    kw = dict(root=0, max_depth=2)
    want = T_kernel.dili_search_f64(*recs, q, ov=ov, **kw)
    assert bool(want[1][:200_000].all())
    grecs = [r.to(gpu) for r in recs]
    for mirror in _mirrors({k: v.to(gpu) for k, v in ov.items()}):
        got = T_kernel.dili_search_f64(*grecs, q.to(gpu), ov=mirror, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), len(mirror)


def test_occupancy_report(gpu):
    """The runtime's registers and resident blocks for each instance's
    kernel."""
    for kern in (T_kernel.kernel, T_kernel.kernel_f64,
                 T_kernel.kernel_f32_i64):
        occ = kern.occupancy()
        assert 0 < occ["regs"] <= 255 and occ["blocks_per_sm"] >= 1


# -- the sharded engine and the serving front-end (on the card) ---------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("strategy", ["gather", "a2a"])
def test_sharded_facade_on_gpu_matches_cpu(gpu, strategy, dtype):
    """8 shards on the card answer as on the CPU (the plain version), bit
    for bit, through writes, ranges, a flush and a skewed a2a batch; each
    lookup launches the f64/i64 (f32/i64) instance once a shard."""
    rng = np.random.default_rng(21)
    keys = generate("logn", 30_000, 21)
    cfg = IndexConfig(engine="sharded", n_shards=8, dtype=dtype,
                      lookup_strategy=strategy)
    ixs = [LearnedIndex.build(keys, config=cfg, device=d)
           for d in ("cpu", "cuda")]
    kern = (T_kernel.kernel_f64 if dtype == torch.float64
            else T_kernel.kernel_f32_i64)
    mids = (keys[:-1] + keys[1:]) / 2
    q = np.concatenate([keys[rng.integers(0, len(keys), 6000)],
                        mids[rng.integers(0, len(mids), 2000)]])
    skew = keys[rng.integers(0, len(keys) // 8, 4096)]
    lo, hi = keys[:700:7], keys[40:740:7]

    def same(a, b):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)

    for step in range(3):
        for ix in ixs:
            ix.upsert(mids[step * 900: step * 900 + 800], np.arange(800)
                      + 2 ** 35)
            ix.delete(keys[step * 900 + 800: step * 900 + 900])
        before = kern.launches
        fell_back = ixs[1].kernel_stats["a2a_fallbacks"]
        same(*(ix.lookup(q) for ix in ixs))
        # one launch a shard, and 8 more where an a2a bucket overflowed
        # (the facade's pow2 pad lanes repeat q[0] into one bucket)
        fell_back = ixs[1].kernel_stats["a2a_fallbacks"] - fell_back
        assert kern.launches - before == 8 * (1 + fell_back)
        same(*(ix.range(lo, hi, max_hits=32) for ix in ixs))
        same(*(ix.lookup(skew) for ix in ixs))
    for ix in ixs:
        ix.flush()
    same(*(ix.lookup(q) for ix in ixs))
    same(*(ix.items() for ix in ixs))
    ks = ixs[1].kernel_stats
    assert ks["launches"] > 0 and ks["table_bytes"] > 0
    if strategy == "a2a":
        assert ks["a2a_fallbacks"] >= 3          # the skewed batches


def test_sharded_a2a_overflow_on_gpu_matches_cpu(gpu):
    """The raw a2a lookup on the card: a skewed batch overflows its
    buckets, and values, found flags and the per-source overflow counts
    equal the plain version's."""
    from repro_torch.core import distributed as TD
    keys = generate("logn", 30_000, 22)
    sd = TD.build_sharded(keys, None, n_shards=8)
    rng = np.random.default_rng(22)
    q = np.concatenate([keys[rng.integers(0, len(keys) // 8, 3000)],
                        keys[rng.integers(0, len(keys), 1000)],
                        [np.inf] * 96])
    out = []
    for dev in ("cpu", "cuda"):
        arrs = TD.to_device(sd, dev)
        res = TD.sharded_lookup(arrs, torch.from_numpy(q).to(dev),
                                strategy="a2a")
        out.append([x.cpu() for x in res])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert int(out[1][2].sum()) > 0


@pytest.mark.parametrize("engine", ["local", "sharded"])
def test_serve_on_gpu_replays_against_the_oracle(gpu, engine):
    """A short concurrent serve run on the card: 4 client threads through
    `ServeFrontend`, then the commit-order journal replayed through the
    oracle-checked `WorkloadRunner` on a fresh index on the card, which
    must end with the served index's content."""
    import threading
    from repro_torch.serve import ServeConfig, ServeFrontend
    from repro_torch.workloads import WorkloadRunner
    n = 4000
    keys = np.arange(0, 2 * n, 2, dtype=np.float64)
    cfg = IndexConfig(engine=engine, n_shards=8 if engine == "sharded"
                      else None)
    ix = LearnedIndex.build(keys, config=cfg, device="cuda")
    fe = ServeFrontend(ix, ServeConfig(dwell_s=2e-4))
    errors = []

    def client(ci):
        try:
            c = fe.client(f"c{ci}")
            r = np.random.default_rng(ci)
            base = float(2 * n + 1 + 100_000 * ci)
            for step in range(40):
                c.upsert([base + 2 * step], [step])
                assert c.get(base + 2 * step) == step
                v, f = c.lookup(keys[r.integers(0, n, 16)])
                assert f.all()
                if step % 4 == 3:
                    c.delete([base + 2 * (step - 1)])
        except BaseException as e:       # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    fe.drain()
    journal = fe.journal_batches()
    fe.close()
    assert not errors, errors[:2]
    fresh = LearnedIndex.build(keys, config=cfg, device="cuda")
    try:
        rep = WorkloadRunner(fresh).run(journal, name=f"serve-{engine}")
        assert rep.divergences == []
        for a, b in zip(ix.items(), fresh.items()):
            assert np.array_equal(a, b)
    finally:
        fresh.close()
        ix.close()


@pytest.fixture(scope="module")
def competitor_case():
    keys = generate("logn", 20_000, 5)
    mids = (keys[:-1] + keys[1:]) / 2
    edges = [-np.inf, np.inf, np.nan, keys[0] - 1, keys[-1] + 1, 1e300,
             -1e300, 3e9]
    return keys, np.concatenate([keys, mids, edges])


@pytest.mark.parametrize("name,dtype", [
    (B.name, dt) for B in TB.ALL_BASELINES
    for dt in ((torch.float64,) if B is TB.LIPP
               else (torch.float64, torch.float32))],
    ids=lambda x: x if isinstance(x, str) else str(x).split(".")[-1])
def test_competitor_on_gpu_matches_cpu(gpu, competitor_case, name, dtype):
    """Each competitor's (vals, found, probes) on the card equal the same
    torch code on the CPU; LIPP's values come from one launch of the
    f64/i64 kernel there and from its plain version here."""
    B = next(B for B in TB.ALL_BASELINES if B.name == name)
    keys, q = competitor_case
    st = B.build(keys, np.arange(len(keys)))
    with np.errstate(over="ignore"):        # ±1e300 in f32 is ±inf
        qt = torch.from_numpy(q.astype(np.float64 if dtype == torch.float64
                                       else np.float32))
    want = B.lookup(B.device(st, dtype=dtype, device="cpu"), qt)
    before = T_kernel.kernel_f64.launches
    got = B.lookup(B.device(st, dtype=dtype, device=gpu), qt.to(gpu))
    torch.cuda.synchronize()
    assert T_kernel.kernel_f64.launches == before + (B is TB.LIPP)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    if dtype == torch.float64:
        assert bool(want[1][:len(keys)].all())
        assert torch.equal(want[0][:len(keys)].long(),
                           torch.arange(len(keys)))


@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_llm_reduced_on_gpu_matches_cpu(gpu, arch, monkeypatch):
    """A reduced LLM in f32 (weights from the port's seeded init on the CPU,
    the same moved to the card): prefill of [2, 12] and 4 greedy decode
    steps on CUDA give the CPU's tokens, logits within 1e-4 absolute, with
    TF32 off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _llm_cfg(arch)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["extra_embeds"] = rng.standard_normal(
            (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        kw["enc_frames"] = rng.standard_normal(
            (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    max_len = 12 + 5 + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    runs = []
    for dev in (torch.device("cpu"), gpu):
        model = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu").to(dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in dict(tokens=tokens, **kw).items()}
        toks, logits = STEP.greedy(model, cfg, batch,
                                   MDL.make_cache(cfg, 2, max_len,
                                                  device=dev), 4)
        assert model.final_norm.device.type == dev.type
        runs.append((toks.cpu(), [lg.cpu() for lg in logits]))
    (t_cpu, l_cpu), (t_gpu, l_gpu) = runs
    assert torch.equal(t_gpu, t_cpu)
    for a, b in zip(l_gpu, l_cpu):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_train_reduced_on_gpu_matches_cpu(gpu, arch, monkeypatch):
    """A reduced LLM in f32 with remat off (weights from the port's seeded
    init on the CPU, the same moved to the card), one AdamW train step
    on CUDA and on the CPU: loss and grad norm within 1e-4 relative, the
    updated first moments (0.1 of each clipped gradient) within 1e-4 of
    each leaf's largest magnitude, with TF32 off."""
    import dataclasses
    from repro_torch.train import optim as O
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(_llm_cfg(arch), remat="none")
    lead = (cfg.accum_steps,) if cfg.accum_steps > 1 else ()
    rng = np.random.default_rng(0)
    batch = dict(tokens=rng.integers(0, cfg.vocab, lead + (2, 12)),
                 labels=rng.integers(0, cfg.vocab, lead + (2, 12)))
    if cfg.family == "vlm":
        batch["extra_embeds"] = rng.standard_normal(
            lead + (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["enc_frames"] = rng.standard_normal(
            lead + (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    runs = []
    for dev in (torch.device("cpu"), gpu):
        opt = O.adamw(lr=1e-3)
        model = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu").to(dev)
        state = dict(params=model, opt=opt.init(MDL.param_tree(model)),
                     step=torch.zeros((), dtype=torch.int32, device=dev))
        state, m = STEP.make_train_step(cfg, opt)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        assert state["opt"]["step"].device.type == dev.type
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     [t.cpu() for t in O.tree_tensors(state["opt"]["mu"])]))
    (l_cpu, n_cpu, mu_cpu), (l_gpu, n_gpu, mu_gpu) = runs
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    assert abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu)
    for a, b in zip(mu_gpu, mu_cpu):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
