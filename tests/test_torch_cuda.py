"""The CUDA kernel and the port's facade on a GPU, against the plain
PyTorch version on the CPU.  Needs an NVIDIA GPU and nvcc; every test
skips without one.  Imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import IndexConfig, LearnedIndex, manual_merge_policy
from repro_torch.core.dili import bulk_load
from repro_torch.core.flat import flatten
from repro_torch.data.datasets import generate
from repro_torch.kernels import dili_search as T_kernel
from repro_torch.kernels import ops as K
from repro_torch.online.overlay import TombstoneOverlay, overlay_device_arrays

pytestmark = pytest.mark.cuda


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
