"""The port's durability subsystem (WAL, checkpoints, recovery, save/load,
the `ft` checkpoint protocol) against the JAX package's, on the CPU.

The scenarios of the reference's tests/test_durability.py,
tests/test_api_persistence.py and tests/test_ft_checkpoint.py run on the
port (`device="cpu"`, on the `local`, `pallas` and `sharded` engines,
the sharded one on a single shard as the reference's in this one-device
process; tests/test_torch_distributed.py holds 8 shards), and the two
packages are held to each other on disk: the same op stream writes
byte-identical WAL segments and equal checkpoints, a directory written by
either recovers in the other to equal `items()`, and the recovery
counters, the `metrics()` key tree, `inspect()["wal"]` and the armed
trace's key tree are equal.  `np.savez` embeds zip timestamps, so
checkpoints are compared by manifest, arrays and file size, never by
`state.npz` bytes.  The crash matrix is in tests/test_torch_crash.py.
"""
import json
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro import api as JA
from repro.durability import checkpoint as J_dckpt
from repro.durability import wal as J_wal
from repro.ft import checkpoint as J_ftck
from repro.workloads.generator import PRESETS as J_PRESETS
from repro.workloads.generator import generate_stream as j_generate_stream
from repro_torch import api as TA
from repro_torch.durability import checkpoint as dckpt
from repro_torch.durability import wal
from repro_torch.ft import checkpoint as ftck
from repro_torch.workloads import (PRESETS, SortedOracle, WorkloadRunner,
                                   generate_stream)

ENGINES = ("local", "pallas", "sharded")
CPU = {"device": "cpu"}


def _dur_cfg(pkg, d, engine="local", fsync="always", merge="manual",
             **kw):
    return pkg.IndexConfig(
        engine=engine, overlay_cap=128,
        merge=pkg.manual_merge_policy() if merge == "manual"
        else pkg.MergePolicy(),
        durability=pkg.DurabilityConfig(dir=str(d), fsync=fsync, **kw))


def _build(pkg, keys, vals, config):
    extra = CPU if pkg is TA else {}
    return pkg.LearnedIndex.build(keys, vals, config=config, **extra)


def _recover(pkg, d, **kw):
    extra = CPU if pkg is TA else {}
    return pkg.LearnedIndex.recover(str(d), **kw, **extra)


def _same_items(a, b):
    (ka, va), (kb, vb) = a, b
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(va, vb)


# ---------------------------------------------------------------------------
# WAL unit tests (the reference's, on the port's module)
# ---------------------------------------------------------------------------


def test_wal_record_round_trip(tmp_path):
    d = str(tmp_path / "w")
    w = wal.WalWriter(d, fsync="always")
    k1 = np.array([1.5, 2.5, 99.0])
    v1 = np.array([10, 20, 30], np.int64)
    assert w.append(wal.OP_UPSERT, k1, v1, epoch=3) == 0
    assert w.append(wal.OP_DELETE, np.array([2.5]), None, epoch=3) == 1
    w.close()
    recs = wal.read_records(d)
    assert [r["lsn"] for r in recs] == [0, 1]
    assert recs[0]["op"] == wal.OP_UPSERT and recs[0]["epoch"] == 3
    np.testing.assert_array_equal(recs[0]["keys"], k1)
    np.testing.assert_array_equal(recs[0]["vals"], v1)
    assert recs[1]["op"] == wal.OP_DELETE and recs[1]["vals"] is None
    np.testing.assert_array_equal(recs[1]["keys"], [2.5])
    # the record bytes are the reference's, and each package reads the
    # other's segment
    for lsn, op, k, v in ((0, wal.OP_UPSERT, k1, v1),
                          (1, wal.OP_DELETE, np.array([2.5]), None)):
        assert (wal.encode_record(lsn, 3, op, k, v)
                == J_wal.encode_record(lsn, 3, op, k, v))
    jr = J_wal.read_records(d)
    assert [(r["lsn"], r["op"], r["epoch"]) for r in jr] == \
        [(r["lsn"], r["op"], r["epoch"]) for r in recs]


def test_wal_torn_tail_truncates_at_first_bad_crc(tmp_path):
    d = str(tmp_path / "w")
    w = wal.WalWriter(d, fsync="always")
    for i in range(4):
        w.append(wal.OP_UPSERT, np.array([float(i)]),
                 np.array([i], np.int64), epoch=1)
    w.close()
    (_, path), = wal.list_segments(d)
    full = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(wal.encode_record(4, 1, wal.OP_UPSERT, np.array([9.0]),
                                  np.array([9], np.int64))[:11])
    assert [r["lsn"] for r in wal.read_records(d)] == [0, 1, 2, 3]
    with open(path, "r+b") as f:
        f.truncate(full)
        f.seek(full // 2)
        b = f.read(1)
        f.seek(full // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    lsns = [r["lsn"] for r in wal.read_records(d)]
    assert lsns == list(range(len(lsns))) and len(lsns) < 4
    assert lsns == [r["lsn"] for r in J_wal.read_records(d)]


def test_wal_rotate_purge_and_resume(tmp_path):
    d = str(tmp_path / "w")
    w = wal.WalWriter(d, fsync="always")
    for i in range(3):
        w.append(wal.OP_DELETE, np.array([float(i)]), None, epoch=1)
    w.rotate()
    w.append(wal.OP_DELETE, np.array([7.0]), None, epoch=1)
    assert len(wal.list_segments(d)) == 2
    assert w.purge_upto(2) == 0
    assert w.purge_upto(3) == 1
    assert [r["lsn"] for r in wal.read_records(d, from_lsn=3)] == [3]
    w.close()
    w2 = wal.WalWriter(d, fsync="always", start_lsn=wal.end_lsn(d))
    assert w2.append(wal.OP_DELETE, np.array([8.0]), None, epoch=2) == 4
    w2.close()
    assert [r["lsn"] for r in wal.read_records(d, from_lsn=3)] == [3, 4]


# ---------------------------------------------------------------------------
# durability checkpoint fallback
# ---------------------------------------------------------------------------


def _write_ckpt(d, step, n):
    keys = np.arange(n, dtype=np.float64)
    return dckpt.write_checkpoint(
        str(d), step, keys, (keys * 2).astype(np.int64),
        epoch=step, wal_lsns={0: step * 10}, keep=3)


def test_checkpoint_corrupt_newest_falls_back(tmp_path):
    d = tmp_path / "ckpt"
    _write_ckpt(d, 1, 50)
    p2 = _write_ckpt(d, 2, 60)
    npz = os.path.join(p2, "state.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(blob))
    name, manifest, keys, _ = next(dckpt.iter_checkpoints(str(d)))
    assert manifest["step"] == 1 and len(keys) == 50
    _write_ckpt(d, 3, 70)
    os.remove(os.path.join(str(d), dckpt.ftck.step_name(3),
                           "manifest.json"))
    name, manifest, keys, _ = next(dckpt.iter_checkpoints(str(d)))
    assert manifest["step"] == 1 and len(keys) == 50
    # the reference walks the port's directory to the same step
    _, jm, jk, _ = next(J_dckpt.iter_checkpoints(str(d)))
    assert jm == manifest
    np.testing.assert_array_equal(jk, keys)


# ---------------------------------------------------------------------------
# in-process build -> crash -> recover round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_abandon_recover_round_trip(tmp_path, engine):
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 20, 900)).astype(np.float64)
    vals = rng.integers(0, 1 << 30, len(keys)).astype(np.int64)
    oracle = SortedOracle(keys, vals)
    ix = _build(TA, keys, vals, _dur_cfg(TA, tmp_path / "dur", engine))
    up_k, up_v = keys[:40] + 0.5, np.arange(40, dtype=np.int64)
    ix.upsert(up_k, up_v)
    oracle.upsert(up_k, up_v)
    ix.flush()
    ix.delete(keys[100:120])
    oracle.delete(keys[100:120])
    ix.abandon()

    rx = _recover(TA, tmp_path / "dur")
    try:
        _same_items(rx.items(), oracle.items())
        assert rx.engine == engine and rx.device.type == "cpu"
        m = rx.metrics()
        assert m["counters"]["recovery.count"] == 1
        assert m["counters"]["recovery.replayed_records"] == 1
        for s in ("recovery.load", "recovery.replay", "recovery.publish"):
            assert m["spans"][s]["count"] == 1, s
        rx.upsert([3.25], [777])
        rx.flush()
    finally:
        rx.close()
    rz = _recover(TA, tmp_path / "dur")
    try:
        assert rz.get(3.25) == 777
    finally:
        rz.close()


def test_recover_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _recover(TA, tmp_path / "nothing")


def test_clean_close_then_recover(tmp_path):
    ix = _build(TA, np.arange(64, dtype=np.float64), None,
                _dur_cfg(TA, tmp_path / "dur", fsync="interval"))
    ix.upsert([7.5], [70])
    ix.close()
    rx = _recover(TA, tmp_path / "dur")
    try:
        assert rx.get(7.5) == 70
    finally:
        rx.close()


def test_wal_truncation_after_checkpoints(tmp_path):
    cfg = _dur_cfg(TA, tmp_path / "dur", keep_checkpoints=2)
    ix = _build(TA, np.arange(256, dtype=np.float64), None, cfg)
    dur = ix._dur
    for i in range(5):
        ix.upsert(np.arange(8, dtype=np.float64) + 1000 + 16 * i,
                  np.arange(8, dtype=np.int64))
        ix.flush()
    manifests = dckpt.retained_manifests(os.path.join(cfg.durability.dir,
                                                      "ckpt"))
    assert len(manifests) == 2
    oldest = min(int(m["wal_lsns"]["0"]) for m in manifests)
    segs = wal.list_segments(os.path.join(cfg.durability.dir, "wal",
                                          "shard_00000"))
    assert all(start >= oldest or i + 1 == len(segs)
               or segs[i + 1][0] > oldest for i, (start, _) in
               enumerate(segs))
    assert dur is ix._dur
    ix.close()


def test_config_round_trips_durability(tmp_path):
    cfg = _dur_cfg(TA, tmp_path / "dur", fsync="interval")
    back = TA.IndexConfig.from_json_dict(cfg.to_json_dict())
    assert back.durability == cfg.durability
    assert TA.IndexConfig.from_json_dict(
        TA.IndexConfig().to_json_dict()).durability is None
    with pytest.raises(ValueError):
        TA.DurabilityConfig(dir=str(tmp_path), fsync="sometimes")
    with pytest.raises(ValueError):
        TA.DurabilityConfig(dir="")
    # the JSON is the reference's, a torch dtype included
    jcfg = _dur_cfg(JA, tmp_path / "dur", fsync="interval", engine="pallas")
    tcfg = _dur_cfg(TA, tmp_path / "dur", fsync="interval", engine="pallas")
    assert tcfg.to_json_dict() == jcfg.to_json_dict()
    t32 = TA.IndexConfig(dtype=torch.float32)
    assert t32.to_json_dict() == JA.IndexConfig(
        dtype=np.float32).to_json_dict()
    assert t32.to_json_dict()["dtype"] == "float32"
    assert JA.IndexConfig.from_json_dict(
        tcfg.to_json_dict()).durability == jcfg.durability


@pytest.mark.parametrize("engine", ENGINES)
def test_durability_with_background_maintenance(tmp_path, engine):
    """Checkpoints from merge publishes (on the worker with background
    maintenance on the local engine) beside a writer: abandon mid-stream,
    recover, and `items()` equals the oracle."""
    keys = np.arange(0, 6000, 2, dtype=np.float64)
    cfg = TA.IndexConfig(
        engine=engine, overlay_cap=256,
        merge=TA.MergePolicy(max_writes=300),
        maintenance=TA.MaintenanceConfig(background=engine == "local"),
        durability=TA.DurabilityConfig(dir=str(tmp_path / "dur")))
    ix = _build(TA, keys, None, cfg)
    spec = PRESETS["ycsb_a"].scaled(n_ops=2400, batch_size=64, seed=4)
    runner = WorkloadRunner(ix)
    out = runner.run_kill_recover(generate_stream(spec, keys),
                                  kill_at=20, spec=spec)
    rx = runner.index
    try:
        assert out["n_divergences"] == 0
        assert out["post_recovery_divergences"] == []
        assert rx.device.type == "cpu"
        assert out["pre"]["n_merges"] >= 2
        _same_items(rx.items(), runner.oracle.items())
    finally:
        rx.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_between_append_and_apply_keeps_the_write(
        tmp_path, engine, monkeypatch):
    """A checkpoint taken on another thread (the maintenance worker's
    publish) after a batch is appended to the WAL and before the engine
    applies it must not count the batch as held: after a crash, recovery
    replays it."""
    import threading
    from repro_torch.durability import manager
    keys = np.arange(0, 600, 2, dtype=np.float64)
    cfg = TA.IndexConfig(engine=engine,
                         durability=TA.DurabilityConfig(dir=str(tmp_path)))
    ix = _build(TA, keys, None, cfg)
    hit = []

    def checkpoint_elsewhere(point):
        if point == "wal.append" and not hit:
            hit.append(point)
            th = threading.Thread(target=ix._dur.checkpoint)
            th.start()
            th.join()

    monkeypatch.setattr(manager.hooks, "crash_point", checkpoint_elsewhere)
    new = np.arange(len(keys), dtype=np.int64) + 10_000
    ix.upsert(keys, new)
    assert hit
    ix.abandon()
    rx = _recover(TA, tmp_path)
    try:
        _same_items(rx.items(), (keys, new))
    finally:
        rx.close()


# ---------------------------------------------------------------------------
# save / load (tests/test_api_persistence.py and the atomic-save tests)
# ---------------------------------------------------------------------------


def _keyset():
    rng = np.random.default_rng(77)
    keys = np.unique(rng.integers(0, 1 << 22, 1500)).astype(np.float64)
    vals = rng.integers(0, 1 << 30, len(keys)).astype(np.int64)
    return keys, vals


@pytest.mark.parametrize("engine", ENGINES)
def test_save_load_round_trip_with_pending_writes(tmp_path, engine):
    keys, vals = _keyset()
    cfg = TA.IndexConfig(engine=engine, merge=TA.manual_merge_policy(),
                         overlay_cap=128)
    ix = _build(TA, keys, vals, cfg)
    new = np.setdiff1d(keys[:64] + 1.0, keys)
    ix.upsert(new, np.arange(len(new), dtype=np.int64) + 9_000_000)
    dead = keys[200:240]
    ix.delete(dead)
    assert ix.stats()["pending_writes"] > 0

    path = str(tmp_path / f"{engine}.npz")
    ix.save(path)
    ix2 = TA.LearnedIndex.load(path, **CPU)
    assert ix2.engine == engine and ix2.device.type == "cpu"
    assert ix2.config.overlay_cap == 128
    assert ix2.stats()["pending_writes"] == 0
    assert ix2.epoch == 1
    _same_items(ix2.items(), ix.items())
    _, f_new = ix2.lookup(new)
    _, f_dead = ix2.lookup(dead)
    assert f_new.all() and not f_dead.any()
    # the file is the reference's format: it loads there too, and a file
    # the reference writes loads in the port
    jx = JA.LearnedIndex.load(path)
    _same_items(jx.items(), ix.items())
    assert jx.engine == engine
    jx.save(str(tmp_path / "ref.npz"))
    _same_items(TA.LearnedIndex.load(str(tmp_path / "ref.npz"),
                                     **CPU).items(), ix.items())


@pytest.mark.parametrize("engine", ENGINES)
def test_load_then_upsert_then_flush(tmp_path, engine):
    keys, vals = _keyset()
    path = str(tmp_path / "ix")
    _build(TA, keys, vals, TA.IndexConfig(
        engine=engine, merge=TA.manual_merge_policy())).save(path)

    ix = TA.LearnedIndex.load(path, **CPU)
    more = np.setdiff1d(keys[300:380] + 1.0, keys)
    ix.upsert(more, np.arange(len(more), dtype=np.int64) + 7_000_000)
    ix.delete(keys[:32])
    st = ix.flush()
    assert st["pending_writes"] == 0
    assert st["epoch"] == 2

    v, f = ix.lookup(more)
    assert f.all()
    np.testing.assert_array_equal(
        v, np.arange(len(more), dtype=np.int64) + 7_000_000)
    _, f2 = ix.lookup(keys[:32])
    assert not f2.any()
    ix.save(str(tmp_path / "ix2"))
    _same_items(TA.LearnedIndex.load(str(tmp_path / "ix2"), **CPU).items(),
                ix.items())


def test_load_with_engine_override(tmp_path):
    keys, vals = _keyset()
    cfg = TA.IndexConfig(merge=TA.manual_merge_policy())
    path = str(tmp_path / "local.npz")
    src = _build(TA, keys, vals, cfg)
    src.save(path)
    q = np.concatenate([keys[::7], keys[:64] + 3.0])
    v0, f0 = src.lookup(q)
    dst = TA.LearnedIndex.load(path, config=replace(cfg, engine="pallas"),
                               **CPU)
    assert dst.engine == "pallas"
    v, f = dst.lookup(q)
    np.testing.assert_array_equal(f, f0)
    np.testing.assert_array_equal(v[f], v0[f0])
    _same_items(dst.items(), (keys, vals))


def test_save_is_atomic_over_existing_file(tmp_path, monkeypatch):
    keys = np.arange(128, dtype=np.float64)
    ix = _build(TA, keys, None, None)
    path = str(tmp_path / "ix.npz")
    ix.save(path)
    before = open(path, "rb").read()

    def boom(*a, **kw):
        raise IOError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(IOError):
        ix.save(path)
    assert open(path, "rb").read() == before
    assert os.listdir(str(tmp_path)) == ["ix.npz"]
    monkeypatch.undo()
    rx = TA.LearnedIndex.load(path, **CPU)
    np.testing.assert_array_equal(rx.items()[0], keys)


def test_load_truncated_file_raises_not_garbage(tmp_path):
    keys = np.arange(128, dtype=np.float64)
    ix = _build(TA, keys, None, None)
    path = str(tmp_path / "ix.npz")
    ix.save(path)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) // 2])
    with pytest.raises(Exception):
        TA.LearnedIndex.load(path, **CPU)


# ---------------------------------------------------------------------------
# cross-package: the same stream on disk, recovery either way
# ---------------------------------------------------------------------------

# (engine, merge policy): the local engine under manual merges and under
# the default policy (whose fill, lag and pressure merges decide the epoch
# each WAL record carries), the pallas engine and the sharded engine
STREAMS = (("local", "manual"), ("local", "default"), ("pallas", "manual"),
           ("sharded", "manual"))


def _stream_keys():
    return np.arange(0, 8000, 2, dtype=np.float64)


def _drive(ix, batches, flush_every=6):
    """Replay the writes of a workload stream, flushing every few batches
    (each flush is a merge publish, hence a checkpoint)."""
    n = 0
    for b in batches:
        if b.op == "upsert":
            ix.upsert(b.keys, b.vals)
        elif b.op == "delete":
            ix.delete(b.keys)
        else:
            continue
        n += 1
        if n % flush_every == 0:
            ix.flush()


def _both_durable(tmp_path, engine, merge):
    """One stream through a durable index of each package; directories of
    equal path length, so the manifests' config JSON sizes agree."""
    keys = _stream_keys()
    spec = J_PRESETS["dili_paper"].scaled(n_ops=4800, batch_size=96,
                                          seed=3)
    batches = j_generate_stream(spec, keys)
    out = []
    for pkg, sub in ((JA, "j"), (TA, "t")):
        cfg = _dur_cfg(pkg, tmp_path / sub / "dur", engine, merge=merge)
        ix = _build(pkg, keys, None, cfg)
        _drive(ix, batches)
        out.append(ix)
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _manifest(path):
    with open(path) as f:
        m = json.load(f)
    m["config"]["durability"]["dir"] = "<dir>"
    return m


@pytest.mark.parametrize("engine,merge", STREAMS)
def test_same_stream_same_bytes_on_disk(tmp_path, engine, merge):
    """(a) Byte-identical WAL segments (every record's epoch included),
    equal manifests and equal checkpoint arrays; (d) equal
    `inspect()["wal"]`."""
    j, t = _both_durable(tmp_path, engine, merge)
    assert t.epoch == j.epoch and t.n_merges == j.n_merges
    if merge == "default":
        assert t.stats()["merge_reasons"] == j.stats()["merge_reasons"]
        assert sum(n for r, n in t.stats()["merge_reasons"].items()
                   if r != "flush") >= 1
    assert t.inspect()["wal"] == j.inspect()["wal"]
    dj, dt = str(tmp_path / "j" / "dur"), str(tmp_path / "t" / "dur")
    assert _files(dt) == _files(dj)
    n_segs = 0
    for rel in _files(dt):
        pj, pt = os.path.join(dj, rel), os.path.join(dt, rel)
        if rel.endswith(".wal"):
            assert open(pt, "rb").read() == open(pj, "rb").read(), rel
            n_segs += 1
        elif rel.endswith("manifest.json"):
            assert _manifest(pt) == _manifest(pj), rel
        elif rel.endswith("state.npz"):
            assert os.path.getsize(pt) == os.path.getsize(pj), rel
            with np.load(pt) as zt, np.load(pj) as zj:
                for k in ("keys", "vals"):
                    np.testing.assert_array_equal(zt[k], zj[k])
        else:
            assert open(pt, "rb").read() == open(pj, "rb").read(), rel
    assert n_segs >= 1
    _same_items(t.items(), j.items())
    for ix in (j, t):
        ix.close()


def _key_tree(d, prefix=""):
    out = []
    for k in sorted(d):
        out.append(prefix + k)
        if isinstance(d[k], dict) and k != "jit_cache_entries":
            out += _key_tree(d[k], prefix + k + ".")
    return out


@pytest.mark.parametrize("engine,merge", STREAMS)
def test_recovery_across_packages(tmp_path, engine, merge):
    """(b) A directory written by either package and abandoned mid-stream
    recovers in the other with `items()` equal to the writer's own
    recovery; (c) the recovery counters and the `metrics()` key tree are
    equal."""
    j, t = _both_durable(tmp_path, engine, merge)
    # a tail of writes after the last checkpoint, then the crash
    tail = np.arange(1, 41, 2, dtype=np.float64) + 9000
    for ix in (j, t):
        ix.upsert(tail, np.arange(len(tail), dtype=np.int64))
        ix.delete(_stream_keys()[:16])
        ix.abandon()
    for src in ("j", "t"):
        d = tmp_path / src / "dur"
        for reader in ("j", "t"):
            shutil.copytree(d, tmp_path / f"{src}_by_{reader}")
    rec = {(src, reader): _recover(JA if reader == "j" else TA,
                                   tmp_path / f"{src}_by_{reader}")
           for src in ("j", "t") for reader in ("j", "t")}
    try:
        own = rec[("j", "j")].items()
        for key, rx in rec.items():
            _same_items(rx.items(), own)
            assert rx.engine == engine
        for src in ("j", "t"):
            mj = rec[(src, "j")].metrics()
            mt = rec[(src, "t")].metrics()
            assert mt["counters"]["recovery.count"] == 1
            for c in ("recovery.count", "recovery.replayed_records"):
                assert mt["counters"][c] == mj["counters"][c], (src, c)
            assert mt["counters"]["recovery.replayed_records"] >= 2
            assert _key_tree(mt) == _key_tree(mj)
            assert (rec[(src, "t")].inspect()["wal"]
                    == rec[(src, "j")].inspect()["wal"])
    finally:
        for rx in rec.values():
            rx.close()


def _event_names(doc):
    out: dict = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _event_tree(doc):
    tree = {}
    for e in doc["traceEvents"]:
        keys = (tuple(sorted(e)), tuple(sorted(e.get("args", {}))))
        tree.setdefault((e["ph"], e["name"]), set()).add(keys)
    return tree


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_with_durability_armed(tmp_path, engine):
    """(e) With durability armed, the `dili.trace/1` key tree equals the
    reference's and holds one `wal.append` per write, on track "wal"."""
    keys = _stream_keys()
    docs = []
    for pkg, sub in ((JA, "j"), (TA, "t")):
        cfg = pkg.IndexConfig(
            engine=engine, telemetry=True, overlay_cap=128,
            merge=pkg.manual_merge_policy(),
            durability=pkg.DurabilityConfig(dir=str(tmp_path / sub / "d")))
        ix = _build(pkg, keys, None, cfg)
        ix.start_trace()
        for i in range(4):
            ix.upsert(keys[i * 8: i * 8 + 8] + 1.0, np.arange(8))
            ix.delete(keys[100 + i: 101 + i])
        ix.flush()
        ix.lookup(keys[:64])
        ix.stop_trace()
        path = tmp_path / f"{sub}.json"
        ix.dump_trace(str(path))
        ix.close()
        with open(path) as f:
            docs.append(json.load(f))
    dj, dt = docs
    assert _event_tree(dt) == _event_tree(dj)
    assert _event_names(dt) == _event_names(dj)
    names = _event_names(dt)
    assert names["wal.append"] == 8
    assert names["wal.append"] == names["op.upsert"] + names["op.delete"]
    wal_ev = [e for e in dt["traceEvents"]
              if e["ph"] == "X" and e["name"] == "wal.append"]
    tracks = {e["tid"] for e in dt["traceEvents"]
              if e["ph"] == "M" and e.get("args", {}).get("name") == "wal"}
    assert tracks and {e["tid"] for e in wal_ev} <= tracks


# ---------------------------------------------------------------------------
# ft: the tensor-state checkpoints (tests/test_ft_checkpoint.py)
# ---------------------------------------------------------------------------


def _state(step: int) -> dict:
    return dict(w=torch.full((4, 3), float(step), dtype=torch.float64),
                b=torch.arange(3, dtype=torch.float64) + step)


def _template() -> dict:
    return dict(w=torch.zeros((4, 3), dtype=torch.float64),
                b=torch.zeros(3, dtype=torch.float64))


def _flip_byte(path: str, frac: float = 0.5) -> None:
    blob = bytearray(open(path, "rb").read())
    blob[int(len(blob) * frac)] ^= 0xFF
    open(path, "wb").write(bytes(blob))


def _restore(d):
    return ftck.restore(d, _template(), **CPU)


def test_ft_restore_skips_corrupt_shard_npz(tmp_path):
    d = str(tmp_path)
    ftck.save(d, 1, _state(1))
    ftck.save(d, 2, _state(2))
    _flip_byte(os.path.join(d, ftck.step_name(2), "shard_00000.npz"))
    state, manifest = _restore(d)
    assert manifest["step"] == 1
    assert torch.equal(state["w"], _state(1)["w"])


def test_ft_restore_skips_mangled_manifest(tmp_path):
    d = str(tmp_path)
    ftck.save(d, 1, _state(1))
    ftck.save(d, 2, _state(2))
    with open(os.path.join(d, ftck.step_name(2), "manifest.json"), "w") as f:
        f.write("{not json")
    state, manifest = _restore(d)
    assert manifest["step"] == 1
    assert torch.equal(state["b"], _state(1)["b"])


def test_ft_restore_checksum_catches_inplace_bitflip(tmp_path):
    d = str(tmp_path)
    ftck.save(d, 1, _state(1))
    ftck.save(d, 2, _state(2))
    npz = os.path.join(d, ftck.step_name(2), "shard_00000.npz")
    data = dict(np.load(npz))
    data["leaf_00000"] = data["leaf_00000"].copy()
    data["leaf_00000"].flat[0] += 1.0
    np.savez(npz, **data)
    state, manifest = _restore(d)
    assert manifest["step"] == 1


def test_ft_restore_ignores_stale_latest_pointer(tmp_path):
    d = str(tmp_path)
    ftck.save(d, 1, _state(1))
    ftck.save(d, 2, _state(2))
    ftck.write_latest(d, ftck.step_name(7))
    state, manifest = _restore(d)
    assert manifest["step"] == 2


def test_ft_restore_nothing_valid_returns_none(tmp_path):
    d = str(tmp_path)
    assert _restore(d) == (None, None)
    ftck.save(d, 1, _state(1))
    _flip_byte(os.path.join(d, ftck.step_name(1), "shard_00000.npz"))
    assert _restore(d) == (None, None)


def test_ft_tmp_dirs_are_never_candidates(tmp_path):
    d = str(tmp_path)
    ftck.save(d, 1, _state(1))
    tmp = ftck.make_tmp_dir(d, ftck.step_name(2))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(dict(step=2), f)
    assert ftck.step_candidates(d) == [ftck.step_name(1)]
    _, manifest = _restore(d)
    assert manifest["step"] == 1


def _nested(step):
    """A train-state-like tree: nested dicts, a list, two dtypes."""
    return dict(params=dict(dense=dict(w=torch.arange(6.0).reshape(2, 3)
                                       + step,
                                       b=torch.zeros(3) + step),
                            emb=torch.arange(4, dtype=torch.float64)),
                opt=[torch.tensor([step], dtype=torch.int64),
                     torch.ones(2, 2) * step],
                step=torch.tensor(step, dtype=torch.int32))


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_np(v) for v in tree]
    return tree.numpy()


def test_ft_checkpoint_across_packages(tmp_path):
    """A checkpoint written by either package restores in the other: the
    leaf paths, order and checksums in the manifest are the reference's."""
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    ftck.save(dt, 3, _nested(3), extra=dict(seed=1))
    J_ftck.save(dj, 3, _to_np(_nested(3)), extra=dict(seed=1))
    mt = json.load(open(os.path.join(dt, ftck.step_name(3),
                                     "manifest.json")))
    mj = json.load(open(os.path.join(dj, J_ftck.step_name(3),
                                     "manifest.json")))
    assert mt == mj
    assert mt["paths"][0] == "opt/0" and "params/dense/w" in mt["paths"]
    want = _nested(3)
    for d in (dt, dj):
        got, m = ftck.restore(d, _nested(0), **CPU)
        assert m["extra"] == dict(seed=1)
        for p, (g, w) in zip(("opt/0", "opt/1"), zip(got["opt"],
                                                      want["opt"])):
            assert torch.equal(g, w) and g.dtype == w.dtype, p
        assert torch.equal(got["params"]["dense"]["w"],
                           want["params"]["dense"]["w"])
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
        # a sub-tree restores by prefix
        sub, _ = ftck.restore(d, _nested(0)["params"], prefix="params", **CPU)
        assert torch.equal(sub["emb"], want["params"]["emb"])
        jgot, _ = J_ftck.restore(d, _to_np(_nested(0)))
        np.testing.assert_array_equal(np.asarray(jgot["opt"][1]),
                                      want["opt"][1].numpy())
