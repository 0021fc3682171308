"""Crash injection on the port: a child process builds a durable index,
replays a fixed op stream and SIGKILLs itself at an armed point
(`DILI_CRASH_POINT="<point>:<n>"`, `repro_torch.durability.hooks`); the
parent recovers the directory and holds `items()` and a lookup of the
base keys to an oracle fed exactly the acknowledged-durable prefix.

The base data, the op stream and the kill-point matrix are copies of
tests/crashkit.py's (a test holds them equal), so the reference's child
and the port's write the same directory: the cross tests recover each
package's crash in the other.

This file is also the port's crash child, for the CPU and the GPU alike:

    python tests/test_torch_crash.py child --engine local --dir D \\
        --device cuda                       # with DILI_CRASH_POINT set
    python tests/test_torch_crash.py matrix --engine local --device cuda

At module level it imports only numpy, pytest and `repro_torch`;
the JAX package is imported inside the cross tests alone.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

SELF = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(os.path.dirname(SELF)), "src")
if SRC not in sys.path:                      # standalone invocation
    sys.path.insert(0, SRC)

from repro_torch.api import (DurabilityConfig, IndexConfig,  # noqa: E402
                             LearnedIndex, manual_merge_policy)
from repro_torch.workloads.oracle import SortedOracle  # noqa: E402

# -- the deterministic workload (tests/crashkit.py's) -------------------------

BASE_SEED, OPS_SEED = 77, 123
N_BASE = 1200
N_BATCHES = 6          # batch = one upsert op + one delete op
FLUSH_AFTER_OPS = 6    # ops before the explicit flush (=> checkpoint hit 2)


def base_data() -> tuple[np.ndarray, np.ndarray]:
    """Integer-valued keys < 2^21 (f32-exact for the pallas engine) and
    int32-range vals (the pallas payload width)."""
    rng = np.random.default_rng(BASE_SEED)
    keys = np.unique(rng.integers(0, 1 << 21, N_BASE)).astype(np.float64)
    vals = rng.integers(0, 1 << 30, len(keys)).astype(np.int64)
    return keys, vals


def gen_ops() -> list[tuple[str, np.ndarray, np.ndarray | None]]:
    """The fixed op stream: [("upsert", keys, vals) | ("delete", keys,
    None), ...].  One op = one facade call = one WAL record: the ported
    engines log to one WAL shard."""
    base, _ = base_data()
    rng = np.random.default_rng(OPS_SEED)
    ops = []
    for _ in range(N_BATCHES):
        pick = rng.choice(len(base), 40, replace=False)
        up_k = np.unique(np.concatenate([
            base[pick[:20]],                 # updates of existing keys
            base[pick[20:]] + 0.5]))         # fresh keys (0.5: f32-exact)
        up_v = rng.integers(0, 1 << 30, len(up_k)).astype(np.int64)
        ops.append(("upsert", up_k, up_v))
        ops.append(("delete", base[rng.choice(len(base), 8, replace=False)],
                    None))
    return ops


#: the sharded engine's shard count in the child (per-shard WALs), as the
#: reference's crash matrix runs its sharded child on 4 devices
SHARDED_SHARDS = 4


def make_config(engine: str, dur_dir: str) -> IndexConfig:
    # manual merges + explicit flush: the checkpoint-hit schedule is then
    # deterministic (hit 1 = build base, hit 2 = first flush's publish)
    return IndexConfig(engine=engine, merge=manual_merge_policy(),
                       overlay_cap=256,
                       n_shards=SHARDED_SHARDS if engine == "sharded"
                       else None,
                       durability=DurabilityConfig(dir=dur_dir,
                                                   fsync="always"))


# -- expected recovered state -------------------------------------------------


def oracle_after_ops(n_ops: int) -> SortedOracle:
    """SortedOracle fed the base data + the first `n_ops` ops."""
    oracle = SortedOracle(*base_data())
    for op, k, v in gen_ops()[:n_ops]:
        if op == "upsert":
            oracle.upsert(k, v)
        else:
            oracle.delete(k)
    return oracle


def expected_oracle(point: str, hits: int) -> SortedOracle:
    """The acknowledged-durable prefix for a kill at `point:hits`."""
    if point == "wal.append":
        # the n-th write's append completed, nothing after it ran
        return oracle_after_ops(hits)
    if point == "wal.mid_record":
        # records 1..n-1 are durable; the n-th is torn (one record per op)
        return oracle_after_ops(hits - 1)
    if point in ("ckpt.pre_publish", "ckpt.mid_publish"):
        # hit 2 = the post-first-flush checkpoint: every op before the
        # flush was WAL-appended; the checkpoint itself must not matter
        assert hits == 2, "checkpoint points target the first flush"
        return oracle_after_ops(FLUSH_AFTER_OPS)
    raise ValueError(f"unknown crash point {point!r}")


def matrix_points() -> list[tuple[str, int]]:
    """The kill-point matrix: every injection point, both before and
    after the first checkpoint where the point allows it."""
    return [
        ("wal.append", 2),                    # pre-checkpoint tail
        ("wal.append", FLUSH_AFTER_OPS + 3),  # post-checkpoint tail
        ("wal.mid_record", 3),                # torn record, pre-checkpoint
        ("wal.mid_record", FLUSH_AFTER_OPS + 1),  # torn first record
        ("ckpt.pre_publish", 2),
        ("ckpt.mid_publish", 2),
    ]


# -- child --------------------------------------------------------------------


def child_main(engine: str, dur_dir: str, device: str) -> int:
    keys, vals = base_data()
    ix = LearnedIndex.build(keys, vals, config=make_config(engine, dur_dir),
                            device=device)
    for i, (op, k, v) in enumerate(gen_ops()):
        if op == "upsert":
            ix.upsert(k, v)
        else:
            ix.delete(k)
        if i + 1 == FLUSH_AFTER_OPS:
            ix.flush()                       # merge publish -> checkpoint
    ix.flush()
    ix.close()
    return 3          # reachable only if the armed crash point never fired


def spawn_child(engine: str, dur_dir: str, point: str, hits: int,
                device: str = "cpu") -> subprocess.CompletedProcess:
    env = dict(os.environ, DILI_CRASH_POINT=f"{point}:{hits}",
               PYTHONPATH=os.pathsep.join(
                   [SRC] + [p for p in (os.environ.get("PYTHONPATH"),)
                            if p]))
    return subprocess.run(
        [sys.executable, SELF, "child", "--engine", engine,
         "--dir", dur_dir, "--device", device],
        env=env, capture_output=True, text=True, timeout=600)


# -- parent: run one point / the whole matrix ---------------------------------


def check_recovered(ix, oracle: SortedOracle, label: str) -> None:
    """`items()` bit-equal to the oracle, and a lookup of every base key
    (hits and deleted ones) equal to the oracle's."""
    k, v = ix.items()
    ok, ov = oracle.items()
    np.testing.assert_array_equal(k, ok, err_msg=f"{label} recovered keys")
    np.testing.assert_array_equal(v, ov, err_msg=f"{label} recovered vals")
    q = np.concatenate([base_data()[0], gen_ops()[0][1]])
    got_v, got_f = ix.lookup(q)
    want_v, want_f = oracle.lookup(q)
    np.testing.assert_array_equal(got_f, want_f, err_msg=f"{label} found")
    np.testing.assert_array_equal(got_v[got_f], want_v[want_f],
                                  err_msg=f"{label} lookup vals")


def run_point(engine: str, dur_dir: str, point: str, hits: int,
              device: str = "cpu") -> dict:
    """Spawn, kill, recover on `device`, diff.  Returns a result dict;
    raises AssertionError on any divergence from the oracle."""
    proc = spawn_child(engine, dur_dir, point, hits, device)
    assert proc.returncode == -9, (
        f"{engine}/{point}:{hits}: child exited {proc.returncode} instead "
        f"of dying at the crash point\n{proc.stdout}\n{proc.stderr}")
    ix = LearnedIndex.recover(dur_dir, device=device)
    try:
        check_recovered(ix, expected_oracle(point, hits),
                        f"{engine}/{point}:{hits}")
        replayed = int(ix.metrics()["counters"]
                       ["recovery.replayed_records"])
        n_items = len(ix.items()[0])
    finally:
        ix.close()
    return dict(engine=engine, point=point, hits=hits, n_items=n_items,
                replayed_records=replayed)


def run_matrix(engine: str, tmp_root: str, device: str = "cpu",
               points=None) -> list[dict]:
    results = []
    for point, hits in points or matrix_points():
        d = os.path.join(tmp_root,
                         f"{engine}_{point.replace('.', '_')}_{hits}")
        results.append(run_point(engine, d, point, hits, device))
        print(f"[crash] ok {results[-1]}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("child", "matrix"):
        p = sub.add_parser(mode)
        p.add_argument("--engine", default="local")
        p.add_argument("--dir", default=None)
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "child":
        return child_main(args.engine, args.dir, args.device)
    import tempfile
    root = args.dir or tempfile.mkdtemp(prefix="crash_")
    run_matrix(args.engine, root, args.device)
    print(f"[crash] matrix passed for engine={args.engine} on "
          f"{args.device}")
    return 0


# -- tests --------------------------------------------------------------------

ENGINES = ("local", "pallas")
POST_CKPT_POINTS = (("wal.append", FLUSH_AFTER_OPS + 3),
                    ("wal.mid_record", FLUSH_AFTER_OPS + 1))
# the sharded engine's points: a write splits into one record per shard,
# so only the points that count facade writes or checkpoints apply
SHARDED_POINTS = (("wal.append", FLUSH_AFTER_OPS + 3),
                  ("ckpt.mid_publish", 2))


def test_workload_is_crashkits():
    """The base data, op stream, flush point and kill-point matrix are the
    reference kit's, and the ported engines log one record per write."""
    import crashkit
    for a, b in zip(base_data(), crashkit.base_data()):
        np.testing.assert_array_equal(a, b)
    ops, ref_ops = gen_ops(), crashkit.gen_ops()
    assert len(ops) == len(ref_ops)
    for (op, k, v), (rop, rk, rv) in zip(ops, ref_ops):
        assert op == rop
        np.testing.assert_array_equal(k, rk)
        assert (v is None) == (rv is None)
        if v is not None:
            np.testing.assert_array_equal(v, rv)
    assert FLUSH_AFTER_OPS == crashkit.FLUSH_AFTER_OPS
    for engine in ENGINES:
        assert matrix_points() == crashkit.matrix_points(engine)
        sched = crashkit.append_schedule(engine)
        assert [i for i, *_ in sched] == list(range(len(ops)))


@pytest.mark.slow
@pytest.mark.parametrize("point,hits", matrix_points())
@pytest.mark.parametrize("engine", ENGINES)
def test_crash_matrix(tmp_path, engine, point, hits):
    """Every kill point recovers to exactly the acknowledged prefix on
    both ported engines."""
    r = run_point(engine, str(tmp_path / "dur"), point, hits)
    if (point, hits) == ("wal.append", 2):
        assert r["replayed_records"] >= 2     # pre-checkpoint tail replayed


@pytest.mark.slow
@pytest.mark.parametrize("point,hits", SHARDED_POINTS)
def test_sharded_crash_recovers_in_both(tmp_path, point, hits):
    """The sharded engine's child (4 shards, one WAL each) dies at a
    point; the port recovers it on 4 shards, and the reference, on this
    process's one JAX device, recovers it elastically onto one shard."""
    import shutil
    from repro.api import LearnedIndex as JLearnedIndex
    d = str(tmp_path / "dur")
    proc = spawn_child("sharded", d, point, hits)
    assert proc.returncode == -9, proc.stderr[-4000:]
    shutil.copytree(d, str(tmp_path / "copy"))
    assert len(os.listdir(os.path.join(d, "wal"))) == SHARDED_SHARDS
    want = expected_oracle(point, hits)
    ix = LearnedIndex.recover(d, device="cpu")
    try:
        assert ix.stats()["n_shards"] == SHARDED_SHARDS
        check_recovered(ix, want, "port, 4 shards")
    finally:
        ix.close()
    jx = JLearnedIndex.recover(str(tmp_path / "copy"))
    try:
        assert jx.stats()["n_shards"] == 1
        k, v = jx.items()
        np.testing.assert_array_equal(k, want.items()[0])
        np.testing.assert_array_equal(v, want.items()[1])
    finally:
        jx.close()


@pytest.mark.slow
@pytest.mark.parametrize("point,hits", POST_CKPT_POINTS)
def test_reference_crash_recovers_in_port(tmp_path, point, hits):
    """The reference's child (tests/crashkit.py, unchanged) dies at a
    post-checkpoint point; the port recovers its directory."""
    import crashkit
    d = str(tmp_path / "dur")
    proc = crashkit.spawn_child("local", d, point, hits)
    assert proc.returncode == -9, proc.stderr[-4000:]
    want = crashkit.expected_oracle("local", point, hits)
    ix = LearnedIndex.recover(d, device="cpu")
    try:
        check_recovered(ix, expected_oracle(point, hits), "port")
        np.testing.assert_array_equal(ix.items()[0], want.items()[0])
        np.testing.assert_array_equal(ix.items()[1], want.items()[1])
    finally:
        ix.close()


@pytest.mark.slow
@pytest.mark.parametrize("point,hits", POST_CKPT_POINTS)
def test_port_crash_recovers_in_reference(tmp_path, point, hits):
    """The port's child dies at a post-checkpoint point; the reference
    recovers its directory."""
    from repro.api import LearnedIndex as JLearnedIndex
    d = str(tmp_path / "dur")
    proc = spawn_child("local", d, point, hits)
    assert proc.returncode == -9, proc.stderr[-4000:]
    want = expected_oracle(point, hits)
    jx = JLearnedIndex.recover(d)
    try:
        k, v = jx.items()
        np.testing.assert_array_equal(k, want.items()[0])
        np.testing.assert_array_equal(v, want.items()[1])
        # the tail after the flush's checkpoint, less a torn record
        assert int(jx.metrics()["counters"]["recovery.replayed_records"]) \
            == hits - FLUSH_AFTER_OPS - (point == "wal.mid_record")
    finally:
        jx.close()


if __name__ == "__main__":
    sys.exit(main())
