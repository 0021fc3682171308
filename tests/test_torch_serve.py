"""The port's serving front-end (`repro_torch.serve`), `SessionTable` and
`RecordStore` against the JAX package's, on the CPU.

The scenarios of tests/test_serve.py, the SessionTable tests of
tests/test_serve.py, tests/test_pipeline_serve.py and tests/test_online.py,
and tests/test_pipeline_serve.py::test_record_store_roundtrip run on the
port (`device="cpu"`).  Where an answer is deterministic (coalesced
groups, the AIMD trajectory, a stub's call log and journal, slot
allocation, a record fetch) the reference computes it too and the two
must be equal.  The concurrent runs cannot be repeated bit for bit, so
their commit-order journal (from either package's front-end) is replayed
through each package's `WorkloadRunner` (oracle-checked) on a fresh
index, and both replays must end with exactly the served index's
`items()`.

Unlike the reference's test of span declaration, the metrics are read
only after `fe.close()`: the batcher releases a request's waiter before it
records `serve.e2e.<op>`, so a client that reads the metrics at once can
see the count still at 0.

Client write keys are odd (the generator convention: the loaded universe
is even integers), disjoint per client, and < 2^24 so the pallas
engine's f32 quantization is exact.
"""
import json
import sys
import threading
from collections import deque

import numpy as np
import pytest

from repro import api as JA
from repro import serve as JS
from repro.data.record_store import RecordStore as JRecordStore
from repro.workloads import generator as JG
from repro.workloads.runner import WorkloadRunner as JRunner
from repro_torch import api as TA
from repro_torch import serve as TS
from repro_torch.data.record_store import RecordStore as TRecordStore
from repro_torch.obs.tracing import MERGE_SPANS, RECOVERY_SPANS, SERVE_SPANS
from repro_torch.workloads import generator as TG
from repro_torch.workloads.generator import PRESETS, generate_stream
from repro_torch.workloads.runner import WorkloadRunner as TRunner

ENGINES = ("local", "pallas", "sharded")


# -- stub-index layer (no engine) ---------------------------------------------

class StubIndex:
    """Records facade calls; optionally blocks inside the first call so a
    test can fill the admission queue while the worker is busy."""

    telemetry = None

    def __init__(self, gate: threading.Event | None = None):
        self.calls: list[tuple] = []
        self.gate = gate
        self.entered = threading.Event()

    def _enter(self):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(30.0)
            self.gate = None            # only the first call blocks

    def lookup(self, q):
        self._enter()
        self.calls.append(("lookup", len(q)))
        return np.asarray(q, np.int64), np.ones(len(q), bool)

    def range(self, lo, hi, max_hits=64):
        self._enter()
        self.calls.append(("range", len(lo), max_hits))
        n = len(lo)
        return (np.full((n, max_hits), np.inf),
                np.full((n, max_hits), -1, np.int64),
                np.zeros(n, np.int64))

    def upsert(self, keys, vals):
        self._enter()
        self.calls.append(("upsert", len(keys)))

    def delete(self, keys):
        self._enter()
        self.calls.append(("delete", len(keys)))


def req(pkg, op, n=1, max_hits=64, **kw):
    if op == "range":
        return pkg.Request(op, lo=np.zeros(n), hi=np.ones(n),
                           max_hits=max_hits, **kw)
    return pkg.Request(op, keys=np.arange(n, dtype=np.float64),
                       vals=np.zeros(n, np.int64) if op == "upsert"
                       else None, **kw)


def test_pow2_bucket_matches_facade_padding():
    """`pow2_bucket(n)` is the port facade's `_pad_batch(n)` and the
    reference's `pow2_bucket(n)` for every n in 1..10,000."""
    ix = TA.LearnedIndex.build(np.arange(8.0), device="cpu")
    try:
        for n in range(1, 10_001):
            assert TS.pow2_bucket(n) == ix._pad_batch(n) == \
                JS.pow2_bucket(n), n
    finally:
        ix.close()


def _coalesce_groups(pkg):
    out = []
    d = deque([req(pkg, "lookup", 10), req(pkg, "lookup", 20),
               req(pkg, "upsert", 5), req(pkg, "lookup", 3)])
    g = pkg.coalesce(d, cap_ops=64)
    assert [r.op for r in g] == ["lookup", "lookup"]   # stops at upsert
    out.append([(r.op, r.n_ops) for r in g])
    assert pkg.coalesce(d, 64)[0].op == "upsert"
    # cap: the head is always taken, the next 20-op req would exceed 25
    d = deque([req(pkg, "lookup", 10), req(pkg, "lookup", 20)])
    assert len(pkg.coalesce(d, cap_ops=25)) == 1 and len(d) == 1
    # oversized head still dispatches alone
    d = deque([req(pkg, "lookup", 100)])
    assert len(pkg.coalesce(d, cap_ops=64)) == 1
    # ranges only coalesce on matching max_hits
    d = deque([req(pkg, "range", 4, max_hits=64),
               req(pkg, "range", 4, max_hits=64),
               req(pkg, "range", 4, max_hits=8)])
    g = pkg.coalesce(d, 64)
    assert len(g) == 2 and d[0].max_hits == 8
    out.append([(r.op, r.n_ops, r.max_hits) for r in g])
    return out


def test_coalesce_op_homogeneity_and_cap():
    assert _coalesce_groups(TS) == _coalesce_groups(JS)


def _aimd_trajectory(pkg):
    cfg = pkg.ServeConfig(min_batch_ops=64, max_batch_ops=2048,
                          latency_slo_s=0.010, aimd_add_ops=64)
    s = pkg.AdaptiveBatchSizer(cfg)
    out = []
    # scripted arrivals: sustained queue pressure, fast service -> grow
    # additively to the ceiling
    for _ in range(100):
        s.observe(queue_depth_ops=4096, service_s=0.001)
        out.append(s.target)
    assert s.target == cfg.max_batch_ops
    # one slow batch halves; floor is respected under repeated violations
    s.observe(4096, 0.100)
    assert s.target == cfg.max_batch_ops // 2
    for _ in range(20):
        s.observe(0, 0.100)
        out.append(s.target)
    assert s.target == cfg.min_batch_ops
    # the dispatch cap is always a pow2 facade bucket within bounds
    for depth in (0, 100, 500, 5000):
        s.observe(depth, 0.001)
        cap = s.cap
        assert cap & (cap - 1) == 0
        assert cfg.min_batch_ops <= cap <= cfg.max_batch_ops
        out.append((s.target, cap))
    return out


def test_aimd_sizer_converges_and_pow2_caps():
    assert _aimd_trajectory(TS) == _aimd_trajectory(JS)


def test_admission_control_sheds_above_bound():
    gate = threading.Event()
    stub = StubIndex(gate=gate)
    b = TS.RequestBatcher(stub, TS.ServeConfig(queue_cap_ops=8, dwell_s=0.0))
    try:
        b.submit(req(TS, "lookup", 1))      # worker picks this up...
        assert stub.entered.wait(10.0)      # ...and blocks inside it
        for _ in range(8):                  # fill the queue to the bound
            b.submit(req(TS, "lookup", 1))
        with pytest.raises(TS.RejectedError):
            b.submit(req(TS, "lookup", 1))
        assert b.n_shed == 1
        gate.set()
        b.drain(30.0)
        assert b.n_completed == 9 and b.n_failed == 0
        s = b.stats()
        assert s["shed_ops"] == 1 and 0 < s["shed_frac"] < 1
    finally:
        gate.set()
        b.close()


def _fifo_run(pkg):
    gate = threading.Event()
    stub = StubIndex(gate=gate)
    b = pkg.RequestBatcher(stub, pkg.ServeConfig(dwell_s=0.0))
    try:
        b.submit(req(pkg, "lookup", 1))     # occupy the worker
        assert stub.entered.wait(10.0)
        rs = [b.submit(r) for r in
              (req(pkg, "lookup", 2), req(pkg, "lookup", 3),
               req(pkg, "upsert", 4), req(pkg, "lookup", 5),
               req(pkg, "delete", 6))]
        gate.set()
        b.drain(30.0)
        v, f = rs[0].wait(1.0)
        assert len(v) == 2 and f.all()      # sliced back per request
        v, f = rs[1].wait(1.0)
        assert len(v) == 3
        journal = [(j.op, j.n_ops, None if j.keys is None else
                    j.keys.tolist()) for j in b.journal]
        return stub.calls, journal
    finally:
        gate.set()
        b.close()


def test_batcher_fifo_coalescing_and_journal():
    calls, journal = _fifo_run(TS)
    # deterministic grouping of the queued prefix: the two lookups
    # coalesce, the write ops break the runs
    assert calls == [("lookup", 1), ("lookup", 5), ("upsert", 4),
                     ("lookup", 5), ("delete", 6)]
    assert [(op, n) for op, n, _ in journal] == \
        [("lookup", 1), ("lookup", 5), ("upsert", 4), ("lookup", 5),
         ("delete", 6)]
    assert (calls, journal) == _fifo_run(JS)


def test_batcher_error_fans_out_to_waiters():
    class Exploding(StubIndex):
        def upsert(self, keys, vals):
            raise RuntimeError("boom")

    b = TS.RequestBatcher(Exploding(), TS.ServeConfig(dwell_s=0.0))
    try:
        r = b.submit(req(TS, "upsert", 3))
        with pytest.raises(RuntimeError, match="boom"):
            r.wait(10.0)
        assert b.n_failed == 3
        v, f = b.submit(req(TS, "lookup", 2)).wait(10.0)   # worker survives
        assert f.all()
    finally:
        b.close()


def test_closed_batcher_rejects_submits():
    b = TS.RequestBatcher(StubIndex(), TS.ServeConfig(dwell_s=0.0))
    b.close()
    with pytest.raises(RuntimeError):
        b.submit(req(TS, "lookup", 1))


def _key_tree(d, prefix=""):
    out = []
    for k in sorted(d):
        out.append(prefix + k)
        if isinstance(d[k], dict) and k != "jit_cache_entries":
            out += _key_tree(d[k], prefix + k + ".")
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_serve_spans_declared_only_on_attach(engine):
    """The serve taxonomy appears in `metrics()` once a frontend attaches,
    and one served lookup is counted.  The counts are read after
    `fe.close()`, when the batch has finished recording them; the key
    tree equals the reference's."""
    trees = []
    for api, kw in ((TA, {"device": "cpu"}), (JA, {})):
        ix = api.LearnedIndex.build(np.arange(32.0), config=api.IndexConfig(
            engine=engine, telemetry=True), **kw)
        pkg = TS if api is TA else JS
        try:
            base_snap = ix.metrics()
            if api is TA:
                assert set(base_snap["spans"]) == set(MERGE_SPANS
                                                      + RECOVERY_SPANS)
                assert base_snap["serve"] == {}   # bare index: no serve block
            fe = pkg.ServeFrontend(ix)
            fe.client("c").lookup([0.0])
            fe.close()
            snap = ix.metrics()
            trees.append(_key_tree(snap))
            if api is JA:
                continue
            assert set(snap["spans"]) == \
                set(MERGE_SPANS + RECOVERY_SPANS) | set(SERVE_SPANS)
            for op in ("lookup", "range", "upsert", "delete"):
                assert f"serve.e2e.{op}" in snap["serve"]
            assert snap["serve"]["serve.e2e.lookup"]["count"] >= 1
            assert snap["serve"]["serve.batch.ops"]["count"] >= 1
            assert snap["spans"]["serve.exec"]["count"] >= 1
        finally:
            ix.close()
    assert trees[0] == trees[1]


# -- engine layer: the concurrency contract -----------------------------------

def _client_program(fe, ci, keys, n, errors, writes_log):
    """One seeded client stream: lookups/ranges over the loaded universe,
    upserts/deletes over a client-private odd key range, with inline
    read-your-acknowledged-writes assertions."""
    try:
        c = fe.client(f"client-{ci}")
        r = np.random.default_rng(1000 + ci)
        base = float(2 * n + 1 + 2_000_000 * ci)     # odd, disjoint, < 2^24
        live: list[tuple[float, int]] = []
        for step in range(24):
            choice = int(r.integers(0, 4))
            if choice == 0:
                q = keys[r.integers(0, n, 8)]
                v, f = c.lookup(q)
                assert f.all(), "loaded even keys are never deleted"
            elif choice == 1:
                lo = keys[r.integers(0, n, 4)]
                ks, vs, cnt = c.range(lo, lo + 64.0)
                assert (cnt >= 1).all()              # lo itself is live
            elif choice == 2:
                k, v = base + 2 * step, ci * 1000 + step
                c.upsert([k], [v])
                live.append((k, v))
                got = c.get(k)                       # read-your-writes
                assert got == v, (ci, step, got, v)
            elif live:
                k, _ = live.pop(int(r.integers(0, len(live))))
                c.delete([k])
                assert c.get(k) is None, (ci, k)
        writes_log[ci] = live
    except BaseException as e:                       # noqa: BLE001
        errors.append((ci, e))


def _cfg(api, engine):
    # the port's sharded engine serves on 8 shards; the reference, on one
    # JAX device, clamps the same config to one shard
    return api.IndexConfig(engine=engine,
                           n_shards=8 if engine == "sharded" else None)


@pytest.mark.parametrize("served_by", ["port", "ref"])
@pytest.mark.parametrize("engine", ENGINES)
def test_multi_client_oracle_equivalence(engine, served_by):
    """>= 4 concurrent client streams through one package's front-end;
    the journal's serialization replayed on a fresh index of each package
    must match the served index bit-exactly."""
    n = 4000 if engine == "local" else 1500
    keys = np.arange(0, 2 * n, 2, dtype=np.float64)
    vals = np.arange(n, dtype=np.int64)
    api, pkg, kw = ((TA, TS, {"device": "cpu"}) if served_by == "port"
                    else (JA, JS, {}))
    ix = api.LearnedIndex.build(keys, vals, config=_cfg(api, engine), **kw)
    fe = pkg.ServeFrontend(ix, pkg.ServeConfig(dwell_s=2e-4))
    errors: list = []
    writes_log: dict = {}
    threads = [threading.Thread(target=_client_program,
                                args=(fe, ci, keys, n, errors, writes_log))
               for ci in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    fe.drain()
    journal = fe.journal_batches()
    stats = fe.stats()
    fe.close()
    assert not errors, errors[:2]
    assert stats["failed_ops"] == 0 and stats["shed_ops"] == 0
    assert stats["n_batches"] >= 1 and journal

    # replay the committed interleaving, oracle-checked batch by batch
    k1, v1 = ix.items()
    fresh_t = TA.LearnedIndex.build(keys, vals, config=_cfg(TA, engine),
                                    device="cpu")
    fresh_j = JA.LearnedIndex.build(keys, vals, config=_cfg(JA, engine))
    try:
        for runner, fresh, batch in ((TRunner, fresh_t, TG.OpBatch),
                                     (JRunner, fresh_j, JG.OpBatch)):
            rep = runner(fresh).run(
                [batch(b.op, keys=b.keys, vals=b.vals, lo=b.lo, hi=b.hi)
                 for b in journal], name=f"serve-{engine}")
            assert rep.n_ops == stats["completed_ops"]
            k2, v2 = fresh.items()
            assert np.array_equal(k1, k2) and np.array_equal(v1, v2), \
                "concurrent run diverged from its own journal's replay"
        # every surviving acknowledged write is in the final content
        for ci, live in writes_log.items():
            for k, v in live:
                i = np.searchsorted(k1, k)
                assert i < len(k1) and k1[i] == k and v1[i] == v, (ci, k)
    finally:
        fresh_t.close()
        fresh_j.close()
        ix.close()


def test_stats_metrics_safe_to_sample_under_load():
    """Hammer `stats()`/`metrics()`/frontend stats from sampler threads
    while the batcher serves a write-heavy mix.

    On the CPU a lookup is the kernel's plain version, hundreds of small
    torch ops that each release the GIL; with the samplers spinning in
    Python, each op would wait out a whole switch interval (5 ms) to get
    it back.  The interval is cut for this test so that the worker does
    not starve; the samplers run as tight as in the reference."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _hammer()
    finally:
        sys.setswitchinterval(old)


def _hammer():
    n = 2000
    keys = np.arange(0, 2 * n, 2, dtype=np.float64)
    ix = TA.LearnedIndex.build(keys, config=TA.IndexConfig(
        engine="local", telemetry=True, overlay_cap=64), device="cpu")
    fe = TS.ServeFrontend(ix, TS.ServeConfig(dwell_s=1e-4))
    stop = threading.Event()
    errors: list = []

    def sampler():
        try:
            while not stop.is_set():
                json.dumps(ix.metrics())     # full snapshot must be JSON-able
                ix.stats()
                fe.stats()
        except BaseException as e:           # noqa: BLE001
            errors.append(e)

    def writer(ci):
        try:
            c = fe.client(f"w{ci}")
            base = 2 * n + 1 + 100_000 * ci
            for i in range(60):
                c.upsert([float(base + 2 * i)], [i])
                c.lookup(keys[(7 * i) % n: (7 * i) % n + 4])
                if i % 3 == 2:
                    c.delete([float(base + 2 * (i - 1))])
        except BaseException as e:           # noqa: BLE001
            errors.append(e)

    samplers = [threading.Thread(target=sampler) for _ in range(2)]
    writers = [threading.Thread(target=writer, args=(ci,))
               for ci in range(2)]
    for t in samplers + writers:
        t.start()
    for t in writers:
        t.join(120.0)
    stop.set()
    for t in samplers:
        t.join(30.0)
    fe.close()
    ix.close()
    assert not errors, errors[:2]


@pytest.mark.parametrize("engine", ["local", "sharded"])
def test_open_loop_low_rate_completes_everything(engine):
    n = 2000
    keys = np.arange(0, 2 * n, 2, dtype=np.float64)
    ix = TA.LearnedIndex.build(keys, config=_cfg(TA, engine), device="cpu")
    fe = TS.ServeFrontend(ix, TS.ServeConfig(dwell_s=1e-4), journal=False)
    try:
        spec = PRESETS["ycsb_a"].scaled(n_ops=400, batch_size=8, seed=3)
        stream = generate_stream(spec, keys)
        rep = TS.open_loop(fe, stream, rate_ops_per_s=2000.0, n_clients=4,
                           timeout_s=60.0)
        assert rep.shed_ops == 0 and rep.failed_ops == 0
        assert rep.done_ops == rep.n_ops
        lat = rep.latency_ms()
        assert lat["lookup"]["count"] > 0
        assert lat["lookup"]["ms_p99"] >= lat["lookup"]["ms_p50"] > 0
        json.dumps(rep.to_json_dict())
        with pytest.raises(RuntimeError, match="journal=False"):
            fe.journal_batches()
    finally:
        fe.close()
        ix.close()


def test_saturation_search_ramps_until_it_stops_keeping_up():
    """The ramp multiplies the offered rate while legs keep up and returns
    the best achieved rate; streams continue leg to leg."""
    n = 2000
    keys = np.arange(0, 2 * n, 2, dtype=np.float64)
    ix = TA.LearnedIndex.build(keys, device="cpu")
    fe = TS.ServeFrontend(ix, TS.ServeConfig(dwell_s=1e-4), journal=False)
    try:
        def make(leg):
            spec = PRESETS["ycsb_a"].scaled(n_ops=64, batch_size=8,
                                            seed=10 + leg)
            return generate_stream(spec, keys)
        sat, legs = TS.saturation_search(fe, make, start_rate=500.0,
                                         factor=2.0, max_legs=3)
        assert 1 <= len(legs) <= 3
        assert sat == max(l.achieved_ops_per_s for l in legs) > 0
        rates = [l.offered_ops_per_s for l in legs]
        assert rates == [500.0 * 2 ** i for i in range(len(legs))]
    finally:
        fe.close()
        ix.close()


# -- session table -----------------------------------------------------------

@pytest.mark.parametrize("engine", ["local", "sharded"])
def test_session_table_concurrent_admit_evict(engine):
    st = TS.SessionTable(n_slots=64, config=TA.IndexConfig(
        engine=engine, overlay_cap=64,
        merge=TA.MergePolicy(max_fill=1.0, max_writes=256)), device="cpu")
    fe = TS.ServeFrontend(st.index)
    try:
        st.serve_through(fe)
        ids = [float(100 + i) for i in range(40)]
        slots: dict = {}
        errors: list = []

        def admit_some(chunk):
            try:
                for sid in chunk:
                    slots[sid] = st.admit(sid)
            except BaseException as e:       # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=admit_some, args=(ids[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not errors, errors[:2]
        # no slot handed out twice (incl. the warm sessions' slots)
        assert len(set(slots.values())) == len(ids)
        got, found = st.lookup_batch(ids)
        assert found.all()
        assert {float(s) for s in got} == {float(s)
                                           for s in slots.values()}

        # same-id contention: exactly one admit wins
        outcomes: list = []

        def race():
            try:
                outcomes.append(st.admit(999.0))
            except KeyError:
                outcomes.append("dup")

        racers = [threading.Thread(target=race) for _ in range(6)]
        for t in racers:
            t.start()
        for t in racers:
            t.join(60.0)
        assert sum(1 for o in outcomes if o != "dup") == 1

        def evict_some(chunk):
            for sid in chunk:
                st.evict(sid)

        threads = [threading.Thread(target=evict_some, args=(ids[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        _, found = st.lookup_batch(ids)
        assert not found.any()
    finally:
        fe.close()
        st.index.close()


def _session_pair(n_slots, **kw):
    """The same SessionTable in both packages (the port's on the CPU)."""
    jkw, tkw = dict(kw), dict(kw)
    if "policy" in kw:
        jkw["policy"] = JA.MergePolicy(**kw["policy"])
        tkw["policy"] = TA.MergePolicy(**kw["policy"])
    return (JS.SessionTable(n_slots, **jkw),
            TS.SessionTable(n_slots, device="cpu", **tkw))


def _both_lookup(j, t, ids):
    out = t.lookup_batch(ids)
    for a, b in zip(j.lookup_batch(ids), out):
        np.testing.assert_array_equal(a, b)
    return out


def test_session_table_admit_lookup_evict():
    j, t = _session_pair(16)
    for st in (j, t):
        s1 = st.admit(100.5)
        s2 = st.admit(200.5)
        assert s1 != s2
    v, f = _both_lookup(j, t, [100.5, 200.5, 300.5])
    assert list(f) == [True, True, False]
    assert list(v[:2]) == [s1, s2]
    for st in (j, t):
        st.evict(100.5)
    v, f = _both_lookup(j, t, [100.5])
    assert not f[0]
    # slot is recycled
    assert j.admit(300.5) == t.admit(300.5) == s1
    with pytest.raises(KeyError):
        t.admit(300.5)
    with pytest.raises(KeyError):
        t.evict(999.0)


def test_session_table_exhaustion():
    t = TS.SessionTable(3, device="cpu")      # 2 warm ids + 1 free
    t.admit(50.0)
    with pytest.raises(RuntimeError):
        t.admit(60.0)
    with pytest.raises(ValueError, match="not both"):
        TS.SessionTable(3, policy=TA.MergePolicy(), config=TA.IndexConfig(),
                        device="cpu")


def test_session_table_one_flatten_per_merge_epoch():
    """One flatten per merge epoch, not per write, with the same merges
    and the same slots as the reference's table."""
    j, t = _session_pair(512, policy=dict(max_fill=1.1, max_writes=40))
    live: dict[float, int] = {}
    n_ops = 0
    for i in range(160):                       # sustained admit/evict loop
        sid = 1000.0 + i
        live[sid] = t.admit(sid)
        assert j.admit(sid) == live[sid]
        n_ops += 1
        if i % 3 == 2:                         # evict every third session
            victim = sorted(live)[0]
            for st in (j, t):
                st.evict(victim)
            live.pop(victim)
            n_ops += 1
        if i % 20 == 0:                        # correct between merges too
            probe = list(live)[:16]
            v, f = _both_lookup(j, t, probe)
            assert f.all()
            assert all(v[k] == live[s] for k, s in enumerate(probe))
            gone = 1000.0 + i + 5000
            _, f2 = _both_lookup(j, t, [gone])
            assert not f2[0]
    # at most one flatten per merge epoch (plus the initial publish)
    assert t.publish_count == 1 + t.index.n_merges == j.publish_count
    assert t.publish_count <= n_ops // 40 + 2
    assert n_ops > 4 * t.publish_count
    v, f = _both_lookup(j, t, sorted(live))
    assert f.all()


def test_session_table_admit_evict_semantics_via_overlay():
    """Duplicate admits / missing evicts must be caught while the state is
    still overlay-only (before any merge)."""
    t = TS.SessionTable(16, policy=TA.MergePolicy(max_fill=1.1,
                                                  max_writes=10**9),
                        device="cpu")
    s = t.admit(100.5)
    with pytest.raises(KeyError):
        t.admit(100.5)                 # live in overlay only
    t.evict(100.5)
    with pytest.raises(KeyError):
        t.evict(100.5)                 # tombstoned in overlay only
    s2 = t.admit(100.5)                # re-admit after evict
    assert s2 == s                     # slot recycled
    assert t.publish_count == 1        # no merge happened at all


# -- record store ------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_record_store_roundtrip(engine):
    rng = np.random.default_rng(6)
    keys = np.unique(rng.uniform(0, 1e6, 500))
    if engine == "pallas":                 # the f32 key domain
        keys = np.unique(keys.astype(np.float32)).astype(np.float64)
    docs = [rng.integers(0, 100, rng.integers(5, 40)).astype(np.int32)
            for _ in keys]
    stores = []
    for api, cls, kw in ((TA, TRecordStore, {"device": "cpu"}),
                         (JA, JRecordStore, {})):
        cfg = api.IndexConfig(engine=engine, sample_stride=4,
                              merge=api.manual_merge_policy())
        stores.append(cls(keys, docs, config=cfg, **kw))
    t, j = stores
    for i in rng.integers(0, len(keys), 50):
        got = t.fetch(float(keys[i]))
        np.testing.assert_array_equal(got, docs[i])
    # batched lookup agreement, with the reference's too
    q = np.concatenate([keys[:64], keys[:8] + 0.5])
    out = t.lookup(q)
    assert out[2][:64].all()
    for a, b in zip(j.lookup(q), out):
        np.testing.assert_array_equal(a, b)
    # write path + publish
    for s in stores:
        s.add(2e6, np.arange(7, dtype=np.int32))
        s.publish()
    np.testing.assert_array_equal(t.fetch(2e6), np.arange(7))
    np.testing.assert_array_equal(t.fetch(2e6, pad_to=10),
                                  j.fetch(2e6, pad_to=10))
    assert t.fetch(3e6) is None
