"""The stage spans inside the incremental (splice) flatten and around the
overlay resolve of a lookup (the port only, on the CPU): the four splice
stages once each, in order, inside one flatten, whose `FlatDILI` is the
same with the hook, without it and from `core.flat.flatten`; one
`lookup.overlay` per lookup, nested in its `lookup.stage`, with a
background merge held in flight and without one; nothing with telemetry
off; the same answers either way."""
import dataclasses
import pickle
import threading
import time

import numpy as np
import pytest

from repro_torch.core.dili import bulk_load
from repro_torch.core.flat import flatten
from repro_torch.maintain import IncrementalFlattener, MaintenanceConfig
from repro_torch.obs import Telemetry
from repro_torch.obs.tracing import (OVERLAY_STAGES, SPLICE_STAGES,
                                     SpanRecorder)
from repro_torch.online.merge import MergePolicy, OnlineIndex

N_KEYS = 20_000
NO_AUTO = MergePolicy(max_fill=1.0, max_writes=1 << 40,
                      pressure_check_every=1 << 40)


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(11)
    return np.unique(rng.integers(0, 1 << 40, N_KEYS)).astype(np.float64)


@pytest.fixture(scope="module")
def tree_bytes(keys):
    """The one build of the module, pickled: each test unpickles its own
    copy, since merges mutate the tree."""
    return pickle.dumps(bulk_load(keys, np.arange(len(keys))))


def _writes(keys, seed, n=600):
    """Updates of loaded keys and inserts of new ones, spread over the key
    range so that they dirty many segments."""
    rng = np.random.default_rng(seed)
    upd = keys[rng.choice(len(keys), n, replace=False)]
    ins = np.setdiff1d(rng.integers(0, 1 << 40, n // 2).astype(np.float64),
                       keys)
    k = np.concatenate([upd, ins])
    return k, np.arange(len(k), dtype=np.int64) + 1_000_000


def _flat_equal(got, want, msg):
    for f in dataclasses.fields(want):
        x, y = getattr(want, f.name), getattr(got, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), (msg, f.name)
        else:
            assert x == y, (msg, f.name)


@pytest.mark.parametrize("cache", ["cold", "warm"])
def test_splice_stage_hook_records_in_order_and_changes_nothing(
        keys, tree_bytes, cache):
    d = pickle.loads(tree_bytes)
    hooked, plain = IncrementalFlattener(), IncrementalFlattener()
    if cache == "warm":
        dirty = d.take_dirty()
        for fl in (hooked, plain):
            fl.flatten(d, set(dirty))
    for k, v in zip(*_writes(keys, 3)):
        d.upsert(float(k), int(v))
    dirty = d.take_dirty()
    assert dirty
    rec = SpanRecorder()
    a = time.perf_counter()
    got = hooked.flatten(d, set(dirty), rec.stage)
    b = time.perf_counter()
    spans = rec.spans()
    assert [s.name for s in spans] == list(SPLICE_STAGES)
    for s, nxt in zip(spans, spans[1:]):
        assert s.t0 + s.dur_s <= nxt.t0
    assert a <= spans[0].t0 and spans[-1].t0 + spans[-1].dur_s <= b
    assert all(s.dur_s >= 0 for s in spans)
    if cache == "warm":
        assert hooked.last_incremental
        assert 0 < hooked.last_dirty_segments < hooked.last_total_segments
    _flat_equal(got, plain.flatten(d, set(dirty)), "splice without hook")
    _flat_equal(got, flatten(d), "full flatten")


def _inside(spans, name, a, b):
    return [s for s in spans if s.name == name and a <= s.t0 <= b]


@pytest.mark.parametrize("in_flight", [False, True])
@pytest.mark.parametrize("telemetry", [True, False])
def test_overlay_resolve_span_once_per_lookup(keys, tree_bytes, telemetry,
                                              in_flight):
    ix = OnlineIndex(dili=pickle.loads(tree_bytes), policy=NO_AUTO,
                     maintenance=MaintenanceConfig(background=True),
                     telemetry=Telemetry(enabled=telemetry), device="cpu")
    truth = dict(zip(keys.tolist(), range(len(keys))))
    gate = threading.Event()
    try:
        k1, v1 = _writes(keys, 5)
        ix.upsert_batch(k1, v1)
        truth.update(zip(k1.tolist(), v1.tolist()))
        if in_flight:
            assert ix.scheduler.submit(gate.wait)   # holds the worker
            ix.merge("explicit")
            assert ix._merging is not None        # frozen overlay installed
            k2, v2 = _writes(keys, 6)
            ix.upsert_batch(k2, v2 + 1_000_000)
            truth.update(zip(k2.tolist(), (v2 + 1_000_000).tolist()))
        q = np.concatenate([np.fromiter(truth, np.float64), [-1.0, 2.0**41]])
        want_v = np.array([truth.get(x, 0) for x in q.tolist()])
        want_f = np.array([x in truth for x in q.tolist()])
        n = 3
        a = time.perf_counter()
        for _ in range(n):
            v, f = ix.lookup(q)
            assert np.array_equal(f, want_f)
            assert np.array_equal(v[f], want_v[f])
        b = time.perf_counter()
        assert (ix._merging is not None) == in_flight
        spans = ix.tel.spans.spans()
        ov = _inside(spans, "lookup.overlay", a, b)
        stage = _inside(spans, "lookup.stage", a, b)
        if not telemetry:
            assert spans == []
        else:
            assert len(ov) == len(stage) == n
            for o, s in zip(ov, stage):
                assert s.t0 <= o.t0 and o.t0 + o.dur_s <= s.t0 + s.dur_s
            assert ix.tel.spans.count(OVERLAY_STAGES[0]) == 0
    finally:
        gate.set()
    ix.flush()
    v, f = ix.lookup(q)
    assert np.array_equal(f, want_f) and np.array_equal(v[f], want_v[f])
    spans = ix.tel.spans.spans()
    if telemetry and in_flight:
        # the held merge ran on the worker: its splice stages lie in order
        # inside its merge.flatten
        last = [s for s in spans if s.name == "merge.flatten"][-1]
        f0, f1 = last.t0, last.t0 + last.dur_s
        stages = [s for s in spans if s.name.startswith("splice.")
                  and f0 <= s.t0 <= f1]
        assert [s.name for s in stages] == list(SPLICE_STAGES)
        assert stages[-1].t0 + stages[-1].dur_s <= f1
    if not telemetry:
        assert spans == []
    ix.close()


@pytest.mark.parametrize("cache", ["cold", "warm"])
def test_worker_pause_points_change_nothing(keys, tree_bytes, cache):
    """The fold and the splice given a `pause` (the worker's yield to
    write calls) call it and give the tree and the `FlatDILI` they give
    without one."""
    from repro_torch.maintain import LeafAccounting
    from repro_torch.maintain.accounting import fold_with_accounting
    from repro_torch.online.overlay import TombstoneOverlay
    calls = []
    trees = [pickle.loads(tree_bytes) for _ in range(2)]
    fls = [IncrementalFlattener(), IncrementalFlattener()]
    if cache == "warm":
        for d, fl in zip(trees, fls):
            fl.flatten(d, d.take_dirty())
    ov = TombstoneOverlay.empty(64).upsert_batch(*_writes(keys, 7))
    flats, counts = [], []
    for d, fl, pause in zip(trees, fls, (lambda: calls.append(1), None)):
        fold_with_accounting(d, ov, LeafAccounting(MaintenanceConfig()),
                             pause)
        counts.append(len(calls))
        flats.append(fl.flatten(d, d.take_dirty(), pause=pause))
        counts.append(len(calls))
    assert counts[0] >= ov.count // 8         # the fold's pause points
    assert counts[1] > counts[0]              # the splice's
    _flat_equal(flats[0], flats[1], "splice with pause")
    _flat_equal(flats[0], flatten(trees[0]), "full flatten")


def test_background_merge_waits_while_a_write_runs(keys, tree_bytes):
    """While a write call runs (`_writing` set, as `upsert_batch` sets it
    on the writer's thread) the worker's merge parks at its first pause
    point; it finishes once the write has returned, and reads are exact
    throughout."""
    ix = OnlineIndex(dili=pickle.loads(tree_bytes), policy=NO_AUTO,
                     maintenance=MaintenanceConfig(background=True),
                     device="cpu")
    k, v = _writes(keys, 8)
    ix.upsert_batch(k, v)
    try:
        ix._writing = True
        ix.merge("explicit")
        time.sleep(0.3)
        assert ix._merging is not None and ix.n_merges == 0
        got_v, got_f = ix.lookup(k)
        assert got_f.all() and np.array_equal(got_v, v)
    finally:
        ix._writing = False
    ix.scheduler.drain()
    assert ix._merging is None and ix.n_merges == 1
    got_v, got_f = ix.lookup(k)
    assert got_f.all() and np.array_equal(got_v, v)
    ix.close()
