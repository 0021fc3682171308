"""The stage spans inside a lookup call and a full flatten (the port only,
on the CPU): one of each stage per call or per `merge.flatten`, in order,
not overlapping, inside the interval that holds them, and a lookup's
`lookup.overlay` inside its `lookup.stage`; nothing with
telemetry off; the ring keeps the last `RING_SPANS` spans; and the
`dili.metrics/1` span keys and `dili.trace/1` event names are the same
whether stage spans are recorded or not."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.api import IndexConfig, LearnedIndex
from repro_torch.core.dili import bulk_load
from repro_torch.core.flat import flatten
from repro_torch.maintain import MaintenanceConfig
from repro_torch.obs.tracing import (FLATTEN_STAGES, LOOKUP_STAGES,
                                     MERGE_SPANS, OVERLAY_STAGES,
                                     RECOVERY_SPANS, RING_SPANS,
                                     SPLICE_STAGES, Span, SpanRecorder)


@pytest.fixture(scope="module")
def keys():
    return np.unique(np.random.default_rng(7).lognormal(0, 1, 4000))


def _build(keys, telemetry=True, **kw):
    return LearnedIndex.build(keys, config=IndexConfig(telemetry=telemetry,
                                                       **kw), device="cpu")


def _inside(ix, a, b):
    return [s for s in ix.telemetry.spans.spans() if a <= s.t0 <= b]


def _in_order_and_disjoint(spans, names, a, b):
    assert [s.name for s in spans] == list(names)
    for s, nxt in zip(spans, spans[1:]):
        assert s.t0 + s.dur_s <= nxt.t0
    assert a <= spans[0].t0 and spans[-1].t0 + spans[-1].dur_s <= b
    assert all(s.dur_s >= 0 for s in spans)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lookup_records_each_stage_once_in_order(keys, dtype):
    ix = _build(keys, dtype=dtype)
    ix.upsert(keys[:5] + 1e-3, np.arange(5))     # an overlay to stage
    ix.lookup(keys[:100])                         # warm
    a = time.perf_counter()
    ix.lookup(keys[100:1100])
    b = time.perf_counter()
    spans = _inside(ix, a, b)
    _in_order_and_disjoint([s for s in spans if s.name in LOOKUP_STAGES],
                           LOOKUP_STAGES, a, b)
    stage, = [s for s in spans if s.name == "lookup.stage"]
    overlay, = [s for s in spans if s.name not in LOOKUP_STAGES]
    assert overlay.name == OVERLAY_STAGES[0]
    assert stage.t0 <= overlay.t0
    assert overlay.t0 + overlay.dur_s <= stage.t0 + stage.dur_s
    ix.close()


def test_forced_merge_records_each_flatten_stage_inside_it(keys):
    ix = _build(keys)
    ix.upsert(keys[:50] + 1e-3, np.arange(50))
    a = time.perf_counter()
    ix.flush()
    b = time.perf_counter()
    spans = _inside(ix, a, b)
    flat = [s for s in spans if s.name == "merge.flatten"]
    assert len(flat) == 1
    f0, f1 = flat[0].t0, flat[0].t0 + flat[0].dur_s
    stages = [s for s in spans if s.name.startswith("flatten.")]
    _in_order_and_disjoint(stages, FLATTEN_STAGES, f0, f1)
    assert not [s for s in spans if s.name.startswith("lookup.")]
    ix.close()


@pytest.mark.parametrize("local_optimized", [True, False])
def test_flatten_stage_hook_records_in_order_and_changes_nothing(
        keys, local_optimized):
    d = bulk_load(keys, local_optimized=local_optimized)
    want = flatten(d)
    rec = SpanRecorder()
    a = time.perf_counter()
    got = flatten(d, rec.stage)
    b = time.perf_counter()
    _in_order_and_disjoint(rec.spans(), FLATTEN_STAGES, a, b)
    for f in dataclasses.fields(want):
        x, y = getattr(want, f.name), getattr(got, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def test_telemetry_off_records_nothing(keys):
    ix = _build(keys, telemetry=False)
    ix.lookup(keys[:100])
    ix.upsert(keys[:50] + 1e-3, np.arange(50))
    ix.flush()
    ix.lookup(keys[:100])
    assert ix.telemetry.spans.spans() == []
    ix.close()


def _calls(ix, keys, path):
    ix.start_trace()
    ix.lookup(keys[:64])
    ix.upsert(keys[:50] + 1e-3, np.arange(50))
    ix.flush()
    ix.lookup(keys[:64])
    ix.stop_trace()
    ix.dump_trace(str(path))
    with open(path) as fh:
        names = sorted({e["name"] for e in json.load(fh)["traceEvents"]})
    return set(ix.metrics()["spans"]), names


def test_stage_spans_leave_metrics_and_trace_unchanged(keys, tmp_path):
    on = _build(keys)
    off = _build(keys)
    off.telemetry.spans.stage = lambda *a: None    # the same calls, no stages
    got = _calls(on, keys, tmp_path / "on.json")
    want = _calls(off, keys, tmp_path / "off.json")
    assert got == want
    assert got[0] == set(MERGE_SPANS + RECOVERY_SPANS)
    stages = LOOKUP_STAGES + OVERLAY_STAGES + FLATTEN_STAGES + SPLICE_STAGES
    assert not set(got[1]) & set(stages)
    assert {s.name for s in on.telemetry.spans.spans()} >= \
        set(LOOKUP_STAGES + OVERLAY_STAGES + FLATTEN_STAGES)
    assert all(on.telemetry.spans.count(n) == 0 for n in stages)
    for ix in (on, off):
        ix.close()


def test_splice_stage_spans_leave_metrics_and_trace_unchanged(keys,
                                                              tmp_path):
    """The same with background maintenance, whose merges splice-flatten
    on the worker."""
    cfg = dict(maintenance=MaintenanceConfig(background=True))
    on = _build(keys, **cfg)
    off = _build(keys, **cfg)
    off.telemetry.spans.stage = lambda *a: None
    got = _calls(on, keys, tmp_path / "on.json")
    assert got == _calls(off, keys, tmp_path / "off.json")
    stages = SPLICE_STAGES + OVERLAY_STAGES
    assert not set(got[1]) & set(stages)
    assert {s.name for s in on.telemetry.spans.spans()} >= set(stages)
    assert all(on.telemetry.spans.count(n) == 0 for n in stages)
    for ix in (on, off):
        ix.close()


def test_ring_keeps_the_last_ring_spans():
    assert RING_SPANS == 1 << 18
    rec = SpanRecorder()
    extra = 5
    for i in range(RING_SPANS + extra):
        rec.stage("lookup.check", float(i), i + 0.5)
    ring = rec.spans()
    assert len(ring) == RING_SPANS
    assert ring[0].t0 == extra and ring[-1].t0 == RING_SPANS + extra - 1
    assert ring[-1].dur_s == 0.5


def test_span_has_fixed_slots_and_shares_empty_attrs():
    rec = SpanRecorder()
    rec.record("merge.fold", 0.1, t0=1.0)
    rec.record("merge.fold", 0.2, t0=2.0, reason="fill")
    rec.stage("flatten.tables", 3.0, 3.5)
    a, b, c = rec.spans()
    assert not hasattr(a, "__dict__") and "__slots__" in vars(Span)
    assert a.attrs is c.attrs and dict(a.attrs) == {}
    assert dict(b.attrs) == {"reason": "fill"}
    assert rec.count("merge.fold") == 2 and rec.count("flatten.tables") == 0
