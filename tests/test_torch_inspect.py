"""The port's `LearnedIndex.inspect()` and causal trace export against the
JAX package's, on the CPU.

`inspect()` is computed from host columns (the published `FlatDILI`, the
splice flattener's segment rows, the accounting's heat), so after the
same call sequence the port's `dili.inspect/1` document equals the
reference's value for value, on the three engines (the sharded one on a
single shard, as the reference's in this one-device process), with
maintenance on and off.  The `dili.trace/1` export holds wall times, so there the key
tree, the event names and their counts are compared, not the times.
"""
import json

import numpy as np
import pytest

from repro import api as JA
from repro_torch import api as TA
from repro_torch.obs import INSPECT_SCHEMA_VERSION, TRACE_SCHEMA_VERSION

ENGINES = ("local", "pallas", "sharded")


def _universe(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 10 * n, n)).astype(np.float64)
    return keys, np.arange(len(keys), dtype=np.int64)


def _churn(ix, keys, seed=2, rounds=4):
    """The reference test's write/merge churn (its tests/test_inspect_trace
    `_churn`), so inspect has segments, heat and an overlay to report."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        ks = rng.integers(1, 10 * len(keys), 512).astype(np.float64)
        ix.upsert(ks, np.arange(512))
        ix.delete(ks[:32])
    ix.flush()
    ix.lookup(keys[:128])


def _shape(d, prefix=""):
    out = []
    for k in sorted(d):
        out.append(prefix + k)
        if isinstance(d[k], dict):
            out += _shape(d[k], prefix + k + ".")
    return out


def _build_both(engine, maintenance, **kw):
    keys, vals = _universe()
    out = []
    for pkg, dev in ((JA, {}), (TA, {"device": "cpu"})):
        m = pkg.MaintenanceConfig(retrain=False, recluster=True) \
            if maintenance else None
        out.append(pkg.LearnedIndex.build(keys, vals, config=pkg.IndexConfig(
            engine=engine, telemetry=True, overlay_cap=1024,
            maintenance=m, **kw), **dev))
    return keys, out


@pytest.mark.parametrize("maintenance", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_inspect_document_equals_reference(engine, maintenance):
    keys, (j, t) = _build_both(engine, maintenance)
    docs = []
    for ix in (j, t):
        _churn(ix, keys)
        ix.upsert(keys[:40] + 0.5, np.arange(40))      # leave some pending
        ix.delete(keys[50:60])
        docs.append(ix.inspect())
    dj, dt = docs
    json.dumps(dt)
    assert dt["schema"] == INSPECT_SCHEMA_VERSION
    assert dt["engine"] == engine and dt["n_shards"] == 1
    assert _shape(dt) == _shape(dj)
    assert dt == dj
    assert dt["overlay"]["pending"] == 50
    assert not dt["wal"]["armed"]                     # the unarmed block
    if maintenance:
        assert dt["segments"]["n_segments"] > 0 and dt["heat"]["n_tracked"]
    gj, gt = (ix.metrics()["gauges"] for ix in (j, t))
    assert gj == gt and gt["inspect.total_rows"] > 0
    for ix in (j, t):
        ix.close()


def test_inspect_values_sane():
    """The reference's value checks, on the port's local engine with
    re-clustering on."""
    keys, (_, ix) = _build_both("local", True)
    _churn(ix, keys)
    doc = ix.inspect()
    t, lv = doc["tree"], doc["leaves"]
    assert sum(t["depth_hist"]) == t["n_nodes"]
    assert 1 <= len(t["depth_hist"]) <= t["max_depth"] + 1
    assert t["n_pairs"] >= len(keys)
    assert lv["n_leaves"] + lv["n_internal"] == t["n_nodes"]
    assert 0.0 <= lv["fill"]["p50"] <= lv["fill"]["max"] <= 1.0
    me = doc["model_error"]
    assert 0 < me["sampled"] <= t["n_pairs"]
    assert me["overall"]["max"] <= t["n_slots"]
    seg = doc["segments"]
    assert seg["n_segments"] > 0 and seg["dirty_rows"] <= seg["total_rows"]
    assert doc["heat"]["n_tracked"] > 0 and doc["heat"]["writes"]["max"] >= 1
    assert doc["overlay"]["cap"] == 1024 and doc["overlay"]["pending"] == 0
    ix.close()


def _trace(ix, keys, path):
    ix.start_trace()
    ix.lookup(keys[:64])
    ix.range(keys[:8], keys[4:12], max_hits=8)
    _churn(ix, keys, rounds=2)
    ix.stop_trace()
    meta = ix.dump_trace(str(path))
    with open(path) as fh:
        return meta, json.load(fh)


def _event_tree(doc):
    """{(ph, name): sorted keys of the event and of its args}."""
    tree = {}
    for e in doc["traceEvents"]:
        keys = (tuple(sorted(e)), tuple(sorted(e.get("args", {}))))
        tree.setdefault((e["ph"], e["name"]), set()).add(keys)
    return tree


def _names(doc):
    out: dict = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


@pytest.mark.parametrize("maintenance", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_trace_export_key_tree_equals_reference(engine, maintenance,
                                                tmp_path):
    """`start_trace`/`dump_trace` write a `dili.trace/1` document whose
    key tree, event names and counts (facade `op.*` slices, `merge.*`
    spans) equal the reference's for the same calls; after `stop_trace`
    the buffer no longer grows."""
    keys, (j, t) = _build_both(engine, maintenance)
    out = [_trace(ix, keys, tmp_path / f"{i}.json")
           for i, ix in enumerate((j, t))]
    (mj, dj), (mt, dt) = out
    assert dt["otherData"]["schema"] == TRACE_SCHEMA_VERSION
    assert set(mt) == set(mj) and set(dt) == set(dj)
    assert set(dt["otherData"]) == set(dj["otherData"])
    assert _event_tree(dt) == _event_tree(dj)
    assert _names(dt) == _names(dj)
    names = _names(dt)
    assert {"op.lookup", "op.range", "op.upsert", "op.delete",
            "merge.fold", "merge.flatten", "merge.publish"} <= set(names)
    if maintenance:
        assert {"merge.retrain", "merge.recluster"} <= set(names)
    n = t.telemetry.trace.n_events
    t.lookup(keys[:64])
    assert t.telemetry.trace.n_events == n
    for ix in (j, t):
        ix.close()


def test_trace_background_merge_spans(tmp_path):
    """With background maintenance the merge spans are recorded on the
    worker thread and still land in the armed trace."""
    keys, vals = _universe()
    ix = TA.LearnedIndex.build(keys, vals, config=TA.IndexConfig(
        telemetry=True, overlay_cap=1024, merge=TA.MergePolicy(
            max_writes=600),
        maintenance=TA.MaintenanceConfig(background=True)), device="cpu")
    _, doc = _trace(ix, keys, tmp_path / "bg.json")
    names = _names(doc)
    assert {"merge.queue_wait", "merge.fold", "merge.retrain",
            "merge.recluster", "merge.flatten", "merge.publish",
            "merge.frozen_dwell"} <= set(names)
    assert ix.stats()["maint_errors"] == 0
    ix.close()
