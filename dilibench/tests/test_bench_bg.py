"""The background-maintenance cell `ycsb-250k-bg.a` on the CPU: its
configuration parses to background maintenance, a run cut to 20,000
records is correct with merges in its window and wrong on the program's
f32 path, and the readers of the splice and overlay-resolve stage spans
(`metrics/splice_*_ms.py`, `metrics/lookup_overlay_ms.py`) read that
run's spans, read exact values on hand-made records, and read nothing
where the spans are missing."""

import copy
import time
from dataclasses import replace

import pytest

from dilibench import harness, manifest as M
from dilibench.splice import SPLICE_STAGES
from dilibench.trace import CallRec, Records

CELL = "ycsb-250k-bg.a"
SPLICE_READERS = {"splice_refresh_ms": 3.0, "splice_walks_ms": 0.7,
                  "splice_assemble_ms": 0.5}
READERS = {**SPLICE_READERS, "lookup_overlay_ms": 0.15}


def test_config_parses_to_background_maintenance():
    cell = M.cell(CELL)
    cfg = harness.index_config(cell.config["index"], False, None)
    assert cfg.maintenance is not None and cfg.maintenance.background
    assert cfg.maintenance.incremental and cfg.maintenance.retrain
    assert cfg.maintenance.recluster and cfg.engine == "local"
    assert [m["name"] for m in cell.end_to_end] == ["mixed_ops_s",
                                                    "write_p95_ms", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {"build_s", *READERS}


def _small():
    c = M.cell(CELL)
    cfg = copy.deepcopy(c.config)
    cfg["data"]["n_keys"] = 20_000
    return replace(c, config=cfg)


@pytest.fixture(scope="module")
def runs():
    """An untraced and a traced run of the cell at 20,000 records, 3-s
    windows, with what each logged."""
    out = {}
    for trace in (False, True):
        log: list[str] = []
        r = harness.run_cell(_small(), 2**33 + 17, 3.0, trace, "cpu",
                             time.perf_counter(), log=log.append)
        out[trace] = (r, log)
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_and_merges(runs, trace):
    r, log = runs[trace]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    merges = int(next(m for m in log if m.startswith("window")).split(
        " ops, ")[1].split()[0])
    assert merges >= 1


def test_untraced_run_reports_the_end_to_end_metrics(runs):
    r, _ = runs[False]
    assert set(r["metrics"]) == {"mixed_ops_s", "write_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_control_f32_is_not_correct():
    """The program's f32 path on the same cut: the comparison that decides
    `correct` finds it wrong."""
    r = harness.run_cell(_small(), 2**33 + 19, 1.0, False, "cpu",
                         time.perf_counter(), overrides={"dtype": "float32"},
                         log=lambda msg: None)
    assert not r["correct"] and r["check"]["wrong_lanes"]["value"] > 0


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_traced_run(runs, name):
    r, _ = runs[True]
    assert r["metrics"][name]["value"] > 0


def _records():
    """Two lookup calls, each with its `lookup.overlay` span, and two
    merges whose splice flattens end in the window (ms: units 0.2 / 0.1,
    refresh 4 / 2, offsets 0.6 / 0.5, assemble 0.6 / 0.4; overlay 0.1 /
    0.2)."""
    calls = [CallRec("lookup", 0.000, 0.001, 512, 0, True),
             CallRec("upsert", 0.001, 0.0012, 512, 1, True),
             CallRec("lookup", 0.002, 0.003, 512, 2, True)]
    spans = [("lookup.stage", 0.0001, 0.0003),
             ("lookup.overlay", 0.0001, 0.0001),
             ("lookup.stage", 0.0021, 0.0003),
             ("lookup.overlay", 0.0021, 0.0002),
             ("merge.flatten", 0.004, 0.0055),
             ("merge.flatten", 0.011, 0.0031)]
    for a, bounds in ((0.004, (0.0002, 0.004, 0.0006, 0.0006)),
                      (0.011, (0.0001, 0.002, 0.0005, 0.0004))):
        for name, d in zip(SPLICE_STAGES, bounds):
            spans.append((name, a, d))
            a += d
    return Records("x", 10.0, 8.0, (0.0, 0.020), calls, merges=2,
                   spans=spans)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_exact_value(name):
    assert M.reader(name)(_records()) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_none_without_its_spans(name):
    rec = _records()
    rec.spans = [s for s in rec.spans
                 if not s[0].startswith(("splice.", "lookup.overlay"))]
    assert M.reader(name)(rec) is None       # the parent program's records
    rec.spans = []
    assert M.reader(name)(rec) is None


@pytest.mark.parametrize("stage", SPLICE_STAGES)
@pytest.mark.parametrize("name", sorted(SPLICE_READERS))
def test_splice_reader_none_when_a_flatten_lacks_a_stage(name, stage):
    rec = _records()
    at = [i for i, s in enumerate(rec.spans) if s[0] == stage][1]
    rec.spans = rec.spans[:at] + rec.spans[at + 1:]
    assert M.reader(name)(rec) is None


@pytest.mark.parametrize("name", sorted(SPLICE_READERS))
def test_splice_reader_drops_a_flatten_that_ends_after_the_window(name):
    """A merge the worker began in the window and finished after it: the
    harness kept its `merge.flatten` (it starts in the window) and only its
    first stage (the rest start after the window's end)."""
    rec = _records()
    want = M.reader(name)(rec)
    rec.spans += [("merge.flatten", 0.019, 0.004),
                  ("splice.units", 0.019, 0.0005)]
    assert M.reader(name)(rec) == pytest.approx(want)
    rec.window = (0.0, 0.024)
    assert M.reader(name)(rec) is None


def test_lookup_overlay_reader_none_when_a_call_lacks_it():
    rec = _records()
    rec.spans = [s for s in rec.spans
                 if not (s[0] == "lookup.overlay" and s[1] > 0.002)]
    assert M.reader("lookup_overlay_ms")(rec) is None
