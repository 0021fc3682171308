"""`BENCHMARK.json` against the benchmark's contract, the harness's lookup
of configurations, mixes and metric readers by name, and the arithmetic
of the readers on hand-made records."""

import json
import shutil

import pytest

from dilibench import manifest as M
from dilibench.peaks import HBM_BYTES_S, distinct_found, lookup_bytes
from dilibench.trace import CallRec, Records, busy_s, idle_gaps

BENCH = M.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert M.NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert M.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(names) - 1 <= 4
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        e2e = {m["name"] for m in M.cell(cell).end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert M.cell(cell).per_layer


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers: dict = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert M.reports(e2e[m["moves"]], cell, BENCH), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(len(layer) < 64 for layer in layers)


def test_every_cell_takes_one_chip_and_each_pair_appears_once():
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_configs_files_and_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"dilibench/configs/{c['name']}.json"
        body = json.loads((M.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert all(k in body for k in c["reduced"])
    assert BENCH["paths"] == ["dilibench"]
    assert BENCH["command"] == ["python3", "dilibench/run.py"]


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    c = M.cell(cell)
    assert c.config["data"] and c.traffic["spec"]
    for m in c.end_to_end + c.per_layer:
        assert callable(M.reader(m["name"]))


def test_new_files_are_picked_up_without_edits(tmp_path):
    here = tmp_path / "dilibench"
    shutil.copytree(M.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "ycsb-250k.json").read_text())
    cfg.update(name="ycsb-1m", data=dict(cfg["data"], n_keys=1_000_000))
    (here / "configs" / "ycsb-1m.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "ycsb-a.json").read_text())
    mix["spec"] = dict(mix["spec"], lookup=0.95, upsert=0.05, wave_len=0)
    (here / "traffic" / "ycsb-b.json").write_text(json.dumps(mix))
    (here / "metrics" / "calls_n.py").write_text(
        "def read(rec):\n    return len(rec.calls)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="ycsb-1m.b", config="ycsb-1m",
                                   traffic="ycsb-b", chips=1, why="new"))
    bench["per_layer"].append(dict(name="calls_n", unit="calls",
                                   better="higher", source="host_clock",
                                   layer="harness", moves="setup_s",
                                   workloads=["ycsb-1m.b"]))
    c = M.cell("ycsb-1m.b", manifest=bench, here=here)
    assert c.config["data"]["n_keys"] == 1_000_000
    assert c.traffic["spec"]["upsert"] == 0.05
    assert [m["name"] for m in c.per_layer] == ["build_s", "calls_n"]
    rec = Records("x", 1.0, 1.0, (0.0, 1.0), [CallRec("lookup", 0, 1, 4, 0,
                                                      True)])
    assert M.reader("calls_n", here=here)(rec) == 1
    assert all(p.read_bytes() == b for p, b in before.items())


def test_roofline_bytes_on_a_hand_made_batch():
    q = [1.0, 2.0, 2.0, 3.0, 9.0, 3.0]
    found = [True, True, True, True, False, True]
    assert distinct_found(q, found) == 3
    # 6 keys read (8 B), 6 answers written (8 + 1 B), 3 distinct pairs
    # found (16 B): the table layout is not counted
    assert lookup_bytes(6, 3) == 6 * 8 + 6 * 9 + 3 * 16 == 150


def _lookup_records():
    """Two lookup calls of 1 ms each with their device work inside, and a
    write call with a merge whose stages the program timed."""
    calls = [CallRec("lookup", 0.000, 0.001, 1 << 20, 0, True),
             CallRec("lookup", 0.001, 0.002, 1 << 20, 1, True),
             CallRec("upsert", 0.002, 0.004, 512, 2, True)]
    device = [("Memcpy HtoD (Pageable -> Device)", 0.0002, 0.0003),
              ("dili_search_kernel", 0.0003, 0.00035),
              ("Memcpy DtoH (Device -> Pageable)", 0.0004, 0.00042),
              ("Memcpy HtoD (Pageable -> Device)", 0.0012, 0.0013),
              ("dili_search_kernel", 0.0013, 0.00135),
              ("Memcpy DtoH (Device -> Pageable)", 0.0014, 0.00142)]
    spans = [("merge.fold", 0.0025, 0.0005), ("merge.flatten", 0.003, 0.0005),
             ("merge.frozen_dwell", 0.0024, 0.0016)]
    return Records("x", 10.0, 8.0, (0.0, 0.004), calls, merges=1,
                   device=device, spans=spans,
                   distinct_found={0: 600_000, 1: 700_000})


def test_per_layer_readers_on_hand_made_records():
    rec = _lookup_records()
    r = {m["name"]: M.reader(m["name"])(rec) for m in BENCH["per_layer"]}
    assert r["build_s"] == 8.0
    assert busy_s(rec) == pytest.approx(0.00034)
    assert r["facade_host_ms.lookup"] == pytest.approx(1.0 - 0.17)
    assert r["copy_ms.lookup"] == pytest.approx(0.12)
    need = lookup_bytes(1 << 20, 600_000) + lookup_bytes(1 << 20, 700_000)
    assert r["roofline_pct.lookup"] == pytest.approx(
        100 * need / HBM_BYTES_S / 0.0001)
    assert r["device_idle_pct.lookup"] == pytest.approx(
        100 * (1 - 0.00034 / 0.004))
    assert r["device_idle_pct.mixed"] == r["device_idle_pct.lookup"]
    assert r["merge_ms"] == pytest.approx(1.0)
    assert r["writes_per_merge"] == 512
    gaps = dict(idle_gaps(rec))
    assert gaps["merge.fold"] == pytest.approx(0.0005)
    assert gaps["merge.flatten"] == pytest.approx(0.0005)
    assert gaps["facade.upsert"] == pytest.approx(0.001)
    assert gaps["facade.lookup"] == pytest.approx(0.002 - 0.00034)
    assert sum(gaps.values()) == pytest.approx(0.004 - 0.00034)


def test_readers_find_nothing_without_a_trace():
    rec = _lookup_records()
    rec.device, rec.merges = [], 0
    for name in ("facade_host_ms.lookup", "copy_ms.lookup",
                 "roofline_pct.lookup", "device_idle_pct.lookup",
                 "merge_ms", "writes_per_merge"):
        assert M.reader(name)(rec) is None


def test_end_to_end_readers():
    rec = _lookup_records()
    assert M.reader("lookup_keys_s")(rec) == pytest.approx(2 * (1 << 20) / 0.004)
    assert M.reader("mixed_ops_s")(rec) == pytest.approx((2 * (1 << 20) + 512) / 0.004)
    assert M.reader("read_p95_ms.host")(rec) == pytest.approx(1.0)
    assert M.reader("write_p95_ms")(rec) == pytest.approx(2.0)
    assert M.reader("setup_s")(rec) == 10.0
