"""`BENCHMARK.json` and the files it names.  Everything that belongs to one
configuration, traffic mix or metric sits in a file of its own, found by
the name the manifest gives it:

  configs/<config>.json   the deployment: data, index settings, source
  traffic/<traffic>.json  the mix (see `traffic.py`)
  metrics/<metric>.py     the reader of one metric: `read(rec) -> float |
                          None` over the run's `trace.Records`

A later PR adds a cell, a mix or a metric by adding files and manifest
entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]   # the cell's end-to-end metrics
    per_layer: list[dict]    # the cell's per-layer metrics


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def reports(metric: dict, cell: str, manifest: dict) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` list, or,
    without the key, every cell (end to end) or every cell that reports
    the end-to-end metric it moves (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        e2e = {m["name"]: m for m in manifest["end_to_end"]}
        return reports(e2e[metric["moves"]], cell, manifest)
    return True


def cell(name: str, manifest: dict | None = None,
         here: Path = HERE) -> Cell:
    m = manifest if manifest is not None else load(here.parent)
    rows = [w for w in m["workloads"] if w["name"] == name]
    if not rows:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = rows[0]
    return Cell(
        name=name,
        config=json.loads((here / "configs"
                           / f"{check_name(w['config'])}.json").read_text()),
        traffic=json.loads((here / "traffic"
                            / f"{check_name(w['traffic'])}.json").read_text()),
        chips=int(w["chips"]),
        end_to_end=[x for x in m["end_to_end"] if reports(x, name, m)],
        per_layer=[x for x in m["per_layer"] if reports(x, name, m)])


def reader(metric: str, here: Path = HERE):
    """The `read` function of `metrics/<metric>.py`."""
    path = here / "metrics" / f"{check_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        f"dilibench.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
