"""The correctness check against its control and against planted faults
(`dilibench/faults.py`), on the CPU at a size a test run holds (the chip
runs the same at the cells' own sizes: `dilibench/control.py`, with
`--fault` for a fault).  Each test drives the rest of a run through
`harness.run_cell`, skipping only `run.py`'s look for a CUDA device, and
reads `correct`."""

import copy
import subprocess
import sys
import time
from dataclasses import replace

import pytest

from dilibench import faults, harness, manifest as M
from repro_torch.online.merge import OnlineIndex

SMALL = {"logn-1m.lookup": (3000, 2048), "ycsb-250k.a": (3000, 128)}


def small(name: str):
    """The cell with its data and batches cut to `SMALL`: the same
    configuration, mix, window and comparison."""
    c = M.cell(name)
    n, batch = SMALL[name]
    cfg = copy.deepcopy(c.config)
    cfg["data"]["n_keys"] = n
    mix = copy.deepcopy(c.traffic)
    mix["spec"]["batch_size"] = batch
    mix["pool_calls"] = min(mix["pool_calls"], 64)
    return replace(c, config=cfg, traffic=mix)


def run(name, seed=2**31 + 7, device="cpu", **kw):
    return harness.run_cell(small(name), seed, 0.4, False, device,
                            time.perf_counter(), log=lambda msg: None, **kw)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0
    assert r["check"]["wrong_lanes"]["value"] == 0
    assert list(r)[-1] == "check"


def test_mixed_run_merges_and_stays_correct():
    """Reads between and after merges: small batches force many merges
    (fold, flatten, publish) inside the window."""
    r = harness.run_cell(small("ycsb-250k.a"), 5, 0.6, True, "cpu",
                         time.perf_counter(), log=lambda msg: None)
    assert r["correct"]
    assert r["metrics"]["writes_per_merge"]["value"] > 0
    assert r["metrics"]["merge_ms"]["value"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_f32_is_not_correct(name):
    r = run(name, overrides={"dtype": "float32"})
    assert not r["correct"]
    assert r["check"]["wrong_lanes"]["value"] > 0


def test_fault_state_unchanged(monkeypatch):
    faults.plant("unchanged", monkeypatch.setattr)
    assert not run("ycsb-250k.a")["correct"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_half_the_batch_left_out(monkeypatch, name):
    faults.plant("half", monkeypatch.setattr)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_answer_altered(monkeypatch, name):
    faults.plant("altered", monkeypatch.setattr)
    assert not run(name)["correct"]


def test_raising_call_is_failed(monkeypatch):
    def boom(self, keys, vals):
        raise RuntimeError("planted")
    warm_up = harness.warm_up

    def warm_then_break(*args):
        warm_up(*args)
        monkeypatch.setattr(OnlineIndex, "upsert_batch", boom)
    monkeypatch.setattr(harness, "warm_up", warm_then_break)
    r = run("ycsb-250k.a")
    assert not r["correct"] and r["check"]["raised_ops"]["value"] > 0


def test_forbidden_modules(monkeypatch):
    import types
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in harness.forbidden_modules()


def test_run_refuses_without_a_card():
    """`run.py` prints no result and exits non-zero where CUDA is absent
    (every CPU test machine); on a card it would run the cell."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(M.HERE / "run.py"),
                        "--workload", "ycsb-250k.a", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_on_card_sound_and_control(cuda_device, name):
    assert run(name, device=cuda_device)["correct"]
    assert not run(name, device=cuda_device,
                   overrides={"dtype": "float32"})["correct"]


def test_every_op_kind_replays_correctly():
    """Lookups, inserts, updates, deletes and ranges through the facade
    agree with the reference call by call, merges included: the mixes a
    later cell may bring need no new harness code."""
    c = small("ycsb-250k.a")
    mix = copy.deepcopy(c.traffic)
    mix.pop("keychooser", None)     # the spec's own key popularity
    mix["spec"] = dict(lookup=0.4, upsert=0.3, delete=0.1, range_=0.2,
                       insert_frac=0.5, distribution="uniform",
                       batch_size=64, miss_frac=0.05, max_hits=16)
    for kind in ("ycsb", "dataset"):
        cfg = copy.deepcopy(c.config)
        if kind == "dataset":
            cfg["data"] = {"kind": "dataset", "dataset": "logn",
                           "n_keys": 3000}
        r = harness.run_cell(replace(c, config=cfg, traffic=mix), 11, 0.6,
                             False, "cpu", time.perf_counter(),
                             log=lambda msg: None)
        assert r["correct"], (kind, r["check"])
