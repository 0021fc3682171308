"""The port's workload engine and differential oracle
(`repro_torch.workloads`), on the CPU.

The generator, the oracle and the runner are copies of the reference's:
every preset's stream is byte-identical from both packages, and the
reference's tests/test_workloads.py scenarios run on the port — the
stream contracts, the oracle against a brute-force dict, and the
differential grid (presets x the `local`, `pallas` and `sharded`
engines, every batch diffed against the oracle, zero divergences; the
sharded engine on 8 shards), the runner's fault detection, and a
kill-and-recover replay through the port's durability.  Keys follow the
integer-key convention (f32-exact), so every comparison is bit-exact on
every engine.
"""
import numpy as np
import pytest

from repro.workloads import PRESETS as J_PRESETS
from repro.workloads import generate_stream as j_generate_stream
from repro_torch.api import (DurabilityConfig, IndexConfig, LearnedIndex,
                             MaintenanceConfig)
from repro_torch.workloads import (PRESETS, SortedOracle, WorkloadDivergence,
                                   WorkloadRunner, WorkloadSpec,
                                   generate_stream, run_preset,
                                   stream_op_counts)

ENGINES = ("local", "pallas", "sharded")
UNIVERSE = np.arange(0, 6000, 2, dtype=np.float64)    # f32-exact even ints


def _build(keys, **kw):
    return LearnedIndex.build(keys, config=IndexConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


def _streams_equal(a, b) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.op != y.op:
            return False
        for f in ("keys", "vals", "lo", "hi"):
            u, v = getattr(x, f), getattr(y, f)
            if (u is None) != (v is None):
                return False
            if u is not None and (u.dtype != v.dtype
                                  or u.tobytes() != v.tobytes()):
                return False
    return True


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_streams_byte_identical_across_packages(preset):
    """Every preset expands to the same bytes in both packages, and the
    port's stream replays byte-identically from its seed."""
    assert PRESETS[preset].__dict__ == J_PRESETS[preset].__dict__
    spec = PRESETS[preset].scaled(n_ops=800, batch_size=64, seed=5)
    jspec = J_PRESETS[preset].scaled(n_ops=800, batch_size=64, seed=5)
    assert spec.__dict__ == jspec.__dict__
    s1 = generate_stream(spec, UNIVERSE)
    assert _streams_equal(s1, j_generate_stream(jspec, UNIVERSE))
    assert _streams_equal(s1, generate_stream(spec, UNIVERSE))
    assert not _streams_equal(s1, generate_stream(spec.scaled(seed=6),
                                                  UNIVERSE))


def test_stream_respects_mix_and_key_contracts():
    spec = PRESETS["dili_paper"].scaled(n_ops=6400, batch_size=64, seed=2)
    batches = generate_stream(spec, UNIVERSE)
    counts = stream_op_counts(batches)
    total = sum(counts.values())
    assert spec.n_ops * 0.98 <= total <= spec.n_ops
    assert counts["lookup"] / total > 0.7
    assert counts["upsert"] > 0 and counts["range"] > 0
    live = set(UNIVERSE.tolist())
    for b in batches:
        if b.op == "upsert":
            new = set(b.keys.tolist()) - live
            assert all(int(k) % 2 == 1 for k in new)
            live |= set(b.keys.tolist())
        elif b.op == "delete":
            assert len(np.unique(b.keys)) == len(b.keys)
            assert set(b.keys.tolist()) <= live
            live -= set(b.keys.tolist())
        elif b.op == "range":
            assert (b.hi > b.lo).all()


def test_latest_distribution_prefers_recent_inserts():
    spec = WorkloadSpec(name="latest_mix", lookup=0.5, upsert=0.5,
                        insert_frac=1.0, distribution="latest",
                        n_ops=4000, batch_size=64, seed=9, miss_frac=0.0)
    inserted: set = set()
    hits_new = hits_loaded = 0
    for b in generate_stream(spec, UNIVERSE):
        if b.op == "upsert":
            inserted |= set(b.keys.tolist())
        elif b.op == "lookup" and inserted:
            ks = set(b.keys.tolist())
            hits_new += len(ks & inserted)
            hits_loaded += len(ks - inserted)
    assert hits_new > hits_loaded


def test_shift_preset_moves_insert_distribution():
    spec = PRESETS["shift_fb_logn"].scaled(n_ops=2000, batch_size=64,
                                           seed=3)
    batches = generate_stream(spec, UNIVERSE)
    loaded = set(UNIVERSE.tolist())
    phase1_hi = UNIVERSE.max() + 2 * spec.n_ops
    n_b = len(batches)
    early_new, late_new = [], []
    for i, b in enumerate(batches):
        if b.op != "upsert":
            continue
        fresh = [k for k in b.keys.tolist() if k not in loaded]
        loaded |= set(b.keys.tolist())
        (early_new if i < n_b // 2 else late_new).extend(fresh)
    assert early_new and late_new
    assert max(early_new) < phase1_hi
    late = np.asarray(late_new)
    assert (late > phase1_hi).mean() > 0.9
    assert np.all(late == np.rint(late)) and late.max() < 2 ** 24


def test_ttl_storm_waves_and_oldest_victims():
    spec = PRESETS["ttl_storm"].scaled(n_ops=1280, batch_size=64, seed=5)
    batches = generate_stream(spec, UNIVERSE)
    ops = [b.op for b in batches]
    assert ops[:10] == ["lookup"] * 2 + ["upsert"] * 5 + ["delete"] * 3
    age = list(UNIVERSE.tolist())
    saw_delete = False
    for b in batches:
        if b.op == "upsert":
            age.extend(k for k in b.keys.tolist() if k not in set(age))
        elif b.op == "delete":
            saw_delete = True
            want = set(np.sort(np.asarray(age[: len(b.keys)])).tolist())
            assert set(b.keys.tolist()) == want
            age = [k for k in age if k not in want]
    assert saw_delete


def test_spec_validation():
    with pytest.raises(ValueError, match="sum to 1"):
        WorkloadSpec(lookup=0.5, upsert=0.2)
    with pytest.raises(ValueError, match="unknown distribution"):
        WorkloadSpec(distribution="pareto")
    with pytest.raises(ValueError, match="delete_policy"):
        WorkloadSpec(delete_policy="newest")
    with pytest.raises(ValueError, match="shift_frac"):
        WorkloadSpec(shift_frac=1.0)
    with pytest.raises(ValueError, match="wave_len"):
        WorkloadSpec(wave_len=-1)


# ---------------------------------------------------------------------------
# oracle
# ---------------------------------------------------------------------------


def test_oracle_matches_brute_force_dict():
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(0, 2000, 300)).astype(np.float64)
    oc = SortedOracle(keys, np.arange(len(keys), dtype=np.int64))
    model = dict(zip(keys.tolist(), range(len(keys))))
    for step in range(30):
        ks = rng.integers(0, 2000, 20).astype(np.float64)
        if step % 3 == 0:
            vs = rng.integers(0, 1 << 30, 20)
            oc.upsert(ks, vs)
            model.update(zip(ks.tolist(), vs.tolist()))
        elif step % 3 == 1:
            oc.delete(ks)
            for k in ks.tolist():
                model.pop(k, None)
        q = rng.integers(0, 2000, 50).astype(np.float64)
        v, f = oc.lookup(q)
        for qi, vi, fi in zip(q.tolist(), v, f):
            assert fi == (qi in model)
            if fi:
                assert vi == model[qi]
    want = np.array(sorted(model), np.float64)
    got_k, got_v = oc.items()
    np.testing.assert_array_equal(got_k, want)
    np.testing.assert_array_equal(got_v, [model[k] for k in want.tolist()])


def test_oracle_range_padding_conventions():
    oc = SortedOracle(np.array([1.0, 3.0, 5.0, 7.0]),
                      np.array([10, 30, 50, 70]))
    ks, vs, cnt = oc.range([2.0, 0.0], [6.0, 100.0], max_hits=3)
    np.testing.assert_array_equal(cnt, [2, 3])
    np.testing.assert_array_equal(ks[0], [3.0, 5.0, np.inf])
    np.testing.assert_array_equal(vs[0], [30, 50, -1])
    np.testing.assert_array_equal(ks[1], [1.0, 3.0, 5.0])


# ---------------------------------------------------------------------------
# differential acceptance grid: presets x engines, zero divergence
# ---------------------------------------------------------------------------

GRID_SIZES = {"local": (1500, 64), "pallas": (600, 64),
              "sharded": (480, 32)}
GRID_PRESETS = ("ycsb_a", "ycsb_e", "dili_paper",
                "shift_fb_logn", "ttl_storm")
MAINT_PRESETS = ("shift_fb_logn", "ttl_storm")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("preset", GRID_PRESETS)
def test_differential_grid(engine, preset):
    n_ops, bs = GRID_SIZES[engine]
    spec = PRESETS[preset].scaled(n_ops=n_ops, batch_size=bs, seed=13)
    ix = _build(UNIVERSE, engine=engine, overlay_cap=512,
                n_shards=8 if engine == "sharded" else None,
                maintenance=(MaintenanceConfig()
                             if preset in MAINT_PRESETS else None))
    report = WorkloadRunner(ix).run(generate_stream(spec, UNIVERSE),
                                    spec=spec)
    assert report.divergences == []
    assert spec.n_ops * 0.95 <= report.n_ops <= spec.n_ops
    assert report.final_stats["engine"] == engine
    ix.close()


def test_write_heavy_mix_exercises_merge_pressure():
    ix = _build(UNIVERSE, overlay_cap=64)
    rep = run_preset(ix, PRESETS["ycsb_a"].scaled(n_ops=2000, batch_size=64,
                                                  seed=21))
    assert rep.divergences == []
    assert rep.final_stats["n_merges"] >= 1
    assert rep.final_stats["epoch"] >= 2


class _FaultyIndex:
    """Facade wrapper that corrupts one lookup lane per batch — the runner
    must catch it (differential harness self-test)."""

    def __init__(self, ix):
        self._ix = ix

    def __getattr__(self, name):
        return getattr(self._ix, name)

    def lookup(self, queries):
        v, f = self._ix.lookup(queries)
        v = np.array(v)
        v[0] += 1
        return v, f


def test_runner_catches_injected_corruption():
    spec = PRESETS["ycsb_c"].scaled(n_ops=256, batch_size=64, seed=1)
    ix = _FaultyIndex(_build(UNIVERSE))
    batches = generate_stream(spec, UNIVERSE)
    report = WorkloadRunner(ix, strict=False).run(batches, spec=spec)
    assert report.divergences
    with pytest.raises(WorkloadDivergence):
        WorkloadRunner(ix).run(batches, spec=spec)


def test_runner_check_false_is_pure_throughput():
    ix = _build(UNIVERSE)
    spec = PRESETS["ycsb_b"].scaled(n_ops=256, batch_size=64, seed=2)
    runner = WorkloadRunner(ix, check=False)
    assert runner.oracle is None
    r = runner.run(generate_stream(spec, UNIVERSE), spec=spec)
    assert r.divergences == [] and r.n_ops == 256 and r.wall_s > 0
    d = r.to_json_dict()
    assert d["ops_per_s"] > 0 and d["n_divergences"] == 0


def test_kill_recover_workload_replay(tmp_path):
    """ycsb_a kill-and-recover on the port: replay half the stream,
    abandon (a SIGKILL's disk state), recover on the same device, finish
    the stream on the recovered index — zero divergence end to end."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 1 << 22, 3000)).astype(np.float64)
    ix = _build(keys, durability=DurabilityConfig(
        dir=str(tmp_path / "dur"), fsync="always"))
    spec = PRESETS["ycsb_a"].scaled(n_ops=3000, batch_size=128)
    batches = generate_stream(spec, keys)
    runner = WorkloadRunner(ix)
    out = runner.run_kill_recover(batches, kill_at=len(batches) // 2,
                                  spec=spec)
    assert runner.index is not ix and runner.index.device.type == "cpu"
    runner.index.close()
    assert out["n_divergences"] == 0
    assert out["post_recovery_divergences"] == []
    assert out["recovery_s"] > 0 and out["replayed_records"] >= 1
