"""The port's competitor indexes against the JAX package's.

Same keys (numpy, seeded) go through both packages' builds and lookups on
the CPU; the build states and every lane's (vals, found, probes) must be
equal, tolerance 0: hits, midpoint misses and edge lanes (±inf, NaN, just
outside the key range, ±1e300, 3e9, the first and last key), at f64 for
all seven and at f32 where the reference's numpy-scalar promotion or its
f32 arithmetic decides the answer.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.data.datasets import generate
from repro_torch.core import baselines as TB
from tests.conftest import make_keys

DISTS = ["logn", "uniform", "fb", "wikits"]
N_KEYS = 20_000
NAMES = [B.name for B in JB.ALL_BASELINES]
J_BY_NAME = {B.name: B for B in JB.ALL_BASELINES}
T_BY_NAME = {B.name: B for B in TB.ALL_BASELINES}


@pytest.fixture(scope="module")
def cases():
    """(name, dist) -> keys, query sets and both packages' build states,
    built once per module."""
    memo = {}

    def get(name, dist):
        if (name, dist) not in memo:
            rng = np.random.default_rng(31)
            keys = make_keys(dist, N_KEYS, rng)
            vals = np.arange(len(keys), dtype=np.int64)
            qi = rng.integers(0, len(keys), 4096)
            qi2 = rng.integers(0, len(keys) - 1, 2048)
            mids = (keys[qi2] + keys[qi2 + 1]) / 2
            edges = np.array([-np.inf, np.inf, np.nan, keys[0] - 1,
                              keys[-1] + 1, 1e300, -1e300, 3e9, keys[0],
                              keys[-1]])
            memo[name, dist] = dict(
                keys=keys, qi=qi,
                sets=dict(hits=keys[qi], misses=mids, edges=edges),
                j=J_BY_NAME[name].build(keys, vals),
                t=T_BY_NAME[name].build(keys, vals))
        return memo[name, dist]

    return get


def _both(case, name, dtype):
    """Both packages' (vals, found, probes) on every query set, as numpy."""
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    jdev = J_BY_NAME[name].device(case["j"], dtype=jdt)
    tdev = T_BY_NAME[name].device(case["t"], dtype=tdt, device="cpu")
    with np.errstate(over="ignore"):        # ±1e300 in f32 is ±inf
        q = np.concatenate(list(case["sets"].values())).astype(
            np.float64 if dtype == "f64" else np.float32)
    want = [np.asarray(x) for x in
            J_BY_NAME[name].lookup(jdev, jnp.asarray(q))]
    got = [x.numpy() for x in
           T_BY_NAME[name].lookup(tdev, torch.from_numpy(q))]
    return want, got


def _assert_lanes_equal(case, want, got):
    bounds = np.cumsum([0] + [len(v) for v in case["sets"].values()])
    for w, g, what in zip(want, got, ("vals", "found", "probes")):
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            bad = np.nonzero(g[lo:hi] != w[lo:hi])[0]
            assert not len(bad), (what, list(case["sets"])[s],
                                  bad[:8].tolist(), g[lo:hi][bad[:8]],
                                  w[lo:hi][bad[:8]])


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", NAMES)
def test_lookup_equals_reference(cases, name, dist):
    case = cases(name, dist)
    want, got = _both(case, name, "f64")
    _assert_lanes_equal(case, want, got)
    n_hit = len(case["sets"]["hits"])
    assert got[1][:n_hit].all()
    assert np.array_equal(got[0][:n_hit], case["qi"])


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", ["PGM", "RS", "ALEX"])
def test_lookup_equals_reference_f32(cases, name, dist):
    case = cases(name, dist)
    want, got = _both(case, name, "f32")
    _assert_lanes_equal(case, want, got)


def _assert_state_equal(j, t, path="state"):
    if dataclasses.is_dataclass(j):
        assert type(t).__name__ == type(j).__name__, path
        for f in dataclasses.fields(j):
            _assert_state_equal(getattr(j, f.name), getattr(t, f.name),
                                f"{path}.{f.name}")
    elif isinstance(j, dict):
        assert sorted(t) == sorted(j), path
        for k in j:
            _assert_state_equal(j[k], t[k], f"{path}[{k!r}]")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (x, y) in enumerate(zip(j, t)):
            _assert_state_equal(x, y, f"{path}[{i}]")
    else:
        assert type(t) is type(j), (path, type(t), type(j))
        if isinstance(j, np.ndarray):
            assert t.dtype == j.dtype, path
            np.testing.assert_array_equal(t, j, err_msg=path)
        else:
            assert t == j or (t != t and j != j), path


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", NAMES)
def test_build_state_equals_reference(cases, name, dist):
    case = cases(name, dist)
    _assert_state_equal(case["j"], case["t"])


def test_lipp_rejects_f32(cases):
    with pytest.raises(ValueError, match="f64/i64"):
        TB.LIPP.device(cases("LIPP", "logn")["t"], dtype=torch.float32,
                       device="cpu")


def test_probe_ordering_learned_beats_binary():
    """Sanity: learned indexes touch fewer entries than binary search
    (the paper's core claim, Table 5); the same means as the reference."""
    rng = np.random.default_rng(32)
    keys = make_keys("logn", 30000, rng)
    vals = np.arange(len(keys), dtype=np.int64)
    qi = rng.integers(0, len(keys), 4096)
    probes = {}
    for B in TB.ALL_BASELINES:
        st = B.build(keys, vals)
        _, _, pr = B.lookup(B.device(st, device="cpu"),
                            torch.from_numpy(keys[qi]))
        probes[B.name] = float(pr.double().mean())
    assert probes["RMI"] < probes["BinS"]
    assert probes["LIPP"] < probes["BinS"]
    assert probes["RS"] < probes["BinS"]
    for B in (JB.BinS, JB.RMI):
        _, _, pr = B.lookup(B.device(B.build(keys, vals)),
                            jnp.asarray(keys[qi]))
        assert probes[B.name] == float(np.asarray(pr).mean())


def test_pgm_misses_the_keys_the_reference_misses():
    """The reference's PGM bounds its upper level's error at the segment
    start keys only, so a key past the last start key of an upper-level
    segment meets that segment's extrapolated model: at the 1M logn keys
    the chip run uses, 892 keys are never found.  The port misses the
    same keys, lane for lane."""
    keys = generate("logn", 1_000_000, 0)
    vals = np.arange(len(keys), dtype=np.int64)
    q = keys[994_000:997_000]
    want = [np.asarray(x) for x in JB.PGM.lookup(
        JB.PGM.device(JB.PGM.build(keys, vals)), jnp.asarray(q))]
    got = [x.numpy() for x in TB.PGM.lookup(
        TB.PGM.device(TB.PGM.build(keys, vals), device="cpu"),
        torch.from_numpy(q))]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert int((~got[1]).sum()) == 892
