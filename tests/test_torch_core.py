"""The port's host tree and torch search against the JAX package.

Same keys (numpy, seeded) go to both packages; every comparison is
bit-exact — outputs are integers, bools, or keys copied unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dili as J_dili
from repro.core import flat as J_flat
from repro.core import search as JS
from repro.kernels import ops as J_ops
from repro.online.overlay import (TombstoneOverlay as JOverlay,
                                  overlay_device_arrays as j_overlay_arrays)
from repro_torch.api.snapshot import from_numpy_tables
from repro_torch.core import dili as T_dili
from repro_torch.core import flat as T_flat
from repro_torch.core import search as TS
from repro_torch.kernels import ops as T_ops
from repro_torch.online.overlay import (TombstoneOverlay as TOverlay,
                                        overlay_device_arrays as
                                        t_overlay_arrays)
from tests.conftest import make_keys

DISTS = ["logn", "uniform", "fb", "wikits"]
N_KEYS = 6000
J_DT = {"f64": jnp.float64, "f32": jnp.float32}
T_DT = {"f64": torch.float64, "f32": torch.float32}
NP_DT = {"f64": np.float64, "f32": np.float32}


def _build(pkg_dili, pkg_flat, keys, prec, **kw):
    if prec == "f32":
        with pkg_dili.placement_dtype(np.float32):
            d = pkg_dili.bulk_load(keys, **kw)
    else:
        d = pkg_dili.bulk_load(keys, **kw)
    return d, pkg_flat.flatten(d)


def _built(dist, prec, n, **kw):
    keys = make_keys(dist, n, np.random.default_rng(31))
    if prec == "f32":
        keys = np.unique(keys.astype(np.float32)).astype(np.float64)
    jd, jf = _build(J_dili, J_flat, keys, prec, **kw)
    td, tf = _build(T_dili, T_flat, keys, prec, **kw)
    jarr = JS.device_arrays(jf, J_DT[prec])
    tables = from_numpy_tables({k: np.asarray(v) for k, v in jarr.items()},
                               device="cpu")
    return dict(dist=dist, prec=prec, keys=keys, jd=jd, td=td, jf=jf, tf=tf,
                jarr=jarr, tarr=tables)


PARAMS = [(d, p) for d in DISTS for p in ("f64", "f32")]


def _id(x):
    return f"{x[0]}-{x[1]}"


@pytest.fixture(scope="module", params=PARAMS, ids=_id)
def built(request):
    return _built(*request.param, N_KEYS)


@pytest.fixture(scope="module", params=PARAMS, ids=_id)
def lo_built(request):
    """DILI-LO builds (`local_optimized=False`): every leaf is dense, so the
    Algorithm 1 probe serves every lookup."""
    return _built(*request.param, 3000, local_optimized=False)


def _queries(keys, prec, rng, n=2048):
    """Hits, midpoint misses, and out-of-range lanes (+inf pad lanes,
    3e9, far below and above the key range)."""
    mids = (keys[:-1] + keys[1:]) / 2
    q = np.concatenate([keys[rng.integers(0, len(keys), n)],
                        mids[rng.integers(0, len(mids), n // 2)],
                        [np.inf, 3e9, -3e9, keys[-1] * 4 + 1e6,
                         keys[0] - 1e6, 0.0, keys[0], keys[-1]]])
    return q.astype(NP_DT[prec])


def _eq(t, j):
    """Bit-exact equality of a torch tensor and a JAX/numpy array."""
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _assert_flat_equal(jf, tf):
    for name in ("a", "b", "base", "fo", "dense", "tag", "key", "val",
                 "pair_key", "pair_val", "pair_slot"):
        x, y = getattr(tf, name), getattr(jf, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in ("root", "max_depth", "key_lo", "key_hi", "n_segments"):
        assert getattr(tf, name) == getattr(jf, name), name


def test_flat_equal_field_by_field(built):
    _assert_flat_equal(built["jf"], built["tf"])


def test_flat_equal_dili_lo(lo_built):
    _assert_flat_equal(lo_built["jf"], lo_built["tf"])


def test_device_arrays_equal(built):
    prec = built["prec"]
    jarr = built["jarr"]
    tarr = TS.device_arrays(built["tf"], T_DT[prec], device="cpu")
    assert set(tarr) == set(jarr)
    for k, v in jarr.items():
        if k in ("max_depth", "has_dense"):
            assert tarr[k] == (bool(v) if k == "has_dense" else int(v)), k
            continue
        x = tarr[k].numpy()
        assert x.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(x, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("layout", ["packed", "column"])
@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("has_dense", [False, True])
def test_search_batch_matches_jax(built, layout, early_exit, has_dense):
    prec = built["prec"]
    q = _queries(built["keys"], prec, np.random.default_rng(32))
    jidx = dict(built["jarr"], has_dense=has_dense)
    tidx = dict(built["tarr"], has_dense=has_dense)
    if layout == "column":
        for k in ("node_pack", "slot_pack"):
            jidx.pop(k, None)
            tidx.pop(k, None)
    jout = JS.search_batch(jidx, jnp.asarray(q), with_stats=True,
                           early_exit=early_exit)
    tout = TS.search_batch(tidx, torch.from_numpy(q), with_stats=True,
                           early_exit=early_exit)
    for t, j in zip(tout, jout):
        _eq(t, j)
    v, f = TS.search_batch(tidx, torch.from_numpy(q), early_exit=early_exit)
    _eq(v, jout[0])
    _eq(f, jout[1])


def test_fma_consistency(built):
    """Port of test_search.py::test_fma_consistency: the port's search
    equals the JAX search jitted and eager (the two-rounding reference)."""
    keys, jarr, tarr = built["keys"], built["jarr"], built["tarr"]
    md = built["jf"].max_depth + 2
    rng = np.random.default_rng(14)
    q = keys[rng.integers(0, len(keys), 4096)].astype(NP_DT[built["prec"]])
    v1, f1 = JS.search_batch(jarr, jnp.asarray(q), max_depth=md)
    with jax.disable_jit():
        v2, f2 = JS.search_batch(jarr, jnp.asarray(q), max_depth=md)
    vt, ft = TS.search_batch(tarr, torch.from_numpy(q), max_depth=md)
    assert bool(ft.all())
    for t, j in ((vt, v1), (vt, v2), (ft, f1), (ft, f2)):
        _eq(t, j)


def test_dense_search_matches_jax(lo_built):
    built = lo_built
    jf = built["jf"]
    dense_nodes = np.nonzero(jf.dense)[0]
    assert len(dense_nodes) > 0
    prec = built["prec"]
    rng = np.random.default_rng(33)
    # queries inside the dense leaves' key ranges: their own pair keys plus
    # midpoints, each routed to its leaf
    n = dense_nodes[rng.integers(0, len(dense_nodes), 2048)]
    base, fo = jf.base[n], jf.fo[n]
    s = base + rng.integers(0, 1 << 20, len(n)) % fo
    q = jf.key[s] + rng.choice([0.0, 1e-9, -1e-9], len(n))
    q = q.astype(NP_DT[prec])
    jv, jok, jp = JS._dense_search(built["jarr"], jnp.asarray(q),
                                   jnp.asarray(n.astype(np.int32)))
    tv, tok, tp = TS._dense_search(built["tarr"], torch.from_numpy(q),
                                   torch.from_numpy(n.astype(np.int32)))
    _eq(tv, jv)
    _eq(tok, jok)
    _eq(tp, jp)


@pytest.mark.parametrize("early_exit", [False, True])
def test_dense_exit_search_matches_jax(lo_built, early_exit):
    q = _queries(lo_built["keys"], lo_built["prec"],
                 np.random.default_rng(38))
    jout = JS.search_batch(lo_built["jarr"], jnp.asarray(q), with_stats=True,
                           early_exit=early_exit)
    tout = TS.search_batch(lo_built["tarr"], torch.from_numpy(q),
                           with_stats=True, early_exit=early_exit)
    assert bool(np.asarray(jout[1]).any())
    for t, j in zip(tout, jout):
        _eq(t, j)


def test_resolve_overlay_matches_jax(built):
    keys, prec = built["keys"], built["prec"]
    rng = np.random.default_rng(34)
    up = keys[rng.integers(0, len(keys), 64)]
    new = ((keys[:-1] + keys[1:]) / 2)[rng.integers(0, len(keys) - 1, 64)]
    dead = keys[rng.integers(0, len(keys), 64)]
    new = new.astype(NP_DT[prec]).astype(np.float64)

    def writes(ov):
        return ov.upsert_batch(np.concatenate([up, new]),
                               np.arange(128) + 10_000).delete_batch(dead)

    jov, tov = writes(JOverlay.empty(32)), writes(TOverlay.empty(32))
    for a, b in zip(tov.entries(), jov.entries()):
        np.testing.assert_array_equal(a, b)
    q = np.concatenate([up, new, dead, keys[:64]]).astype(NP_DT[prec])
    sv, sf = JS.search_batch(built["jarr"], jnp.asarray(q))
    jv, jfound = JS.resolve_overlay(j_overlay_arrays(jov, J_DT[prec]),
                                    jnp.asarray(q), sv, sf)
    jova, tova = j_overlay_arrays(jov, J_DT[prec]), t_overlay_arrays(
        tov, T_DT[prec], device="cpu")
    for t, j in zip(TS.overlay_lookup(tova, torch.from_numpy(q)),
                    JS.overlay_lookup(jova, jnp.asarray(q))):
        _eq(t, j)
    tv, tfound = TS.resolve_overlay(t_overlay_arrays(tov, T_DT[prec],
                                                     device="cpu"),
                                    torch.from_numpy(q),
                                    torch.from_numpy(np.array(sv)),
                                    torch.from_numpy(np.array(sf)))
    _eq(tv, jv)
    _eq(tfound, jfound)


@pytest.mark.parametrize("max_hits", [1, 16, 128])
def test_range_query_batch_matches_jax(built, max_hits):
    keys, prec = built["keys"], built["prec"]
    rng = np.random.default_rng(35)
    starts = rng.integers(0, len(keys) - 200, 256)
    lo = keys[starts]
    hi = keys[np.minimum(starts + rng.integers(0, 180, 256), len(keys) - 1)]
    lo = np.concatenate([lo, [keys[0] - 1e6, keys[-1] + 1, keys[10]]])
    hi = np.concatenate([hi, [keys[0], keys[-1] * 4 + 1e6, keys[5]]])
    lo, hi = lo.astype(NP_DT[prec]), hi.astype(NP_DT[prec])
    jout = JS.range_query_batch(built["jarr"], jnp.asarray(lo),
                                jnp.asarray(hi), max_hits=max_hits)
    tout = TS.range_query_batch(built["tarr"], torch.from_numpy(lo),
                                torch.from_numpy(hi), max_hits=max_hits)
    for t, j in zip(tout, jout):
        _eq(t, j)


# -- XLA's saturating float -> int32 and slot prediction ---------------------

EDGE = [np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0 ** 31, -2.0 ** 31,
        2.0 ** 31 - 2 ** 7, 1e30, -1e30, 1.5, -1.5, 0.0, -0.0, 7.0]


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_saturating_cast_matches_xla(prec):
    x = np.asarray(EDGE, NP_DT[prec])
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = TS.sat_i32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 2147483647 and got[2] == 0     # +inf, NaN


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_predict_slot_out_of_range_matches_xla(prec):
    """+inf pad lanes and queries far above the key range land on the last
    slot (XLA saturates), not on slot 0."""
    rng = np.random.default_rng(36)
    q = np.asarray(EDGE + list(rng.lognormal(0, 3, 64)), NP_DT[prec])
    a = np.full(len(q), 0.25, NP_DT[prec])
    b = np.full(len(q), 1000.0, NP_DT[prec])
    fo = np.full(len(q), 1000, np.int32)
    want = np.asarray(JS.predict_slot(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(q), jnp.asarray(fo)))
    got = TS.predict_slot(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(q), torch.from_numpy(fo)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 999                             # +inf -> last slot


def test_build_f32_index_matches_jax():
    keys = make_keys("logn", 3000, np.random.default_rng(37))
    jd, jk = J_ops.build_f32_index(keys)
    td, tk = T_ops.build_f32_index(keys)
    np.testing.assert_array_equal(tk, jk)
    jf, tf = J_flat.flatten(jd), T_flat.flatten(td)
    ja = {k: np.asarray(v) for k, v in J_ops.kernel_arrays(jf).items()}
    ta = T_ops.kernel_arrays(tf, device="cpu")
    # the port's tables are the reference's columns, packed
    want = T_ops.pack_tables(ja, device="cpu")
    assert set(ta) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert ta[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ta[k].numpy(), v.numpy(),
                                          err_msg=k)
        else:
            assert ta[k] == v, k
    assert ta["max_depth"] == int(ja["max_depth"])
    assert T_ops.column_bytes(ta) == J_ops.table_bytes(
        J_ops.kernel_arrays(jf))
