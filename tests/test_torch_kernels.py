"""The port's lookup kernel against the reference's.

The function under test is the reference's `repro.kernels.ops.dili_search`
(the Pallas kernel in interpret mode plus the XLA recheck of the lanes it
flags), which the port computes in one kernel: the walk and the dense-leaf
probe.  Here the port runs its plain version (the CPU path of
`repro_torch.kernels.dili_search`) on tables packed from the reference's
own `kernel_arrays`.  Bit-exact: the outputs are int32 values and bools.
The CUDA kernel against this plain version is tests/test_torch_cuda.py
(needs a card, imports no JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as J_search
from repro.core.dili import placement_dtype as j_placement
from repro.core.flat import TAG_CHILD, TAG_EMPTY, TAG_PAIR, flatten
from repro.kernels import ops as J_ops
from repro.kernels.dili_search import dili_search_pallas
from repro.kernels.ref import dili_search_ref as j_ref
from repro_torch.kernels import dili_search as T_kernel
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref
from tests.conftest import make_keys

NAMES = ("a", "b", "base", "fo", "dense", "tag", "key", "val", "root")


def tables(jarr) -> dict:
    """The reference's kernel tables and the port's, packed from them."""
    return dict(jarr=jarr, tarr=T_ops.pack_tables(
        {k: np.asarray(v) for k, v in jarr.items()}, device="cpu"))


def build(dist, n, seed=21):
    """Reference build; the port gets the same tables, packed."""
    keys = make_keys(dist, n, np.random.default_rng(seed))
    d, keys32 = J_ops.build_f32_index(keys)
    f = flatten(d)
    return dict(keys32=keys32, d=d, f=f, **tables(J_ops.kernel_arrays(f)))


@pytest.fixture(scope="module")
def cached():
    """build(dist, n), shared across this module's tests."""
    memo: dict = {}

    def get(dist, n):
        if (dist, n) not in memo:
            memo[(dist, n)] = build(dist, n)
        return memo[(dist, n)]
    return get


def port_pair(b, q, max_depth=None):
    t = b["tarr"]
    md = t["max_depth"] if max_depth is None else max_depth
    out = T_kernel.dili_search(t["node_rec"], t["slot_rec"], t["key"],
                               torch.from_numpy(q), root=t["root"],
                               max_depth=md)
    return [x.numpy() for x in out]


def ref_pair(b, q):
    """The reference's dispatch: Pallas kernel (interpret) + XLA recheck."""
    out = J_ops.dili_search(b["jarr"], jnp.asarray(q), interpret=True)
    return [np.asarray(x) for x in out]


def pallas_pair(b, q, block_q):
    """`ref_pair` with the Pallas kernel tiled by `block_q` lanes."""
    j = b["jarr"]
    pad = (-len(q)) % block_q
    qp = jnp.asarray(np.concatenate([q, np.full(pad, np.inf, np.float32)]))
    out, found, fb = dili_search_pallas(
        *(j[k] for k in NAMES), qp, max_depth=j["max_depth"],
        interpret=True, block_q=block_q)
    v2, f2 = J_search.search_batch(J_ops._as_search_idx(j), qp,
                                   max_depth=j["max_depth"])
    out = jnp.where(fb, v2, out)
    found = jnp.where(fb, f2, found)
    return [np.asarray(x)[: len(q)] for x in (out, found)]


def assert_pairs_equal(b, q, got, want):
    """Bit equality; on a mismatch, name the side the host walk
    (`DILI.search` under f32 placement) disagrees with."""
    for g, w in zip(got, want):
        bad = np.nonzero(g != w)[0]
        if len(bad):
            i = int(bad[0])
            host = None
            if "d" in b:
                with j_placement(np.float32):
                    host = b["d"].search(float(q[i]))
            pytest.fail(f"lane {i} (q={q[i]!r}): port {g[i]} vs reference "
                        f"{w[i]}; host walk says {host}")


@pytest.mark.parametrize("dist", ["logn", "uniform", "fb", "wikits"])
@pytest.mark.parametrize("n", [2000, 30000])
def test_kernel_matches_truth_and_pallas(dist, n, cached):
    b = cached(dist, n)
    keys32 = b["keys32"]
    rng = np.random.default_rng(22)
    qi = rng.integers(0, len(keys32), 4096)
    q = keys32[qi]
    got = port_pair(b, q)
    assert_pairs_equal(b, q, got, ref_pair(b, q))
    assert bool(got[1].all())
    assert np.array_equal(got[0], qi)
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(q))
    np.testing.assert_array_equal(v.numpy(), got[0])
    np.testing.assert_array_equal(fnd.numpy(), got[1])


@pytest.mark.parametrize("block_q", [512, 2048])
def test_kernel_matches_pallas_block_sizes(block_q, cached):
    """A ragged batch (no multiple of either tile) against the reference
    tiled two ways."""
    b = cached("logn", 20000)
    rng = np.random.default_rng(23)
    q = b["keys32"][rng.integers(0, len(b["keys32"]), 3001)]
    assert_pairs_equal(b, q, port_pair(b, q), pallas_pair(b, q, block_q))


def test_kernel_misses_no_false_positives(cached):
    b = cached("uniform", 20000)
    keys32 = b["keys32"]
    rng = np.random.default_rng(24)
    qi = rng.integers(0, len(keys32) - 1, 2048)
    mids = ((keys32[qi].astype(np.float64)
             + keys32[qi + 1].astype(np.float64)) / 2).astype(np.float32)
    ok = (mids != keys32[qi]) & (mids != keys32[qi + 1])
    got = port_pair(b, mids)
    assert_pairs_equal(b, mids, got, ref_pair(b, mids))
    assert not got[1][ok].any()
    assert (got[0][~got[1]] == -1).all()


def test_kernel_pads_ragged_batch(cached):
    """A batch of 777 lanes needs no padding: the lane count is the
    caller's."""
    b = cached("logn", 5000)
    q = b["keys32"][:777]
    stats = {}
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(q), stats=stats)
    assert fnd.shape == (777,) and bool(fnd.all())
    assert np.array_equal(v.numpy(), np.arange(777))
    assert stats["lanes"] == 777
    assert_pairs_equal(b, q, port_pair(b, q), ref_pair(b, q))


def test_out_of_range_and_pad_lanes(cached):
    """+inf pad lanes, NaN and queries far above/below the key range: XLA's
    saturating cast sends them to the last/first slot; never a hit."""
    b = cached("fb", 2000)
    k = b["keys32"]
    q = np.asarray([np.inf, 3e9, 1e30, k[-1] * 2, -1e30, -np.inf, 0.0,
                    np.nan, -3e9, k[0], k[-1]], np.float32)
    got = port_pair(b, q)
    assert_pairs_equal(b, q, got, ref_pair(b, q))
    assert got[1].tolist() == [False] * 9 + [True, True]


def test_dense_leaf_table_recheck(cached, monkeypatch):
    """logn at f32 placement has dense leaves.  The reference's kernel flags
    their lanes and rechecks the batch in XLA; the port resolves them in
    its one kernel call, with nothing run after it."""
    b = cached("logn", 20000)
    assert b["f"].dense.any()
    rng = np.random.default_rng(25)
    keys32 = b["keys32"]
    qi = rng.integers(0, len(keys32), 4096)
    q = keys32[qi]
    j = b["jarr"]
    flagged = np.asarray(j_ref(*(j[k] for k in NAMES[:-1]), j["root"][0],
                               jnp.asarray(q), j["max_depth"])[2])
    assert flagged.mean() > 0.5                     # most lanes end dense
    calls = []

    def counted(*args, **kw):
        calls.append(args[3].numel())
        return T_kernel.dili_search(*args, **kw)

    monkeypatch.setattr(T_ops, "dili_search_kernel", counted)
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(q))
    assert calls == [4096]
    assert bool(fnd.all()) and np.array_equal(v.numpy(), qi)
    assert_pairs_equal(b, q, [v.numpy(), fnd.numpy()], ref_pair(b, q))


def test_wrapper_rejects_bad_inputs(cached):
    b = cached("logn", 2000)
    t = dict(b["tarr"])
    q = torch.from_numpy(b["keys32"][:64])
    recs = [t["node_rec"], t["slot_rec"], t["key"]]
    kw = dict(root=t["root"], max_depth=t["max_depth"])
    with pytest.raises(TypeError):
        T_kernel.dili_search(*recs, q.double(), **kw)
    bad = list(recs)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        T_kernel.dili_search(*bad, q, **kw)
    with pytest.raises(ValueError):
        T_kernel.dili_search(*recs, torch.from_numpy(
            b["keys32"][:128])[::2], **kw)
    bad = list(recs)
    bad[2] = bad[2][:-1]
    with pytest.raises(ValueError):
        T_kernel.dili_search(*bad, q, **kw)
    with pytest.raises(ValueError):
        T_kernel.dili_search(*recs, q, root=t["node_rec"].shape[0],
                             max_depth=t["max_depth"])


# ---------------------------------------------------------------------------
# the dense probe's edges, on hand-made tables
# ---------------------------------------------------------------------------

BIG = (1 << 17) + 8          # a dense leaf wider than 16 doublings reach


def synthetic() -> dict:
    """Root (slot = floor(q)) over seven children and an empty slot:
      [0,1) dense, fanout 1;  [1,2) dense, 8 keys, model biased low;
      [2,3) dense, 300 keys, prediction always 0;
      [3,4) dense, 300 keys, prediction always clipped to m1;
      [4,5) / [5,6) dense, BIG keys, prediction 0 / m1 (the 16-step cuts);
      [6,7) non-dense leaf: PAIR, PAIR with a NaN key, PAIR, CHILD -> a
      dense leaf of 2 keys one level deeper; [7,8) EMPTY."""
    f32 = np.float32
    leaves = [  # (a, b, keys, dense)
        (0.0, 0.0, [0.5], True),
        (-12.0, 8.0, [1.25 + 0.0625 * i for i in range(8)], True),
        (0.0, 0.0, [2 + i / 512 for i in range(300)], True),
        (1000.0, 0.0, [3 + i / 512 for i in range(300)], True),
        (0.0, 0.0, list(4 + np.arange(BIG) * 2.0 ** -18), True),
        (1e9, 0.0, list(5 + np.arange(BIG) * 2.0 ** -18), True),
    ]
    a, b, base, fo, dense = [0.0], [1.0], [0], [8], [0]
    tag = [TAG_CHILD] * 7 + [TAG_EMPTY]
    key = [0.0] * 8
    val = list(range(1, 8)) + [0]
    for i, (la, lb, ks, dn) in enumerate(leaves):
        a.append(la), b.append(lb), base.append(len(tag))
        fo.append(len(ks)), dense.append(int(dn))
        tag += [TAG_PAIR] * len(ks)
        key += ks
        val += [100 * (i + 1) + j for j in range(len(ks))]
    # node 7: non-dense leaf over [6,7), slot = floor(4q - 24)
    a.append(-24.0), b.append(4.0), base.append(len(tag))
    fo.append(4), dense.append(0)
    tag += [TAG_PAIR, TAG_PAIR, TAG_PAIR, TAG_CHILD]
    key += [6.0, np.nan, 6.5, 0.0]
    val += [700, 701, 702, 8]
    # node 8: dense leaf of 2 keys at depth 3
    a.append(0.0), b.append(0.0), base.append(len(tag))
    fo.append(2), dense.append(1)
    tag += [TAG_PAIR, TAG_PAIR]
    key += [6.8, 6.9]
    val += [800, 801]
    jarr = dict(a=jnp.asarray(a, f32), b=jnp.asarray(b, f32),
                base=jnp.asarray(base, np.int32),
                fo=jnp.asarray(fo, np.int32),
                dense=jnp.asarray(dense, np.int32),
                tag=jnp.asarray(tag, np.int32), key=jnp.asarray(key, f32),
                val=jnp.asarray(val, np.int32),
                root=jnp.asarray([0], np.int32), max_depth=3)
    return tables(jarr)


@pytest.fixture(scope="module")
def syn():
    return synthetic()


def _leaf_keys(syn, node):
    t = syn["jarr"]
    s = int(t["base"][node])
    return np.asarray(t["key"])[s: s + int(t["fo"][node])]


def _around(keys):
    """Every key, the midpoints between neighbours, and the floats just
    below the first and just above the last."""
    keys = np.asarray(keys, np.float32)
    mids = ((keys[:-1].astype(np.float64) + keys[1:]) / 2).astype(np.float32)
    edge = [np.nextafter(keys[0], np.float32(-np.inf)),
            np.nextafter(keys[-1], np.float32(np.inf))]
    return np.concatenate([keys, mids, np.asarray(edge, np.float32)])


PROBE_CASES = {
    "fanout_1": [1],
    "below_and_above": [2, 3, 4],          # pred clipped at 0 and at m1
    "cut_by_16_steps": [5, 6],
    "deeper_and_nan_pair": [7, 8],
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_dense_probe_edges(case, syn):
    parts = []
    for node in PROBE_CASES[case]:
        ks = _leaf_keys(syn, node)
        if len(ks) > 4096:                 # sample the wide leaves
            pick = np.random.default_rng(node).integers(0, len(ks), 1500)
            ks = np.sort(np.concatenate([ks[pick], ks[:40], ks[-40:],
                                         ks[65530:65545]]))
        parts.append(_around(ks[~np.isnan(ks)]))
    q = np.concatenate(parts + [np.asarray(
        [np.inf, -np.inf, np.nan, 3e9, -3e9, 0.0, -0.0, 7.5, 100.0,
         6.25, 6.3, 6.75], np.float32)])
    got = port_pair(syn, q)
    assert_pairs_equal(syn, q, got, ref_pair(syn, q))
    assert got[1].any() and not got[1].all()


def test_dense_probe_edges_cover_the_cuts(syn):
    """The wide leaves do cut: a key past 2^16 slots from the prediction is
    not found, by the reference and the port alike."""
    ks = _leaf_keys(syn, 5)
    q = ks[[10, 65536, 70000, BIG - 1]]
    got = port_pair(syn, q)
    assert_pairs_equal(syn, q, got, ref_pair(syn, q))
    assert got[1].tolist() == [True, True, False, False]


@pytest.mark.parametrize("dist", ["logn", "wikits"])
def test_dense_leaf_misses_between_keys(dist, cached):
    """Midpoints between the keys of every dense leaf, and the floats just
    outside each leaf's key range."""
    b = cached(dist, 20000)
    f = b["f"]
    parts = []
    for n in np.nonzero(f.dense)[0][:400]:
        ks = np.asarray(f.key[f.base[n]: f.base[n] + f.fo[n]], np.float32)
        parts.append(_around(ks[np.asarray(
            f.tag[f.base[n]: f.base[n] + f.fo[n]]) == TAG_PAIR]))
    q = np.concatenate(parts)
    got = port_pair(b, q)
    assert_pairs_equal(b, q, got, ref_pair(b, q))


@pytest.mark.parametrize("source", ["logn", "fb", "synthetic"])
def test_max_depth_below_snapshot(source, cached, syn):
    """One trip short: lanes standing on a dense leaf are probed, the rest
    miss — as the reference's `search_batch` with the same max_depth."""
    if source == "synthetic":
        b = syn
        q = np.concatenate([_around(_leaf_keys(syn, n)) for n in (1, 2, 8)]
                           + [np.asarray([6.0, 6.5], np.float32)])
    else:
        b = cached(source, 20000)
        q = b["keys32"][np.random.default_rng(26).integers(
            0, len(b["keys32"]), 4096)]
    md = int(b["jarr"]["max_depth"]) - 1
    got = port_pair(b, q, max_depth=md)
    want = J_search.search_batch(J_ops._as_search_idx(b["jarr"]),
                                 jnp.asarray(q), max_depth=md)
    assert_pairs_equal(b, q, got, [np.asarray(x) for x in want])
    assert got[1].any()
    if source == "synthetic":   # node 8's keys: probed on exit; mids miss
        assert got[1][:len(_leaf_keys(syn, 1))].all() and not got[1].all()


@pytest.mark.parametrize("source", ["logn", "synthetic"])
def test_packed_records_match_columns(source, cached, syn):
    """`pack_tables`' records hold the columns field by field: f32 model
    bits, exact int32 base and fo with the dense flag in fo's sign, and per
    slot the key bits (NaN sentinels for non-PAIR tags) and the payload."""
    b = syn if source == "synthetic" else cached(source, 2000)
    j = {k: np.asarray(v) for k, v in b["jarr"].items()}
    t = b["tarr"]
    nr = t["node_rec"].numpy()
    sr = t["slot_rec"].numpy()
    assert nr.dtype == np.int32 and nr.shape == (len(j["a"]), 4)
    assert sr.dtype == np.int32 and sr.shape == (len(j["tag"]), 2)
    np.testing.assert_array_equal(nr[:, 0], j["a"].view(np.int32))
    np.testing.assert_array_equal(nr[:, 1], j["b"].view(np.int32))
    np.testing.assert_array_equal(nr[:, 2], j["base"])
    np.testing.assert_array_equal(np.abs(nr[:, 3]), j["fo"])
    np.testing.assert_array_equal(nr[:, 3] < 0, j["dense"] > 0)
    pair = (j["tag"] == TAG_PAIR) & ~np.isnan(j["key"])
    np.testing.assert_array_equal(sr[pair, 0], j["key"][pair].view(np.int32))
    assert (sr[j["tag"] == TAG_CHILD, 0] == T_ref.CHILD_KEY_BITS).all()
    assert (sr[~pair & (j["tag"] != TAG_CHILD), 0]
            == T_ref.EMPTY_KEY_BITS).all()
    np.testing.assert_array_equal(sr[:, 1], j["val"])
    np.testing.assert_array_equal(t["key"].numpy().view(np.int32),
                                  j["key"].view(np.int32))
    assert t["root"] == int(j["root"][0])
    assert t["max_depth"] == int(j["max_depth"])
    cols = T_ref.unpack_tables(t["node_rec"], t["slot_rec"], t["key"])
    tag = np.where(pair | (j["tag"] != TAG_PAIR), j["tag"], TAG_EMPTY)
    np.testing.assert_array_equal(cols["tag"].numpy(), tag)
    np.testing.assert_array_equal(cols["fo"].numpy(), j["fo"])
    np.testing.assert_array_equal(cols["dense"].numpy(), j["dense"])


# ---------------------------------------------------------------------------
# the f64/i64 instance with the overlay resolve fused in (the local
# engine's lookup) against the reference's `search_with_overlay`
# ---------------------------------------------------------------------------

F64_BUILDS = [("logn", False), ("uniform", False), ("fb", False),
              ("logn", True), ("wikits", True)]


def _f64_id(x):
    return f"{x[0]}-{'lo' if x[1] else 'std'}"


@pytest.fixture(scope="module", params=F64_BUILDS, ids=_f64_id)
def f64_built(request):
    """A reference f64 build (DILI-LO with `local_optimized=False`, where
    every leaf is dense), its snapshot and overlay mirrors in both
    packages, and the port's f64 kernel tables packed from the same
    flat."""
    from repro.core.dili import bulk_load as j_bulk_load
    from repro.online.overlay import (TombstoneOverlay as JOverlay,
                                      overlay_device_arrays as j_ov_arrays)
    from repro_torch.online.overlay import (TombstoneOverlay as TOverlay,
                                            overlay_device_arrays as
                                            t_ov_arrays)
    dist, lo = request.param
    rng = np.random.default_rng(27)
    keys = make_keys(dist, 8000 if lo else 20000, rng)
    d = j_bulk_load(keys, local_optimized=not lo)
    f = flatten(d)
    assert bool(f.dense.any()) == lo
    up = keys[rng.integers(0, len(keys), 300)]
    new = ((keys[:-1] + keys[1:]) / 2)[rng.integers(0, len(keys) - 1, 300)]
    dead = np.concatenate([keys[rng.integers(0, len(keys), 300)],
                           new[:20], [keys[-1] * 2]])

    def writes(ov):
        return (ov.upsert_batch(np.concatenate([up, new]),
                                np.arange(600) + 2 ** 40)
                .delete_batch(dead)
                .upsert_batch(dead[:10], np.arange(10) + 7))

    jov, tov = writes(JOverlay.empty(64)), writes(TOverlay.empty(64))
    return dict(keys=keys, f=f, up=up, new=new, dead=dead,
                jidx=J_search.device_arrays(f, jnp.float64),
                jov=j_ov_arrays(jov, jnp.float64),
                tov=t_ov_arrays(tov, torch.float64, device="cpu"),
                tarr=T_ops.kernel_arrays(f, device="cpu",
                                         dtype=torch.float64))


def _f64_queries(b, rng):
    keys = b["keys"]
    mids = (keys[:-1] + keys[1:]) / 2
    return np.concatenate([
        keys[rng.integers(0, len(keys), 3000)],
        mids[rng.integers(0, len(mids), 1500)],
        b["up"], b["new"], b["dead"],
        [np.inf, -np.inf, np.nan, 3e9, -3e9, keys[-1] * 4 + 1e6,
         keys[0] - 1e6, 0.0, -0.0, keys[0], keys[-1], 1e300]])


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("depth_cut", [0, 1])
def test_f64_overlay_instance_matches_search_with_overlay(
        f64_built, early_exit, depth_cut):
    """The f64 instance's plain version (through `ops` and through the
    wrapper) equals the reference's fused `search_with_overlay` lane for
    lane, with upserts, tombstones and re-upserted tombstones pending,
    early exit either way, and at the snapshot's depth and one short."""
    b = f64_built
    q = _f64_queries(b, np.random.default_rng(28))
    md = int(b["f"].max_depth) - depth_cut
    want = [np.asarray(x) for x in J_search.search_with_overlay(
        b["jidx"], b["jov"], jnp.asarray(q), md, early_exit=early_exit)]
    arrs = dict(b["tarr"], max_depth=md)
    stats = {}
    got = T_ops.search_with_overlay(arrs, b["tov"], torch.from_numpy(q),
                                    early_exit=early_exit, stats=stats)
    assert got[0].dtype == torch.int64 and stats["lanes"] == len(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if depth_cut == 0:
        assert want[1][:3000].sum() > 2500       # mostly hits
        # -inf and NaN never hit; +inf meets the overlay's +inf padding,
        # which the reference reports found with the padding's val 0
        assert want[1][-12:-9].tolist() == [True, False, False]
        assert want[0][-12] == 0


def test_f64_instance_without_overlay_is_search_batch(f64_built):
    """No overlay: the snapshot's (val, found), as `search_batch`."""
    b = f64_built
    q = _f64_queries(b, np.random.default_rng(29))
    t = b["tarr"]
    got = T_kernel.dili_search_f64(t["node_rec"], t["slot_rec"], t["key"],
                                   torch.from_numpy(q), root=t["root"],
                                   max_depth=t["max_depth"])
    want = J_search.search_batch(b["jidx"], jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_f64_pack_tables_round_trip(f64_built):
    """`pack_tables` at f64: 32-byte node records and 16-byte slot
    records with the 64-bit sentinels (a child's carrying its fo, id and
    base), which `unpack_tables` turns back into the flat's columns."""
    b = f64_built
    f, t = b["f"], b["tarr"]
    nr, sr = t["node_rec"], t["slot_rec"]
    assert nr.dtype == torch.int64 and tuple(nr.shape) == (f.n_nodes, 4)
    assert sr.dtype == torch.int64 and tuple(sr.shape) == (f.n_slots, 2)
    assert nr.element_size() * nr.shape[1] == 32
    assert sr.element_size() * sr.shape[1] == 16
    assert t["key"].dtype == torch.float64
    assert (nr[:, 3] == 0).all()                        # the padding word
    cols = T_ref.unpack_tables(nr, sr, t["key"])
    for name in ("a", "b", "base", "fo", "dense", "val"):
        np.testing.assert_array_equal(cols[name].numpy(),
                                      np.asarray(getattr(f, name)), name)
    np.testing.assert_array_equal(cols["key"].numpy().view(np.int64),
                                  np.asarray(f.key).view(np.int64))
    np.testing.assert_array_equal(cols["tag"].numpy(), np.asarray(f.tag))
    kb, vb = sr[:, 0].numpy(), sr[:, 1].numpy()
    child = np.asarray(f.tag) == TAG_CHILD
    cid = np.asarray(f.val)[child]                 # the children's ids
    fo_signed = np.where(np.asarray(f.dense) > 0, -np.asarray(f.fo),
                         np.asarray(f.fo))
    assert (kb[child] >> 32 == T_ref.CHILD_KEY_HI_F64).all()
    np.testing.assert_array_equal(
        (kb[child] & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
        fo_signed[cid])
    np.testing.assert_array_equal(vb[child] & 0xFFFFFFFF, cid)
    np.testing.assert_array_equal(vb[child] >> 32, np.asarray(f.base)[cid])
    assert (kb[np.asarray(f.tag) == TAG_EMPTY] == T_ref.EMPTY_KEY_BITS_F64).all()
    assert T_ops.column_bytes(t) == (f.n_nodes * 28 + f.n_slots * 20 + 4)
    assert T_ops.table_bytes(t) == f.n_nodes * 32 + f.n_slots * 24


def test_f64_wrapper_rejects_bad_inputs(f64_built):
    t = f64_built["tarr"]
    ov = f64_built["tov"]
    q = torch.from_numpy(f64_built["keys"][:64])
    recs = [t["node_rec"], t["slot_rec"], t["key"]]
    kw = dict(root=t["root"], max_depth=t["max_depth"])
    with pytest.raises(TypeError):                      # f32 queries
        T_kernel.dili_search_f64(*recs, q.float(), ov=ov, **kw)
    with pytest.raises(TypeError):                      # f32-width records
        T_kernel.dili_search_f64(recs[0].view(torch.int32), *recs[1:], q,
                                 ov=ov, **kw)
    with pytest.raises(TypeError):                      # f32 key column
        T_kernel.dili_search_f64(recs[0], recs[1], recs[2].float(), q,
                                 ov=ov, **kw)
    with pytest.raises(TypeError):                      # i32 overlay vals
        T_kernel.dili_search_f64(*recs, q, ov=dict(
            ov, vals=ov["vals"].int()), **kw)
    with pytest.raises(ValueError):                     # ragged overlay
        T_kernel.dili_search_f64(*recs, q, ov=dict(
            ov, tomb=ov["tomb"][:-1]), **kw)
    with pytest.raises(TypeError):                      # f64 tables, f32 call
        T_kernel.dili_search(*recs, q.float(), **kw)


# ---------------------------------------------------------------------------
# the f32/i64 instance with the overlay resolve fused in (the local engine
# at dtype=float32) against the reference's `search_with_overlay` at f32
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=F64_BUILDS, ids=_f64_id)
def f32_built(request):
    """A reference build placed in f64 (as the local engine builds at
    dtype=float32), its f32 snapshot and f32 overlay mirrors in both
    packages, and the port's f32/i64 kernel tables packed from the same
    flat."""
    from repro.core.dili import bulk_load as j_bulk_load
    from repro.online.overlay import (TombstoneOverlay as JOverlay,
                                      overlay_device_arrays as j_ov_arrays)
    from repro_torch.online.overlay import (TombstoneOverlay as TOverlay,
                                            overlay_device_arrays as
                                            t_ov_arrays)
    dist, lo = request.param
    rng = np.random.default_rng(31)
    keys = make_keys(dist, 6000 if lo else 20000, rng)
    d = j_bulk_load(keys, local_optimized=not lo)
    f = flatten(d)
    assert bool(f.dense.any()) == lo
    up = keys[rng.integers(0, len(keys), 300)]
    new = ((keys[:-1] + keys[1:]) / 2)[rng.integers(0, len(keys) - 1, 300)]
    dead = np.concatenate([keys[rng.integers(0, len(keys), 300)],
                           new[:20], [keys[-1] * 2]])

    def writes(ov):
        return (ov.upsert_batch(np.concatenate([up, new]),
                                np.arange(600) + 2 ** 40)
                .delete_batch(dead)
                .upsert_batch(dead[:10], np.arange(10) + 7))

    jov, tov = writes(JOverlay.empty(64)), writes(TOverlay.empty(64))
    return dict(keys=keys, f=f, up=up, new=new, dead=dead,
                jidx=J_search.device_arrays(f, jnp.float32),
                jov=j_ov_arrays(jov, jnp.float32),
                tov=t_ov_arrays(tov, torch.float32, device="cpu"),
                tarr=T_ops.kernel_arrays(f, device="cpu",
                                         dtype=torch.float32,
                                         val_dtype=torch.int64))


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("depth_cut", [0, 1])
def test_f32_i64_overlay_instance_matches_search_with_overlay(
        f32_built, early_exit, depth_cut):
    """The f32/i64 instance's plain version (through `ops`, which picks it
    from the tables' key dtype) equals the reference's fused
    `search_with_overlay` at f32 lane for lane — the misses on keys that
    f32 does not hold exactly included — with upserts, tombstones and
    re-upserted tombstones pending, early exit either way, and at the
    snapshot's depth and one short."""
    b = f32_built
    with np.errstate(over="ignore"):              # 1e300 -> +inf
        q = _f64_queries(b, np.random.default_rng(32)).astype(np.float32)
    md = int(b["f"].max_depth) - depth_cut
    want = [np.asarray(x) for x in J_search.search_with_overlay(
        b["jidx"], b["jov"], jnp.asarray(q), md, early_exit=early_exit)]
    arrs = dict(b["tarr"], max_depth=md)
    stats = {}
    got = T_ops.search_with_overlay(arrs, b["tov"], torch.from_numpy(q),
                                    early_exit=early_exit, stats=stats)
    assert got[0].dtype == torch.int64 and stats["lanes"] == len(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if depth_cut == 0 and not b["f"].dense.any():
        # f32 casts of an f64-placed tree: the reference misses some of
        # the keys, and so must the port
        assert 1000 < want[1][:3000].sum() < 3000


def test_f32_i64_two_roundings_would_disagree(f32_built):
    """The reason the instance predicts with one rounding: the reference's
    answers are the fused multiply-add's (walk and dense probe), and on a
    standard build a two-rounding walk finds keys the reference misses."""
    from repro_torch.core import search as TS
    b = f32_built
    q = b["keys"].astype(np.float32)
    want = np.asarray(J_search.search_batch(b["jidx"], jnp.asarray(q))[1])
    t = b["tarr"]
    cols = T_ref.unpack_tables(t["node_rec"], t["slot_rec"], t["key"])
    assert cols["fused"]
    idx = dict(cols, root=torch.tensor(t["root"]),
               has_dense=bool(b["f"].dense.any()))
    qt = torch.from_numpy(q)
    fused = TS.search_batch(idx, qt, max_depth=t["max_depth"])[1].numpy()
    two = TS.search_batch(dict(idx, fused=False), qt,
                          max_depth=t["max_depth"])[1].numpy()
    np.testing.assert_array_equal(fused, want)
    if not b["f"].dense.any():
        assert two.sum() > want.sum()


def test_f32_i64_pack_tables_round_trip(f32_built):
    """`pack_tables` at f32 keys with i64 payloads: the f32 instance's
    16-byte node records and 16-byte slot records {f32 key bits, 4 bytes
    of padding, i64 val}, which `unpack_tables` turns back into the flat's
    columns (keys and models cast to f32)."""
    b = f32_built
    f, t = b["f"], b["tarr"]
    nr, sr = t["node_rec"], t["slot_rec"]
    assert nr.dtype == torch.int32 and tuple(nr.shape) == (f.n_nodes, 4)
    assert sr.dtype == torch.int64 and tuple(sr.shape) == (f.n_slots, 2)
    assert sr.element_size() * sr.shape[1] == 16
    assert t["key"].dtype == torch.float32
    assert (sr.view(torch.int32)[:, 1] == 0).all()      # the padding
    cols = T_ref.unpack_tables(nr, sr, t["key"])
    for name in ("base", "fo", "dense", "val"):
        np.testing.assert_array_equal(cols[name].numpy(),
                                      np.asarray(getattr(f, name)), name)
    for name in ("a", "b"):
        np.testing.assert_array_equal(
            cols[name].numpy(), np.asarray(getattr(f, name), np.float32))
    np.testing.assert_array_equal(cols["key"].numpy().view(np.int32),
                                  np.asarray(f.key, np.float32).view(
                                      np.int32))
    np.testing.assert_array_equal(cols["tag"].numpy(), np.asarray(f.tag))
    kb = sr.view(torch.int32)[:, 0].numpy()
    assert (kb[np.asarray(f.tag) == TAG_CHILD] == T_ref.CHILD_KEY_BITS).all()
    assert (kb[np.asarray(f.tag) == TAG_EMPTY] == T_ref.EMPTY_KEY_BITS).all()
    assert T_ops.column_bytes(t) == (f.n_nodes * 20 + f.n_slots * 16 + 4)
    assert T_ops.table_bytes(t) == f.n_nodes * 16 + f.n_slots * 20


def test_f32_i64_wrapper_rejects_bad_inputs(f32_built):
    t = f32_built["tarr"]
    ov = f32_built["tov"]
    q = torch.from_numpy(f32_built["keys"][:64].astype(np.float32))
    recs = [t["node_rec"], t["slot_rec"], t["key"]]
    kw = dict(root=t["root"], max_depth=t["max_depth"])
    with pytest.raises(TypeError):                      # f64 queries
        T_kernel.dili_search_f32_i64(*recs, q.double(), ov=ov, **kw)
    with pytest.raises(TypeError):                      # i32 slot records
        T_kernel.dili_search_f32_i64(recs[0], recs[1].view(torch.int32)
                                     [:, :2].contiguous(), recs[2], q,
                                     ov=ov, **kw)
    with pytest.raises(TypeError):                      # f64 overlay keys
        T_kernel.dili_search_f32_i64(*recs, q, ov=dict(
            ov, keys=ov["keys"].double()), **kw)
    with pytest.raises(TypeError):                      # f32/i32 call
        T_kernel.dili_search(*recs, q, **kw)
    with pytest.raises(TypeError):                      # f64/i64 call
        T_kernel.dili_search_f64(*recs, q.double(), ov=ov, **kw)
    with pytest.raises(TypeError):
        T_ops.pack_tables(dict(a=[0.0], b=[0.0], base=[0], fo=[1],
                               dense=[0], tag=[0], key=[0.0], val=[0],
                               root=0, max_depth=1), device="cpu",
                          dtype=torch.float64, val_dtype=torch.int32)


def test_fma_f32_is_correctly_rounded():
    """`core.search.fma_f32` rounds a + b*q once, to nearest even: held to
    exact rational arithmetic on random operands and on constructed
    double-rounding traps (the exact result just off an f32 midpoint
    that the f64 sum rounds onto)."""
    from fractions import Fraction
    from repro_torch.core.search import fma_f32
    rng = np.random.default_rng(33)
    a = rng.uniform(-1e3, 1e3, 3000).astype(np.float32)
    b = rng.uniform(-1e3, 1e3, 3000).astype(np.float32)
    q = rng.uniform(-10, 10, 3000).astype(np.float32)
    # traps: a = 1, b*q = 2^-24 (half an ulp of 1) plus a sliver of
    # +-2^-60 that f64 loses: the exact result lies just above or below
    # the midpoint 1 + 2^-24
    sliver = [(np.float32(1.0), np.float32(2.0 ** -24 + 2.0 ** -47),
               np.float32(1.0 + s * 2.0 ** -13)) for s in (1, -1)]
    for x, y, z in sliver:
        a, b, q = (np.append(a, x), np.append(b, y), np.append(q, z))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(q)).numpy()
    for x, y, z, g in zip(a, b, q, got):
        exact = Fraction(float(x)) + Fraction(float(y)) * Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(c)) - exact) for c in cands]
        best = min(errs)
        want = [c for c, e in zip(cands, errs) if e == best]
        want = (want[0] if len(want) == 1 else
                [c for c in want if not (c.view(np.int32) & 1)][0])
        assert g == want, (x, y, z, g, want)


# ---------------------------------------------------------------------------
# the overlay membership filter of the i64 instances
# ---------------------------------------------------------------------------


def test_overlay_filter_leaves_the_plain_version_alone(f64_built):
    """On the CPU a mirror with its membership filter gives the same
    (val, found) as without it (the plain version resolves the whole
    overlay either way); a filter that is not int32 words, a power of
    two and at least 32 of them, is refused."""
    t, ov = f64_built["tarr"], f64_built["tov"]
    q = torch.from_numpy(_f64_queries(f64_built, np.random.default_rng(34)))
    recs = [t["node_rec"], t["slot_rec"], t["key"], q]
    kw = dict(root=t["root"], max_depth=t["max_depth"])
    bare = {k: ov[k] for k in ("keys", "vals", "tomb")}
    filt = T_kernel.overlay_filter(bare["keys"].numpy())
    want = T_kernel.dili_search_f64(*recs, ov=bare, **kw)
    got = T_kernel.dili_search_f64(*recs, ov=dict(bare, filter=filt), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for bad in (filt[:48], filt[:16], filt.to(torch.int64)):
        with pytest.raises((TypeError, ValueError)):
            T_kernel.dili_search_f64(*recs, ov=dict(bare, filter=bad), **kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 64, 4096, 65536])
def test_overlay_filter_has_no_false_negatives(n, dtype):
    """Every query equal to an overlay key (its +inf padding, duplicates
    and -0/+0 included) finds its bit set in `overlay_filter`, so the
    kernel skips the overlay only for queries no key equals: over
    seeded overlays, `resolve_overlay` leaves the snapshot's result on
    every lane whose bit is clear.  The filter has 16 bits a key, at
    least 1024, and sets few enough that most misses skip."""
    from repro_torch.core.search import resolve_overlay
    npt = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(n + 3)
    for fill in sorted({0, n // 2, n}):
        extra = [0.0, -0.0, 1.5, 1.5][:min(fill, 4)]      # +-0, a duplicate
        k = np.sort(np.concatenate([rng.normal(0, 100, fill - len(extra)),
                                    extra]))
        k = np.concatenate([k, np.full(n - fill, np.inf)]).astype(npt)
        filt = T_kernel.overlay_filter(k, dtype)
        words = filt.shape[0] * 32
        assert words >= max(1024, 16 * n) and not words & (words - 1)
        q = np.concatenate([k, -k, rng.normal(0, 100, 4000),
                            [0.0, -0.0, np.inf, -np.inf, np.nan]]).astype(npt)
        hold = T_ref.filter_may_hold(filt, q)
        assert hold[:n].all()
        assert hold[np.isin(q, k)].all()
        ov = dict(keys=torch.from_numpy(k),
                  vals=torch.from_numpy(rng.integers(0, 1 << 40, n)),
                  tomb=torch.from_numpy((rng.random(n) < 0.3).astype(
                      np.int8)))
        snap_v = torch.from_numpy(rng.integers(0, 1 << 40, len(q)))
        snap_f = torch.from_numpy(rng.random(len(q)) < 0.5)
        v, f = resolve_overlay(ov, torch.from_numpy(q), snap_v, snap_f)
        skip = torch.from_numpy(~hold)
        assert torch.equal(v[skip], snap_v[skip])
        assert torch.equal(f[skip], snap_f[skip])
        misses = ~np.isin(q[2 * n:], k)
        assert hold[2 * n:][misses].mean() < 0.2
