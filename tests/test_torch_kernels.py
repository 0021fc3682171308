"""The port's lookup kernel against the Pallas kernel.

The cases of tests/test_kernels.py, run through the port's plain version
(the CPU path of `repro_torch.kernels.dili_search`) and its dispatch
(`ops.dili_search`) against `dili_search_pallas(..., interpret=True)` and
`repro.kernels.ref.dili_search_ref` on identical tables.  Bit-exact: the
outputs are int32 values and bools.  The CUDA kernel against this plain
version is tests/test_torch_cuda.py (needs a card, imports no JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dili import placement_dtype as j_placement
from repro.core.flat import flatten
from repro.kernels import ops as J_ops
from repro.kernels.dili_search import dili_search_pallas
from repro.kernels.ref import dili_search_ref as j_ref
from repro_torch.api.snapshot import from_numpy_tables
from repro_torch.kernels import dili_search as T_kernel
from repro_torch.kernels import ops as T_ops
from tests.conftest import make_keys

NAMES = ("a", "b", "base", "fo", "dense", "tag", "key", "val", "root")


def build(dist, n, seed=21):
    """Reference build; the port gets the same tables as tensors."""
    keys = make_keys(dist, n, np.random.default_rng(seed))
    d, keys32 = J_ops.build_f32_index(keys)
    f = flatten(d)
    jarr = J_ops.kernel_arrays(f)
    tarr = from_numpy_tables({k: np.asarray(v) for k, v in jarr.items()},
                             device="cpu")
    return dict(keys32=keys32, d=d, f=f, jarr=jarr, tarr=tarr)


@pytest.fixture(scope="module")
def cached():
    """build(dist, n), shared across this module's tests."""
    memo: dict = {}

    def get(dist, n):
        if (dist, n) not in memo:
            memo[(dist, n)] = build(dist, n)
        return memo[(dist, n)]
    return get


def port_triple(b, q):
    t = b["tarr"]
    out = T_kernel.dili_search(*(t[k] for k in NAMES), torch.from_numpy(q),
                               max_depth=t["max_depth"])
    return [x.numpy() for x in out]


def pallas_triple(b, q, block_q=T_kernel.BLOCK_Q):
    j = b["jarr"]
    pad = (-len(q)) % block_q
    qp = np.concatenate([q, np.full(pad, np.inf, np.float32)])
    out = dili_search_pallas(*(j[k] for k in NAMES), jnp.asarray(qp),
                             max_depth=j["max_depth"], interpret=True,
                             block_q=block_q)
    return [np.asarray(x)[: len(q)] for x in out]


def ref_triple(b, q):
    j = b["jarr"]
    out = j_ref(*(j[k] for k in NAMES[:-1]), j["root"][0], jnp.asarray(q),
                j["max_depth"])
    return [np.asarray(x) for x in out]


def assert_triples_equal(b, q, got, want):
    """Bit equality; on a mismatch, name the side the host walk
    (`DILI.search` under f32 placement) disagrees with."""
    for g, w in zip(got, want):
        bad = np.nonzero(g != w)[0]
        if len(bad):
            i = int(bad[0])
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
    got = port_triple(b, q)
    assert_triples_equal(b, q, got, pallas_triple(b, q))
    assert_triples_equal(b, q, got, ref_triple(b, q))
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(q))
    assert bool(fnd.all())
    assert np.array_equal(v.numpy(), qi)
    jv, jf = J_ops.dili_search(b["jarr"], jnp.asarray(q))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(fnd.numpy(), np.asarray(jf))


@pytest.mark.parametrize("block_q", [512, 2048])
def test_kernel_matches_pallas_block_sizes(block_q, cached):
    b = cached("logn", 20000)
    rng = np.random.default_rng(23)
    q = b["keys32"][rng.integers(0, len(b["keys32"]), 4096)]
    assert_triples_equal(b, q, port_triple(b, q),
                         pallas_triple(b, q, block_q=block_q))


def test_kernel_misses_no_false_positives(cached):
    b = cached("uniform", 20000)
    keys32 = b["keys32"]
    rng = np.random.default_rng(24)
    qi = rng.integers(0, len(keys32) - 1, 2048)
    mids = ((keys32[qi].astype(np.float64)
             + keys32[qi + 1].astype(np.float64)) / 2).astype(np.float32)
    ok = (mids != keys32[qi]) & (mids != keys32[qi + 1])
    assert_triples_equal(b, mids, port_triple(b, mids),
                         pallas_triple(b, mids))
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(mids))
    assert not fnd.numpy()[ok].any()
    jv, jf = J_ops.dili_search(b["jarr"], jnp.asarray(mids))
    np.testing.assert_array_equal(fnd.numpy(), np.asarray(jf))


def test_kernel_pads_ragged_batch(cached):
    b = cached("logn", 5000)
    q = b["keys32"][:777]                            # not a block multiple
    stats = {}
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(q), stats=stats)
    assert fnd.shape == (777,) and bool(fnd.all())
    assert np.array_equal(v.numpy(), np.arange(777))
    assert stats["lanes"] == T_kernel.BLOCK_Q
    assert_triples_equal(b, q, port_triple(b, q), pallas_triple(b, q))


def test_out_of_range_and_pad_lanes(cached):
    """+inf pad lanes and queries far above/below the key range: XLA's
    saturating cast sends them to the last/first slot; never a hit."""
    b = cached("fb", 2000)
    k = b["keys32"]
    q = np.asarray([np.inf, 3e9, 1e30, k[-1] * 2, -1e30, -np.inf, 0.0,
                    k[0], k[-1]], np.float32)
    got = port_triple(b, q)
    assert_triples_equal(b, q, got, pallas_triple(b, q))
    assert not got[1][:7].any()
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(q))
    assert fnd.numpy().tolist() == [False] * 7 + [True, True]
    jv, jf = J_ops.dili_search(b["jarr"], jnp.asarray(q))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_dense_leaf_table_recheck(cached):
    """logn at f32 placement has dense leaves: the kernel flags their lanes
    and the dispatch's whole-batch recheck resolves them, as the
    reference's does."""
    b = cached("logn", 20000)
    assert b["f"].dense.any()
    rng = np.random.default_rng(25)
    keys32 = b["keys32"]
    qi = rng.integers(0, len(keys32), 4096)
    q = keys32[qi]
    got = port_triple(b, q)
    assert got[2].any()                              # some lanes flagged
    assert_triples_equal(b, q, got, pallas_triple(b, q))
    stats = {}
    v, fnd = T_ops.dili_search(b["tarr"], torch.from_numpy(q), stats=stats)
    assert stats["flagged"] == int(got[2].sum())
    assert bool(fnd.all()) and np.array_equal(v.numpy(), qi)
    jv, jf = J_ops.dili_search(b["jarr"], jnp.asarray(q))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_wrapper_rejects_bad_inputs(cached):
    b = cached("logn", 2000)
    t = dict(b["tarr"])
    q = torch.from_numpy(b["keys32"][:64])
    args = [t[k] for k in NAMES]
    with pytest.raises(TypeError):
        T_kernel.dili_search(*args, q.double(), max_depth=t["max_depth"])
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        T_kernel.dili_search(*bad, q, max_depth=t["max_depth"])
    with pytest.raises(ValueError):
        T_kernel.dili_search(*args, torch.from_numpy(
            b["keys32"][:128])[::2], max_depth=t["max_depth"])
    bad = list(args)
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError):
        T_kernel.dili_search(*bad, q, max_depth=t["max_depth"])

