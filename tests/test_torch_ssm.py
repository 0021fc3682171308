"""The port's Mamba-1/Mamba-2 blocks (`repro_torch.models.mamba`) and the
ssm and hybrid families of its LM against the JAX package on the CPU.

No config in `configs/` has either family, so both packages build the two
seed configs pruned from `configs/` (falcon-mamba-7b, ssm; zamba2-1.2b,
hybrid) at `.reduced()` sizes; the hybrid has 5 layers with the shared
block every 2, so three cache sites, two of them used.  Inputs come from
numpy seeds, and both run on the same weights (the reference's
`init_params` tree carried in by `params_from_reference`).  Every float
comparison is relative to the reference's largest magnitude, within
`RTOL` (the scans differ from XLA's only where XLA contracts
`b_l * a_r + b_r` into one FMA); greedy tokens are equal.  The chunk
invariance tests are the reference's (`tests/test_models.py`), on the
port's scans, at their `atol`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import config as JC
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.train import optim as JO
from repro.train import step as JSTEP
from repro_torch.ft import checkpoint as CKPT
from repro_torch.models import config as TC
from repro_torch.models import mamba as MB
from repro_torch.models import model as MDL
from repro_torch.train import optim as O
from repro_torch.train import step as STEP

CPU = torch.device("cpu")
RTOL = 1e-5
CHUNK_ATOL = 1e-4        # the reference's chunk-invariance tolerance

# the seed's configs/falcon_mamba_7b.py and configs/zamba2_1p2b.py
FALCON_MAMBA_7B = dict(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024, ssm_state=16,
    ssm_version=1, expand=2, d_conv=4, tie_embeddings=False)
ZAMBA2_1P2B = dict(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, ssm_state=64,
    ssm_version=2, ssm_heads=32, expand=2, d_conv=4, shared_attn_every=6,
    act="gelu")
CASES = {"ssm": (FALCON_MAMBA_7B, {}),
         "hybrid": (ZAMBA2_1P2B, dict(n_layers=5, shared_attn_every=2))}


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


_MODELS = {}


def _case(family: str, **overrides):
    """(reference cfg, port cfg, reference params, port module)."""
    key = (family, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        base, ov = CASES[family]
        ov = dict(ov, **overrides)
        cfg = JC.ModelConfig(**base).reduced(**ov)
        tcfg = TC.ModelConfig(**base).reduced(**ov)
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        _MODELS[key] = (cfg, tcfg, params, _np_tree(params))
    cfg, tcfg, params, tree = _MODELS[key]
    return cfg, tcfg, params, MDL.params_from_reference(tcfg, tree,
                                                        device=CPU)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _scan_inputs(seed, b, s, di, ds):
    rng = np.random.default_rng(seed)
    u = _randn(rng, b, s, di)
    dt_ = np.log1p(np.exp(_randn(rng, b, s, di))).astype(np.float32)
    A = -np.exp(_randn(rng, di, ds, scale=0.1))
    return (u, dt_, A, _randn(rng, b, s, ds), _randn(rng, b, s, ds),
            _randn(rng, b, di, ds))


def _ssd_inputs(seed, b, s, nh, hd, ds):
    rng = np.random.default_rng(seed)
    u = _randn(rng, b, s, nh, hd)
    dt_ = np.log1p(np.exp(_randn(rng, b, s, nh))).astype(np.float32)
    A = -np.exp(_randn(rng, nh, scale=0.1))
    return (u, dt_, A, _randn(rng, b, s, ds), _randn(rng, b, s, ds),
            _randn(rng, b, nh, hd, ds))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# per function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(1)
    x, w, b = _randn(rng, 2, 9, 24), _randn(rng, 4, 24), _randn(rng, 24)
    state = _randn(rng, 2, 3, 24) if with_state else None
    jy, js = JMB._causal_conv(*_j(x, w, b),
                              None if state is None else jnp.asarray(state))
    ty, ts = MB._causal_conv(*_t(x, w, b),
                             None if state is None else torch.tensor(state))
    assert _rel(ty, jy) <= RTOL and _rel(ts, js) == 0.0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(50, 64), (50, 16), (1, 64)])
def test_selective_scan_matches_reference(with_h0, s, chunk):
    u, dt_, A, Bm, Cm, h0 = _scan_inputs(2, 2, s, 16, 8)
    h0 = h0 if with_h0 else None
    jy, jh = JMB._selective_scan(*_j(u, dt_, A, Bm, Cm),
                                 None if h0 is None else jnp.asarray(h0),
                                 chunk=chunk)
    ty, th = MB._selective_scan(*_t(u, dt_, A, Bm, Cm),
                                None if h0 is None else torch.tensor(h0),
                                chunk=chunk)
    assert ty.shape == jy.shape and th.dtype == torch.float32
    assert _rel(ty, jy) <= RTOL and _rel(th, jh) <= RTOL


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(40, 64), (40, 16)])
def test_ssd_scan_matches_reference(with_h0, s, chunk):
    u, dt_, A, Bm, Cm, h0 = _ssd_inputs(3, 2, s, 4, 8, 16)
    h0 = h0 if with_h0 else None
    jy, jh = JMB._ssd_scan(*_j(u, dt_, A, Bm, Cm),
                           None if h0 is None else jnp.asarray(h0),
                           chunk=chunk)
    ty, th = MB._ssd_scan(*_t(u, dt_, A, Bm, Cm),
                          None if h0 is None else torch.tensor(h0),
                          chunk=chunk)
    assert _rel(ty, jy) <= RTOL and _rel(th, jh) <= RTOL


def test_ssd_scan_gradient_where_the_reference_overflows():
    """A chunk whose cumulative log-decay spans more than ~88.7: the
    reference's `exp(g_t - g_s)` overflows above the diagonal and its
    gradient through dt is NaN (0 * inf behind `where`).  The port masks
    the exponent first: the same forward within RTOL, a finite dt
    gradient, and the reference's u gradient (finite there)."""
    u, _, _, Bm, Cm, _ = _ssd_inputs(7, 1, 64, 2, 4, 8)
    dt_ = np.full((1, 64, 2), 2.0, np.float32)
    A = -np.ones((2,), np.float32)

    def ref(u, dt):
        return JMB._ssd_scan(u, dt, jnp.asarray(A), jnp.asarray(Bm),
                             jnp.asarray(Cm), None)[0].sum()
    jdu, jddt = jax.grad(ref, argnums=(0, 1))(jnp.asarray(u),
                                              jnp.asarray(dt_))
    assert np.isnan(np.asarray(jddt)).any()          # the reference's fault
    tu, tdt = (torch.tensor(u, requires_grad=True),
               torch.tensor(dt_, requires_grad=True))
    y, _ = MB._ssd_scan(tu, tdt, *_t(A, Bm, Cm), None)
    y.sum().backward()
    jy, _ = JMB._ssd_scan(*_j(u, dt_, A, Bm, Cm), None)
    assert _rel(y, jy) <= RTOL
    assert bool(torch.isfinite(tdt.grad).all())
    assert _rel(tu.grad, jdu) <= RTOL


def test_associative_scan_is_jax_recursion():
    """Any length, the scan's combine order is jax's: on integers (no
    rounding) and a non-commutative combine (2x2 matrix products) the
    prefixes are equal exactly."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 7, 8, 13):
        m = rng.integers(-2, 3, (n, 2, 2)).astype(np.int64)

        def jfn(a, b):
            return (jnp.einsum("...ij,...jk->...ik", a[0], b[0]),)

        def tfn(a, b):
            return (a[0] @ b[0],)
        want = jax.lax.associative_scan(jfn, (jnp.asarray(m),), axis=0)[0]
        got = MB.associative_scan(tfn, (torch.from_numpy(m),), axis=0)[0]
        assert np.array_equal(got.numpy(), np.asarray(want)), n


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_blocks_match_reference(family, with_state):
    cfg, tcfg, params, model = _case(family)
    jp = jax.tree.map(lambda a: a[1], params["layers"]["mamba"])
    tp = model.layers[1].mamba
    rng = np.random.default_rng(5)
    s = 1 if with_state else 19
    x = _randn(rng, 2, s, cfg.d_model)
    state = None
    if with_state:
        cache = MDL.make_cache(tcfg, 2, 4, device=CPU)
        state = (_randn(rng, *cache["conv"].shape[1:]),
                 _randn(rng, *cache["ssm"].shape[1:]))
    jblk = JMB.mamba_block if family == "ssm" else JMB.mamba2_block
    tblk = MB.mamba_block if family == "ssm" else MB.mamba2_block
    jy, (jc, jh) = jblk(jp, cfg, jnp.asarray(x),
                        None if state is None else tuple(_j(*state)))
    with torch.no_grad():
        ty, (tc, th) = tblk(tp, tcfg, torch.from_numpy(x),
                            None if state is None else tuple(_t(*state)))
    for got, want in ((ty, jy), (tc, jc), (th, jh)):
        assert tuple(got.shape) == want.shape
        assert _rel(got, want) <= RTOL


def test_modules_have_reference_names_shapes_and_dtypes():
    for family in ("ssm", "hybrid"):
        cfg, tcfg, params, model = _case(family)
        want = {".".join(str(k.key) for k in path): (a.shape, str(a.dtype))
                for path, a in jax.tree_util.tree_flatten_with_path(
                    params)[0]}
        got = {k: (a.shape, str(a.dtype)) for k, a in _flat(
            MDL.host_tree(MDL.param_tree(model), CKPT.to_numpy))}
        assert got == want
    bf = TC.ModelConfig(**FALCON_MAMBA_7B).reduced(dtype="bfloat16")
    m = MDL.init_params(bf, torch.Generator().manual_seed(0), device=CPU)
    mb = m.layers[0].mamba
    assert mb.w_in.dtype == mb.conv_w.dtype == torch.bfloat16
    assert mb.a_log.dtype == mb.d_skip.dtype == torch.float32


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_forward_loss_and_gradients_match_reference(family):
    """Logits, loss and every gradient leaf against
    `jax.value_and_grad` of the reference's `loss_fn` (remat `dots` in
    both)."""
    cfg, tcfg, params, model = _case(family)
    toks = _tokens(cfg, 2, 24)
    labels = np.roll(toks, -1, axis=1)
    want, _ = jax.jit(JM.forward_train, static_argnums=1)(
        params, cfg, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = MDL.forward_train(model, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert _rel(got, want) <= RTOL
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jnp.asarray(toks),
                             jnp.asarray(labels))))(params)
    model.requires_grad_(True)
    tree = MDL.param_tree(model)
    loss = MDL.loss_fn(model, tcfg, torch.from_numpy(toks),
                       torch.from_numpy(labels))
    grads = iter(torch.autograd.grad(loss, O.tree_tensors(tree)))
    gtree = O.tree_map(lambda p: [next(grads) for _ in p]
                       if isinstance(p, list) else next(grads), tree)
    assert abs(float(loss.detach()) - float(jl)) <= RTOL * abs(float(jl))
    got_g = dict(_flat(MDL.host_tree(gtree, CKPT.to_numpy)))
    want_g = dict(_flat(_np_tree(jg)))
    assert got_g.keys() == want_g.keys()
    for k, w in want_g.items():
        if np.abs(w).max() == 0:
            assert np.abs(got_g[k]).max() == 0, k
        else:
            assert _rel(got_g[k], w) <= RTOL, (k, _rel(got_g[k], w))


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_prefill_and_greedy_decode_match_reference(family):
    """Prefill of 21 tokens, then 4 greedy decode steps: equal tokens,
    logits and the conv, ssm and shared-site states within RTOL."""
    cfg, tcfg, params, model = _case(family)
    B, S, steps = 2, 21, 4
    toks = _tokens(cfg, B, S, seed=1)
    jcache = JM.make_cache(cfg, B, S + steps + 1)
    tcache = MDL.make_cache(tcfg, B, S + steps + 1, device=CPU)
    assert {k: tuple(v.shape) for k, v in tcache.items() if k != "pos"} == \
        {k: v.shape for k, v in jcache.items() if k != "pos"}
    assert {k: str(v.dtype).replace("torch.", "")
            for k, v in tcache.items() if k != "pos"} == \
        {k: str(v.dtype) for k, v in jcache.items() if k != "pos"}
    jl, jcache = JM.prefill(params, cfg, jnp.asarray(toks), jcache)
    tl, tcache = MDL.prefill(model, tcfg, torch.from_numpy(toks), tcache)
    assert tcache["pos"] == int(jcache["pos"]) == S
    assert _rel(tl, jl) <= RTOL
    for k in jcache:
        if k != "pos":
            assert _rel(tcache[k], jcache[k]) <= RTOL, k
    if family == "hybrid":      # 3 sites, the last unused: zero in both
        assert not tcache["shared_k"][2].any()
        assert not np.asarray(jcache["shared_k"][2]).any()
        assert not tcache["shared_k"][:, :, S:].any()
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    for _ in range(steps):
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        jl, jcache = JM.decode_step(params, cfg, jt, jcache)
        tl, tcache = MDL.decode_step(model, tcfg, tt, tcache)
        assert _rel(tl, jl) <= RTOL
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert tcache["pos"] == int(jcache["pos"]) == S + steps
    for k in jcache:
        if k != "pos":
            assert _rel(tcache[k], jcache[k]) <= RTOL, k


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_decode_matches_full_forward(family):
    """The reference's decode property (tests/test_models.py) on the
    port alone: prefill of 20 tokens and one decode step give the 21st
    token the full forward's logits within 2e-2 relative."""
    _, tcfg, _, model = _case(family)
    toks = torch.from_numpy(_tokens(tcfg, 2, 21, seed=2))
    with torch.no_grad():
        full, _ = MDL.forward_train(model, tcfg, toks)
    cache = MDL.make_cache(tcfg, 2, 24, device=CPU)
    _, cache = MDL.prefill(model, tcfg, toks[:, :20], cache)
    lg, _ = MDL.decode_step(model, tcfg, toks[:, 20:21], cache)
    assert _rel(lg[:, 0], full[:, -1].numpy()) < 2e-2


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_remat_modes_give_equal_gradients(family):
    """remat none, dots and full: the same loss and gradients."""
    out = {}
    for remat in ("none", "dots", "full"):
        _, tcfg, _, model = _case(family, remat=remat)
        toks = torch.from_numpy(_tokens(tcfg, 2, 16, seed=3))
        model.requires_grad_(True)
        loss = MDL.loss_fn(model, tcfg, toks, torch.roll(toks, -1, 1))
        out[remat] = (float(loss), torch.autograd.grad(
            loss, list(model.parameters())))
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def test_train_steps_and_state_match_reference(tmp_path):
    """The train step, AdamW (what `pick_optimizer` gives both seed
    configs) and `ft` take both families unchanged: 3 steps' losses and
    grad norms against the reference's jitted step, then the state saved
    by the port restores in the reference bit for bit."""
    from repro.ft import checkpoint as JCKPT
    for family in ("ssm", "hybrid"):
        cfg, tcfg, params, model = _case(family)
        jopt, topt = JO.adamw(lr=3e-3), O.adamw(lr=3e-3)
        jstate = dict(params=params, opt=jopt.init(params),
                      step=jnp.zeros((), jnp.int32))
        tstate = dict(params=model, opt=topt.init(MDL.param_tree(model)),
                      step=torch.zeros((), dtype=torch.int32))
        jstep = jax.jit(JSTEP.make_train_step(cfg, jopt))
        tstep = STEP.make_train_step(tcfg, topt)
        for i in range(3):
            rng = np.random.default_rng(10 + i)
            b = dict(tokens=rng.integers(0, cfg.vocab, (2, 16)),
                     labels=rng.integers(0, cfg.vocab, (2, 16)))
            b = {k: v.astype(np.int32) for k, v in b.items()}
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
                RTOL * abs(float(jm["loss"]))
            assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
                1e-4 * float(jm["grad_norm"])
        d = str(tmp_path / family)
        STEP.save_state(d, 3, tstate)
        tmpl = jax.eval_shape(lambda: JSTEP.init_state(
            jax.random.PRNGKey(0), cfg, jopt))
        got, man = JCKPT.restore(d, tmpl)
        assert man["step"] == 3
        want = dict(_flat(STEP.host_state(tstate)))
        for k, a in _flat(_np_tree(got)):
            assert np.array_equal(a, want[k]), k


# ---------------------------------------------------------------------------
# chunk invariance (tests/test_models.py, on the port's scans)
# ---------------------------------------------------------------------------


def test_selective_scan_chunk_invariance():
    u, dt_, A, Bm, Cm, _ = _scan_inputs(5, 2, 50, 16, 8)
    args = _t(u, dt_, A, Bm, Cm)
    y1, h1 = MB._selective_scan(*args, chunk=64)
    y2, h2 = MB._selective_scan(*args, chunk=7)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=CHUNK_ATOL)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=CHUNK_ATOL)


def test_ssd_chunk_invariance():
    u, dt_, A, Bm, Cm, _ = _ssd_inputs(6, 2, 40, 4, 8, 16)
    args = _t(u, dt_, A, Bm, Cm)
    y1, h1 = MB._ssd_scan(*args, None, chunk=64)
    y2, h2 = MB._ssd_scan(*args, None, chunk=5)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=CHUNK_ATOL)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=CHUNK_ATOL)
