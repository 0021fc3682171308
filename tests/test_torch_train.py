"""The port's training path (`repro_torch.train`, `ft`, `data.pipeline`,
`parallel.compression`, `launch.train`) against the JAX package on the CPU.

Inputs come from numpy seeds; both packages run on the same weights (the
reference's `init_params` tree carried in by `params_from_reference`, or a
checkpoint one package wrote and the other restored).  Tolerances, each
stated where it is used:
  * optimizers on identical params and grads, 3 steps: params and every
    moment within `OPT_RTOL` of the leaf's largest magnitude;
  * a train step: loss within `LOSS_RTOL` relative, the grad norm within
    `NORM_RTOL` relative, every gradient leaf within `GRAD_RTOL` of the
    leaf's largest |g| (the largest gap measured is printed with `-s`);
  * batches, int8 quantization and error feedback: bit for bit;
  * checkpoints: bytes, CRCs and manifests equal; restored leaves equal.
"""
import dataclasses
import glob
import io
import json
import os
import shutil
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, list_archs
from repro.data import pipeline as JP
from repro.data.record_store import RecordStore as JRecordStore
from repro.ft import checkpoint as JCKPT
from repro.launch import train as JLAUNCH
from repro.models import model as JM
from repro.parallel import compression as JCOMP
from repro.train import optim as JO
from repro.train import step as JSTEP
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TP
from repro_torch.data.record_store import RecordStore
from repro_torch.ft import checkpoint as CKPT
from repro_torch.launch import train as LAUNCH
from repro_torch.models import model as MDL
from repro_torch.parallel import compression as COMP
from repro_torch.train import optim as O
from repro_torch.train import step as STEP

CPU = torch.device("cpu")
ARCHS = list_archs()
OPT_RTOL = 1e-6
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
GRAD_RTOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _host(tree):
    """A port tree (tensors and stacks) as the reference's arrays."""
    return MDL.host_tree(tree, CKPT.to_numpy)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _assert_tree_close(got, want, rtol, label=""):
    """Leaf by leaf: |got - want| <= rtol * max|want| (exact at 0).
    Returns the largest gap relative to its leaf's magnitude."""
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys(), (label, g.keys() ^ w.keys())
    worst = 0.0
    for k in w:
        a, b = g[k].astype(np.float64), w[k].astype(np.float64)
        assert a.shape == b.shape, (label, k, a.shape, b.shape)
        gap = float(np.abs(a - b).max()) if a.size else 0.0
        scale = float(np.abs(b).max()) if b.size else 0.0
        assert gap <= rtol * scale, (label, k, gap, scale)
        worst = max(worst, gap / scale if scale else 0.0)
    return worst


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _opt_case(seed=0):
    """Params (one factored 130x140 leaf, a stack of three of them, a
    vector and a small matrix) and three steps of grads, f32 numpy."""
    rng = np.random.default_rng(seed)
    params = dict(w=rng.standard_normal((130, 140)).astype(np.float32),
                  b=rng.standard_normal((7,)).astype(np.float32),
                  layers=dict(w=rng.standard_normal((3, 130, 140))
                              .astype(np.float32),
                              n=rng.standard_normal((3, 9))
                              .astype(np.float32)),
                  m=rng.standard_normal((3, 5)).astype(np.float32))
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape)
                          .astype(np.float32) * 0.3, params)
             for _ in range(3)]
    return params, grads


def _port_tree(tree):
    """numpy tree -> port tree, `layers` leaves as stacks of slices."""
    def one(path, a):
        if path and path[0] == "layers":
            return [torch.from_numpy(np.array(x)) for x in a]
        return torch.from_numpy(np.array(a))

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return one(path, t)
    return walk(tree)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adamw", dict(lr=3e-3, weight_decay=0.1, clip_norm=0.5)),
    ("adafactor", {}),
    ("adafactor", dict(weight_decay=0.01, clip_norm=0.5)),
], ids=["adamw", "adamw-clipped", "adafactor", "adafactor-decay"])
@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["const", "cosine"])
def test_optimizer_update_matches_reference(name, kw, scheduled):
    """3 updates on identical params and grads: params and every moment
    (AdamW's mu, nu; Adafactor's vr, vc, v, with a stack's whole-leaf
    update clip) within OPT_RTOL of each leaf's largest magnitude."""
    params, grads = _opt_case()
    if scheduled:
        jkw = dict(kw, schedule=JO.cosine_schedule(0.01, 2, 6))
        tkw = dict(kw, schedule=O.cosine_schedule(0.01, 2, 6))
    else:
        jkw = tkw = kw
    jopt, topt = JO.get_optimizer(name, **jkw), O.get_optimizer(name, **tkw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _port_tree(params)
    ts = topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.update(_port_tree(g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_RTOL)
    _assert_tree_close(_host(tp), _np_tree(jp), OPT_RTOL, "params")
    _assert_tree_close(_host(ts), _np_tree(js), OPT_RTOL, "state")
    assert int(ts["step"]) == int(js["step"]) == 3
    if name == "adafactor":       # the 130x140 leaves are factored
        assert set(ts["v"]["w"]) == {"vr", "vc"}
        assert set(ts["v"]["layers"]["w"]) == {"vr", "vc"}
        assert set(ts["v"]["b"]) == {"v"}


def quad_loss(p):
    return torch.sum(torch.square(p["w"] - 3.0)) + \
        torch.sum(torch.square(p["b"] + 1))


def _quad_params():
    return dict(w=torch.zeros((4, 130), requires_grad=True),
                b=torch.zeros((7,), requires_grad=True))


@pytest.mark.parametrize("opt_fn", [
    lambda: O.adamw(lr=0.1),
    lambda: O.adafactor(lr=0.5, schedule=O.cosine_schedule(0.5, 10, 300)),
], ids=["adamw", "adafactor"])
def test_optimizer_converges_quadratic(opt_fn):
    """The reference's scenario (tests/test_train.py) on the port."""
    opt = opt_fn()
    params = _quad_params()
    state = opt.init(params)
    for _ in range(300):
        g = dict(zip(params, torch.autograd.grad(quad_loss(params),
                                                 list(params.values()))))
        params, state, _ = opt.update(g, state, params)
    assert float(quad_loss(params)) < 1e-2


def test_cosine_schedule_shape():
    lr = O.cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert float(lr(100)) < 1e-6
    assert float(lr(55)) < float(lr(20))
    jlr = JO.cosine_schedule(1.0, warmup=10, total=100)
    for s in (0, 3, 10, 20, 55, 99, 100, 140):
        assert float(lr(torch.tensor(s, dtype=torch.int32))) == \
            float(jlr(jnp.int32(s)))


def test_get_optimizer_names():
    assert isinstance(O.get_optimizer("adamw"), O.Optimizer)
    with pytest.raises(ValueError):
        O.get_optimizer("sgd")


# ---------------------------------------------------------------------------
# train step against the reference
# ---------------------------------------------------------------------------


def _inputs(cfg, B, S, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (B, S)
    batch = dict(tokens=rng.integers(0, cfg.vocab, shape).astype(np.int32),
                 labels=rng.integers(0, cfg.vocab, shape).astype(np.int32))
    if cfg.family == "vlm":
        batch["extra_embeds"] = rng.standard_normal(
            lead + (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["enc_frames"] = rng.standard_normal(
            lead + (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(model, cfg, batch):
    """(loss, the gradient tree in the reference's layout) of the port."""
    model.requires_grad_(True)
    tree = MDL.param_tree(model)
    loss = MDL.loss_fn(model, cfg, batch["tokens"], batch["labels"],
                       extra_embeds=batch.get("extra_embeds"),
                       enc_frames=batch.get("enc_frames"))
    grads = iter(torch.autograd.grad(loss, O.tree_tensors(tree)))
    gtree = O.tree_map(lambda p: [next(grads) for _ in p]
                       if isinstance(p, list) else next(grads), tree)
    return float(loss.detach()), _host(gtree)


def _ref_grads(params, cfg, batch):
    def f(p):
        return JM.loss_fn(p, cfg, batch["tokens"], batch["labels"],
                          extra_embeds=batch.get("extra_embeds"),
                          enc_frames=batch.get("enc_frames"))
    loss, g = jax.jit(jax.value_and_grad(f))(params)
    return float(loss), _np_tree(g)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, capsys):
    """One step's loss, grad norm and every gradient leaf against
    `jax.value_and_grad` of the reference's `loss_fn` (remat at the
    config's `dots`), then 3 AdamW steps' losses and grad norms.  (The
    weights after them are not compared: AdamW's m / sqrt(v) turns a
    last-bit gap in a near-zero gradient into a gap of up to 2 lr.)"""
    cfg = ref_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    model = MDL.params_from_reference(tcfg, _np_tree(params), device=CPU)
    batch = _inputs(cfg, 2, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jg = _ref_grads(params, cfg, jb)
    tl, tg = _port_grads(model, tcfg, tb)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    worst = _assert_tree_close(tg, jg, GRAD_RTOL, arch)
    with capsys.disabled():
        print(f"\n  {arch}: loss gap {abs(tl - jl):.3e}, largest gradient "
              f"gap {worst:.3e} of its leaf's max |g|")

    jopt, topt = JO.adamw(lr=3e-3), O.adamw(lr=3e-3)
    jstate = dict(params=params, opt=jopt.init(params),
                  step=jnp.zeros((), jnp.int32))
    tstate = dict(params=model, opt=topt.init(MDL.param_tree(model)),
                  step=torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(JSTEP.make_train_step(cfg, jopt))
    tstep = STEP.make_train_step(tcfg, topt)
    lead = (cfg.accum_steps,) if cfg.accum_steps > 1 else ()
    for i in range(3):
        b = _inputs(cfg, 2, 16, seed=i + 1, lead=lead)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=NORM_RTOL)
    assert int(tstate["step"]) == 3


def test_accumulated_step_matches_reference():
    """accum_steps=2: the summed f32 micro-batch gradients and the mean
    loss against the reference's `lax.scan`, read through the metrics and
    the first moments (mu = 0.1 g after one step)."""
    cfg = dataclasses.replace(ref_config("granite_8b").reduced(),
                              accum_steps=2, remat="none")
    tcfg = dataclasses.replace(get_config("granite_8b").reduced(),
                               accum_steps=2, remat="none")
    params = JM.init_params(jax.random.PRNGKey(3), cfg)
    model = MDL.params_from_reference(tcfg, _np_tree(params), device=CPU)
    jopt, topt = JO.adamw(lr=1e-2), O.adamw(lr=1e-2)
    batch = _inputs(cfg, 2, 16, lead=(2,))
    jstate, jm = jax.jit(JSTEP.make_train_step(cfg, jopt))(
        dict(params=params, opt=jopt.init(params),
             step=jnp.zeros((), jnp.int32)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = STEP.make_train_step(tcfg, topt)(
        dict(params=model, opt=topt.init(MDL.param_tree(model)),
             step=torch.zeros((), dtype=torch.int32)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=NORM_RTOL)
    _assert_tree_close(_host(tstate["opt"]["mu"]),
                       _np_tree(jstate["opt"]["mu"]), GRAD_RTOL, "mu")


def test_grad_accumulation_matches_full_batch():
    """The reference's scenario on the port: 4 micro-batches of 2 against
    the batch of 8 (loss 1e-5, grad norm 1e-4 relative)."""
    cfg = dataclasses.replace(get_config("granite_8b").reduced(),
                              accum_steps=4, remat="none")
    opt = O.adamw(lr=0.0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)))
    state = STEP.init_state(cfg, opt, torch.Generator().manual_seed(0),
                            device=CPU)
    _, m_a = STEP.make_train_step(cfg, opt)(
        state, dict(tokens=tokens.reshape(4, 2, 16),
                    labels=labels.reshape(4, 2, 16)))
    cfg1 = dataclasses.replace(cfg, accum_steps=1)
    _, m_f = STEP.make_train_step(cfg1, opt)(
        state, dict(tokens=tokens, labels=labels))
    np.testing.assert_allclose(float(m_a["loss"]), float(m_f["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_a["grad_norm"]),
                               float(m_f["grad_norm"]), rtol=1e-4)


def test_train_step_reduces_loss():
    """The reference's scenario on the port: next token = token + 1."""
    cfg = get_config("internvl2_1b").reduced(n_layers=1, vocab=128)
    cfg = dataclasses.replace(cfg, family="dense", frontend="",
                              frontend_seq=0)
    opt = O.adamw(lr=3e-3)
    state = STEP.init_state(cfg, opt, torch.Generator().manual_seed(0),
                            device=CPU)
    step = STEP.make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab - 1, (4, 32))
    batch = dict(tokens=torch.from_numpy(toks.astype(np.int32)),
                 labels=torch.from_numpy(((toks + 1) % cfg.vocab)
                                         .astype(np.int32)))
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    assert int(state["step"]) == int(state["opt"]["step"]) == 30


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_1b_a400m",
                                  "whisper_base", "gemma2_2b"])
def test_remat_modes_give_equal_gradients(arch):
    """remat none, dots and full: the same loss and gradients (the
    recomputed forward runs the same ops on the same inputs)."""
    base = get_config(arch).reduced()
    batch = {k: torch.from_numpy(v)
             for k, v in _inputs(base, 2, 16, seed=5).items()}
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        model = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                                device=CPU)
        out[remat] = _port_grads(model, cfg, batch)
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0]
        _assert_tree_close(out[remat][1], out["none"][1], 0.0, remat)


@pytest.mark.parametrize("arch", ["granite_8b", "gemma2_2b"])
def test_flash_attention_gradients_match_dense(arch, monkeypatch):
    """The chunked online-softmax path is differentiable: forced on with
    small chunks (gemma2's window and softcaps included), its loss and
    gradients equal the dense path's within GRAD_RTOL of each leaf's
    largest |g|."""
    from repro_torch.models import layers as L
    cfg = get_config(arch).reduced()
    batch = {k: torch.from_numpy(v)
             for k, v in _inputs(cfg, 2, 40, seed=2).items()}
    out = []
    for flash in (False, True):
        if flash:
            monkeypatch.setattr(L, "FLASH_THRESHOLD", 1)
            monkeypatch.setattr(L, "FLASH_Q_CHUNK", 16)
            monkeypatch.setattr(L, "FLASH_KV_CHUNK", 16)
        model = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                                device=CPU)
        out.append(_port_grads(model, cfg, batch))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=LOSS_RTOL)
    _assert_tree_close(out[1][1], out[0][1], GRAD_RTOL, "flash")


def test_dots_policy_saves_the_weight_products():
    """Under `dots` the layer's checkpoint keeps the `aten.mm` outputs and
    recomputes the rest: the backward re-runs no matmul of `L.mm`.  Under
    `full` it re-runs the layer's forward as far as the backward needs
    it: 6 of the 7 weight products (no backward reads `w_down`'s
    output, and the recomputation stops before it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(get_config("granite_8b").reduced(),
                                  remat=remat)
        model = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                                device=CPU).requires_grad_(True)
        b = {k: torch.from_numpy(v)
             for k, v in _inputs(cfg, 2, 8).items()}
        loss = MDL.loss_fn(model, cfg, b["tokens"], b["labels"])
        with Count() as c:
            loss.backward()
        counts[remat] = c.mm
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 6 * 2


# ---------------------------------------------------------------------------
# data pipeline and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_equal_reference(seed):
    j, t = JP.SyntheticLM(512, 32, 4, seed=seed), \
        TP.SyntheticLM(512, 32, 4, seed=seed)
    assert np.array_equal(j.perm, t.perm)
    for step in (0, 1, 17):
        a, b = j.batch_at(step), t.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_store_pipeline_batches_equal_reference():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.uniform(0, 1e9, 300))
    docs = [rng.integers(0, 512, rng.integers(5, 60)).astype(np.int32)
            for _ in keys]
    j = JP.StorePipeline(JRecordStore(keys, docs), keys, seq_len=40,
                         batch=6, seed=2)
    store = RecordStore(keys, docs, device="cpu")
    t = TP.StorePipeline(store, keys, seq_len=40, batch=6, seed=2)
    for step in range(5):
        a, b = j.batch_at(step), t.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    with pytest.raises(LookupError):
        TP.StorePipeline(store, keys + 0.5, 40, 6).batch_at(0)
    store.index.close()


def test_quantize_and_error_feedback_equal_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 5, (256,)) * np.r_[np.ones(255), 40]).astype(
        np.float32)
    q, s = COMP.quantize_int8(torch.from_numpy(x))
    jq, js = JCOMP.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                    np.asarray(jq))
    assert float(s) == float(js)
    assert np.array_equal(COMP.dequantize_int8(q, s).numpy(),
                          np.asarray(JCOMP.dequantize_int8(jq, js)))
    params, grads = _opt_case(1)
    res_t = COMP.init_residual(_port_tree(params))
    res_j = JCOMP.init_residual(jax.tree.map(jnp.asarray, params))
    for g in grads:
        ct, res_t = COMP.ef_compress(_port_tree(g), res_t)
        cj, res_j = JCOMP.ef_compress(jax.tree.map(jnp.asarray, g), res_j)
        _assert_tree_close(_host(ct), _np_tree(cj), 0.0, "compressed")
        _assert_tree_close(_host(res_t), _np_tree(res_j), 0.0, "residual")


def test_error_feedback_compression_convergence():
    """int8+EF gradient compression must still converge (quadratic)."""
    opt = O.adamw(lr=0.1)
    params = dict(w=torch.zeros((8, 130), requires_grad=True),
                  b=torch.zeros((7,), requires_grad=True))
    state = opt.init(params)
    residual = COMP.init_residual(params)
    for _ in range(250):
        g = dict(zip(params, torch.autograd.grad(quad_loss(params),
                                                 list(params.values()))))
        g, residual = COMP.ef_compress(g, residual)
        params, state, _ = opt.update(g, state, params)
    assert float(quad_loss(params)) < 0.05


def test_quantize_roundtrip_bounded_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 5, (256,)).astype(np.float32))
    q, s = COMP.quantize_int8(x)
    err = (COMP.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _members(npz: str) -> dict:
    with zipfile.ZipFile(npz) as z:
        return {n: z.read(n) for n in z.namelist()}


def _manifest(d: str, step: int) -> dict:
    with open(os.path.join(d, JCKPT.step_name(step), "manifest.json")) as f:
        return json.load(f)


def _states(dtype: str, seed: int = 0):
    """The reference's train state for granite-8b reduced at `dtype` and
    the port's holding the same weights (zero moments in both)."""
    cfg = dataclasses.replace(ref_config("granite_8b").reduced(),
                              dtype=dtype)
    tcfg = dataclasses.replace(get_config("granite_8b").reduced(),
                               dtype=dtype)
    jopt, topt = JO.adamw(), O.adamw()
    jstate = JSTEP.init_state(jax.random.PRNGKey(seed), cfg, jopt)
    model = MDL.params_from_reference(tcfg, _np_tree(jstate["params"]),
                                      device=CPU)
    tstate = dict(params=model, opt=topt.init(MDL.param_tree(model)),
                  step=torch.zeros((), dtype=torch.int32))
    return (cfg, jopt, jstate), (tcfg, topt, tstate)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_saved_state_bytes_equal_reference(tmp_path, dtype):
    """The port's `save_state` of a state equal to the reference's writes
    the reference's npz members (headers and data, bf16 leaves as '<V2'),
    CRC32s and manifest (the zip's timestamps aside)."""
    (_, _, jstate), (_, _, tstate) = _states(dtype)
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    JCKPT.save(jd, 5, jstate, extra={"data_step": 5})
    STEP.save_state(td, 5, tstate, extra={"data_step": 5})
    assert _manifest(td, 5) == _manifest(jd, 5)
    name = "step_00000005/shard_00000.npz"
    got, want = _members(os.path.join(td, name)), \
        _members(os.path.join(jd, name))
    assert got == want
    if dtype == "bfloat16":
        assert any(b"'descr': '<V2'" in m[:128] for m in got.values())
    # the port's own np.savez-free writer equals np.savez on plain arrays
    buf = io.BytesIO()
    arrays = {"leaf_00000": np.arange(6, dtype=np.float32),
              "leaf_00001": np.int32(3)}
    np.savez(buf, **arrays)
    CKPT._write_npz(str(tmp_path / "x.npz"), arrays)
    assert _members(str(tmp_path / "x.npz")) == _members(buf)


def test_bf16_checkpoints_fall_back_as_the_reference():
    """Neither package restores a bf16 leaf ('|V2' has no cast): both skip
    every bf16 step and cold-start, whichever package wrote it."""
    (cfg, jopt, jstate), (tcfg, topt, tstate) = _states("bfloat16")
    import tempfile
    for writer in ("ref", "port"):
        with tempfile.TemporaryDirectory() as d:
            if writer == "ref":
                JCKPT.save(d, 1, jstate)
            else:
                STEP.save_state(d, 1, tstate)
            assert JCKPT.restore(d, JSTEP.state_shape(cfg, jopt)) == \
                (None, None)
            before = tstate["params"].final_norm.clone()
            assert STEP.restore_state(d, tstate) is None
            assert torch.equal(tstate["params"].final_norm, before)


def test_f32_state_restores_across_packages(tmp_path):
    """A trained f32 state (nonzero moments) written by the reference
    restores into the port leaf for leaf, and the port's into the
    reference, under the same paths and shapes."""
    (cfg, jopt, jstate), (tcfg, topt, tstate) = _states("float32")
    batch = _inputs(cfg, 2, 16)
    jstate, _ = jax.jit(JSTEP.make_train_step(cfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jd = str(tmp_path / "ref")
    JCKPT.save(jd, 1, jstate)
    fresh = STEP.init_state(tcfg, topt, torch.Generator().manual_seed(9),
                            device=CPU)
    man = STEP.restore_state(jd, fresh)
    assert man["step"] == 1
    _assert_tree_close(STEP.host_state(fresh), _np_tree(jstate), 0.0,
                       "ref->port")
    assert float(fresh["opt"]["mu"]["final_norm"].abs().max()) > 0

    tstate, _ = STEP.make_train_step(tcfg, topt)(
        fresh, {k: torch.from_numpy(v)
                for k, v in _inputs(cfg, 2, 16, seed=1).items()})
    td = str(tmp_path / "port")
    STEP.save_state(td, 2, tstate)
    got, man = JCKPT.restore(td, JSTEP.state_shape(cfg, jopt))
    assert man["step"] == 2
    _assert_tree_close(_np_tree(got), STEP.host_state(tstate), 0.0,
                       "port->ref")
    # the template's shapes are the reference's eval_shape
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        JSTEP.state_shape(cfg, jopt))
    tmpl = O.tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).replace("torch.", "")),
                      STEP.state_shape(tcfg, topt))
    assert tmpl == want


def test_checkpoint_roundtrip_and_fallback(tmp_path):
    """The reference's scenario on the port's train state: the newest step
    restores; a corrupted one falls back to the step before."""
    cfg = get_config("granite_8b").reduced()
    opt = O.adamw()
    state = STEP.init_state(cfg, opt, torch.Generator().manual_seed(0),
                            device=CPU)
    d = str(tmp_path / "ckpt")
    STEP.save_state(d, 1, state, extra={"data_pos": 123})
    with torch.no_grad():
        for t in O.tree_tensors(STEP.state_tree(state)):
            t.add_(1)
    STEP.save_state(d, 2, state)
    want = state["params"].final_norm.clone()
    got = STEP.init_state(cfg, opt, torch.Generator().manual_seed(1),
                          device=CPU)
    assert STEP.restore_state(d, got)["step"] == 2
    assert torch.equal(got["params"].final_norm, want)
    assert int(got["step"]) == 1 and int(got["opt"]["step"]) == 1
    npz = glob.glob(os.path.join(d, "step_00000002", "*.npz"))[0]
    with open(npz, "wb") as f:
        f.write(b"garbage")
    man1 = STEP.restore_state(d, got)
    assert man1["step"] == 1 and man1["extra"]["data_pos"] == 123
    assert torch.equal(got["params"].final_norm, want - 1)


def test_checkpoint_gc_keeps_last(tmp_path):
    d = str(tmp_path)
    state = dict(x=torch.arange(4))
    for s in range(5):
        CKPT.save(d, s, state, keep=2)
    dirs = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert dirs == [CKPT.step_name(3), CKPT.step_name(4)]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--arch", "granite-8b", "--reduced", "--steps", "12",
               "--batch", "2", "--seq", "16", "--ckpt-every", "4"]


def _reference_launch(argv, monkeypatch, capsys) -> dict:
    """The reference launcher run in process; the losses it printed."""
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    JLAUNCH.main()
    out = capsys.readouterr().out
    return {int(l.split()[1]): float(l.split("loss=")[1].split()[0])
            for l in out.splitlines() if l.startswith("step ")}


def test_launcher_matches_reference_launcher(tmp_path, monkeypatch, capsys):
    """Both launchers resume from one step-0 checkpoint of the reference's
    initial state and train 12 steps on `SyntheticLM`: the losses the
    reference prints (4 decimals) against the port's, within 1e-4
    absolute (the rounding), and the final checkpoints' paths, shapes and
    dtypes equal.  (Their values are not compared: over 12 AdamW steps a
    last-bit gap in a near-zero gradient grows to 1.2e-2 of a leaf.)"""
    cfg = ref_config("granite_8b").reduced()
    jopt = JO.adamw(lr=3e-3, schedule=JO.cosine_schedule(3e-3, 20, 12))
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    JCKPT.save(jd, 0, JSTEP.init_state(jax.random.PRNGKey(0), cfg, jopt))
    shutil.copytree(jd, td)
    printed = _reference_launch(LAUNCH_ARGS + ["--ckpt-dir", jd],
                                monkeypatch, capsys)
    rep = LAUNCH.main(LAUNCH_ARGS + ["--ckpt-dir", td, "--device", "cpu"])
    assert "[launch] resumed from step 0" in capsys.readouterr().out
    assert rep["start"] == 0 and len(rep["losses"]) == 12
    assert sorted(printed) == [0, 10]
    for s, loss in printed.items():
        assert abs(rep["losses"][s] - loss) <= 1e-4, (s, loss)
    got, want = (dict(np.load(os.path.join(d, "step_00000012",
                                           "shard_00000.npz")))
                 for d in (td, jd))
    got_m, want_m = _manifest(td, 12), _manifest(jd, 12)
    assert got_m["paths"] == want_m["paths"] and got_m["step"] == 12
    assert {k: (a.shape, a.dtype) for k, a in got.items()} == \
        {k: (a.shape, a.dtype) for k, a in want.items()}


def test_launcher_resumes_where_it_stopped(tmp_path, capsys):
    """A run killed after its step-4 checkpoint resumes there and ends on
    the uninterrupted run's losses and weights, exactly (the CPU's ops
    are deterministic)."""
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    rep = LAUNCH.main(LAUNCH_ARGS + ["--ckpt-dir", full, "--device", "cpu"])
    shutil.copytree(full, cut)
    for name in os.listdir(cut):
        if name not in ("step_00000004", "latest"):
            shutil.rmtree(os.path.join(cut, name))
    JCKPT.write_latest(cut, "step_00000004")
    capsys.readouterr()
    again = LAUNCH.main(LAUNCH_ARGS + ["--ckpt-dir", cut, "--device", "cpu"])
    assert "[launch] resumed from step 4" in capsys.readouterr().out
    assert again["start"] == 4 and again["losses"] == rep["losses"][4:]
    for a, b in zip(O.tree_tensors(STEP.state_tree(again["state"])),
                    O.tree_tensors(STEP.state_tree(rep["state"]))):
        assert torch.equal(a, b)


def test_launcher_rejects_production_meshes_and_missing_card():
    """A production mesh needs 256 or 512 devices: refused by name before
    any state is built, as `jax.make_mesh` refuses it on one device."""
    for mesh, n in (("16x16", 256), ("2x16x16", 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            LAUNCH.main(["--reduced", "--mesh", mesh, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LAUNCH.main(["--reduced", "--steps", "1"])
