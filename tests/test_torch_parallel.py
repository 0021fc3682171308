"""The port's parallel and launch scaffolding (`repro_torch.parallel`,
`launch.{mesh,specs,dryrun,bounds}`) against the JAX package.

The reference's collectives need a mesh of 8 devices, so its side runs
once, in a module-scoped subprocess with 8 forced host devices (this
process must keep seeing one JAX device, as tests/test_distributed.py
does), and writes its answers to an `.npz` and a JSON file:
  * `pipeline_forward` on a (4, 2, 1) mesh with 4 microbatches, and its
    gradient of mean(logits^2) taken under `jax.set_mesh(mesh)`: the
    port's on one card within `RTOL` relative of each, and within
    `PIPE_RTOL` of its own `forward_train`;
  * `psum_int8` under `shard_map` on tests/test_distributed.py's (64, 32)
    input: the port's over the 8 stacked slices bit for bit;
  * the dry run's skip reasons, optimizer picks and probe points for every
    (arch x shape) cell, and the bytes of each cell's inputs summed over
    the reference's `jax.eval_shape` leaves: the port's equal.
The sharding rules are pure functions of shapes and mesh sizes, so they
are compared in this process over `AbstractMesh`es, spec for spec, as
tuples.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config, list_archs
from repro.launch import specs as JSPECS
from repro.models import config as JC
from repro.models import model as JM
from repro.parallel import sharding as JSH
from repro.train import step as JSTEP
from repro.train import optim as JO
from repro_torch.configs import get_config
from repro_torch.launch import bounds as BD
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as MESH
from repro_torch.launch import specs as SPECS
from repro_torch.models import config as TC
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models.config import ALL_SHAPES
from repro_torch.parallel import compression as COMP
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel import sharding as SH
from repro_torch.train import optim as O
from repro_torch.train import step as STEP
from tests.test_torch_ssm import FALCON_MAMBA_7B, ZAMBA2_1P2B

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RTOL = 1e-5          # the port against the reference (of each max)
PIPE_RTOL = 1e-6     # the pipeline against the port's own forward_train
SEEDS = {"falcon_mamba_7b": FALCON_MAMBA_7B, "zamba2_1p2b": ZAMBA2_1P2B}
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((8, 1), ("data", "model"))]


def _configs(pkg_config, model_config):
    """Every assigned arch and the two seed ssm/hybrid configs."""
    out = {a: pkg_config(a) for a in list_archs()}
    out.update({a: model_config(**kw) for a, kw in SEEDS.items()})
    return out


def _pipe_cfg(config_fn):
    return dataclasses.replace(config_fn("granite_8b").reduced(), n_layers=4,
                               remat="none")


def _pipe_tokens(cfg):
    return np.random.default_rng(1).integers(
        0, cfg.vocab, (8, 16)).astype(np.int32)


def _psum_input():
    return np.asarray(np.random.default_rng(0).normal(0, 1, (64, 32)),
                      np.float32)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _unflat(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


# -- the reference side (runs in the subprocess) ------------------------------

def _ref_nbytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


def reference_outputs(out_dir: str) -> None:
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.parallel.compression import psum_int8
    from repro.parallel.pipeline import pipeline_forward
    from repro.train.optim import get_optimizer
    assert len(jax.devices()) == 8
    # imported after the backend is up: the module forces 512 devices
    from repro.launch import dryrun as JD

    arrays = {}
    cfg = _pipe_cfg(ref_config)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    tokens = jnp.asarray(_pipe_tokens(cfg))
    mesh = jax.make_mesh((4, 2, 1), ("pod", "data", "model"))
    with jax.set_mesh(mesh):
        arrays["logits"] = np.asarray(
            pipeline_forward(cfg, mesh, params, tokens, n_micro=4))

        def loss(p):
            lg = pipeline_forward(cfg, mesh, p, tokens, n_micro=4)
            return jnp.mean(jnp.square(lg))
        grads = jax.grad(loss)(params)
    for k, v in _flat(jax.tree.map(np.asarray, params)):
        arrays["param/" + k] = v
    for k, v in _flat(jax.tree.map(np.asarray, grads)):
        arrays["grad/" + k] = v

    dmesh = jax.make_mesh((8,), ("data",))
    arrays["psum"] = np.asarray(shard_map(
        lambda x: psum_int8(x, "data"), mesh=dmesh, in_specs=P("data"),
        out_specs=P("data"))(jnp.asarray(_psum_input())))
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)

    cells = {}
    for arch, cfg in _configs(ref_config, JC.ModelConfig).items():
        for shape in ALL_SHAPES:
            row = dict(reason=JD.cell_skip_reason(cfg, shape),
                       probes=JD.probe_points(cfg))
            if row["reason"] is None:
                c = JSPECS.effective_config(cfg, shape)
                row["optimizer"] = JD.pick_optimizer(c)
                spec = JSPECS.input_specs(c, shape,
                                          get_optimizer(row["optimizer"]))
                if spec["kind"] == "train":
                    row["bytes"] = dict(
                        params=_ref_nbytes(spec["state"]["params"]),
                        opt=_ref_nbytes(spec["state"]["opt"])
                        + _ref_nbytes(spec["state"]["step"]),
                        cache=0, batch=_ref_nbytes(spec["batch"]))
                else:
                    batch = (spec["batch"] if spec["kind"] == "prefill"
                             else spec["token"])
                    row["bytes"] = dict(params=_ref_nbytes(spec["params"]),
                                        opt=0,
                                        cache=_ref_nbytes(spec["cache"]),
                                        batch=_ref_nbytes(batch))
            cells[f"{arch}/{shape.name}"] = row
    with open(os.path.join(out_dir, "cells.json"), "w") as f:
        json.dump(cells, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_ENABLE_X64="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    code = ("from tests.test_torch_parallel import reference_outputs; "
            f"reference_outputs({str(tmp)!r})")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=900, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        arrays = dict(z)
    with open(tmp / "cells.json") as f:
        cells = json.load(f)
    return arrays, cells


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    gap = float(np.abs(np.asarray(got, np.float64) - want).max())
    scale = float(np.abs(want).max())
    return gap / scale if scale else gap


# -- the GPipe schedule -------------------------------------------------------

def _pipe_model(arrays):
    tcfg = _pipe_cfg(get_config)
    tree = _unflat({k[len("param/"):]: v for k, v in arrays.items()
                    if k.startswith("param/")})
    return tcfg, MDL.params_from_reference(tcfg, tree, device=CPU)


def test_pipeline_forward_matches_reference_and_forward_train(ref):
    arrays, _ = ref
    tcfg, model = _pipe_model(arrays)
    tokens = torch.from_numpy(_pipe_tokens(tcfg))
    mesh = SH.Mesh(("pod", "data", "model"), (4, 2, 1))
    with torch.no_grad():
        got = PP.pipeline_forward(tcfg, mesh, model, tokens, n_micro=4)
        full, _ = MDL.forward_train(model, tcfg, tokens)
    assert got.shape == (8, 16, tcfg.vocab) and got.dtype == torch.float32
    assert _rel(got.numpy(), arrays["logits"]) <= RTOL
    assert _rel(got.numpy(), full.numpy()) <= PIPE_RTOL


def test_pipeline_gradients_match_reference(ref):
    """The gradient of mean(logits^2) through the schedule, leaf by leaf,
    against the reference's taken under `jax.set_mesh`."""
    arrays, _ = ref
    tcfg, model = _pipe_model(arrays)
    model.requires_grad_(True)
    tree = MDL.param_tree(model)
    mesh = SH.Mesh(("pod", "data", "model"), (4, 2, 1))
    lg = PP.pipeline_forward(tcfg, mesh, model,
                             torch.from_numpy(_pipe_tokens(tcfg)), n_micro=4)
    grads = iter(torch.autograd.grad(torch.mean(torch.square(lg)),
                                     O.tree_tensors(tree)))
    gtree = O.tree_map(lambda p: [next(grads) for _ in p]
                       if isinstance(p, list) else next(grads), tree)
    got = dict(_flat(MDL.host_tree(gtree, lambda t: t.detach().numpy())))
    want = {k[len("grad/"):]: v for k, v in arrays.items()
            if k.startswith("grad/")}
    assert got.keys() == want.keys()
    gn = sum(float(np.sum(np.square(v))) for v in want.values())
    assert np.isfinite(gn) and gn > 0
    for k, w in want.items():
        assert _rel(got[k], w) <= RTOL, (k, _rel(got[k], w))


def test_split_stages_and_schedule_checks():
    layers = list(range(6))
    assert PP.split_stages(layers, 3) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="stages"):
        PP.split_stages(layers, 4)
    cfg = _pipe_cfg(get_config)
    model = MDL.init_params(cfg, device=CPU)
    with pytest.raises(ValueError, match="microbatches"):
        PP.pipeline_forward(cfg, SH.Mesh(("pod", "data", "model"),
                                         (2, 1, 1)), model,
                            torch.zeros((6, 4), dtype=torch.int64),
                            n_micro=4)


# -- psum_int8 ----------------------------------------------------------------

def test_psum_int8_bit_equal_to_reference(ref):
    arrays, _ = ref
    x = torch.from_numpy(_psum_input()).reshape(8, 8, 32)
    got = COMP.psum_int8(x).reshape(64, 32)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), arrays["psum"])
    # and close to the exact sum, as the reference's own test holds it
    exact = x.sum(0).repeat(8, 1)
    assert float((got - exact).abs().max()) < \
        0.05 * float(exact.abs().max()) + 0.1


def test_psum_int8_scales_and_vectors():
    """One scale for all shards (the largest), an all-zero input stays
    zero, and 1-D shards work."""
    x = torch.tensor([[1.0, -2.0], [0.5, 254.0]])
    got = COMP.psum_int8(x)
    assert torch.equal(got[0], got[1])
    # each shard rounds to a multiple of the shared scale, 254 / 127
    assert float((got[0] - x.sum(0)).abs().max()) <= 254.0 / 127.0 + 1e-5
    assert float(got[0, 1]) == pytest.approx(254.0 - 254.0 / 127.0)
    assert not COMP.psum_int8(torch.zeros(3, 4, 5)).any()


# -- sharding rules -----------------------------------------------------------

def _spec_cases():
    for arch in list(list_archs()) + list(SEEDS):
        for reduced in (False, True):
            yield arch, reduced


@pytest.mark.parametrize("arch,reduced", list(_spec_cases()))
def test_param_and_cache_specs_equal_reference(arch, reduced):
    cfg = _configs(ref_config, JC.ModelConfig)[arch]
    tcfg = _configs(get_config, TC.ModelConfig)[arch]
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    ref_params = jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    ref_leaves = {"/".join(str(k.key) for k in path): leaf
                  for path, leaf in
                  jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    port = dict(_flat(STEP.params_shape(tcfg)))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in ref_leaves.items()}
    shape = ALL_SHAPES[2]
    for sizes, names in MESHES:
        jmesh, tmesh = AbstractMesh(sizes, names), SH.Mesh(names, sizes)
        for k, leaf in ref_leaves.items():
            path = tuple(k.split("/"))
            want = JSH.param_spec(path, leaf.shape, cfg, jmesh)
            got = SH.param_spec(path, tuple(leaf.shape), tcfg, tmesh)
            assert got == tuple(want), (k, sizes, got, want)
        for long_ctx in (False, True):
            want = JSH.cache_specs(cfg, jmesh, 0, long_ctx)
            got = SH.cache_specs(tcfg, tmesh, 0, long_ctx)
            assert got == {k: tuple(v) for k, v in want.items()}
        ref_cache = jax.eval_shape(lambda: JM.make_cache(cfg, 4, 16))
        for k, v in SH.cache_shardings(
                tcfg, tmesh, MDL.make_cache(tcfg, 4, 16, device="meta")
        ).items():
            want = JSH.fit_spec(ref_cache[k].shape,
                                JSH.cache_specs(cfg, jmesh, 0).get(
                                    k, JSH.P()), jmesh)
            assert v.spec == tuple(want) and v.mesh is tmesh, k
        for accum in (1, 2):
            want = JSH.batch_spec(cfg, shape, jmesh, accum)
            got = SH.batch_spec(tcfg, shape, tmesh, accum)
            assert got == dict(dp=want["dp"], tok=tuple(want["tok"]))


def test_local_mesh_train_step_shardings():
    """tests/test_distributed.py::test_small_mesh_train_step_shardings on
    one card: the state's shardings on the launcher's (1, 1) mesh place
    every leaf whole (the identity), those on the (4, 2) mesh shard as the
    reference's do, and a train step on the card's mesh gives a finite
    loss."""
    cfg = dataclasses.replace(get_config("granite_8b").reduced(),
                              d_model=128, n_heads=4, n_kv_heads=2,
                              d_ff=256, vocab=512)
    opt = O.adamw(lr=1e-3)
    shapes = STEP.state_shape(cfg, opt)["params"]
    mesh = MESH.make_local_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    for k, sh in _flat(SH.param_shardings(cfg, mesh, shapes)):
        leaf = dict(_flat(shapes))[k]
        assert SH.shard_shape(tuple(leaf.shape), sh.spec, mesh) == \
            tuple(leaf.shape)
    wq = SH.param_shardings(cfg, SH.Mesh(("data", "model"), (4, 2)),
                            shapes)["layers"]["attn"]["wq"]
    assert wq.spec == (None, "data", "model")
    assert SH.shard_shape((2, 128, 128), wq.spec, wq.mesh) == (2, 32, 64)
    state = STEP.init_state(cfg, opt, device=CPU)
    toks = torch.zeros((8, 16), dtype=torch.int32)
    _, m = STEP.make_train_step(cfg, opt)(state, dict(tokens=toks,
                                                      labels=toks))
    assert np.isfinite(float(m["loss"]))


def test_elastic_restore_across_meshes(tmp_path):
    """tests/test_distributed.py::test_elastic_restore_across_meshes on
    one card: a state the reference saved restores into the port's state
    laid out for the (8, 1) mesh's FSDP shardings (on the one card, the
    identity), its leaves equal."""
    from repro.ft import checkpoint as JCKPT
    cfg = ref_config("granite_8b").reduced()
    tcfg = get_config("granite_8b").reduced()
    jstate = JSTEP.init_state(jax.random.PRNGKey(0), cfg, JO.adamw())
    JCKPT.save(str(tmp_path), 5, jstate)
    state = STEP.init_state(tcfg, O.adamw(), device=CPU)
    mesh = SH.Mesh(("data", "model"), (8, 1))
    p_sh = SH.param_shardings(tcfg, mesh, STEP.params_shape(tcfg))
    assert p_sh["layers"]["attn"]["wq"].spec == (None, "data", "model")
    man = STEP.restore_state(str(tmp_path), state)
    assert man["step"] == 5
    want = np.asarray(jstate["params"]["layers"]["attn"]["wq"])
    got = np.stack([t.numpy() for t in
                    MDL.param_tree(state["params"])["layers"]["attn"]["wq"]])
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- mesh, specs, the launcher ------------------------------------------------

def test_meshes_and_device_check():
    single, multi = (MESH.make_production_mesh(),
                     MESH.make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert SH.dp_axes(multi) == ("pod", "data")
    assert SH.axis_size(multi, ("pod", "data")) == 32
    MESH.check_devices(MESH.make_local_mesh(), CPU)
    with pytest.raises(ValueError, match="512 devices"):
        MESH.check_devices(multi, CPU)


def test_launcher_uses_the_local_meshs_shardings(tmp_path):
    from repro_torch.launch import train as LAUNCH
    rep = LAUNCH.main(["--reduced", "--steps", "1", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    assert rep["mesh"] == MESH.make_local_mesh()
    tok = rep["shardings"]["params"]["embed"]["tok"]
    assert tok.spec == ("model", "data")
    shape = tuple(rep["state"]["params"].embed.tok.shape)
    assert SH.shard_shape(shape, tok.spec, tok.mesh) == shape


@pytest.mark.parametrize("arch", list(list_archs()) + list(SEEDS))
def test_input_specs_equal_reference(arch):
    """Every abstract input, shape and dtype, against the reference's
    `jax.eval_shape` (the cache's `pos` included)."""
    cfg = _configs(ref_config, JC.ModelConfig)[arch].reduced()
    tcfg = _configs(get_config, TC.ModelConfig)[arch].reduced()
    for shape in ALL_SHAPES:
        shape = dataclasses.replace(shape, seq_len=64, global_batch=32)
        opt, topt = JO.adamw(), O.adamw()
        want = JSPECS.input_specs(cfg, shape, opt)
        got = SPECS.input_specs(tcfg, shape, topt)
        assert got["kind"] == want["kind"]
        assert got["cfg"] == SPECS.effective_config(tcfg, shape)
        for part in ("state", "params", "batch", "cache", "token"):
            if part not in want:
                continue
            w = {"/".join(str(getattr(k, "key", k)) for k in p):
                 (tuple(x.shape), str(x.dtype)) for p, x in
                 jax.tree_util.tree_flatten_with_path(want[part])[0]}
            g = got[part] if isinstance(got[part], dict) \
                else {"": got[part]}
            g = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                 for k, x in _flat(g)}
            assert g == w, (arch, shape.name, part)


# -- the dry run --------------------------------------------------------------

def test_dryrun_cells_equal_reference(ref):
    """Skip reasons, optimizer picks, probe points and the whole-state
    bytes of every cell, single and multi-pod."""
    _, cells = ref
    for arch, cfg in _configs(get_config, TC.ModelConfig).items():
        for shape in ALL_SHAPES:
            want = cells[f"{arch}/{shape.name}"]
            assert DRY.probe_points(cfg) == want["probes"]
            for multi in (False, True):
                row = DRY.run_cell(cfg, shape, multi, 80 * 10**9, arch=arch)
                assert row["arch"] == arch and row["shape"] == shape.name
                assert row["mesh"] == ("multi" if multi else "single")
                if want["reason"] is not None:
                    assert (row["status"], row["reason"]) == \
                        ("SKIP", want["reason"])
                    continue
                assert row["status"] == "OK"
                assert row["optimizer"] == want["optimizer"]
                assert row["bytes"] == want["bytes"], (arch, shape.name)
                assert row["devices"] == (512 if multi else 256)
                assert 0 < row["total_device_bytes"] < row["total_bytes"]
                assert row["fits"] == (row["total_bytes"] <= 80 * 10**9)
                assert row["bound_ms"] > 0


def test_dryrun_main_writes_rows(tmp_path, capsys):
    rows = DRY.main(["--arch", "granite-8b", "--shape", "decode_32k",
                     "--hbm-bytes", str(80 * 10**9), "--out", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["kind"] == "decode"
    assert "granite-8b" in capsys.readouterr().out
    with open(tmp_path / "granite-8b_decode_32k_single.json") as f:
        assert json.load(f)["total_bytes"] == rows[0]["total_bytes"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="hbm-bytes"):
            DRY.main(["--arch", "granite-8b"])


# -- the bounds ---------------------------------------------------------------

def _meta_model(cfg):
    return MDL.LM(cfg, L.Init(torch.device("meta")))


def test_bounds_keep_the_earlier_numbers():
    """granite-8b: the train step at 16 layers on 8 x 128 tokens and the
    serve numbers at batch 8 as chip_smoke printed them (PRs 19-20)."""
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=16)
    bd = BD.train_bounds(_meta_model(cfg), cfg, 8 * 128, 128)
    assert bd["bytes"] == 123_769_847_808 and bd["ops"] == 22_729_369_583_616
    assert round(bd["ms"], 3) == 36.946 and bd["by"] == "bytes"
    cfg = get_config("granite-8b")
    bd = BD.llm_bounds(_meta_model(cfg), cfg, 8, 32, 35 + 8)
    assert bd["weight_bytes"] == 16_509_976_576
    assert bd["prefill"]["bytes"] == 16_148_742_144
    assert round(bd["prefill"]["ms"], 3) == 4.821
    assert bd["decode"]["bytes"] == 16_160_866_304
    assert round(bd["decode"]["ms"], 2) == 4.82


def test_bounds_of_the_ssm_families():
    falcon = TC.ModelConfig(**FALCON_MAMBA_7B)
    zamba = TC.ModelConfig(**ZAMBA2_1P2B)
    assert BD.attention_layers(falcon) == 0
    assert BD.shared_sites(zamba) == BD.attention_layers(zamba) == 6
    m = _meta_model(falcon)
    # the 2-D weights but conv_w and a_log, per layer
    per_layer = sum(p.numel() for n, p in m.layers[0].named_parameters()
                    if p.dim() == 2 and n not in ("mamba.conv_w",
                                                  "mamba.a_log"))
    assert BD.decoder_matmul_weights(m, falcon) == 64 * per_layer
    bd = BD.llm_bounds(m, falcon, 8, 32, 40)
    state = 64 * 8 * (3 * 8192 * 2 + 8192 * 16 * 4)
    assert bd["decode"]["bytes"] - bd["prefill"]["bytes"] == \
        state - 8 * 31 * 4096 * 2
    assert bd["prefill"]["elementwise_ops"] == \
        8 * 32 * 64 * (7 * 8192 * 16 + 2 * 4 * 8192)
    z = _meta_model(zamba)
    shared = sum(p.numel() for p in z.shared_attn.parameters()
                 if p.dim() == 2)
    layers = sum(p.numel() for n, p in z.layers.named_parameters()
                 if p.dim() == 2 and not n.endswith(("conv_w", "a_log")))
    assert BD.decoder_matmul_weights(z, zamba) == layers + 6 * shared
    tb = BD.train_bounds(z, zamba, 8 * 128, 128)
    assert tb["elementwise_ops"] == 3 * BD.scan_ops(zamba, 8 * 128)
    assert tb["ms"] >= max(tb["bytes_ms"], tb["ops_ms"]) - 1e-12
