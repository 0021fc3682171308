"""One-card dry run: size every (arch x shape x mesh) cell without
allocating it.  Port of `repro/launch/dryrun.py`.

The reference lowers and compiles each cell on 512 forced XLA devices and
reads the compiled program's memory and cost analyses and the collectives
in its HLO.  None of these exists on CUDA: there is no HLO, and on one
card there are no collectives.  For each cell the port builds the step's
inputs as `meta` tensors (`launch.specs`) and records:
  * the bytes of params, optimizer state, cache and batch, whole;
  * the same per device under the production mesh's specs
    (`parallel.sharding`, through `fit_spec`);
  * whether the whole fits the card's memory
    (`torch.cuda.get_device_properties(0).total_memory`, or `--hbm-bytes`
    where there is no card), and whether one device's share would;
  * the step's least time on one card from its FLOP and byte bounds
    (`launch.bounds`).
Rows keep the reference's keys where they keep a meaning (arch, shape,
mesh, status, reason, kind, optimizer, accum_steps).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --out results/dryrun
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from ..configs import get_config, list_archs
from ..models import layers as L
from ..models import model as MDL
from ..models.config import ALL_SHAPES, ModelConfig, ShapeConfig
from ..parallel import sharding as SH
from ..train.optim import get_optimizer
from . import bounds as B
from . import specs as SPECS
from .mesh import make_production_mesh

# ---------------------------------------------------------------------------
# cell applicability (DESIGN.md section 4)
# ---------------------------------------------------------------------------

SUBQUADRATIC = {"ssm", "hybrid"}


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return "long_500k needs sub-quadratic attention (full-attn arch)"
    return None


def pick_optimizer(cfg: ModelConfig) -> str:
    return "adafactor" if cfg.d_model >= 5120 or cfg.n_experts >= 8 else "adamw"


def probe_points(cfg: ModelConfig) -> list[int]:
    """Layer counts of the reference's roofline probes (XLA's cost analysis
    counts a scan body once, so it extrapolates over n_layers):
      generic:  f(L) = f1 + (L-1)(f2-f1)            probes [1, 2]
      gemma2:   per-pair (local+global)             probes [2, 4]
      zamba2:   f(L) = a + b*L + c*sites(L)         probes [6, 7, 12]
    """
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        k = cfg.shared_attn_every
        return [k, k + 1, 2 * k]
    if cfg.attn_type == "local_global":
        return [2, 4]
    return [1, 2]


# ---------------------------------------------------------------------------
# bytes, whole and per device
# ---------------------------------------------------------------------------


def _nbytes(shape, t: torch.Tensor) -> int:
    return math.prod(shape) * t.element_size()


def _opt_spec(path: tuple, shape: tuple, param_specs: dict, mesh) -> tuple:
    """An optimizer leaf's spec: its parameter's, the factored adafactor
    rows and columns the matching prefix (the reference's
    `_opt_shardings`)."""
    core = tuple(n for n in path
                 if n not in ("v", "mu", "nu", "vr", "vc", "step"))
    spec = param_specs.get(core)
    if spec is None:
        return SH.P()
    if path[-1] == "vr":        # param spec minus last dim
        spec = spec[:len(shape)]
    elif path[-1] == "vc":      # param spec minus second-to-last dim
        spec = (spec[:max(len(shape) - 1, 0)] + spec[-1:]
                if len(spec) >= 2 else SH.P())
    return SH.fit_spec(shape, spec, mesh)


def _batch_spec(shape: tuple, cfg, kind: str, mesh) -> tuple:
    lead = (None,) if cfg.accum_steps > 1 and kind == "train" else ()
    inner = (SH.dp_axes(mesh),) + (None,) * (len(shape) - len(lead) - 1)
    return SH.fit_spec(shape, SH.P(*(lead + inner)), mesh)


def cell_bytes(spec_tree: dict, cfg: ModelConfig, shape: ShapeConfig,
               mesh) -> tuple:
    """({part: bytes}, {part: bytes on one device of `mesh`}) of a cell's
    inputs, parts params, opt, cache and batch."""
    kind = spec_tree["kind"]
    whole = dict(params=0, opt=0, cache=0, batch=0)
    dev = dict(whole)

    def add(part, t, spec):
        whole[part] += _nbytes(t.shape, t)
        dev[part] += _nbytes(SH.shard_shape(tuple(t.shape), spec, mesh), t)

    params = (spec_tree["state"]["params"] if kind == "train"
              else spec_tree["params"])
    param_specs = {}
    for path, t in MDL.leaves_with_path(params):
        param_specs[path] = SH.param_spec(path, tuple(t.shape), cfg, mesh)
        add("params", t, param_specs[path])
    if kind == "train":
        for path, t in MDL.leaves_with_path(spec_tree["state"]["opt"]):
            add("opt", t, _opt_spec(path, tuple(t.shape), param_specs, mesh))
        add("opt", spec_tree["state"]["step"], SH.P())
        batch = spec_tree["batch"]
    else:
        batch = (spec_tree["batch"] if kind == "prefill"
                 else dict(token=spec_tree["token"]))
        specs = SH.cache_specs(cfg, mesh, 0, shape.name == "long_500k")
        for k, t in spec_tree["cache"].items():
            add("cache", t, SH.fit_spec(tuple(t.shape),
                                        specs.get(k, SH.P()), mesh))
    for t in batch.values():
        add("batch", t, _batch_spec(tuple(t.shape), cfg, kind, mesh))
    return whole, dev


def step_bound(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The step's least time on one card (`launch.bounds`)."""
    model = MDL.LM(cfg, L.Init(torch.device("meta")))
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return B.train_bounds(model, cfg, b * s, s)
    return B.llm_bounds(model, cfg, b, s, s)[shape.kind]


def run_cell(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
             hbm_bytes: int, arch: str | None = None) -> dict:
    row = dict(arch=arch or cfg.name, shape=shape.name,
               mesh="multi" if multi_pod else "single")
    reason = cell_skip_reason(cfg, shape)
    if reason:
        return dict(row, status="SKIP", reason=reason)
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = SPECS.effective_config(cfg, shape)
    opt_name = pick_optimizer(cfg)
    spec_tree = SPECS.input_specs(cfg, shape, get_optimizer(opt_name))
    whole, dev = cell_bytes(spec_tree, cfg, shape, mesh)
    bd = step_bound(cfg, shape)
    total, per_dev = sum(whole.values()), sum(dev.values())
    return dict(row, status="OK", kind=spec_tree["kind"],
                optimizer=opt_name, accum_steps=cfg.accum_steps,
                bytes=whole, total_bytes=total, device_bytes=dev,
                total_device_bytes=per_dev, devices=mesh.size,
                hbm_bytes=hbm_bytes, fits=total <= hbm_bytes,
                device_fits=per_dev <= hbm_bytes,
                bound_ms=bd["ms"], bound_by=bd["by"],
                bound_bytes=bd["bytes"], bound_ops=bd["ops"],
                bound_elementwise_ops=bd["elementwise_ops"])


def format_row(row: dict) -> str:
    head = f"{row['arch']:<22} {row['shape']:<12} {row['mesh']:<6}"
    if row["status"] != "OK":
        return f"{head} {row['status']}: {row['reason']}"
    gb = 1e9
    return (f"{head} {row['kind']:<7} {row['optimizer']:<9} "
            f"whole {row['total_bytes'] / gb:10.2f} GB "
            f"(fits: {'yes' if row['fits'] else 'no'}), per device of "
            f"{row['devices']} {row['total_device_bytes'] / gb:8.3f} GB "
            f"(fits: {'yes' if row['device_fits'] else 'no'}); bound on one "
            f"card {row['bound_ms']:.3f} ms by {row['bound_by']}")


def card_bytes(hbm_bytes: int | None) -> int:
    if hbm_bytes:
        return hbm_bytes
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    raise RuntimeError("no CUDA device to read the memory of: pass "
                       "--hbm-bytes")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write one JSON file a cell here")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="the memory to fit (default: the card's)")
    args = ap.parse_args(argv)
    hbm = card_bytes(args.hbm_bytes)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = (ALL_SHAPES if args.shape == "all"
              else [s for s in ALL_SHAPES if s.name == args.shape])
    if not shapes:
        raise ValueError(f"unknown shape {args.shape!r}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    rows = []
    for arch in archs:
        for shape in shapes:
            row = run_cell(get_config(arch), shape, args.multi_pod, hbm,
                           arch=arch)
            print(format_row(row), flush=True)
            if args.out:
                tag = f"{arch}_{shape.name}_{row['mesh']}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(row, f, indent=1)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
