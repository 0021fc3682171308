"""Logical -> physical sharding rules (FSDP / TP / EP / SP / DP).  Port of
`repro/parallel/sharding.py`.

Mesh axes: ("data", "model") single-pod 16x16; ("pod", "data", "model")
multi-pod 2x16x16.  FSDP shards parameters (and optimizer states) over the
data-parallel axes; TP shards heads / d_ff / vocab over "model"; MoE experts
shard over "model" when divisible (EP) else expert-TP; long-context KV caches
shard their sequence dim over "model" (SP).

Every spec is passed through `fit_spec` which drops mesh axes that do not
divide the corresponding dimension (e.g. whisper's vocab 51865) — degrading
to replication instead of failing.

The port runs on one card, so the rules are what they are in the
reference, pure functions of shapes and mesh sizes, over the port's own
stand-ins for jax's: `Mesh` (axis names and sizes, no devices), `P` (a
spec is a tuple whose entries are None, an axis name or a tuple of two or
more names, as `tuple(PartitionSpec(...))` gives them) and
`NamedSharding`.  A tree
given to `param_shardings` or `cache_shardings` is the port's: nested
dicts whose leaves are tensors or stacks (lists of per-layer tensors, one
stacked leaf of the reference, `models.model.param_tree`), or `meta`
tensors (`launch.specs`).  `shard_shape` gives the slice a device holds;
on the one card's (1, 1) mesh every placement is the identity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..models.config import ModelConfig, ShapeConfig
from ..train.optim import leaf_shape


@dataclass(frozen=True)
class Mesh:
    """A device mesh's axis names and sizes (jax's `Mesh` without its
    devices)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _entry(e):
    # PartitionSpec's canonical entry: () -> None, (name,) -> name
    if isinstance(e, (tuple, list)):
        return (None if not e else e[0] if len(e) == 1 else tuple(e))
    return e


def P(*spec) -> tuple:
    """A partition spec: one entry per leading dimension."""
    return tuple(_entry(e) for e in spec)


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: tuple


def dp_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def fit_spec(shape: tuple, spec: tuple, mesh: Mesh) -> tuple:
    """Drop axes that don't evenly divide their dimension."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        if dim % axis_size(mesh, ax) == 0:
            out.append(ax)
        else:
            # try single-axis fallback for composite axes
            if isinstance(ax, tuple):
                kept = tuple(a for a in ax if dim % mesh.shape[a] == 0)
                out.append(kept[0] if kept else None)
            else:
                out.append(None)
    return P(*out)


def shard_shape(shape: tuple, spec: tuple, mesh: Mesh) -> tuple:
    """The slice of a `shape` array that one device holds under `spec`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // axis_size(mesh, ax) for d, ax in zip(shape, spec))


def param_spec(path: tuple, shape: tuple, cfg: ModelConfig,
               mesh: Mesh) -> tuple:
    """`path`: the leaf's keys in the reference's tree, e.g.
    ("layers", "attn", "wq"); `shape`: its stacked shape."""
    names = [str(k) for k in path]
    name = names[-1]
    fsdp = dp_axes(mesh)
    stacked = names[0] in ("layers", "encoder", "cross")
    lead = (None,) if stacked else ()
    model = "model"
    ep_ok = cfg.n_experts > 0 and cfg.n_experts % mesh.shape["model"] == 0

    def S(*spec):
        return fit_spec(shape, P(*(lead + spec)), mesh)

    # heads-aware attention TP: sharding the packed (H*hd) dim when the head
    # count does not divide |model| makes the (B,S,H,hd) reshape cross shard
    # boundaries.  "auto" degrades to FSDP-only.
    nmod = mesh.shape["model"]
    q_tp_ok = cfg.n_heads % nmod == 0 if cfg.n_heads else False
    kv_tp_ok = cfg.n_kv_heads % nmod == 0 if cfg.n_kv_heads else False
    attn_tp = {"packed": (True, True), "off": (False, False),
               "auto": (q_tp_ok, kv_tp_ok and q_tp_ok)}[cfg.attn_tp]

    if name == "tok":
        return fit_spec(shape, P(model, fsdp), mesh)
    if name == "head":
        return fit_spec(shape, P(fsdp, model), mesh)
    if name == "wq":
        return S(fsdp, model) if attn_tp[0] else S(fsdp, None)
    if name in ("wk", "wv"):
        return S(fsdp, model) if attn_tp[1] else S(fsdp, None)
    if name == "wo":
        return S(model, fsdp) if attn_tp[0] else S(None, fsdp)
    if name in ("w_up", "w_gate") and "moe" not in names:
        return S(fsdp, model)
    if name == "w_down" and "moe" not in names:
        return S(model, fsdp)
    if name == "router":
        return S(fsdp, None)
    if name in ("w_up", "w_gate") and "moe" in names:
        return S(model, fsdp, None) if ep_ok else S(None, fsdp, model)
    if name == "w_down" and "moe" in names:
        return S(model, fsdp, None) if ep_ok else S(None, model, fsdp)
    if name == "w_in":
        return S(fsdp, model)
    if name == "conv_w":
        return S(None, model)
    if name in ("conv_b", "dt_bias", "d_skip", "norm_w"):
        return S(model)
    if name == "w_xbc":
        return S(model, None)
    if name == "w_dt":
        return S(None, model)
    if name == "a_log" and len(shape) >= 2 + len(lead):
        return S(model, None)
    if name == "w_out":
        return S(model, fsdp)
    if name == "patch_proj":
        return fit_spec(shape, P(fsdp, model), mesh)
    # norms & scalars: replicated
    return P(*([None] * len(shape)))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(cfg: ModelConfig, mesh: Mesh, params_shape) -> dict:
    """One `NamedSharding` a leaf of the tree (a stack's is its stacked
    leaf's)."""
    def one(path, leaf):
        return NamedSharding(mesh, param_spec(path, leaf_shape(leaf), cfg,
                                              mesh))
    return _map_with_path(one, params_shape)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------


def batch_spec(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               accum: int = 1) -> dict:
    """Input specs for one step.  Token arrays are [B, S] (or [A, B/A, S]
    with grad accumulation).  Batch sharded over dp axes when divisible."""
    dp = dp_axes(mesh)
    b = shape.global_batch
    lead = (None,) if accum > 1 else ()

    def tok_spec(bdim):
        return fit_spec((bdim, shape.seq_len),
                        P(*(lead + (dp, None))), mesh) \
            if accum <= 1 else fit_spec((accum, bdim, shape.seq_len),
                                        P(None, dp, None), mesh)
    return dict(dp=dp, tok=tok_spec(b // max(accum, 1)))


def cache_specs(cfg: ModelConfig, mesh: Mesh, batch: int,
                long_context: bool = False) -> dict:
    """Partition specs for the KV/SSM cache (see model.make_cache)."""
    dp = dp_axes(mesh)
    out = {}
    if cfg.family == "ssm":
        out["conv"] = P(None, dp, None, "model")
        out["ssm"] = P(None, dp, "model", None)
        out["pos"] = P()
        return out
    if cfg.family == "hybrid":
        out["conv"] = P(None, dp, None, "model")
        out["ssm"] = P(None, dp, "model", None, None)
        out["pos"] = P()
        if cfg.shared_attn_every:
            # SP: shard the (huge) shared-site KV over seq; batch=1 in the
            # long-context shape, so the seq dim takes the "data" axis
            if long_context:
                out["shared_k"] = P(None, None, "data", "model", None)
            else:
                out["shared_k"] = P(None, dp, None, "model", None)
            out["shared_v"] = out["shared_k"]
        return out
    # attention families: [L, B, S, Hkv, hd] — SP on seq over "model"
    out["k"] = P(None, dp, "model", None, None)
    out["v"] = out["k"]
    out["pos"] = P()
    if cfg.is_encdec:
        out["enc_out"] = P(None, dp, None)
    return out


def _shape(leaf) -> tuple:
    return () if isinstance(leaf, int) else tuple(leaf.shape)


def cache_shardings(cfg: ModelConfig, mesh: Mesh, cache_shape,
                    long_context: bool = False) -> dict:
    """One `NamedSharding` a cache entry (`pos`, a host int in the port's
    cache, is a scalar)."""
    specs = cache_specs(cfg, mesh, 0, long_context)
    return {k: NamedSharding(mesh, fit_spec(_shape(v), specs.get(k, P()),
                                            mesh))
            for k, v in cache_shape.items()}
