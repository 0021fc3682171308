"""Optimizers (AdamW, Adafactor) as minimal (init, update) pairs over trees
of tensors.  Port of `repro/train/optim.py`.

A tree is a nested dict (the layout `ft` saves).  A leaf is a tensor, or a
list of tensors that stand for one leaf of the reference stacked along a
leading axis: the per-layer weights of the port's model
(`models.model.param_tree`).  Element-wise work runs slice by slice;
whatever the reference computes over a whole leaf (Adafactor's factoring
rule and its update clip) runs over the whole stack.

`update(grads, state, params)` returns `(params, state, metrics)` as the
reference's does, with the reference's f32 arithmetic in its order and the
final cast to each parameter's dtype, but it writes the parameters and the
moments in place (under `torch.no_grad()`), and the returned trees are the
ones passed in.  The learning rate and the bias corrections come from the
step count, a tensor on the parameters' device, so an update never waits on
the host.  Adafactor's factored second moment keeps optimizer state O(d)
instead of O(d^2-ish); AdamW is the default for <= 14B.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params) -> (params, state, metrics)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (stacks as whole lists), the other
    trees followed along `tree`'s keys, in sorted key order (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def slices(leaf) -> list:
    """A leaf's tensors: a stack's slices, or the tensor alone."""
    return leaf if isinstance(leaf, list) else [leaf]


def tree_leaves(tree, like=None) -> list:
    """The leaves of `tree` (stacks whole) in sorted key order; with
    `like`, the subtrees of `tree` at `like`'s leaves (Adafactor's moment
    dicts at the parameters')."""
    like = tree if like is None else like
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in tree_leaves(tree[k], like[k])]
    return [tree]


def tree_tensors(tree) -> list:
    """Every tensor of `tree` in sorted key order, a stack's slices in
    order."""
    return [t for leaf in tree_leaves(tree) for t in slices(leaf)]


def leaf_shape(leaf) -> tuple:
    """The reference's shape of a leaf: a stack's with its leading axis."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _zeros_f32(leaf):
    if isinstance(leaf, list):
        return [torch.zeros_like(t, dtype=torch.float32) for t in leaf]
    return torch.zeros_like(leaf, dtype=torch.float32)


def _step0(params) -> torch.Tensor:
    dev = tree_tensors(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# schedule and clipping
# ---------------------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_tensors(tree)))


def clip_by_global_norm(tree, max_norm):
    """(`tree` scaled to a global norm of at most `max_norm`, in new
    tensors of each leaf's dtype; the norm before)."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)

    def one(leaf):
        out = [(x.float() * scale).to(x.dtype) for x in slices(leaf)]
        return out if isinstance(leaf, list) else out[0]
    return tree_map(one, tree), n


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          clip_norm=1.0, schedule=None):
    lr_fn = schedule or (lambda s: lr)

    def init(params):
        return dict(mu=tree_map(_zeros_f32, params),
                    nu=tree_map(_zeros_f32, params),
                    step=_step0(params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        grads, gn = clip_by_global_norm(grads, clip_norm)
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())
        lr_t = lr_fn(step)
        for p, g, m, v in zip(tree_tensors(params), tree_tensors(grads),
                              tree_tensors(state["mu"]),
                              tree_tensors(state["nu"])):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            p.copy_((p.float() - lr_t * u).to(p.dtype))
        return params, dict(mu=state["mu"], nu=state["nu"], step=step), \
            dict(grad_norm=gn)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_norm=1.0,
              weight_decay=0.0, schedule=None, min_dim_factored=128):
    """Factored second-moment optimizer (Shazeer & Stern 2018), simplified."""
    lr_fn = schedule or (lambda s: lr)

    def _factored(leaf):
        shape = leaf_shape(leaf)
        if not (len(shape) >= 2 and shape[-1] >= min_dim_factored
                and shape[-2] >= min_dim_factored):
            return False
        if isinstance(leaf, list) and leaf[0].dim() < 2:
            raise NotImplementedError(
                f"a stack of {len(leaf)} leaves of shape "
                f"{tuple(leaf[0].shape)} is factored across its slices")
        return True

    def init(params):
        def one(p):
            if _factored(p):
                vr = [torch.zeros(t.shape[:-1], dtype=torch.float32,
                                  device=t.device) for t in slices(p)]
                vc = [torch.zeros(t.shape[:-2] + t.shape[-1:],
                                  dtype=torch.float32, device=t.device)
                      for t in slices(p)]
                if not isinstance(p, list):
                    vr, vc = vr[0], vc[0]
                return dict(vr=vr, vc=vc)
            return dict(v=_zeros_f32(p))
        return dict(v=tree_map(one, params), step=_step0(params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        grads, gn = clip_by_global_norm(grads, clip_norm)
        beta = 1.0 - (step.float() + 1) ** (-decay)
        lr_t = lr_fn(step)

        def one(p, g, v):
            us = []
            for i, gi in enumerate(slices(g)):
                gi = gi.float()
                g2 = torch.square(gi) + eps
                if "vr" in v:
                    vr, vc = slices(v["vr"])[i], slices(v["vc"])[i]
                    vr.copy_(beta * vr + (1 - beta) * g2.mean(-1))
                    vc.copy_(beta * vc + (1 - beta) * g2.mean(-2))
                    denom = (vr[..., None] * vc[..., None, :]
                             / torch.clamp(vr.mean(-1)[..., None, None],
                                           min=eps))
                    us.append(gi * torch.rsqrt(denom + eps))
                else:
                    vi = slices(v["v"])[i]
                    vi.copy_(beta * vi + (1 - beta) * g2)
                    us.append(gi * torch.rsqrt(vi + eps))
            # update clipping (RMS <= 1), over the whole (stacked) leaf
            n = sum(u.numel() for u in us)
            rms = torch.sqrt(sum(torch.sum(torch.square(u)) for u in us) / n
                             + 1e-30)
            for pi, u in zip(slices(p), us):
                u = u / torch.clamp(rms, min=1.0)
                u = u + weight_decay * pi.float()
                pi.copy_((pi.float() - lr_t * u).to(pi.dtype))

        for p, g, v in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["v"], params)):
            one(p, g, v)
        return params, dict(v=state["v"], step=step), dict(grad_norm=gn)

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)
