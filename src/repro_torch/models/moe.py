"""Mixture-of-Experts block: top-k routing with sort-based capacity dispatch.
Port of `repro/models/moe.py`.

Dispatch is the gather/scatter-by-sort formulation (dropless up to the
capacity factor): token-expert assignments are sorted by expert, the first C
per expert are gathered into [E, C, d] and processed by one batched
einsum — active-FLOPs-proportional, unlike the dense one-hot dispatch.  On
one card there is no expert or tensor parallelism: every expert's weights
sit whole on the device.

Two places follow the reference's arithmetic exactly rather than its
source line for line:
  * the reference's gather writes every dropped assignment's zeros to row
    E*C-1 (its scatter; XLA on the CPU applies duplicate indices in update
    order, the last write wins).  So when the last expert dropped an
    assignment, its kept row at rank C-1 ends as zeros; here that is one
    explicit `where` after a scatter with unique indices;
  * the combine is an `index_add_` over token ids.  With top_k <= 2 a token
    receives at most two nonzero terms, whose sum is the same in any order;
    for top_k > 2 `index_add_` on CUDA adds in no fixed order, so results may
    differ in the last bits between runs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import torch_dtype
from .layers import Init, einsum


class MoE(nn.Module):
    """The reference's `init_moe`: router (f32) and per-expert weights."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
        s = 1.0 / math.sqrt(D)
        self.router = init.dense(D, E, torch.float32)
        self.w_up = init.normal((E, D, F_), s, dt)
        self.w_down = init.normal((E, F_, D), 1.0 / math.sqrt(F_), dt)
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = init.normal((E, D, F_), s, dt)


def top_k(probs, k: int):
    """`lax.top_k`: the k largest along the last axis, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p: MoE, cfg, x):
    """x: [B, S, D] -> [B, S, D] plus aux load-balance loss."""
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = b * s
    xt = x.reshape(T, d)

    logits = xt.float() @ p.router                           # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                    # [T, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    flat_e = gate_idx.reshape(-1)                            # [T*K]
    counts = F.one_hot(flat_e, E).sum(0)                     # [E]
    me = probs.mean(0)
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)

    # ---- sort-based capacity dispatch ------------------------------------
    # floor keeps small (decode-sized) batches effectively dropless
    C = max(int(math.ceil(T * K / E * cfg.capacity_factor)), min(T * K, 16), 1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_g = gate_vals.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    g_sorted = flat_g[order]
    # rank within expert
    onehot_pos = F.one_hot(e_sorted, E)
    rank = onehot_pos.cumsum(0).gather(1, e_sorted[:, None])[:, 0] - 1
    keep = rank < C
    slot = e_sorted * C + rank.clamp(0, C - 1)               # [T*K]

    # kept slots are unique; dropped assignments go to a spare last row
    rows = torch.where(keep, slot, E * C)
    buf = x.new_zeros((E * C + 1, d))
    buf[rows] = xt[t_sorted]
    # the reference's last write to row E*C-1 (see the module docstring)
    buf[E * C - 1] = torch.where(counts[E - 1] > C, 0, buf[E * C - 1])
    ex = buf[:E * C].reshape(E, C, d)

    up = einsum("ecd,edf->ecf", ex, p.w_up)
    if cfg.act == "swiglu":
        h = F.silu(einsum("ecd,edf->ecf", ex, p.w_gate)) * up
    elif cfg.act == "geglu":
        h = F.gelu(einsum("ecd,edf->ecf", ex, p.w_gate),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    eo = einsum("ecf,efd->ecd", h, p.w_down).reshape(E * C, d)

    contrib = torch.where(keep[:, None],
                          eo[slot] * g_sorted[:, None].to(x.dtype), 0)
    out = x.new_zeros((T, d)).index_add_(0, t_sorted, contrib.to(x.dtype))
    return out.reshape(b, s, d), aux
