"""Plain PyTorch version of the DILI lookup kernel (port of
`repro/kernels/ref.py`).

Mirrors the kernel's semantics exactly: f32 keys/models, mul-then-add
slot prediction with two roundings, XLA's saturating float->int32 cast,
fixed `max_depth` traversal, no dense-leaf handling (dense lanes are
flagged for the wrapper's recheck — see ops.py).  The CPU tests hold it
against the Pallas kernel; on the card the CUDA kernel is held against it.
"""

from __future__ import annotations

import torch

from ..core.search import predict_slot

TAG_EMPTY, TAG_PAIR, TAG_CHILD = 0, 1, 2


def dili_search_ref(a, b, base, fo, dense, tag, key, val, root, queries,
                    max_depth: int):
    """Returns (vals i32, found bool, needs_fallback bool) per query.
    `root` is a scalar (int or 0-d/1-element int32 tensor)."""
    q = queries
    dev = q.device
    n = torch.zeros(q.shape, dtype=torch.int32, device=dev) + root
    done = torch.zeros(q.shape, dtype=torch.bool, device=dev)
    out = torch.full(q.shape, -1, dtype=torch.int32, device=dev)
    found = torch.zeros_like(done)
    fallback = torch.zeros_like(done)

    for _ in range(max_depth):
        ni = n.long()
        an = a[ni]
        bn = b[ni]
        fon = fo[ni]
        is_dense = dense[ni] > 0
        pos = predict_slot(an, bn, q, fon)
        s = (base[ni] + pos).long()
        t = tag[s]
        sk = key[s]
        sv = val[s]
        active = ~done & ~is_dense
        is_child = (t == TAG_CHILD) & active
        hit = (t == TAG_PAIR) & (sk == q) & active
        miss = ((t == TAG_EMPTY) | ((t == TAG_PAIR) & (sk != q))) & active
        out = torch.where(hit, sv, out)
        found = found | hit
        fallback = fallback | (is_dense & ~done)
        n = torch.where(is_child, sv, n)
        done = done | hit | miss | (is_dense & ~done)

    fallback = fallback | ~done   # ran out of depth: the wrapper rechecks
    return out, found, fallback
