"""Gradient compression: int8 quantization with error feedback.  Port of
`repro/parallel/compression.py`.

`ErrorFeedback` carries the quantization residual into the next step
(Karimireddy et al. 2019) so convergence is preserved: `ef_compress`
quantizes each gradient leaf (plus its residual) to int8 with a per-tensor
scale and returns what dequantizes back, and the new residual.  The
reference's `psum_int8`, the compressed all-reduce inside `shard_map`,
waits for the parallel slice (ROADMAP item 11c): on one card there is no
data-parallel reduction to compress.

Trees are the optimizer's (`train.optim`): nested dicts whose leaves are
tensors or stacks (lists of per-layer tensors).
"""

from __future__ import annotations

import torch

from ..train.optim import slices, tree_map


def quantize_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def ef_compress(grads, residual):
    """Error feedback: g' = Q(g + r); r' = (g + r) - g'.  A stack is one
    leaf of the reference: one scale over all its slices."""
    def leaf(g, r):
        ts = [gi.float() + ri for gi, ri in zip(slices(g), slices(r))]
        q, scale = quantize_int8(torch.cat([t.reshape(-1) for t in ts]))
        deqs = [d.reshape(t.shape) for d, t in zip(
            dequantize_int8(q, scale).split([t.numel() for t in ts]), ts)]
        comp = [d.to(gi.dtype) for d, gi in zip(deqs, slices(g))]
        res = [t - d for t, d in zip(ts, deqs)]
        if isinstance(g, list):
            return comp, res
        return comp[0], res[0]

    pairs = tree_map(leaf, grads, residual)
    comp = tree_map(lambda x: x[0], pairs)
    res = tree_map(lambda x: x[1], pairs)
    return comp, res


def init_residual(params):
    def zeros(p):
        out = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in slices(p)]
        return out if isinstance(p, list) else out[0]
    return tree_map(zeros, params)
