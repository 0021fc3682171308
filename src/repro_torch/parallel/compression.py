"""Gradient compression: int8 quantized all-reduce with error feedback.
Port of `repro/parallel/compression.py`.

`psum_int8` is the compressed all-reduce: each shard's tensor is quantized
to int8 with one scale (the largest of the shards' per-tensor scales, so
every participant dequantizes alike), the int8 payloads are summed as
int32 (no overflow at 512 participants), and the sum is dequantized.  The
reference runs it inside `shard_map` over a mesh axis; on the one card the
shards' slices are stacked on a leading axis, the axis's `pmax` and `psum`
become a max and a sum over it, and every shard's result is returned, as
`core/distributed.py` emulates the sharded engine's collectives.
`ErrorFeedback` carries the quantization residual into the next step
(Karimireddy et al. 2019) so convergence is preserved: `ef_compress`
quantizes each gradient leaf (plus its residual) to int8 with a per-tensor
scale and returns what dequantizes back, and the new residual.

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


def psum_int8(x):
    """Compressed psum of per-shard float tensors stacked as x [n, ...]:
    the reference's formula (per-shard scale, its max across shards,
    round half to even, clip to +-127, int8, int32 sum, times the scale).
    Returns every shard's result, [n, ...] (all equal), in f32."""
    per_shard = torch.abs(x).reshape(x.shape[0], -1).amax(dim=1)
    scale = torch.clamp(per_shard, min=1e-12) / 127.0
    scale = torch.amax(scale)                               # pmax
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    s = torch.sum(q.to(torch.int32), dim=0, dtype=torch.int32)   # psum
    return (s.to(torch.float32) * scale).expand_as(x)


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
