"""Pipeline parallelism (GPipe schedule) over the multi-pod "pod" axis.
Port of `repro/parallel/pipeline.py`.

The layer stack is split into |pod| contiguous stages.  The classic GPipe
loop runs M microbatches stage to stage: at tick t, stage s computes
microbatch t - s, so the schedule takes M + S - 1 ticks and its bubble
fraction is (S-1)/(M+S-1).  The reference runs one stage a device inside
`shard_map` and hands activations on with `ppermute`; on the one card the
stages run in turn within a tick and the hand-off is the activation
tensor itself.  A stage's tick outside its microbatches (the bubble) only
computes what the reference discards, and is skipped.  The last stage
fills the output buffer; then come the final norm and the head.  Dense
family only, as in the reference; gradients flow through it as through
any torch code.
"""

from __future__ import annotations

import torch

from ..models import layers as L
from ..models import model as MDL
from ..models.config import ModelConfig
from .sharding import Mesh


def split_stages(layers, n_stages: int) -> list:
    """The per-layer list as `n_stages` contiguous groups."""
    n = len(layers)
    if n % n_stages:
        raise ValueError(f"{n} layers do not split into {n_stages} stages")
    per = n // n_stages
    return [list(layers[s * per:(s + 1) * per]) for s in range(n_stages)]


def _attn_block(pl_, cfg, x, positions, rot):
    """The reference's `model._attn_block` (window 0): (x, aux)."""
    h = L.rms_norm(x, pl_.norm1, cfg.norm_eps)
    a = L.attention(pl_.attn, cfg, h, positions, causal=True, rot=rot)
    return MDL._after_attn(pl_, cfg, x, a)


def pipeline_forward(cfg: ModelConfig, mesh: Mesh, params: MDL.LM, tokens,
                     n_micro: int = 8):
    """Embedding + PP layer stack + head.  tokens: [B, S_len] -> logits
    [B, S_len, V] (f32)."""
    n_stages = mesh.shape["pod"]
    stages = split_stages(params.layers, n_stages)
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    x = L.embed(params.embed, cfg, tokens)
    mb = x.reshape(n_micro, b // n_micro, s, -1)
    positions = torch.arange(s, device=x.device).expand(b // n_micro, s)
    rot = L.rope_rotation(positions, cfg.hd, cfg.rope_theta)

    def stage_fn(stage_layers, h):
        for pl_ in stage_layers:
            h, _ = _attn_block(pl_, cfg, h, positions, rot)
        return h

    held = [None] * n_stages         # what each stage received last tick
    buf = [None] * n_micro           # outputs finished on the last stage
    for t in range(n_micro + n_stages - 1):
        outs = [None] * n_stages
        for st in range(n_stages):
            if not 0 <= t - st < n_micro:
                continue             # the bubble
            h_in = mb[t] if st == 0 else held[st]
            outs[st] = stage_fn(stages[st], h_in)
        if t >= n_stages - 1:
            buf[t - (n_stages - 1)] = outs[-1]
        held = [None] + outs[:-1]    # stage i -> i+1
    x = torch.stack(buf).reshape(b, s, -1)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.lm_logits(params.embed, cfg, x)
