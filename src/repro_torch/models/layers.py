"""Core transformer layers: norms, RoPE, GQA attention (full / sliding /
softcapped), gated MLPs, embeddings.  Port of `repro/models/layers.py`.

The blocks that own weights are `nn.Module`s (`Attention`, `MLP`,
`Embedding`) holding them in the reference's layout (`x @ w` with `w`
[d_in, d_out]), so the reference's arrays carry over unchanged
(`model.params_from_reference`).  The math stays plain functions over
tensors, each beside its counterpart's name.  Attention is XLA code in the
reference, not a Pallas kernel, so here it is plain torch ops too: the
dense path and the chunked online-softmax (flash) path, switched by
`FLASH_THRESHOLD` as there.  Mixed dtypes promote as `jnp` promotes
(`mm`, `einsum`): torch's matmul wants one dtype.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import torch_dtype


class Init:
    """Where a model's weights come from: normals drawn on `device` from
    `generator` (f32, scaled, then cast), or, without a generator, tensors
    left unset (`torch.empty`) for a caller that fills them.  Weights are
    made without gradients; the trainer turns them on
    (`train.step.init_state`)."""

    def __init__(self, device: torch.device, generator=None):
        self.device = device
        self.generator = generator

    def normal(self, shape, scale: float, dtype) -> nn.Parameter:
        if self.generator is None:
            t = torch.empty(shape, dtype=dtype, device=self.device)
        else:
            t = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            t = t.mul_(scale).to(dtype)
        return nn.Parameter(t, requires_grad=False)

    def dense(self, d_in: int, d_out: int, dtype, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        return self.normal((d_in, d_out), scale, dtype)

    def zeros(self, shape, dtype=torch.float32) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                        device=self.device),
                            requires_grad=False)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` in the promoted dtype, as `jnp.matmul` computes it."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rms_norm(x, w, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float):
    # numpy f32, the reference's own expression: a torch pow may differ in
    # the last bit
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=None)
def _freqs_on(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    # one upload per (head dim, theta, device): read-only, shared
    return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def rope_rotation(positions, hd: int, theta):
    """cos and sin of the rotation angles at positions [..., S], each
    [..., S, 1, hd/2] in f32: one pair serves q and k of every layer."""
    freqs = _freqs_on(hd, float(theta), positions.device)   # [hd/2]
    ang = positions[..., :, None].float() * freqs           # [..., S, hd/2]
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x, positions, theta, rot=None):
    """x: [..., S, H, hd]; positions: [..., S].  Split-half rotation;
    `rot` is `rope_rotation(positions, hd, theta)` when the caller has it."""
    cos, sin = rot or rope_rotation(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        hd = cfg.hd
        self.wq = init.dense(cfg.d_model, cfg.n_heads * hd, dt)
        self.wk = init.dense(cfg.d_model, cfg.n_kv_heads * hd, dt)
        self.wv = init.dense(cfg.d_model, cfg.n_kv_heads * hd, dt)
        self.wo = init.dense(cfg.n_heads * hd, cfg.d_model, dt)


# Above this many score elements per (batch*head) the full S x T score
# tensor is replaced by the flash-style chunked path (online softmax).
# The chunks are read when the flash path runs, so a test may patch them.
FLASH_THRESHOLD = 4096 * 4096
FLASH_Q_CHUNK = 1024
FLASH_KV_CHUNK = 1024


def _grouped_scores(q, k):
    """GQA without materializing repeated KV.
    q: [B,S,Hkv,G,hd]; k: [B,T,Hkv,hd] -> [B,Hkv,G,S,T]."""
    return einsum("bskgd,btkd->bkgst", q, k)


def _mask(qpos, kpos, causal, window):
    """[B,1,1,S,T] validity of each score, as the reference builds it."""
    kp = kpos[:, None, None, None, :]
    qp = qpos[:, None, None, :, None]
    mask = (kp >= 0)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    return mask


def _attend_dense(q, k, v, qpos, kpos, *, causal, window, attn_softcap,
                  scale, mask=None):
    """Full-score attention.  q: [B,S,Hkv,G,hd]; k,v: [B,T,Hkv,hd];
    `mask` is `_mask(qpos, kpos, causal, window)` when the caller has it."""
    scores = _grouped_scores(q, k).float() * scale
    if attn_softcap:
        scores = softcap(scores, attn_softcap)
    if mask is None:
        mask = _mask(qpos, kpos, causal, window)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return einsum("bkgst,btkd->bskgd", probs, v)


def _pad_seq(x, n: int, fill):
    """`x` padded along dim 1 to length `n` with `fill`."""
    if x.shape[1] == n:
        return x
    pad = x.new_full((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]), fill)
    return torch.cat([x, pad], dim=1)


def _attend_flash(q, k, v, qpos, kpos, *, causal, window, attn_softcap,
                  scale, q_chunk=None, kv_chunk=None):
    """Online-softmax chunked attention: never materializes S x T scores.
    Shapes as in _attend_dense.  Outer loop over q chunks, inner over kv
    chunks (the reference's double scan)."""
    b, s, hkv, g, hd = q.shape
    t = k.shape[1]
    qc = min(q_chunk or FLASH_Q_CHUNK, s)
    kc = min(kv_chunk or FLASH_KV_CHUNK, t)
    nq = (s + qc - 1) // qc
    nk = (t + kc - 1) // kc
    qp, qpp = _pad_seq(q, nq * qc, 0), _pad_seq(qpos, nq * qc, -2)
    kp, vp = _pad_seq(k, nk * kc, 0), _pad_seq(v, nk * kc, 0)
    kpp = _pad_seq(kpos, nk * kc, -1)
    outs = []
    for i in range(nq):
        qq, qpos_c = qp[:, i * qc:(i + 1) * qc], qpp[:, i * qc:(i + 1) * qc]
        m = q.new_full((b, hkv, g, qc), -math.inf, dtype=torch.float32)
        l = q.new_zeros((b, hkv, g, qc), dtype=torch.float32)
        acc = q.new_zeros((b, hkv, g, qc, hd), dtype=torch.float32)
        for j in range(nk):
            kk, vv = kp[:, j * kc:(j + 1) * kc], vp[:, j * kc:(j + 1) * kc]
            kpos_c = kpp[:, j * kc:(j + 1) * kc]
            sc = einsum("bskgd,btkd->bkgst", qq, kk).float() * scale
            if attn_softcap:
                sc = softcap(sc, attn_softcap)
            sc = sc.masked_fill(~_mask(qpos_c, kpos_c, causal, window),
                                -1e30)
            m_new = torch.maximum(m, sc.amax(-1))          # [B,Hkv,G,qc]
            alpha = torch.exp(m - m_new)
            pe = torch.exp(sc - m_new[..., None])
            l = l * alpha + pe.sum(-1)
            acc = acc * alpha[..., None] + einsum(
                "bkgst,btkd->bkgsd", pe.to(vv.dtype), vv).float()
            m = m_new
        out = (acc / l.clamp_min(1e-30)[..., None]).to(v.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))            # [B,qc,Hkv,G,hd]
    return torch.cat(outs, dim=1)[:, :s]


def attention(p: Attention, cfg, x, positions, *, causal=True, window=0,
              kv=None, kv_positions=None, cross_kv=None, rot=None,
              mask=None):
    """Batched GQA without KV repetition.  x: [B,S,D].

    kv: optional precomputed (k, v) tensors [B,T,Hkv,hd] (decode w/ cache or
    cross attention); kv_positions: [B,T] (masking; -1 = invalid slot).
    rot, mask: the layer-independent `rope_rotation` of `positions` and
    `_mask` of the self-attention scores, when the caller computed them
    once for all layers (the flash path builds its masks per chunk).
    """
    b, s, _ = x.shape
    hd = cfg.hd
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    q = mm(x, p.wq).reshape(b, s, cfg.n_heads, hd)
    if cross_kv is not None:
        k, v = cross_kv
        kpos = kv_positions
        causal = False
        window = 0
    elif kv is not None:
        k, v = kv
        kpos = kv_positions
        q = apply_rope(q, positions, cfg.rope_theta, rot)
    else:
        k = mm(x, p.wk).reshape(b, s, hkv, hd)
        v = mm(x, p.wv).reshape(b, s, hkv, hd)
        q = apply_rope(q, positions, cfg.rope_theta, rot)
        k = apply_rope(k, positions, cfg.rope_theta, rot)
        kpos = positions
    qg = q.reshape(b, s, hkv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    kw = dict(causal=causal, window=window, attn_softcap=cfg.attn_softcap,
              scale=scale)
    if s * k.shape[1] > FLASH_THRESHOLD:
        out = _attend_flash(qg, k, v, positions, kpos, **kw)
    else:
        out = _attend_dense(qg, k, v, positions, kpos,
                            mask=None if cross_kv is not None else mask,
                            **kw)
    return mm(out.reshape(b, s, cfg.n_heads * hd), p.wo)


def project_kv(p: Attention, cfg, x, positions, rot=None):
    """Compute rotated (k, v) for cache insertion. x: [B,S,D]."""
    b, s, _ = x.shape
    hd = cfg.hd
    k = mm(x, p.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = mm(x, p.wv).reshape(b, s, cfg.n_kv_heads, hd)
    k = apply_rope(k, positions, cfg.rope_theta, rot)
    return k, v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg, init: Init, d_ff=None):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        d_ff = d_ff or cfg.d_ff
        self.w_up = init.dense(cfg.d_model, d_ff, dt)
        self.w_down = init.dense(d_ff, cfg.d_model, dt)
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = init.dense(cfg.d_model, d_ff, dt)


def mlp(p: MLP, cfg, x):
    up = mm(x, p.w_up)
    if cfg.act == "swiglu":
        h = F.silu(mm(x, p.w_gate)) * up
    elif cfg.act == "geglu":
        h = F.gelu(mm(x, p.w_gate), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return mm(h, p.w_down)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.tok = init.normal((cfg.vocab, cfg.d_model), 0.02, dt)
        if not cfg.tie_embeddings:
            self.head = init.dense(cfg.d_model, cfg.vocab, dt)


def embed(p: Embedding, cfg, tokens):
    # an out-of-range token raises here (jnp.take would clamp it)
    return F.embedding(tokens, p.tok)


def lm_logits(p: Embedding, cfg, x):
    if cfg.tie_embeddings:
        logits = mm(x, p.tok.T)
    else:
        logits = mm(x, p.head)
    logits = logits.float()
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits
