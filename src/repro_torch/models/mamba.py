"""Mamba-1 selective scan and Mamba-2 SSD blocks (falcon-mamba / zamba2).
Port of `repro/models/mamba.py`.

Training and prefill scan the sequence in chunks of `SCAN_CHUNK`
(`cfg.scan_chunk`): a Python loop over the chunks carries the state in
f32, as the reference's outer `lax.scan` does.  Inside a chunk, Mamba-1's
recurrence  h_t = A_t * h_{t-1} + B_t x_t  runs as `associative_scan`, a
tensor port of jax's own odd/even recursion (`lax.associative_scan`), with
the reference's combine  (a_l * a_r, b_l * a_r + b_r): the same pairs are
combined in the same order, so the two differ only where XLA contracts
`b_l * a_r + b_r` into one FMA.  Mamba-2's chunk is the SSD dual form, an
attention-like [c, c] decay-weighted product.  Decode is the same block on
one token with the carried state: an O(1) update.

The weights are `nn.Module`s in the reference's names, shapes and dtypes
(`Mamba`, `Mamba2`); the math is plain functions over tensors.  Every
product of activations with a weight goes through `layers.mm` (the
`aten.mm` that the `dots` remat policy saves); the scans' einsums have
batch dimensions and are recomputed, as the reference's
`checkpoint_dots_with_no_batch_dims` does.

State layout:
  mamba1: conv state [B, d_conv-1, d_inner]; ssm state [B, d_inner, d_state]
  mamba2: conv state [B, d_conv-1, d_inner(+2*groups*d_state)];
          ssm state [B, n_heads, head_dim, d_state]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from .config import torch_dtype


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus switches to x
    # above its threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    def __init__(self, cfg, init: L.Init):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        di, ds = cfg.d_inner, cfg.ssm_state
        dt_rank = max(cfg.d_model // 16, 1)
        f32 = torch.float32
        self.w_in = init.dense(cfg.d_model, 2 * di, dt)
        self.conv_w = init.normal((cfg.d_conv, di), 0.1, dt)
        self.conv_b = init.zeros((di,), dt)
        self.w_xbc = init.dense(di, dt_rank + 2 * ds, dt)
        self.w_dt = init.dense(dt_rank, di, dt)
        self.dt_bias = init.zeros((di,))
        self.a_log = _param(torch.log(torch.arange(
            1, ds + 1, dtype=f32, device=init.device).repeat(di, 1)))
        self.d_skip = _param(torch.ones((di,), dtype=f32, device=init.device))
        self.w_out = init.dense(di, cfg.d_model, dt)


def init_mamba(cfg, init: L.Init) -> Mamba:
    """The reference's `init_mamba`: a block's weights drawn by `init`."""
    return Mamba(cfg, init)


def _causal_conv(x, w, b, state=None):
    """x: [B,S,C]; w: [K,C] depthwise.  Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # [B, S+K-1, C]
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else torch.zeros_like(pad)
    return F.silu(y + b), new_state


SCAN_CHUNK = 64   # sequence chunk for the selective scan (memory knob):
                  # per-chunk state tensor is [B, chunk, d_inner, d_state]


def _scan_combine(a, b):
    a_l, b_l = a
    a_r, b_r = b
    return a_l * a_r, b_l * a_r + b_r


def _interleave(a, b, axis: int):
    """a[0], b[0], a[1], b[1], ... along `axis` (a one longer, or equal)."""
    n = b.shape[axis]
    both = torch.stack([a.narrow(axis, 0, n), b], dim=axis + 1)
    out = both.flatten(axis, axis + 1)
    if a.shape[axis] > n:
        out = torch.cat([out, a.narrow(axis, n, 1)], dim=axis)
    return out


def _strided(x, start: int, stop, axis: int):
    """x[start:stop:2] along `axis`."""
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, 2)
    return x[tuple(idx)]


def associative_scan(fn, elems, axis: int = 0):
    """Inclusive scan of the tuple of tensors `elems` along `axis` under
    the associative `fn`, by jax's odd/even recursion
    (`lax.associative_scan`): pairs are reduced, the half-length scan
    recursed, and the even positions filled in, combining the same pairs
    in the same order as jax.  Log depth, about twice the input's
    memory."""
    n = elems[0].shape[axis]
    if n < 2:
        return list(elems)
    reduced = fn([_strided(e, 0, -1, axis) for e in elems],
                 [_strided(e, 1, None, axis) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([e.narrow(axis, 0, e.shape[axis] - 1) for e in odd],
                  [_strided(e, 2, None, axis) for e in elems])
    else:
        even = fn(odd, [_strided(e, 2, None, axis) for e in elems])
    even = [torch.cat([e.narrow(axis, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _chunks(x, c: int, nc: int):
    """x [B, S, ...] zero-padded to nc * c along S, as nc chunks
    [B, c, ...]."""
    pad = nc * c - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                      dim=1)
    return x.split(c, dim=1)


def _selective_scan(u, dt_, A, B, C, h0=None, chunk: int = SCAN_CHUNK):
    """u: [B,S,di]; dt_: [B,S,di]; A: [di,ds]; B,C: [B,S,ds].
    Returns (y [B,S,di], h_last [B,di,ds]).

    Chunked over the sequence: a loop over the chunks carries the state
    in f32, the associative scan runs within a chunk — the full
    [B,S,di,ds] tensor is never materialized; peak is [B,chunk,di,ds].
    """
    b, s, di = u.shape
    ds = A.shape[1]
    sdt = u.dtype                 # scan compute dtype (perf knob)
    h = h0 if h0 is not None else u.new_zeros((b, di, ds),
                                              dtype=torch.float32)
    c = min(chunk, s)
    nc = (s + c - 1) // c
    ys = []
    for u1, dt1, B1, C1 in zip(*(_chunks(x, c, nc) for x in (u, dt_, B, C))):
        dA = torch.exp(dt1[..., None] * A[None, None]).to(sdt)
        dBu = (dt1[..., None] * B1[:, :, None, :]
               * u1[..., None]).to(sdt)              # [B,c,di,ds]
        first = dBu[:, :1] + (dA[:, :1].float() * h[:, None]).to(sdt)
        dBu = torch.cat([first, dBu[:, 1:]], dim=1)
        _, hh = associative_scan(_scan_combine, (dA, dBu), axis=1)
        ys.append(L.einsum("bsdn,bsn->bsd", hh, C1))
        h = hh[:, -1].float()                        # f32 carry across chunks
    y = torch.cat(ys, dim=1)[:, :s]
    return y, h


def mamba_block(p: Mamba, cfg, x, state=None):
    """x: [B,S,D] -> (y, new_state).  state = (conv_state, ssm_state)."""
    ds = cfg.ssm_state
    dt_rank = p.w_dt.shape[0]
    xz = L.mm(x, p.w_in)
    u, z = xz.chunk(2, dim=-1)
    conv_state = state[0] if state is not None else None
    u, new_conv = _causal_conv(u, p.conv_w, p.conv_b, conv_state)
    xbc = L.mm(u, p.w_xbc)
    dt_in, Bm, Cm = xbc.split([dt_rank, ds, ds], dim=-1)
    dt_ = _softplus(L.mm(dt_in, p.w_dt).float() + p.dt_bias)
    A = -torch.exp(p.a_log)                                  # [di, ds]
    h0 = state[1] if state is not None else None
    sdt = torch_dtype(getattr(cfg, "scan_dtype", "float32"))
    y, h_last = _selective_scan(u.to(sdt), dt_.to(sdt), A.to(sdt),
                                Bm.to(sdt), Cm.to(sdt), h0,
                                chunk=getattr(cfg, "scan_chunk", SCAN_CHUNK))
    y = y.float()
    y = y + u.float() * p.d_skip
    y = y.to(x.dtype) * F.silu(z)
    return L.mm(y, p.w_out), (new_conv, h_last)


def mamba_decode_step(p: Mamba, cfg, x, state):
    """Single-token decode: x [B,1,D]; O(1) state update."""
    return mamba_block(p, cfg, x, state)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, scalar-decay-per-head)
# ---------------------------------------------------------------------------


def n_ssm_heads(cfg) -> int:
    return cfg.ssm_heads or max(cfg.d_inner // 64, 1)


class Mamba2(nn.Module):
    def __init__(self, cfg, init: L.Init):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        di, ds = cfg.d_inner, cfg.ssm_state
        nh = n_ssm_heads(cfg)
        f32 = torch.float32
        self.w_in = init.dense(cfg.d_model, 2 * di + 2 * ds + nh, dt)
        self.conv_w = init.normal((cfg.d_conv, di + 2 * ds), 0.1, dt)
        self.conv_b = init.zeros((di + 2 * ds,), dt)
        self.a_log = init.zeros((nh,))
        self.dt_bias = init.zeros((nh,))
        self.d_skip = _param(torch.ones((nh,), dtype=f32, device=init.device))
        self.norm_w = init.zeros((di,))
        self.w_out = init.dense(di, cfg.d_model, dt)


def init_mamba2(cfg, init: L.Init) -> Mamba2:
    """The reference's `init_mamba2`: a block's weights drawn by `init`."""
    return Mamba2(cfg, init)


def _ssd_scan(u_h, dt_, A_h, Bm, Cm, h0, chunk: int = SCAN_CHUNK):
    """Mamba-2 SSD dual form, chunked.

    u_h: [B,S,nh,hd]; dt_: [B,S,nh]; A_h: [nh] (negative); Bm,Cm: [B,S,ds];
    h0: [B,nh,hd,ds].  Within a chunk the recurrence collapses to an
    attention-like [c,c] decay-weighted matmul (never materializes the
    per-position state tensor); across chunks a loop carries the state.
    """
    b, s, nh, hd = u_h.shape
    ds = Bm.shape[-1]
    c = min(chunk, s)
    nc = (s + c - 1) // c
    ld = A_h[None, None, :] * dt_                    # [B,S,nh] log-decay <= 0
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=u_h.device))
    h = h0 if h0 is not None else u_h.new_zeros((b, nh, hd, ds))
    ys = []
    for u1, dt1, ld1, B1, C1 in zip(*(_chunks(x, c, nc)
                                      for x in (u_h, dt_, ld, Bm, Cm))):
        g = torch.cumsum(ld1, dim=1)                         # [B,c,nh]
        # intra-chunk: w[t,s] = exp(g_t - g_s) * dt_s * (C_t . B_s), s <= t
        cb = L.einsum("btk,bsk->bts", C1, B1)                # [B,c,c]
        # the reference exponentiates the whole square: g_t - g_s > 0
        # above the diagonal, and once it passes ~88.7 exp overflows to
        # inf, which `where` drops from the forward but whose gradient is
        # 0 * inf = NaN.  The exponent is masked first (exp(-inf) = 0):
        # the same forward bit for bit, and the reference's gradient
        # wherever that is finite.
        keep = tri[None, :, :, None]
        dec = torch.exp(torch.where(keep, g[:, :, None, :] - g[:, None, :, :],
                                    -torch.inf))             # [B,t,s,nh]
        w = torch.where(keep, dec * dt1[:, None, :, :], 0.0) * cb[..., None]
        y_intra = L.einsum("btsn,bsnd->btnd", w, u1)
        # inter-chunk: y_t += exp(g_t) * (C_t . h)
        y_inter = (torch.exp(g)[..., None]
                   * L.einsum("btk,bndk->btnd", C1, h))
        # state: h' = exp(g_end)*h + sum_s exp(g_end - g_s)*dt_s * u_s (x) B_s
        g_end = g[:, -1]                                     # [B,nh]
        w_end = torch.exp(g_end[:, None, :] - g) * dt1       # [B,c,nh]
        h = (torch.exp(g_end)[:, :, None, None] * h
             + torch.einsum("bsn,bsnd,bsk->bndk", w_end, u1, B1))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, h


def mamba2_block(p: Mamba2, cfg, x, state=None):
    """SSD with scalar per-head decay.  x: [B,S,D]."""
    b, s, _ = x.shape
    di = cfg.d_inner
    ds = cfg.ssm_state
    nh = n_ssm_heads(cfg)
    hd = di // nh
    zxbcdt = L.mm(x, p.w_in)
    z, xbc, dt_in = zxbcdt.split([di, di + 2 * ds, nh], dim=-1)
    conv_state = state[0] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    u, Bm, Cm = xbc.split([di, ds, ds], dim=-1)
    dt_ = _softplus(dt_in.float() + p.dt_bias)                     # [B,S,nh]
    A_h = -torch.exp(p.a_log)                                      # [nh]
    u_h = u.reshape(b, s, nh, hd).float()
    h0 = state[1] if state is not None else None
    y, h_last = _ssd_scan(u_h, dt_, A_h, Bm.float(), Cm.float(), h0)
    y = y + u_h * p.d_skip[None, None, :, None]
    y = y.reshape(b, s, di)
    # gated RMSNorm (mamba2)
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5) * (1.0 + p.norm_w)
    y = y.to(x.dtype) * F.silu(z)
    return L.mm(y, p.w_out), (new_conv, h_last)
