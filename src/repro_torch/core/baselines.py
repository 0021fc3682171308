"""The paper's competitor indexes, as batched torch searches (section 7.1;
port of `repro/core/baselines.py`).

Implemented: BinS, B+Tree, RMI (2-stage), PGM (epsilon-bounded PLA), RS
(RadixSpline), LIPP, ALEX-lite (gapped arrays + power-of-2 internal fanout).
MassTree is out of scope, as in the reference (DESIGN.md).

Each index exposes:  build(keys, vals) -> state dict (numpy, the
reference's builds copied), `device(state, dtype, device)` -> dict of
tensors on `device` (CUDA unless the caller asks for the CPU), and
`lookup(state, queries)` returning (vals, found, probes) where probes
counts memory touches (Table 5 proxy).

The lookups are eager torch ops, as the reference's are eager jnp ops (its
`lookup`s are not jitted), and they give the reference's answers lane for
lane:

  * two roundings: `a + b*q` is two ops, never `addcmul` or
    `torch.compile`;
  * float -> int32 casts saturate as XLA's do (`search.sat_i32`), and the
    integer arithmetic stays int32, so the values that wrap in the
    reference (a -inf query's INT32_MIN prediction minus its error bound)
    wrap here; an index becomes int64 only at its gather;
  * the reference clips every gather index (JAX would clamp it silently,
    torch raises);
  * RS and ALEX keep `k0`, `k1` as numpy f64 scalars, which JAX does not
    weakly type: `q - k0` promotes an f32 query to f64, so their bucket
    is computed in f64 at every dtype.

LIPP is DILI's own `local_opt` tree from a single whole-range root, so its
walk is Alg. 6: values and found flags come from one launch of the
f64/i64 lookup kernel with no overlay, and the count of nodes and probes
from `search.search_batch(with_stats=True)` over the column tables, which
is where the reference's count comes from too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as K
from ..kernels.dili_search import dili_search_f64
from . import search as S
from .bu_tree import least_squares
from .dili import Leaf, local_opt
from .flat import flatten as flatten_dili
from .search import _t, sat_i32


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _zero(q: torch.Tensor) -> torch.Tensor:
    """int32 zeros shaped like `q`.  The reference's `(q*0).astype(int32)`
    is 0 under XLA even on ±inf and NaN lanes; torch's `q*0` is NaN there."""
    return torch.zeros_like(q, dtype=torch.int32)


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.floor(x).astype(jnp.int32)`."""
    return sat_i32(torch.floor(x))


def _binary_search(keys: torch.Tensor, q: torch.Tensor, lo, hi, iters: int,
                   upper: bool = False):
    """Vectorized binary search in keys[lo..hi); probes counted.

    lower (default): first index with keys[i] >= q.
    upper:           first index with keys[i] >  q  (use upper-1 for
                     "which segment covers q" selections — lower-1 is wrong
                     exactly when q equals a segment-start key).
    """
    probes = _zero(q)
    last = len(keys) - 1
    for _ in range(iters):
        mid = (lo + hi) // 2
        go = lo < hi
        k = keys[mid.clamp(0, last).long()]
        below = (k <= q) if upper else (k < q)
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid, hi)
        probes = probes + go.to(torch.int32)
    return lo, probes


# ---------------------------------------------------------------------------
# BinS: binary search over the full sorted array
# ---------------------------------------------------------------------------


class BinS:
    name = "BinS"

    @staticmethod
    def build(keys, vals):
        return dict(keys=np.asarray(keys, np.float64),
                    vals=np.asarray(vals, np.int64), n=len(keys))

    @staticmethod
    def device(st, dtype=torch.float64, device="cuda"):
        device = resolve_device(device)
        return dict(keys=_t(st["keys"], dtype, device),
                    vals=_t(st["vals"], torch.int32, device),
                    n=st["n"])

    @staticmethod
    def lookup(st, q):
        n = st["n"]
        iters = max(int(math.ceil(math.log2(max(n, 2)))) + 1, 1)
        zi = _zero(q)
        pos, probes = _binary_search(st["keys"], q, zi, zi + n, iters)
        pos = pos.clamp(0, n - 1).long()
        found = st["keys"][pos] == q
        return st["vals"][pos], found, probes + 1


# ---------------------------------------------------------------------------
# B+Tree: implicit structure-of-arrays multiway tree
# ---------------------------------------------------------------------------


class BTree:
    name = "B+Tree"

    @staticmethod
    def build(keys, vals, fanout: int = 32):
        keys = np.asarray(keys, np.float64)
        levels = []          # top..bottom separator arrays
        cur = keys[::1]
        # leaf level = the keys themselves (implicit); build separator levels
        sep = keys[::fanout]
        while len(sep) > 1:
            levels.append(sep)
            sep = sep[::fanout]
        levels.reverse()     # levels[0] is the root separator array
        return dict(keys=keys, vals=np.asarray(vals, np.int64),
                    levels=[l for l in levels], fanout=fanout, n=len(keys))

    @staticmethod
    def device(st, dtype=torch.float64, device="cuda"):
        device = resolve_device(device)
        return dict(keys=_t(st["keys"], dtype, device),
                    vals=_t(st["vals"], torch.int32, device),
                    levels=tuple(_t(l, dtype, device) for l in st["levels"]),
                    fanout=st["fanout"], n=st["n"])

    @staticmethod
    def lookup(st, q):
        fo = st["fanout"]
        zi = _zero(q)
        node = zi           # index into current level
        probes = zi
        itb = int(math.ceil(math.log2(fo))) + 1
        for lvl in st["levels"]:
            n_l = len(lvl)
            lo = node * fo
            hi = (lo + fo).clamp(max=n_l)
            # binary search within the node's separator window
            pos, pr = _binary_search(lvl, q, lo, hi, itb, upper=True)
            # child = (#separators <= q) - 1  (separators are child lower bounds)
            node = (pos - 1).clamp(0, n_l - 1)
            probes = probes + pr + 1
        # leaf: binary search within the fanout-sized run of keys
        lo = node * fo
        hi = (lo + fo).clamp(max=st["n"])
        pos, pr = _binary_search(st["keys"], q, lo, hi, itb)
        pos = pos.clamp(0, st["n"] - 1).long()
        found = st["keys"][pos] == q
        return st["vals"][pos], found, probes + pr + 1


# ---------------------------------------------------------------------------
# RMI: 2-stage recursive model index with per-model error bounds
# ---------------------------------------------------------------------------


class RMI:
    name = "RMI"

    @staticmethod
    def build(keys, vals, n_models: int = 4096):
        keys = np.asarray(keys, np.float64)
        n = len(keys)
        y = np.arange(n, dtype=np.float64)
        a1, b1 = least_squares(keys, y * (n_models / n))
        mid = np.clip(np.floor(a1 + b1 * keys).astype(np.int64), 0,
                      n_models - 1)
        a2 = np.zeros(n_models)
        b2 = np.zeros(n_models)
        err_lo = np.zeros(n_models, np.int64)
        err_hi = np.zeros(n_models, np.int64)
        starts = np.searchsorted(mid, np.arange(n_models), side="left")
        ends = np.searchsorted(mid, np.arange(n_models), side="right")
        for m in range(n_models):
            s, e = starts[m], ends[m]
            if e - s == 0:
                continue
            aa, bb = least_squares(keys[s:e], y[s:e])
            a2[m], b2[m] = aa, bb
            pred = np.floor(aa + bb * keys[s:e])
            d = pred - y[s:e]
            err_lo[m] = int(np.ceil(max(d.max(), 0))) + 1
            err_hi[m] = int(np.ceil(max(-d.min(), 0))) + 1
        return dict(keys=keys, vals=np.asarray(vals, np.int64),
                    a1=a1, b1=b1, a2=a2, b2=b2,
                    err_lo=err_lo, err_hi=err_hi, n=n, n_models=n_models)

    @staticmethod
    def device(st, dtype=torch.float64, device="cuda"):
        device = resolve_device(device)
        return dict(keys=_t(st["keys"], dtype, device),
                    vals=_t(st["vals"], torch.int32, device),
                    a1=_t(st["a1"], dtype, device),
                    b1=_t(st["b1"], dtype, device),
                    a2=_t(st["a2"], dtype, device),
                    b2=_t(st["b2"], dtype, device),
                    err_lo=_t(st["err_lo"], torch.int32, device),
                    err_hi=_t(st["err_hi"], torch.int32, device),
                    n=st["n"], n_models=st["n_models"])

    @staticmethod
    def lookup(st, q):
        n = st["n"]
        m = _floor_i32(st["a1"] + st["b1"] * q).clamp(
            0, st["n_models"] - 1).long()
        pred = _floor_i32(st["a2"][m] + st["b2"][m] * q)
        lo = (pred - st["err_lo"][m]).clamp(0, n - 1)
        hi = (pred + st["err_hi"][m]).clamp(0, n)
        pos, probes = _binary_search(st["keys"], q, lo, hi, 22)
        pos = pos.clamp(0, n - 1).long()
        found = st["keys"][pos] == q
        return st["vals"][pos], found, probes + 2


# ---------------------------------------------------------------------------
# PGM: epsilon-bounded piecewise linear approximation, 2 levels
# ---------------------------------------------------------------------------


def _pla_segments(keys: np.ndarray, eps: int) -> list[tuple[int, int, float, float]]:
    """Greedy epsilon-PLA (slope-cone algorithm): maximal segments such that
    |a + b*x_i - i_local| <= eps for all covered keys."""
    n = len(keys)
    segs = []
    i = 0
    while i < n:
        x0 = keys[i]
        lo_sl, hi_sl = -math.inf, math.inf
        j = i + 1
        while j < n:
            dx = keys[j] - x0
            if dx <= 0:
                break
            y = j - i
            lo_need = (y - eps) / dx
            hi_need = (y + eps) / dx
            nlo = max(lo_sl, lo_need)
            nhi = min(hi_sl, hi_need)
            if nlo > nhi:
                break
            lo_sl, hi_sl = nlo, nhi
            j += 1
        if j == i + 1:
            b = 0.0
        else:
            b = (lo_sl + hi_sl) / 2 if math.isfinite(lo_sl + hi_sl) else 0.0
        a = i - b * x0          # maps key -> global index approx
        segs.append((i, j, a + b * 0, b))  # store (start, end, a_global, b)
        segs[-1] = (i, j, i - b * x0, b)
        i = j
    return segs


class PGM:
    name = "PGM"

    @staticmethod
    def _measured_bound(xs, idx_of, a, b, eps):
        """Verified prediction-error bound (f64 eval error on tight key
        clusters can exceed the cone's epsilon; measure, don't trust)."""
        seg = idx_of
        pred = np.floor(a[seg] + b[seg] * xs)
        return max(int(np.abs(pred - np.arange(len(xs))).max()) + 1, eps)

    @staticmethod
    def build(keys, vals, eps: int = 64):
        keys = np.asarray(keys, np.float64)
        segs = _pla_segments(keys, eps)
        seg_key = np.array([keys[s[0]] for s in segs])
        seg_a = np.array([s[2] for s in segs])
        seg_b = np.array([s[3] for s in segs])
        which = np.clip(np.searchsorted(seg_key, keys, side="right") - 1,
                        0, len(segs) - 1)
        eps1 = PGM._measured_bound(keys, which, seg_a, seg_b, eps)
        # upper level: PLA over segment start keys
        segs2 = _pla_segments(seg_key, eps)
        s2_key = np.array([seg_key[s[0]] for s in segs2])
        s2_a = np.array([s[2] for s in segs2])
        s2_b = np.array([s[3] for s in segs2])
        which2 = np.clip(np.searchsorted(s2_key, seg_key, side="right") - 1,
                         0, len(segs2) - 1)
        eps2 = PGM._measured_bound(seg_key, which2, s2_a, s2_b, eps)
        return dict(keys=keys, vals=np.asarray(vals, np.int64),
                    seg_key=seg_key, seg_a=seg_a, seg_b=seg_b,
                    s2_key=s2_key, s2_a=s2_a, s2_b=s2_b,
                    eps=eps1, eps2=eps2,
                    n=len(keys), n_seg=len(segs), n_seg2=len(segs2))

    @staticmethod
    def device(st, dtype=torch.float64, device="cuda"):
        device = resolve_device(device)
        out = {k: (_t(v, dtype, device) if isinstance(v, np.ndarray)
                   and v.dtype == np.float64 else v) for k, v in st.items()}
        out["vals"] = _t(st["vals"], torch.int32, device)
        return out

    @staticmethod
    def lookup(st, q):
        eps1 = st["eps"]
        eps2 = st["eps2"]
        it1 = int(math.ceil(math.log2(2 * eps1 + 3))) + 1
        it2 = int(math.ceil(math.log2(2 * eps2 + 3))) + 1
        # root -> find segment-of-segments by scanning s2 (small; binary)
        zi = _zero(q)
        n2 = st["n_seg2"]
        p2, pr0 = _binary_search(st["s2_key"], q, zi, zi + n2,
                                 max(int(math.ceil(math.log2(max(n2, 2)))) + 1, 1),
                                 upper=True)
        p2 = (p2 - 1).clamp(0, n2 - 1).long()
        pred = _floor_i32(st["s2_a"][p2] + st["s2_b"][p2] * q)
        lo = (pred - eps2 - 1).clamp(0, st["n_seg"] - 1)
        hi = (pred + eps2 + 2).clamp(0, st["n_seg"])
        p1, pr1 = _binary_search(st["seg_key"], q, lo, hi, it2, upper=True)
        p1 = (p1 - 1).clamp(0, st["n_seg"] - 1).long()
        pred = _floor_i32(st["seg_a"][p1] + st["seg_b"][p1] * q)
        lo = (pred - eps1 - 1).clamp(0, st["n"] - 1)
        hi = (pred + eps1 + 2).clamp(0, st["n"])
        pos, pr2 = _binary_search(st["keys"], q, lo, hi, it1)
        pos = pos.clamp(0, st["n"] - 1).long()
        found = st["keys"][pos] == q
        return st["vals"][pos], found, pr0 + pr1 + pr2 + 3


# ---------------------------------------------------------------------------
# RS: RadixSpline — radix table over key prefix + spline with maxerr
# ---------------------------------------------------------------------------


def _greedy_spline(keys: np.ndarray, eps: int) -> list[int]:
    """GreedySplineCorridor knot selection (RadixSpline)."""
    n = len(keys)
    knots = [0]
    base = 0
    lo_sl, hi_sl = -math.inf, math.inf
    for i in range(1, n):
        dx = keys[i] - keys[base]
        if dx <= 0:
            continue
        lo_need = ((i - eps) - base) / dx
        hi_need = ((i + eps) - base) / dx
        if max(lo_sl, lo_need) > min(hi_sl, hi_need):
            knots.append(i - 1)
            base = i - 1
            dx = keys[i] - keys[base]
            lo_sl = ((i - eps) - base) / dx
            hi_sl = ((i + eps) - base) / dx
        else:
            lo_sl = max(lo_sl, lo_need)
            hi_sl = min(hi_sl, hi_need)
    if knots[-1] != n - 1:
        knots.append(n - 1)
    return knots


def _bucket(q: torch.Tensor, k0, k1, r: int) -> torch.Tensor:
    """`((q - k0) / (k1 - k0) * r).astype(int32)` clipped to [0, r): the
    numpy f64 scalars `k0`, `k1` make the reference compute it in f64,
    whatever the query's dtype."""
    x = (q.to(torch.float64) - float(k0)) / float(k1 - k0) * r
    return sat_i32(x).clamp(0, r - 1)


class RS:
    name = "RS"

    @staticmethod
    def build(keys, vals, eps: int = 32, radix_bits: int = 18):
        keys = np.asarray(keys, np.float64)
        n = len(keys)
        ki = np.array(_greedy_spline(keys, eps), np.int64)
        sp_key = keys[ki]
        sp_pos = ki.astype(np.float64)
        # verify the actual interpolant error on every key; store the measured
        # bound (greedy corridor subtleties make the theoretical bound loose)
        seg = np.clip(np.searchsorted(sp_key, keys, side="right") - 1,
                      0, len(ki) - 2)
        x0, x1 = sp_key[seg], sp_key[seg + 1]
        y0, y1 = sp_pos[seg], sp_pos[seg + 1]
        t = np.where(x1 > x0, (keys - x0) / np.maximum(x1 - x0, 1e-300), 0.0)
        pred = np.floor(y0 + t * (y1 - y0))
        bound = int(np.abs(pred - np.arange(n)).max()) + 1
        # radix table over normalized key space
        k0, k1 = keys[0], keys[-1]
        r = 1 << radix_bits
        norm = ((sp_key - k0) / max(k1 - k0, 1e-300) * r).astype(np.int64)
        table = np.searchsorted(norm, np.arange(r + 1), side="left")
        return dict(keys=keys, vals=np.asarray(vals, np.int64),
                    sp_key=sp_key, sp_pos=sp_pos, table=table,
                    k0=k0, k1=k1, radix_bits=radix_bits, eps=bound, n=n,
                    n_spline=len(sp_key))

    @staticmethod
    def device(st, dtype=torch.float64, device="cuda"):
        device = resolve_device(device)
        out = dict(st)
        for k in ("keys", "sp_key", "sp_pos"):
            out[k] = _t(st[k], dtype, device)
        out["table"] = _t(st["table"], torch.int32, device)
        out["vals"] = _t(st["vals"], torch.int32, device)
        return out

    @staticmethod
    def lookup(st, q):
        r = 1 << st["radix_bits"]
        bucket = _bucket(q, st["k0"], st["k1"], r)
        lo = st["table"][bucket.long()]
        hi = (st["table"][(bucket + 1).long()] + 1).clamp(
            max=st["n_spline"])
        p, pr0 = _binary_search(st["sp_key"], q, lo, hi, 12)
        p = p.clamp(1, st["n_spline"] - 1).long()
        # linear interpolation between spline points
        x0, x1 = st["sp_key"][p - 1], st["sp_key"][p]
        y0, y1 = st["sp_pos"][p - 1], st["sp_pos"][p]
        t = torch.where(x1 > x0, (q - x0) / (x1 - x0), 0.0)
        pred = _floor_i32(y0 + t * (y1 - y0))
        eps = st["eps"]
        lo = (pred - eps - 1).clamp(0, st["n"] - 1)
        hi = (pred + eps + 2).clamp(0, st["n"])
        itr = max(int(math.ceil(math.log2(2 * eps + 3))) + 1, 4)
        pos, pr1 = _binary_search(st["keys"], q, lo, hi, itr)
        pos = pos.clamp(0, st["n"] - 1).long()
        found = st["keys"][pos] == q
        return st["vals"][pos], found, pr0 + pr1 + 2


# ---------------------------------------------------------------------------
# LIPP: one kernelized model from the root; conflicts spawn child nodes.
# Reuses DILI's local-opt machinery with a single whole-range "leaf" root.
# ---------------------------------------------------------------------------


class LIPP:
    name = "LIPP"

    @staticmethod
    def build(keys, vals, gap: float = 1.25):
        keys = np.asarray(keys, np.float64)
        n = len(keys)
        pairs = [(float(keys[i]), int(vals[i])) for i in range(n)]
        root = Leaf(lb=float(keys[0]), ub=float(keys[-1]) + 1.0)
        a, b = least_squares(keys, np.arange(n, dtype=np.float64))
        root.a, root.b = a, b
        local_opt(root, pairs, eta=gap)

        class _Shim:            # minimal DILI-like shell for flatten()
            pass
        shim = _Shim()
        shim.root = root
        flat = flatten_dili(shim)   # type: ignore[arg-type]
        return dict(flat=flat)

    @staticmethod
    def device(st, dtype=torch.float64, device="cuda"):
        """The f64/i64 kernel tables (`kernel`) and the column tables
        (`cols`) of the flattened tree.  f64 only: the walk runs on the
        f64/i64 instance."""
        if dtype != torch.float64:
            raise ValueError(f"LIPP runs the f64/i64 lookup kernel; "
                             f"dtype {dtype} is not supported")
        device = resolve_device(device)
        return dict(kernel=K.kernel_arrays(st["flat"], device, torch.float64,
                                           torch.int64),
                    cols=S.device_arrays(st["flat"], torch.float64,
                                         device=device))

    @staticmethod
    def lookup(st, q):
        k = st["kernel"]
        # depth derives from the snapshot (resolve_max_depth), never a
        # hard-coded trip count
        v, f = dili_search_f64(k["node_rec"], k["slot_rec"], k["key"], q,
                               root=k["root"], max_depth=k["max_depth"])
        _, _, nodes, probes = S.search_batch(st["cols"], q, with_stats=True)
        return v, f, nodes + probes


# ---------------------------------------------------------------------------
# ALEX-lite: power-of-2 equal splits + gapped-array leaves + exp. search
# ---------------------------------------------------------------------------


class ALEX:
    name = "ALEX"

    @staticmethod
    def build(keys, vals, max_leaf: int = 4096, gap: float = 1.3):
        keys = np.asarray(keys, np.float64)
        vals = np.asarray(vals, np.int64)
        n = len(keys)
        lo_k, hi_k = keys[0], keys[-1] + max(1e-9, abs(keys[-1]) * 1e-12)
        # choose k so that average leaf size <= max_leaf (power-of-2 fanout)
        k = max(int(math.ceil(math.log2(max(n / max_leaf, 1)))), 1)
        fo = 1 << k
        edges = np.linspace(lo_k, hi_k, fo + 1)
        starts = np.searchsorted(keys, edges[:-1], side="left")
        ends = np.searchsorted(keys, edges[1:], side="left")
        # gapped leaves: spread each leaf's keys over gap*size slots by model
        leaf_base = []
        gk, gv, gt = [], [], []
        cursor = 0
        leaf_a, leaf_b, leaf_fo = [], [], []
        for i in range(fo):
            s, e = int(starts[i]), int(ends[i])
            m = e - s
            cap = max(int(math.ceil(m * gap)), 1)
            slot_k = np.full(cap, np.nan)
            slot_v = np.zeros(cap, np.int64)
            slot_t = np.zeros(cap, np.int8)
            if m > 0:
                a, b = least_squares(keys[s:e],
                                     np.arange(m, dtype=np.float64) * (cap / m))
                pos = np.clip(np.floor(a + b * keys[s:e]).astype(np.int64),
                              0, cap - 1)
                # monotonic gapped placement: keep sorted order, spread per
                # model, resolve collisions by pushing right then clamping
                # from the right edge (vectorized equivalent of ALEX's
                # gapped-array bulk placement)
                ar = np.arange(m)
                p = np.maximum.accumulate(pos - ar) + ar      # strictly incr.
                p = np.minimum(p, cap - m + ar)               # right-feasible
                slot_k[p] = keys[s:e]
                slot_v[p] = vals[s:e]
                slot_t[p] = 1
            else:
                a, b = 0.0, 0.0
            leaf_a.append(a)
            leaf_b.append(b)
            leaf_fo.append(cap)
            leaf_base.append(cursor)
            gk.append(slot_k)
            gv.append(slot_v)
            gt.append(slot_t)
            cursor += cap
        # sorted view for exponential search: backward-fill gaps with next key
        slot_k = np.concatenate(gk)
        slot_v = np.concatenate(gv)
        slot_t = np.concatenate(gt)
        filled = slot_k[::-1].copy()
        mask = ~np.isnan(filled)
        idxs = np.where(mask, np.arange(len(filled)), 0)
        idxs = np.maximum.accumulate(idxs)
        filled = np.where(np.isnan(filled[idxs]), np.inf, filled[idxs])[::-1]
        return dict(slot_key=filled, slot_raw=np.nan_to_num(slot_k, nan=np.inf),
                    slot_val=slot_v, slot_tag=slot_t,
                    leaf_a=np.array(leaf_a), leaf_b=np.array(leaf_b),
                    leaf_fo=np.array(leaf_fo, np.int32),
                    leaf_base=np.array(leaf_base, np.int32),
                    k0=lo_k, k1=hi_k, fo=fo, n=n, n_slots=cursor)

    @staticmethod
    def device(st, dtype=torch.float64, device="cuda"):
        device = resolve_device(device)
        out = dict(st)
        for k in ("slot_key", "slot_raw", "leaf_a", "leaf_b"):
            out[k] = _t(st[k], dtype, device)
        out["slot_val"] = _t(st["slot_val"], torch.int32, device)
        out["slot_tag"] = _t(st["slot_tag"], torch.int8, device)
        out["leaf_fo"] = _t(st["leaf_fo"], torch.int32, device)
        out["leaf_base"] = _t(st["leaf_base"], torch.int32, device)
        return out

    @staticmethod
    def lookup(st, q):
        fo = st["fo"]
        leaf = _bucket(q, st["k0"], st["k1"], fo).long()
        a = st["leaf_a"][leaf]
        b = st["leaf_b"][leaf]
        cap = st["leaf_fo"][leaf]
        base = st["leaf_base"][leaf]
        m1 = (cap - 1).clamp(min=0)
        pred = torch.minimum(_floor_i32(a + b * q).clamp(min=0), m1)
        keys = st["slot_key"]

        def key_at(i):
            return keys[(base + torch.minimum(i.clamp(min=0), m1)).long()]

        # gaps are backward-filled with the NEXT real key, so runs of equal
        # values end at the real slot: search the *upper bound* (first key
        # strictly greater than q) and probe the slot just before it.
        zi = _zero(q)
        probes = zi + 1
        going_up = key_at(pred) <= q

        bound, done = zi + 1, zi > 0
        for _ in range(18):
            up_i = torch.minimum((pred + bound).clamp(min=0), m1)
            dn_i = torch.minimum((pred - bound).clamp(min=0), m1)
            need_up = going_up & ~done & (key_at(up_i) <= q) & (pred + bound < m1)
            need_dn = ~going_up & ~done & (key_at(dn_i) > q) & (pred - bound > 0)
            probes = probes + (~done).to(torch.int32)
            done = done | ~(need_up | need_dn)
            bound = torch.where(done, bound, bound * 2)
        lo = torch.where(going_up, pred, (pred - bound).clamp(min=0))
        hi = torch.where(going_up, torch.minimum(pred + bound + 1, m1 + 1),
                         pred)

        for _ in range(18):
            mid = (lo + hi) // 2
            go = lo < hi
            below = key_at(mid) <= q
            lo = torch.where(go & below, mid + 1, lo)
            hi = torch.where(go & ~below, mid, hi)
            probes = probes + go.to(torch.int32)
        s = (base + torch.minimum((lo - 1).clamp(min=0), m1)).long()
        found = (st["slot_tag"][s] == 1) & (st["slot_raw"][s] == q)
        return st["slot_val"][s], found, probes


ALL_BASELINES = [BinS, BTree, RMI, PGM, RS, LIPP, ALEX]
