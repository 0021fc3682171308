"""Batched device-side DILI search as torch ops (port of
`repro/core/search.py`).

Level-synchronous traversal: a batch of Q queries advances together through
the unified node/slot tables (flat.py).  Each round costs one multiply,
one add, floor, clamp and a few gathers per query.  Dense (DILI-LO) leaves
exit the loop and run the paper's exponential search (Algorithm 1) as a
bounded vectorised probe sequence.

These functions are the CPU path of the port and the plain version its
kernel is held against, so they reproduce XLA's arithmetic exactly:

  * two roundings: `b*q` and `a + bq` are two eager ops (never `addcmul`,
    never `torch.compile`), matching construction's numpy arithmetic;
  * saturating float->int32: XLA saturates (+inf and 3e9 -> 2147483647,
    NaN -> 0) where `tensor.to(torch.int32)` wraps, so `sat_i32` clamps
    first.  Otherwise +inf pad lanes would land on slot 0;
  * one exception, the `fused` prediction: the reference's compiled XLA on
    the CPU contracts `a + b*q` into one fused multiply-add despite its
    optimization barrier (measured at f32 and f64 with jax 0.9).  Where
    construction placed the keys in the search's own precision its
    nudges off integer boundaries make both roundings agree, but the local
    engine at f32 searches f32 casts of f64-placed tables, and there the
    reference's answers are the FMA's.  A snapshot dict with
    `fused=True` (the f32/i64 kernel tables) predicts with `fma_f32`, a
    correctly rounded f32 FMA.

Every function takes the snapshot as a dict of tensors (see
`device_arrays`) with `max_depth` / `has_dense` as host statics, or an
`api.DeviceSnapshot` (duck-typed on `as_dict()`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from .flat import TAG_CHILD, TAG_EMPTY, TAG_PAIR, FlatDILI

INT32_MAX = 2147483647
INT32_MIN = -2147483648


def sat_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 with XLA's saturation: values >= 2^31 (and +inf)
    give INT32_MAX, values < -2^31 (and -inf) INT32_MIN, NaN 0; the rest
    truncate toward zero.  Exact in f32 and f64 (2^31 is a power of two)."""
    hi = x >= 2147483648.0
    lo = x < -2147483648.0
    safe = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
    out = safe.to(torch.int32)
    out = torch.where(hi, torch.full_like(out, INT32_MAX), out)
    return torch.where(lo, torch.full_like(out, INT32_MIN), out)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """a + b*q in f32 with ONE rounding (to nearest, ties to even), as
    CUDA's `__fmaf_rn(b, q, a)`.  The product of two f32 values is exact in
    f64; their sum `s` is rounded once there, with its exact error `e`
    (TwoSum), so that `s + e` is the exact result.  Rounding `s` to f32
    is then wrong only where `s` falls exactly halfway between two f32
    values and `e` pushes the exact result past that midpoint: those lanes
    take the neighbour on `e`'s side."""
    a64, p = a.double(), b.double() * q.double()
    s = a64 + p
    bb = s - a64
    e = (a64 - (s - bb)) + (p - bb)
    r = s.float()
    r64 = r.double()
    d = s - r64
    nb = torch.nextafter(r, torch.where(d > 0, math.inf, -math.inf).float())
    mid = (d != 0) & (s == (r64 + nb.double()) * 0.5)
    return torch.where(mid & (e != 0) & ((e > 0) == (d > 0)), nb, r)


def predict_slot(a, b, q, fo, fused: bool = False):
    """floor(a + b*q) clipped to [0, fo).

    Two IEEE roundings, as construction placed the keys (DESIGN.md
    section 7): the product and the sum are separate eager ops.  With
    `fused` (f32 only), one rounding: `fma_f32` (see the module
    docstring)."""
    if fused:
        s = fma_f32(a, b, q)
    else:
        bq = b * q
        s = a + bq
    return torch.minimum(torch.clamp(sat_i32(torch.floor(s)), min=0),
                         fo - 1)


def _pow2_len(n: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)


def _pad_pow2(x: np.ndarray, fill) -> np.ndarray:
    n = len(x)
    m = _pow2_len(n)
    if m == n:
        return x
    out = np.full(m, fill, dtype=x.dtype)
    out[:n] = x
    return out


def host_cast(x: np.ndarray, dtype) -> np.ndarray:
    """`x` cast in numpy to the numpy type of torch `dtype`, contiguous
    (round-to-nearest-even like the reference's upload)."""
    x = np.asarray(x).astype(torch.empty(0, dtype=dtype).numpy().dtype)
    return np.ascontiguousarray(x)


def _t(x: np.ndarray, dtype, device) -> torch.Tensor:
    """numpy -> tensor of `dtype` on `device` (the cast happens in numpy,
    `host_cast`)."""
    shape = np.shape(x)     # `ascontiguousarray` makes a 0-d array 1-d
    return torch.from_numpy(host_cast(x, dtype)).reshape(shape).to(device)


def device_arrays(flat: FlatDILI, dtype=torch.float64, pad: bool = True,
                  device="cuda") -> dict:
    """Upload the snapshot to `device` (CUDA unless asked otherwise); pads
    table lengths to powers of two, with the reference's fills.

    Besides the column tables, the traversal reads two row-packed mirrors:
    `node_pack` [n_nodes, 4] = (a, b, base, fo*±1 with the sign carrying the
    dense flag) and `slot_pack` [n_slots, 2] = (key, tag).  base/fo must be
    exact in the float mantissa, so a narrow dtype on a table of 2^24 slots
    or more keeps the column layout only (the reference's guard)."""
    device = resolve_device(device)
    f = flat
    conv = (lambda x, fill: _pad_pow2(x, fill)) if pad else (lambda x, fill: x)
    av = conv(np.asarray(f.a), 0.0)
    bv = conv(np.asarray(f.b), 0.0)
    basev = conv(f.base, 0)
    fov = conv(f.fo, 1)
    densev = conv(f.dense, 0)
    tagv = conv(f.tag, TAG_EMPTY)
    keyv = conv(f.key, 0.0)
    out = dict(
        a=_t(av, dtype, device),
        b=_t(bv, dtype, device),
        base=_t(basev, torch.int32, device),
        fo=_t(fov, torch.int32, device),
        dense=_t(densev, torch.int8, device),
        tag=_t(tagv, torch.int8, device),
        key=_t(keyv, dtype, device),
        val=_t(conv(f.val, -1), torch.int64, device),
        **pair_arrays(flat, dtype, pad=pad, device=device),
        root=torch.tensor(int(f.root), dtype=torch.int32, device=device),
        max_depth=int(f.max_depth),
        has_dense=bool(np.asarray(f.dense).any()),
    )
    if _packs(dtype, len(tagv)):
        out["node_pack"] = _t(np.stack(
            [av, bv, basev.astype(np.float64),
             (fov * np.where(densev > 0, -1, 1)).astype(np.float64)],
            axis=1), dtype, device)
        out["slot_pack"] = _t(
            np.stack([keyv, tagv.astype(np.float64)], axis=1), dtype, device)
    return out


def _packs(dtype, n_slots: int) -> bool:
    """Whether `device_arrays` adds the packed row mirrors."""
    return torch.finfo(dtype).eps <= 2.0 ** -52 or n_slots < (1 << 24)


def pair_arrays(flat: FlatDILI, dtype=torch.float64, pad: bool = True,
                device="cuda") -> dict:
    """Only the sorted pair table of `device_arrays` (`pair_key`,
    `pair_val`, padded alike): all that `range_query_batch` reads."""
    device = resolve_device(device)
    conv = _pad_pow2 if pad else (lambda x, fill: x)
    return dict(pair_key=_t(conv(flat.pair_key, np.inf), dtype, device),
                pair_val=_t(conv(flat.pair_val, -1), torch.int64, device))


def device_layout(flat: FlatDILI, dtype=torch.float64,
                  pad: bool = True) -> dict:
    """{name: (shape, dtype)} of the tensors `device_arrays` would give,
    built and uploaded without: n nodes, m slots and p pairs, each padded
    to a power of two when `pad`."""
    size = _pow2_len if pad else (lambda n: n)
    n, m, p = (size(len(x)) for x in (flat.a, flat.tag, flat.pair_key))
    out = dict(a=((n,), dtype), b=((n,), dtype), base=((n,), torch.int32),
               fo=((n,), torch.int32), dense=((n,), torch.int8),
               tag=((m,), torch.int8), key=((m,), dtype),
               val=((m,), torch.int64), pair_key=((p,), dtype),
               pair_val=((p,), torch.int64), root=((), torch.int32))
    if _packs(dtype, m):
        out.update(node_pack=((n, 4), dtype), slot_pack=((m, 2), dtype))
    return out


def layout_nbytes(layout: dict) -> int:
    """Device bytes of a `device_layout`: `DeviceSnapshot.nbytes` of the
    snapshot it describes."""
    return sum(math.prod(shape) * dtype.itemsize
               for shape, dtype in layout.values())


def as_snapshot_dict(idx) -> dict:
    """Accept either the raw snapshot dict or an `api.DeviceSnapshot`."""
    if isinstance(idx, dict):
        return idx
    return idx.as_dict()


def resolve_max_depth(idx) -> int:
    """The snapshot's true traversal depth (DESIGN.md section 9: trip
    counts come from the snapshot, never a constant)."""
    return int(as_snapshot_dict(idx)["max_depth"])


# ---------------------------------------------------------------------------
# Unified traversal (Algorithm 6 batched)
# ---------------------------------------------------------------------------


def _traverse_step(idx: dict, q, state, with_stats: bool):
    """One level of the unified traversal; shared by the fixed-trip loop
    and the convergence early exit."""
    if with_stats:
        n, done, val, found, nodes, probes = state
    else:
        n, done, val, found = state
    ni = n.long()
    if "node_pack" in idx:
        npk = idx["node_pack"][ni]                  # [Q, 4]
        a = npk[..., 0]
        b = npk[..., 1]
        base = npk[..., 2].to(torch.int32)
        fo_s = npk[..., 3].to(torch.int32)
        is_dense = fo_s < 0
        fo = torch.where(is_dense, -fo_s, fo_s)
        pos = predict_slot(a, b, q, fo, idx.get("fused", False))
        s = (base + pos).long()
        spk = idx["slot_pack"][s]                   # [Q, 2]
        sk = spk[..., 0]
        t = spk[..., 1].to(torch.int8)
    else:
        a = idx["a"][ni]
        b = idx["b"][ni]
        fo = idx["fo"][ni]
        is_dense = idx["dense"][ni] > 0
        pos = predict_slot(a, b, q, fo, idx.get("fused", False))
        s = (idx["base"][ni] + pos).long()
        t = idx["tag"][s]
        sk = idx["key"][s]
    sv = idx["val"][s]
    step_active = ~done & ~is_dense
    is_child = (t == TAG_CHILD) & step_active
    hit = (t == TAG_PAIR) & (sk == q) & step_active
    miss = ((t == TAG_EMPTY) | ((t == TAG_PAIR) & (sk != q))) & step_active
    val = torch.where(hit, sv, val)
    found = found | hit
    n = torch.where(is_child, sv.to(torch.int32), n)
    done = done | hit | miss | (is_dense & ~done)
    if with_stats:
        nodes = nodes + step_active.to(torch.int32)
        probes = probes + step_active.to(torch.int32)
        return (n, done, val, found, nodes, probes)
    return (n, done, val, found)


def _search_batch(idx: dict, q: torch.Tensor, max_depth: int,
                  with_stats: bool = False, early_exit: bool = False,
                  has_dense: bool = True):
    zi = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    zb = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    n0 = zi + idx["root"]
    state = (n0, zb, (zi - 1).to(idx["val"].dtype), zb)
    if with_stats:
        state = state + (zi, zi)

    for _ in range(max_depth):
        # early exit: the whole batch stops once every lane is done, so a
        # batch bottoming out at height h pays h rounds, not max_depth
        if early_exit and bool(state[1].all()):
            break
        state = _traverse_step(idx, q, state, with_stats)

    if with_stats:
        n, done, val, found, nodes, probes = state
    else:
        n, done, val, found = state

    if not has_dense:
        if with_stats:
            return val, found, nodes, probes
        return val, found

    # dense-leaf exit: exponential + binary search (Algorithm 1 lines 2-5)
    is_dense = idx["dense"][n.long()] > 0
    dval, dfound, dprobes = _dense_search(idx, q, n)
    val = torch.where(is_dense & dfound, dval, val)
    found = found | (is_dense & dfound)
    if with_stats:
        nodes = nodes + is_dense.to(torch.int32)
        probes = probes + torch.where(is_dense, dprobes,
                                      torch.zeros_like(dprobes))
        return val, found, nodes, probes
    return val, found


def search_batch(idx, queries: torch.Tensor, max_depth: int | None = None,
                 with_stats: bool = False, early_exit: bool = False):
    """Point lookups.  Returns (values, found) — values only valid where
    found.  `max_depth=None` derives the trip count from the snapshot;
    `early_exit=True` stops the batch once every lane is done (bit-identical
    results); `with_stats` also returns per-query (nodes_visited,
    slot_probes).  A snapshot without `has_dense` runs the dense probe;
    one with `fused=True` predicts with one rounding (module docstring)."""
    idx = as_snapshot_dict(idx)
    if max_depth is None:
        max_depth = resolve_max_depth(idx)
    has_dense = idx.get("has_dense", True)
    return _search_batch(idx, queries, max_depth=int(max_depth),
                         with_stats=with_stats, early_exit=early_exit,
                         has_dense=bool(has_dense))


def _dense_search(idx: dict, q: torch.Tensor, n: torch.Tensor):
    """Vectorised exponential search around the model prediction inside a
    dense leaf [base, base+fo).  Fixed trip counts (16 doubling + 16
    binary halving), as in the reference."""
    ni = n.long()
    a = idx["a"][ni]
    b = idx["b"][ni]
    fo = idx["fo"][ni]
    base = idx["base"][ni]
    m1 = torch.clamp(fo - 1, min=0)
    pred = torch.minimum(torch.clamp(
        predict_slot(a, b, q, fo, idx.get("fused", False)), min=0), m1)

    def clip(i):
        return torch.minimum(torch.clamp(i, min=0), m1)

    def key_at(i):
        return idx["key"][(base + clip(i)).long()]

    kp = key_at(pred)
    zi = torch.zeros_like(pred)
    probes = zi + 1

    # --- exponential phase: grow a distance bound B until it brackets q ----
    going_up = kp < q
    bound = zi + 1
    done = torch.zeros_like(going_up)
    for _ in range(16):
        up_i = clip(pred + bound)
        dn_i = clip(pred - bound)
        need_up = going_up & ~done & (key_at(up_i) < q) & (pred + bound < m1)
        need_dn = ~going_up & ~done & (key_at(dn_i) > q) & (pred - bound > 0)
        probes = probes + (~done).to(torch.int32)
        done = done | ~(need_up | need_dn)
        bound = torch.where(done, bound, bound * 2)

    # bracket [lo, hi] guaranteed to contain the lower bound of q
    lo = torch.where(going_up, pred, torch.clamp(pred - bound, min=0))
    hi = torch.where(going_up, torch.minimum(pred + bound, m1), pred)

    # --- binary phase: first index with key >= q ---------------------------
    for _ in range(16):
        mid = (lo + hi) // 2
        go = lo < hi
        below = key_at(mid) < q
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid, hi)
        probes = probes + go.to(torch.int32)

    s = (base + clip(lo)).long()
    ok = (idx["tag"][s] == TAG_PAIR) & (idx["key"][s] == q)
    return idx["val"][s], ok, probes


# ---------------------------------------------------------------------------
# Overlay resolution
# ---------------------------------------------------------------------------


def overlay_lookup(ov: dict, queries: torch.Tensor):
    i = torch.clamp(torch.searchsorted(ov["keys"], queries), 0,
                    len(ov["keys"]) - 1)
    return ov["vals"][i], ov["keys"][i] == queries


def resolve_overlay(ov: dict, queries: torch.Tensor, snap_vals: torch.Tensor,
                    snap_found: torch.Tensor):
    """Fuse overlay state over snapshot results: an overlay hit wins, and an
    overlay tombstone (``ov["tomb"][i] != 0``) hides a snapshot hit."""
    i = torch.clamp(torch.searchsorted(ov["keys"], queries), 0,
                    len(ov["keys"]) - 1)
    hit = ov["keys"][i] == queries
    tomb = ov.get("tomb")
    dead = hit & (tomb[i] > 0) if tomb is not None else hit & False
    live = hit & ~dead
    vals = ov["vals"][i]
    val = torch.where(live, vals, snap_vals.to(vals.dtype))
    return val, live | (snap_found & ~dead)


def search_with_overlay(idx, ov: dict, queries: torch.Tensor,
                        max_depth: int | None = None, *,
                        early_exit: bool = True):
    """Snapshot traversal, then the overlay resolved over its result: the
    plain counterpart of the reference's fused `search_with_overlay`
    (overlay hit wins, tombstone hides a snapshot hit).  The local
    engine's lookups run the f64 kernel instance, which computes the same
    function (`kernels.ops.search_with_overlay`); this one composes the
    torch ops over a `DeviceSnapshot`."""
    v, f = search_batch(idx, queries, max_depth=max_depth,
                        early_exit=early_exit)
    return resolve_overlay(ov, queries, v, f)


# ---------------------------------------------------------------------------
# Range query: bisect the sorted pair table, gather one bounded window
# ---------------------------------------------------------------------------


def range_query_batch(idx, lo: torch.Tensor, hi: torch.Tensor,
                      max_hits: int = 128):
    """For each (lo, hi): the first max_hits pair (key, val)s in [lo, hi),
    ascending, plus the count (saturating at max_hits).  Two searchsorted
    bisections of the key-sorted pair table locate the window, then one
    bounded gather reads it — O(log n + max_hits) per query."""
    idx = as_snapshot_dict(idx)
    pk = idx["pair_key"]
    start = torch.searchsorted(pk, lo, side="left")          # [Q]
    end = torch.searchsorted(pk, hi, side="left")            # [Q]
    cnt = torch.clamp(end - start, min=0)
    offs = torch.arange(max_hits, device=pk.device)          # [H]
    valid = offs[None, :] < cnt[:, None]                     # [Q, H]
    g = torch.clamp(start[:, None] + offs[None, :], 0, pk.shape[0] - 1)
    ks = torch.where(valid, pk[g], math.inf)
    vs = torch.where(valid, idx["pair_val"][g], -1)
    return ks, vs, torch.clamp(cnt, max=max_hits).to(torch.int32)
