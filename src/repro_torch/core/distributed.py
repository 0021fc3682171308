"""Range-partitioned DILI with its shards on one device (port of
`repro/core/distributed.py`).

The paper's equal-division trick (Eq. 1) *is* the router: partition
boundaries are chosen from key quantiles, and a query's shard comes from a
searchsorted over the (tiny) boundary array — one more "internal node"
whose children are whole trees.

The reference places one shard per device of a `jax` mesh and runs its
lookups inside `shard_map` with collectives.  Here every shard lives on
the same card, so the collectives become gathers and scatters on that
card, and each shard's search is one launch of the lookup kernel's
f64/i64 instance (f32/i64 at `dtype=float32`, which predicts with one
FMA, as the reference's XLA does inside `shard_map` too) with the
combined overlay resolved in the same launch, in place of the reference's
XLA `search_batch` + `resolve_overlay` in each shard's body:

  * ``gather`` (default, always exact): a lane belongs to shard r exactly
    when ``boundaries[r] <= q < boundaries[r+1]``.  The lanes are grouped
    by owner (a stable sort), each shard's kernel launch searches only
    its own lanes, and the results are scattered back; a lane no shard
    owns (+inf, NaN) comes back (0, False), as the reference's masked
    `psum_scatter` gives.  The reference's per-shard search of the whole
    batch gives the same answers at S times the lanes.
  * ``a2a`` (capacity-bounded): the reference's per-source bucketing,
    emulated exactly — source s owns lanes [s*qn, (s+1)*qn), buckets of
    `cap = 2*ceil(qn/S)` lanes per (source, destination) pair filled in
    the order of a stable sort by destination (jax's `argsort` is
    stable), overflowed lanes back as misses and counted per source, and
    one launch per destination over its `S*cap` received lanes.  As in
    the reference, an overflowed bucket's last slot is overwritten with
    +inf (its scatter writes the overflowed lanes there, last one wins).

Shard snapshots are padded to identical pow2 shapes, as the reference's
host stack is.  The device holds each shard's kernel records
(`kernels.ops.kernel_arrays` of its flat), the stacked pair tables for
ranges (`_stack_pairs`, the only stacked columns it reads) and the
boundaries; `column_bytes` gives the bytes of the reference's stacked
column upload, the engine's `device_bytes`, from the padded shapes.

Online updates (DESIGN.md section 8): each shard owns a private tombstone
overlay absorbing the writes routed to its key range (`shard_of`).  A
merge folds ONE shard's overlay through that shard's host DILI (Alg. 7/8),
re-flattens only that shard, and rewrites its rows of the stacked pair
tables; `to_device(..., prev=, shards=)` then re-packs only the merged
shards' kernel records.  Reads between merges resolve the (globally
sorted, because shard ranges are disjoint) combined overlay on top of the
sharded snapshot lookup.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as K
from ..kernels.dili_search import overlay_filter
from .bu_tree import CostModel, DEFAULT_COST
from .dili import bulk_load
from .flat import FlatDILI, flatten


@dataclass
class ShardedDILI:
    idx: dict              # stacked pair tables, leading dim = shard
    boundaries: np.ndarray  # [R+1] range boundaries (replicated)
    n_shards: int
    max_depth: int
    has_dense: bool = True  # any shard has dense (DILI-LO) leaves
    # pow2-padded node and slot counts of the reference's stacked columns
    n_nodes: int = 0
    n_slots: int = 0
    # online-update state (None when built with keep_host=False)
    flats: list | None = None      # per-shard FlatDILI (current epoch)
    dilis: list | None = None      # per-shard host DILI writers
    overlays: list | None = None   # per-shard TombstoneOverlay
    epoch: int = 0
    # device mirror of the combined overlay per (dtype, device): the
    # overlay objects it was built from and the mirror
    _ov_cache: dict = field(default_factory=dict, repr=False)


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def _pow2(n: int) -> int:
    return 1 << max(1, math.ceil(math.log2(max(n, 1))))


def _stack_pairs(flats: list[FlatDILI]) -> dict:
    """The key-sorted pair tables of every shard (range queries), padded to
    one pow2 length; +inf pads keep the searchsorted window inside the
    populated prefix.  int64 payloads end-to-end."""
    n_pairs = _pow2(max(f.n_pairs for f in flats))
    return dict(
        pair_key=np.stack([_pad_to(f.pair_key, n_pairs, np.inf)
                           for f in flats]),
        pair_val=np.stack([_pad_to(f.pair_val, n_pairs, -1) for f in flats]))


def _restack(sd: "ShardedDILI") -> None:
    """Re-pad every shard to the current flats' pow2 shapes."""
    sd.idx = _stack_pairs(sd.flats)
    sd.n_nodes = _pow2(max(f.n_nodes for f in sd.flats))
    sd.n_slots = _pow2(max(f.n_slots for f in sd.flats))


def build_sharded(keys: np.ndarray, vals: np.ndarray | None, n_shards: int,
                  cm: CostModel = DEFAULT_COST, sample_stride: int = 1,
                  keep_host: bool = True, overlay_cap: int = 4096,
                  **kw) -> ShardedDILI:
    from ..online.overlay import TombstoneOverlay
    keys = np.asarray(keys, np.float64)
    n = len(keys)
    if vals is None:
        vals = np.arange(n, dtype=np.int64)
    # quantile partitioning: equal #keys per shard (balanced memory/work)
    cuts = [0] + [round(n * (i + 1) / n_shards) for i in range(n_shards)]
    flats: list[FlatDILI] = []
    dilis: list = []
    for r in range(n_shards):
        lo, hi = cuts[r], cuts[r + 1]
        d = bulk_load(keys[lo:hi], vals[lo:hi], cm=cm,
                      sample_stride=sample_stride, **kw)
        dilis.append(d)
        flats.append(flatten(d))
    boundaries = np.concatenate([[ -np.inf ],
                                 [keys[cuts[r]] for r in range(1, n_shards)],
                                 [np.inf]])
    # depth-exact: the deepest shard's true height IS the trip count (padding
    # never deepens a tree, and off-range queries miss before going deeper)
    max_depth = max(f.max_depth for f in flats)
    sd = ShardedDILI(idx={}, boundaries=boundaries, n_shards=n_shards,
                     max_depth=max_depth,
                     has_dense=any(bool(f.dense.any()) for f in flats),
                     flats=flats)
    _restack(sd)
    if keep_host:
        sd.dilis = dilis
        sd.overlays = [TombstoneOverlay.empty(overlay_cap)
                       for _ in range(n_shards)]
    else:
        sd.flats = None
    return sd


# ---------------------------------------------------------------------------
# Device copy
# ---------------------------------------------------------------------------


_NP_KEY = {torch.float32: np.float32, torch.float64: np.float64}


def column_bytes(sd: ShardedDILI, dtype=torch.float64) -> int:
    """Bytes of the reference's device copy (`to_mesh`): every stacked
    column at its padded shape, the f64 ones (a, b, key, pair_key) at the
    key `dtype`, plus the roots and the boundaries."""
    w = dtype.itemsize
    node = 2 * w + 4 + 4 + 1             # a, b; base, fo int32; dense int8
    slot = 1 + w + 8                     # tag int8, key, val int64
    pair = w + 8                         # pair_key, pair_val int64
    n_pairs = sd.idx["pair_key"].shape[1]
    return (sd.n_shards * (sd.n_nodes * node + sd.n_slots * slot
                           + n_pairs * pair + 4)
            + (sd.n_shards + 1) * w)


def to_device(sd: ShardedDILI, device="cuda", dtype=torch.float64,
              prev: dict | None = None,
              shards: list[int] | None = None) -> dict:
    """The shards' device copy on `device` (CUDA unless asked otherwise),
    keys of `dtype`: per-shard kernel records with i64 payloads
    (`kernel`, packed from each shard's flat, so the stack must keep its
    host state: keep_host=True), the stacked pair tables `pair_key` [S, P] and
    `pair_val` [S, P], the `boundaries` [S+1], and the statics
    `max_depth` and `n_shards`.

    With `prev` (the copy before a merge) and `shards` (the merged ones),
    only those shards' kernel records are re-packed; the pair tables are
    uploaded whole, as the reference's republish does.  A new dict is
    returned either way, so a reader holding `prev` is never changed."""
    _require_host(sd)
    device = resolve_device(device)
    kdt = _NP_KEY[dtype]
    if prev is None or len(prev["kernel"]) != sd.n_shards or shards is None:
        kernel, shards = [None] * sd.n_shards, range(sd.n_shards)
    else:
        kernel = list(prev["kernel"])
    for r in shards:
        kernel[r] = K.kernel_arrays(sd.flats[r], device=device, dtype=dtype,
                                    val_dtype=torch.int64)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return dict(kernel=kernel,
                pair_key=t(sd.idx["pair_key"].astype(kdt)),
                pair_val=t(sd.idx["pair_val"].astype(np.int64)),
                boundaries=t(sd.boundaries.astype(kdt)),
                max_depth=int(sd.max_depth), n_shards=sd.n_shards)


def _empty_overlay(dtype, device) -> dict:
    """The reference's no-op overlay (one +inf key): a +inf query meets it
    and comes back found with val 0, as it does in the reference."""
    return dict(keys=torch.full((1,), math.inf, dtype=dtype, device=device),
                vals=torch.zeros(1, dtype=torch.int64, device=device),
                tomb=torch.zeros(1, dtype=torch.int8, device=device))


def _search_shard(arrs: dict, r: int, q: torch.Tensor, ov: dict,
                  stats: dict | None):
    """One launch of the kernel over shard r's tables for the lanes `q`,
    with the overlay `ov` resolved, at the stack's trip count."""
    tables = dict(arrs["kernel"][r], max_depth=arrs["max_depth"])
    if stats is not None:
        stats["launches"] = stats.get("launches", 0) + 1
    return K.search_with_overlay(tables, ov, q.contiguous(), stats=stats)


def _owners(bnd: torch.Tensor, q: torch.Tensor, n_shards: int):
    """Per lane, the shard r with bnd[r] <= q < bnd[r+1], or `n_shards`
    where none holds (the reference's gather mask, literally)."""
    own = (q[None, :] >= bnd[:-1, None]) & (q[None, :] < bnd[1:, None])
    r = torch.arange(n_shards, device=q.device)[:, None]
    return torch.where(own, r, n_shards).amin(0)


def sharded_lookup(sd_arrays: dict, queries: torch.Tensor,
                   strategy: str = "gather", overlay: dict | None = None,
                   stats: dict | None = None):
    """Batched lookup over every shard: (vals i64, found bool) on the
    gather strategy, and (vals, found, overflow [S] int32) on a2a, whose
    batch length must be a multiple of the shard count.  `overlay` (the
    combined overlay mirror, `combined_overlay_arrays`) is resolved in
    each shard's launch; without one, the reference's one-key +inf
    overlay.  With `stats`, counts `launches` and `lanes` there."""
    n = sd_arrays["n_shards"]
    bnd = sd_arrays["boundaries"]
    q = queries
    ov = overlay if overlay is not None else _empty_overlay(q.dtype,
                                                             q.device)
    if strategy == "gather":
        owner = _owners(bnd, q, n)
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=n + 1).tolist()
        qs = q[order]
        vs = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
        fs = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
        off = 0
        for r in range(n):
            c = counts[r]
            if c:
                v, f = _search_shard(sd_arrays, r, qs[off: off + c], ov,
                                     stats)
                vs[off: off + c] = torch.where(f, v, 0)
                fs[off: off + c] = f
            off += c
        v_out = torch.empty_like(vs).index_copy_(0, order, vs)
        f_out = torch.empty_like(fs).index_copy_(0, order, fs)
        return v_out, f_out

    elif strategy == "a2a":
        nq = q.shape[0]
        if nq % n:
            raise ValueError(f"a2a needs a batch that is a multiple of the "
                             f"{n} shards, got {nq}")
        qn = nq // n                               # per-source query count
        cap = int(2 * math.ceil(qn / n))           # capacity slack 2x
        dev = q.device
        dest = torch.clamp(torch.searchsorted(bnd, q, right=True) - 1,
                           0, n - 1)
        src = torch.arange(nq, device=dev) // max(qn, 1)
        # per source, the stable order by destination (sources stay apart)
        bucket = src * n + dest
        order = torch.argsort(bucket, stable=True)
        b_sorted = bucket[order]
        counts = torch.bincount(bucket, minlength=n * n)
        starts = torch.cumsum(counts, 0) - counts
        within = torch.arange(nq, device=dev) - starts[b_sorted]
        ok = within < cap
        s_sorted, d_sorted = b_sorted // n, b_sorted % n
        slot = torch.clamp(within, 0, max(cap - 1, 0))
        # overflowed lanes go to a spare slot past the bucket's end, so
        # every write lands in a place of its own
        buckets = torch.full((n, n, cap + 1), math.inf, dtype=q.dtype,
                             device=dev)
        buckets[s_sorted, d_sorted, torch.where(ok, within, cap)] = q[order]
        buckets = buckets[..., :cap]
        if cap:
            # the reference scatters overflowed lanes' +inf onto the last
            # slot of their bucket (in order, so the last write wins)
            full = (counts > cap).view(n, n)
            buckets[..., cap - 1] = torch.where(
                full, math.inf, buckets[..., cap - 1])
        res_v = torch.empty((n, n, cap), dtype=torch.int64, device=dev)
        res_f = torch.empty((n, n, cap), dtype=torch.bool, device=dev)
        for d in range(n):                         # one launch a shard
            recv = buckets[:, d, :].reshape(-1)    # [S*cap]
            v, f = _search_shard(sd_arrays, d, recv, ov, stats)
            res_v[:, d, :] = v.view(n, cap)
            res_f[:, d, :] = f.view(n, cap)
        vs = res_v[s_sorted, d_sorted, slot]
        fs = res_f[s_sorted, d_sorted, slot] & ok
        v_out = torch.empty_like(vs).index_copy_(0, order, vs)
        f_out = torch.empty_like(fs).index_copy_(0, order, fs)
        overflow = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, s_sorted, (~ok).to(torch.int32))
        return v_out, f_out, overflow
    raise ValueError(strategy)


def sharded_range_query(sd_arrays: dict, lo: torch.Tensor, hi: torch.Tensor,
                        max_hits: int = 128):
    """Range queries over every shard: for each (lo, hi) the first
    `max_hits` pairs in [lo, hi) ascending plus the count (saturating).

    Each shard bisects ITS key-sorted pair table over the window clipped
    to its own key range — O(log n_shard + max_hits) per query per shard
    — then places its run at the offset given by the exclusive prefix of
    per-shard counts (shard ranges are disjoint and ordered, so
    shard-order concatenation IS key order).  The runs are summed into one
    answer as the reference's `psum_scatter` does: exactly one shard owns
    each (query, position)."""
    pk, pv = sd_arrays["pair_key"], sd_arrays["pair_val"]
    bnd = sd_arrays["boundaries"]
    n, n_pairs = pk.shape
    # clip every window to each shard's key range: [S, Q]
    slo = torch.maximum(lo[None, :], bnd[:-1, None])
    shi = torch.maximum(torch.minimum(hi[None, :], bnd[1:, None]), slo)
    start = torch.searchsorted(pk, slo.contiguous(), side="left")
    cnt = torch.searchsorted(pk, shi.contiguous(), side="left") - start
    before = torch.cumsum(cnt, 0) - cnt        # exclusive prefix per query
    posn = torch.arange(max_hits, device=pk.device)[None, :]       # [1, H]
    ks = torch.zeros((lo.shape[0], max_hits), dtype=pk.dtype,
                     device=pk.device)
    vs = torch.zeros((lo.shape[0], max_hits), dtype=pv.dtype,
                     device=pk.device)
    for r in range(n):
        rel = posn - before[r][:, None]                            # [Q, H]
        mine = (rel >= 0) & (rel < cnt[r][:, None])
        g = torch.clamp(start[r][:, None] + rel, 0, n_pairs - 1)
        ks = ks + torch.where(mine, pk[r][g], 0.0)
        vs = vs + torch.where(mine, pv[r][g], 0)
    total = cnt.sum(0)
    filled = posn < torch.clamp(total, max=max_hits)[:, None]
    ks = torch.where(filled, ks, math.inf)
    vs = torch.where(filled, vs, -1)
    return ks, vs, torch.clamp(total, max=max_hits).to(torch.int32)


# ---------------------------------------------------------------------------
# Online updates: per-shard overlays, single-shard merge, fused read path
# ---------------------------------------------------------------------------


def shard_of(sd: ShardedDILI, keys: np.ndarray) -> np.ndarray:
    """Route keys to shards: the boundary array is the root 'internal node'."""
    return np.clip(np.searchsorted(sd.boundaries, keys, side="right") - 1,
                   0, sd.n_shards - 1)


def _require_host(sd: ShardedDILI) -> None:
    if sd.overlays is None:
        raise ValueError("build_sharded(..., keep_host=True) required for "
                         "online updates")


def sharded_upsert(sd: ShardedDILI, keys, vals) -> None:
    _require_host(sd)
    keys = np.atleast_1d(np.asarray(keys, np.float64))
    vals = np.atleast_1d(np.asarray(vals, np.int64))
    dest = shard_of(sd, keys)
    for r in np.unique(dest):
        m = dest == r
        sd.overlays[r] = sd.overlays[r].upsert_batch(keys[m], vals[m])


def sharded_delete(sd: ShardedDILI, keys) -> None:
    _require_host(sd)
    keys = np.atleast_1d(np.asarray(keys, np.float64))
    dest = shard_of(sd, keys)
    for r in np.unique(dest):
        m = dest == r
        sd.overlays[r] = sd.overlays[r].delete_batch(keys[m])


def sharded_merge(sd: ShardedDILI, max_fill: float = 0.0,
                  fold_fn=None, flatten_fn=None) -> list[int]:
    """Fold each shard whose overlay full_fraction exceeds `max_fill` through
    its host DILI (Alg. 7/8), re-flatten ONLY those shards, and rewrite their
    rows of the stacked tables in place.  The stack is re-padded (bigger pow2)
    only when a merged shard outgrows the shared shape.  Returns merged shard
    ids; bumps `sd.epoch` when any merged.

    `fold_fn(r, dili, overlay)` / `flatten_fn(r, dili) -> FlatDILI` override
    the per-shard fold and flatten — the maintenance hooks the sharded
    engine uses to route through accounting/retrains and the incremental
    flattener (defaults: plain `fold_overlay` / full `flatten`).

    NOTE: only the HOST stack (`sd.idx`) is rewritten, and the merged
    overlays are replaced by empty ones (the old overlay objects are left
    as they were, so a reader holding them with the old device copy still
    sees the folded writes) — device copies from a prior `to_device()` no
    longer see the folded writes.  Callers must republish
    (`to_device(sd, ..., prev=, shards=merged)`) before serving lookups
    whenever this returns a non-empty list."""
    from ..online.overlay import TombstoneOverlay, fold_overlay
    _require_host(sd)
    if fold_fn is None:
        fold_fn = lambda r, d, ov: fold_overlay(d, ov)   # noqa: E731
    if flatten_fn is None:
        # drain the dirty-id set a full flatten supersedes (it would
        # otherwise grow for the lifetime of a maintenance-less shard)
        def flatten_fn(r, d):
            f = flatten(d)
            d.take_dirty()
            return f
    merged: list[int] = []
    for r, ov in enumerate(sd.overlays):
        if ov.count == 0 or ov.full_fraction < max_fill:
            continue
        fold_fn(r, sd.dilis[r], ov)
        sd.flats[r] = flatten_fn(r, sd.dilis[r])
        sd.overlays[r] = TombstoneOverlay.empty(ov.cap)
        merged.append(r)
    if not merged:
        return merged
    n_pairs = sd.idx["pair_key"].shape[1]
    if any(sd.flats[r].n_nodes > sd.n_nodes or sd.flats[r].n_slots > sd.n_slots
           or sd.flats[r].n_pairs > n_pairs for r in merged):
        _restack(sd)                         # grow: re-pad every shard
    else:
        for r in merged:                     # steady state: row rewrite only
            f = sd.flats[r]
            sd.idx["pair_key"][r] = _pad_to(f.pair_key, n_pairs, np.inf)
            sd.idx["pair_val"][r] = _pad_to(f.pair_val, n_pairs, -1)
    sd.max_depth = max(f.max_depth for f in sd.flats)
    sd.has_dense = any(bool(f.dense.any()) for f in sd.flats)
    sd.epoch += 1
    return merged


def combined_overlay_arrays(sd: ShardedDILI, dtype=torch.float64,
                            device="cuda", overlays=None) -> dict:
    """One globally sorted overlay view on `device`: shard key ranges are
    disjoint, so concatenating per-shard populated prefixes in shard order
    IS sorted.  Carries the membership "filter" the kernel reads
    (`kernels.dili_search.overlay_filter`), as the local engine's mirror
    does.  `overlays` (default: the stack's current ones) are per-shard
    overlay objects, which writes and merges replace and never change, so
    the mirror is cached per (dtype, device) for the objects it was built
    from: a write or merge invalidates it."""
    _require_host(sd)
    ovs = tuple(sd.overlays if overlays is None else overlays)
    device = resolve_device(device)
    ckey = (str(dtype), str(device))
    hit = sd._ov_cache.get(ckey)
    if hit is not None and len(hit[0]) == len(ovs) \
            and all(a is b for a, b in zip(hit[0], ovs)):
        return hit[1]
    ks, vs, tb = overlay_entries(ovs)
    # pad to (at least) the summed per-shard capacities, not the populated
    # count: caps start at the configured overlay_cap and only grow by
    # doubling, so the mirror keeps ONE shape from idle through
    # write-heavy periods, as the local engine's cap-sized mirror does
    floor = sum(ov.cap for ov in ovs)
    cap = 1 << max(1, math.ceil(math.log2(max(len(ks), floor, 1))))
    keys = _pad_to(ks, cap, np.inf).astype(_NP_KEY[dtype])
    out = dict(keys=torch.from_numpy(keys).to(device),
               vals=torch.from_numpy(_pad_to(vs, cap, 0).astype(
                   np.int64)).to(device),
               tomb=torch.from_numpy(_pad_to(tb, cap, 0).astype(
                   np.int8)).to(device),
               filter=overlay_filter(keys, dtype).to(device))
    sd._ov_cache[ckey] = (ovs, out)
    return out


def overlay_entries(overlays) -> tuple:
    """(keys, vals, tomb) of every shard's pending writes, globally sorted
    (disjoint shard ranges => shard-order concatenation IS key order)."""
    parts = [ov.entries() for ov in overlays]
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


def sharded_lookup_with_overlay(sd_arrays: dict, sd: ShardedDILI,
                                queries: torch.Tensor,
                                strategy: str = "gather",
                                stats: dict | None = None):
    """Sharded snapshot lookup with the combined overlay resolved in each
    shard's kernel launch — no extra pass for the overlay."""
    ova = combined_overlay_arrays(sd, queries.dtype, queries.device)
    return sharded_lookup(sd_arrays, queries, strategy=strategy,
                          overlay=ova, stats=stats)
