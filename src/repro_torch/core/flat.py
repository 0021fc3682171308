"""Flattening: host DILI -> immutable structure-of-arrays device snapshot.

TPU-native layout (DESIGN.md section 2): the whole tree becomes three parallel
tables so traversal is a chain of `gather; fma; floor; clamp` — no pointers.

Node table (one row per internal OR leaf node):
    a, b      : linear model (key -> slot offset), float
    base      : first slot of this node in the slot table, int32
    fo        : number of slots, int32
    dense     : 1 if this is a DILI-LO dense leaf (exponential-search exit)

Slot table (one row per slot of every node, concatenated):
    tag       : 0 = EMPTY, 1 = PAIR, 2 = CHILD
    key       : pair key (valid when tag == PAIR)
    val       : pair payload (tag == PAIR) or child node id (tag == CHILD)

Internal nodes are just nodes whose slots are all CHILD — search over the
whole tree (Alg. 6) collapses into ONE loop (search.py).

Pair table (key-sorted auxiliary view of every PAIR slot, built once per
flatten; DESIGN.md section 9):
    pair_key  : sorted pair keys
    pair_val  : payloads, aligned with pair_key
    pair_slot : slot-table rank of each pair (its row in the slot table)

Range queries bisect the pair table (two searchsorted) and gather one bounded
window — O(log n + max_hits) per query — instead of scanning the slot table.

The live write path is `repro.online`'s tombstone-capable overlay +
epoch/merge lifecycle (DESIGN.md section 8).  `DeltaOverlay` below is the
legacy insert-only buffer, kept for the single-process convenience path and
its tests; it is NOT what serving uses.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np

from .dili import DILI, Internal, Leaf

TAG_EMPTY, TAG_PAIR, TAG_CHILD = 0, 1, 2


@dataclass
class FlatDILI:
    # node table
    a: np.ndarray        # f64 [n_nodes]
    b: np.ndarray        # f64 [n_nodes]
    base: np.ndarray     # i32 [n_nodes]
    fo: np.ndarray       # i32 [n_nodes]
    dense: np.ndarray    # i8  [n_nodes]
    # slot table
    tag: np.ndarray      # i8  [n_slots]
    key: np.ndarray      # f64 [n_slots]
    val: np.ndarray      # i64 [n_slots]
    # pair table (key-sorted auxiliary view of the PAIR slots)
    pair_key: np.ndarray   # f64 [n_pairs], sorted ascending
    pair_val: np.ndarray   # i64 [n_pairs]
    pair_slot: np.ndarray  # i32 [n_pairs], slot-table rank of each pair
    root: int
    max_depth: int
    key_lo: float
    key_hi: float
    # segment metadata: number of splice units (top-level leaf subtrees) the
    # incremental flattener would cache for this tree — the denominator of
    # the dirty-segment fraction and the re-clustering layout signal
    n_segments: int = 0

    @property
    def n_nodes(self) -> int:
        return len(self.a)

    @property
    def n_slots(self) -> int:
        return len(self.tag)

    @property
    def n_pairs(self) -> int:
        return len(self.pair_key)

    def nbytes(self) -> int:
        return sum(x.nbytes for x in
                   (self.a, self.b, self.base, self.fo, self.dense,
                    self.tag, self.key, self.val,
                    self.pair_key, self.pair_val, self.pair_slot))

    def astype(self, dtype) -> "FlatDILI":
        """Cast key/model dtype (f32 for the Pallas TPU kernel path)."""
        return FlatDILI(self.a.astype(dtype), self.b.astype(dtype),
                        self.base, self.fo, self.dense, self.tag,
                        self.key.astype(dtype), self.val,
                        self.pair_key.astype(dtype), self.pair_val,
                        self.pair_slot, self.root,
                        self.max_depth, self.key_lo, self.key_hi,
                        self.n_segments)


def preorder(root) -> list:
    """DFS preorder over the host tree.  This is the canonical flatten
    order (since the maintenance subsystem, DESIGN.md section 12): every
    subtree occupies one CONTIGUOUS run of node ids and slot rows, so the
    incremental flattener (`repro.maintain.flattener`) can splice a dirty
    subtree's re-flattened rows without renumbering interleaved levels —
    BFS interleaves subtrees across levels and has no such property.
    (Lookup cost is unaffected: an interleaved same-process A/B of the two
    orders on the 300k fb/wikits/logn snapshots measured DFS at 0.84x /
    0.28x / 0.93x of the BFS wall time — the former BFS comment's
    "parents get smaller ids" locality hope does not show up on the
    batched gather path.)
    Children are visited in key order, so (with the equal-division routing
    being monotone in the key) the PAIR slots of consecutive subtrees are
    consecutive key ranges too."""
    order: list = []
    stack = [root]
    while stack:
        nd = stack.pop()
        order.append(nd)
        if isinstance(nd, Internal):
            stack.extend(reversed(nd.children))
        else:
            stack.extend(reversed([s for s in nd.slots
                                   if isinstance(s, Leaf)]))
    return order


def node_tables(nodes: list, ids: dict[int, int]):
    """Materialize the node + slot tables for `nodes` (a preorder run) with
    node ids taken from `ids`.  Shared by the whole-tree `flatten()` and the
    per-subtree blocks of `repro.maintain.flattener` (which passes
    subtree-local ids), so the two can never drift."""
    n_nodes = len(nodes)
    a = np.zeros(n_nodes)
    b = np.zeros(n_nodes)
    base = np.zeros(n_nodes, np.int32)
    fo = np.zeros(n_nodes, np.int32)
    dense = np.zeros(n_nodes, np.int8)

    tags: list[np.ndarray] = []
    keys: list[np.ndarray] = []
    vals: list[np.ndarray] = []
    cursor = 0
    for i, nd in enumerate(nodes):
        if isinstance(nd, Internal):
            m = nd.fanout
            a[i], b[i], base[i], fo[i] = nd.a, nd.b, cursor, m
            tags.append(np.full(m, TAG_CHILD, np.int8))
            keys.append(np.zeros(m))
            vals.append(np.array([ids[id(c)] for c in nd.children], np.int64))
            cursor += m
        else:
            m = max(nd.fo, 1)
            a[i], b[i], base[i], fo[i] = nd.a, nd.b, cursor, m
            dense[i] = 1 if nd.dense else 0
            t = np.zeros(m, np.int8)
            k = np.zeros(m)
            v = np.zeros(m, np.int64)
            for j, s in enumerate(nd.slots[:m]):
                if s is None:
                    continue
                if isinstance(s, Leaf):
                    t[j] = TAG_CHILD
                    v[j] = ids[id(s)]
                else:
                    t[j] = TAG_PAIR
                    k[j] = s[0]
                    v[j] = s[1]
            tags.append(t)
            keys.append(k)
            vals.append(v)
            cursor += m

    tag_all = np.concatenate(tags) if tags else np.zeros(0, np.int8)
    key_all = np.concatenate(keys) if keys else np.zeros(0)
    val_all = np.concatenate(vals) if vals else np.zeros(0, np.int64)
    return a, b, base, fo, dense, tag_all, key_all, val_all


def flatten(dili: DILI, stage=None) -> FlatDILI:
    """DFS preorder over the host tree, assigning node ids and slot ranges
    (see `preorder` for why preorder is the canonical order).  Given a
    stage recorder (`obs.SpanRecorder.stage`, called as
    `stage(name, t0, t1)`) it records the spans `flatten.preorder`,
    `flatten.tables`, `flatten.pairs` and `flatten.shape`."""
    on = stage is not None
    if on:
        t0 = time.perf_counter()
    nodes = preorder(dili.root)
    ids = {id(nd): i for i, nd in enumerate(nodes)}
    if on:
        t1 = time.perf_counter()
    a, b, base, fo, dense, tag_all, key_all, val_all = node_tables(nodes, ids)
    if on:
        t2 = time.perf_counter()

    # pair table: key-sorted view of the PAIR slots.  Slots are id-ordered,
    # not key-ordered, so one argsort here buys O(log n + k) range queries
    # (two searchsorted + a bounded window gather) on the device.
    slots = np.nonzero(tag_all == TAG_PAIR)[0].astype(np.int32)
    order = np.argsort(key_all[slots], kind="stable")
    pair_slot = slots[order]
    pair_key, pair_val = key_all[pair_slot], val_all[pair_slot]
    if on:
        t3 = time.perf_counter()
    max_depth, n_segments = _max_depth(dili.root), _n_segments(dili.root)
    if on:
        stage("flatten.preorder", t0, t1)
        stage("flatten.tables", t1, t2)
        stage("flatten.pairs", t2, t3)
        stage("flatten.shape", t3, time.perf_counter())

    return FlatDILI(
        a=a, b=b, base=base, fo=fo, dense=dense,
        tag=tag_all, key=key_all, val=val_all,
        pair_key=pair_key, pair_val=pair_val, pair_slot=pair_slot,
        root=ids[id(dili.root)], max_depth=max_depth,
        key_lo=float(dili.root.lb), key_hi=float(dili.root.ub),
        n_segments=n_segments,
    )


def patch_payloads(flat: FlatDILI, keys, vals) -> FlatDILI | None:
    """`flat` with the payloads of the pairs at `keys` (distinct) replaced
    by `vals`, or None if any key is not exactly one of its pairs, bit for
    bit (a signed zero counts as another key).  This is what `flatten()`
    gives after upserts that only replace existing payloads (Alg. 7's
    duplicate branch), since such an upsert moves no slot, model or node:
    the two differ only in `val` at the pairs' slot rows and in
    `pair_val`.  Those two arrays are fresh copies; every other array is
    `flat`'s own, which nothing writes into once it is built."""
    keys = np.asarray(keys, np.float64)
    n = flat.n_pairs
    at = np.searchsorted(flat.pair_key, keys)
    if len(keys) and at.max() >= n:
        return None
    hit = flat.pair_key[at]
    twice = (at + 1 < n) & (flat.pair_key[np.minimum(at + 1, n - 1)] == keys)
    if not (np.array_equal(hit, keys) and not twice.any()
            and np.array_equal(np.signbit(hit), np.signbit(keys))):
        return None
    vals = np.asarray(vals, np.int64)
    val, pair_val = flat.val.copy(), flat.pair_val.copy()
    val[flat.pair_slot[at]] = vals
    pair_val[at] = vals
    return replace(flat, val=val, pair_val=pair_val)


def _n_segments(root) -> int:
    """Count the splice units (`maintain.flattener._units`'s 'seg' entries):
    top-level leaf subtrees hanging off Internals, or the root itself when
    it is a leaf.  O(#internals + #segments), no per-slot work."""
    n = 0
    stack = [root]
    while stack:
        nd = stack.pop()
        if isinstance(nd, Internal):
            stack.extend(nd.children)
        else:
            n += 1
    return n


def _max_depth(root) -> int:
    best = 1
    stack = [(root, 1)]
    while stack:
        nd, d = stack.pop()
        best = max(best, d)
        if isinstance(nd, Internal):
            for c in nd.children:
                stack.append((c, d + 1))
        else:
            for s in nd.slots:
                if isinstance(s, Leaf):
                    stack.append((s, d + 1))
    return best


# ---------------------------------------------------------------------------
# Delta overlay: sorted buffer for inserts between snapshot publishes
# ---------------------------------------------------------------------------


def merge_sorted_runs(old_k: np.ndarray, old_cols: tuple,
                      new_k: np.ndarray, new_cols: tuple):
    """Merge an already-sorted run with an (unsorted) write batch.

    Last-write-wins: a new key displaces an old entry with the same key, and
    within the batch the later duplicate wins.  Cost is O(n + k log n): the
    batch is sorted (k log k), binary-searched against the old run, and both
    runs are scattered straight into their merged positions — the old run is
    never re-sorted.  Returns (keys, cols) with cols aligned to keys.
    """
    new_k = np.asarray(new_k, old_k.dtype)
    order = np.argsort(new_k, kind="stable")
    new_k = new_k[order]
    new_cols = tuple(np.asarray(c)[order] for c in new_cols)
    keep = np.ones(len(new_k), bool)                 # in-batch dedupe (last)
    keep[:-1] = np.diff(new_k) != 0
    new_k = new_k[keep]
    new_cols = tuple(c[keep] for c in new_cols)

    if len(new_k):
        # drop old entries shadowed by the batch
        pos = np.minimum(np.searchsorted(new_k, old_k), len(new_k) - 1)
        live = new_k[pos] != old_k
        old_k = old_k[live]
        old_cols = tuple(c[live] for c in old_cols)

    # interleave: each run's rank among the other gives its merged position
    n = len(old_k) + len(new_k)
    at_old = np.searchsorted(new_k, old_k) + np.arange(len(old_k))
    at_new = np.searchsorted(old_k, new_k) + np.arange(len(new_k))
    mk = np.empty(n, old_k.dtype)
    mk[at_old] = old_k
    mk[at_new] = new_k
    cols = []
    for oc, nc in zip(old_cols, new_cols):
        mc = np.empty(n, oc.dtype)
        mc[at_old] = oc
        mc[at_new] = nc
        cols.append(mc)
    return mk, tuple(cols)


@dataclass
class DeltaOverlay:
    keys: np.ndarray     # f64 [cap], padded with +inf
    vals: np.ndarray     # i64 [cap]
    count: int
    cap: int

    @staticmethod
    def empty(cap: int = 65536) -> "DeltaOverlay":
        return DeltaOverlay(np.full(cap, np.inf), np.zeros(cap, np.int64), 0, cap)

    def insert_batch(self, k: np.ndarray, v: np.ndarray) -> "DeltaOverlay":
        # the buffer is already sorted: merge two runs instead of re-sorting
        # the whole thing — absorption is O(n + k log n), not O((n+k) log(n+k))
        nk, (nv,) = merge_sorted_runs(
            self.keys[: self.count], (self.vals[: self.count],),
            np.asarray(k, np.float64), (np.asarray(v, np.int64),))
        cap = self.cap
        while len(nk) > cap:
            cap *= 2
        keys = np.full(cap, np.inf)
        vals = np.zeros(cap, np.int64)
        keys[: len(nk)] = nk
        vals[: len(nk)] = nv
        return DeltaOverlay(keys, vals, len(nk), cap)

    @property
    def full_fraction(self) -> float:
        return self.count / max(self.cap, 1)
