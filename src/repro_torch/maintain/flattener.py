"""Incremental (splice) flattening: re-flatten only the dirty subtrees.

The monolithic `core.flat.flatten` walks EVERY node and EVERY slot of the
host tree per merge — O(n) Python-loop work whose cost grows with total
index size, not with the write footprint.  This module converts that to
O(dirty): the tree is partitioned into **segments** (the maximal mutable
subtrees — every leaf that hangs off an internal node, conflict-leaf
chains included; the paper's Alg. 7/8 only ever mutate inside these, while
internal nodes are structurally immutable after construction), each
segment's flattened block (node rows, slot rows, key-sorted pair run) is
cached, and a merge re-materializes only the segments its writes dirtied.  Reassembly is numpy concatenation plus vectorized id/offset
shifts — no per-slot Python.

Exactness contract: the result is **bit-identical** to `flatten(dili)` on
the same tree (asserted by tests/test_maintain.py's property test).  Two
structural facts make that cheap:

  * `flatten` is DFS preorder, so a segment occupies one contiguous run of
    node ids and slot rows; splicing never renumbers interleaved levels.
  * the equal-division routing is monotone in the key, so consecutive
    segments hold consecutive key ranges — the global key-sorted pair
    table is the concatenation of per-segment sorted runs, no global
    argsort.

Dirty plumbing: `DILI` records the id of every leaf its mutation entry
points located (`DILI.dirty_ids`); the flattener maps those to segments
via the node->segment index it builds while flattening.  An id it cannot
map (should not happen — every located leaf existed at the previous
flatten) falls back to a full re-flatten rather than risking a stale
block: correctness never depends on the plumbing being airtight.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..core.dili import DILI, Internal
from ..core.flat import (FlatDILI, TAG_CHILD, TAG_PAIR, _max_depth,
                         node_tables, preorder)


@dataclass
class SegmentBlock:
    """One segment's cached flatten output, in segment-local coordinates
    (node ids 0-based at the segment root, slot offsets 0-based at the
    segment's first slot row)."""
    root: object                 # strong ref: keeps ids in the index stable
    nodes: list                  # strong refs to every node (id stability)
    a: np.ndarray
    b: np.ndarray
    base: np.ndarray             # local slot offsets
    fo: np.ndarray
    dense: np.ndarray
    tag: np.ndarray
    key: np.ndarray
    val: np.ndarray              # CHILD entries hold segment-local node ids
    child_mask: np.ndarray       # tag == TAG_CHILD (precomputed for shifts)
    pair_key: np.ndarray         # segment pairs, key-sorted
    pair_val: np.ndarray
    pair_slot: np.ndarray        # local slot ranks of the sorted pairs
    depth: int                   # local subtree height (segment root = 1)

    @property
    def n_nodes(self) -> int:
        return len(self.a)

    @property
    def n_slots(self) -> int:
        return len(self.tag)


def flatten_segment(root) -> SegmentBlock:
    """Flatten one subtree in isolation, via the same `node_tables` code
    path as the whole-tree `flatten()` (bit-for-bit the same rows once the
    local ids/offsets are shifted into place)."""
    nodes = preorder(root)
    ids = {id(nd): i for i, nd in enumerate(nodes)}
    a, b, base, fo, dense, tag, key, val = node_tables(nodes, ids)
    slots = np.nonzero(tag == TAG_PAIR)[0].astype(np.int32)
    order = np.argsort(key[slots], kind="stable")
    pair_slot = slots[order]
    return SegmentBlock(
        root=root, nodes=nodes, a=a, b=b, base=base, fo=fo, dense=dense,
        tag=tag, key=key, val=val, child_mask=tag == TAG_CHILD,
        pair_key=key[pair_slot], pair_val=val[pair_slot],
        pair_slot=pair_slot, depth=_max_depth(root))


PAUSE_UNITS = 512    # units of passes 2 and 3 between calls of `pause`


def _no_pause() -> None:
    pass


class IncrementalFlattener:
    """Segment-cached flattener.  `flatten(dili, dirty_ids)` returns a
    `FlatDILI` bit-identical to `core.flat.flatten(dili)`, re-flattening
    only segments containing a dirty id (plus segments whose root object
    changed — a retrained subtree is a cache miss by identity)."""

    def __init__(self) -> None:
        self._cache: dict[int, SegmentBlock] = {}
        self._node2seg: dict[int, int] = {}
        # observability (read by engine stats())
        self.last_dirty_segments = 0
        self.last_total_segments = 0
        self.last_dirty_rows = 0
        self.last_total_rows = 0
        self.last_incremental = False
        # forced full re-flattens from an unmappable dirty id — distinct
        # from INTENTIONAL full flattens (cold cache, incremental=False):
        # a nonzero count means the dirty plumbing leaked an id and the
        # O(dirty) guarantee silently degraded to O(n).  Surfaced as
        # `n_forced_full_flattens` in engine stats().
        self.n_fallback_full = 0

    def segment_rows(self, nid: int) -> int | None:
        """Flattened slot-row count of the segment containing node `nid`,
        or None if the node was never flattened.  The re-clustering
        planner's size signal: rows (not pairs) are what a dirty segment
        actually costs a merge."""
        seg = self._node2seg.get(nid)
        if seg is None:
            return None
        blk = self._cache.get(seg)
        return blk.n_slots if blk is not None else None

    # -- structure -----------------------------------------------------------

    @staticmethod
    def _units(root) -> list:
        """DFS preorder as a list of units: ('spine', node, depth) single
        Internal nodes and ('seg', node, depth) whole leaf-rooted mutable
        subtrees.  Concatenating per-unit blocks in this order IS
        `preorder(root)`.

        The spine is DYNAMIC — every `Internal` is a spine unit, including
        internals a retrain introduced.  Internals are structurally
        immutable after construction (Alg. 7/8 mutate only leaf subtrees;
        bulk_load and rebuild_subtree never touch an existing internal's
        children list, only swap one pointer), so caching applies exactly
        to the mutable units.  This also keeps segments fine-grained under
        append-style workloads: when the frontier leaf is retrained into
        an Internal-rooted subtree, its leaves become independent segments
        instead of one ever-growing block."""
        units: list = []
        stack = [(root, 1)]
        while stack:
            nd, d = stack.pop()
            if isinstance(nd, Internal):
                units.append(("spine", nd, d))
                stack.extend((c, d + 1) for c in reversed(nd.children))
            else:
                units.append(("seg", nd, d))
        return units

    # -- the splice ----------------------------------------------------------

    def flatten(self, dili: DILI, dirty_ids: set[int] | None = None,
                stage=None, pause=None) -> FlatDILI:
        """The splice.  Given a stage recorder (`obs.SpanRecorder.stage`,
        called as `stage(name, t0, t1)`) it records the spans
        `splice.units`, `splice.refresh`, `splice.offsets` and
        `splice.assemble`.  `pause`, when given, is called between units
        of its work: before each re-flattened segment, every
        `PAUSE_UNITS` units of passes 2 and 3, and between the final
        concatenations (the maintenance worker's yield to write calls)."""
        if pause is None:
            pause = _no_pause
        on = stage is not None
        if on:
            t0 = time.perf_counter()
        dirty_ids = dirty_ids or set()
        units = self._units(dili.root)
        had_cache = bool(self._cache)

        # translate dirty node ids -> dirty segment ids; an id the index
        # does not know forces a full re-flatten (safety net, see module
        # docstring) by dirtying every segment
        dirty_segs: set[int] = set()
        force_full = False
        for nid in dirty_ids:
            seg = self._node2seg.get(nid)
            if seg is None:
                force_full = True
                self.n_fallback_full += 1
                break
            dirty_segs.add(seg)
        if on:
            t1 = time.perf_counter()

        # pass 1: refresh segment blocks (cache miss == dirty by identity)
        seen: set[int] = set()
        n_dirty = dirty_rows = 0
        for kind, nd, _ in units:
            if kind != "seg":
                continue
            sid = id(nd)
            seen.add(sid)
            if force_full or sid in dirty_segs or sid not in self._cache:
                pause()
                old = self._cache.pop(sid, None)
                if old is not None:
                    for onode in old.nodes:
                        self._node2seg.pop(id(onode), None)
                blk = flatten_segment(nd)
                self._cache[sid] = blk
                for bnode in blk.nodes:
                    self._node2seg[id(bnode)] = sid
                n_dirty += 1
                dirty_rows += blk.n_slots
        # drop segments that no longer exist (retrained away)
        for dead in set(self._cache) - seen:
            for onode in self._cache.pop(dead).nodes:
                self._node2seg.pop(id(onode), None)
        if on:
            t2 = time.perf_counter()

        # pass 2: assign global offsets per unit (plain python ints — a
        # numpy scalar store per unit costs more than the whole pass)
        node_off: list[int] = []
        slot_off: list[int] = []
        cur_n = cur_s = 0
        blocks: list[SegmentBlock | None] = []
        for u, (kind, nd, _) in enumerate(units):
            if not u % PAUSE_UNITS:
                pause()
            node_off.append(cur_n)
            slot_off.append(cur_s)
            if kind == "spine":
                blocks.append(None)
                cur_n += 1
                cur_s += nd.fanout
            else:
                blk = self._cache[id(nd)]
                blocks.append(blk)
                cur_n += blk.n_nodes
                cur_s += blk.n_slots
        unit_of_node = {id(nd): u for u, (_, nd, _) in enumerate(units)}
        if on:
            t3 = time.perf_counter()

        # pass 3: assemble.  The unit loop only APPENDS segment-local
        # arrays (zero numpy calls per cached segment — with many small
        # segments the per-segment numpy-call overhead used to dominate
        # the whole splice); every id/offset shift is applied after the
        # concat as one vectorized repeat/masked-add over the full table.
        a_parts, b_parts, base_parts, fo_parts, dense_parts = [], [], [], [], []
        tag_parts, key_parts, val_parts = [], [], []
        pk_parts, pv_parts, ps_parts = [], [], []
        u_nodes: list[int] = []      # node rows per unit  (base shift runs)
        u_slots: list[int] = []      # slot rows per unit  (val shift runs)
        u_noff: list[int] = []       # node-id shift for seg CHILD slots
        seg_pairs: list[int] = []    # pair rows per seg   (pair_slot runs)
        seg_soff: list[int] = []     # slot-row shift per seg's pair run
        zero1_i8 = np.zeros(1, np.int8)
        zero1_i32 = np.zeros(1, np.int32)
        max_depth = 1
        for u, (kind, nd, d) in enumerate(units):
            if not u % PAUSE_UNITS:
                pause()
            if kind == "spine":
                a_parts.append(np.array([nd.a]))
                b_parts.append(np.array([nd.b]))
                base_parts.append(zero1_i32)
                fo_parts.append(np.array([nd.fanout], np.int32))
                dense_parts.append(zero1_i8)
                m = nd.fanout
                tag_parts.append(np.full(m, TAG_CHILD, np.int8))
                key_parts.append(np.zeros(m))
                # spine CHILD targets are arbitrary units' offsets — only
                # these are resolved in-loop (few internals, many segments)
                val_parts.append(np.array(
                    [node_off[unit_of_node[id(c)]] for c in nd.children],
                    np.int64))
                u_nodes.append(1)
                u_slots.append(m)
                u_noff.append(0)     # already global
                max_depth = max(max_depth, d)
            else:
                blk = blocks[u]
                a_parts.append(blk.a)
                b_parts.append(blk.b)
                base_parts.append(blk.base)
                fo_parts.append(blk.fo)
                dense_parts.append(blk.dense)
                tag_parts.append(blk.tag)
                key_parts.append(blk.key)
                val_parts.append(blk.val)
                pk_parts.append(blk.pair_key)
                pv_parts.append(blk.pair_val)
                ps_parts.append(blk.pair_slot)
                u_nodes.append(blk.n_nodes)
                u_slots.append(blk.n_slots)
                u_noff.append(node_off[u])
                seg_pairs.append(len(blk.pair_slot))
                seg_soff.append(slot_off[u])
                max_depth = max(max_depth, d + blk.depth - 1)

        total_rows = int(cur_s)
        self.last_dirty_segments = n_dirty
        self.last_total_segments = len(self._cache)
        self.last_dirty_rows = dirty_rows
        self.last_total_rows = total_rows
        self.last_incremental = had_cache and not force_full

        z8, zf, zi = (np.zeros(0, np.int8), np.zeros(0),
                      np.zeros(0, np.int64))
        zi32 = np.zeros(0, np.int32)
        pause()
        tag = np.concatenate(tag_parts) if tag_parts else z8
        # base rows are segment-local: one repeat of each unit's slot
        # offset over its node rows re-bases them globally (spine locals
        # are 0, so the uniform shift is exact for both unit kinds)
        base = np.concatenate(base_parts) if base_parts else zi32
        base += np.repeat(np.asarray(slot_off, np.int32),
                          np.asarray(u_nodes, np.int32))
        # CHILD slot entries of a segment hold segment-local node ids;
        # shift them by their unit's node offset in one masked add
        # (spine units carry shift 0 — their targets are already global)
        pause()
        val = np.concatenate(val_parts) if val_parts else zi
        child = tag == TAG_CHILD
        val[child] += np.repeat(np.asarray(u_noff, np.int64),
                                np.asarray(u_slots, np.int64))[child]
        # sorted pair runs: slot ranks are segment-local too
        pause()
        pair_slot = np.concatenate(ps_parts) if ps_parts else zi32
        pair_slot += np.repeat(np.asarray(seg_soff, np.int32),
                               np.asarray(seg_pairs, np.int32))
        def cat(parts, empty):
            pause()
            return np.concatenate(parts) if parts else empty

        flat = FlatDILI(
            a=cat(a_parts, zf),
            b=cat(b_parts, zf),
            base=base,
            fo=cat(fo_parts, zi32),
            dense=cat(dense_parts, z8),
            tag=tag,
            key=cat(key_parts, zf),
            val=val,
            pair_key=cat(pk_parts, zf),
            pair_val=cat(pv_parts, zi),
            pair_slot=pair_slot,
            root=0, max_depth=max_depth,
            key_lo=float(dili.root.lb), key_hi=float(dili.root.ub),
            n_segments=len(self._cache),
        )
        if on:
            stage("splice.units", t0, t1)
            stage("splice.refresh", t1, t2)
            stage("splice.offsets", t2, t3)
            stage("splice.assemble", t3, time.perf_counter())
        return flat
