"""Index-health introspection: the `dili.inspect/1` schema
(DESIGN.md section 13).

DILI's search cost is governed by tree height and leaf-model accuracy
(the paper's central trade-off; the PGM-index's multicriteria framing is
the same surface), but until now neither was observable on a live index
— only their downstream effect on latency.  `build_inspect` computes a
stable, engine-independent key tree from the flattened snapshot(s):

  tree        — node/slot/pair counts, depth histogram, fanout summary
  leaves      — leaf count, slot-size + fill-factor summaries, dense frac
  model_error — |predicted - actual| slot offset per pair, overall and
                per-leaf-mean summaries (stride-sampled, bounded cost)
  segments    — splice-segment counts + dirty-row breakdown from the
                incremental flattener's last merge
  heat        — per-leaf write/delete/hot-streak summaries from the
                maintain accounting
  overlay     — pending write/tombstone footprint
  wal         — durability footprint (WAL + checkpoint bytes on disk)

Everything is computed from numpy columns already in host memory — no
tree walk, no device sync — so `LearnedIndex.inspect()` is safe to call
on a serving index.  The schema (key tree) is identical across
local/pallas/sharded, pinned by tests/test_inspect_trace.py; values
differ (a sharded index has one flat per shard — arrays are concatenated
before summarizing, counters summed).
"""

from __future__ import annotations

import numpy as np

from ..core.flat import TAG_CHILD, TAG_PAIR

INSPECT_SCHEMA_VERSION = "dili.inspect/1"

#: stride-sample the per-pair model-error computation down to this many
#: pairs — keeps inspect() O(bounded) on the 10M+ rungs
ERROR_SAMPLE_CAP = 65536

_SUMMARY_PCTS = ((50.0, "p50"), (95.0, "p95"), (99.0, "p99"))


def _summary(xs) -> dict:
    """Fixed-key numeric summary (count/mean/p50/p95/p99/max) — the
    inspect-schema analogue of `latency_summary`, unit-free."""
    xs = np.asarray(xs, np.float64)
    if xs.size == 0:
        out = dict(count=0, mean=0.0)
        for _, name in _SUMMARY_PCTS:
            out[name] = 0.0
        out["max"] = 0.0
        return out
    qs = np.percentile(xs, [q for q, _ in _SUMMARY_PCTS])
    out = dict(count=int(xs.size), mean=float(xs.mean()))
    for (_, name), v in zip(_SUMMARY_PCTS, qs):
        out[name] = float(v)
    out["max"] = float(xs.max())
    return out


def _collect_flat(flat, error_cap: int):
    """Raw per-node / per-pair columns for ONE FlatDILI snapshot.

    Returns (depths[n_nodes], leaf_mask[n_nodes], fo, pairs_per_node,
    errors[sampled], err_leaf_ids[sampled], dense) — callers concatenate
    across shards before summarizing."""
    n_nodes = flat.n_nodes
    fo = np.asarray(flat.fo, np.int64)
    tag = flat.tag
    # slot row i belongs to node owner[i]: preorder flatten emits each
    # node's fo slots contiguously in node-id order
    owner = np.repeat(np.arange(n_nodes), fo)

    child_mask = tag == TAG_CHILD
    edge_parent = owner[child_mask]
    edge_child = np.asarray(flat.val[child_mask], np.int64)
    n_child = np.bincount(edge_parent, minlength=n_nodes)
    # an internal node's slots are ALL child pointers; anything else
    # (pairs, empties, or a childless root) is a leaf-class node
    internal = (n_child == fo) & (fo > 0)
    leaf_mask = ~internal

    # depth by level propagation over the child edges: depth[root]=0,
    # each sweep settles one level, max_depth sweeps total
    depth = np.full(n_nodes, -1, np.int64)
    depth[flat.root] = 0
    for _ in range(max(int(flat.max_depth), 1)):
        src = depth[edge_parent]
        ready = src >= 0
        if not ready.any():
            break
        before = depth[edge_child[ready]]
        depth[edge_child[ready]] = src[ready] + 1
        if (before == src[ready] + 1).all():
            break

    pair_mask = tag == TAG_PAIR
    pairs_per_node = np.bincount(owner[pair_mask], minlength=n_nodes)

    # model prediction error per pair: the leaf model maps key -> local
    # slot offset (search.py: off = clip(floor(a + b*k), 0, fo-1)); the
    # pair's actual offset is its slot-table row minus the node base
    n_pairs = flat.n_pairs
    stride = max(1, -(-n_pairs // error_cap)) if n_pairs else 1
    ps = np.asarray(flat.pair_slot[::stride], np.int64)
    pk = np.asarray(flat.pair_key[::stride], np.float64)
    nid = owner[ps] if len(ps) else np.zeros(0, np.int64)
    if len(ps):
        pred = np.floor(np.asarray(flat.a, np.float64)[nid]
                        + np.asarray(flat.b, np.float64)[nid] * pk)
        pred = np.clip(pred, 0, fo[nid] - 1)
        actual = ps - np.asarray(flat.base, np.int64)[nid]
        errors = np.abs(pred - actual)
    else:
        errors = np.zeros(0)
    return (depth, leaf_mask, fo, pairs_per_node, errors, nid,
            np.asarray(flat.dense, np.int64))


def _zero_overlay() -> dict:
    return dict(pending=0, live=0, tombstones=0, cap=0, fill=0.0)


def _zero_wal() -> dict:
    return dict(armed=False, n_shards=0, wal_bytes=0, n_wal_files=0,
                ckpt_bytes=0, n_ckpt_files=0)


def build_inspect(*, engine: str, epoch: int, flats,
                  flatteners=(), accounts=(), overlay: dict | None = None,
                  wal: dict | None = None,
                  error_sample_cap: int = ERROR_SAMPLE_CAP) -> dict:
    """The `dili.inspect/1` document for one index.

    `flats` is the list of published FlatDILI snapshots (one per shard);
    `flatteners` the live IncrementalFlattener instances (may be empty —
    maintenance off); `accounts` the LeafAccount records from the
    maintain accounting; `overlay`/`wal` pre-aggregated footprint dicts
    (None -> zero-filled, same keys)."""
    flats = [f for f in flats if f is not None]
    depths, leaf_masks, fos, ppn, errs, err_nids, denses = [], [], [], [], [], [], []
    nid_off = 0
    for f in flats:
        d, lm, fo, pp, e, en, dn = _collect_flat(f, error_sample_cap)
        depths.append(d)
        leaf_masks.append(lm)
        fos.append(fo)
        ppn.append(pp)
        errs.append(e)
        err_nids.append(en + nid_off)      # shard-unique leaf ids
        denses.append(dn)
        nid_off += f.n_nodes
    cat = (lambda xs, dt=np.int64: np.concatenate(xs)
           if xs else np.zeros(0, dt))
    depth = cat(depths)
    leaf_mask = cat(leaf_masks, bool)
    fo = cat(fos)
    pairs_per_node = cat(ppn)
    errors = cat(errs, np.float64)
    err_nid = cat(err_nids)
    dense = cat(denses)

    n_nodes = int(depth.size)
    max_depth = int(depth.max()) + 1 if n_nodes else 0
    depth_hist = (np.bincount(depth[depth >= 0],
                              minlength=max_depth).tolist()
                  if n_nodes else [])

    leaf_fo = fo[leaf_mask]
    leaf_pairs = pairs_per_node[leaf_mask]
    fill = (leaf_pairs / np.maximum(leaf_fo, 1)) if leaf_fo.size else leaf_fo

    # per-leaf mean |error| over the sampled pairs
    if errors.size:
        sums = np.zeros(nid_off)
        cnts = np.zeros(nid_off)
        np.add.at(sums, err_nid, errors)
        np.add.at(cnts, err_nid, 1.0)
        hit = cnts > 0
        per_leaf_mean = sums[hit] / cnts[hit]
    else:
        per_leaf_mean = np.zeros(0)

    seg = dict(n_segments=int(sum(f.n_segments for f in flats)),
               dirty_segments=0, total_segments=0,
               dirty_rows=0, total_rows=0, dirty_fraction=0.0,
               incremental=False, n_fallback_full=0,
               rows=_summary(()))
    fls = [fl for fl in (flatteners or ()) if fl is not None]
    if fls:
        seg["dirty_segments"] = int(sum(fl.last_dirty_segments for fl in fls))
        seg["total_segments"] = int(sum(fl.last_total_segments for fl in fls))
        seg["dirty_rows"] = int(sum(fl.last_dirty_rows for fl in fls))
        seg["total_rows"] = int(sum(fl.last_total_rows for fl in fls))
        seg["dirty_fraction"] = (seg["dirty_rows"] / seg["total_rows"]
                                 if seg["total_rows"] else 0.0)
        seg["incremental"] = bool(all(fl.last_incremental for fl in fls))
        seg["n_fallback_full"] = int(sum(fl.n_fallback_full for fl in fls))
        seg["rows"] = _summary([blk.n_slots for fl in fls
                                for blk in fl._cache.values()])

    accounts = list(accounts or ())
    heat = dict(n_tracked=len(accounts),
                writes=_summary([ac.writes for ac in accounts]),
                deletes=_summary([ac.deletes for ac in accounts]),
                hot_streak=_summary([ac.hot_streak for ac in accounts]))

    return dict(
        schema=INSPECT_SCHEMA_VERSION,
        engine=engine,
        epoch=int(epoch),
        n_shards=len(flats),
        n_keys=int(sum(f.n_pairs for f in flats)),
        tree=dict(n_nodes=n_nodes,
                  n_slots=int(sum(f.n_slots for f in flats)),
                  n_pairs=int(sum(f.n_pairs for f in flats)),
                  max_depth=max_depth,
                  depth_hist=depth_hist,
                  fanout=_summary(fo)),
        leaves=dict(n_leaves=int(leaf_mask.sum()),
                    n_internal=int((~leaf_mask).sum()),
                    slots=_summary(leaf_fo),
                    fill=_summary(fill),
                    dense_frac=(float(dense[leaf_mask].mean())
                                if leaf_mask.any() else 0.0)),
        model_error=dict(sampled=int(errors.size),
                         overall=_summary(errors),
                         per_leaf_mean=_summary(per_leaf_mean)),
        segments=seg,
        heat=heat,
        overlay=dict(_zero_overlay(), **(overlay or {})),
        wal=dict(_zero_wal(), **(wal or {})),
    )
