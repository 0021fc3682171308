#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--keys 1000000] [--seed 0] [--baseline SRC]

Phases (any failure exits nonzero; nothing falls back to the CPU):
  1. card and build: prints the card's name and power limit, builds the
     CUDA lookup kernel from `src/repro_torch/kernels/csrc/` with nvcc
     (one library, three instances: f32/i32, f64/i64 and f32/i64) and
     prints ptxas's register and shared-memory report for each;
  2. each instance against its plain version, bit for bit on hits,
     midpoint misses, +inf and NaN lanes and queries above the key range,
     a ragged batch of 777, and the 2^20-lane batch that the numbers
     time: the f32/i32 instance at 20k keys (a table with dense leaves)
     and at the `pallas` main index; the f64/i64 instance, with an overlay
     of upserts and tombstones resolved in the same launch, at 20k logn
     keys (no dense leaf), at a 20k DILI-LO build (every leaf dense) and
     at the local main index; the f32/i64 instance, with an f32 overlay,
     at the same two 20k builds and at the local-f32 main index;
  3. the `pallas` main path: `LearnedIndex.build` on `--keys` logn keys,
     at most 250k (f32, unique), with engine="pallas" on CUDA, lookups in
     2^20-query batches, 4096 range queries, a few thousand upserts and
     deletes, flush, lookups again and `items()` — each checked against a
     numpy truth; the f32 kernel must have launched, and the pair-table
     recheck must have turned no kernel miss into a hit;
  4. the local main path, with the defaults users get
     (`IndexConfig(telemetry=True)`): `LearnedIndex.build` on `--keys`
     logn keys in f64, lookups in 2^20-query batches, 4096 range queries,
     writes in batches of 1000 (new keys, overwrites, deletes) under the
     default merge policy, which must merge on its own at least once,
     then flush, lookups, ranges, `items()` and one more write batch,
     each held against a numpy truth; the f64 kernel must have launched;
     after its numbers (5), the same index is served through
     `ServeFrontend` (4 open-loop client threads, 16-op YCSB-A requests,
     the reference's ramp from 4000 ops/s in 2 s legs, then legs of at
     least 1,000 lookup requests at 50% and 80% of its best achieved
     rate), every answer recorded in commit order and replayed through
     `WorkloadRunner`'s oracle against the journal (zero divergences);
     prints each leg's request counts, offered and achieved rates and
     whether it held, per-op p50/p99, the highest offered rate a leg
     held, the mean coalesced batch and the shed share;
  5. numbers, per instance: launches during its main path; on one
     2^20-query batch the share of lanes that end at a dense leaf, the L2
     sectors the walk requests under the column layout and under the
     packed records (split by tree level, node records against slot
     records), the kernel's registers and resident blocks per SM, kernel
     ms warm (CUDA-graph replays of 25 launches, no Python between
     launches) and with a cold L2, with an overlay also the walk alone,
     plain version ms, library ms (`torch.searchsorted` over the pair
     table, and with an overlay `resolve_overlay`'s over it), whole
     lookup ms with its device breakdown, and the kernel's bound from the
     distinct node records, key and val words and overlay words the batch
     reads (a torch replay of the kernel, held to the kernel); table
     bytes, build, flatten, merge and flush seconds; with `--baseline
     SRC` (an earlier copy of csrc/dili_search.cu), that kernel's warm
     and cold ms on the same batch, timed in turns with this one's;
  6. the local main path at f32 (`dtype=torch.float32`) on `--keys` logn
     keys, at most 250k, made exact in f32: lookups in 2^20-query batches, 4096 range
     queries, writes in batches of 1000 with an automatic merge, flush
     and `items()`.  The reference's f32 arithmetic misses some keys of
     an f64-placed tree, so lookups are held to a numpy model of that
     walk (which lanes are found) and to the key set (every found value),
     ranges and `items()` to the key set; the f32/i64 kernel must have
     launched, and its numbers follow as in 5;
  7. background maintenance on the local engine at `--keys` f64 logn
     keys, on a copy of the local path's bulk load: 12 rounds of 2048
     scrambled-zipfian upserts (YCSB-A's update draw) and 500 deletes,
     each round's lookups held to the truth, at least one started while
     a merge was in flight; then the flush
     barrier, `items()`, at least one incremental flatten and re-cluster,
     no forced full flatten, no maintenance error, not degraded,
     `inspect()`'s `dili.inspect/1` key tree and a `dili.trace/1` export
     with the merge spans; prints per-merge stage times (from the trace),
     dirty fractions, publish seconds, and lookup ms with and without a
     merge in flight;
  8. durability on the local engine at `--keys` f64 logn keys (at most
     250k) with
     `IndexConfig(telemetry=True, durability=DurabilityConfig(dir=...))`
     (a fresh temporary directory, removed at the end): YCSB-A in 32
     batches of 1024 through `WorkloadRunner.run_kill_recover`, every
     batch held to the oracle, the index abandoned at half the stream
     and recovered on CUDA, zero divergences; then a 2^20-query lookup
     through the recovered index held to the oracle, and the port's crash
     child (tests/test_torch_crash.py) killed at three points and
     recovered on CUDA; prints the recovery's seconds and spans, the
     replayed records, the recovery's bulk load, upsert p50/p99, the
     share of upsert time in `wal.append`, `inspect()["wal"]` and the
     directory's bytes; the f64 kernel must have launched;
  9. the sharded engine on `--keys` f64 logn keys (at most 250k, the
     durable path's), `IndexConfig(engine="sharded", n_shards=8,
     telemetry=True)`: 2^20
     lookups on the gather strategy, on a2a a uniform batch (its overflow
     counts printed) and a batch skewed into shard 0 that must overflow
     and come back exact through the gather fallback, 4096 range
     queries, writes, a flush and `items()`, each held against a numpy
     truth; shard 0's tables with the combined overlay held to the plain
     version; prints launches per lookup, host ms, the graph-timed
     device ms of one lookup's 8 launches against one launch over the
     same batch on the durable path's recovered local index, the
     per-shard table bytes, and what the cut to 250k saved against the
     local path's 1M build; the f64 kernel must have launched;
 10. background against synchronous maintenance (the reference's
     serving config: sample_stride=4, overlay_cap=8192) on 250k
     even-integer keys: the ramp on a background index of its own, then
     the same YCSB-A stream offered at 0.8 of its best achieved rate to
     a fresh index of each mode; prints lookup p50/p99 of both and their
     ratio;
 11. the paper's competitors (`repro_torch/core/baselines.py`: BinS,
     B+Tree, RMI, PGM, RS, LIPP, ALEX) beside DILI on the local path's
     keys (LIPP, the slowest host build, on the local-f32 path's 249,228
     keys with a batch of its own), DILI's row from that bulk load's
     flat (the f64/i64 walk, no overlay): each built on the host (its
     seconds and device bytes a key, Fig. 6a), one 2^20-lane batch of hits and midpoint misses
     through each held to a numpy truth, then to the same torch code on
     the CPU on a 65,536-lane sample and the pad-and-above lanes (vals,
     found, probes; PGM, which misses some keys as the reference does,
     on the whole batch), LIPP's and DILI's kernel to its plain version; per
     row ms per 2^20 lanes on the graph timer, one lookup's host ms with
     numpy in and out, kernel launches a lookup (profiler) and mean
     probes (Table 5).  The competitors are eager torch ops, tens to
     hundreds of launches each, and DILI one launch: this is not the
     paper's comparison of compiled indexes;
 12. llm serve (the LLM serving path, `repro_torch/launch/serve.py`): the
     six assigned architectures' reduced configs in f32, weights from the
     port's seeded init, prefill and 4 greedy decode steps on the card and
     on the CPU (equal tokens, logits within 1e-4, TF32 off); then
     granite-8b at full width and depth in bf16 served by the launcher (16
     requests, batch 8, prompt 32, 8 tokens, 4 front-end threads, the
     session table on the card, whose lookups must launch the f64/i64
     kernel): every session resolved to the KV slot its admit returned,
     finite logits, tokens in range; the f64/i64 kernel against its plain
     version on the session table's tables and overlay and each batch's
     ids as those lookups read them;
     prints the init seconds, tok/s, the front-end's batches and shed
     share, weight bytes and peak memory, prefill of [8, 32] and decode
     ms a step on CUDA events beside their bounds, and the device's busy
     share in each; then decode against the full forward at
     granite-8b's width with 2 layers in f32 (2e-2 relative);
 13. llm train (the LLM training path, `repro_torch/train/`): the six
     reduced archs in f32 with remat off, weights from the port's seeded
     init, one step's loss, grad norm and every gradient leaf and 3 AdamW
     steps' losses on the card and on the CPU (relative gaps within 1e-4,
     TF32 off); then granite-8b at full width with 16 of its 36 layers in
     bf16, remat `dots`, the launcher's AdamW and cosine schedule, 6 steps
     of batch 8 x 128 drawn by `StorePipeline` from a `RecordStore` on the
     card (2,000 documents of 129 tokens, the training example's
     `build_store`), whose lookups must launch the f64/i64 kernel: finite
     losses and grad norms, weights changed; the kernel against its plain
     version on each lookup's tables, overlay and keys; prints the init
     seconds, peak memory, step ms on CUDA events (median of steps 2-6,
     split forward + backward and optimizer) beside the bytes and
     operations bounds, and one more step under torch.profiler (busy,
     idle share, kernels); then the accumulation property at full width
     with 2 layers in f32 (loss 1e-5, grad norm 1e-4 relative), and
     `examples/train_lm_torch.py --preset cpu` on the card failed at step
     6 (exit 42) and resumed from its step-4 checkpoint, its losses and
     weights against an uninterrupted run within 1e-5;
 14. ssm / hybrid / parallel (`models/mamba.py`, `parallel/`,
     `launch/{mesh,specs,dryrun,bounds}.py`) on the seed's two configs,
     built here (no config in `configs/` has either family):
     falcon-mamba-7b (Mamba-1) and zamba2-1.2b (Mamba-2 with a shared
     attention block every 6 layers): their reduced configs in f32 card
     against CPU as in phases 12 and 13; each served uncut in bf16,
     prefill of [8, 32] and 8 greedy decode steps, then prefill and decode
     ms on CUDA events beside their bounds, kernels a decode step and the
     idle share, peak memory; the decode property at full width in f32
     (falcon-mamba 2 layers, zamba2 12 layers: two shared sites, both
     used); each trained at full width in bf16 as in phase 13 (zamba2
     whole, falcon-mamba 8 of its 64 layers), whose store lookups must
     launch the f64/i64 kernel, held to its plain version; the GPipe
     schedule at granite-8b's width (4 layers, 4 stages, 4 microbatches,
     f32) against `forward_train` within 1e-5; `psum_int8` on the card
     bit-equal to the CPU's; and the dry run of every (arch x shape)
     cell, single and multi-pod, against the card's memory.  Then the
     whole script's seconds.
The last two lines are the kernels JSON object and the `{"ok": true, ...}`
result.  Needs `torch` with CUDA, `nvcc`, and `nvidia-smi`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 1 << 20
# The pallas path, the first of four main paths, is cut to 250k keys: with
# four host bulk loads of 1M keys (136-160 s each on an H100 machine's CPU,
# PERF.md §4) the script took 697 s of its 1200 s limit, and it aims at
# half of it.
PALLAS_KEYS = 250_000
# The local-f32 path is cut the same way since the durable path (two 1M
# bulk loads) joined: its bit equality with the plain version stays held
# at the 20k builds.
LOCAL_F32_KEYS = 250_000
# The durable path (two bulk loads: the first build and the recovery's)
# is cut the same way since the sharded path (a 1M bulk load of 8 shards)
# joined; the serve comparison's two indexes take this size too.
DURABLE_KEYS = 250_000
SERVE_COMPARE_KEYS = 250_000
# The sharded path builds its own index of 8 shards: cut the same way
# since phase 14 joined (its 1M host build took 113-170 s); its device-time
# comparison takes the durable path's recovered index over the same keys.
SHARDED_KEYS = 250_000
T_START = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.bounds import (BF16_FLOPS, F32_FLOPS,  # noqa: E402
                                       F64_FLOPS, HBM_BYTES_PER_S,
                                       llm_bounds, train_bounds)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kind(arrs) -> str:
    """The kernel instance these tables are for: "f32" (i32 payloads),
    "f64" (i64) or "f32_i64"."""
    import torch
    if arrs["key"].dtype == torch.float64:
        return "f64"
    return "f32_i64" if arrs["slot_rec"].dtype == torch.int64 else "f32"


def pair(arrs, q, plain: bool = False, ov=None):
    """(val, found) of the kernel instance for these tables (f32/i32, or
    f64/i64 and f32/i64 with the overlay `ov` resolved in the same
    launch), or of its plain version."""
    from repro_torch.kernels.dili_search import (dili_search,
                                                 dili_search_f32_i64,
                                                 dili_search_f64)
    from repro_torch.kernels.ref import (dili_search_ref,
                                         search_with_overlay_ref)
    recs = (arrs["node_rec"], arrs["slot_rec"], arrs["key"], q)
    k = kind(arrs)
    if k != "f32":
        if plain:
            return search_with_overlay_ref(*recs, arrs["root"],
                                           arrs["max_depth"], ov)
        fn = dili_search_f64 if k == "f64" else dili_search_f32_i64
        return fn(*recs, root=arrs["root"], max_depth=arrs["max_depth"],
                  ov=ov)
    if plain:
        return dili_search_ref(*recs, arrs["root"], arrs["max_depth"])
    return dili_search(*recs, root=arrs["root"], max_depth=arrs["max_depth"])


def lane_sets(keys: np.ndarray, rng, device, dtype=np.float32) -> dict:
    """Hits, midpoint misses, +inf / NaN / above-range lanes and a ragged
    777, as `dtype` queries on `device`."""
    import torch
    keys = np.asarray(keys, dtype)
    mids = ((keys[:-1].astype(np.float64) + keys[1:]) / 2).astype(dtype)
    hits = keys[rng.integers(0, len(keys), min(BATCH, len(keys)))]
    above = np.concatenate([np.full(2048, np.inf),
                            [3e9, 1e30, keys[-1] * 2.0, keys[-1] + 1.0,
                             np.finfo(dtype).max, np.nan]])
    sets = dict(hits=hits,
                misses=mids[rng.integers(0, len(mids),
                                         min(BATCH, len(mids)))],
                pad_and_above=above, ragged_777=keys[:777])
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype)).to(
        device) for k, v in sets.items()}


def kernel_vs_plain(arrs, sets: dict, label: str, ov=None) -> float:
    """Bit equality of the kernel and its plain version on every lane set;
    returns the max |difference| seen (0.0 when equal)."""
    import torch
    worst = 0.0
    for name, q in sets.items():
        want = pair(arrs, q, plain=True, ov=ov)
        got = pair(arrs, q, ov=ov)
        for g, w, what in zip(got, want, ("val", "found")):
            diff = (g.long() - w.long()).abs().max().item() if g.numel() else 0
            worst = max(worst, float(diff))
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{label}/{name}: kernel {what} differs "
                                     f"from the plain version on {bad} lanes")
        print(f"  {label}/{name}: {q.numel()} lanes bit-equal, "
              f"{int(want[1].sum())} found", flush=True)
    return worst


def walk_reads(arrs, q, ov=None) -> dict:
    """Replay the kernel (csrc/dili_search.cu) with torch ops on q's device,
    for any instance (the widths come from the tables): the walk, the
    dense probe of every lane that ends at a dense leaf, and with `ov` the
    overlay epilogue's bisection.  Record each load the kernel makes
    (which lanes, which row) and what the function needs of the kernel's
    own tables: each node visited (`bound_of` counts its fields); of
    each slot reached, the key word (4 or 8 bytes),
    which also carries the tag, and the `val` word (4 or 8) of a CHILD or
    of a PAIR equal to the query; the key words the probe compares; the
    overlay key words the bisection compares, and the tomb byte and val
    word of each overlay entry that equals a query.  A slot's key is one
    word whether the slot record or the key column gives it, so
    `key_rows` counts it once.
    Returns the replay's (val, found), the distinct rows of each kind, the
    levels and probes that predict a slot, the lanes that end at a dense
    leaf, the L2 sectors the walk requests under both layouts
    (`sectors`, with the packed records' split by tree level), and per
    level of the walk its lanes and distinct node and slot records
    (`levels`)."""
    import torch
    from repro_torch.core.flat import TAG_CHILD, TAG_PAIR
    from repro_torch.core.search import predict_slot
    from repro_torch.kernels.ref import unpack_tables
    c = unpack_tables(arrs["node_rec"], arrs["slot_rec"], arrs["key"])
    nq, dev = q.numel(), q.device
    out = torch.full((nq,), -1, dtype=c["val"].dtype, device=dev)
    hit = torch.zeros(nq, dtype=torch.bool, device=dev)
    rows = {k: [] for k in ("node", "key", "val", "ov_key", "ov_tomb",
                            "ov_val")}
    loads = []           # (table, level, lanes, rows[, key read, val read])
    per_level = []       # per level: lanes, distinct nodes, distinct slots

    def node_load(lanes, node, level):
        loads.append(("node", level, lanes, node))
        rows["node"].append(node)

    def slot_load(lanes, s, qq, level):
        t = c["tag"][s]
        child, is_pair = t == TAG_CHILD, t == TAG_PAIR
        eq = is_pair & (c["key"][s] == qq)
        loads.append(("slot", level, lanes, s, is_pair, child | eq))
        rows["key"].append(s)
        rows["val"] += [s[child], s[eq]]
        out[lanes[eq]] = c["val"][s[eq]]
        hit[lanes[eq]] = True
        return child

    lanes = torch.arange(nq, device=dev)
    node = torch.full((nq,), int(arrs["root"]), dtype=torch.long, device=dev)
    dense_lanes, dense_nodes = [], []
    levels = 0
    for level in range(arrs["max_depth"]):
        if lanes.numel() == 0:
            break
        node_load(lanes, node, level)
        n_lanes, n_nodes = lanes.numel(), torch.unique(node).numel()
        dn = c["dense"][node] > 0
        dense_lanes.append(lanes[dn])
        dense_nodes.append(node[dn])
        lanes, node = lanes[~dn], node[~dn]
        levels += node.numel()
        qq = q[lanes]
        pos = predict_slot(c["a"][node], c["b"][node], qq, c["fo"][node],
                           c["fused"])
        slot = (c["base"][node] + pos).long()
        child = slot_load(lanes, slot, qq, level)
        per_level.append(dict(lanes=n_lanes, nodes=n_nodes,
                              slots=torch.unique(slot).numel()))
        node = c["val"][slot].long()
        lanes, node = lanes[child], node[child]
    if lanes.numel():                 # out of depth: probed if dense
        node_load(lanes, node, arrs["max_depth"])
        dn = c["dense"][node] > 0
        dense_lanes.append(lanes[dn])
        dense_nodes.append(node[dn])

    # the dense probe, as `_dense_search` and the kernel run it
    L, N = torch.cat(dense_lanes), torch.cat(dense_nodes)
    qq = q[L]
    fo, base = c["fo"][N], c["base"][N]
    m1 = torch.clamp(fo - 1, min=0)
    pred = torch.minimum(torch.clamp(predict_slot(c["a"][N], c["b"][N], qq,
                                                  fo, c["fused"]), min=0),
                         m1)

    def key_load(mask, i):
        r = (base + torch.minimum(torch.clamp(i, min=0), m1)).long()
        loads.append(("key", "probe", L[mask], r[mask]))
        rows["key"].append(r[mask])
        return c["key"][r]

    going_up = key_load(torch.ones_like(L, dtype=torch.bool), pred) < qq
    bound = torch.ones_like(pred)
    active = torch.ones_like(going_up)
    for _ in range(16):
        probe = active & torch.where(going_up, pred + bound < m1,
                                     pred - bound > 0)
        k = key_load(probe, torch.where(going_up, pred + bound, pred - bound))
        active = probe & torch.where(going_up, k < qq, k > qq)
        bound = torch.where(active, bound * 2, bound)
    lo = torch.where(going_up, pred, torch.clamp(pred - bound, min=0))
    hi = torch.where(going_up, torch.minimum(pred + bound, m1), pred)
    for _ in range(16):
        go = lo < hi
        mid = (lo + hi) // 2
        below = key_load(go, mid) < qq
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid, hi)
    slot_load(L, (base + torch.minimum(lo, m1)).long(), qq, "probe")

    if ov is not None:                # the overlay epilogue's bisection
        ok, n = ov["keys"], ov["keys"].numel()
        lo = torch.zeros(nq, dtype=torch.long, device=dev)
        hi = torch.full((nq,), n, dtype=torch.long, device=dev)
        while bool((lo < hi).any()):
            go = lo < hi
            mid = (lo + hi) // 2
            rows["ov_key"].append(mid[go])
            below = ok[torch.clamp(mid, max=n - 1)] < q
            lo = torch.where(go & below, mid + 1, lo)
            hi = torch.where(go & ~below, mid, hi)
        i = torch.clamp(lo, max=n - 1)
        rows["ov_key"].append(i)
        eq = ok[i] == q
        dead = eq & (ov["tomb"][i] > 0)
        live = eq & ~dead
        rows["ov_tomb"].append(i[eq])
        rows["ov_val"].append(i[live])
        out = torch.where(live, ov["vals"][i], out)
        hit = live | (hit & ~dead)

    return dict(pair=(out, hit),
                rows={k: int(torch.unique(torch.cat(v)).numel()) if v else 0
                      for k, v in rows.items()},
                predicts=levels + L.numel(), dense_lanes=L.numel(),
                sectors=l2_sectors(loads, arrs), levels=per_level)


def l2_sectors(loads, arrs) -> dict:
    """L2 sectors the replayed loads request per layout: for each load,
    the distinct 32-byte sectors among the lanes of each warp (32
    consecutive lanes), summed.  `columns` reads one column per field (a
    node: a, b of the key's width, then base, fo, dense of 4 bytes; a
    slot: a 4-byte tag, then the key of a PAIR, of the key's width, and
    the val of a CHILD or hit, of the payload's); `records` reads a node
    as one record and a slot as one record (the kernel's layout: 16 and 8
    bytes at f32/i32, 32 and 16 at f64/i64, 16 and 16 at f32/i64).  Both
    read the dense probe's keys from the key column.  `by_level` splits
    the records' sectors by the walk's level (the dense probe's as
    "probe") into node and slot sectors."""
    import torch
    w = arrs["key"].element_size()
    vw = arrs["slot_rec"].element_size()
    node_b = arrs["node_rec"].shape[1] * arrs["node_rec"].element_size()
    slot_b = arrs["slot_rec"].shape[1] * arrs["slot_rec"].element_size()

    def count(lanes, rows, row_bytes):
        if lanes.numel() == 0:
            return 0
        sector = rows.long() * row_bytes // 32
        return int(torch.unique((lanes.long() // 32) * (1 << 40)
                                + sector).numel())

    cols = recs = 0
    by_level: dict = {}
    for ld in loads:
        table, level, lanes, rows = ld[:4]
        if table == "node":
            cols += 2 * count(lanes, rows, w) + 3 * count(lanes, rows, 4)
            r = count(lanes, rows, node_b)
        elif table == "slot":
            key_read, val_read = ld[4], ld[5]
            cols += (count(lanes, rows, 4)
                     + count(lanes[key_read], rows[key_read], w)
                     + count(lanes[val_read], rows[val_read], vw))
            r = count(lanes, rows, slot_b)
        else:
            cols += count(lanes, rows, w)
            r = count(lanes, rows, w)
        recs += r
        lv = by_level.setdefault(level, dict(node=0, slot=0, key=0))
        lv[table] += r
    return dict(columns=cols, records=recs, by_level=by_level)


def bound_of(rp: dict, arrs, nq: int) -> tuple:
    """(bound ms, bound_by, bytes moved, table bytes read) of one batch:
    the queries in, (val, found) out, and what the replay `rp` says this
    batch needs of the tables and the overlay, each byte once (a node's
    fields, not its record's padding); against the operations, a
    multiply and an add per slot prediction (one fused multiply-add at
    f32/i64 counts as both).  At f32 a node's fields are a, b, base and
    fo; at f64 a and b, since a child's base and fo travel in the key and
    val words of the CHILD slot that names it (counted with the slot),
    and the root's base and fo once."""
    w = arrs["key"].element_size()
    vw = arrs["slot_rec"].element_size()     # the payload's width
    r = rp["rows"]
    node_read = (2 * w * r["node"] + 8 if w == 8
                 else (2 * w + 8) * r["node"])
    table_read = (node_read + w * r["key"] + vw * r["val"]
                  + w * r["ov_key"] + 8 * r["ov_val"] + r["ov_tomb"])
    moved = nq * (w + vw + 1) + table_read
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * rp["predicts"] / (F64_FLOPS if w == 8 else F32_FLOPS) * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", moved,
            table_read)


def truth_lookup(tk: np.ndarray, tv: np.ndarray, q: np.ndarray):
    i = np.clip(np.searchsorted(tk, q), 0, len(tk) - 1)
    hit = tk[i] == q
    return np.where(hit, tv[i], -1), hit


def check_lookup(ix, tk, tv, q, label, f32: bool = True):
    """Lookup through the facade, held against the truth (at f32, on the
    queries as the `pallas` engine casts them); returns its seconds."""
    t0 = time.perf_counter()
    v, f = ix.lookup(q)
    dt = time.perf_counter() - t0
    verify_lookup(v, f, tk, tv, q, label, f32)
    return dt


def verify_lookup(v, f, tk, tv, q, label, f32: bool = True):
    want_v, want_f = truth_lookup(tk, tv, q.astype(np.float32).astype(
        np.float64) if f32 else q)
    if not np.array_equal(f, want_f) or not np.array_equal(v[f], want_v[f]):
        raise AssertionError(f"{label}: lookup disagrees with the truth on "
                             f"{int((f != want_f).sum())} found flags")


def check_range(ix, tk, tv, rng, n=4096, max_hits=128, label="range"):
    starts = rng.integers(0, len(tk) - 300, n)
    lo = tk[starts]
    hi = tk[starts + rng.integers(1, 300, n)]
    ks, vs, cnt = ix.range(lo, hi, max_hits=max_hits)
    s0 = np.searchsorted(tk, lo)
    want_cnt = np.minimum(np.searchsorted(tk, hi) - s0, max_hits)
    if not np.array_equal(cnt, want_cnt):
        raise AssertionError(f"{label}: counts disagree with the truth")
    pos = np.arange(max_hits)[None, :]
    g = np.minimum(s0[:, None] + pos, len(tk) - 1)
    valid = pos < want_cnt[:, None]
    if not (np.array_equal(ks, np.where(valid, tk[g], np.inf))
            and np.array_equal(vs, np.where(valid, tv[g], -1))):
        raise AssertionError(f"{label}: windows disagree with the truth")


def lookup_batches(tk, rng, n_batches: int):
    """2^20-query batches, half hits and half midpoint misses."""
    mids = (tk[:-1] + tk[1:]) / 2
    for _ in range(n_batches):
        yield np.concatenate([tk[rng.integers(0, len(tk), BATCH // 2)],
                              mids[rng.integers(0, len(mids), BATCH // 2)]])


def main_path(n_keys: int, seed: int, device) -> tuple:
    """Build, read, write, flush, read again and list: every answer held
    against a numpy truth.  Returns (index, truth keys, truth vals, info)."""
    from repro_torch.api import IndexConfig, LearnedIndex, manual_merge_policy
    from repro_torch.data.datasets import generate
    rng = np.random.default_rng(seed + 1)
    keys = np.unique(generate("logn", n_keys, seed).astype(np.float32))
    tk = keys.astype(np.float64)
    tv = np.arange(len(tk), dtype=np.int64)
    cfg = IndexConfig(engine="pallas", merge=manual_merge_policy(),
                      overlay_cap=8192, telemetry=True)
    t0 = time.perf_counter()
    ix = LearnedIndex.build(tk, tv, config=cfg, device=device)
    total_s = time.perf_counter() - t0
    spans = ix.metrics()["spans"]
    flatten_s = spans["merge.flatten"]["ms_max"] / 1e3
    upload_s = spans["merge.publish"]["ms_max"] / 1e3
    st = ix.stats()
    info = dict(n_keys=len(tk), build_s=total_s - flatten_s - upload_s,
                flatten_s=flatten_s, upload_s=upload_s,
                table_bytes=st["table_bytes"], max_depth=st["max_depth"])
    print(f"main: built {len(tk)} keys in {total_s:.3f} s (bulk load "
          f"{info['build_s']:.3f} s, flatten {flatten_s:.3f} s, upload "
          f"{upload_s:.3f} s); kernel tables {st['table_bytes']} B, "
          f"max_depth {st['max_depth']}", flush=True)

    lookup_s = [check_lookup(ix, tk, tv, q, "fresh lookup")
                for q in lookup_batches(tk, rng, 3)]
    check_range(ix, tk, tv, rng, label="fresh range")

    # writes: new keys, overwrites, deletes — visible before any merge
    mids = ((tk[:-1] + tk[1:]) / 2).astype(np.float32).astype(np.float64)
    new = np.setdiff1d(np.unique(mids[rng.integers(0, len(mids), 2000)]), tk)
    pick = rng.permutation(len(tk))[:2000]
    over, dead = tk[pick[:1000]], tk[pick[1000:]]
    up_k = np.concatenate([new, over])
    up_v = np.arange(len(up_k), dtype=np.int64) + 50_000_000
    ix.upsert(up_k, up_v)
    ix.delete(dead)
    nk, (nv, nt) = _apply(tk, tv, up_k, up_v, dead)
    tk, tv = nk[nt == 0], nv[nt == 0]
    check_lookup(ix, tk, tv, np.concatenate([up_k, dead, tk[:4096]]),
                 "pending writes")
    check_lookup(ix, tk, tv, next(lookup_batches(tk, rng, 1)),
                 "pending writes batch")
    check_range(ix, tk, tv, rng, label="range over pending writes")
    pending = ix.stats()["pending_writes"]
    print(f"main: {len(up_k)} upserts + {len(dead)} deletes visible before "
          f"the merge ({pending} pending)", flush=True)
    t0 = time.perf_counter()
    ix.flush()
    info["flush_s"] = time.perf_counter() - t0
    lookup_s += [check_lookup(ix, tk, tv, q, "post-flush lookup")
                 for q in lookup_batches(tk, rng, 2)]
    check_lookup(ix, tk, tv, np.concatenate([up_k, dead]), "post-flush")
    check_range(ix, tk, tv, rng, label="post-flush range")
    ik, iv = ix.items()
    if not (np.array_equal(ik, tk) and np.array_equal(iv, tv)):
        raise AssertionError("items() disagrees with the truth")
    print(f"main: flush {info['flush_s']:.3f} s; lookups, ranges and "
          f"items() equal to the truth ({len(tk)} live keys)", flush=True)
    info["lookup_ms"] = [s * 1e3 for s in lookup_s]
    return ix, tk, tv, info


@contextlib.contextmanager
def bulk_load_kept(keep: dict):
    """The local engine's bulk load (Alg. 4, on the host), kept across
    builds inside the block: the first tree built is pickled as it came
    out of `bulk_load`, with its keys, vals and settings (the pickling's
    seconds in keep["pickle_s"]); a later build of the same keys, vals and
    settings gets an unpickled copy of that tree, which is what a second
    bulk load would build, instead of building it again."""
    import pickle
    from repro_torch.online import merge as M
    real = M.bulk_load

    def bulk_load(keys, vals, **kw):
        if "tree" in keep:
            if not (kw == keep["kw"] and np.array_equal(keys, keep["keys"])
                    and np.array_equal(vals, keep["vals"])):
                raise AssertionError("the kept bulk load is of other keys, "
                                     "vals or settings")
            return pickle.loads(keep["tree"])
        tree = real(keys, vals, **kw)
        t0 = time.perf_counter()
        keep.update(keys=np.array(keys), vals=np.array(vals), kw=dict(kw),
                    tree=pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL))
        keep["pickle_s"] = time.perf_counter() - t0
        return tree

    M.bulk_load = bulk_load
    try:
        yield
    finally:
        M.bulk_load = real


def local_path(n_keys: int, seed: int, device, keep: dict) -> tuple:
    """The local engine with the defaults users get: build on f64 logn
    keys, read, write in batches of 1000 under the default merge policy
    (which must merge on its own), flush, read and list, and leave one
    more round of writes pending; every answer held against a numpy
    truth after every write batch.  The bulk load is kept in `keep` for
    the maintenance path (`bulk_load_kept`).  Returns (index, truth keys,
    truth vals, info)."""
    from repro_torch.api import IndexConfig, LearnedIndex
    from repro_torch.data.datasets import generate
    rng = np.random.default_rng(seed + 2)
    tk = generate("logn", n_keys, seed)
    tv = np.arange(len(tk), dtype=np.int64)
    t0 = time.perf_counter()
    with bulk_load_kept(keep):
        ix = LearnedIndex.build(tk, tv, config=IndexConfig(telemetry=True),
                                device=device)
    total_s = time.perf_counter() - t0 - keep["pickle_s"]
    if ix.engine != "local":
        raise AssertionError(f"IndexConfig() built {ix.engine!r}")
    spans = ix.metrics()["spans"]
    flatten_s = spans["merge.flatten"]["ms_max"] / 1e3
    upload_s = spans["merge.publish"]["ms_max"] / 1e3
    st = ix.stats()
    info = dict(n_keys=len(tk), build_s=total_s - flatten_s - upload_s,
                flatten_s=flatten_s, upload_s=upload_s,
                device_bytes=st["device_bytes"], max_depth=st["max_depth"],
                keys=tk, flat=ix._engine.oi.store.flat)
    print(f"local: built {len(tk)} f64 keys in {total_s:.3f} s (bulk load "
          f"{info['build_s']:.3f} s, flatten {flatten_s:.3f} s, upload "
          f"{upload_s:.3f} s); DeviceSnapshot (not uploaded) "
          f"{st['device_bytes']} B, kernel tables "
          f"{ix.kernel_stats['table_bytes']} B, max_depth {st['max_depth']}",
          flush=True)
    lookup_s = [check_lookup(ix, tk, tv, q, "local fresh lookup", f32=False)
                for q in lookup_batches(tk, rng, 2)]
    check_range(ix, tk, tv, rng, label="local fresh range")

    mids = (tk[:-1] + tk[1:]) / 2
    new = np.setdiff1d(mids[rng.integers(0, len(mids), 3200)], tk)
    new = rng.permutation(new)[:3000]
    pick = rng.permutation(len(tk))[:4000]
    over, dead = tk[pick[:1500]], tk[pick[1500:]]
    n_up = 0

    def write(op, keys):
        nonlocal tk, tv, n_up
        if op == "upsert":
            vals = np.arange(len(keys), dtype=np.int64) + 2 ** 40 + n_up
            n_up += len(keys)
            ix.upsert(keys, vals)
            nk, (nv, nt) = _apply(tk, tv, keys, vals, keys[:0])
        else:
            ix.delete(keys)
            nk, (nv, nt) = _apply(tk, tv, keys[:0], tv[:0], keys)
        tk, tv = nk[nt == 0], nv[nt == 0]
        check_lookup(ix, tk, tv, np.concatenate([keys, tk[:4096]]),
                     f"local after {op}", f32=False)
        check_lookup(ix, tk, tv, next(lookup_batches(tk, rng, 1)),
                     f"local batch after {op}", f32=False)
        check_range(ix, tk, tv, rng, label=f"local range after {op}")
        for k in keys[:8]:
            i = np.searchsorted(tk, k)
            want = int(tv[i]) if i < len(tk) and tk[i] == k else None
            if ix.get(k) != want:
                raise AssertionError(f"local get({k!r}) after {op}")
        st = ix.stats()
        print(f"local: {op} of {len(keys)} keys held to the truth; epoch "
              f"{st['epoch']}, {st['pending_writes']} pending, merges "
              f"{st['merge_reasons']}", flush=True)

    for op, keys in (("upsert", new[:1000]), ("upsert", over[:1000]),
                     ("delete", dead[:1000]), ("upsert", new[1000:2000])):
        write(op, keys)
    reasons = ix.stats()["merge_reasons"]
    auto = sum(n for r, n in reasons.items() if r != "flush")
    if auto < 1:
        raise AssertionError(f"the default policy merged no time on its "
                             f"own: {reasons}")
    t0 = time.perf_counter()
    ix.flush()
    info["flush_s"] = time.perf_counter() - t0
    lookup_s += [check_lookup(ix, tk, tv, q, "local post-flush lookup",
                              f32=False) for q in lookup_batches(tk, rng, 2)]
    check_range(ix, tk, tv, rng, label="local post-flush range")
    ik, iv = ix.items()
    if not (np.array_equal(ik, tk) and np.array_equal(iv, tv)):
        raise AssertionError("local items() disagrees with the truth")
    print(f"local: flush {info['flush_s']:.3f} s; lookups, ranges and "
          f"items() equal to the truth ({len(tk)} live keys)", flush=True)
    # one more round, left pending, so that the timed lookups resolve a
    # real overlay (upserts, overwrites and tombstones)
    write("upsert", np.concatenate([new[2000:2500], over[1000:1500]]))
    write("delete", dead[1000:2000])
    st = ix.stats()
    info.update(merge_reasons=st["merge_reasons"],
                merges=ix.maint_timings(), pending=st["pending_writes"],
                lookup_ms=[s * 1e3 for s in lookup_s])
    print(f"local: merge_reasons {st['merge_reasons']}; per merge "
          f"(fold + flatten, upload) s "
          f"{[(round(m['merge_s'], 3), round(m['publish_s'], 3)) for m in info['merges']]}; "
          f"{st['pending_writes']} writes left pending", flush=True)
    return ix, tk, tv, info


def fma_f32_np(a: np.ndarray, b: np.ndarray, q: np.ndarray) -> np.ndarray:
    """a + b*q in f32 with one rounding, in numpy: the exact product in
    f64, the sum with its exact error (TwoSum), and the f32 rounding
    corrected where the f64 sum sits on an f32 midpoint."""
    a64 = a.astype(np.float64)
    p = b.astype(np.float64) * q.astype(np.float64)
    s = a64 + p
    bb = s - a64
    e = (a64 - (s - bb)) + (p - bb)
    with np.errstate(over="ignore", invalid="ignore"):
        r = s.astype(np.float32)
        d = s - r.astype(np.float64)
        nb = np.nextafter(r, np.where(d > 0, np.float32(np.inf),
                                      np.float32(-np.inf)))
        mid = (d != 0) & (s == (r.astype(np.float64) + nb) * 0.5)
    return np.where(mid & (e != 0) & ((e > 0) == (d > 0)), nb, r)


def f32_walk_model(flat, q32: np.ndarray):
    """(val, found) of the reference's f32 `search_batch` over a standard
    build placed in f64, in numpy: models, keys and queries cast to f32,
    each slot predicted as floor(fma(b, q, a)) with XLA's saturating cast
    and the clips (the f32/i64 instance's arithmetic, written again)."""
    from repro_torch.core.flat import TAG_CHILD, TAG_PAIR
    if flat.dense.any():
        raise AssertionError("the f32 walk model covers standard builds")
    a, b = flat.a.astype(np.float32), flat.b.astype(np.float32)
    key = flat.key.astype(np.float32)
    n = np.full(len(q32), flat.root, np.int64)
    val = np.full(len(q32), -1, np.int64)
    found = np.zeros(len(q32), bool)
    live = np.arange(len(q32))
    for _ in range(flat.max_depth):
        if not len(live):
            break
        nn = n[live]
        s = np.floor(fma_f32_np(a[nn], b[nn], q32[live]))
        s = np.nan_to_num(s, nan=0.0, posinf=2.0 ** 31, neginf=-2.0 ** 31)
        slot = flat.base[nn] + np.clip(s, 0, flat.fo[nn] - 1).astype(
            np.int64)
        t = flat.tag[slot]
        hit = (t == TAG_PAIR) & (key[slot] == q32[live])
        found[live[hit]] = True
        val[live[hit]] = flat.val[slot[hit]]
        child = t == TAG_CHILD
        n[live[child]] = flat.val[slot[child]]
        live = live[child]
    return val, found


def check_lookup_f32_local(ix, tk, tv, q, label):
    """A lookup of the local engine at f32, held to two numpy truths: the
    f32 walk model over the published snapshot with the pending writes
    resolved over it decides which lanes are found (the reference misses
    keys there, and so must the port), and every found lane's value is
    the key set's.  Returns (seconds, found share of the lanes whose f32
    query is a live key)."""
    t0 = time.perf_counter()
    v, f = ix.lookup(q)
    dt = time.perf_counter() - t0
    oi = ix._engine.oi
    q32 = q.astype(np.float32)
    ok, ovv, ot = oi.pending_entries()
    sv, sf = f32_walk_model(oi.store.flat, q32)
    ok32 = ok.astype(np.float32)
    i = np.clip(np.searchsorted(ok32, q32), 0, max(len(ok32) - 1, 0))
    eq = (ok32[i] == q32) if len(ok32) else np.zeros(len(q32), bool)
    dead = eq & (ot[i] > 0) if len(ok32) else eq
    alive = eq & ~dead
    want_f = alive | (sf & ~dead)
    want_v = np.where(alive, ovv[i] if len(ok32) else 0, sv)
    if not (np.array_equal(f, want_f) and np.array_equal(v[f], want_v[f])):
        raise AssertionError(f"{label}: lookup disagrees with the f32 walk "
                             f"model on {int((f != want_f).sum())} lanes")
    tv_q, th = truth_lookup(tk, tv, q32.astype(np.float64))
    if not (th[f].all() and np.array_equal(v[f], tv_q[f])):
        raise AssertionError(f"{label}: a found lane's value is not the "
                             f"key set's")
    return dt, float(f[th].mean()) if th.any() else 1.0


def f32_exact_keys(n_keys: int, seed: int) -> np.ndarray:
    """`n_keys` logn keys made exact in f32 (cast and unique), as f64."""
    from repro_torch.data.datasets import generate
    return np.unique(generate("logn", n_keys, seed).astype(
        np.float32)).astype(np.float64)


def local_f32_path(n_keys: int, seed: int, device) -> tuple:
    """The local engine at dtype=float32: build on logn keys made exact in
    f32 (cast and unique), read, write in batches of 1000 under the
    default merge policy (which must merge on its own), flush, read and
    list; lookups held to the f32 walk model and the key set, ranges,
    gets and items() to the key set.  Returns (index, truth keys, truth
    vals, info)."""
    import torch
    from repro_torch.api import IndexConfig, LearnedIndex
    rng = np.random.default_rng(seed + 3)
    tk = f32_exact_keys(n_keys, seed)
    tv = np.arange(len(tk), dtype=np.int64) + 2 ** 36
    t0 = time.perf_counter()
    ix = LearnedIndex.build(tk, tv, config=IndexConfig(
        telemetry=True, dtype=torch.float32), device=device)
    total_s = time.perf_counter() - t0
    spans = ix.metrics()["spans"]
    flatten_s = spans["merge.flatten"]["ms_max"] / 1e3
    upload_s = spans["merge.publish"]["ms_max"] / 1e3
    info = dict(n_keys=len(tk), build_s=total_s - flatten_s - upload_s,
                flatten_s=flatten_s, upload_s=upload_s, hit_share=[])
    print(f"local-f32: built {len(tk)} f32-exact keys in {total_s:.3f} s "
          f"(bulk load {info['build_s']:.3f} s, flatten {flatten_s:.3f} s, "
          f"upload {upload_s:.3f} s); kernel tables "
          f"{ix.kernel_stats['table_bytes']} B, max_depth "
          f"{ix.stats()['max_depth']}", flush=True)
    lookup_s = []

    def lookups(label, n):
        for q in lookup_batches(tk, rng, n):
            dt, share = check_lookup_f32_local(ix, tk, tv, q, label)
            lookup_s.append(dt)
            info["hit_share"].append(share)

    lookups("local-f32 fresh lookup", 2)
    check_range(ix, tk, tv, rng, label="local-f32 fresh range")
    mids = ((tk[:-1] + tk[1:]) / 2).astype(np.float32).astype(np.float64)
    new = rng.permutation(np.setdiff1d(
        mids[rng.integers(0, len(mids), 4000)], tk))[:3000]
    pick = rng.permutation(len(tk))[:2500]
    over, dead = tk[pick[:1000]], tk[pick[1000:]]
    for b, (op, keys) in enumerate((("upsert", new[:1000]),
                                    ("upsert", over),
                                    ("delete", dead[:1000]),
                                    ("upsert", new[1000:2000]),
                                    ("delete", dead[1000:1500]))):
        if op == "upsert":
            vals = np.arange(len(keys), dtype=np.int64) + 2 ** 40 + b * 1000
            ix.upsert(keys, vals)
            nk, (nv, nt) = _apply(tk, tv, keys, vals, keys[:0])
        else:
            ix.delete(keys)
            nk, (nv, nt) = _apply(tk, tv, keys[:0], tv[:0], keys)
        tk, tv = nk[nt == 0], nv[nt == 0]
        check_lookup_f32_local(ix, tk, tv, np.concatenate([keys, tk[:4096]]),
                               f"local-f32 after {op}")
        lookups(f"local-f32 batch after {op}", 1)
        check_range(ix, tk, tv, rng, label=f"local-f32 range after {op}")
        for k in keys[:8]:
            i = np.searchsorted(tk, k)
            want = int(tv[i]) if i < len(tk) and tk[i] == k else None
            if ix.get(k) != want:
                raise AssertionError(f"local-f32 get({k!r}) after {op}")
        st = ix.stats()
        print(f"local-f32: {op} of {len(keys)} keys held to the truths; "
              f"epoch {st['epoch']}, {st['pending_writes']} pending, merges "
              f"{st['merge_reasons']}", flush=True)
    reasons = ix.stats()["merge_reasons"]
    if sum(n for r, n in reasons.items() if r != "flush") < 1:
        raise AssertionError(f"the default policy merged no time on its "
                             f"own: {reasons}")
    t0 = time.perf_counter()
    ix.flush()
    info["flush_s"] = time.perf_counter() - t0
    lookups("local-f32 post-flush lookup", 2)
    check_range(ix, tk, tv, rng, label="local-f32 post-flush range")
    ik, iv = ix.items()
    if not (np.array_equal(ik, tk) and np.array_equal(iv, tv)):
        raise AssertionError("local-f32 items() disagrees with the truth")
    # left pending, so that the timed lookups resolve a real overlay
    ix.upsert(new[2000:2500], np.arange(500, dtype=np.int64) + 2 ** 41)
    ix.delete(dead[1500:])
    nk, (nv, nt) = _apply(tk, tv, new[2000:2500],
                          np.arange(500, dtype=np.int64) + 2 ** 41,
                          dead[1500:])
    tk, tv = nk[nt == 0], nv[nt == 0]
    check_lookup_f32_local(ix, tk, tv, np.concatenate([new, dead]),
                           "local-f32 pending")
    st = ix.stats()
    info.update(merge_reasons=st["merge_reasons"], merges=ix.maint_timings(),
                lookup_ms=[x * 1e3 for x in lookup_s])
    print(f"local-f32: flush {info['flush_s']:.3f} s; ranges and items() "
          f"equal to the truth ({len(tk)} live keys); found share of live "
          f"keys per 2^20 batch {[round(x, 4) for x in info['hit_share']]} "
          f"(the reference's f32 arithmetic, held to the walk model); "
          f"merge_reasons {st['merge_reasons']}; {st['pending_writes']} "
          f"writes left pending", flush=True)
    return ix, tk, tv, info


INSPECT_TREE = {
    "tree": ["depth_hist", "fanout", "max_depth", "n_nodes", "n_pairs",
             "n_slots"],
    "leaves": ["dense_frac", "fill", "n_internal", "n_leaves", "slots"],
    "model_error": ["overall", "per_leaf_mean", "sampled"],
    "segments": ["dirty_fraction", "dirty_rows", "dirty_segments",
                 "incremental", "n_fallback_full", "n_segments", "rows",
                 "total_rows", "total_segments"],
    "heat": ["deletes", "hot_streak", "n_tracked", "writes"],
    "overlay": ["cap", "fill", "live", "pending", "tombstones"],
    "wal": ["armed", "ckpt_bytes", "n_ckpt_files", "n_shards",
            "n_wal_files", "wal_bytes"],
}


# A logn build's splice segments span a few hundred slot rows (at 100k to
# 300k keys: p99 316-494, max 518), under the default re-cluster floor of
# 2048 rows, which suits uniform keys' larger leaves.  The maintenance path
# lowers the floor and the children's size to logn's scale, as the
# reference's own 1M zipfian test sets them for its keys (512 and 128).
RECLUSTER_MIN_ROWS = 256
RECLUSTER_TARGET_PAIRS = 64


def maint_path(n_keys: int, seed: int, device, keep: dict,
               rounds: int = 12) -> dict:
    """Background maintenance on the local engine: build f64 logn keys
    with `IndexConfig(telemetry=True, maintenance=MaintenanceConfig(
    background=True, ...))` (the re-cluster sizes above, the rest
    default) on the local path's bulk load of the same keys (`keep`, see
    `bulk_load_kept`), then `rounds` rounds of 2048 scrambled-zipfian
    upserts (YCSB-A's update draw, theta 0.99) and 500 deletes under the
    default merge policy, each round's lookups held to the numpy truth,
    one batch while a merge may be in flight and one after the worker
    drained; then the flush barrier, items(), the maintenance counters,
    inspect() and the trace.  Returns the numbers it printed."""
    import json as _json
    import tempfile
    from repro_torch.api import IndexConfig, LearnedIndex, MaintenanceConfig
    from repro_torch.data.datasets import generate
    from repro_torch.workloads import (DEFAULT_THETA, ZetaCache,
                                       scatter_ranks, zipfian_ranks)
    rng = np.random.default_rng(seed + 4)
    keys = generate("logn", n_keys, seed)
    tk, tv = keys.copy(), np.arange(len(keys), dtype=np.int64)
    t0 = time.perf_counter()
    with bulk_load_kept(keep):
        ix = LearnedIndex.build(tk, tv, config=IndexConfig(
            telemetry=True, maintenance=MaintenanceConfig(
                background=True, recluster_min_rows=RECLUSTER_MIN_ROWS,
                recluster_target_pairs=RECLUSTER_TARGET_PAIRS)),
            device=device)
    print(f"maint: built {len(tk)} f64 keys with background maintenance in "
          f"{time.perf_counter() - t0:.3f} s on a copy of the local path's "
          f"bulk load", flush=True)
    oi = ix._engine.oi
    ix.start_trace()
    zeta = ZetaCache(DEFAULT_THETA)
    inflight_ms, idle_ms, overlapped = [], [], 0
    for r in range(rounds):
        idx = scatter_ranks(zipfian_ranks(rng, len(keys), 2048,
                                          DEFAULT_THETA, zeta), len(keys))
        up_k = keys[idx]
        up_v = rng.integers(0, 1 << 40, len(up_k))
        dead = tk[rng.integers(0, len(tk), 500)]
        # the truth and the queries first, so that the lookup follows the
        # write that triggers a merge at once: last write wins inside the
        # upsert batch, then the deletes
        last = np.unique(up_k[::-1], return_index=True)[1]
        uk = up_k[::-1][last]
        uv = up_v[::-1][last]
        nk, (nv, nt) = _apply(tk, tv, uk, uv, keys[:0])
        tk, tv = nk[nt == 0], nv[nt == 0]
        nk, (nv, nt) = _apply(tk, tv, keys[:0], tv[:0], np.unique(dead))
        tk, tv = nk[nt == 0], nv[nt == 0]
        q = np.concatenate([next(lookup_batches(tk, rng, 1))[:BATCH - 4096],
                            uk[:2048], np.unique(dead)[:2048]])[:BATCH]
        ix.upsert(up_k, up_v)
        ix.delete(dead)
        # in flight: frozen and queued when the lookup starts (whether it
        # still is when the lookup returns is printed too)
        busy = oi._merging is not None and oi.scheduler.depth > 0
        # the writes pending as this lookup sees them: the frozen overlay
        # (the zipfian upserts, when they started a merge) under the live
        mg = oi._merging
        pending_ov = oi.overlay if mg is None else mg.merged_with(oi.overlay)
        t0 = time.perf_counter()
        v, f = ix.lookup(q)
        dt = time.perf_counter() - t0
        still = busy and oi.scheduler.depth > 0
        verify_lookup(v, f, tk, tv, q, f"maint round {r}", f32=False)
        overlapped += busy
        (inflight_ms if busy else idle_ms).append(dt * 1e3)
        oi.scheduler.drain()
        idle_ms.append(check_lookup(ix, tk, tv, q, f"maint round {r} "
                                    f"drained", f32=False) * 1e3)
        st = ix.stats()
        print(f"maint: round {r}: merges {st['n_merges']} "
              f"(incremental {st['n_incremental_flattens']}, reclusters "
              f"{st['n_reclusters']}, retrains {st['n_retrains']}), "
              f"pending {st['pending_writes']}, lookup started during a "
              f"merge: {busy} (merge still in flight at its end: {still})",
              flush=True)
    if overlapped < 1:
        raise AssertionError("no lookup overlapped a background merge")
    zipf = filter_on_zipf(ix, pending_ov, keys, tk, tv, rng, zeta)
    t0 = time.perf_counter()
    st = ix.flush()
    flush_s = time.perf_counter() - t0
    ix.stop_trace()
    ik, iv = ix.items()
    if not (np.array_equal(ik, tk) and np.array_equal(iv, tv)):
        raise AssertionError("maint items() disagrees with the truth")
    check_lookup(ix, tk, tv, next(lookup_batches(tk, rng, 1)),
                 "maint post-flush", f32=False)
    counters = ix.metrics()["counters"]
    if st["n_incremental_flattens"] < 1:
        raise AssertionError("no incremental flatten")
    if st["n_reclusters"] < 1:
        raise AssertionError("no re-cluster")
    if st["n_forced_full_flattens"] or oi.flattener.n_fallback_full:
        raise AssertionError("a flatten fell back to a full one")
    if st["maint_errors"] or counters.get("maint.errors", 0):
        raise AssertionError(f"maintenance errors: "
                             f"{st['maint_error_logs']}")
    if st["maint_degraded"]:
        raise AssertionError("maintenance degraded to synchronous merges")
    doc = ix.inspect()
    if doc.get("schema") != "dili.inspect/1" or any(
            sorted(doc.get(k, {})) != v for k, v in INSPECT_TREE.items()):
        tree = {k: sorted(v) for k, v in doc.items() if isinstance(v, dict)}
        raise AssertionError(f"inspect() key tree: {tree}")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        ix.dump_trace(path)
        with open(path) as fh:
            trace = _json.load(fh)
    if trace["otherData"].get("schema") != "dili.trace/1":
        raise AssertionError("trace schema")
    spans: dict = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X" and e["name"].startswith("merge."):
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    for name in ("merge.fold", "merge.recluster", "merge.flatten",
                 "merge.publish"):
        if not spans.get(name):
            raise AssertionError(f"the trace holds no {name} span")
    timings = ix.maint_timings()
    dirty = [m["dirty_frac"] for m in timings]
    out = dict(n_keys=len(keys), merges=len(timings),
               incremental=st["n_incremental_flattens"],
               reclusters=st["n_reclusters"], retrains=st["n_retrains"],
               dirty=dirty, dirty_mean=float(np.mean(dirty)),
               stage_ms={k: [round(x, 3) for x in v]
                         for k, v in sorted(spans.items())},
               publish_s=[m["publish_s"] for m in timings],
               inflight_ms=inflight_ms, idle_ms=idle_ms,
               overlapped=overlapped, flush_s=flush_s, zipf=zipf)
    print(f"maint: {out['merges']} merges ({out['incremental']} incremental, "
          f"{out['reclusters']} re-clusters, {out['retrains']} retrains), "
          f"no fallback, no errors; flush {flush_s:.3f} s; items() equal to "
          f"the truth ({len(tk)} live keys); inspect() and the dili.trace/1 "
          f"export hold the expected keys and spans", flush=True)
    print(f"maint: dirty fraction per merge {[round(x, 4) for x in dirty]}, "
          f"mean {out['dirty_mean']:.4f}", flush=True)
    for name, ms in out["stage_ms"].items():
        print(f"maint: {name} ms per merge {ms}", flush=True)
    print(f"maint: publish_s per merge (upload + synchronize, on the worker) "
          f"{[round(x, 4) for x in out['publish_s']]}", flush=True)
    print(f"maint: whole lookup ms (2^20 queries) with a merge in flight "
          f"{[round(x, 3) for x in inflight_ms]} (median "
          f"{np.median(inflight_ms):.3f}); with none "
          f"{[round(x, 3) for x in idle_ms]} (median "
          f"{np.median(idle_ms):.3f})", flush=True)
    ix.close()
    return out


def filter_on_zipf(ix, pending_ov, keys, tk, tv, rng, zeta) -> dict:
    """The overlay filter under YCSB-A's reads on the local engine `ix`,
    once its worker has drained: a 2^20 batch of scrambled-zipfian reads
    of `keys` (theta 0.99, as the updates), held to the truth through
    `lookup`; over the mirror of `pending_ov` (the writes a lookup saw
    pending while a merge was in flight: the frozen zipfian upserts under
    the live deletes, as `_overlay_arrays` builds it), the share of lanes
    whose filter bit is set, and of those equal to a pending key; the f64
    kernel's warm ms on the published tables with the mirror's filter,
    without it and the walk alone (graph replays in turns, each
    bit-equal to the plain version first); and the host ms of building
    the mirror (which the first read after each change to the overlay
    pays) and of its filter alone (built and uploaded).  The launches made
    here are not counted in the path's.  On the CPU (a rehearsal) only
    the shares and host times."""
    import torch
    from repro_torch.kernels import dili_search as D
    from repro_torch.kernels.ref import filter_may_hold
    from repro_torch.online.overlay import overlay_device_arrays
    from repro_torch.workloads import (DEFAULT_THETA, scatter_ranks,
                                       zipfian_ranks)
    oi = ix._engine.oi
    q_np = keys[scatter_ranks(zipfian_ranks(rng, len(keys), BATCH,
                                            DEFAULT_THETA, zeta), len(keys))]
    check_lookup(ix, tk, tv, q_np, "maint zipfian reads", f32=False)
    if oi._merging is not None or oi.scheduler.depth:
        raise AssertionError("a merge is in flight during the filter's "
                             "measurement")
    n0 = D.kernel_f64.launches
    dev = oi.device
    sync = (torch.cuda.synchronize if dev.type == "cuda" else
            (lambda: None))
    build_ms, filter_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        ov = overlay_device_arrays(pending_ov, torch.float64, device=dev)
        ov["filter"] = D.overlay_filter(pending_ov.keys).to(dev)
        sync()
        build_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        D.overlay_filter(pending_ov.keys).to(dev)
        sync()
        filter_ms.append((time.perf_counter() - t0) * 1e3)
    pend, _, tomb = pending_ov.entries()
    share_set = float(filter_may_hold(ov["filter"].cpu().numpy(),
                                      q_np).mean())
    share_eq = float(np.isin(q_np, pend).mean())
    arrs = oi.store.kernel_tables
    q = torch.from_numpy(q_np).to(dev)
    bare = {k: ov[k] for k in ("keys", "vals", "tomb")}
    fns = {"filter": lambda: pair(arrs, q, ov=ov),
           "no_filter": lambda: pair(arrs, q, ov=bare),
           "walk": lambda: pair(arrs, q)}
    for k, fn in fns.items():
        want = pair(arrs, q, plain=True, ov=None if k == "walk" else ov)
        for g, w in zip(fn(), want):
            if not torch.equal(g, w):
                raise AssertionError(f"zipfian reads, {k}: the kernel "
                                     f"differs from the plain version")
    rounds = graph_rounds(fns) if dev.type == "cuda" else {}
    D.kernel_f64.launches = n0
    out = dict(pending=len(pend), share_set=share_set, share_eq=share_eq,
               mirror_host_ms=float(np.median(build_ms)),
               filter_host_ms=float(np.median(filter_ms)),
               kernel_ms={k: float(np.median(v)) for k, v in rounds.items()},
               kernel_spread={k: float(max(v) - min(v))
                              for k, v in rounds.items()})
    print(f"maint: zipfian reads (2^20, theta {DEFAULT_THETA}) over "
          f"{len(pend)} pending writes ({int(np.sum(tomb))} of them "
          f"deletes): filter bit set on {share_set:.4f} of lanes, a pending "
          f"key on {share_eq:.4f}; f64 kernel warm ms, 8 graph replays of "
          f"25 in turns: "
          + "; ".join(f"{k} {[round(x, 5) for x in v]} (median "
                      f"{np.median(v):.5f})" for k, v in rounds.items())
          + f"; host ms per overlay change (median of 5): the mirror "
          f"{out['mirror_host_ms']:.4f}, its filter alone (built and "
          f"uploaded) {out['filter_host_ms']:.4f}", flush=True)
    return out


# the port's crash child and its oracle: tests/test_torch_crash.py, which
# imports no JAX at module level
CRASH_KIT = ROOT / "tests" / "test_torch_crash.py"


def _dir_bytes(d: str) -> tuple:
    b = n = 0
    for root, _dirs, files in os.walk(d):
        for f in files:
            b += os.path.getsize(os.path.join(root, f))
            n += 1
    return b, n


def _load_crash_kit():
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_crash_kit",
                                                  CRASH_KIT)
    kit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kit)
    return kit


def durable_path(n_keys: int, seed: int, device) -> tuple:
    """Durability on the local engine: build f64 logn keys with
    `IndexConfig(telemetry=True, durability=DurabilityConfig(dir=<a fresh
    temporary directory>))` (fsync "interval", a checkpoint after every
    merge publish, 3 kept; the default merge policy), drive YCSB-A
    (`generate_stream`, 32768 ops in batches of 1024) through
    `WorkloadRunner.run_kill_recover`: every batch held to the oracle,
    the index abandoned at half the stream (no final fsync), recovered on
    `device`, and the stream finished on the recovered index; then a
    2^20-query lookup batch through the recovered index held to the
    oracle, and the port's crash child killed at three points and
    recovered on `device`.  Any divergence raises.  Returns the recovered
    index's kernel tables, overlay mirror and that batch on the device
    (the sharded path's one-launch comparison over the same keys)."""
    import json as _json
    import shutil
    import tempfile
    from repro_torch.api import DurabilityConfig, IndexConfig, LearnedIndex
    from repro_torch.data.datasets import generate
    from repro_torch.workloads import PRESETS, WorkloadRunner, generate_stream
    import torch
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 5)
    tk = generate("logn", n_keys, seed)
    tv = np.arange(len(tk), dtype=np.int64)
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    try:
        dur_dir = os.path.join(root, "dur")
        cfg = IndexConfig(telemetry=True,
                          durability=DurabilityConfig(dir=dur_dir))
        # every build of this path (the first, and the one recovery makes
        # from the checkpoint) is timed, its flatten and upload from the
        # new index's spans
        builds = []
        real_build = LearnedIndex.build.__func__

        def timed_build(cls, *a, **kw):
            t0 = time.perf_counter()
            ix = real_build(cls, *a, **kw)
            total = time.perf_counter() - t0
            sp = ix.metrics()["spans"]
            builds.append(dict(
                n=len(ix.items()[0]), total_s=total,
                flatten_s=sp["merge.flatten"]["ms_max"] / 1e3,
                upload_s=sp["merge.publish"]["ms_max"] / 1e3))
            return ix

        LearnedIndex.build = classmethod(timed_build)
        try:
            ix = LearnedIndex.build(tk, tv, config=cfg, device=device)
            spec = PRESETS["ycsb_a"].scaled(n_ops=32768, batch_size=1024)
            batches = generate_stream(spec, tk)
            ops = [b.op for b in batches]
            print(f"durable: built {len(tk)} f64 keys in "
                  f"{builds[0]['total_s']:.3f} s with durability armed; "
                  f"ycsb_a stream of {len(batches)} batches "
                  f"({ops.count('lookup')} lookup, {ops.count('upsert')} "
                  f"upsert), killed at batch {len(batches) // 2}",
                  flush=True)
            runner = WorkloadRunner(ix)
            ix.start_trace()
            out = runner.run_kill_recover(batches, kill_at=len(batches) // 2,
                                          spec=spec)
            ix.stop_trace()
        finally:
            LearnedIndex.build = classmethod(real_build)
        rx = runner.index
        reasons = (ix.stats()["merge_reasons"], rx.stats()["merge_reasons"])
        if out["n_divergences"] or out["post_recovery_divergences"]:
            raise AssertionError(f"durable: divergences {out}")
        if rx.device.type != dev.type or rx.engine != "local":
            raise AssertionError(f"durable: recovered onto {rx.engine} on "
                                 f"{rx.device}")
        m = rx.metrics()
        rec = {s: m["spans"][f"recovery.{s}"]["ms_max"]
               for s in ("load", "replay", "publish")}
        rb = builds[1]
        rebuild_bulk_s = rb["total_s"] - rb["flatten_s"] - rb["upload_s"]
        pre, post = out["pre"], out["post"]
        n_merges_pre, n_merges_post = pre["n_merges"], post["n_merges"]
        print(f"durable: 0 divergences through {len(batches)} batches "
              f"(kill at {out['kill_at_batch']}); merges {n_merges_pre} "
              f"before the kill {reasons[0]}, {n_merges_post} on the "
              f"recovered index {reasons[1]}; "
              f"recovery_s {out['recovery_s']:.3f} (load {rec['load']:.1f} "
              f"ms, replay {rec['replay']:.1f} ms, publish "
              f"{rec['publish']:.1f} ms), replayed "
              f"{out['replayed_records']} records; the recovery's build of "
              f"{rb['n']} keys {rb['total_s']:.3f} s (bulk load "
              f"{rebuild_bulk_s:.3f} s, flatten {rb['flatten_s']:.3f} s, "
              f"upload {rb['upload_s']:.3f} s)", flush=True)
        up_ms = {leg: (o["latency_ms"]["upsert"]["ms_p50"],
                       o["latency_ms"]["upsert"]["ms_p99"],
                       o["op_counts"]["upsert"] // spec.batch_size)
                 for leg, o in (("pre", pre), ("post", post))}
        trace_path = os.path.join(root, "trace.json")
        ix.dump_trace(trace_path)
        with open(trace_path) as fh:
            doc = _json.load(fh)
        dur_us = {}
        for e in doc["traceEvents"]:
            if e["ph"] == "X":
                dur_us.setdefault(e["name"], []).append(e["dur"])
        n_wal, n_up = len(dur_us["wal.append"]), len(dur_us["op.upsert"])
        if n_wal != n_up:
            raise AssertionError(f"durable: {n_wal} wal.append events for "
                                 f"{n_up} upserts")
        wal_share = sum(dur_us["wal.append"]) / sum(dur_us["op.upsert"])
        print(f"durable: upsert batch ms p50/p99 before the kill "
              f"{up_ms['pre'][0]:.3f}/{up_ms['pre'][1]:.3f} "
              f"({up_ms['pre'][2]} batches), after recovery "
              f"{up_ms['post'][0]:.3f}/{up_ms['post'][1]:.3f} "
              f"({up_ms['post'][2]} batches); wal.append share of upsert "
              f"time {wal_share:.4f} ({n_wal} appends, median "
              f"{np.median(dur_us['wal.append']) / 1e3:.3f} ms)", flush=True)
        # the upsert time that no span covers: the checkpoint after each
        # merge publish, and the overlay write
        merge_us = sum(sum(dur_us.get(f"merge.{k}", ()))
                       for k in ("fold", "flatten", "publish"))
        rest_ms = (sum(dur_us["op.upsert"]) - sum(dur_us["wal.append"])
                   - merge_us) / 1e3
        print(f"durable: trace of the first leg, ms (count): "
              f"{ {k: (round(sum(v) / 1e3, 3), len(v)) for k, v in sorted(dur_us.items())} }; "
              f"upsert time outside wal.append and merge.fold/flatten/"
              f"publish {rest_ms:.3f} ms",
              flush=True)

        # a 2^20-query batch through the recovered index, held to the oracle
        ok, ov = runner.oracle.items()
        q = next(lookup_batches(ok, rng, 1))
        rx.lookup(q)
        lookup_s = [check_lookup(rx, ok, ov, q, "durable recovered",
                                 f32=False) for _ in range(5)]
        lookup_ms = float(np.median(lookup_s)) * 1e3
        wal_doc = rx.inspect()["wal"]
        if not wal_doc["armed"]:
            raise AssertionError("durable: the recovered index's WAL is not "
                                 "armed")
        dir_b, dir_n = _dir_bytes(dur_dir)
        print(f"durable: recovered lookup of 2^20 queries equal to the "
              f"oracle, median of five {lookup_ms:.4f} ms; inspect wal "
              f"{wal_doc}; directory {dir_b} B in {dir_n} files",
              flush=True)
        oi = rx._engine.oi
        timing = (oi.store.kernel_tables, oi._overlay_arrays(),
                  torch.from_numpy(q).to(dev))
        rx.close()
        del ix, rx, runner

        # the port's crash child, killed on the card at three points
        kit = _load_crash_kit()
        points = [("wal.append", kit.FLUSH_AFTER_OPS + 3),
                  ("wal.mid_record", kit.FLUSH_AFTER_OPS + 1),
                  ("ckpt.mid_publish", 2)]
        t0 = time.perf_counter()
        crash = kit.run_matrix("local", os.path.join(root, "crash"),
                               device=dev.type, points=points)
        crash_s = time.perf_counter() - t0
        print(f"durable: crash child killed (-9) at {len(crash)} points and "
              f"recovered on {dev.type}, items() and kernel lookups "
              f"equal to the oracle, in {crash_s:.1f} s: "
              f"{[(r['point'], r['hits'], r['replayed_records']) for r in crash]}",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return timing


SHARDS = 8


def sharded_path(n_keys: int, seed: int, device, local_timing=None) -> dict:
    """The sharded engine on one card: `IndexConfig(engine="sharded",
    n_shards=8, telemetry=True)` (the default merge policy) on f64 logn
    keys (the local path's); 2^20-query lookups on the gather strategy,
    then on a2a a uniform batch and a batch skewed into shard 0 (which
    overflows and must come back exact through the gather fallback),
    4096 range queries, writes in batches of 1000, a flush and `items()`,
    each held against a numpy truth; one shard's tables with the combined
    overlay held to the plain version bit for bit; graph-timed device ms
    of one lookup's per-shard launches against `local_timing` (a local
    index's tables, overlay and 2^20 batch over the same keys: the
    durable path's recovered index, one launch).  Returns the numbers it
    printed."""
    from dataclasses import replace
    import torch
    from repro_torch.api import IndexConfig, LearnedIndex
    from repro_torch.core import distributed as D
    from repro_torch.data.datasets import generate
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.dili_search import kernel_f64
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 6)
    tk = generate("logn", n_keys, seed)
    tv = np.arange(len(tk), dtype=np.int64)
    cfg = IndexConfig(engine="sharded", n_shards=SHARDS, telemetry=True)
    t0 = time.perf_counter()
    ix = LearnedIndex.build(tk, tv, config=cfg, device=device)
    build_s = time.perf_counter() - t0
    eng = ix._engine
    st = ix.stats()
    if (ix.engine, st["n_shards"]) != ("sharded", SHARDS):
        raise AssertionError(f"built {ix.engine!r} on {st['n_shards']} "
                             f"shards")
    shard_bytes = [K.table_bytes(t) for t in eng.arrs["kernel"]]
    print(f"sharded: built {len(tk)} f64 keys on {SHARDS} shards in "
          f"{build_s:.3f} s; kernel tables per shard {shard_bytes} B "
          f"(sum {sum(shard_bytes)}), stacked pair tables "
          f"{eng.arrs['pair_key'].nbytes + eng.arrs['pair_val'].nbytes} B; "
          f"the reference's column layout (stats' device_bytes) "
          f"{st['device_bytes']} B; max_depth {st['max_depth']}",
          flush=True)

    def counted_lookup(q, label):
        before, ks0 = kernel_f64.launches, dict(ix.kernel_stats)
        dt = check_lookup(ix, tk, tv, q, label, f32=False)
        ks1 = ix.kernel_stats
        return dt, kernel_f64.launches - before, {
            k: ks1[k] - ks0[k] for k in ("lookups", "launches", "lanes",
                                         "a2a_fallbacks")}

    gather = [counted_lookup(q, "sharded gather lookup")
              for q in lookup_batches(tk, rng, 3)]
    print(f"sharded gather: 2^20-query lookups equal to the truth; host ms "
          f"{[round(g[0] * 1e3, 3) for g in gather]}; kernel launches per "
          f"lookup {[g[1] for g in gather]} (stats {gather[-1][2]})",
          flush=True)
    if dev.type == "cuda":                   # a CPU rehearsal skips it
        q_np = next(lookup_batches(tk, rng, 1))
        device_breakdown(lambda: ix.lookup(q_np))

    # a2a on the same index (its config's strategy swapped in)
    a2a_cfg = replace(cfg, lookup_strategy="a2a")
    eng.cfg = ix.config = a2a_cfg
    q_uni = next(lookup_batches(tk, rng, 1))
    qd = torch.from_numpy(q_uni).to(dev)
    ova = D.combined_overlay_arrays(eng.sd, torch.float64, dev)
    _, _, ovf_uni = D.sharded_lookup(eng.arrs, qd, strategy="a2a",
                                     overlay=ova)
    uni = counted_lookup(q_uni, "sharded a2a uniform lookup")
    lo_shard = tk[tk < eng.sd.boundaries[1]]
    q_skew = lo_shard[rng.integers(0, len(lo_shard), 1 << 16)]
    _, _, ovf_skew = D.sharded_lookup(
        eng.arrs, torch.from_numpy(q_skew).to(dev), strategy="a2a",
        overlay=ova)
    skew = counted_lookup(q_skew, "sharded a2a skewed lookup")
    if int(ovf_skew.sum()) == 0 or skew[2]["a2a_fallbacks"] != 1:
        raise AssertionError(f"the skewed a2a batch did not overflow into "
                             f"the gather fallback: {ovf_skew.tolist()}, "
                             f"{skew[2]}")
    print(f"sharded a2a: uniform 2^20 batch overflow per source "
          f"{ovf_uni.tolist()} (fallbacks {uni[2]['a2a_fallbacks']}), "
          f"host {uni[0] * 1e3:.3f} ms, {uni[1]} launches; skewed batch of "
          f"{len(q_skew)} into shard 0 overflow per source "
          f"{ovf_skew.tolist()}, answered exactly through the gather "
          f"fallback ({skew[1]} launches, host {skew[0] * 1e3:.3f} ms)",
          flush=True)
    eng.cfg = ix.config = cfg
    check_range(ix, tk, tv, rng, label="sharded range")

    # writes under the default policy, then a flush and items()
    mids = (tk[:-1] + tk[1:]) / 2
    new = rng.permutation(np.setdiff1d(mids[rng.integers(0, len(mids),
                                                         3300)], tk))
    pick = rng.permutation(len(tk))[:3000]
    over, dead = tk[pick[:1500]], tk[pick[1500:]]
    n_up = 0

    def write(op, keys):
        nonlocal tk, tv, n_up
        if op == "upsert":
            vals = np.arange(len(keys), dtype=np.int64) + 2 ** 41 + n_up
            n_up += len(keys)
            ix.upsert(keys, vals)
            nk, (nv, nt) = _apply(tk, tv, keys, vals, keys[:0])
        else:
            ix.delete(keys)
            nk, (nv, nt) = _apply(tk, tv, keys[:0], tv[:0], keys)
        tk, tv = nk[nt == 0], nv[nt == 0]
        check_lookup(ix, tk, tv, np.concatenate([keys, tk[:4096]]),
                     f"sharded after {op}", f32=False)

    for op, keys in (("upsert", new[:1000]), ("upsert", over[:1000]),
                     ("delete", dead[:1000])):
        write(op, keys)
    check_lookup(ix, tk, tv, next(lookup_batches(tk, rng, 1)),
                 "sharded batch over pending writes", f32=False)
    check_range(ix, tk, tv, rng, label="sharded range over pending writes")
    st = ix.stats()
    print(f"sharded: 3000 writes held to the truth; per-shard pending "
          f"{st['per_shard_pending']}, epoch {st['epoch']}, merges "
          f"{st['n_merges']}", flush=True)
    t0 = time.perf_counter()
    ix.flush()
    flush_s = time.perf_counter() - t0
    check_lookup(ix, tk, tv, next(lookup_batches(tk, rng, 1)),
                 "sharded post-flush lookup", f32=False)
    check_range(ix, tk, tv, rng, label="sharded post-flush range")
    ik, iv = ix.items()
    if not (np.array_equal(ik, tk) and np.array_equal(iv, tv)):
        raise AssertionError("sharded items() disagrees with the truth")
    print(f"sharded: flush {flush_s:.3f} s ({ix.maint_timings()[-1]}); "
          f"lookups, ranges and items() equal to the truth ({len(tk)} live "
          f"keys)", flush=True)
    # writes left pending, then shard 0's tables with the combined overlay
    write("upsert", np.concatenate([new[1000:1500], over[1000:1500]]))
    write("delete", dead[1000:1500])
    # the path's launches end here: the comparison with the plain version
    # and the timing below do not count
    launches = kernel_f64.launches
    ova = D.combined_overlay_arrays(eng.sd, torch.float64, dev)
    shard0_tables = dict(eng.arrs["kernel"][0],
                         max_depth=eng.arrs["max_depth"])
    shard0 = tk[tk < eng.sd.boundaries[1]]
    print(f"f64 kernel vs plain at shard 0 of 8 ({len(shard0)} live keys) "
          f"with the combined {ova['keys'].numel()}-entry overlay:",
          flush=True)
    max_err = kernel_vs_plain(shard0_tables, lane_sets(shard0, rng, dev,
                                                   np.float64),
                              "sharded-shard0", ov=ova)

    # device time: one lookup's per-shard launches, graph-timed, against
    # the local path's one launch over a batch of the same keys
    out = dict(max_err=max_err, build_s=build_s, launches=launches,
               gather_ms=[g[0] * 1e3 for g in gather],
               launches_per_lookup=gather[-1][1])
    if local_timing is not None:
        l_arrs, l_ov, q = local_timing
        owner = D._owners(eng.arrs["boundaries"], q, SHARDS)
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=SHARDS + 1).tolist()
        qs = q[order]
        offs = np.concatenate([[0], np.cumsum(counts)])
        slices = [qs[offs[r]: offs[r + 1]] for r in range(SHARDS)
                  if counts[r]]
        shards = [r for r in range(SHARDS) if counts[r]]

        def sharded_launches():
            for r, s in zip(shards, slices):
                D._search_shard(eng.arrs, r, s, ova, None)

        def whole_batch_launches():
            # the reference's shape: every shard searches every lane
            for r in range(SHARDS):
                D._search_shard(eng.arrs, r, q, ova, None)

        rounds = graph_rounds({"sharded": sharded_launches,
                               "local": lambda: pair(l_arrs, q, ov=l_ov)})
        whole = graph_rounds({"whole": whole_batch_launches}, rounds=3,
                             reps=5)["whole"]
        out.update(sharded_dev_ms=float(np.median(rounds["sharded"])),
                   local_dev_ms=float(np.median(rounds["local"])),
                   whole_dev_ms=float(np.median(whole)))
        print(f"sharded device time of one 2^20-query gather lookup: the "
              f"{len(shards)} per-shard launches {out['sharded_dev_ms']:.5f} "
              f"ms (rounds {[round(x, 5) for x in rounds['sharded']]}) "
              f"against the durable path's recovered local index's one "
              f"launch over the same batch "
              f"{out['local_dev_ms']:.5f} ms (rounds "
              f"{[round(x, 5) for x in rounds['local']]}); lanes per shard "
              f"{counts[:SHARDS]}; every shard over the whole batch, as the "
              f"reference's shard_map body searches, "
              f"{out['whole_dev_ms']:.5f} ms (rounds "
              f"{[round(x, 5) for x in whole]})", flush=True)
    ix.close()
    return out


class Recorder:
    """The index as a `ServeFrontend`'s batcher sees it: each facade call
    is passed on and its answer kept, in commit order."""

    def __init__(self, ix):
        self.ix = ix
        self.answers = []

    @property
    def telemetry(self):
        return self.ix.telemetry

    def lookup(self, q):
        out = self.ix.lookup(q)
        self.answers.append(out)
        return out

    def range(self, lo, hi, max_hits):
        out = self.ix.range(lo, hi, max_hits=max_hits)
        self.answers.append(out)
        return out

    def upsert(self, keys, vals):
        self.ix.upsert(keys, vals)
        self.answers.append(None)

    def delete(self, keys):
        self.ix.delete(keys)
        self.answers.append(None)


class Served:
    """A served run's recorded answers handed to `WorkloadRunner` in
    commit order, so that its oracle checks each answer the clients got
    against the content the journal's prefix defines: `items()` is the
    content before serving at the runner's start and the served index's
    after it."""

    def __init__(self, start_items, recorder):
        self.start = start_items
        self.rec = recorder
        self.i = 0
        self.engine = recorder.ix.engine

    def items(self):
        if self.start is not None:
            start, self.start = self.start, None
            return start
        return self.rec.ix.items()

    def _next(self):
        self.i += 1
        return self.rec.answers[self.i - 1]

    def lookup(self, q):
        return self._next()

    def range(self, lo, hi, max_hits):
        return self._next()

    def upsert(self, keys, vals):
        self._next()

    def delete(self, keys):
        self._next()

    def stats(self):
        return self.rec.ix.stats()


SERVE_START_RATE = 4000.0        # the reference's benchmarks/run.py
SERVE_LEG_S = 2.0
SERVE_REQ_OPS = 16
SERVE_CLIENTS = 4
SERVE_LEG_MAX_OPS = 20_000
# a measured leg holds at least this many lookup requests, so that its p99
# is the 10th-slowest lookup and not the slowest
SERVE_TAIL_LOOKUPS = 1000
SERVE_KEEP_UP = 0.9              # saturation_search's keep_up_frac
SERVE_SHED_TOL = 0.01            # and its shed_tol


def _leg_ops(rate: float) -> int:
    return int(np.clip(rate * SERVE_LEG_S, 1000, SERVE_LEG_MAX_OPS))


def _held(rep) -> bool:
    """Whether a leg kept up with its offered rate, by saturation_search's
    own test."""
    return (rep.achieved_ops_per_s >= SERVE_KEEP_UP * rep.offered_ops_per_s
            and rep.shed_frac <= SERVE_SHED_TOL)


def _leg_line(rep) -> str:
    """A leg's requests per op, offered and achieved rates, whether it
    held, shed share and per-op p50/p99."""
    lat = rep.latency_ms()
    return (f"{rep.n_reqs} requests ("
            + ", ".join(f"{v['count']} {op}" for op, v in lat.items())
            + f"), offered {rep.offered_ops_per_s:.1f} ops/s, achieved "
            f"{rep.achieved_ops_per_s:.1f} "
            f"({'held' if _held(rep) else 'fell behind'}), shed "
            f"{rep.shed_frac:.4f}: "
            + "; ".join(f"{op} p50/p99 {v['ms_p50']:.3f}/{v['ms_p99']:.3f} "
                        f"ms" for op, v in lat.items()))


class StreamTap:
    """One YCSB-A stream consumed front to back, regenerated with the next
    seed when it runs dry (the reference's `_StreamTap`)."""

    def __init__(self, keys, seed):
        self.keys, self.seed = keys, seed
        self._refill()

    def _refill(self):
        from repro_torch.workloads import PRESETS, generate_stream
        spec = PRESETS["ycsb_a"].scaled(n_ops=SERVE_LEG_MAX_OPS,
                                        batch_size=SERVE_REQ_OPS,
                                        seed=self.seed)
        self.batches = generate_stream(spec, self.keys)
        self.seed += 1
        self.i = 0

    def take(self, n_ops: int = 0, n_lookups: int = 0) -> list:
        """The next requests, until they hold `n_ops` ops and `n_lookups`
        lookup requests."""
        out, got, looks = [], 0, 0
        while got < n_ops or looks < n_lookups:
            if self.i >= len(self.batches):
                self._refill()
            b = self.batches[self.i]
            self.i += 1
            out.append(b)
            got += b.n_ops
            looks += b.op == "lookup"
        return out


def _lat(rep, op="lookup") -> tuple:
    lat = rep.latency_ms().get(op, {})
    return lat.get("ms_p50", float("nan")), lat.get("ms_p99", float("nan"))


def serve_path(ix, seed: int) -> dict:
    """Serve the local path's index through `ServeFrontend`: 4 open-loop
    client threads, 16-op YCSB-A requests, the reference's ramp
    (`saturation_search` from 4000 ops/s, 2 s legs, doubling), then two
    measured legs of at least `SERVE_TAIL_LOOKUPS` lookup requests each at
    50% and 80% of the ramp's best achieved rate.  Each leg is reported
    with its request counts and whether it held its offered rate; the
    sustained rate is the highest offered rate of a leg that held.  Every
    facade answer is recorded in commit order and replayed through
    `WorkloadRunner`'s oracle against the journal (zero divergences, and
    the final content equal).  Returns the numbers."""
    from repro_torch.serve import (ServeConfig, ServeFrontend, open_loop,
                                   saturation_search)
    from repro_torch.workloads import WorkloadRunner
    start = ix.items()
    keys = start[0]
    rec = Recorder(ix)
    fe = ServeFrontend(rec, ServeConfig(), journal=True)
    tap = StreamTap(keys, seed + 11)
    t0 = time.perf_counter()
    best, ramp = saturation_search(
        fe, lambda leg: tap.take(_leg_ops(SERVE_START_RATE * 2.0 ** leg)),
        SERVE_START_RATE, factor=2.0, max_legs=7, n_clients=SERVE_CLIENTS,
        keep_up_frac=SERVE_KEEP_UP, shed_tol=SERVE_SHED_TOL)
    legs = {}
    for frac in (0.5, 0.8):
        legs[frac] = open_loop(fe, tap.take(n_lookups=SERVE_TAIL_LOOKUPS),
                               frac * best, n_clients=SERVE_CLIENTS,
                               timeout_s=300.0)
    serve_s = time.perf_counter() - t0
    journal = fe.journal_batches()
    stats = fe.stats()
    fe.close()
    if len(journal) != len(rec.answers):
        raise AssertionError(f"serve: {len(journal)} journal batches for "
                             f"{len(rec.answers)} facade calls")
    t0 = time.perf_counter()
    rep = WorkloadRunner(Served(start, rec), verify_writes=False).run(
        journal, name="serve,ycsb_a")
    replay_s = time.perf_counter() - t0
    if rep.divergences or rep.n_ops != stats["completed_ops"]:
        raise AssertionError(f"serve: {len(rep.divergences)} divergences, "
                             f"{rep.n_ops} ops replayed of "
                             f"{stats['completed_ops']}")
    for r in ramp:
        print(f"serve ramp leg: {_leg_line(r)}", flush=True)
    held = [r.offered_ops_per_s for r in ramp + list(legs.values())
            if _held(r)]
    sustained = max(held) if held else float("nan")
    out = dict(ramp_best=best, sustained=sustained,
               batch_ops_mean=stats["batch_ops_mean"],
               shed_frac=stats["shed_frac"], journal=len(journal))
    for frac, r in legs.items():
        print(f"serve leg at {int(frac * 100)}% of the ramp's best achieved "
              f"rate: {_leg_line(r)}", flush=True)
        lat = r.latency_ms()
        out[f"leg_{int(frac * 100)}"] = dict(
            n_reqs=r.n_reqs, offered=r.offered_ops_per_s,
            achieved=r.achieved_ops_per_s, held=_held(r),
            **{op: (v["count"], v["ms_p50"], v["ms_p99"])
               for op, v in lat.items()})
    print(f"serve: the ramp's best achieved rate {best:.1f} ops/s "
          f"(saturation_search's return; {sum(map(_held, ramp))} of its "
          f"{len(ramp)} legs held); the highest offered rate a leg held "
          f"{sustained:.1f} ops/s; mean coalesced batch "
          f"{stats['batch_ops_mean']:.2f} ops over {stats['n_batches']} "
          f"batches; shed share {stats['shed_frac']:.5f}; the journal's "
          f"{len(journal)} batches ({rep.n_ops} ops) replayed through the "
          f"oracle in {replay_s:.1f} s: 0 divergences, final items() "
          f"equal; serving took {serve_s:.1f} s", flush=True)
    return out


def serve_compare_path(n_keys: int, seed: int, device) -> dict:
    """Background against synchronous maintenance under the same offered
    load, on the even-integer universe of `n_keys` keys and the
    reference's serving config (`benchmarks/run.py::_serve_index`:
    sample_stride=4, overlay_cap=8192, `MaintenanceConfig(background=
    True|False)`).  The reference's ramp runs on an index of its own with
    background maintenance; then a fresh index of each mode serves the
    same YCSB-A requests (at least `SERVE_TAIL_LOOKUPS` lookup requests)
    at 0.8 of the ramp's best achieved rate, as the reference builds a
    fresh index for each mode.  Lookup p50/p99 of each and their ratio."""
    from repro_torch.api import IndexConfig, LearnedIndex, MaintenanceConfig
    from repro_torch.serve import (ServeConfig, ServeFrontend, open_loop,
                                   saturation_search)
    keys = np.arange(0, 2 * n_keys, 2, dtype=np.float64)

    def build(bg: bool):
        t0 = time.perf_counter()
        ix = LearnedIndex.build(keys, config=IndexConfig(
            sample_stride=4, overlay_cap=8192,
            maintenance=MaintenanceConfig(background=bg)), device=device)
        return ix, time.perf_counter() - t0

    ramp_ix, _ = build(True)
    fe = ServeFrontend(ramp_ix, ServeConfig(), journal=False)
    tap = StreamTap(keys, seed + 13)
    best, ramp = saturation_search(
        fe, lambda leg: tap.take(_leg_ops(SERVE_START_RATE * 2.0 ** leg)),
        SERVE_START_RATE, factor=2.0, max_legs=7, n_clients=SERVE_CLIENTS,
        keep_up_frac=SERVE_KEEP_UP, shed_tol=SERVE_SHED_TOL)
    fe.close()
    ramp_ix.close()
    for r in ramp:
        print(f"serve compare ramp leg (background): {_leg_line(r)}",
              flush=True)
    rate = 0.8 * best
    out = dict(ramp_best=best, rate=rate, n_keys=n_keys)
    for label, bg in (("background", True), ("sync", False)):
        ix, build_s = build(bg)
        cfe = ServeFrontend(ix, ServeConfig(), journal=False)
        ctap = StreamTap(keys, seed + 1531)       # the same stream for both
        before = ix.stats()["n_merges"]
        rep = open_loop(cfe, ctap.take(n_lookups=SERVE_TAIL_LOOKUPS), rate,
                        n_clients=SERVE_CLIENTS, timeout_s=240.0)
        cfe.close()
        ix.flush()
        p50, p99 = _lat(rep)
        out[label] = dict(p50=p50, p99=p99, n_reqs=rep.n_reqs,
                          achieved=rep.achieved_ops_per_s, held=_held(rep),
                          shed=rep.shed_frac, n_ops=rep.n_ops,
                          merges=ix.stats()["n_merges"] - before)
        print(f"serve compare, maintenance={label} (fresh index, build "
              f"{build_s:.1f} s), at 0.8 of the ramp's best achieved rate "
              f"{best:.1f}: {rep.n_ops} ops, merges "
              f"{out[label]['merges']}; {_leg_line(rep)}", flush=True)
        ix.close()
    out["p99_sync_over_background"] = out["sync"]["p99"] / out[
        "background"]["p99"]
    print(f"serve compare: lookup p99 sync / background "
          f"{out['p99_sync_over_background']:.3f} (the JAX package's CPU "
          f"run in BENCH_PR2.json: 557.6 / 61.4 ms = 9.08 at 12,377 ops/s)",
          flush=True)
    return out


# The competitors phase holds each competitor to the same torch code on
# the CPU on a sample of the timed batch (the full batch would take LIPP's
# plain walk minutes on the host).
COMPETITOR_SAMPLE = 1 << 16


def _nbytes(x) -> int:
    """Bytes of every tensor in a (nested) device state."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.nbytes
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


# The reference's PGM bounds its upper level's error at the segment start
# keys only, so a query past the last start key of an upper-level segment
# extrapolates that segment's model: at 1M logn keys 892 keys (0.09%) are
# never found, by the reference as by the port.  Its found lanes are held
# to the truth, and all its lanes to the same torch code on the CPU.
INEXACT = ("PGM",)


def _held_to_truth(label, v, f, want_v, want_f, exact: bool) -> int:
    """Every found lane is a key with its value; an exact index finds
    every key.  Returns the hits missed."""
    f = f.cpu().numpy()
    v = v.cpu().numpy().astype(np.int64)
    wrong = int((f & (~want_f | (v != want_v))).sum())
    missed = int((want_f & ~f).sum())
    if wrong or (exact and missed):
        raise AssertionError(f"competitors/{label}: {wrong} found lanes "
                             f"wrong and {missed} hits missed against the "
                             f"truth")
    return missed


def _kernel_profile(fn) -> tuple:
    """(kernels one call of `fn` runs on the card, their device µs, the
    three longest by name as (µs, count, name)), from torch.profiler's
    CUDA events with copies and memsets left out; (nan, nan, []) when not
    measured."""
    _, by_name = device_events(fn, reps=1)
    kernels = {name: row for name, row in by_name.items()
               if not name.startswith(("Memcpy", "Memset"))}
    if not kernels:
        return float("nan"), float("nan"), []
    top = sorted(((us, n, name) for name, (us, n) in kernels.items()),
                 reverse=True)[:3]
    return (float(sum(n for _, n in kernels.values())),
            sum(us for us, _ in kernels.values()), top)


def _competitor_batch(keys: np.ndarray, rng, device) -> dict:
    """One key set's 2^20-lane batch (half hits, half midpoint misses,
    repeated where the key set has fewer), its numpy truth, and the
    sample the CPU comparison reads."""
    import torch
    vals = np.arange(len(keys), dtype=np.int64)
    sets = lane_sets(keys, rng, "cpu", np.float64)
    half = BATCH // 2
    q_cpu = torch.cat([x.repeat(-(-half // len(x)))[:half]
                       for x in (sets["hits"], sets["misses"])])
    pick = torch.from_numpy(rng.choice(BATCH, COMPETITOR_SAMPLE,
                                       replace=False))
    return dict(keys=keys, vals=vals, sets=sets, q_cpu=q_cpu,
                q=q_cpu.to(device),
                want=truth_lookup(keys, vals, q_cpu.numpy()),
                qs_cpu=torch.cat([q_cpu[pick], sets["pad_and_above"]]))


def competitors_path(keys: np.ndarray, flat, dili_build_s: float,
                     seed: int, device, card: str,
                     lipp_keys: np.ndarray) -> dict:
    """The paper's competitors (section 7.1; Tables 4 and 5, Fig. 6a)
    beside DILI on the local path's keys, whose bulk load's `flat` (built
    in `dili_build_s`, flatten included) gives the DILI row; LIPP, whose
    host build is the slowest, on `lipp_keys` (the local-f32 path's
    249,228 keys since PR 20, to keep the script inside its time limit)
    with a batch of its own.  Each is built on the host (payload =
    position), and one 2^20-lane batch (half hits, half midpoint misses)
    is looked up through each, every lane held to a numpy truth (PGM's
    found lanes only, `INEXACT`): that is the path the launch count
    reads.  Then each is held to the same torch
    code on the CPU (vals, found, probes) on a sample of the batch and
    the pad-and-above lanes (PGM on the whole batch), LIPP's kernel and
    DILI's to their plain versions, and each row is timed: ms per 2^20
    lanes on the graph timer, one lookup on the host clock with numpy in
    and out, kernel launches a lookup (profiler) and mean probes.  DILI's
    row is the f64/i64 walk alone (no overlay), with its traversal's
    mean nodes plus probes."""
    import torch
    from repro_torch.core import search as S
    from repro_torch.core.baselines import ALL_BASELINES
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.dili_search import dili_search_f64, kernel_f64
    rng = np.random.default_rng(seed + 11)
    base = _competitor_batch(keys, rng, device)
    lipp_b = _competitor_batch(lipp_keys, rng, device)

    rows = {}
    for B in ALL_BASELINES:
        b = lipp_b if B.name == "LIPP" else base
        n = len(b["keys"])
        t0 = time.perf_counter()
        st = B.build(b["keys"], b["vals"])
        build_s = time.perf_counter() - t0
        dst = B.device(st, device=device)
        rows[B.name] = dict(B=B, st=st, dev=dst, build_s=build_s, b=b,
                            bytes=_nbytes(dst), lookup=B.lookup)
        kern = (f" ({K.table_bytes(dst['kernel']) / n:.3f} in the "
                f"kernel tables; the column tables serve the probe count)"
                if "kernel" in dst else "")
        print(f"competitors: {B.name} built on the host on {n} keys in "
              f"{build_s:.3f} s, {_nbytes(dst) / n:.3f} device "
              f"B/key{kern}", flush=True)

    def dili_lookup(st, q):
        k = st["kernel"]
        return dili_search_f64(k["node_rec"], k["slot_rec"], k["key"], q,
                               root=k["root"], max_depth=k["max_depth"])

    dili = dict(kernel=K.kernel_arrays(flat, device, torch.float64,
                                       torch.int64))
    rows["DILI"] = dict(dev=dili, build_s=dili_build_s, b=base,
                        bytes=K.table_bytes(dili["kernel"]),
                        lookup=dili_lookup)

    # the path: one 2^20-lane lookup through each, held to the truth
    for name, r in rows.items():
        out = r["lookup"](r["dev"], r["b"]["q"])
        r["missed"] = _held_to_truth(name, out[0], out[1], *r["b"]["want"],
                                     exact=name not in INEXACT)
        if name != "DILI":
            r["probes"] = float(out[2].double().mean())
    launches = kernel_f64.launches
    cols = S.device_arrays(flat, torch.float64, device=device)
    _, _, nodes, probes = S.search_batch(cols, base["q"], with_stats=True)
    rows["DILI"]["probes"] = float((nodes + probes).double().mean())
    del cols, nodes, probes
    print(f"competitors: {len(rows)} rows held to the truth on {BATCH} "
          f"lanes ({int(base['want'][1].sum())} hits; LIPP's "
          f"{int(lipp_b['want'][1].sum())}); f64 kernel launches "
          f"{launches}", flush=True)

    # the same torch code on the CPU, and the kernels' plain versions
    for name, r in rows.items():
        if name == "DILI":
            continue
        b = r["b"]
        qc = (torch.cat([b["q_cpu"], b["sets"]["pad_and_above"]])
              if name in INEXACT else b["qs_cpu"])
        want = r["B"].lookup(r["B"].device(r["st"], device="cpu"), qc)
        got = r["lookup"](r["dev"], qc.to(device))
        for g, w, what in zip(got, want, ("vals", "found", "probes")):
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
                raise AssertionError(f"competitors/{name}: {what} on the "
                                     f"card differ from the CPU port")
        print(f"  competitors/{name}: {qc.numel()} lanes bit-equal to the "
              f"CPU port", flush=True)
    max_err = max(
        kernel_vs_plain(rows["LIPP"]["dev"]["kernel"],
                        {"sample": lipp_b["qs_cpu"].to(device),
                         "timed_2^20": lipp_b["q"]}, "LIPP"),
        kernel_vs_plain(dili["kernel"], {"sample": base["qs_cpu"].to(
            device)}, "DILI"))

    # the numbers
    fns = {name: (lambda r=r: r["lookup"](r["dev"], r["b"]["q"]))
           for name, r in rows.items()}
    lipp = rows["LIPP"]["dev"]
    graph = graph_rounds({**fns, "LIPP walk": lambda: dili_lookup(
        lipp, lipp_b["q"])})
    lipp_walk_ms = float(np.median(graph["LIPP walk"]))
    print(f"competitors on {card}: LIPP's walk alone, one f64/i64 launch, "
          f"{lipp_walk_ms:.5f} ms per 2^20 lanes on its {len(lipp_keys)} "
          f"keys (max_depth {lipp['kernel']['max_depth']}, DILI's "
          f"{flat.max_depth} on {len(keys)}); the "
          f"rest of its row is its probe count's stats walk, every lane "
          f"on every one of max_depth rounds", flush=True)
    for name, r in rows.items():
        r["ms"] = float(np.median(graph[name]))
        q_np = r["b"]["q_cpu"].numpy()
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = r["lookup"](r["dev"], torch.from_numpy(q_np).to(device))
            out = [x.cpu().numpy() for x in out]
            host.append((time.perf_counter() - t0) * 1e3)
        r["host_ms"] = float(np.median(host))
        r["launches"], busy_us, top = _kernel_profile(fns[name])
        print(f"competitors on {card}: {name:6s} {r['ms']:.5f} ms per 2^20 "
              f"lanes (graph), host {r['host_ms']:.3f} ms, "
              f"{r['launches']:.0f} launches a lookup, mean probes "
              f"{r['probes']:.4f}, {r['bytes'] / len(r['b']['keys']):.3f} "
              f"device B/key over {len(r['b']['keys'])} keys, build "
              f"{r['build_s']:.3f} s, hits missed {r['missed']}", flush=True)
        print(f"  {name}: kernels busy {busy_us:.1f} us (profiler); "
              f"longest: " + "; ".join(f"{us:.1f} us in {n} x {k[:60]}"
                                       for us, n, k in top), flush=True)
    order = sorted(rows, key=lambda k: rows[k]["ms"])
    print(f"competitors: graph-timed order, fastest first: "
          f"{' < '.join(order)}; by mean probes: "
          f"{' < '.join(sorted(rows, key=lambda k: rows[k]['probes']))}",
          flush=True)
    return dict(launches=launches, max_err=max_err, order=order)


LLM_ARCH = "granite-8b"          # the launcher's default architecture
LLM_STEPS = 4                    # greedy decode steps of the reduced archs
LLM_ATOL = 1e-4                  # reduced archs' f32 logits, card vs CPU
LLM_DECODE_RTOL = 2e-2           # tests/test_models.py's decode property
LLM_SERVE_ARGV = ["--arch", LLM_ARCH, "--requests", "16", "--batch", "8",
                  "--prompt-len", "32", "--tokens", "8",
                  "--frontend-threads", "4"]
LLM_TIMED_STEPS = 16             # decode steps between two CUDA events


def llm_inputs(cfg, B: int, S: int, seed: int, device) -> tuple:
    """Tokens [B, S] and the frontend stubs (vlm patches, whisper frames)
    from a numpy seed, on `device`."""
    import torch
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["extra_embeds"] = rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        kw["enc_frames"] = rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return (torch.from_numpy(tokens).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in kw.items()})


def reduced_archs() -> dict:
    """Each assigned architecture's reduced config (f32)."""
    from repro_torch.configs import get_config, list_archs
    return {a: get_config(a).reduced() for a in list_archs()}


def llm_reduced_vs_cpu(seed: int, device, cfgs: dict) -> float:
    """Each reduced config of `cfgs` (name -> config, f32), weights from
    the port's seeded init on the CPU moved to `device`: prefill of
    [2, 12] and LLM_STEPS greedy decode steps there and on the CPU.
    Greedy tokens must be equal and every logit within LLM_ATOL.  Returns
    the largest gap."""
    import torch
    from repro_torch.models import model as MDL
    from repro_torch.train import step as STEP
    B, S = 2, 12
    worst = 0.0
    for arch, cfg in cfgs.items():
        runs = []
        for d in ("cpu", device):
            model = MDL.init_params(cfg, torch.Generator().manual_seed(seed),
                                    device="cpu").to(d)
            tokens, kw = llm_inputs(cfg, B, S, seed, d)
            max_len = S + LLM_STEPS + 1 + (cfg.frontend_seq
                                           if cfg.family == "vlm" else 0)
            cache = MDL.make_cache(cfg, B, max_len, device=d)
            toks, logits = STEP.greedy(model, cfg, dict(tokens=tokens, **kw),
                                       cache, LLM_STEPS)
            runs.append((toks.cpu(), [lg.cpu() for lg in logits]))
        (t_cpu, l_cpu), (t_dev, l_dev) = runs
        err = max(float((a - b).abs().max()) for a, b in zip(l_cpu, l_dev))
        print(f"  {arch} reduced ({cfg.family}): tokens "
              f"{t_dev[0].tolist()}, max |logit gap| {err:.3e}", flush=True)
        if not torch.equal(t_cpu, t_dev):
            raise AssertionError(f"{arch}: greedy tokens on {device} "
                                 f"{t_dev.tolist()} != CPU {t_cpu.tolist()}")
        if not err <= LLM_ATOL:
            raise AssertionError(f"{arch}: logits on {device} differ from "
                                 f"the CPU's by {err} > {LLM_ATOL}")
        worst = max(worst, err)
    return worst


def llm_serve(argv, tables: list) -> dict:
    """`repro_torch.launch.serve.main(argv)`, held to what it must give:
    every admitted session resolved (the launcher raises otherwise) to the
    KV slot its admit returned, finite logits, tokens in [0, vocab) and no
    shed session op.  Each batch's session ids, with the session table's
    kernel tables and overlay mirror as its lookup read them, go to
    `tables`."""
    from repro_torch.launch import serve as LS

    def on_lookup(sessions, ids):
        oi = sessions.index._engine.oi
        tables.append((oi.store.kernel_tables, oi._overlay_arrays(),
                       sessions.index._pad_batch(len(ids)), list(ids)))

    rep = LS.main(argv, on_lookup=on_lookup)
    cfg, gen = rep["cfg"], rep["generated"]
    for b in rep["slots"]:
        if not np.array_equal(b["resolved"], b["admitted"]):
            raise AssertionError(f"sessions {b['ids']} resolved to KV slots "
                                 f"{b['resolved']}, admitted to "
                                 f"{b['admitted']}")
    if not rep["logits_finite"]:
        raise AssertionError("the served logits are not all finite")
    if not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"served tokens outside [0, {cfg.vocab})")
    if rep["frontend"]["shed_ops"]:
        raise AssertionError(f"the front-end shed "
                             f"{rep['frontend']['shed_ops']} session ops")
    return rep


def llm_numbers(rep: dict, seed: int, device, card: str,
                profiled: tuple = (2, 4)) -> dict:
    """The served model's weight bytes and memory, prefill of [8, 32] and
    decode ms per step on CUDA events (each beside its bound), and where
    the time of `profiled` = (prefills, decode steps) run under
    torch.profiler goes (0: not profiled)."""
    import torch
    from repro_torch.models import model as MDL
    from repro_torch.train import step as STEP
    model, cfg = rep["model"], rep["cfg"]
    B, P = 8, 32
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, P)).astype(np.int32)).to(device)
    cache = MDL.make_cache(cfg, B, P + 3 * LLM_TIMED_STEPS, device=device)
    prefill = STEP.make_prefill_step(cfg)
    decode = STEP.make_decode_step(cfg)
    batch = dict(tokens=prompts)
    for _ in range(2):
        prefill(model, batch, cache)
    prefill_ms = cuda_ms(lambda: prefill(model, batch, cache), 5)
    n_pre, n_dec = profiled
    p_wall_us, p_by_name = (device_events(lambda: prefill(model, batch,
                                                          cache), reps=n_pre)
                            if n_pre else (0.0, {}))
    p_busy_us = sum(us for us, _ in p_by_name.values())
    logits, cache = prefill(model, batch, cache)
    st = dict(tok=torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32),
              cache=cache)

    def step():
        st["tok"], _, st["cache"] = decode(model, st["tok"], st["cache"])

    for _ in range(3):
        step()
    pos = st["cache"]["pos"]
    decode_ms = cuda_ms(step, LLM_TIMED_STEPS)
    wall_us, by_name = (device_events(step, reps=n_dec) if n_dec
                        else (0.0, {}))
    busy_us = sum(us for us, _ in by_name.values())
    launches = sum(c for _, c in by_name.values()) / max(n_dec, 1)
    bd = llm_bounds(model, cfg, B, P, pos + LLM_TIMED_STEPS // 2)
    out = dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
               bounds=bd,
               decode_busy_ms=busy_us / (n_dec * 1e3) if by_name else None,
               decode_idle=1 - busy_us / wall_us if by_name else None,
               decode_launches=launches if by_name else None,
               prefill_idle=1 - p_busy_us / p_wall_us if p_by_name else None)
    print(f"llm numbers on {card} ({cfg.name}, {cfg.n_layers} layers, "
          f"{cfg.dtype}): weights {bd['weight_bytes']} B; prefill of "
          f"[{B}, {P}] {prefill_ms:.3f} ms (bound {bd['prefill']['ms']:.3f} "
          f"ms by {bd['prefill']['by']}: {bd['prefill']['bytes']} B, "
          f"{bd['prefill']['ops']} ops); decode {decode_ms:.3f} ms a step on "
          f"CUDA events over {LLM_TIMED_STEPS} steps from position {pos} "
          f"(bound "
          f"{bd['decode']['ms']:.3f} ms by {bd['decode']['by']}: "
          f"{bd['decode']['bytes']} B over {HBM_BYTES_PER_S:.3g} B/s, "
          f"{bd['decode']['ops']} ops, {bd['decode']['elementwise_ops']} "
          f"f32 element-wise ops; {decode_ms / bd['decode']['ms']:.2f}x "
          f"the bound)", flush=True)
    if p_by_name:
        entries = sum(c for _, c in p_by_name.values()) / n_pre
        print(f"  prefill: device busy {p_busy_us / (n_pre * 1e3):.3f} ms of "
              f"{p_wall_us / (n_pre * 1e3):.3f} ms wall (idle "
              f"{out['prefill_idle']:.4f}), {entries:.0f} device entries",
              flush=True)
    if by_name:
        print(f"  decode step: device busy {out['decode_busy_ms']:.3f} ms of "
              f"{wall_us / (n_dec * 1e3):.3f} ms wall (idle "
              f"{out['decode_idle']:.4f}), {launches:.0f} device entries a "
              f"step (over {n_dec} under torch.profiler); top:", flush=True)
        for name, (us, c) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            print(f"    {us / (n_dec * 1e3):9.3f} ms  x{c / n_dec:.0f}  "
                  f"{name[:80]}", flush=True)
    else:
        print("  decode step breakdown: not measured (three profiler "
              "sessions saw no device events)", flush=True)
    return out


def llm_decode_property(cfg, seed: int, device) -> float:
    """The reference's decode property (tests/test_models.py) on `cfg`:
    prefill of 20 tokens and one decode step give the last token the full
    forward's logits within LLM_DECODE_RTOL.  Returns the relative gap."""
    import torch
    from repro_torch.models import model as MDL
    model = MDL.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    B, S = 2, 21
    tokens, _ = llm_inputs(cfg, B, S, seed, device)
    with torch.no_grad():
        full, _ = MDL.forward_train(model, cfg, tokens)
    cache = MDL.make_cache(cfg, B, S + 3, device=device)
    _, cache = MDL.prefill(model, cfg, tokens[:, :S - 1], cache)
    lg, _ = MDL.decode_step(model, cfg, tokens[:, S - 1:S], cache)
    rel = float((full[:, -1] - lg[:, 0]).abs().max()) \
        / (float(full[:, -1].abs().max()) + 1e-9)
    print(f"  decode against the full forward, {cfg.name} at d_model "
          f"{cfg.d_model}, {cfg.n_layers} layers, {cfg.dtype}: relative gap "
          f"{rel:.3e} (limit {LLM_DECODE_RTOL})", flush=True)
    if not rel < LLM_DECODE_RTOL:
        raise AssertionError(f"decode differs from the full forward by "
                             f"{rel} relative")
    del model
    return rel


def llm_path(seed: int, device, card: str) -> dict:
    """Phase 12 (see the module docstring); the f64 kernel's launches are
    counted over the launcher's run alone."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.dili_search import (kernel, kernel_f32_i64,
                                                 kernel_f64)
    t12 = time.perf_counter()
    # card results are held to CPU ones: no TF32 in f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    print("llm: the six reduced archs (f32), prefill and "
          f"{LLM_STEPS} greedy decode steps, card against CPU:", flush=True)
    llm_err = llm_reduced_vs_cpu(seed, device, reduced_archs())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    tables = []
    rep = llm_serve(LLM_SERVE_ARGV, tables)
    launches = kernel_f64.launches
    if launches == 0:
        raise AssertionError("the llm serve path launched the f64 kernel no "
                             "time")
    # the f64/i64 kernel at this path's shapes: the session table's tables
    # and overlay as each batch's lookup read them, its ids padded as the
    # facade pads them, and the ids alone
    print(f"f64 kernel vs plain on the session table ({len(tables)} decode "
          f"batches):", flush=True)
    max_err = 0.0
    for i, (arrs, ov, lanes, ids) in enumerate(tables):
        q = torch.tensor(ids + ids[:1] * (lanes - len(ids)),
                         dtype=torch.float64, device=device)
        max_err = max(max_err, kernel_vs_plain(
            arrs, {f"batch{i}_padded": q, f"batch{i}_ids": q[:len(ids)]},
            "sessions", ov=ov))
    del tables
    held = torch.cuda.memory_allocated() - mem0
    fe, cfg = rep["frontend"], rep["cfg"]
    print(f"llm serve on {card}: {cfg.name} at full width, {cfg.n_layers} "
          f"layers, {cfg.dtype}: {len(rep['generated'])} requests x "
          f"{rep['generated'].shape[1]} tokens, every session resolved, "
          f"logits finite, tokens in [0, {cfg.vocab}); init "
          f"{rep['init_s']:.3f} s; served in {rep['serve_s']:.3f} s "
          f"({rep['tok_per_s']:.1f} tok/s); {held} B held after serving; "
          f"front-end {fe['accepted_ops']} ops in {fe['n_batches']} batches, "
          f"shed share {fe['shed_ops'] / max(fe['accepted_ops'], 1):.4f}; "
          f"f64 kernel launches {launches} (f32: {kernel.launches}, "
          f"f32/i64: {kernel_f32_i64.launches})", flush=True)
    out = llm_numbers(rep, seed, device, card)
    print(f"llm memory: peak allocated {torch.cuda.max_memory_allocated()} B "
          f"over serving and timing", flush=True)
    del rep
    torch.cuda.empty_cache()
    rel = llm_decode_property(dataclasses.replace(
        get_config(LLM_ARCH), n_layers=2, dtype="float32"), seed, device)
    print(f"llm: phase {time.perf_counter() - t12:.1f} s; reduced archs' "
          f"largest logit gap {llm_err:.3e}, full-width decode's relative "
          f"gap {rel:.3e}", flush=True)
    return dict(out, launches=launches, max_err=max_err)


TRAIN_ARCH = "granite-8b"
TRAIN_LAYERS = 16                # of granite-8b's 36: AdamW's state must fit
TRAIN_STEPS = 6                  # full-width steps; one more is profiled
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the launcher's and the example's defaults
TRAIN_RTOL = 1e-4                # reduced archs card vs CPU (of each max)
TRAIN_ACCUM_LOSS_RTOL = 1e-5     # tests/test_train.py's accumulation
TRAIN_ACCUM_NORM_RTOL = 1e-4     # property, loss and grad norm
TRAIN_RESUME_RTOL = 1e-5         # resumed against uninterrupted (of max)


def _train_batch(cfg, B: int, S: int, seed: int, device) -> dict:
    """Tokens and labels [B, S] (with the frontend stubs), from a numpy
    seed, with a leading accumulation axis when the config accumulates."""
    import torch
    rng = np.random.default_rng(seed)
    lead = (cfg.accum_steps,) if cfg.accum_steps > 1 else ()
    b = dict(tokens=rng.integers(0, cfg.vocab, lead + (B, S)),
             labels=rng.integers(0, cfg.vocab, lead + (B, S)))
    if cfg.family == "vlm":
        b["extra_embeds"] = rng.standard_normal(
            lead + (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["enc_frames"] = rng.standard_normal(
            lead + (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _rel_gap(a, b) -> float:
    """max |a - b| over max |b| (0 when both are 0)."""
    scale = float(b.abs().max())
    gap = float((a.float() - b.float()).abs().max())
    return gap / scale if scale else gap


def train_reduced_vs_cpu(seed: int, device, cfgs: dict) -> dict:
    """Phase 13a: each reduced config of `cfgs` (name -> config, f32) with
    remat off, weights from the port's seeded init on the CPU moved to
    `device`: one step's loss, grad norm and every gradient leaf there and
    on the CPU, then 3 AdamW train steps' losses.  Every gap is relative
    (to the CPU's value, or to the leaf's largest |g|) and must be within
    TRAIN_RTOL.  Returns the largest gaps."""
    import dataclasses
    import torch
    from repro_torch.models import model as MDL
    from repro_torch.train import optim as O
    from repro_torch.train import step as STEP
    worst = dict(loss=0.0, grad_norm=0.0, grad=0.0, steps=0.0)
    for arch, cfg in cfgs.items():
        cfg = dataclasses.replace(cfg, remat="none")
        runs = []
        for d in ("cpu", device):
            model = MDL.init_params(cfg, torch.Generator().manual_seed(seed),
                                    device="cpu").to(d).requires_grad_(True)
            tree = MDL.param_tree(model)
            b = _train_batch(cfg, 2, 12, seed, d)
            mb = {k: v[0] for k, v in b.items()} if cfg.accum_steps > 1 \
                else b
            loss = MDL.loss_fn(model, cfg, mb["tokens"], mb["labels"],
                               extra_embeds=mb.get("extra_embeds"),
                               enc_frames=mb.get("enc_frames"))
            grads = torch.autograd.grad(loss, O.tree_tensors(tree))
            norm = O.global_norm({"g": list(grads)})
            opt = O.adamw(lr=1e-3)
            state = dict(params=model, opt=opt.init(tree),
                         step=torch.zeros((), dtype=torch.int32, device=d))
            step = STEP.make_train_step(cfg, opt)
            losses = []
            for i in range(3):
                state, m = step(state, _train_batch(cfg, 2, 12, seed + 1 + i,
                                                    d))
                losses.append(float(m["loss"]))
            runs.append((float(loss.detach()), float(norm),
                          [g.cpu() for g in grads], losses))
        (l0, n0, g0, s0), (l1, n1, g1, s1) = runs
        gaps = dict(loss=abs(l1 - l0) / abs(l0), grad_norm=abs(n1 - n0) / n0,
                    grad=max(_rel_gap(a, b) for a, b in zip(g1, g0)),
                    steps=max(abs(a - b) / abs(b) for a, b in zip(s1, s0)))
        print(f"  {arch} reduced ({cfg.family}): loss {l1:.6f}, grad norm "
              f"{n1:.6f}; relative gaps: loss {gaps['loss']:.3e}, grad "
              f"norm {gaps['grad_norm']:.3e}, largest gradient leaf "
              f"{gaps['grad']:.3e}; 3 AdamW steps' losses "
              f"{[round(x, 6) for x in s1]}, gap {gaps['steps']:.3e}",
              flush=True)
        for k, v in gaps.items():
            if not v <= TRAIN_RTOL:
                raise AssertionError(f"{arch}: {k} on {device} differs from "
                                     f"the CPU's by {v} > {TRAIN_RTOL}")
            worst[k] = max(worst[k], v)
    return worst


def store_lookups_vs_plain(lookups: list, device) -> float:
    """The f64/i64 kernel against its plain version on each record store
    lookup `train_full` kept: its tables and overlay, its keys padded as
    the facade pads them, and the keys alone."""
    import torch
    print(f"f64 kernel vs plain on the record store ({len(lookups)} "
          f"lookups):", flush=True)
    max_err = 0.0
    for i, (arrs, ov, lanes, picks) in enumerate(lookups):
        q = torch.from_numpy(np.concatenate(
            [picks, np.full(max(lanes - len(picks), 0), picks[0])])).to(
                device)
        max_err = max(max_err, kernel_vs_plain(
            arrs, {f"lookup{i}_padded": q, f"lookup{i}": q[:len(picks)]},
            "store", ov=ov))
    return max_err


def _example_module(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_full(cfg, seed: int, device, card: str,
               profile: bool = True) -> dict:
    """Phase 13b: `cfg` (granite-8b at full width, TRAIN_LAYERS layers;
    phase 14 the ssm and hybrid models), bf16, remat `dots`, the
    launcher's AdamW and cosine schedule, batches from `StorePipeline`
    over a `RecordStore` on the card (the training example's `build_store`
    at the config's vocab).  Each store lookup's tables, overlay and keys
    are kept for the kernel comparison; the f64/i64 kernel's launches are
    counted by the caller over this function.  With `profile`, one more
    step runs under torch.profiler."""
    import torch
    from repro_torch.data.pipeline import StorePipeline
    from repro_torch.train import optim as O
    from repro_torch.train import step as STEP
    t0 = time.perf_counter()
    store, keys = _example_module("train_lm_torch").build_store(
        cfg, device=device)
    store_s = time.perf_counter() - t0
    lookups = []
    plain_lookup = store.lookup

    def recorded(picks):
        oi = store.index._engine.oi
        lookups.append((oi.store.kernel_tables, oi._overlay_arrays(),
                        store.index._pad_batch(len(picks)),
                        np.asarray(picks, np.float64)))
        return plain_lookup(picks)

    store.lookup = recorded
    pipe = StorePipeline(store, keys, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH)
    opt = O.adamw(lr=3e-3, schedule=O.cosine_schedule(3e-3, 20,
                                                      TRAIN_STEPS))
    marks = []

    def marked_update(g, s, p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return opt.update(g, s, p)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = STEP.init_state(cfg, opt, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state["params"]
    # the first layer's first weight matrix (granite's wq, a Mamba's w_in)
    watched = next(p for p in model.layers[0].parameters() if p.dim() == 2)
    before = watched.detach().clone()
    step_fn = STEP.make_train_step(cfg, O.Optimizer(opt.init, marked_update))
    rows = []
    for step in range(TRAIN_STEPS):
        b = pipe.batch_at(step)
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step_fn(state, batch)
        e1.record()
        rows.append((e0, marks[-1], e1, m))
    torch.cuda.synchronize()
    losses = [float(m["loss"]) for *_, m in rows]
    norms = [float(m["grad_norm"]) for *_, m in rows]
    step_ms = [a.elapsed_time(c) for a, _, c, _ in rows]
    fb_ms = [a.elapsed_time(b) for a, b, _, _ in rows]
    opt_ms = [b.elapsed_time(c) for _, b, c, _ in rows]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    if torch.equal(watched, before):
        raise AssertionError("the weights did not change")
    del before, watched
    nxt = {}

    def profiled():
        b = pipe.batch_at(TRAIN_STEPS)
        nxt["state"], nxt["m"] = step_fn(
            state, {k: torch.from_numpy(v).to(device) for k, v in b.items()})

    wall_us, by_name = (device_events(profiled, reps=1) if profile
                        else (0.0, {}))
    peak = torch.cuda.max_memory_allocated()
    bd = train_bounds(model, cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ)
    # steps 2-6: the first one also loads the kernels and warms cuBLAS
    out = dict(init_s=init_s, store_s=store_s, peak=peak, losses=losses,
               norms=norms, step_ms=float(np.median(step_ms[1:])),
               fb_ms=float(np.median(fb_ms[1:])),
               opt_ms=float(np.median(opt_ms[1:])), bounds=bd,
               lookups=lookups, busy_ms=None, idle=None, kernels=None)
    if by_name:
        busy = sum(us for us, _ in by_name.values())
        out.update(busy_ms=busy / 1e3, idle=1 - busy / wall_us,
                   kernels=sum(c for _, c in by_name.values()))
    print(f"train on {card}: {cfg.name} at full width, {cfg.n_layers} "
          f"layers, {cfg.dtype}, remat {cfg.remat}, {bd['params']} "
          f"parameters ({bd['matmul_params']} in matmuls); batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} from StorePipeline over a "
          f"{len(keys)}-document RecordStore (built in {store_s:.3f} s); "
          f"init {init_s:.3f} s; peak allocated {peak} B", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 4) for x in norms]}; weights changed", flush=True)
    print(f"  step ms on CUDA events (median of steps 2-{TRAIN_STEPS}): "
          f"{out['step_ms']:.3f} (forward + backward {out['fb_ms']:.3f}, "
          f"optimizer {out['opt_ms']:.3f}); all steps "
          f"{[round(x, 3) for x in step_ms]}", flush=True)
    print(f"  bound {bd['ms']:.3f} ms by {bd['by']}: {bd['bytes']} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bd['bytes_ms']:.3f} ms, "
          f"{bd['ops']} ops at {BF16_FLOPS:.3g}/s and "
          f"{bd['elementwise_ops']} f32 element-wise ops at "
          f"{F32_FLOPS:.3g}/s = {bd['ops_ms']:.3f} ms; the step takes "
          f"{out['step_ms'] / bd['ms']:.2f}x the bound", flush=True)
    if by_name:
        print(f"  one step under torch.profiler: device busy "
              f"{out['busy_ms']:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle "
              f"{out['idle']:.4f}), {out['kernels']} device entries; top:",
              flush=True)
        for name, (us, c) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            print(f"    {us / 1e3:9.3f} ms  x{c}  {name[:80]}", flush=True)
    elif profile:
        print("  step breakdown: not measured (three profiler sessions saw "
              "no device events)", flush=True)
    store.index.close()
    del state, model, nxt
    torch.cuda.empty_cache()
    return out


def train_accum_property(seed: int, device) -> tuple:
    """Phase 13c: the reference's accumulation property
    (tests/test_train.py) at granite-8b's width with 2 layers in f32:
    accum_steps=2 against one batch of the same 4 x 64 tokens, lr 0."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.train import optim as O
    from repro_torch.train import step as STEP
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                              dtype="float32", accum_steps=2)
    opt = O.adamw(lr=0.0)
    state = STEP.init_state(
        cfg, opt, torch.Generator(device=device).manual_seed(seed),
        device=device)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(device)
    _, m_a = STEP.make_train_step(cfg, opt)(
        state, dict(tokens=tokens.reshape(2, 2, 64),
                    labels=labels.reshape(2, 2, 64)))
    _, m_f = STEP.make_train_step(dataclasses.replace(cfg, accum_steps=1),
                                  opt)(state, dict(tokens=tokens,
                                                   labels=labels))
    l_gap = abs(float(m_a["loss"]) - float(m_f["loss"])) / \
        abs(float(m_f["loss"]))
    n_gap = abs(float(m_a["grad_norm"]) - float(m_f["grad_norm"])) / \
        float(m_f["grad_norm"])
    print(f"  accumulation at d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.dtype}: 2 micro-batches of 2 x 64 against the batch of 4: "
          f"loss {float(m_a['loss']):.6f}, relative gaps loss {l_gap:.3e} "
          f"(limit {TRAIN_ACCUM_LOSS_RTOL}), grad norm {n_gap:.3e} (limit "
          f"{TRAIN_ACCUM_NORM_RTOL})", flush=True)
    if not (l_gap <= TRAIN_ACCUM_LOSS_RTOL and
            n_gap <= TRAIN_ACCUM_NORM_RTOL):
        raise AssertionError(f"accumulated step differs from the full "
                             f"batch: loss {l_gap}, grad norm {n_gap}")
    del state
    torch.cuda.empty_cache()
    return l_gap, n_gap


def train_resume(device) -> dict:
    """Phase 13d: `examples/train_lm_torch.py --preset cpu` on `device`
    for 8 steps with a checkpoint every 4: uninterrupted, then failed at
    step 6 (exit 42) and rerun, which must resume from step 4 and end on
    the uninterrupted run's losses and weights within TRAIN_RESUME_RTOL
    (of the loss, of each weight leaf's largest magnitude)."""
    import tempfile
    import torch
    mod = _example_module("train_lm_torch")
    argv = ["--preset", "cpu", "--device", str(device), "--steps", "8",
            "--ckpt-every", "4"]
    with tempfile.TemporaryDirectory() as tmp:
        full = mod.main(argv + ["--ckpt-dir", os.path.join(tmp, "full")])
        cut = argv + ["--ckpt-dir", os.path.join(tmp, "cut")]
        try:
            mod.main(cut + ["--fail-at-step", "6"])
        except SystemExit as e:
            if e.code != 42:
                raise AssertionError(f"the failed run exited {e.code}, "
                                     f"not 42") from None
        else:
            raise AssertionError("the run meant to fail at step 6 did not")
        again = mod.main(cut)
    if again["start"] != 4:
        raise AssertionError(f"the rerun resumed from {again['start']}, "
                             f"not 4")
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(again["losses"], full["losses"][4:]))
    w_gap = max(_rel_gap(a.detach(), b.detach()) for a, b in zip(
        again["state"]["params"].parameters(),
        full["state"]["params"].parameters()))
    print(f"  resume: examples/train_lm_torch.py --preset cpu on {device}, "
          f"8 steps, checkpoints at 4 and 8: failed at 6 (exit 42), rerun "
          f"resumed from step 4; final loss {again['losses'][-1]:.6f} "
          f"against {full['losses'][-1]:.6f} uninterrupted; largest "
          f"relative gaps: losses {loss_gap:.3e}, weights {w_gap:.3e} "
          f"(limit {TRAIN_RESUME_RTOL})", flush=True)
    if not (loss_gap <= TRAIN_RESUME_RTOL and w_gap <= TRAIN_RESUME_RTOL):
        raise AssertionError(f"the resumed run differs: losses {loss_gap}, "
                             f"weights {w_gap}")
    return dict(loss_gap=loss_gap, w_gap=w_gap)


def train_path(seed: int, device, card: str) -> dict:
    """Phase 13 (see the module docstring); the f64 kernel's launches are
    counted over the full-width training run alone (13b)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.dili_search import (kernel, kernel_f32_i64,
                                                 kernel_f64)
    t13 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    print("train: the six reduced archs (f32, remat none), one step's "
          "gradients and 3 AdamW steps, card against CPU:", flush=True)
    reduced = train_reduced_vs_cpu(seed, device, reduced_archs())
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    full = train_full(dataclasses.replace(get_config(TRAIN_ARCH),
                                          n_layers=TRAIN_LAYERS),
                      seed, device, card)
    launches = kernel_f64.launches
    if launches == 0:
        raise AssertionError("the train path launched the f64 kernel no "
                             "time")
    print(f"train: f64 kernel launches {launches} over "
          f"{len(full['lookups'])} store lookups (f32: {kernel.launches}, "
          f"f32/i64: {kernel_f32_i64.launches})", flush=True)
    max_err = store_lookups_vs_plain(full.pop("lookups"), device)
    accum = train_accum_property(seed, device)
    resume = train_resume(device)
    print(f"train: phase {time.perf_counter() - t13:.1f} s; reduced archs' "
          f"largest relative gaps: loss {reduced['loss']:.3e}, grad norm "
          f"{reduced['grad_norm']:.3e}, gradient {reduced['grad']:.3e}, "
          f"3-step losses {reduced['steps']:.3e}; accumulation gaps "
          f"{accum[0]:.3e} / {accum[1]:.3e}; resume gaps "
          f"{resume['loss_gap']:.3e} / {resume['w_gap']:.3e}", flush=True)
    return dict(full, launches=launches, max_err=max_err)


# Phase 14 builds the seed's two ssm/hybrid configs, which configs/ no
# longer holds (configs/falcon_mamba_7b.py and configs/zamba2_1p2b.py of
# the seed): no config there has either family.
SSM_CONFIGS = {
    # Mamba-1 [arXiv:2410.05355]
    "falcon-mamba-7b": dict(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024, ssm_state=16,
        ssm_version=1, expand=2, d_conv=4, tie_embeddings=False),
    # Mamba-2 backbone + a shared attention block every 6 [arXiv:2411.15242]
    "zamba2-1.2b": dict(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, ssm_state=64,
        ssm_version=2, ssm_heads=32, expand=2, d_conv=4,
        shared_attn_every=6, act="gelu"),
}
# trained at full width: falcon-mamba cut to 8 of its 64 layers (AdamW's
# 16 B a parameter: the whole needs ~116 GB), zamba2 whole
SSM_TRAIN_LAYERS = {"falcon-mamba-7b": 8, "zamba2-1.2b": 38}
# the decode property at full width in f32: zamba2's 12 layers hold two
# shared sites, both used (i % 6 == 5 at 5 and 11)
SSM_PROPERTY_LAYERS = {"falcon-mamba-7b": 2, "zamba2-1.2b": 12}
SSM_SERVE_STEPS = 8              # greedy decode steps after the prefill
PIPE_LAYERS = PIPE_STAGES = PIPE_MICRO = 4
PIPE_RTOL = 1e-5                 # pipeline against forward_train, f32


def ssm_serve(cfg, seed: int, device, card: str) -> dict:
    """Phase 14a: `cfg` uncut at its dtype, weights drawn on the card,
    prefill of [8, 32] and SSM_SERVE_STEPS greedy decode steps through
    `train/step.py` (finite logits, tokens in range), then `llm_numbers`:
    prefill and decode ms on CUDA events beside their bounds, kernels a
    decode step and the idle share."""
    import torch
    from repro_torch.models import model as MDL
    from repro_torch.train import step as STEP
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MDL.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    B, P = 8, 32
    tokens, _ = llm_inputs(cfg, B, P, seed, device)
    cache = MDL.make_cache(cfg, B, P + SSM_SERVE_STEPS + 1, device=device)
    t0 = time.perf_counter()
    toks, logits = STEP.greedy(model, cfg, dict(tokens=tokens), cache,
                               SSM_SERVE_STEPS)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if not all(bool(torch.isfinite(lg).all()) for lg in logits):
        raise AssertionError(f"{cfg.name}: the served logits are not all "
                             f"finite")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{cfg.name}: served tokens outside "
                             f"[0, {cfg.vocab})")
    print(f"ssm serve on {card}: {cfg.name} uncut ({cfg.family}, "
          f"{cfg.n_layers} layers, {cfg.dtype}), {n} parameters drawn on "
          f"the card in {init_s:.3f} s; prefill of [{B}, {P}] and "
          f"{SSM_SERVE_STEPS} greedy decode steps in {serve_s:.3f} s, logits "
          f"finite, tokens in range (row 0: {toks[0].tolist()})", flush=True)
    del cache
    # one decode step under the profiler, to keep phase 14 within what the
    # sharded path's cut saves
    out = llm_numbers(dict(model=model, cfg=cfg), seed, device, card,
                      profiled=(0, 1))
    peak = torch.cuda.max_memory_allocated()
    print(f"  {cfg.name}: peak allocated {peak} B over serving and timing",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(out, init_s=init_s, params=n, peak=peak)


def pipeline_on_card(seed: int, device) -> dict:
    """Phase 14e: the GPipe schedule at granite-8b's width, PIPE_LAYERS
    layers in f32 (TF32 off) split into PIPE_STAGES stages with
    PIPE_MICRO microbatches of [8, 64] tokens, against `forward_train`
    within PIPE_RTOL; both timed on CUDA events."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.parallel import pipeline as PP
    from repro_torch.parallel.sharding import Mesh
    cfg = dataclasses.replace(get_config(LLM_ARCH), n_layers=PIPE_LAYERS,
                              dtype="float32", remat="none")
    model = MDL.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    tokens, _ = llm_inputs(cfg, 8, 64, seed, device)
    mesh = Mesh(("pod", "data", "model"), (PIPE_STAGES, 1, 1))
    with torch.no_grad():
        full, _ = MDL.forward_train(model, cfg, tokens)
        pp = PP.pipeline_forward(cfg, mesh, model, tokens, n_micro=PIPE_MICRO)
        rel = _rel_gap(pp, full)
        pp_ms = cuda_ms(lambda: PP.pipeline_forward(
            cfg, mesh, model, tokens, n_micro=PIPE_MICRO), 3)
        fw_ms = cuda_ms(lambda: MDL.forward_train(model, cfg, tokens), 3)
    print(f"  pipeline: {cfg.name} width, {PIPE_LAYERS} layers in "
          f"{PIPE_STAGES} stages, {PIPE_MICRO} microbatches of [2, 64], f32: "
          f"logits against forward_train relative gap {rel:.3e} (limit "
          f"{PIPE_RTOL}); {pp_ms:.3f} ms against {fw_ms:.3f} ms on CUDA "
          f"events", flush=True)
    if not rel <= PIPE_RTOL:
        raise AssertionError(f"pipeline_forward differs from forward_train "
                             f"by {rel} relative")
    del model, full, pp
    torch.cuda.empty_cache()
    return dict(rel=rel, ms=pp_ms, forward_ms=fw_ms)


def psum_on_card(seed: int, device) -> None:
    """Phase 14f: `psum_int8` over 8 stacked shard slices on the card
    against its CPU result, bit for bit: the reference test's (64, 32)
    input as 8 x (8, 32), and 8 x (1024, 4096)."""
    import torch
    from repro_torch.parallel.compression import psum_int8
    rng = np.random.default_rng(seed)
    for shape in ((8, 8, 32), (8, 1024, 4096)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        want = psum_int8(x)
        xd = x.to(device)
        got = psum_int8(xd).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"psum_int8 on the card differs from the "
                                 f"CPU's at {shape}: "
                                 f"{float((got - want).abs().max())}")
        ms = cuda_ms(lambda: psum_int8(xd), 5)
        print(f"  psum_int8 over {shape[0]} shards of {shape[1:]}: bit-equal "
              f"to the CPU's; {ms:.4f} ms on CUDA events", flush=True)


def dryrun_table(cfgs: dict) -> list:
    """Phase 14g: `launch.dryrun` over every (arch x shape) cell, the six
    assigned archs and `cfgs`, single and multi-pod, against the card's
    memory; one line a cell."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import dryrun as DRY
    from repro_torch.models.config import ALL_SHAPES
    hbm = DRY.card_bytes(None)
    archs = dict({a: get_config(a) for a in list_archs()}, **cfgs)
    print(f"  dry run against the card's {hbm} B:", flush=True)
    rows = []
    for multi in (False, True):
        for name, cfg in archs.items():
            for shape in ALL_SHAPES:
                rows.append(DRY.run_cell(cfg, shape, multi, hbm, arch=name))
                print(f"    {DRY.format_row(rows[-1])}", flush=True)
    ok = [r for r in rows if r["status"] == "OK"]
    print(f"  dry run: {len(rows)} cells, {len(ok)} sized, "
          f"{len(rows) - len(ok)} skipped; {sum(r['fits'] for r in ok)} "
          f"fit the card whole", flush=True)
    return rows


def ssm_path(seed: int, device, card: str) -> dict:
    """Phase 14 (see the module docstring); the f64 kernel's launches are
    counted over the two full-width training runs (14c)."""
    import dataclasses
    import torch
    from repro_torch.kernels.dili_search import (kernel, kernel_f32_i64,
                                                 kernel_f64)
    from repro_torch.models.config import ModelConfig
    t14 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfgs = {k: ModelConfig(**v) for k, v in SSM_CONFIGS.items()}
    reduced = {"falcon-mamba-7b": cfgs["falcon-mamba-7b"].reduced(),
               "zamba2-1.2b": cfgs["zamba2-1.2b"].reduced(
                   n_layers=5, shared_attn_every=2)}
    print("ssm: the reduced ssm and hybrid archs (f32), prefill and "
          f"{LLM_STEPS} greedy decode steps, then one step's gradients and 3 "
          f"AdamW steps (remat none), card against CPU:", flush=True)
    marks = [("start", time.perf_counter())]
    llm_err = llm_reduced_vs_cpu(seed, device, reduced)
    tr_err = train_reduced_vs_cpu(seed, device, reduced)
    marks.append(("reduced", time.perf_counter()))
    serve = {}
    for name, cfg in cfgs.items():
        serve[name] = ssm_serve(cfg, seed, device, card)
        marks.append((f"serve {name}", time.perf_counter()))
    rel = {name: llm_decode_property(dataclasses.replace(
        cfg, n_layers=SSM_PROPERTY_LAYERS[name], dtype="float32"), seed,
        device) for name, cfg in cfgs.items()}
    marks.append(("decode property", time.perf_counter()))
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    trains = {}
    for name, cfg in cfgs.items():
        trains[name] = train_full(dataclasses.replace(
            cfg, n_layers=SSM_TRAIN_LAYERS[name]), seed, device, card,
            profile=False)
        marks.append((f"train {name}", time.perf_counter()))
    launches = kernel_f64.launches
    if launches == 0:
        raise AssertionError("the ssm train path launched the f64 kernel no "
                             "time")
    print(f"ssm: f64 kernel launches {launches} over the two training runs' "
          f"store lookups (f32: {kernel.launches}, f32/i64: "
          f"{kernel_f32_i64.launches})", flush=True)
    max_err = store_lookups_vs_plain(
        [lk for t in trains.values() for lk in t.pop("lookups")], device)
    print("ssm: parallel and launch on the card:", flush=True)
    pipe = pipeline_on_card(seed, device)
    marks.append(("pipeline", time.perf_counter()))
    psum_on_card(seed, device)
    marks.append(("psum", time.perf_counter()))
    dryrun_table(cfgs)
    marks.append(("dry run", time.perf_counter()))
    seconds = time.perf_counter() - t14
    parts = {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}
    print(f"ssm: seconds by part {parts}", flush=True)
    print(f"ssm: phase {seconds:.1f} s; reduced archs' largest logit gap "
          f"{llm_err:.3e}, gradient {tr_err['grad']:.3e}, 3-step losses "
          f"{tr_err['steps']:.3e}; decode against the full forward "
          f"{ {k: f'{v:.3e}' for k, v in rel.items()} }; pipeline gap "
          f"{pipe['rel']:.3e}; train ms a step "
          f"{ {k: round(t['step_ms'], 3) for k, t in trains.items()} }",
          flush=True)
    return dict(serve=serve, train=trains, launches=launches,
                max_err=max_err, seconds=seconds)


def make_overlay(keys: np.ndarray, rng, device, n_up: int = 1000,
                 n_dead: int = 600, dtype=None, cap: int = 64):
    """An overlay mirror of upserts (new keys between neighbours, and
    overwrites) and tombstones, some re-upserted, over `keys`, with keys
    of `dtype` (f64 unless given), at a capacity of at least `cap`, and
    its membership filter, as the local engine's mirror carries."""
    import torch
    from repro_torch.kernels.dili_search import overlay_filter
    from repro_torch.online.overlay import (TombstoneOverlay,
                                            overlay_device_arrays)
    mids = (keys[:-1] + keys[1:]) / 2
    up = np.concatenate([mids[rng.integers(0, len(mids), n_up // 2)],
                         keys[rng.integers(0, len(keys), n_up // 2)]])
    dead = keys[rng.integers(0, len(keys), n_dead)]
    ov = (TombstoneOverlay.empty(cap)
          .upsert_batch(up, np.arange(len(up)) + 2 ** 40)
          .delete_batch(dead)
          .upsert_batch(dead[: n_dead // 10], np.arange(n_dead // 10)))
    arrs = overlay_device_arrays(ov, dtype or torch.float64, device=device)
    arrs["filter"] = overlay_filter(ov.keys, dtype or torch.float64).to(
        device)
    return arrs


def _apply(tk, tv, up_k, up_v, dead):
    from repro_torch.core.flat import merge_sorted_runs
    k = np.concatenate([up_k, dead])
    v = np.concatenate([up_v, np.zeros(len(dead), np.int64)])
    t = np.concatenate([np.zeros(len(up_k), np.int8),
                        np.ones(len(dead), np.int8)])
    return merge_sorted_runs(tk, (tv, np.zeros(len(tk), np.int8)), k, (v, t))


def cuda_ms(fn, reps: int) -> float:
    """ms per call of `fn()`: `reps` calls queued back to back between two
    CUDA events.  The host queues ahead of the card, so this is device time
    unless a call's host work outlasts its device work: the plain
    versions, whose host work syncs, are timed so."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_of(fn, reps: int = 25):
    """`reps` calls of `fn()` captured in one CUDA graph (after three
    calls on a side stream, which load the kernels and warm the
    allocator): a replay runs them with no Python between launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def replay_ms(g, reps: int = 25) -> float:
    """ms per launch of one replay of `g` (`reps` launches), between two
    CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_rounds(fns: dict, rounds: int = 8, reps: int = 25) -> dict:
    """Warm ms per launch of each function in `fns` (name -> fn): each
    captured once as a graph of `reps` launches, then `rounds` replays of
    each, in turns, forward then backward (a, b, b, a, ...) so that drift
    falls on all alike.  Returns name -> list of per-round ms."""
    graphs = {k: graph_of(fn, reps) for k, fn in fns.items()}
    names = list(graphs)
    out = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            out[k].append(replay_ms(graphs[k], reps))
    return out


def cold_l2_ms(fn, device, reps: int) -> float:
    """Median ms of one `fn()` between CUDA events, with a 64 MB buffer
    written before each run so that the tables start out of the 50 MB L2.
    The card then spins for about 0.1 ms, while the host queues the run,
    so the events time the device alone."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    times = []
    for r in range(reps):
        flush.fill_(r & 0xFF)
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_events(fn, reps: int = 3) -> tuple:
    """(wall µs of `reps` calls of `fn`, {name: [device µs, count]}) from
    torch.profiler's CUDA events; the dict is empty when three profiling
    sessions in a row saw no device event (seen once for a second session
    in one process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                row = by_name.setdefault(e.name, [0.0, 0])
                row[0] += e.time_range.elapsed_us()
                row[1] += 1
        if by_name:
            break
    return wall_us, by_name


def device_breakdown(fn, reps: int = 3) -> None:
    """Print the device time of `reps` calls of `fn` by kernel / copy name
    (`device_events`) and the device's busy share of the wall time."""
    wall_us, by_name = device_events(fn, reps)
    if not by_name:
        print("where the time goes: not measured (three profiler sessions "
              "saw no device events)", flush=True)
        return
    busy = sum(us for us, _ in by_name.values())
    print(f"where the time goes, per lookup call: wall {wall_us / reps:.1f} "
          f"us, device busy {busy / reps:.1f} us ({busy / wall_us:.4f} of "
          f"wall, idle {1 - busy / wall_us:.4f}); top device entries:",
          flush=True)
    for name, (us, _) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us / reps:10.1f} us  {name[:90]}", flush=True)


class Baseline:
    """The lookup kernel built from another copy of csrc/dili_search.cu
    into a library of its own (`--baseline`): the same tables and queries
    timed through it and through this checkout's kernel in one run.  The
    copy is either of PR 15's interface (i64 entry points without the
    overlay filter; f64 CHILD slots holding the bare sentinel and the
    child's id), converted to here, or of this checkout's (it exports
    `dili_search_occupancy`), such as this source with one choice edited."""

    def __init__(self, src: str):
        import ctypes
        import hashlib
        from repro_torch.kernels import dili_search as D
        self.src = src
        data = Path(src).read_bytes()
        digest = hashlib.sha256(data + " ".join(D.NVCC_FLAGS).encode())
        lib_path = D._BUILD_DIR / f"baseline_{digest.hexdigest()[:16]}.so"
        if not lib_path.exists():
            D._BUILD_DIR.mkdir(parents=True, exist_ok=True)
            res = subprocess.run([D._find_nvcc(), *D.NVCC_FLAGS, "-o",
                                  str(lib_path), src], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed building the baseline "
                                   f"{src}:\n{res.stdout}\n{res.stderr}")
        self.lib = ctypes.CDLL(str(lib_path))
        self.current = hasattr(self.lib, "dili_search_occupancy")
        self._legacy = (None, None)   # (slot_rec, its earlier encoding)
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        f32 = [vp] * 3 + [ctypes.c_int, vp, ll, ctypes.c_int] + [vp] * 3
        i64 = (f32[:7] + [vp] * 3 + [ll]
               + ([vp, ctypes.c_int] if self.current else []) + [vp] * 3)
        self.entries = {}
        for k, name, args in (("f32", "dili_search_f32_launch", f32),
                              ("f64", "dili_search_f64_launch", i64),
                              ("f32_i64", "dili_search_f32_i64_launch",
                               i64)):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            self.entries[k] = fn

    def tables(self, arrs) -> dict:
        """`arrs` as the copy reads them: for PR 15's, an f64 CHILD slot
        holds the bare sentinel 0x7FF8000000000002 and the child's id (the
        slot's other fields are newer); the rest is unchanged."""
        if self.current or kind(arrs) != "f64":
            return arrs
        from repro_torch.kernels.ref import CHILD_KEY_HI_F64
        if self._legacy[0] is not arrs["slot_rec"]:
            sr = arrs["slot_rec"].clone()
            child = (sr[:, 0] >> 32) == CHILD_KEY_HI_F64
            sr[:, 0] = sr[:, 0].masked_fill(child, 0x7FF8000000000002)
            sr[:, 1] = sr[:, 1].where(~child, sr[:, 1] & 0xFFFFFFFF)
            self._legacy = (arrs["slot_rec"], sr)
        return dict(arrs, slot_rec=self._legacy[1])

    def pair(self, arrs, q, ov=None):
        import torch
        k = kind(arrs)
        arrs = self.tables(arrs)
        out = torch.empty(q.numel(), dtype=torch.int32 if k == "f32"
                          else torch.int64, device=q.device)
        found = torch.empty(q.numel(), dtype=torch.bool, device=q.device)
        head = (arrs["node_rec"].data_ptr(), arrs["slot_rec"].data_ptr(),
                arrs["key"].data_ptr(), int(arrs["root"]), q.data_ptr(),
                q.numel(), int(arrs["max_depth"]))
        if k != "f32":
            head += ((0, 0, 0, 0) if ov is None else
                     (ov["keys"].data_ptr(), ov["vals"].data_ptr(),
                      ov["tomb"].data_ptr(), ov["keys"].numel()))
            if self.current:
                filt = None if ov is None else ov.get("filter")
                head += ((0, 0) if filt is None else
                         (filt.data_ptr(),
                          (32 * filt.numel()).bit_length() - 1))
        err = self.entries[k](*head, out.data_ptr(), found.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline {k} launch: CUDA error {err}")
        return out, found


def print_occupancy(arrs) -> None:
    """Registers, spills and resident blocks per SM of the kernel that the
    engine of these tables runs."""
    from repro_torch.kernels import dili_search as D
    k = kind(arrs)
    kern = {"f32": D.kernel, "f64": D.kernel_f64,
            "f32_i64": D.kernel_f32_i64}[k]
    occ = kern.occupancy()
    print(f"{k} occupancy: {occ['regs']} registers a thread, "
          f"{occ['local_bytes']} B local, {occ['blocks_per_sm']} blocks of "
          f"256 per SM ({occ['blocks_per_sm'] * 256} of 2048 threads)",
          flush=True)


def time_kernel(arrs, q, dev, ov=None, baseline=None) -> dict:
    """Warm ms (8 CUDA-graph replays of 25 launches, `graph_rounds`),
    cold-L2 ms (median of 20 single launches) and plain-version ms (5
    calls) of one batch; with an overlay, also the walk alone (`ov=None`);
    with a `Baseline`, its warm and cold ms on the same batch, the warm
    rounds in turns with this kernel's (old, new, new, old, ...)."""
    import torch
    fns = {"new": lambda: pair(arrs, q, ov=ov)}
    if ov is not None:
        fns["walk"] = lambda: pair(arrs, q)
    if baseline is not None:
        fns = {"old": lambda: baseline.pair(arrs, q, ov), **fns}
        for g, w in zip(baseline.pair(arrs, q, ov), pair(arrs, q, ov=ov)):
            if not torch.equal(g, w):
                raise AssertionError("the baseline kernel disagrees with "
                                     "this checkout's on the timed batch")
        if ov is not None:
            fns["old_walk"] = lambda: baseline.pair(arrs, q)
    rounds = graph_rounds(fns)
    for k, v in rounds.items():
        print(f"  {k} kernel ms per launch, 8 graph replays of 25: "
              f"{[round(x, 5) for x in v]}", flush=True)
    res = {k + "_rounds": v for k, v in rounds.items()}
    res.update({k + "_ms": float(np.median(v)) for k, v in rounds.items()})
    res["ms"] = res["new_ms"]
    for k, fn in fns.items():
        res[k + "_cold_ms"] = cold_l2_ms(fn, dev, 20)
    res["cold_ms"] = res["new_cold_ms"]
    res["plain_ms"] = cuda_ms(lambda: pair(arrs, q, plain=True, ov=ov), 5)
    if baseline is not None:
        print(f"  baseline ({baseline.src}) against this kernel: warm "
              f"{res['old_ms']:.5f} -> {res['new_ms']:.5f} ms, cold "
              f"{res['old_cold_ms']:.5f} -> {res['new_cold_ms']:.5f} ms"
              + ("" if ov is None else
                 f"; the walk alone warm {res['old_walk_ms']:.5f} -> "
                 f"{res['walk_ms']:.5f} ms, cold "
                 f"{res['old_walk_cold_ms']:.5f} -> "
                 f"{res['walk_cold_ms']:.5f} ms"), flush=True)
    if ov is not None:
        print(f"  the walk alone (no overlay): warm {res['walk_ms']:.5f} ms, "
              f"cold {res['walk_cold_ms']:.5f} ms; with the "
              f"{ov['keys'].numel()}-entry overlay: warm {res['ms']:.5f} ms, "
              f"cold {res['cold_ms']:.5f} ms", flush=True)
    return res


def replay_checked(arrs, q, ov=None, label="timed batch") -> dict:
    """`walk_reads`, held to the kernel: the replay must be the kernel, so
    its loads and words are the kernel's."""
    import torch
    rp = walk_reads(arrs, q, ov)
    for r, k, what in zip(rp["pair"], pair(arrs, q, ov=ov), ("val", "found")):
        if not torch.equal(r, k):
            raise AssertionError(f"{label}: walk replay {what} differs from "
                                 f"the kernel")
    print(f"{label}: lanes ending at a dense leaf {rp['dense_lanes']} of "
          f"{q.numel()} ({rp['dense_lanes'] / q.numel():.4f}); L2 sectors "
          f"requested (32 B, distinct per warp and load): column layout "
          f"{rp['sectors']['columns']}, packed records "
          f"{rp['sectors']['records']}", flush=True)
    by = rp["sectors"]["by_level"]
    for lv, st in enumerate(rp["levels"]):
        print(f"  level {lv}: {st['lanes']} lanes, {st['nodes']} distinct "
              f"node records ({by[lv]['node']} sectors), {st['slots']} "
              f"distinct slot records ({by[lv]['slot']} sectors)",
              flush=True)
    if "probe" in by:
        print(f"  dense probe: {by['probe']['key']} key-column sectors, "
              f"{by['probe']['slot']} slot-record sectors", flush=True)
    return rp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1_000_000,
                    help="keys of each main path (the pallas and "
                    "local-f32 paths take at most 250k)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", metavar="SRC",
                    help="another copy of csrc/dili_search.cu (PR 15's "
                    "or one of this checkout's interface, see Baseline), "
                    "built into its own library and timed in turns with "
                    "this checkout's kernel on every timed batch")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.core.dili import bulk_load
    from repro_torch.core.flat import flatten
    from repro_torch.core import search as S
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.dili_search import (kernel, kernel_f32_i64,
                                                 kernel_f64)
    from repro_torch.data.datasets import generate
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # -- 1. card and build ----------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    kernel.build()
    print(f"build: dili_search.cu (f32/i32, f64/i64 and f32/i64 instances) "
          f"built and loaded in {kernel.build_s:.3f} s", flush=True)
    for line in kernel.ptxas_report.splitlines():
        print(f"  {line.strip()}", flush=True)
    baseline = Baseline(args.baseline) if args.baseline else None

    # -- 2. each instance against its plain version, 20k keys -----------------
    d, k20 = K.build_f32_index(generate("logn", 20_000, args.seed))
    f20 = flatten(d)
    arrs20 = K.kernel_arrays(f20, device=dev)
    print(f"f32 kernel vs plain at {len(k20)} keys ({int(f20.dense.sum())} "
          f"dense leaves of {f20.n_nodes} nodes):", flush=True)
    if not f20.dense.any():
        raise AssertionError("the 20k logn table has no dense leaf")
    max_err = kernel_vs_plain(arrs20, lane_sets(k20, rng, dev), "20k")
    k64 = generate("logn", 20_000, args.seed)
    max_err64 = 0.0
    for label, lo_opt in (("20k-f64", True), ("20k-f64-dili-lo", False)):
        f = flatten(bulk_load(k64, local_optimized=lo_opt))
        print(f"f64 kernel vs plain at {len(k64)} keys, "
              f"{'standard' if lo_opt else 'DILI-LO'} build "
              f"({int(f.dense.sum())} dense leaves of {f.n_nodes} nodes), "
              f"with an overlay:", flush=True)
        if f.dense.any() == lo_opt:
            raise AssertionError(f"the {label} build has "
                                 f"{int(f.dense.sum())} dense leaves")
        a64, sets = (K.kernel_arrays(f, device=dev, dtype=torch.float64),
                     lane_sets(k64, rng, dev, np.float64))
        ov20 = make_overlay(k64, rng, dev)
        max_err64 = max(max_err64, kernel_vs_plain(a64, sets, label,
                                                   ov=ov20))
        for name in ("hits", "misses"):
            replay_checked(a64, sets[name], ov20, f"  {label}/{name}")
    max_err32l = 0.0
    for label, lo_opt in (("20k-f32-i64", True), ("20k-f32-i64-dili-lo",
                                                   False)):
        f = flatten(bulk_load(k64, local_optimized=lo_opt))
        print(f"f32/i64 kernel vs plain at {len(k64)} keys placed in f64, "
              f"{'standard' if lo_opt else 'DILI-LO'} build "
              f"({int(f.dense.sum())} dense leaves of {f.n_nodes} nodes), "
              f"with an f32 overlay:", flush=True)
        a32l = K.kernel_arrays(f, device=dev, dtype=torch.float32,
                               val_dtype=torch.int64)
        sets = lane_sets(k64, rng, dev, np.float32)
        ov20 = make_overlay(k64, rng, dev, dtype=torch.float32)
        max_err32l = max(max_err32l, kernel_vs_plain(a32l, sets, label,
                                                     ov=ov20))
        replay_checked(a32l, sets["hits"], ov20, f"  {label}/hits")

    # -- 3. the pallas main path, counted -------------------------------------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    ix, tk, tv, info = main_path(min(args.keys, PALLAS_KEYS), args.seed, dev)
    launches, launches_f64 = kernel.launches, kernel_f64.launches
    ks = ix.kernel_stats
    if launches == 0:
        raise AssertionError("the pallas path launched the f32 kernel no "
                             "time")
    if ks["recheck_changed"]:
        raise AssertionError(f"the pair-table recheck changed "
                             f"{ks['recheck_changed']} lanes: the kernel "
                             f"missed keys that are in the table")
    print(f"main: f32 kernel launches {launches} (f64: {launches_f64}) over "
          f"{ks['lookups']} lookup calls ({ks['lanes']} lanes); pair-table "
          f"recheck changed {ks['recheck_changed']} lanes", flush=True)

    # -- 3b. f32 kernel against its plain version at the main index -----------
    flat = flatten(ix.host)
    arrs = K.kernel_arrays(flat, device=dev)
    print(f"f32 kernel vs plain at the main index ({len(tk)} keys, "
          f"{int(flat.dense.sum())} dense leaves of {flat.n_nodes} nodes):",
          flush=True)
    keys32 = tk.astype(np.float32)
    max_err = max(max_err, kernel_vs_plain(arrs, lane_sets(keys32, rng, dev),
                                           "main"))

    # -- 5a. f32 numbers at 2^20-query batches --------------------------------
    q_np = next(lookup_batches(tk, rng, 1)).astype(np.float32)
    q = torch.from_numpy(q_np).to(dev)
    max_err = max(max_err, kernel_vs_plain(arrs, {"timed_2^20": q}, "main"))
    rp = replay_checked(arrs, q)
    print_occupancy(arrs)
    t32 = time_kernel(arrs, q, dev, baseline=baseline)
    pk = torch.from_numpy(flat.pair_key.astype(np.float32)).to(dev)
    pv = torch.from_numpy(flat.pair_val.astype(np.int32)).to(dev)

    def library():
        i = torch.searchsorted(pk, q).clamp_(max=pk.numel() - 1)
        return pv[i], pk[i] == q

    lv, lf = library()
    kv, kf = pair(arrs, q)
    if not (torch.equal(lf, kf) and torch.equal(lv[lf], kv[kf])):
        raise AssertionError("searchsorted over the pair table disagrees "
                             "with the kernel")
    library_ms = float(np.median(graph_rounds({"lib": library})["lib"]))
    ix.lookup(q_np)
    lookup_ms = float(np.median([check_lookup(ix, tk, tv, q_np, "timed")
                                 for _ in range(5)])) * 1e3
    device_breakdown(lambda: ix.lookup(q_np))
    bound_ms, bound_by, moved, table_read = bound_of(rp, arrs, q.numel())
    print(f"f32 time per 2^20-query batch on {card}: kernel "
          f"{t32['ms']:.4f} ms ({t32['cold_ms']:.4f} ms with a cold L2), "
          f"plain version {t32['plain_ms']:.4f} ms, searchsorted over the "
          f"pair table {library_ms:.4f} ms, whole lookup {lookup_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({moved} B over HBM: {table_read} B of "
          f"the {K.table_bytes(arrs)} B tables: distinct node records, key "
          f"and val words {rp['rows']}; {rp['predicts']} slot predictions)",
          flush=True)
    print(f"sizes: {info['n_keys']} keys; after the flush, tables "
          f"{K.column_bytes(arrs)} B in the column layout, "
          f"{K.table_bytes(arrs)} B packed; bulk load "
          f"{info['build_s']:.3f} s, flatten {info['flatten_s']:.3f} s, "
          f"flush {info['flush_s']:.3f} s; facade lookup ms per batch in the "
          f"main path {[round(x, 3) for x in info['lookup_ms']]}", flush=True)
    ix.close()
    entry32 = dict(
        name="dili_search", route="cuda",
        source="src/repro_torch/kernels/csrc/dili_search.cu",
        replaces="src/repro/kernels/dili_search.py:34",
        launches=launches, max_abs_err=max_err, ms=t32["ms"],
        plain_ms=t32["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms)
    del ix, arrs, flat, pk, pv, q, rp
    torch.cuda.empty_cache()

    # -- 4. the local main path, counted --------------------------------------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    local_tree = {}
    ix, tk, tv, info = local_path(args.keys, args.seed, dev, local_tree)
    launches, launches_f64 = kernel.launches, kernel_f64.launches
    if launches_f64 == 0:
        raise AssertionError("the local path launched the f64 kernel no "
                             "time")
    ks = ix.kernel_stats
    print(f"local: f64 kernel launches {launches_f64} (f32: {launches}) over "
          f"{ks['lookups']} lookup calls ({ks['lanes']} lanes)", flush=True)

    # -- 4b. f64 kernel against its plain version at the main index -----------
    oi = ix._engine.oi
    arrs, ov, flat = oi.store.kernel_tables, oi._overlay_arrays(), oi.store.flat
    print(f"f64 kernel vs plain at the local main index ({len(tk)} live "
          f"keys, {int(flat.dense.sum())} dense leaves of {flat.n_nodes} "
          f"nodes, {ix.stats()['pending_writes']} pending writes in the "
          f"overlay):", flush=True)
    max_err64 = max(max_err64, kernel_vs_plain(
        arrs, lane_sets(tk, rng, dev, np.float64), "local", ov=ov))

    # -- 5b. f64 numbers at 2^20-query batches --------------------------------
    q_np = next(lookup_batches(tk, rng, 1))
    q = torch.from_numpy(q_np).to(dev)
    max_err64 = max(max_err64, kernel_vs_plain(arrs, {"timed_2^20": q},
                                               "local", ov=ov))
    rp = replay_checked(arrs, q, ov)
    print_occupancy(arrs)
    t64 = time_kernel(arrs, q, dev, ov, baseline)
    pk = torch.from_numpy(flat.pair_key).to(dev)
    pv = torch.from_numpy(flat.pair_val).to(dev)

    def library64():
        i = torch.searchsorted(pk, q).clamp_(max=pk.numel() - 1)
        return S.resolve_overlay(ov, q, pv[i], pk[i] == q)

    lv, lf = library64()
    kv, kf = pair(arrs, q, ov=ov)
    if not (torch.equal(lf, kf) and torch.equal(lv[lf], kv[kf])):
        raise AssertionError("searchsorted over the pair table and the "
                             "overlay disagrees with the kernel")
    library64_ms = float(np.median(graph_rounds(
        {"lib": library64})["lib"]))
    ix.lookup(q_np)
    lookup64_ms = float(np.median([
        check_lookup(ix, tk, tv, q_np, "local timed", f32=False)
        for _ in range(5)])) * 1e3
    device_breakdown(lambda: ix.lookup(q_np))
    bound64_ms, bound64_by, moved, table_read = bound_of(rp, arrs, q.numel())
    print(f"f64 time per 2^20-query batch on {card}: kernel "
          f"{t64['ms']:.4f} ms ({t64['cold_ms']:.4f} ms with a cold L2), "
          f"plain version {t64['plain_ms']:.4f} ms, searchsorted over the "
          f"pair table and the overlay {library64_ms:.4f} ms, whole "
          f"LocalEngine lookup {lookup64_ms:.4f} ms; bound "
          f"{bound64_ms:.4f} ms ({moved} B over HBM: {table_read} B of the "
          f"{K.table_bytes(arrs)} B tables and the overlay: distinct rows "
          f"{rp['rows']}; {rp['predicts']} slot predictions)", flush=True)
    print(f"local sizes: {info['n_keys']} keys built; kernel tables "
          f"{K.column_bytes(arrs)} B in the column layout, "
          f"{K.table_bytes(arrs)} B packed; pair table on the device "
          f"{sum(t.nbytes for t in oi.store.pairs.values())} B; "
          f"DeviceSnapshot (stats' device_bytes, not uploaded) "
          f"{ix.stats()['device_bytes']} B; bulk load {info['build_s']:.3f} "
          f"s, flatten {info['flatten_s']:.3f} s, upload "
          f"{info['upload_s']:.3f} s, flush {info['flush_s']:.3f} s; merges "
          f"{info['merge_reasons']}; facade lookup ms per batch in the main "
          f"path {[round(x, 3) for x in info['lookup_ms']]}", flush=True)
    # kept for the competitors' DILI row: the bulk load's keys and flat
    local_bulk = (info["keys"], info["flat"],
                  info["build_s"] + info["flatten_s"])
    local_build_s = info["build_s"] + info["flatten_s"] + info["upload_s"]

    # -- 4c. the serving front-end over the local index, counted --------------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    serve = serve_path(ix, args.seed)
    launches_serve = kernel_f64.launches
    if launches_serve == 0:
        raise AssertionError("the serve path launched the f64 kernel no "
                             "time")
    print(f"serve: f64 kernel launches {launches_serve} (f32: "
          f"{kernel.launches}, f32/i64: {kernel_f32_i64.launches})",
          flush=True)
    ix.close()
    entry64 = dict(
        name="dili_search_f64", route="cuda",
        source="src/repro_torch/kernels/csrc/dili_search.cu",
        replaces="src/repro/kernels/dili_search.py:34",
        launches=launches_f64, max_abs_err=max_err64, ms=t64["ms"],
        plain_ms=t64["plain_ms"], bound_ms=bound64_ms, bound_by=bound64_by,
        library_ms=library64_ms)
    entry64["launches"] += launches_serve

    del ix, arrs, ov, flat, pk, pv, q, rp, oi
    torch.cuda.empty_cache()

    # -- 6. the local main path at f32, counted -------------------------------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    ix, tk, tv, info = local_f32_path(min(args.keys, LOCAL_F32_KEYS),
                                      args.seed, dev)
    launches_f32l = kernel_f32_i64.launches
    if launches_f32l == 0:
        raise AssertionError("the local f32 path launched the f32/i64 "
                             "kernel no time")
    ks = ix.kernel_stats
    print(f"local-f32: f32/i64 kernel launches {launches_f32l} (f32: "
          f"{kernel.launches}, f64: {kernel_f64.launches}) over "
          f"{ks['lookups']} lookup calls ({ks['lanes']} lanes)", flush=True)

    # -- 6b. f32/i64 kernel against its plain version at the main index -------
    oi = ix._engine.oi
    arrs, ov, flat = oi.store.kernel_tables, oi._overlay_arrays(), oi.store.flat
    print(f"f32/i64 kernel vs plain at the local-f32 main index ({len(tk)} "
          f"live keys, {int(flat.dense.sum())} dense leaves of "
          f"{flat.n_nodes} nodes, {ix.stats()['pending_writes']} pending "
          f"writes in the overlay):", flush=True)
    max_err32l = max(max_err32l, kernel_vs_plain(
        arrs, lane_sets(tk, rng, dev, np.float32), "local-f32", ov=ov))

    # -- 6c. f32/i64 numbers at 2^20-query batches ----------------------------
    q_np = next(lookup_batches(tk, rng, 1))
    q = torch.from_numpy(q_np.astype(np.float32)).to(dev)
    max_err32l = max(max_err32l, kernel_vs_plain(arrs, {"timed_2^20": q},
                                                 "local-f32", ov=ov))
    rp = replay_checked(arrs, q, ov)
    print_occupancy(arrs)
    t32l = time_kernel(arrs, q, dev, ov, baseline)
    pk = torch.from_numpy(flat.pair_key.astype(np.float32)).to(dev)
    pv = torch.from_numpy(flat.pair_val).to(dev)

    def library32l():
        i = torch.searchsorted(pk, q).clamp_(max=pk.numel() - 1)
        return S.resolve_overlay(ov, q, pv[i], pk[i] == q)

    lv, lf = library32l()
    kv, kf = pair(arrs, q, ov=ov)
    # the bisection finds every key; the kernel, with the reference's f32
    # arithmetic, misses some: where the kernel finds, both agree
    if not (bool(lf[kf].all()) and torch.equal(lv[kf], kv[kf])):
        raise AssertionError("searchsorted over the pair table and the "
                             "overlay disagrees with the f32/i64 kernel")
    library32l_ms = float(np.median(graph_rounds(
        {"lib": library32l})["lib"]))
    ix.lookup(q_np)
    lookup32l_ms = float(np.median([
        check_lookup_f32_local(ix, tk, tv, q_np, "local-f32 timed")[0]
        for _ in range(5)])) * 1e3
    device_breakdown(lambda: ix.lookup(q_np))
    bound32l_ms, bound32l_by, moved, table_read = bound_of(rp, arrs,
                                                           q.numel())
    print(f"f32/i64 time per 2^20-query batch on {card}: kernel "
          f"{t32l['ms']:.4f} ms ({t32l['cold_ms']:.4f} ms with a cold L2), "
          f"plain version {t32l['plain_ms']:.4f} ms, searchsorted over the "
          f"pair table and the overlay {library32l_ms:.4f} ms (it finds "
          f"{int(lf.sum())} lanes, the kernel {int(kf.sum())}), whole "
          f"LocalEngine lookup {lookup32l_ms:.4f} ms; bound "
          f"{bound32l_ms:.4f} ms ({moved} B over HBM: {table_read} B of the "
          f"{K.table_bytes(arrs)} B tables and the overlay: distinct rows "
          f"{rp['rows']}; {rp['predicts']} slot predictions)", flush=True)
    print(f"local-f32 sizes: {info['n_keys']} keys built; kernel tables "
          f"{K.column_bytes(arrs)} B in the column layout, "
          f"{K.table_bytes(arrs)} B packed; bulk load {info['build_s']:.3f} "
          f"s, flatten {info['flatten_s']:.3f} s, upload "
          f"{info['upload_s']:.3f} s, flush {info['flush_s']:.3f} s; merges "
          f"{info['merge_reasons']}; facade lookup ms per batch in the main "
          f"path {[round(x, 3) for x in info['lookup_ms']]}", flush=True)
    ix.close()
    entry32l = dict(
        name="dili_search_f32_i64", route="cuda",
        source="src/repro_torch/kernels/csrc/dili_search.cu",
        replaces="src/repro/kernels/dili_search.py:34",
        launches=launches_f32l, max_abs_err=max_err32l, ms=t32l["ms"],
        plain_ms=t32l["plain_ms"], bound_ms=bound32l_ms,
        bound_by=bound32l_by, library_ms=library32l_ms)
    del ix, arrs, ov, flat, pk, pv, q, rp, oi
    torch.cuda.empty_cache()

    # -- 7. background maintenance on the local engine, counted ---------------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    maint = maint_path(args.keys, args.seed, dev, local_tree)
    del local_tree
    launches_maint = kernel_f64.launches
    if launches_maint == 0:
        raise AssertionError("the maintenance path launched the f64 kernel "
                             "no time")
    print(f"maint: f64 kernel launches {launches_maint} (f32: "
          f"{kernel.launches}, f32/i64: {kernel_f32_i64.launches}); "
          f"lookups that overlapped a merge {maint['overlapped']}",
          flush=True)
    entry64["launches"] += launches_maint

    # -- 8. durability: kill and recover on the local engine, counted ---------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    t0 = time.perf_counter()
    durable_timing = durable_path(min(args.keys, DURABLE_KEYS), args.seed,
                                  dev)
    durable_s = time.perf_counter() - t0
    launches_dur = kernel_f64.launches
    if launches_dur == 0:
        raise AssertionError("the durable path launched the f64 kernel no "
                             "time")
    print(f"durable: f64 kernel launches {launches_dur} (f32: "
          f"{kernel.launches}, f32/i64: {kernel_f32_i64.launches}); the "
          f"path took {durable_s:.1f} s", flush=True)
    entry64["launches"] += launches_dur

    # -- 9. the sharded engine, counted --------------------------------------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    t0 = time.perf_counter()
    sharded = sharded_path(min(args.keys, SHARDED_KEYS), args.seed, dev,
                           durable_timing)
    sharded_s = time.perf_counter() - t0
    launches_sharded = sharded["launches"]
    if launches_sharded == 0:
        raise AssertionError("the sharded path launched the f64 kernel no "
                             "time")
    print(f"sharded: f64 kernel launches {launches_sharded} on the path, "
          f"{kernel_f64.launches} with the comparison and timing (f32: "
          f"{kernel.launches}, f32/i64: {kernel_f32_i64.launches})",
          flush=True)
    entry64["launches"] += launches_sharded
    entry64["max_abs_err"] = max(entry64["max_abs_err"], sharded["max_err"])
    # the cut's saving: the local path's 1M host build of the same
    # distribution in this run stands for the sharded path's old 1M build
    sharded_saved_s = local_build_s - sharded["build_s"]
    print(f"sharded: the path took {sharded_s:.1f} s at "
          f"{min(args.keys, SHARDED_KEYS)} keys (build "
          f"{sharded['build_s']:.1f} s); the local path's build of "
          f"{args.keys} keys took {local_build_s:.1f} s in this run, so the "
          f"cut saved about {sharded_saved_s:.1f} s", flush=True)
    del durable_timing
    torch.cuda.empty_cache()

    # -- 10. serving: background against sync maintenance, counted ----------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    compare = serve_compare_path(min(args.keys, SERVE_COMPARE_KEYS),
                                 args.seed, dev)
    launches_cmp = kernel_f64.launches
    if launches_cmp == 0:
        raise AssertionError("the serve compare path launched the f64 "
                             "kernel no time")
    print(f"serve compare: f64 kernel launches {launches_cmp} (f32: "
          f"{kernel.launches}, f32/i64: {kernel_f32_i64.launches})",
          flush=True)
    entry64["launches"] += launches_cmp

    # -- 11. the paper's competitors beside DILI, counted --------------------
    kernel.launches = kernel_f64.launches = kernel_f32_i64.launches = 0
    comp = competitors_path(*local_bulk, args.seed, dev, card,
                            lipp_keys=f32_exact_keys(
                                min(args.keys, LOCAL_F32_KEYS), args.seed))
    if comp["launches"] == 0:
        raise AssertionError("the competitors path launched the f64 kernel "
                             "no time")
    print(f"competitors: f64 kernel launches {comp['launches']} on the "
          f"path, {kernel_f64.launches} with the comparisons and timing "
          f"(f32: {kernel.launches}, f32/i64: {kernel_f32_i64.launches})",
          flush=True)
    entry64["launches"] += comp["launches"]
    comp_order = comp["order"]
    entry64["max_abs_err"] = max(entry64["max_abs_err"], comp["max_err"])
    del local_bulk, comp
    torch.cuda.empty_cache()

    # -- 12. llm serve: the LLM serving path on the card, counted ------------
    llm = llm_path(args.seed, dev, card)
    entry64["launches"] += llm["launches"]
    entry64["max_abs_err"] = max(entry64["max_abs_err"], llm["max_err"])

    # -- 13. llm train: the LLM training path on the card, counted ----------
    train = train_path(args.seed, dev, card)
    entry64["launches"] += train["launches"]
    entry64["max_abs_err"] = max(entry64["max_abs_err"], train["max_err"])

    # -- 14. ssm / hybrid / parallel: the last slice on the card, counted ---
    ssm = ssm_path(args.seed, dev, card)
    entry64["launches"] += ssm["launches"]
    entry64["max_abs_err"] = max(entry64["max_abs_err"], ssm["max_err"])
    print(f"ssm: phase 14 took {ssm['seconds']:.1f} s; the sharded cut "
          f"saved about {sharded_saved_s:.1f} s", flush=True)
    print(f"summary: serve on the local 1M index: the ramp's best "
          f"achieved rate {serve['ramp_best']:.1f} ops/s, the highest "
          f"offered rate a leg held {serve['sustained']:.1f} ops/s; sharded "
          f"lookup "
          f"{sharded['launches_per_lookup']} launches, device "
          f"{sharded['sharded_dev_ms']:.5f} ms against local "
          f"{sharded['local_dev_ms']:.5f} ms; background/sync lookup p99 "
          f"{compare['background']['p99']:.3f}/{compare['sync']['p99']:.3f} "
          f"ms; competitors fastest first {' < '.join(comp_order)}; "
          f"{LLM_ARCH} decode {llm['decode_ms']:.3f} ms a step against a "
          f"{llm['bounds']['decode']['ms']:.3f} ms bound; {TRAIN_ARCH} at "
          f"{TRAIN_LAYERS} layers trains {train['step_ms']:.3f} ms a step "
          f"against a {train['bounds']['ms']:.3f} ms bound; "
          + "; ".join(f"{k} decode {v['decode_ms']:.3f} ms a step against a "
                      f"{v['bounds']['decode']['ms']:.3f} ms bound"
                      for k, v in ssm["serve"].items())
          + f"; the whole script {time.perf_counter() - T_START:.1f} s",
          flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [entry32, entry64, entry32l]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
