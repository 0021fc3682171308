#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--keys 1000000] [--seed 0]

Phases (any failure exits nonzero; nothing falls back to the CPU):
  1. card and build: prints the card's name and power limit, builds the
     CUDA lookup kernel from `src/repro_torch/kernels/csrc/` with nvcc;
  2. kernel against its plain version: at 20k keys and at the main index,
     the CUDA triple (val, found, needs_fallback) must equal the plain
     PyTorch version's bit for bit on hits, midpoint misses, +inf pad lanes
     and queries above the key range, a ragged batch of 777, a table
     with dense leaves, and the 2^20-lane batch that phase 4 times;
  3. main path: `LearnedIndex.build` on `--keys` logn keys (f32, unique)
     with engine="pallas" on CUDA, lookups in 2^20-query batches, 4096
     range queries, a few thousand upserts and deletes, flush, lookups
     again and `items()` — each checked against a numpy truth;
  4. numbers: kernel launches during the main path, the flagged-lane
     share, lanes the pair-table recheck changed, kernel / plain version /
     whole lookup ms per 2^20-query batch, table bytes, build and flatten
     seconds, and the kernel's bound from the distinct table words this
     run's walk reads (a torch replay of the walk, held to the kernel).
The last two lines are the kernels JSON object and the `{"ok": true, ...}`
result.  Needs `torch` with CUDA, `nvcc`, and `nvidia-smi`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 1 << 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM data sheet, non-tensor f32
NAMES = ("a", "b", "base", "fo", "dense", "tag", "key", "val", "root")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def triple(arrs, q, plain: bool):
    from repro_torch.kernels.dili_search import dili_search
    from repro_torch.kernels.ref import dili_search_ref
    fn = dili_search_ref if plain else dili_search
    return fn(*(arrs[k] for k in NAMES), q, max_depth=arrs["max_depth"])


def lane_sets(keys32: np.ndarray, rng, device) -> dict:
    import torch
    mids = ((keys32[:-1].astype(np.float64) + keys32[1:]) / 2).astype(
        np.float32)
    hits = keys32[rng.integers(0, len(keys32), min(BATCH, len(keys32)))]
    above = np.concatenate([np.full(2048, np.inf),
                            [3e9, 1e30, keys32[-1] * 2.0, keys32[-1] + 1.0,
                             np.finfo(np.float32).max]])
    sets = dict(hits=hits,
                misses=mids[rng.integers(0, len(mids),
                                         min(BATCH, len(mids)))],
                pad_and_above=above, ragged_777=keys32[:777])
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        device) for k, v in sets.items()}


def kernel_vs_plain(arrs, sets: dict, label: str) -> float:
    """Bit equality of the kernel and its plain version on every lane set;
    returns the max |difference| seen (0.0 when equal)."""
    import torch
    worst = 0.0
    for name, q in sets.items():
        got = triple(arrs, q, plain=False)
        want = triple(arrs, q, plain=True)
        for g, w, what in zip(got, want, ("val", "found", "fallback")):
            diff = (g.long() - w.long()).abs().max().item() if g.numel() else 0
            worst = max(worst, float(diff))
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{label}/{name}: kernel {what} differs "
                                     f"from the plain version on {bad} lanes")
        flagged = int(got[2].sum())
        print(f"  {label}/{name}: {q.numel()} lanes bit-equal, "
              f"{flagged} flagged needs_fallback", flush=True)
    return worst


def walk_reads(arrs, q):
    """Replay the kernel's walk (csrc/dili_search.cu) with torch ops on
    q's device and record which table words it reads: `dense` of every node
    visited; `a`, `b`, `fo`, `base` of a non-dense node; `tag` of every slot
    reached; `val` of a CHILD slot or of a PAIR whose key equals the query;
    `key` of a PAIR.  Returns (triple, distinct words read per table,
    non-dense levels visited)."""
    import torch
    from repro_torch.core.flat import TAG_CHILD, TAG_EMPTY, TAG_PAIR
    from repro_torch.core.search import predict_slot
    nq, dev = q.numel(), q.device
    out = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    hit = torch.zeros(nq, dtype=torch.bool, device=dev)
    done = torch.zeros(nq, dtype=torch.bool, device=dev)
    flag = torch.zeros(nq, dtype=torch.bool, device=dev)
    reads = {k: [] for k in ("a", "b", "base", "fo", "dense", "tag", "key",
                             "val")}
    lanes = torch.arange(nq, device=dev)
    node = arrs["root"].long().expand(nq)
    levels = 0
    for _ in range(arrs["max_depth"]):
        if lanes.numel() == 0:
            break
        reads["dense"].append(node)
        dn = arrs["dense"][node] > 0
        flag[lanes[dn]] = True
        done[lanes[dn]] = True
        lanes, node = lanes[~dn], node[~dn]
        for k in ("a", "b", "fo", "base"):
            reads[k].append(node)
        levels += node.numel()
        qq = q[lanes]
        pos = predict_slot(arrs["a"][node], arrs["b"][node], qq,
                           arrs["fo"][node])
        s = (arrs["base"][node] + pos).long()
        reads["tag"].append(s)
        t = arrs["tag"][s]
        child, pair = t == TAG_CHILD, t == TAG_PAIR
        reads["key"].append(s[pair])
        eq = pair & (arrs["key"][s] == qq)
        reads["val"] += [s[child], s[eq]]
        out[lanes[eq]] = arrs["val"][s[eq]]
        hit[lanes[eq]] = True
        term = pair | (t == TAG_EMPTY)
        done[lanes[term]] = True
        node = torch.where(child, arrs["val"][s].long(), node)
        lanes, node = lanes[~term], node[~term]
    words = {k: int(torch.unique(torch.cat(v)).numel()) if v else 0
             for k, v in reads.items()}
    return (out, hit, flag | ~done), words, levels


def truth_lookup(tk: np.ndarray, tv: np.ndarray, q: np.ndarray):
    i = np.clip(np.searchsorted(tk, q), 0, len(tk) - 1)
    hit = tk[i] == q
    return np.where(hit, tv[i], -1), hit


def check_lookup(ix, tk, tv, q, label):
    t0 = time.perf_counter()
    v, f = ix.lookup(q)
    dt = time.perf_counter() - t0
    want_v, want_f = truth_lookup(tk, tv, q.astype(np.float32).astype(
        np.float64))
    if not np.array_equal(f, want_f) or not np.array_equal(v[f], want_v[f]):
        raise AssertionError(f"{label}: lookup disagrees with the truth on "
                             f"{int((f != want_f).sum())} found flags")
    return dt


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


def _apply(tk, tv, up_k, up_v, dead):
    from repro_torch.core.flat import merge_sorted_runs
    k = np.concatenate([up_k, dead])
    v = np.concatenate([up_v, np.zeros(len(dead), np.int64)])
    t = np.concatenate([np.zeros(len(up_k), np.int8),
                        np.ones(len(dead), np.int8)])
    return merge_sorted_runs(tk, (tv, np.zeros(len(tk), np.int8)), k, (v, t))


def cuda_ms(fn, reps: int) -> float:
    """Median ms of `fn()` over `reps` runs, each between CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_breakdown(fn, reps: int = 3) -> None:
    """Print the device time of `reps` calls of `fn` by kernel / copy name
    (torch.profiler's CUDA events) and the device's busy share of the
    wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not by_name:
        print("where the time goes: not measured (the profiler saw no "
              "device events)", flush=True)
        return
    busy = sum(by_name.values())
    print(f"where the time goes, per lookup call: wall {wall_us / reps:.1f} "
          f"us, device busy {busy / reps:.1f} us ({busy / wall_us:.4f} of "
          f"wall, idle {1 - busy / wall_us:.4f}); top device entries:",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / reps:10.1f} us  {name[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.flat import flatten
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.dili_search import kernel
    from repro_torch.data.datasets import generate
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # -- 1. card and build ----------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    kernel.build()
    print(f"build: dili_search.cu built and loaded in {kernel.build_s:.3f} s",
          flush=True)

    # -- 2. kernel against its plain version, 20k keys ------------------------
    d, k20 = K.build_f32_index(generate("logn", 20_000, args.seed))
    f20 = flatten(d)
    arrs20 = K.kernel_arrays(f20, device=dev)
    print(f"kernel vs plain at {len(k20)} keys ({int(f20.dense.sum())} dense "
          f"leaves of {f20.n_nodes} nodes):", flush=True)
    if not f20.dense.any():
        raise AssertionError("the 20k logn table has no dense leaf")
    max_err = kernel_vs_plain(arrs20, lane_sets(k20, rng, dev), "20k")

    # -- 3. main path, counted ------------------------------------------------
    kernel.launches = 0
    ix, tk, tv, info = main_path(args.keys, args.seed, dev)
    launches = kernel.launches
    ks = ix.kernel_stats
    if launches == 0:
        raise AssertionError("the main path launched the kernel no time")
    share = ks["flagged"] / max(ks["lanes"], 1)
    print(f"main: kernel launches {launches} over {ks['lookups']} lookup "
          f"calls; lanes flagged needs_fallback {ks['flagged']} of "
          f"{ks['lanes']} ({share:.4f}); pair-table recheck changed "
          f"{ks['recheck_changed']} lanes", flush=True)

    # -- 2b. kernel against its plain version at the main index ---------------
    flat = flatten(ix.host)
    arrs = K.kernel_arrays(flat, device=dev)
    print(f"kernel vs plain at the main index ({len(tk)} keys, "
          f"{int(flat.dense.sum())} dense leaves of {flat.n_nodes} nodes):",
          flush=True)
    keys32 = tk.astype(np.float32)
    max_err = max(max_err, kernel_vs_plain(arrs, lane_sets(keys32, rng, dev),
                                           "main"))

    # -- 4. times and bound at 2^20-query batches -----------------------------
    q_np = next(lookup_batches(tk, rng, 1)).astype(np.float32)
    q = torch.from_numpy(q_np).to(dev)
    max_err = max(max_err, kernel_vs_plain(arrs, {"timed_2^20": q}, "main"))
    for _ in range(3):
        triple(arrs, q, plain=False)
    ms = cuda_ms(lambda: triple(arrs, q, plain=False), 50)
    plain_ms = cuda_ms(lambda: triple(arrs, q, plain=True), 5)
    ix.lookup(q_np)
    lookup_ms = float(np.median([check_lookup(ix, tk, tv, q_np, "timed")
                                 for _ in range(5)])) * 1e3
    device_breakdown(lambda: ix.lookup(q_np))
    # bound: the queries in, the triple out, and each distinct 4-byte table
    # word this batch's walk reads, once (the replay's triple must be the
    # kernel's, so the words counted are the ones the kernel reads)
    replay, words, levels = walk_reads(arrs, q)
    for r, k, what in zip(replay, triple(arrs, q, plain=False),
                          ("val", "found", "fallback")):
        if not torch.equal(r, k):
            raise AssertionError(f"walk replay {what} differs from the kernel")
    table_read = 4 * (sum(words.values()) + 1)           # + the root word
    moved = q.numel() * (4 + 4 + 1 + 1) + table_read
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * levels / F32_FLOPS * 1e3        # one mul + one add a level
    bound_ms = max(bytes_ms, ops_ms)
    print(f"time per 2^20-query batch on {card}: kernel {ms:.4f} ms, plain "
          f"version {plain_ms:.4f} ms, whole lookup {lookup_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({moved} B over HBM: {table_read} B of "
          f"the {K.table_bytes(arrs)} B tables, distinct words read {words}; "
          f"{levels} non-dense levels visited)", flush=True)
    print(f"sizes: {info['n_keys']} keys, table {info['table_bytes']} B, "
          f"bulk load {info['build_s']:.3f} s, flatten "
          f"{info['flatten_s']:.3f} s, flush {info['flush_s']:.3f} s; "
          f"facade lookup ms per batch in the main path "
          f"{[round(x, 3) for x in info['lookup_ms']]}", flush=True)
    ix.close()

    print(card, flush=True)
    print(json.dumps({"kernels": [dict(
        name="dili_search", route="cuda",
        source="src/repro_torch/kernels/csrc/dili_search.cu",
        replaces="src/repro/kernels/dili_search.py:34",
        launches=launches, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
