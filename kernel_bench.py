#!/usr/bin/env python3
"""Lever bench of the CUDA lookup kernel on one NVIDIA GPU.

    python3 kernel_bench.py [--keys 1000000] [--f32-keys 250000] [--seed 0]
                            [--baseline SRC ...] [--cache DIR] [--build-only]

Builds the tables chip_smoke.py's main paths search, without the
facades: the local engine's f64/i64 tables over `--keys` logn keys, the
local engine's f32/i64 tables over `--f32-keys` logn keys made exact in
f32 (placed in f64), and the `pallas` engine's f32/i32 tables over
`--f32-keys` (placed in f32); the i64 instances with a 4096-entry overlay
of 1000 upserts and 1000 tombstones and its membership filter, as the
local path leaves pending.  On a 2^20-query batch (half hits, half
midpoint misses) it prints the replay's sectors by tree level and the
kernels' occupancy, holds each kernel below bit-equal to the plain
version and times it: this checkout's kernel, for the i64 instances also
with the mirror's filter left out and the walk alone (no overlay), and
the kernel of each `--baseline` source (another copy of
csrc/dili_search.cu, PR 15's or this one with a choice edited; see
chip_smoke.Baseline), with the overlay and alone.  Warm ms from
CUDA-graph replays taken in turns, with their spread, and cold-L2 ms.  It
prints one JSON line of the medians last.

`--cache DIR` keeps the flattened trees as .npz files (the host bulk
load of 1M keys takes minutes); `--build-only` fills the cache on a
machine without a GPU and exits.  Needs torch with CUDA, nvcc and
nvidia-smi otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 1 << 20
FLAT_FIELDS = ("a", "b", "base", "fo", "dense", "tag", "key", "val")


def flat_of(name: str, n_keys: int, seed: int, cache: str | None) -> dict:
    """The columns of a flattened logn build: "f64" (f64 keys), "f32_i64"
    (keys made exact in f32, placed in f64) or "f32" (placed in f32)."""
    path = Path(cache) / f"{name}_{n_keys}_{seed}.npz" if cache else None
    if path is not None and path.exists():
        z = np.load(path)
        return {k: z[k] for k in z.files}
    from repro_torch.core.dili import bulk_load
    from repro_torch.core.flat import flatten
    from repro_torch.data.datasets import generate
    from repro_torch.kernels.ops import build_f32_index
    t0 = time.perf_counter()
    raw = generate("logn", n_keys, seed)
    if name == "f32":
        d, keys = build_f32_index(raw)
    else:
        keys = (raw if name == "f64" else
                np.unique(raw.astype(np.float32)).astype(np.float64))
        d = bulk_load(keys, np.arange(len(keys), dtype=np.int64))
    f = flatten(d)
    cols = {k: getattr(f, k) for k in FLAT_FIELDS}
    cols.update(root=np.int64(f.root), max_depth=np.int64(f.max_depth),
                keys=np.asarray(keys, np.float64))
    print(f"{name}: built {len(keys)} keys in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **cols)
    return cols


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--f32-keys", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", metavar="SRC", action="append",
                    default=[])
    ap.add_argument("--cache", metavar="DIR")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    plan = (("f64", args.keys), ("f32_i64", args.f32_keys),
            ("f32", args.f32_keys))
    if args.build_only:
        for name, n in plan:
            flat_of(name, n, args.seed, args.cache)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import dili_search as D
    from repro_torch.kernels.ops import pack_tables, table_bytes
    dev = torch.device("cuda")
    card = C.card_line()
    print(f"card: {card}", flush=True)
    D.kernel.build()
    for line in D.kernel.ptxas_report.splitlines():
        print(f"  {line.strip()}", flush=True)
    baselines = {src: C.Baseline(src) for src in args.baseline}
    summary = dict(card=card, instances={})
    for name, n in plan:
        cols = flat_of(name, n, args.seed, args.cache)
        keys = cols.pop("keys")
        rng = np.random.default_rng(args.seed + 5)
        kdt = torch.float64 if name == "f64" else torch.float32
        arrs = pack_tables(cols, device=dev, dtype=kdt,
                           val_dtype=None if name == "f32" else torch.int64)
        mids = (keys[:-1] + keys[1:]) / 2
        q_np = np.concatenate([keys[rng.integers(0, len(keys), BATCH // 2)],
                               mids[rng.integers(0, len(mids), BATCH // 2)]])
        q = torch.from_numpy(q_np.astype(
            np.float64 if name == "f64" else np.float32)).to(dev)
        ov = None if name == "f32" else C.make_overlay(
            keys, rng, dev, n_up=1000, n_dead=1000, dtype=kdt, cap=4096)
        print(f"{name}: {len(keys)} keys, {arrs['node_rec'].shape[0]} "
              f"nodes, {arrs['slot_rec'].shape[0]} slots, max_depth "
              f"{arrs['max_depth']}, tables {table_bytes(arrs)} B"
              + ("" if ov is None else
                 f", overlay capacity {ov['keys'].numel()}"), flush=True)
        C.replay_checked(arrs, q, ov, f"{name} timed batch")
        C.print_occupancy(arrs)
        want = {False: C.pair(arrs, q, plain=True, ov=ov)}
        fns = {"new": lambda: C.pair(arrs, q, ov=ov)}
        if ov is not None:
            want[True] = C.pair(arrs, q, plain=True)
            bare = {k: ov[k] for k in ("keys", "vals", "tomb")}
            fns["new no-filter"] = lambda: C.pair(arrs, q, ov=bare)
            fns["new walk"] = lambda: C.pair(arrs, q)
        for src, b in baselines.items():
            fns[src] = lambda b=b: b.pair(arrs, q, ov)
            if ov is not None:
                fns[src + " walk"] = lambda b=b: b.pair(arrs, q)
        for k, fn_k in fns.items():
            for g, w in zip(fn_k(), want["walk" in k]):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} {k}: differs from the "
                                         f"plain version")
        print(f"{name}: {len(fns)} kernels bit-equal to the plain version "
              f"on the batch", flush=True)
        rounds = C.graph_rounds(fns)
        res = {}
        for k, fn_k in fns.items():
            res[k] = dict(ms=float(np.median(rounds[k])),
                          cold_ms=C.cold_l2_ms(fn_k, dev, 20),
                          spread=float(max(rounds[k]) - min(rounds[k])))
            print(f"  {name} {k} warm {res[k]['ms']:.5f} ms (rounds "
                  f"{[round(x, 5) for x in rounds[k]]}), cold "
                  f"{res[k]['cold_ms']:.5f} ms", flush=True)
        summary["instances"][name] = res
        del arrs, q, ov, fns
        torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
