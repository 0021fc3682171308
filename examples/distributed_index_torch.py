"""Distributed DILI through the facade, on the PyTorch/CUDA port: the
sharded engine range-partitions the key space into 8 shards (learned
router = quantile boundaries), with per-shard overlays for online updates
— all behind the same `LearnedIndex` API as the local engine.  The port
keeps every shard on the one device (`IndexConfig.n_shards`); each
shard's search is one launch of the lookup kernel on a GPU:

    PYTHONPATH=src python examples/distributed_index_torch.py
        [--device cuda|cpu] [--keys 200000]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import IndexConfig, LearnedIndex
from repro_torch.data.datasets import generate

SHARDS = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--keys", type=int, default=200_000)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}, shards: {SHARDS}")
    keys = generate("books", args.keys, seed=2)
    rng = np.random.default_rng(1)
    qi = rng.integers(0, len(keys), 8192)
    q = keys[qi]

    for strategy in ("gather", "a2a"):
        ix = LearnedIndex.build(
            keys, config=IndexConfig(engine="sharded", sample_stride=4,
                                     n_shards=SHARDS,
                                     lookup_strategy=strategy),
            device=dev)
        ix.lookup(q)                                   # warm
        t0 = time.time()
        v, f = ix.lookup(q)
        dt = time.time() - t0
        correct = np.array_equal(v[f], qi[f])
        print(f"{strategy:7s}: found {int(f.sum())}/{len(f)} "
              f"correct={correct}  {len(qi) / dt / 1e3:.0f}K lookups/s")
        if strategy != "gather":
            ix.close()
            continue

        # online updates: per-shard overlays, visible before any merge
        new = np.setdiff1d(np.unique(rng.uniform(keys[0], keys[-1], 2000)),
                           keys)[:1024]
        ix.upsert(new, 5_000_000 + np.arange(len(new)))
        ix.delete(keys[qi[:256]])
        vn, fn = ix.lookup(new)
        _, fd = ix.lookup(np.unique(keys[qi[:256]]))
        print(f"         upserts visible={bool(fn.all())}, "
              f"deletes hidden={not fd.any()}  (pre-merge)")
        ix.flush()                     # per-shard fold + republish
        print(f"         after flush: epoch={ix.epoch}  "
              f"stats={ix.stats()['pending_writes']} pending")
        ix.close()

        # indexed range queries: per-shard bisection, then assembly
        starts = rng.integers(0, len(keys) - 101, 4096)
        ix2 = LearnedIndex.build(keys,
                                 config=IndexConfig(engine="sharded",
                                                    sample_stride=4,
                                                    n_shards=SHARDS),
                                 device=dev)
        ix2.range(keys[starts], keys[starts + 100])    # warm
        t0 = time.time()
        ks, vs, counts = ix2.range(keys[starts], keys[starts + 100],
                                   max_hits=128)
        dt = time.time() - t0
        print(f"range  : {len(starts)} x 100-key windows, "
              f"avg hits {float(counts.mean()):.1f}  "
              f"{len(starts) / dt / 1e3:.0f}K ranges/s")
        ix2.close()


if __name__ == "__main__":
    main()
