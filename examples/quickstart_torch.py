"""Quickstart on the PyTorch/CUDA port: build a DILI through the
`repro_torch.api.LearnedIndex` facade, run batched lookups and range
queries, write through the overlay, flush, and compare against baselines.
Engine choice is one argument; the index lives on the GPU unless
`--device cpu` asks for the CPU:

    PYTHONPATH=src python examples/quickstart_torch.py [local|pallas|sharded]
        [--device cuda|cpu] [--keys 200000]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import IndexConfig, LearnedIndex
from repro_torch.core import search as S
from repro_torch.core.baselines import BinS, RMI
from repro_torch.data.datasets import generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("engine", nargs="?", default="local",
                    choices=("local", "pallas", "sharded"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--keys", type=int, default=200_000)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    engine = args.engine
    print(f"== DILI quickstart ({engine} engine, {args.device}) ==")
    keys = generate("logn", args.keys, seed=1)
    vals = np.arange(len(keys), dtype=np.int64)

    t0 = time.time()
    ix = LearnedIndex.build(keys, vals,
                            config=IndexConfig(engine=engine,
                                               sample_stride=4),
                            device=dev)
    st = ix.stats()
    print(f"bulk load: {len(keys):,} keys in {time.time() - t0:.1f}s; "
          f"stats: {st}")

    rng = np.random.default_rng(0)
    q = keys[rng.integers(0, len(keys), 8192)]
    v, found = ix.lookup(q)
    assert found.all()
    print(f"batched lookup: 8192/8192 found; "
          f"device bytes {st['device_bytes'] / 1e6:.1f} MB")

    # range queries: O(log n + max_hits) sorted-pair bisection
    starts = rng.integers(0, len(keys) - 101, 1024)
    ks, vs, cnt = ix.range(keys[starts], keys[starts + 100], max_hits=128)
    print(f"range: 1024 x 100-key windows, avg hits "
          f"{float(cnt.mean()):.1f}")

    # updates (Algorithms 7/8): overlay-visible immediately, folded on flush
    new = np.setdiff1d(np.unique(rng.uniform(keys[0], keys[-1], 1000)), keys)
    ix.upsert(new, 10_000_000 + np.arange(len(new)))
    ix.delete(keys[5])
    v2, f2 = ix.lookup(new)
    _, fdel = ix.lookup(keys[5])
    print(f"after {len(new)} upserts + 1 delete (pre-flush): new keys found "
          f"= {bool(f2.all())}, deleted hidden = {not fdel[0]}")
    ix.flush()
    v2, f2 = ix.lookup(new)
    print(f"after flush: new keys found = {bool(f2.all())}; "
          f"epoch = {ix.epoch}")

    # baseline comparison (probe counts: the paper's cache-miss economy)
    qd = torch.from_numpy(q).to(dev)
    for B in (BinS, RMI):
        bst = B.build(keys, vals)
        _, fb, pr = B.lookup(B.device(bst, device=dev), qd)
        print(f"{B.name}: found={bool(fb.all())}, "
              f"avg probes={float(pr.double().mean()):.1f}")
    # the sharded engine keeps one snapshot a shard, none for the index
    if engine != "sharded":
        _, _, nodes, probes = S.search_batch(ix.snapshot, qd,
                                             with_stats=True)
        print(f"DILI: avg nodes={float(nodes.double().mean()):.2f}, "
              f"avg probes={float(probes.double().mean()):.2f}")
    ix.close()


if __name__ == "__main__":
    main()
