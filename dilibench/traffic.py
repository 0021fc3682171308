"""A traffic mix, made from the run's seed before the window: the general
generator behind every `traffic/<mix>.json`.

A mix file holds the loop (`"loop": "closed"`, `"clients": 1`: one client
sends its next call when the last one has returned; nothing is queued,
shed or timed out), `pool_calls`, and `spec`: the fields of the frozen
`gen.generator.WorkloadSpec` (op shares `lookup`/`upsert`/`delete`/
`range_` chosen per call, `distribution`, `theta`, `batch_size` ops a
call, `miss_frac`, `insert_frac`, `scan_len`, `max_hits`, ...).  The
frozen `gen.generator.generate_stream` expands the spec into `pool_calls`
calls over the configuration's keys; the window sends them in order and
starts again at the first when it reaches the end.  A payload written in
the k-th pass through the pool is the generated one plus k times the
payloads one pass writes, so no two writes in a run carry the same
payload.

A mix may also name a YCSB `keychooser` (`gen.ycsb.KEYCHOOSERS`, e.g.
`"scrambled_zipfian"`): the records that every lookup and update touches
are then drawn by it over the loaded records (record r is the key whose
payload is r), in place of the keys the spec's `distribution` drew; the
spec still gives the calls' ops, sizes and payloads.  Such a mix reads
and updates loaded records only (no misses, inserts, deletes or ranges).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .data import Data
from .gen import ycsb
from .gen.generator import OpBatch, WorkloadSpec, generate_stream

WRITES = ("upsert", "delete")


@dataclass(frozen=True)
class Pool:
    batches: list        # the generated OpBatch of each call of one pass
    val_span: int        # payloads written by one pass
    max_hits: int        # a range call's window (the spec's `max_hits`)

    def __len__(self) -> int:
        return len(self.batches)

    def call(self, i: int) -> OpBatch:
        """The i-th call of the window."""
        b = self.batches[i % len(self.batches)]
        k = i // len(self.batches)
        if b.op == "upsert" and k:
            b = replace(b, vals=b.vals + k * self.val_span)
        return b


def inserts_needed(mix: dict) -> int:
    """Fresh keys the mix may draw (an upper bound: every op of the pool)."""
    s = mix["spec"]
    if not s.get("insert_frac", 0.0) or not s.get("upsert", 0.0):
        return 0
    return int(mix["pool_calls"]) * int(s["batch_size"])


def make_pool(mix: dict, data: Data, seed: int) -> Pool:
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError("the harness drives a closed loop of one client")
    spec = WorkloadSpec(seed=seed, **mix["spec"])
    spec = replace(spec, n_ops=int(mix["pool_calls"]) * spec.batch_size)
    val_base = int(data.vals.max()) + 1
    batches = generate_stream(spec, data.keys, insert_pool=data.insert_pool,
                              val_base=val_base)
    if "keychooser" in mix:
        batches = choose_keys(batches, spec, mix["keychooser"], data, seed)
    span = sum(len(b.keys) for b in batches if b.op == "upsert")
    return Pool(batches, span, spec.max_hits)


def choose_keys(batches: list, spec: WorkloadSpec, chooser: str,
                data: Data, seed: int) -> list:
    """The batches with every key redrawn by the YCSB key chooser
    `chooser`, in one draw over the whole pool."""
    if spec.miss_frac or spec.insert_frac or spec.delete or spec.range_:
        raise ValueError("a keychooser reads and updates loaded records "
                         "only: no misses, inserts, deletes or ranges")
    n = len(data.keys)
    if not np.array_equal(np.sort(data.vals), np.arange(n)):
        raise ValueError("a keychooser needs the payloads 0..n-1 as "
                         "record numbers")
    by_record = np.empty(n)
    by_record[data.vals] = data.keys
    rng = np.random.default_rng([seed, 3])
    recs = ycsb.KEYCHOOSERS[chooser](rng, n, sum(b.n_ops for b in batches))
    out, at = [], 0
    for b in batches:
        out.append(replace(b, keys=by_record[recs[at:at + b.n_ops]]))
        at += b.n_ops
    return out
