"""One run of one cell: make the data and the traffic from the seed, build
the index, warm up the cell's own shapes, drive the closed loop for the
window, then compare the answers with the plain reference and reduce the
records to the cell's metrics.

The loop has one client and no queue, deadline or timeout: it sends call
i + 1 when call i has returned, from the first call until the call that is
running when `seconds` have passed has returned.  The window is that span,
and every rate is all the work of all of its calls over all of its
seconds.  A call that raises is counted, and the loop goes on.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from . import check, data as D, manifest as M, peaks, traffic as T
from .trace import CallRec, DeviceTrace, Records, busy_s, device_ops, \
    idle_gaps

KEEP_LANES = 1 << 23     # read lanes a run keeps for the comparison
                         # beyond the first pass through the pool
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def index_config(spec: dict, telemetry: bool, overrides: dict | None):
    """The configuration's `IndexConfig`: its stated fields over the
    defaults, telemetry on in the traced run only."""
    from repro_torch.api import IndexConfig
    d = IndexConfig().to_json_dict()
    for k, v in spec.items():
        d[k] = dict(d[k], **v) if isinstance(d.get(k), dict) else v
    d.update(overrides or {}, telemetry=telemetry)
    return IndexConfig.from_json_dict(d)


def execute(ix, b, max_hits: int):
    """Send one call to the facade; a read's answer, None for a write."""
    if b.op == "lookup":
        return ix.lookup(b.keys)
    if b.op == "range":
        return ix.range(b.lo, b.hi, max_hits)
    if b.op == "upsert":
        ix.upsert(b.keys, b.vals)
    elif b.op == "delete":
        ix.delete(b.keys)
    else:
        raise ValueError(f"unknown op {b.op!r}")
    return None


def warm_up(ix, pool: T.Pool, data: D.Data) -> None:
    """Run each shape the window sends once, and a merge when it writes,
    leaving the index's content as built: the writes put back the loaded
    payloads of loaded keys."""
    seen = set()
    for b in pool.batches:
        if b.op in seen or b.op not in ("lookup", "range"):
            continue
        seen.add(b.op)
        for _ in range(2):
            execute(ix, b, pool.max_hits)
    writes = [b for b in pool.batches if b.op in T.WRITES]
    if writes:
        n = max(len(b.keys) for b in writes)
        rng = np.random.default_rng(0)
        pick = np.sort(rng.choice(len(data.keys), min(n, len(data.keys)),
                                  replace=False))
        k, v = data.keys[pick], data.vals[pick]
        if any(b.op == "delete" for b in writes):
            ix.delete(k)
        ix.upsert(k, v)
        ix.flush()


def run_cell(cell: M.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: dict | None = None,
             log=_stderr) -> dict:
    """Run `cell` once on `device`; the result object `run.py` prints (its
    `check` entry last)."""
    import torch
    from repro_torch.api import LearnedIndex
    device = torch.device(device)
    cuda = device.type == "cuda"

    data = D.make(cell.config["data"], seed, T.inserts_needed(cell.traffic))
    pool = T.make_pool(cell.traffic, data, seed)
    cfg = index_config(cell.config["index"], trace, overrides)
    t0 = time.perf_counter()
    ix = LearnedIndex.build(data.keys, data.vals, config=cfg, device=device)
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"built {len(data.keys)} keys in {build_s:.3f} s: kernel tables "
        f"{ix.kernel_stats.get('table_bytes')} B, device snapshot "
        f"{ix.stats().get('device_bytes')} B, max depth "
        f"{ix.stats().get('max_depth')}")
    warm_up(ix, pool, data)
    if cuda:
        torch.cuda.synchronize()
    merges0 = ix.n_merges

    calls: list[CallRec] = []
    answers: dict = {}
    keep_k = max(1, KEEP_LANES // max(1, pool.batches[0].n_ops))
    reservoir: list[int] = []
    n_reads = 0
    keep_rng = np.random.default_rng([seed, 4])
    tracer = DeviceTrace(device) if trace else None
    if tracer:
        tracer.__enter__()
    setup_s = time.perf_counter() - t_start
    deadline = time.perf_counter() + seconds
    i = 0
    while True:
        b = pool.call(i)
        a = time.perf_counter()
        try:
            out, ok = execute(ix, b, pool.max_hits), True
        except Exception as e:       # counted as failed; the loop goes on
            out, ok = None, False
            if not any(not c.ok for c in calls):
                log(f"call {i} ({b.op}) raised: {e!r}")
        z = time.perf_counter()
        calls.append(CallRec(b.op, a, z, b.n_ops, i % len(pool), ok))
        if out is not None:
            if i < len(pool):
                answers[i] = out
            else:                    # a uniform sample of the later reads
                if len(reservoir) < keep_k:
                    reservoir.append(i)
                    answers[i] = out
                else:
                    j = int(keep_rng.integers(0, n_reads + 1))
                    if j < keep_k:
                        del answers[reservoir[j]]
                        reservoir[j] = i
                        answers[i] = out
                n_reads += 1
        i += 1
        if z >= deadline:
            break
    if tracer:
        tracer.__exit__(None, None, None)
    window = (calls[0].t0, calls[-1].t1)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    merges = ix.n_merges - merges0
    spans = [(s.name, s.t0, s.dur_s) for s in ix.telemetry.spans.spans()
             if window[0] <= s.t0 <= window[1]]
    ix.close()
    del ix
    if cuda:
        torch.cuda.empty_cache()

    cmp = check.compare(data, pool, calls, answers)
    numbers = cmp["numbers"]
    correct = check.verdict(numbers) and cmp["lanes"] > 0
    rec = Records(cell=cell.name, setup_s=setup_s, build_s=build_s,
                  window=window, calls=calls, merges=merges,
                  device=tracer.events if tracer else [], spans=spans)
    if trace:
        for p in range(len(pool)):
            if p in answers and pool.batches[p].op == "lookup":
                rec.distinct_found[p] = peaks.distinct_found(
                    pool.batches[p].keys, answers[p][1])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = M.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(sum(c.n for c in calls)),
        "failed": int(numbers["wrong_lanes"] + numbers["raised_ops"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"].update(busy_s=busy_s(rec), window_s=rec.window_s)
        result["breakdown"] = {"device_ops": device_ops(rec)[:10],
                               "idle_gaps": idle_gaps(rec)[:10]}
    log(f"window {rec.window_s:.3f} s, {len(calls)} calls, "
        f"{result['attempted']} ops, {merges} merges; compared "
        f"{cmp['lanes']} read lanes of {cmp['calls']} calls")
    result["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in numbers.items()}
    return result


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def print_result(result: dict, log=_stderr) -> None:
    for k, v in result["check"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
