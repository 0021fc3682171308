"""Open-loop load generator + saturation search (DESIGN.md section 15).

Open loop means arrivals are scheduled by a clock, not by completions:
request i's arrival time is `t0 + (ops before i) / rate`, fixed up
front.  A client thread that falls behind (because the system is slow)
does NOT slow the schedule down — it submits late, and the request's
latency is still measured from the *scheduled* arrival.  This is the
standard guard against coordinated omission: a closed loop would let a
stalled server throttle its own load and report flattering tails.

Requests are dealt round-robin to `n_clients` client threads, each
driving its own `ServeClient` handle in schedule order.  Admission
rejections (`RejectedError`) count as shed ops — shed is a *result* (the
system refusing load), never an error.

`saturation_search` ramps the offered rate geometrically until the
system stops keeping up (achieved < keep_up_frac x offered, or shed
above tolerance) and returns the last sustained rate — the knee the
50%/80%/95% latency legs of a serving benchmark hang off.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..obs import latency_summary
from .batcher import RejectedError, Request

#: request-payload field mapping per op (OpBatch -> submit kwargs)
_PAYLOAD = {
    "lookup": lambda b: dict(keys=b.keys),
    "upsert": lambda b: dict(keys=b.keys, vals=b.vals),
    "delete": lambda b: dict(keys=b.keys),
    "range": lambda b: dict(lo=b.lo, hi=b.hi),
}


@dataclass
class LoadReport:
    """One open-loop leg: offered vs achieved rate + e2e latency tails."""
    offered_ops_per_s: float
    n_clients: int
    n_reqs: int = 0
    n_ops: int = 0
    done_ops: int = 0
    shed_ops: int = 0
    failed_ops: int = 0
    wall_s: float = 0.0
    late_submits: int = 0          # reqs submitted > 1ms past schedule
    latency_s: dict = field(default_factory=dict)   # op -> [seconds]

    @property
    def achieved_ops_per_s(self) -> float:
        return self.done_ops / max(self.wall_s, 1e-12)

    @property
    def shed_frac(self) -> float:
        return self.shed_ops / max(self.n_ops, 1)

    def latency_ms(self) -> dict:
        """{op: p50/p95/p99/p999/max/mean ms end-to-end (scheduled
        arrival -> completion)} via the shared percentile recipe."""
        return {op: latency_summary(xs)
                for op, xs in sorted(self.latency_s.items())}

    def to_json_dict(self) -> dict:
        return dict(offered_ops_per_s=self.offered_ops_per_s,
                    achieved_ops_per_s=self.achieved_ops_per_s,
                    n_clients=self.n_clients, n_reqs=self.n_reqs,
                    n_ops=self.n_ops, done_ops=self.done_ops,
                    shed_ops=self.shed_ops, shed_frac=self.shed_frac,
                    failed_ops=self.failed_ops, wall_s=round(self.wall_s, 4),
                    late_submits=self.late_submits,
                    latency_ms=self.latency_ms())


def open_loop(frontend, batches, rate_ops_per_s: float,
              n_clients: int = 4, timeout_s: float = 120.0,
              trace_path: str | None = None) -> LoadReport:
    """Drive `batches` (each one request) through the frontend at a fixed
    offered rate from `n_clients` concurrent client threads.

    Returns after every accepted request completed (the batcher is
    drained) with per-op end-to-end latency samples measured from each
    request's SCHEDULED arrival.  Raises nothing on shed/failed requests
    — they are counted in the report.

    `trace_path` arms causal tracing for this leg (requires the index's
    telemetry to be enabled) and writes the Chrome-trace-event JSON there
    after the drain — open it in Perfetto to see each request's
    queue/exec/facade/WAL/merge chain."""
    tel = getattr(frontend.index, "telemetry", None)
    tracing = trace_path is not None and tel is not None and tel.enabled
    if tracing:
        tel.start_trace()
    report = LoadReport(offered_ops_per_s=float(rate_ops_per_s),
                        n_clients=n_clients)
    report.n_reqs = len(batches)
    # global open-loop schedule: request i arrives after the ops of all
    # earlier requests were offered at the target rate
    offsets, acc = [], 0.0
    for b in batches:
        offsets.append(acc / rate_ops_per_s)
        acc += b.n_ops
    report.n_ops = int(acc)
    lanes = [[] for _ in range(n_clients)]      # (batch, offset) per client
    for i, b in enumerate(batches):
        lanes[i % n_clients].append((b, offsets[i]))
    t0 = time.perf_counter()
    results: list[list[Request]] = [[] for _ in range(n_clients)]
    sheds = [0] * n_clients
    lates = [0] * n_clients

    def drive(ci: int) -> None:
        client = frontend.client(f"lg-{ci}")
        out, shed, late = results[ci], 0, 0
        for b, off in lanes[ci]:
            t_arr = t0 + off
            now = time.perf_counter()
            if t_arr > now:
                time.sleep(t_arr - now)
            elif now - t_arr > 1e-3:
                late += 1
            try:
                out.append(client.submit(b.op, t_arrival=t_arr,
                                         **_PAYLOAD[b.op](b)))
            except RejectedError:
                shed += b.n_ops
        sheds[ci], lates[ci] = shed, late

    threads = [threading.Thread(target=drive, args=(ci,), daemon=True,
                                name=f"loadgen-{ci}")
               for ci in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    frontend.drain(timeout_s)
    report.wall_s = time.perf_counter() - t0
    if tracing:
        tel.trace.dump(trace_path)
        tel.stop_trace()
    report.shed_ops = sum(sheds)
    report.late_submits = sum(lates)
    for reqs in results:
        for r in reqs:
            if r.error is not None:
                report.failed_ops += r.n_ops
                continue
            report.done_ops += r.n_ops
            report.latency_s.setdefault(r.op, []).append(r.latency_s)
    return report


def saturation_search(frontend, make_batches, start_rate: float,
                      factor: float = 1.7, max_legs: int = 8,
                      n_clients: int = 4, keep_up_frac: float = 0.9,
                      shed_tol: float = 0.01,
                      timeout_s: float = 120.0) -> tuple[float, list]:
    """Geometric offered-rate ramp until the system stops keeping up.

    `make_batches(leg_index)` supplies a fresh request list per leg (legs
    mutate the index, so streams must continue, not repeat).  A leg
    "keeps up" when achieved >= keep_up_frac x offered AND shed_frac <=
    shed_tol.  Returns `(saturation_ops_per_s, leg_reports)` where
    saturation is the best *achieved* rate across legs — the classic
    open-loop throughput ceiling even when the last leg over-offered."""
    legs: list[LoadReport] = []
    rate = float(start_rate)
    for leg in range(max_legs):
        rep = open_loop(frontend, make_batches(leg), rate,
                        n_clients=n_clients, timeout_s=timeout_s)
        legs.append(rep)
        kept_up = (rep.achieved_ops_per_s >= keep_up_frac * rate
                   and rep.shed_frac <= shed_tol)
        if not kept_up:
            break
        rate *= factor
    saturation = max(l.achieved_ops_per_s for l in legs)
    return saturation, legs
