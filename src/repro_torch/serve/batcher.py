"""Request batcher/coalescer + admission control (DESIGN.md section 15).

The serving front-end's core: many concurrent client streams submit
single-op requests; ONE worker thread dequeues them in arrival order,
coalesces runs of compatible requests (same op type, and for ranges the
same `max_hits`) into one facade batch, executes it through
`repro_torch.api.LearnedIndex`, and completes each request's future with
its slice of the batched result.

Why this shape:

  * FIFO + prefix coalescing preserves a TOTAL order over all client
    streams — a strict superset of the per-client program order the
    consistency contract requires — and that total order is journaled as
    plain `OpBatch`es, so the exact serialization the concurrent run
    applied can be replayed through `WorkloadRunner` for the oracle
    equivalence check.
  * The worker thread is the facade's single caller, so the engines'
    one-writer threading contract holds by construction; clients never
    touch the index.
  * Admission control is a bounded pending-op queue: a submit that would
    exceed the bound fails immediately with `RejectedError` (load
    shedding — the op is never executed, never journaled, never
    acknowledged), instead of letting queue delay grow without bound.
  * Batch sizing is AIMD over the facade's pow2 padding buckets: the
    coalescer fills up to the bucket boundary (padding makes the extra
    lanes free), grows the target additively under queue pressure, and
    halves it when a batch's service time blows the latency target.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from ..obs.trace_export import mint_trace_id, trace_context
from ..obs.tracing import SERVE_SPANS  # noqa: F401  (re-export convenience)
from ..workloads.generator import OpBatch

#: ops a request may carry — the facade's batched entry points
SERVE_OPS = ("lookup", "range", "upsert", "delete")


class RejectedError(RuntimeError):
    """Admission control shed this request: the queue bound was hit.  The
    op was NOT executed and NOT acknowledged — retry later or back off."""


def pow2_bucket(n: int, floor: int = 64) -> int:
    """The facade's pow2 padding bucket for an n-lane batch (the same
    recipe as `LearnedIndex._pad_batch`): lanes between a bucket boundary
    and the next are free, so the coalescer fills to the boundary."""
    if n <= 0:
        return floor
    return 1 << max(int(np.log2(floor)), int(n - 1).bit_length())


@dataclass
class ServeConfig:
    """Knobs for the serving front-end (batcher + admission + sizing).

    queue_cap_ops    : admission bound — max pending (queued, unexecuted)
                       ops; a submit past it sheds with `RejectedError`.
    min_batch_ops    : AIMD floor = the facade's smallest pow2 pad bucket.
    max_batch_ops    : AIMD ceiling for one coalesced facade batch.
    dwell_s          : how long the worker waits for the batch to fill
                       toward the target before dispatching what it has.
    latency_slo_s    : service-time target per facade batch; one batch
                       over it halves the size target (the MD step).
    aimd_add_ops     : additive size-target increase per pressured batch.
    max_hits         : range window bound all front-end range requests
                       share (compatibility key for coalescing).
    """

    queue_cap_ops: int = 8192
    min_batch_ops: int = 64
    max_batch_ops: int = 2048
    dwell_s: float = 0.0005
    latency_slo_s: float = 0.050
    aimd_add_ops: int = 64
    max_hits: int = 64


class Request:
    """One client op in flight: payload arrays + completion future.

    `t_arrival` is the *intended* arrival time (open-loop load generators
    set it to the scheduled arrival so queueing delay from a late submit
    is charged to the system, not hidden — no coordinated omission);
    it defaults to the submit time.  `wait()` blocks until the batcher
    completed (or failed) the op and returns the op's result."""

    __slots__ = ("op", "keys", "vals", "lo", "hi", "max_hits", "client_id",
                 "t_submit", "t_arrival", "t_done", "result", "error",
                 "trace_id", "_event")

    def __init__(self, op: str, *, keys=None, vals=None, lo=None, hi=None,
                 max_hits: int = 64, client_id: str = "",
                 t_arrival: float | None = None):
        if op not in SERVE_OPS:
            raise ValueError(f"unknown op {op!r}; expected one of "
                             f"{SERVE_OPS}")
        self.op = op
        self.keys = (None if keys is None
                     else np.atleast_1d(np.asarray(keys, np.float64)))
        self.vals = (None if vals is None
                     else np.atleast_1d(np.asarray(vals, np.int64)))
        self.lo = (None if lo is None
                   else np.atleast_1d(np.asarray(lo, np.float64)))
        self.hi = (None if hi is None
                   else np.atleast_1d(np.asarray(hi, np.float64)))
        self.max_hits = int(max_hits)
        self.client_id = client_id
        self.t_submit = time.perf_counter()
        self.t_arrival = self.t_submit if t_arrival is None else t_arrival
        self.t_done: float | None = None
        self.result = None
        self.error: BaseException | None = None
        # causal trace id: minted at construction (i.e. at client submit —
        # `ServeFrontend.submit` builds the Request inline), carried through
        # coalescing so every downstream stage can link back to this request
        self.trace_id = mint_trace_id()
        self._event = threading.Event()

    @property
    def n_ops(self) -> int:
        if self.op == "range":
            return len(self.lo)
        return len(self.keys)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> float | None:
        """End-to-end seconds from (intended) arrival to completion."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival

    def wait(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.op} request not served in "
                               f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    def _complete(self, result=None, error: BaseException | None = None,
                  t_done: float | None = None) -> None:
        self.result = result
        self.error = error
        self.t_done = time.perf_counter() if t_done is None else t_done
        self._event.set()


def compatible(a: Request, b: Request) -> bool:
    """Can these requests share one facade batch?  Same op type, and
    ranges must agree on the window bound (one `max_hits` per call)."""
    return a.op == b.op and (a.op != "range" or a.max_hits == b.max_hits)


def coalesce(pending, cap_ops: int) -> list[Request]:
    """Pop the longest prefix of mutually-compatible requests totalling
    <= `cap_ops` lanes from the deque (the head request is always taken,
    even oversized — it must make progress).  Prefix-only grouping is
    what preserves the cross-client total order."""
    first = pending.popleft()
    group = [first]
    total = first.n_ops
    while pending and compatible(first, pending[0]) \
            and total + pending[0].n_ops <= cap_ops:
        r = pending.popleft()
        group.append(r)
        total += r.n_ops
    return group


class AdaptiveBatchSizer:
    """AIMD target for coalesced batch lanes.

    Observation per dispatched batch: (queue depth in ops at dispatch,
    service seconds).  Service time over the SLO halves the target
    (multiplicative decrease — the batch is too big for the latency
    budget); queue depth above the current target grows it additively
    (there is demand the current size leaves queued).  `cap` rounds the
    target up to the facade's pow2 pad bucket, because lanes up to the
    bucket boundary cost nothing extra."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.target = cfg.min_batch_ops

    def observe(self, queue_depth_ops: int, service_s: float) -> None:
        if service_s > self.cfg.latency_slo_s:
            self.target = max(self.target // 2, self.cfg.min_batch_ops)
        elif queue_depth_ops > self.target:
            self.target = min(self.target + self.cfg.aimd_add_ops,
                              self.cfg.max_batch_ops)

    @property
    def cap(self) -> int:
        return min(pow2_bucket(self.target, self.cfg.min_batch_ops),
                   self.cfg.max_batch_ops)


class RequestBatcher:
    """The serving worker: bounded FIFO queue + coalescing dispatch loop.

    One instance owns one `LearnedIndex` (or anything duck-typed with
    lookup/range/upsert/delete — the batcher unit tests drive a stub).
    `submit()` is called from any number of client threads; everything
    engine-side happens on the single worker thread.  `journal` holds the
    executed facade batches in commit order as `OpBatch`es — feed it to
    `WorkloadRunner.run` to replay the exact serialization."""

    def __init__(self, index, config: ServeConfig | None = None,
                 telemetry=None, journal: bool = True):
        self.index = index
        self.cfg = config or ServeConfig()
        self.sizer = AdaptiveBatchSizer(self.cfg)
        self.tel = telemetry if telemetry is not None \
            else getattr(index, "telemetry", None)
        if self.tel is not None:
            # serve taxonomy lives in the SAME per-index telemetry bundle,
            # so `LearnedIndex.metrics()` exports it alongside merge spans
            self.tel.spans.declare(*SERVE_SPANS)
            self.tel.metrics.declare_histogram(
                *(f"serve.e2e.{op}" for op in SERVE_OPS), "serve.batch.ops")
        self.journal: list[OpBatch] | None = [] if journal else None
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        from collections import deque
        self._pending: deque[Request] = deque()
        self._pending_ops = 0
        self._inflight = 0                  # ops dequeued, not yet done
        self._idle = threading.Condition(self._lock)
        self._stop = False
        # counters (ops unless named otherwise); written by one thread
        # each, read by anyone — plain ints are atomic enough to sample
        self.n_accepted = 0
        self.n_shed = 0
        self.n_completed = 0
        self.n_failed = 0
        self.n_batches = 0
        self.batch_ops: list[int] = []      # per dispatched batch
        self._worker = threading.Thread(target=self._run,
                                        name="serve-batcher", daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Enqueue or shed.  Raises `RejectedError` when the pending-op
        bound is hit (the fast path: one lock, no allocation beyond the
        request itself)."""
        with self._nonempty:
            if self._stop:
                raise RuntimeError("batcher is closed")
            if self._pending_ops + req.n_ops > self.cfg.queue_cap_ops:
                self.n_shed += req.n_ops
                raise RejectedError(
                    f"admission queue full ({self._pending_ops} pending "
                    f"ops, cap {self.cfg.queue_cap_ops})")
            self._pending.append(req)
            self._pending_ops += req.n_ops
            self.n_accepted += req.n_ops
            self._nonempty.notify()
        return req

    @property
    def queue_depth_ops(self) -> int:
        return self._pending_ops

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every accepted request has completed."""
        deadline = time.perf_counter() + timeout
        with self._idle:
            while self._pending or self._inflight:
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError("batcher did not drain in time")
                self._idle.wait(left)

    def close(self) -> None:
        """Stop the worker after serving everything already accepted.
        Idempotent; the queue rejects new submits immediately."""
        with self._nonempty:
            if self._stop:
                return
            self._stop = True
            self._nonempty.notify_all()
        self._worker.join(timeout=60.0)

    def stats(self) -> dict:
        """Racy-but-safe counter sample (plain int reads)."""
        n_b = self.n_batches
        return dict(accepted_ops=self.n_accepted, shed_ops=self.n_shed,
                    completed_ops=self.n_completed,
                    failed_ops=self.n_failed,
                    shed_frac=self.n_shed
                    / max(self.n_accepted + self.n_shed, 1),
                    n_batches=n_b,
                    queue_depth_ops=self._pending_ops,
                    batch_ops_mean=(sum(self.batch_ops[:n_b]) / n_b
                                    if n_b else 0.0),
                    batch_target_ops=self.sizer.target,
                    journal_batches=(len(self.journal)
                                     if self.journal is not None else 0))

    # -- worker side ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._nonempty:
                while not self._pending and not self._stop:
                    self._nonempty.wait()
                if not self._pending:
                    return                          # stopped and drained
                # dwell: give the batch a bounded chance to fill toward
                # the AIMD target before dispatching a fragment
                if (self._pending_ops < self.sizer.target
                        and not self._stop and self.cfg.dwell_s > 0):
                    self._nonempty.wait(self.cfg.dwell_s)
                    if not self._pending:
                        continue
                depth_at_dispatch = self._pending_ops
                group = coalesce(self._pending, self.sizer.cap)
                n = sum(r.n_ops for r in group)
                self._pending_ops -= n
                self._inflight += n
            self._dispatch(group, n, depth_at_dispatch)
            with self._idle:
                self._inflight -= n
                if not self._pending and not self._inflight:
                    self._idle.notify_all()

    def _dispatch(self, group: list[Request], n: int,
                  depth_ops: int) -> None:
        tel = self.tel
        tracing = tel is not None and tel.enabled and tel.trace.enabled
        # the member requests' ids become the worker thread's trace
        # context: every span/event recorded while this batch executes —
        # serve.queue_wait/exec, the facade op, the WAL append, a merge
        # the batch triggers — links back to these requests
        with trace_context(tuple(r.trace_id for r in group) if tracing
                           else ()):
            self._dispatch_traced(group, n, depth_ops, tracing)

    def _dispatch_traced(self, group: list[Request], n: int,
                         depth_ops: int, tracing: bool) -> None:
        tel = self.tel
        t0 = time.perf_counter()
        if tel is not None and tel.enabled:
            tel.record_span("serve.queue_wait", t0 - group[0].t_submit)
            tel.metrics.gauge("serve.queue_depth_ops", depth_ops)
            tel.metrics.gauge("serve.batch_target_ops", self.sizer.target)
            # batch-size histogram: lanes recorded on the ms scale, i.e.
            # `serve.batch.ops` summary reads ms_* keys AS lane counts
            tel.metrics.observe("serve.batch.ops", n * 1e-3)
        try:
            self._execute(group)
            err = None
        except BaseException as e:          # noqa: BLE001 — fan the error
            err = e                         # out to every waiting client
        service_s = time.perf_counter() - t0
        if tel is not None and tel.enabled:
            tel.record_span("serve.exec", service_s, op=group[0].op,
                            n_ops=n, n_requests=len(group))
        self.n_batches += 1
        self.batch_ops.append(n)
        self.sizer.observe(depth_ops, service_s)
        t_done = time.perf_counter()
        for r in group:
            if err is not None and not r.done:
                # requests `_execute` already completed keep their result
                r._complete(error=err, t_done=t_done)
            if r.error is not None:
                self.n_failed += r.n_ops
            else:
                self.n_completed += r.n_ops
            if tel is not None and tel.enabled:
                tel.metrics.observe(f"serve.e2e.{r.op}",
                                    t_done - r.t_arrival)
                if tracing:
                    # the request's anchor slice: one per trace id, on the
                    # owning client's track; flow arrows start here
                    tel.trace.add(
                        "serve.request", t0=r.t_submit,
                        dur_s=(r.t_done or t_done) - r.t_submit,
                        track=f"client:{r.client_id or 'anon'}",
                        trace_ids=(r.trace_id,), anchor=True,
                        op=r.op, n_ops=r.n_ops,
                        ok=r.error is None)

    def _execute(self, group: list[Request]) -> None:
        """Run one coalesced facade batch and slice results back out.
        Commit order == execution order == journal order."""
        op = group[0].op
        ix = self.index
        t_done: float | None = None
        if op == "lookup":
            q = np.concatenate([r.keys for r in group])
            v, f = ix.lookup(q)
            self._journal(OpBatch("lookup", keys=q))
            t_done = time.perf_counter()
            i = 0
            for r in group:
                j = i + r.n_ops
                r._complete((v[i:j], f[i:j]), t_done=t_done)
                i = j
        elif op == "range":
            lo = np.concatenate([r.lo for r in group])
            hi = np.concatenate([r.hi for r in group])
            ks, vs, cnt = ix.range(lo, hi, max_hits=group[0].max_hits)
            self._journal(OpBatch("range", lo=lo, hi=hi))
            t_done = time.perf_counter()
            i = 0
            for r in group:
                j = i + r.n_ops
                r._complete((ks[i:j], vs[i:j], cnt[i:j]), t_done=t_done)
                i = j
        elif op == "upsert":
            keys = np.concatenate([r.keys for r in group])
            vals = np.concatenate([r.vals for r in group])
            # within-batch order = request order, so a later request's
            # write to the same key wins (overlay merge is last-write-wins
            # in array order — the same rule the oracle replay applies)
            ix.upsert(keys, vals)
            self._journal(OpBatch("upsert", keys=keys, vals=vals))
            t_done = time.perf_counter()
            for r in group:
                # the ack: WAL append (when armed) + overlay apply are done
                r._complete(t_done=t_done)
        else:                                        # delete
            keys = np.concatenate([r.keys for r in group])
            ix.delete(keys)
            self._journal(OpBatch("delete", keys=keys))
            t_done = time.perf_counter()
            for r in group:
                r._complete(t_done=t_done)

    def _journal(self, batch: OpBatch) -> None:
        if self.journal is not None:
            self.journal.append(batch)
