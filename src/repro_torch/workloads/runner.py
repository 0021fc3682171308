"""`WorkloadRunner`: drive any `repro_torch.api.LearnedIndex` engine
through an op stream while diffing every batch against the
`SortedOracle`.

The runner is the differential half of the workload subsystem: the
generator says *what* happens, the oracle says what the answers *must* be,
and the runner replays the stream engine-batch-wise, checking

  * lookup hits AND misses (found masks bit-equal, values equal on hits),
  * range windows (keys/vals/counts bit-equal including padding),
  * write visibility (every upsert batch is immediately readable with its
    new values, every delete batch immediately invisible — the overlay
    path, not just post-merge state),
  * final content (`items()` equals the oracle after the whole stream).

Timing covers only the engine calls (oracle bookkeeping and diffing run
off the clock), so the same replay that proves correctness also yields the
mixed-workload throughput numbers `benchmarks/run.py --workload` records.

A divergence raises `WorkloadDivergence` by default (CI-friendly: a broken
engine fails the job); pass strict=False to collect divergence messages
into the report instead, e.g. to assert that an injected fault IS caught.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..obs import latency_summary
from .generator import OPS, OpBatch, WorkloadSpec, stream_op_counts
from .oracle import SortedOracle


class WorkloadDivergence(AssertionError):
    """An engine answered differently from the ground-truth oracle."""


@dataclass
class WorkloadReport:
    """Outcome of one stream replay: throughput + divergence record."""
    name: str
    engine: str
    n_ops: int = 0
    n_batches: int = 0
    op_counts: dict = field(default_factory=lambda: {o: 0 for o in OPS})
    op_seconds: dict = field(default_factory=lambda: {o: 0.0 for o in OPS})
    # per-batch engine-call durations (seconds), captured off the clock —
    # the tail-latency raw material behind `latency_ms` in the JSON report
    op_latencies: dict = field(default_factory=lambda: {o: [] for o in OPS})
    divergences: list = field(default_factory=list)
    final_stats: dict = field(default_factory=dict)

    def note_op(self, op: str, dur_s: float) -> None:
        self.op_seconds[op] += dur_s
        self.op_latencies[op].append(dur_s)

    @property
    def wall_s(self) -> float:
        return sum(self.op_seconds.values())

    @property
    def ops_per_s(self) -> float:
        return self.n_ops / max(self.wall_s, 1e-12)

    def latency_ms(self) -> dict:
        """{op: p50/p95/p99/p999/max/mean ms per engine batch call} via
        the shared percentile recipe (`repro_torch.obs.latency_summary`)."""
        return {op: latency_summary(self.op_latencies[op]) for op in OPS}

    def to_json_dict(self) -> dict:
        return dict(name=self.name, engine=self.engine, n_ops=self.n_ops,
                    n_batches=self.n_batches, ops_per_s=self.ops_per_s,
                    us_per_op=1e6 * self.wall_s / max(self.n_ops, 1),
                    op_counts=dict(self.op_counts),
                    op_seconds={k: round(v, 6)
                                for k, v in self.op_seconds.items()},
                    latency_ms=self.latency_ms(),
                    n_divergences=len(self.divergences),
                    divergences=self.divergences[:8],
                    pending_writes=self.final_stats.get("pending_writes"),
                    epoch=self.final_stats.get("epoch"),
                    n_merges=self.final_stats.get("n_merges"))


def _diff(tag: str, got, want) -> list[str]:
    """Bit-exact comparison; returns human-pointable messages, not raises."""
    out = []
    for part, g, w in zip(("keys/vals", "vals", "found/counts"),
                          got, want):
        g, w = np.asarray(g), np.asarray(w)
        if np.array_equal(g, w):
            continue
        if g.shape != w.shape:
            out.append(f"{tag}: {part} shape diverge "
                       f"(got {g.shape}, want {w.shape})")
            continue
        bad = np.nonzero(~np.isclose(g.astype(np.float64),
                                     w.astype(np.float64), equal_nan=True))
        lane = bad[0][0] if len(bad[0]) else -1
        out.append(f"{tag}: {part} diverge at lane {lane} "
                   f"(got {g.reshape(-1)[:4]}..., "
                   f"want {w.reshape(-1)[:4]}...)")
    return out


class WorkloadRunner:
    """Replay `OpBatch` streams through one `LearnedIndex`, oracle-checked.

    check=False turns the runner into a pure throughput driver (no oracle,
    no diffs) for perf sweeps where the keys are not exactly representable
    in the engine's dtype (the pallas engine quantizes to f32; the
    differential contract requires the integer-key convention).

    `warmup_batches` marks the index's retrace watchdog warm after that
    many replayed batches (`telemetry.mark_warm()`): every executable the
    steady state needs should exist by then, so the report's post-warmup
    trace count is a retrace regression signal, not compile noise."""

    def __init__(self, index, check: bool = True, strict: bool = True,
                 verify_writes: bool = True, final_check: bool = True,
                 warmup_batches: int = 8):
        self.index = index
        self.check = check
        self.strict = strict
        self.verify_writes = verify_writes and check
        self.final_check = final_check and check
        self.warmup_batches = warmup_batches
        k, v = index.items()
        self.oracle = SortedOracle(k, v) if check else None

    # -- one batch -----------------------------------------------------------

    def _replay(self, i: int, b: OpBatch, report: WorkloadReport) -> None:
        ix, oc = self.index, self.oracle
        if b.op == "lookup":
            t0 = time.perf_counter()
            v, f = ix.lookup(b.keys)
            report.note_op("lookup", time.perf_counter() - t0)
            if self.check:
                wv, wf = oc.lookup(b.keys)
                msgs = _diff(f"batch {i} lookup", (f, v[f]),
                             (wf, wv[wf] if len(wv) else wv))
                report.divergences += msgs
        elif b.op == "upsert":
            t0 = time.perf_counter()
            ix.upsert(b.keys, b.vals)
            report.note_op("upsert", time.perf_counter() - t0)
            if self.check:
                oc.upsert(b.keys, b.vals)
                if self.verify_writes:
                    v, f = ix.lookup(b.keys)
                    wv, wf = oc.lookup(b.keys)
                    report.divergences += _diff(
                        f"batch {i} upsert-visibility", (f, v[f]), (wf, wv[wf]))
        elif b.op == "delete":
            t0 = time.perf_counter()
            ix.delete(b.keys)
            report.note_op("delete", time.perf_counter() - t0)
            if self.check:
                oc.delete(b.keys)
                if self.verify_writes:
                    _, f = ix.lookup(b.keys)
                    if f.any():
                        report.divergences.append(
                            f"batch {i} delete-visibility: "
                            f"{int(f.sum())}/{len(f)} deleted keys still "
                            f"found")
        else:                                    # range
            mh = getattr(self, "_max_hits", 64)
            t0 = time.perf_counter()
            ks, vs, cnt = ix.range(b.lo, b.hi, max_hits=mh)
            report.note_op("range", time.perf_counter() - t0)
            if self.check:
                want = oc.range(b.lo, b.hi, max_hits=mh)
                report.divergences += _diff(f"batch {i} range",
                                            (ks, vs, cnt), want)

    def _prewarm_buckets(self, batches: list[OpBatch]) -> None:
        """Mint every read-path executable the stream's batch lengths can
        reach before declaring warmup over: one probe lookup (and range,
        when the mix has ranges) per pow2 lane bucket the facade pads to.
        Without this the stream's shorter tail batch hits a smaller pad
        bucket AFTER mark_warm and the compile counts as a retrace."""
        ix = self.index
        pad = getattr(ix, "_pad_batch", None)
        if pad is None:
            return
        buckets, has_range = set(), False
        for b in batches:
            if b.op == "range":
                has_range = True
                buckets.add(pad(len(b.lo)) or len(b.lo))
            else:
                buckets.add(pad(len(b.keys)) or len(b.keys))
        k0 = float(ix.items()[0][0])
        mh = getattr(self, "_max_hits", 64)
        for n in sorted(buckets):
            ix.lookup(np.full(n, k0))
            if has_range:
                ix.range(np.full(n, k0), np.full(n, k0), max_hits=mh)

    # -- the stream ----------------------------------------------------------

    def run(self, batches: list[OpBatch],
            spec: WorkloadSpec | None = None,
            name: str = "") -> WorkloadReport:
        self._max_hits = spec.max_hits if spec is not None else 64
        report = WorkloadReport(
            name=name or (spec.name if spec is not None else "stream"),
            engine=self.index.engine)
        report.op_counts = stream_op_counts(batches)
        tel = getattr(self.index, "telemetry", None)
        for i, b in enumerate(batches):
            n_before = len(report.divergences)
            self._replay(i, b, report)
            report.n_batches += 1
            report.n_ops += b.n_ops
            if (tel is not None and not tel.warmed
                    and report.n_batches >= self.warmup_batches):
                self._prewarm_buckets(batches)
                tel.mark_warm()
            if self.strict and len(report.divergences) > n_before:
                raise WorkloadDivergence(
                    f"{report.name} on engine {report.engine!r}: "
                    + "; ".join(report.divergences[n_before:]))
        if self.final_check:
            k, v = self.index.items()
            wk, wv = self.oracle.items()
            msgs = _diff(f"{report.name} final items()", (k, v), (wk, wv))
            report.divergences += msgs
            if self.strict and msgs:
                raise WorkloadDivergence("; ".join(msgs))
        report.final_stats = self.index.stats()
        # off-thread merges must stay oracle-exact AND alive: a background
        # maintenance task that died is a silent correctness/liveness hole
        # the per-batch diffs may not have tripped over — fail loudly
        n_err = report.final_stats.get("maint_errors", 0)
        if n_err:
            logs = report.final_stats.get("maint_error_logs", [])
            msg = (f"{report.name} on engine {report.engine!r}: "
                   f"{n_err} background maintenance task(s) failed"
                   + ("\n" + "\n".join(logs) if logs else ""))
            report.divergences.append(msg)
            if self.strict:
                raise WorkloadDivergence(msg)
        return report


    # -- kill-and-recover replay (DESIGN.md section 14) ----------------------

    def run_kill_recover(self, batches: list[OpBatch], kill_at: int,
                         spec: WorkloadSpec | None = None,
                         name: str = "") -> dict:
        """Replay `batches[:kill_at]` oracle-checked, crash the index
        (`abandon()`: no final fsync — exactly a SIGKILL's disk state),
        `LearnedIndex.recover` it from its durability directory, diff the
        recovered content bit-exactly against the oracle at the kill
        point, then continue the remaining stream on the RECOVERED index
        (self.index is replaced; the caller closes it via the runner).
        The recovered index runs on the device of the one it replaces.

        Requires `config.durability`.  Returns a JSON-able dict with both
        leg reports, the recovery wall time, and the replayed-record
        count; strict mode raises `WorkloadDivergence` on any diff."""
        from ..api.index import LearnedIndex
        if not self.check:
            raise ValueError("kill-and-recover is a differential mode; "
                             "construct the runner with check=True")
        dur = self.index.config.durability
        if dur is None:
            raise ValueError("kill-and-recover requires config.durability "
                             "(there is no WAL to recover from)")
        name = name or (spec.name if spec is not None else "stream")
        pre = self.run(batches[:kill_at], spec=spec,
                       name=f"{name}[pre-kill]")
        device = self.index.device
        self.index.abandon()
        t0 = time.perf_counter()
        self.index = LearnedIndex.recover(dur.dir, device=device)
        recovery_s = time.perf_counter() - t0
        k, v = self.index.items()
        wk, wv = self.oracle.items()
        msgs = _diff(f"{name} post-recovery items()", (k, v), (wk, wv))
        if self.strict and msgs:
            raise WorkloadDivergence("; ".join(msgs))
        counters = self.index.metrics()["counters"]
        post = self.run(batches[kill_at:], spec=spec,
                        name=f"{name}[post-recovery]")
        return dict(
            name=name, kill_at_batch=kill_at, recovery_s=recovery_s,
            replayed_records=int(counters["recovery.replayed_records"]),
            post_recovery_divergences=msgs,
            n_divergences=(len(pre.divergences) + len(msgs)
                           + len(post.divergences)),
            pre=pre.to_json_dict(), post=post.to_json_dict())


def run_preset(index, preset_or_spec, loaded_keys=None, **scale
               ) -> WorkloadReport:
    """One-call convenience: resolve a preset name (or take a spec),
    generate its stream over the index's current content, and replay it."""
    from .generator import PRESETS, generate_stream
    spec = (PRESETS[preset_or_spec].scaled(**scale)
            if isinstance(preset_or_spec, str) else preset_or_spec)
    if loaded_keys is None:
        loaded_keys = index.items()[0]
    batches = generate_stream(spec, loaded_keys)
    return WorkloadRunner(index).run(batches, spec=spec)
