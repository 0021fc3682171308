"""Trace spans over the merge pipeline (DESIGN.md section 13).

A span is one timed stage of a pipeline run: `(name, t0, dur_s, attrs)`.
The recorder keeps a bounded ring of recent spans (for debugging "what did
the last merge do") plus running per-name duration lists (for percentile
export), and is safe for the one-writer-plus-maintenance-worker threading
model the merge pipeline already guarantees: each span is recorded by
whichever single thread ran that stage, and list.append is atomic.

The merge span taxonomy is fixed (`MERGE_SPANS`) so every engine exports
the same span names:

  merge.queue_wait   — submit -> worker pickup (background scheduler only)
  merge.fold         — overlay fold through the host tree (Alg. 7/8)
  merge.retrain      — drift/tombstone-triggered subtree rebuilds
  merge.recluster    — heat-triggered locality splits of hot leaf segments
  merge.flatten      — full or incremental-splice flatten
  merge.publish      — device upload + epoch flip
  merge.frozen_dwell — overlay freeze -> frozen drop (reads resolve the
                       frozen overlay for this long; background only)
  merge.failed       — one failed merge attempt (duration = time spent in
                       the pipeline before it died; see the bounded-retry
                       loop in `online.merge`)

Engines that run a stage synchronously inside another (e.g. the sharded
engine's per-shard fold) record one span per shard with a `shard` attr.

`RECOVERY_SPANS` is the crash-recovery taxonomy (DESIGN.md section 14):
load (checkpoint walk + npz read), replay (WAL tail through the fold
path), publish (fresh base checkpoint + WAL re-arm).  Recovery spans are
recorded unconditionally — bypassing the telemetry `enabled` gate —
because recovery is rare and always worth seeing.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from .metrics import latency_summary

MERGE_SPANS = ("merge.queue_wait", "merge.fold", "merge.retrain",
               "merge.recluster", "merge.flatten", "merge.publish",
               "merge.frozen_dwell", "merge.failed")

RECOVERY_SPANS = ("recovery.load", "recovery.replay", "recovery.publish")

# Serving front-end taxonomy (DESIGN.md section 15).  NOT part of the
# default declaration: a bare index exports exactly the merge + recovery
# span set (pinned by the telemetry schema tests); the serve spans join a
# Telemetry bundle only when a `RequestBatcher` attaches to the index,
# via `SpanRecorder.declare`.
#
#   serve.queue_wait — head request's submit -> worker dispatch (the
#                      admission-queue delay component of e2e latency)
#   serve.exec       — one coalesced facade batch, dispatch -> results
#                      sliced back to clients (attr `op`)
SERVE_SPANS = ("serve.queue_wait", "serve.exec")


@dataclass(frozen=True)
class Span:
    name: str
    t0: float                  # perf_counter timestamp at stage start
    dur_s: float
    attrs: dict = field(default_factory=dict)


class SpanRecorder:
    """Bounded span ring + per-name duration accumulators."""

    def __init__(self, maxlen: int = 2048,
                 declare: tuple[str, ...] = MERGE_SPANS + RECOVERY_SPANS):
        self.ring: deque[Span] = deque(maxlen=maxlen)
        self._durations: dict[str, list[float]] = {n: [] for n in declare}
        # optional causal-trace tap: when set (see Telemetry.start_trace)
        # every recorded span is also forwarded as
        # `sink(name, t0, dur_s, attrs)` — the TraceBuffer adapter
        self.sink = None

    def record(self, name: str, dur_s: float, t0: float | None = None,
               **attrs) -> None:
        if t0 is None:
            t0 = time.perf_counter() - dur_s
        self.ring.append(Span(name, t0, dur_s, attrs))
        self._durations.setdefault(name, []).append(dur_s)
        if self.sink is not None:
            self.sink(name, t0, dur_s, attrs)

    @contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, t0=t0, **attrs)

    def declare(self, *names: str) -> None:
        """Add span names to the exported taxonomy (zero-count until
        recorded).  Late opt-in for subsystems that aren't part of every
        index — e.g. the serving front-end declares `SERVE_SPANS` on
        attach, so only served indexes export them."""
        for name in names:
            self._durations.setdefault(name, [])

    def spans(self, name: str | None = None) -> list[Span]:
        return [s for s in self.ring if name is None or s.name == name]

    def count(self, name: str) -> int:
        return len(self._durations.get(name, ()))

    def summary(self) -> dict:
        """{span name: shared percentile summary} over every declared or
        recorded span name — JSON-able, stable key set per taxonomy.

        Safe to call while another thread records: the name dict and each
        duration list are snapshotted atomically (`dict()`/`list()` are
        single bytecodes over the live object), so a concurrent append
        lands in this summary or the next, never in a RuntimeError."""
        return {name: latency_summary(list(durs))
                for name, durs in sorted(dict(self._durations).items())}
