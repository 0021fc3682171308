"""Trace spans over the merge pipeline (DESIGN.md section 13) and inside
a lookup call.

A span is one timed stage of a pipeline run: `(name, t0, dur_s, attrs)`,
`t0` a `time.perf_counter` reading.  The recorder keeps a bounded ring of
recent spans (`RING_SPANS`, the oldest dropped first) plus running
per-name duration lists (for percentile export), and is safe for the
one-writer-plus-maintenance-worker threading model the merge pipeline
already guarantees: each span is recorded by whichever single thread ran
that stage, and deque/list appends are atomic.

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

Stage spans split two host blocks that would otherwise be opaque, with
telemetry on only (`SpanRecorder.stage`):

  lookup.check     — the facade's `asarray`, finite check and pow2 padding
  lookup.stage     — the local engine's overlay mirror and the numpy cast
                     of the queries, up to the copy
  lookup.overlay   — inside `lookup.stage`: the live-over-frozen overlay
                     resolve and its device mirror (`_overlay_arrays`)
  lookup.upload    — the queries' host-to-device copy (host staging
                     included)
  lookup.download  — the payloads' and flags' device-to-host copies, the
                     wait for the kernel included
  flatten.preorder — `core.flat.flatten`'s node walk and numbering
  flatten.tables   — its per-slot `node_tables`
  flatten.pairs    — its key-sorted pair table (argsort and gathers)
  flatten.shape    — its `_max_depth` and `_n_segments` walks
  flatten.patch    — `core.flat.patch_payloads`, taken in place of the
                     full flatten by a merge whose writes only replaced
                     existing payloads
  splice.units     — the incremental flattener's unit walk and the
                     translation of the dirty node ids to segments
  splice.refresh   — its pass 1: dirty segments re-flattened, dead ones
                     dropped
  splice.offsets   — its pass 2: each unit's node and slot offsets
  splice.assemble  — its pass 3: the concatenations and shifts, up to the
                     `FlatDILI`

One of each lookup stage per facade lookup call of the local engine, in
that order and not overlapping (the kernel launch and the facade's final
slicing lie between or after them; the pallas and sharded engines record
`lookup.check` alone), and one `lookup.overlay` nested in its
`lookup.stage`; one of each flatten stage inside every `merge.flatten`
span of the local engine's full flatten, the patch stage alone inside one
that patched the published flat instead, and one of each splice stage,
in order, inside one that ran the incremental flattener.  Stage
spans go into the ring only: not into the duration lists, so `summary()`
(the `dili.metrics/1` `spans` block) keeps the reference's key set, and
not into the trace sink, so `dili.trace/1` keeps its event names.

`RECOVERY_SPANS` is the crash-recovery taxonomy (DESIGN.md section 14):
load (checkpoint walk + npz read), replay (WAL tail through the fold
path), publish (fresh base checkpoint + WAL re-arm).  Recovery spans are
recorded unconditionally — bypassing the telemetry `enabled` gate —
because recovery is rare and always worth seeing.
"""

from __future__ import annotations

import time
from collections import deque
from collections.abc import Mapping
from contextlib import contextmanager
from dataclasses import dataclass
from types import MappingProxyType

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

LOOKUP_STAGES = ("lookup.check", "lookup.stage", "lookup.upload",
                 "lookup.download")
FLATTEN_STAGES = ("flatten.preorder", "flatten.tables", "flatten.pairs",
                  "flatten.shape")
PATCH_STAGES = ("flatten.patch",)
SPLICE_STAGES = ("splice.units", "splice.refresh", "splice.offsets",
                 "splice.assemble")
OVERLAY_STAGES = ("lookup.overlay",)

# a 51-s window of 2^20-key lookups records ~40,000 stage spans; the ring
# holds several such windows beside the merges' spans
RING_SPANS = 1 << 18

_NO_ATTRS: Mapping = MappingProxyType({})   # shared by attr-less spans


@dataclass(slots=True)   # not frozen: a frozen init costs ~4x per span
class Span:
    name: str
    t0: float                  # perf_counter timestamp at stage start
    dur_s: float
    attrs: Mapping = _NO_ATTRS


class SpanRecorder:
    """Bounded span ring + per-name duration accumulators."""

    def __init__(self, maxlen: int = RING_SPANS,
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
        self.ring.append(Span(name, t0, dur_s, attrs or _NO_ATTRS))
        self._durations.setdefault(name, []).append(dur_s)
        if self.sink is not None:
            self.sink(name, t0, dur_s, attrs)

    def stage(self, name: str, t0: float, t1: float) -> None:
        """Record one stage span (a `LOOKUP_STAGES`, `FLATTEN_STAGES`,
        `PATCH_STAGES`, `SPLICE_STAGES` or `OVERLAY_STAGES` name) from `t0`
        to `t1`, into the ring only.  The caller reads the clock and checks
        `Telemetry.enabled` itself."""
        self.ring.append(Span(name, t0, t1 - t0))

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
