"""`Telemetry`: the per-index bundle every engine carries (DESIGN.md
section 13) — one `MetricsRegistry` + one `SpanRecorder` + a retrace
watchdog window, behind a single `enabled` flag.

Cost contract: with `enabled=False` (the default) the read/write hot path
pays one attribute check plus one integer op-count increment per facade
call — the op count must keep flowing even when latency capture is off,
because `retraces_per_1k_ops` (the retrace regression number) is
meaningful either way and the watchdog's counters are fed by the kernel
loader (`kernels.dili_search`), not by the hot path — and a local-engine
lookup one more read of the flag and a few branches on a local copy of
it, with no allocation; a full flatten pays one argument.  With
`enabled=True` each facade call additionally pays one perf_counter pair
and one histogram bucket increment, and a local-engine lookup call, a
full flatten, a payload patch or a splice flatten records its stage spans
(`tracing.LOOKUP_STAGES` with `tracing.OVERLAY_STAGES`,
`tracing.FLATTEN_STAGES`, `tracing.PATCH_STAGES`,
`tracing.SPLICE_STAGES`: a perf_counter read and one ring append each,
into the ring only).

Snapshot schema (`snapshot()`) is the JAX package's `dili.metrics/1` key
tree — fixed op set, fixed merge-span taxonomy, fixed retrace keys — so
consumers read both packages' metrics the same way.
"""

from __future__ import annotations

from . import watchdog
from .metrics import MetricsRegistry
from .trace_export import TraceBuffer
from .tracing import MERGE_SPANS, RECOVERY_SPANS, SpanRecorder

# the facade op set: every engine serves exactly these through
# `repro.api.LearnedIndex`, so per-op histograms share one name space
OPS = ("lookup", "range", "upsert", "delete", "flush")

SCHEMA_VERSION = "dili.metrics/1"


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Telemetry:
    """Metrics + spans + retrace window for ONE index instance."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry()
        self.metrics.declare_histogram(*(f"op.{op}" for op in OPS))
        self.metrics.declare_counter("publish.retraced", "maint.errors",
                                     "maint.reclusters",
                                     "recovery.count",
                                     "recovery.replayed_records",
                                     # structured warning counters
                                     # (MetricsRegistry.warn): declared so
                                     # the counter key tree is identical on
                                     # engines that never warn
                                     "warn.pallas_f32_collision")
        # last merge-publish health sample (obs.inspect feeds the full
        # picture; these gauges are the cheap always-on trend lines)
        self.metrics.declare_gauge("inspect.n_segments",
                                   "inspect.dirty_rows",
                                   "inspect.total_rows",
                                   "inspect.dirty_fraction")
        self.spans = SpanRecorder(declare=MERGE_SPANS + RECOVERY_SPANS)
        self.trace = TraceBuffer()
        self.ops_total = 0
        # watchdog window: the build mark anchors "traces since build";
        # mark_warm() anchors the post-warmup (regression) window
        self._build_mark = watchdog.TraceMark.now()
        self._warm_mark: watchdog.TraceMark | None = None
        self._ops_at_warm = 0

    # -- hot path -------------------------------------------------------------

    def count_ops(self, n: int) -> None:
        """Unconditional op accounting (one int add; keeps
        retraces_per_1k_ops meaningful with latency capture off)."""
        self.ops_total += n

    def record_op(self, op: str, dur_s: float, n: int = 1) -> None:
        """Enabled-path per-call record: one histogram increment."""
        self.ops_total += n
        self.metrics.observe(f"op.{op}", dur_s)

    # -- merge pipeline -------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing one pipeline stage; no-op when
        disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return self.spans.span(name, **attrs)

    def record_span(self, name: str, dur_s: float, **attrs) -> None:
        if self.enabled:
            self.spans.record(name, dur_s, **attrs)

    # -- causal tracing -------------------------------------------------------

    def start_trace(self) -> None:
        """Arm causal request tracing: every span the recorder sees is
        tee'd into the trace buffer (tagged with the recording thread's
        trace context), alongside the facade/WAL events the hot path adds
        directly.  Requires `enabled` for the serve/merge spans to be
        recorded at all."""
        self.trace.arm()
        self.spans.sink = self.trace.span_sink

    def stop_trace(self) -> None:
        self.spans.sink = None
        self.trace.disarm()

    # -- merge-publish health sample ------------------------------------------

    def sample_publish(self, *, n_segments: int, dirty_rows: int,
                       total_rows: int) -> None:
        """Cheap index-health gauges refreshed at every merge publish
        from flattener segment metadata (no tree walk; the full picture
        is `LearnedIndex.inspect()`)."""
        if not self.enabled:
            return
        m = self.metrics
        m.gauge("inspect.n_segments", n_segments)
        m.gauge("inspect.dirty_rows", dirty_rows)
        m.gauge("inspect.total_rows", total_rows)
        m.gauge("inspect.dirty_fraction",
                dirty_rows / total_rows if total_rows else 0.0)

    # -- retrace watchdog -----------------------------------------------------

    def mark_warm(self) -> None:
        """Declare warmup over: every executable the steady state needs
        exists now, so any further trace is a retrace regression."""
        self._warm_mark = watchdog.TraceMark.now()
        self._ops_at_warm = self.ops_total

    @property
    def warmed(self) -> bool:
        return self._warm_mark is not None

    def retrace_report(self) -> dict:
        since_build = self._build_mark.delta()
        if self._warm_mark is None:
            post = dict(traces=0, compiles=0)
            post_ops = 0
        else:
            post = self._warm_mark.delta()
            post_ops = self.ops_total - self._ops_at_warm
        return dict(
            warmed=self.warmed,
            traces_since_build=since_build["traces"],
            compiles_since_build=since_build["compiles"],
            post_warmup_traces=post["traces"],
            post_warmup_compiles=post["compiles"],
            post_warmup_ops=post_ops,
            retraces_per_1k_ops=(1000.0 * post["traces"] / post_ops
                                 if post_ops else 0.0),
            jit_cache_entries=watchdog.jit_cache_sizes())

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """The stable JSON-able metrics snapshot (same schema on every
        engine; `LearnedIndex.metrics()` is a thin wrapper)."""
        m = self.metrics.snapshot()
        return dict(
            schema=SCHEMA_VERSION,
            enabled=self.enabled,
            ops_total=self.ops_total,
            ops={op: m["histograms"][f"op.{op}"] for op in OPS},
            # serving-front-end histograms (e2e latency per op, batch
            # sizes) appear only once a `RequestBatcher` attached and
            # declared them — {} on a bare index, same on every engine
            serve={k: v for k, v in m["histograms"].items()
                   if k.startswith("serve.")},
            counters=m["counters"],
            gauges=m["gauges"],
            spans=self.spans.summary(),
            retrace=self.retrace_report())


#: shared disabled instance for call sites that accept an optional
#: telemetry (never enable this one — make your own)
NULL_TELEMETRY = Telemetry(enabled=False)
