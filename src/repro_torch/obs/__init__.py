"""Telemetry core: metrics registry, merge-pipeline spans, causal trace
buffer, the `dili.inspect/1` health document and the recompile watchdog —
copies of `repro.obs` except the watchdog, which counts kernel builds
instead of XLA compiles."""

from .inspect import INSPECT_SCHEMA_VERSION, build_inspect
from .metrics import (LatencyHistogram, MetricsRegistry, PERCENTILES,
                      latency_summary)
from .telemetry import NULL_TELEMETRY, OPS, SCHEMA_VERSION, Telemetry
from .trace_export import (TRACE_SCHEMA_VERSION, TraceBuffer,
                           current_trace_ids, mint_trace_id, trace_context)
from .tracing import (MERGE_SPANS, RECOVERY_SPANS, SERVE_SPANS, Span,
                      SpanRecorder)
from . import watchdog

__all__ = [
    "INSPECT_SCHEMA_VERSION", "build_inspect",
    "LatencyHistogram", "MetricsRegistry", "PERCENTILES", "latency_summary",
    "NULL_TELEMETRY", "OPS", "SCHEMA_VERSION", "Telemetry",
    "TRACE_SCHEMA_VERSION", "TraceBuffer", "current_trace_ids",
    "mint_trace_id", "trace_context",
    "MERGE_SPANS", "RECOVERY_SPANS", "SERVE_SPANS", "Span", "SpanRecorder",
    "watchdog",
]
