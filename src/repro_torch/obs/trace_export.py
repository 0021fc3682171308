"""Causal request tracing: trace IDs, thread-propagated trace context,
and Chrome-trace-event export (DESIGN.md section 13).

The metrics side of `repro.obs` answers "how slow was X on average" —
this module answers "what happened to THIS request": a trace id is minted
per client request at submit (`repro.serve.frontend`), the batcher
installs the coalesced batch's id set as the worker thread's *trace
context* while it executes, and every causal stage recorded underneath —
serve queue/exec spans, the facade op, the WAL append, and any merge or
recovery pipeline the write triggered — lands in a bounded `TraceBuffer`
ring tagged with those ids.

Export is the Chrome trace-event JSON format (`TraceBuffer.to_chrome`),
loadable in Perfetto (https://ui.perfetto.dev) or chrome://tracing:
stages are complete ("X") slices on named tracks (one per client, plus
serve/facade/wal/merge/recovery), and requests are connected to the
stages that served them with flow arrows ("s" at the request slice,
"t" steps at each linked stage).

Threading model: trace ids are minted from one process-global counter
(atomic via the GIL); the context is a thread-local, installed by the
single batcher worker (and re-installed on the maintenance worker for
background merges, see `online.merge`); `TraceBuffer.add` is a deque
append — safe under the same one-writer-per-stage model the span
recorder already assumes.  Everything is disabled (one flag check) until
`arm()`.
"""

from __future__ import annotations

import itertools
import json
import threading
from collections import deque

TRACE_SCHEMA_VERSION = "dili.trace/1"

#: process-global request id mint — `next()` on a count iterator is atomic
_MINT = itertools.count(1)


def mint_trace_id() -> int:
    """A fresh process-unique trace id (one per client request)."""
    return next(_MINT)


_CTX = threading.local()


def current_trace_ids() -> tuple:
    """The trace ids causally responsible for work on THIS thread right
    now (empty outside any traced dispatch)."""
    return getattr(_CTX, "ids", ())


class trace_context:
    """Install `trace_ids` as this thread's causal context for the
    duration of the `with` block (re-entrant: the previous context is
    restored on exit).  The batcher wraps each coalesced dispatch in one;
    background merge submission captures the writer's context and
    re-enters it on the worker."""

    __slots__ = ("ids", "_prev")

    def __init__(self, trace_ids):
        self.ids = tuple(trace_ids)

    def __enter__(self) -> "trace_context":
        self._prev = getattr(_CTX, "ids", ())
        _CTX.ids = self.ids
        return self

    def __exit__(self, *exc) -> bool:
        _CTX.ids = self._prev
        return False


class TraceBuffer:
    """Bounded ring of causal trace events with Chrome-trace export.

    One buffer per `Telemetry` bundle (so per index).  Events are
    `(name, track, t0, dur_s, trace_ids, anchor, attrs)`; `anchor=True`
    marks the *request* slice that OWNS a trace id (flow arrows start
    there), every other event carrying ids is a linked stage (flow
    steps).  Unarmed, `add` is a single flag check."""

    def __init__(self, maxlen: int = 65536):
        self.ring: deque = deque(maxlen=maxlen)
        self.enabled = False
        self.n_events = 0          # total added (ring may have dropped)

    def arm(self) -> None:
        self.enabled = True

    def disarm(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self.ring.clear()
        self.n_events = 0

    def add(self, name: str, *, t0: float, dur_s: float, track: str,
            trace_ids=None, anchor: bool = False, **attrs) -> None:
        """Record one causal stage.  `trace_ids=None` (the common case)
        links the event to the thread's current trace context."""
        if not self.enabled:
            return
        if trace_ids is None:
            trace_ids = current_trace_ids()
        self.ring.append((name, track, float(t0), float(dur_s),
                          tuple(trace_ids), bool(anchor), attrs))
        self.n_events += 1

    def span_sink(self, name: str, t0: float, dur_s: float,
                  attrs: dict) -> None:
        """`SpanRecorder.sink` adapter: every span the recorder sees
        (merge.*, recovery.*, serve.*) becomes a trace event on the track
        named by its prefix, linked to the current trace context."""
        self.add(name, t0=t0, dur_s=dur_s, track=name.split(".", 1)[0],
                 **attrs)

    # -- export ---------------------------------------------------------------

    def to_chrome(self, process_name: str = "dili") -> dict:
        """The ring as a Chrome trace-event JSON object.

        Slices are "X" (complete) events on per-track tids; each anchor
        slice emits a flow start ("s") per owned trace id and each linked
        stage emits a flow step ("t"), so Perfetto draws request ->
        stage arrows.  Timestamps are microseconds relative to the
        earliest event (perf_counter origin is arbitrary)."""
        events = list(self.ring)
        pid = 1
        out = [dict(ph="M", pid=pid, name="process_name",
                    args=dict(name=process_name))]
        tids: dict[str, int] = {}
        base = min((e[2] for e in events), default=0.0)
        for name, track, t0, dur_s, ids, anchor, attrs in events:
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                out.append(dict(ph="M", pid=pid, tid=tid,
                                name="thread_name", args=dict(name=track)))
            ts = round((t0 - base) * 1e6, 3)
            dur = round(max(dur_s, 1e-7) * 1e6, 3)
            args = {k: (v if isinstance(v, (int, float, str, bool))
                        else repr(v)) for k, v in attrs.items()}
            if ids:
                args["trace_ids"] = list(ids)
            out.append(dict(name=name, ph="X", ts=ts, dur=dur,
                            pid=pid, tid=tid, cat=track, args=args))
            # flow events must bind INSIDE their slice: anchor starts the
            # per-request flow, linked stages step it
            mid = round(ts + dur / 2, 3)
            for trace_id in ids:
                out.append(dict(ph=("s" if anchor else "t"), cat="request",
                                id=int(trace_id), name="req", ts=mid,
                                pid=pid, tid=tid))
        return dict(displayTimeUnit="ms", traceEvents=out,
                    otherData=dict(schema=TRACE_SCHEMA_VERSION,
                                   n_events=self.n_events,
                                   n_exported=len(events)))

    def dump(self, path: str, process_name: str = "dili") -> dict:
        """Write `to_chrome()` JSON to `path` (open in Perfetto);
        returns the document's `otherData` summary block."""
        doc = self.to_chrome(process_name)
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1)
        return doc["otherData"]
