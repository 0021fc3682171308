"""The traced run's records and the arithmetic that reduces them.

`DeviceTrace` runs torch.profiler (CPU and CUDA activities) over the
window and returns the device's operations as (name, start, end) in
`time.perf_counter` seconds, the clock the harness times its calls and the
program times its spans with.  The two clocks are tied by one
`record_function("bench.window")` marker entered at a known
`perf_counter` reading.  The raw kineto events are read
(`prof.profiler.kineto_results.events()`), not `prof.events()`, whose
tree takes seconds per hundred thousand events.

The helpers below work on sorted, half-open intervals in seconds.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

MARKER = "bench.window"
COPY_PREFIXES = ("Memcpy", "Memset")
# the program's merge stages, innermost host work of a write call
MERGE_STAGES = ("merge.fold", "merge.retrain", "merge.recluster",
                "merge.flatten", "merge.publish")


@dataclass(frozen=True)
class CallRec:
    op: str
    t0: float
    t1: float
    n: int           # operations the call carried
    pool: int        # index of its batch in the traffic pool
    ok: bool         # returned without raising


@dataclass
class Records:
    """What a run hands the metric readers (`metrics/<name>.py`)."""
    cell: str
    setup_s: float
    build_s: float
    window: tuple[float, float]
    calls: list[CallRec]
    merges: int = 0                  # merges the window's writes triggered
    # traced run only
    device: list = field(default_factory=list)   # (name, t0, t1)
    spans: list = field(default_factory=list)    # program (name, t0, dur)
    distinct_found: dict = field(default_factory=dict)   # pool -> count

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def of(self, op: str) -> list[CallRec]:
        return [c for c in self.calls if c.op == op]


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)


def busy_s(rec: Records) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return total(clip(union((a, b) for _, a, b in rec.device),
                      *rec.window))


def idle_pct(rec: Records) -> float | None:
    """The share of the traced window in which no operation ran on the
    device, in percent; None without a device trace."""
    if not rec.device:
        return None
    return 100.0 * (1.0 - busy_s(rec) / rec.window_s)


def per_call(rec: Records, calls: list[CallRec]) -> list[list]:
    """The device operations inside each of `calls` (by the midpoint of
    the operation), as lists of (name, t0, t1)."""
    ev = sorted(rec.device, key=lambda e: e[1])
    order = sorted(range(len(calls)), key=lambda i: calls[i].t0)
    out: list[list] = [[] for _ in calls]
    j = 0
    for i in order:
        c = calls[i]
        while j < len(ev) and (ev[j][1] + ev[j][2]) / 2 < c.t0:
            j += 1
        k = j
        while k < len(ev) and (ev[k][1] + ev[k][2]) / 2 <= c.t1:
            out[i].append(ev[k])
            k += 1
        j = k
    return out


def idle_gaps(rec: Records) -> list[tuple[str, float]]:
    """Idle device seconds in the window by what the host was doing: the
    program's merge stage, else the facade call, else `host.other`."""
    idle, at = [], rec.window[0]
    for a, b in clip(union((a, b) for _, a, b in rec.device), *rec.window):
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if at < rec.window[1]:
        idle.append((at, rec.window[1]))
    levels = [
        sorted((t0, t0 + d, name) for name, t0, d in rec.spans
               if name in MERGE_STAGES),
        sorted((c.t0, c.t1, f"facade.{c.op}") for c in rec.calls),
    ]
    by: dict[str, float] = {}
    for level in levels:
        ends = [s1 for _, s1, _ in level]
        rest = []
        for a, b in idle:
            k = bisect.bisect_right(ends, a)
            while k < len(level) and level[k][0] < b and a < b:
                s0, s1, name = level[k]
                lo, hi = max(a, s0), min(b, s1)
                by[name] = by.get(name, 0.0) + hi - lo
                if lo > a:
                    rest.append((a, lo))
                a = hi
                k += 1
            if a < b:
                rest.append((a, b))
        idle = rest
    by["host.other"] = by.get("host.other", 0.0) + total(idle)
    return sorted(((k, v) for k, v in by.items() if v > 0),
                  key=lambda kv: -kv[1])


def device_ops(rec: Records) -> list[tuple[str, float]]:
    """Device seconds in the window by operation name, longest first."""
    by: dict[str, float] = {}
    lo, hi = rec.window
    for name, a, b in rec.device:
        if b > lo and a < hi:
            by[name] = by.get(name, 0.0) + min(b, hi) - max(a, lo)
    return sorted(by.items(), key=lambda kv: -kv[1])


class DeviceTrace:
    """torch.profiler over the window; `events` after exit."""

    def __init__(self, device):
        self.device = device
        self.events: list[tuple[str, float, float]] = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(MARKER)
        self._mark.__enter__()
        self._p0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        self.events = self._read()
        return False

    def _read(self) -> list[tuple[str, float, float]]:
        from torch.autograd import DeviceType
        raw = self._prof.profiler.kineto_results.events()
        ns = (lambda e: (e.start_ns(), e.duration_ns())) \
            if hasattr(raw[0], "start_ns") else \
            (lambda e: (e.start_us() * 1000, e.duration_us() * 1000))
        mark = [e for e in raw if e.name() == MARKER
                and e.device_type() == DeviceType.CPU]
        off = ns(mark[0])[0] - self._p0
        out = []
        for e in raw:
            if e.device_type() != DeviceType.CUDA or e.name() == MARKER:
                continue
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            s, d = ns(e)
            t0 = (s - off) * 1e-9
            out.append((e.name(), t0, t0 + d * 1e-9))
        return out
