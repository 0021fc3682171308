"""Metrics primitives: counters, gauges, log-bucketed latency histograms,
and THE one percentile implementation (DESIGN.md section 13).

The histogram is HDR-style: fixed geometric bucket edges (32 sub-buckets
per power-of-two octave, so quantile estimates carry at most ~3.2%
relative error) held in one shared numpy array.  Recording a sample is a
single `searchsorted` into that fixed table plus an integer increment —
no per-sample allocation, no stored samples — which is what lets the
serving hot path keep a histogram per op without a measurable cost.

`latency_summary` is the single percentile recipe (p50/p95/p99/p999/max,
milliseconds) shared by every consumer: histogram export here, the
workload runner's per-batch op latencies, and the benchmark harness's
merge/publish percentiles all emit the same keys from the same code, so
the numbers can never disagree on methodology.
"""

from __future__ import annotations

import warnings

import numpy as np

# the percentile set every latency surface exports: the tail levels a
# serving deployment is judged on (ROADMAP's p50/p99/p999 plus the
# historical p95 the bench artifact already records)
PERCENTILES = ((50.0, "p50"), (95.0, "p95"), (99.0, "p99"), (99.9, "p999"))


def latency_summary(seconds, prefix: str = "", *,
                    scale: float = 1e3) -> dict:
    """Percentile summary of raw duration samples (seconds -> ms keys).

    Returns `{<prefix>_ms_p50, ..., _ms_p999, _ms_max, _ms_mean}` plus
    `<prefix>_count` (prefix-less keys when `prefix` is empty).  Empty
    input returns the same key set, all-zero, so every consumer emits a
    stable schema without special-casing quiet ops."""
    p = f"{prefix}_" if prefix else ""
    xs = np.asarray(list(seconds), np.float64) * scale
    out: dict = {f"{p}count": int(xs.size)}
    if xs.size == 0:
        for _, name in PERCENTILES:
            out[f"{p}ms_{name}"] = 0.0
        out[f"{p}ms_max"] = 0.0
        out[f"{p}ms_mean"] = 0.0
        return out
    qs = np.percentile(xs, [q for q, _ in PERCENTILES])
    for (_, name), v in zip(PERCENTILES, qs):
        out[f"{p}ms_{name}"] = float(v)
    out[f"{p}ms_max"] = float(xs.max())
    out[f"{p}ms_mean"] = float(xs.mean())
    return out


_T_MIN = 1e-7                      # 100 ns: below any timeable op
_N_OCTAVES = 32
_SUBS = 32
# one shared immutable edge table: T_MIN * 2**k * (1 + j/SUBS)
_EDGES = _T_MIN * np.concatenate(
    [2.0 ** k * (1.0 + np.arange(1, _SUBS + 1) / _SUBS)
     for k in range(_N_OCTAVES)])
_EDGES.setflags(write=False)


class LatencyHistogram:
    """Log-bucketed duration histogram with fixed, shared bucket edges.

    Buckets span 100ns .. ~400s in 32 octaves x 32 linear sub-buckets
    (1025 counters incl. overflow).  `record` is O(log n_buckets)
    with zero allocation; `summary()` reports quantiles at the bucket
    upper edge (a conservative <=1/32 relative overestimate)."""

    T_MIN = _T_MIN
    N_OCTAVES = _N_OCTAVES
    SUBS = _SUBS
    EDGES = _EDGES

    __slots__ = ("counts", "n", "total_s", "max_s")

    def __init__(self):
        self.counts = np.zeros(len(self.EDGES) + 1, np.int64)
        self.n = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        self.counts[int(np.searchsorted(self.EDGES, seconds))] += 1
        self.n += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other: "LatencyHistogram") -> None:
        self.counts += other.counts
        self.n += other.n
        self.total_s += other.total_s
        self.max_s = max(self.max_s, other.max_s)

    def quantile(self, q: float) -> float:
        """Value (seconds) at quantile q in [0, 1]: the upper edge of the
        bucket holding the q-th sample (0.0 when empty)."""
        if self.n == 0:
            return 0.0
        rank = q * self.n
        i = int(np.searchsorted(np.cumsum(self.counts), rank, side="left"))
        if i >= len(self.EDGES):            # overflow bucket
            return self.max_s
        return float(self.EDGES[i])

    def summary(self, prefix: str = "") -> dict:
        """Same key layout as `latency_summary` (the shared percentile
        contract), estimated from the buckets."""
        p = f"{prefix}_" if prefix else ""
        out: dict = {f"{p}count": self.n}
        if self.n == 0:
            for _, name in PERCENTILES:
                out[f"{p}ms_{name}"] = 0.0
            out[f"{p}ms_max"] = 0.0
            out[f"{p}ms_mean"] = 0.0
            return out
        for q, name in PERCENTILES:
            out[f"{p}ms_{name}"] = self.quantile(q / 100.0) * 1e3
        out[f"{p}ms_max"] = self.max_s * 1e3
        out[f"{p}ms_mean"] = self.total_s / self.n * 1e3
        return out


class MetricsRegistry:
    """Named counters + gauges + latency histograms with one JSON-able
    export.  Creation is lazy; `declare_histogram` pre-registers names so
    every engine exports an identical schema even for ops it never ran."""

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, LatencyHistogram] = {}
        self._warn_calls: dict[str, int] = {}   # warn() rate-limit state

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def declare_counter(self, *names: str) -> None:
        for name in names:
            self.counters.setdefault(name, 0)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def declare_gauge(self, *names: str) -> None:
        for name in names:
            self.gauges.setdefault(name, 0.0)

    def warn(self, name: str, message: str, *, count: int = 1,
             limit: int = 1) -> None:
        """Rate-limited structured warning: `warn.<name>` counts every
        occurrence (floods stay visible in snapshots), but the Python
        warning itself is emitted only for the first `limit` call sites
        per registry, so a per-batch condition can't spam stderr.
        stacklevel=3 points the warning at the engine caller's caller
        (the user's write), matching what a bare warnings.warn showed."""
        calls = self._warn_calls.get(name, 0)
        self._warn_calls[name] = calls + 1
        self.count(f"warn.{name}", count)
        if calls < limit:
            warnings.warn(message, UserWarning, stacklevel=3)

    def declare_histogram(self, *names: str) -> None:
        for name in names:
            self.histograms.setdefault(name, LatencyHistogram())

    def observe(self, name: str, seconds: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = LatencyHistogram()
        h.record(seconds)

    def snapshot(self) -> dict:
        """Stable JSON-able export: plain ints/floats only.

        Safe to sample while another thread records: each dict is copied
        atomically (`dict()` over a live dict is one bytecode) before the
        sorted iteration, so a concurrent counter/gauge/histogram
        registration can't RuntimeError the export — it simply lands in
        this snapshot or the next.  Histogram summaries read live bucket
        counts; a race there skews one sample at most."""
        hists = dict(self.histograms)
        return dict(
            counters=dict(sorted(dict(self.counters).items())),
            gauges=dict(sorted(dict(self.gauges).items())),
            histograms={k: hists[k].summary() for k in sorted(hists)})
