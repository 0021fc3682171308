"""Recompile watchdog, the port's counterpart of `repro.obs.watchdog`.

The JAX package counts jit traces and XLA compiles through
`jax.monitoring`.  PyTorch runs eagerly and this package never calls
`torch.compile`, so the only executables it mints are its hand-written
CUDA kernels, built by `nvcc` at first use.  Each such build counts as a
"compile"; "traces" stays 0.  The key set (`traces`, `compiles`, the
per-entry-point cache sizes, `TraceMark` deltas) is the reference's, so
`metrics()["retrace"]` has the same shape on both packages.

Counters are process-wide: deltas attribute every build in the window to
the index being measured.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

_counts = {"traces": 0, "compiles": 0}
_lock = threading.Lock()


def note_compile() -> None:
    """Record one kernel build (called by the kernel loaders)."""
    with _lock:
        _counts["compiles"] += 1


def trace_counts() -> dict:
    """Process-global {traces, compiles} so far."""
    with _lock:
        return dict(_counts)


# -- named cache registry -------------------------------------------------------

_PROVIDERS: dict[str, object] = {}


def register_jit_provider(name: str, provider) -> None:
    """Register a zero-arg callable returning an int cache size (built
    kernel libraries behind one entry point) — or a {name: size} dict."""
    _PROVIDERS[name] = provider


def jit_cache_sizes() -> dict:
    """{entry point name: built executables} for every registered
    provider; -1 where a provider fails."""
    out: dict = {}
    for name, provider in _PROVIDERS.items():
        try:
            got = provider()
        except Exception:
            out[name] = -1
            continue
        if isinstance(got, dict):
            out.update({k: int(v) for k, v in got.items()})
        else:
            out[name] = int(got)
    return dict(sorted(out.items()))


# -- windowed deltas ----------------------------------------------------------


@dataclass(frozen=True)
class TraceMark:
    traces: int
    compiles: int

    @classmethod
    def now(cls) -> "TraceMark":
        c = trace_counts()
        return cls(traces=c["traces"], compiles=c["compiles"])

    def delta(self) -> dict:
        c = trace_counts()
        return dict(traces=c["traces"] - self.traces,
                    compiles=c["compiles"] - self.compiles)
