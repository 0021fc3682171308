"""Cooperative crash-injection points for the durability subsystem.

`tests/crashkit.py` arms a named kill point in a child process via the
environment:

    DILI_CRASH_POINT="<point>:<n>"     # SIGKILL on the n-th hit of <point>

and the durability code calls `crash_point("<point>")` at the protocol
boundaries worth dying at (after a WAL append, before/inside a checkpoint
publish, mid-WAL-record).  Unarmed (the production case) a crash point is
one cached string comparison; SIGKILL — not sys.exit — because the whole
point is that NO cleanup runs (no buffer flush, no atexit, no close).

The points:

  wal.append        — the batch's WAL record is fully written + synced
                      (the write is durable; the caller never saw the ack)
  wal.mid_record    — half a WAL record is on disk (torn tail)
  ckpt.pre_publish  — checkpoint staged in the .tmp dir, not yet published
  ckpt.mid_publish  — step dir published (os.replace done), `latest`
                      pointer not yet moved
"""

from __future__ import annotations

import os
import signal

ENV_VAR = "DILI_CRASH_POINT"

_armed_point: str | None = None
_remaining: int = 0
_parsed_env: str | None = None


def _parse() -> None:
    """(Re)parse the env var; cached per value so the unarmed hot path is
    one dict lookup + string compare."""
    global _armed_point, _remaining, _parsed_env
    spec = os.environ.get(ENV_VAR, "")
    if spec == _parsed_env:
        return
    _parsed_env = spec
    if not spec:
        _armed_point, _remaining = None, 0
        return
    point, _, n = spec.partition(":")
    _armed_point = point
    _remaining = int(n) if n else 1


def armed(point: str) -> bool:
    """Whether `point` is the armed kill point (used to gate test-only
    code shapes, e.g. the split two-write WAL record path)."""
    _parse()
    return _armed_point == point


def crash_point(point: str) -> None:
    """Die (SIGKILL, no cleanup) if this is the armed point's n-th hit."""
    global _remaining
    if not armed(point):
        return
    _remaining -= 1
    if _remaining <= 0:
        os.kill(os.getpid(), signal.SIGKILL)
