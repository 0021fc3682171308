"""How `correct` is decided: every read answer the window kept is compared
with the plain reference (`reference.SortedArrayMap`) replaying the same
calls in the same order, after the window has closed.

Numbers compared, each with its limit (exact comparisons, limit 0):
  wrong_lanes — read lanes whose answer differs from the reference's;
  raised_ops  — operations of calls that raised.
The control (the program's f32 path, `control.py`) reads wrong_lanes in
the thousands or more on every seed tried; PERF.md gives the readings.
"""

from __future__ import annotations

from .reference import SortedArrayMap, wrong_lanes
from .traffic import Pool

LIMITS = {"wrong_lanes": 0, "raised_ops": 0}


def compare(data, pool: Pool, calls, answers: dict) -> dict:
    """Replay the window's calls through the reference; return each number
    compared, the lanes compared and the calls whose answers were read."""
    ref = SortedArrayMap(data.keys, data.vals)
    wrong = lanes = read = 0
    for i, c in enumerate(calls):
        b = pool.call(i)
        if b.op in ("upsert", "delete"):
            ref.apply(b, pool.max_hits)
        elif i in answers:
            wrong += wrong_lanes(b.op, answers[i], ref.apply(b, pool.max_hits))
            lanes += b.n_ops
            read += 1
    raised = sum(c.n for c in calls if not c.ok)
    return dict(numbers=dict(wrong_lanes=wrong, raised_ops=raised),
                lanes=lanes, calls=read)


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
