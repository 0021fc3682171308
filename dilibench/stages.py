"""The program's stage spans (recorded with telemetry on, in the traced
run) matched to the intervals that hold them: `lookup.*` to the window's
lookup calls, `flatten.*` to its `merge.flatten` spans.  The names are the
program's (`repro_torch.obs.tracing.LOOKUP_STAGES`, `FLATTEN_STAGES`),
written out here because a reader also runs against a program that has
no stage spans, and then finds nothing.

A stage belongs to the interval its span starts in.  A reader gets a
number only where every interval holds exactly one span of each stage, so
that a dropped or doubled span shows as a missing number, not a biased
one.
"""

from __future__ import annotations

import bisect

from dilibench.trace import Records

LOOKUP_STAGES = ("lookup.check", "lookup.stage", "lookup.upload",
                 "lookup.download")
FLATTEN_STAGES = ("flatten.preorder", "flatten.tables", "flatten.pairs",
                  "flatten.shape")


def stages_in(spans, intervals, names) -> list[dict] | None:
    """For each (t0, t1) of `intervals`, {stage: (t0, t1)} of the one span
    of each of `names` that starts inside it; None without intervals, or
    where an interval lacks a stage or holds one twice."""
    if not intervals:
        return None
    mine = sorted((t0, t0 + d, name) for name, t0, d in spans
                  if name in names)
    starts = [s[0] for s in mine]
    out = []
    for a, b in intervals:
        got: dict = {}
        for t0, t1, name in mine[bisect.bisect_left(starts, a):
                                 bisect.bisect_right(starts, b)]:
            if name in got:
                return None
            got[name] = (t0, t1)
        if len(got) != len(names):
            return None
        out.append(got)
    return out


def lookup_stages(rec: Records) -> list[dict] | None:
    return stages_in(rec.spans, [(c.t0, c.t1) for c in rec.of("lookup")],
                     LOOKUP_STAGES)


def flatten_stages(rec: Records) -> list[dict] | None:
    return stages_in(rec.spans, [(t0, t0 + d) for name, t0, d in rec.spans
                                 if name == "merge.flatten"], FLATTEN_STAGES)


def mean_ms(per: list[dict] | None, names) -> float | None:
    """The mean over the intervals of the summed durations of the stages
    `names`, in milliseconds; None where `per` is None."""
    if per is None:
        return None
    return sum(got[n][1] - got[n][0] for got in per for n in names) \
        / len(per) * 1e3

