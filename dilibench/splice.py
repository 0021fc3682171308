"""The program's splice stages (`repro_torch.obs.tracing.SPLICE_STAGES`,
recorded with telemetry on by the incremental flattener) matched to the
window's `merge.flatten` spans, as `stages.py` matches the full flatten's.

Only a `merge.flatten` that ends by the window's end counts.  With
background maintenance the worker can still be inside a merge that began
in the window when the window closes; the harness keeps the spans that
start in the window, so such a merge would hold only its first stages,
and every reader would find nothing for the whole run.
"""

from __future__ import annotations

from dilibench.stages import stages_in
from dilibench.trace import Records

SPLICE_STAGES = ("splice.units", "splice.refresh", "splice.offsets",
                 "splice.assemble")


def splice_stages(rec: Records) -> list[dict] | None:
    end = rec.window[1]
    return stages_in(rec.spans, [(t0, t0 + d) for name, t0, d in rec.spans
                                 if name == "merge.flatten"
                                 and t0 + d <= end], SPLICE_STAGES)
