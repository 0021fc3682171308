"""merge_ms: milliseconds of a merge's stages as the program's spans time
them (`merge.fold`, `merge.retrain`, `merge.recluster`, `merge.flatten`,
`merge.publish`, recorded with `telemetry=True` in the traced run), the
mean over the merges the window's writes triggered."""

from dilibench.trace import MERGE_STAGES


def read(rec):
    if not rec.merges:
        return None
    spent = sum(d for name, _, d in rec.spans if name in MERGE_STAGES)
    if spent <= 0:
        return None
    return spent / rec.merges * 1e3
