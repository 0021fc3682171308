"""write_p95_ms: 95th percentile of every upsert call's latency in the
window, the synchronous merge a call triggers included (host clock)."""

import numpy as np


def read(rec):
    calls = rec.of("upsert")
    if not calls:
        return None
    return float(np.percentile([c.t1 - c.t0 for c in calls], 95)) * 1e3
