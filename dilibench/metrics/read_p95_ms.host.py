"""read_p95_ms.host: 95th percentile of every lookup call's latency in the
traced window, from the call until its NumPy answers are in hand (host
clock, the profiler running).  A per-layer reading where the host's
run-to-run spread leaves no room for a bound on `read_p95_ms`."""

import numpy as np


def read(rec):
    calls = rec.of("lookup")
    if not calls:
        return None
    return float(np.percentile([c.t1 - c.t0 for c in calls], 95)) * 1e3
