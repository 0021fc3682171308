"""facade_host_ms.lookup: host milliseconds of a lookup call in which no
operation ran on the device (the call's span minus the device intervals
inside it), the mean over the window's lookup calls."""

from dilibench.trace import per_call, total, union


def read(rec):
    calls = rec.of("lookup")
    if not calls or not rec.device:
        return None
    inside = per_call(rec, calls)
    host = [c.t1 - c.t0 - total(union((a, b) for _, a, b in ev))
            for c, ev in zip(calls, inside)]
    return sum(host) / len(host) * 1e3
