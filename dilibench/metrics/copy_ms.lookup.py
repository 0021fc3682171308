"""copy_ms.lookup: device milliseconds of host<->device copies inside a
lookup call, the mean over the window's lookup calls."""

from dilibench.trace import is_copy, per_call


def read(rec):
    calls = rec.of("lookup")
    if not calls or not rec.device:
        return None
    inside = per_call(rec, calls)
    copy = sum(b - a for ev in inside for name, a, b in ev if is_copy(name))
    return copy / len(calls) * 1e3
