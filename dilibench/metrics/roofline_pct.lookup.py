"""roofline_pct.lookup: the least time the lookup calls' bytes need at the
HBM peak, over the device time of every kernel launched inside them, in
percent.  Bytes come from each call's inputs and outputs
(`peaks.lookup_bytes`); kernels are found by their place inside the call,
whatever their names, copies left out."""

from dilibench.peaks import HBM_BYTES_S, lookup_bytes
from dilibench.trace import is_copy, per_call


def read(rec):
    calls = [c for c in rec.of("lookup") if c.pool in rec.distinct_found]
    if not calls or not rec.device:
        return None
    inside = per_call(rec, calls)
    kernel_s = sum(b - a for ev in inside for name, a, b in ev
                   if not is_copy(name))
    if kernel_s <= 0:
        return None
    need = sum(lookup_bytes(c.n, rec.distinct_found[c.pool]) for c in calls)
    return 100.0 * need / HBM_BYTES_S / kernel_s
