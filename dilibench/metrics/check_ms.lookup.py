"""check_ms.lookup: milliseconds of the program's `lookup.check` span (the
facade's `asarray`, finite check and pow2 padding), the mean over the
window's lookup calls."""

from dilibench.stages import lookup_stages, mean_ms


def read(rec):
    return mean_ms(lookup_stages(rec), ("lookup.check",))
