"""stage_ms.lookup: milliseconds of the program's `lookup.stage` span (the
local engine's overlay mirror and the numpy cast of the queries, up to the
copy), the mean over the window's lookup calls."""

from dilibench.stages import lookup_stages, mean_ms


def read(rec):
    return mean_ms(lookup_stages(rec), ("lookup.stage",))
