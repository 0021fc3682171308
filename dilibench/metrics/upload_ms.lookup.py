"""upload_ms.lookup: milliseconds of the program's `lookup.upload` span
(the queries' pageable host-to-device copy, host staging included), the
mean over the window's lookup calls."""

from dilibench.stages import lookup_stages, mean_ms


def read(rec):
    return mean_ms(lookup_stages(rec), ("lookup.upload",))
