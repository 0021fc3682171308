"""download_ms.lookup: milliseconds of the program's `lookup.download`
span (the wait for the kernel and the payloads' and flags' pageable
device-to-host copies), the mean over the window's lookup calls."""

from dilibench.stages import lookup_stages, mean_ms


def read(rec):
    return mean_ms(lookup_stages(rec), ("lookup.download",))
