"""splice_refresh_ms: milliseconds of the program's `splice.refresh` span
(the incremental flattener's pass 1: the segments the merge dirtied
flattened again, the dead ones dropped), the mean over the window's
splice flattens (`merge.flatten` spans that end in the window)."""

from dilibench.splice import splice_stages
from dilibench.stages import mean_ms


def read(rec):
    return mean_ms(splice_stages(rec), ("splice.refresh",))
