"""splice_walks_ms: milliseconds of the program's `splice.units` and
`splice.offsets` spans (the incremental flattener's walk of the tree into
units with the dirty ids' translation, and its pass over the units that
assigns their offsets), the mean over the window's splice flattens
(`merge.flatten` spans that end in the window)."""

from dilibench.splice import splice_stages
from dilibench.stages import mean_ms


def read(rec):
    return mean_ms(splice_stages(rec), ("splice.units", "splice.offsets"))
