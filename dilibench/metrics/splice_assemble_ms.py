"""splice_assemble_ms: milliseconds of the program's `splice.assemble`
span (the incremental flattener's pass 3: the per-unit arrays gathered,
concatenated and shifted into the `FlatDILI`), the mean over the window's
splice flattens (`merge.flatten` spans that end in the window)."""

from dilibench.splice import splice_stages
from dilibench.stages import mean_ms


def read(rec):
    return mean_ms(splice_stages(rec), ("splice.assemble",))
