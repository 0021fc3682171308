"""flatten_pairs_ms: milliseconds of the program's `flatten.pairs` span
(the key-sorted pair table: argsort of the pair slots and its gathers),
the mean over the window's full flattens (`merge.flatten` spans)."""

from dilibench.stages import flatten_stages, mean_ms


def read(rec):
    return mean_ms(flatten_stages(rec), ("flatten.pairs",))
