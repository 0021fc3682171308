"""flatten_walks_ms: milliseconds of the program's `flatten.preorder` and
`flatten.shape` spans (the node walk and numbering, `_max_depth` and
`_n_segments`), the mean over the window's full flattens (`merge.flatten`
spans)."""

from dilibench.stages import flatten_stages, mean_ms


def read(rec):
    return mean_ms(flatten_stages(rec), ("flatten.preorder", "flatten.shape"))
