"""flatten_tables_ms: milliseconds of the program's `flatten.tables` span
(`core/flat.py::node_tables`, the per-slot pass), the mean over the
window's full flattens (`merge.flatten` spans)."""

from dilibench.stages import flatten_stages, mean_ms


def read(rec):
    return mean_ms(flatten_stages(rec), ("flatten.tables",))
