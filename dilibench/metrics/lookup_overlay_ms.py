"""lookup_overlay_ms: milliseconds of the program's `lookup.overlay` span
(inside `lookup.stage`: the live overlay resolved over the frozen one a
background merge is folding, and its device mirror), the mean over the
window's lookup calls."""

from dilibench.stages import mean_ms, stages_in


def read(rec):
    return mean_ms(stages_in(rec.spans,
                             [(c.t0, c.t1) for c in rec.of("lookup")],
                             ("lookup.overlay",)), ("lookup.overlay",))
