"""mixed_ops_s: every operation of the window's calls (keys read and pairs
written) over all of the window's seconds; the merges the writes trigger
run inside the calls."""


def read(rec):
    return sum(c.n for c in rec.calls) / rec.window_s
