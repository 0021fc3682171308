"""lookup_keys_s: keys answered by the window's lookup calls over all of
the window's seconds."""


def read(rec):
    calls = rec.of("lookup")
    if not calls:
        return None
    return sum(c.n for c in calls) / rec.window_s
