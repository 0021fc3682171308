"""writes_per_merge: pairs written in the window over the merges they
triggered (`LearnedIndex.n_merges` growth)."""


def read(rec):
    if not rec.merges:
        return None
    return sum(c.n for c in rec.calls if c.op == "upsert") / rec.merges
