"""build_s: seconds of `LearnedIndex.build` (host bulk load, flatten,
table packing and upload), on the benchmark's host timer."""


def read(rec):
    return rec.build_s
