"""setup_s: seconds from the start of `run.py` to the window's first call
(data and traffic from the seed, the build, the upload, the warm-up)."""


def read(rec):
    return rec.setup_s
