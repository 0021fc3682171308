"""patched_flatten_pct: the share, in percent, of the window's
`merge.flatten` spans that hold the program's `flatten.patch` span, that
is of the merges whose writes only replaced existing payloads, so that
the program patched the published snapshot (`core/flat.py::
patch_payloads`) instead of running the full flatten.  None without
merges, and None against a program that declares no such span
(`repro_torch.obs.tracing.PATCH_STAGES`)."""

import bisect

PATCH = "flatten.patch"


def _declared() -> bool:
    try:
        from repro_torch.obs import tracing
    except ImportError:
        return False
    return PATCH in getattr(tracing, "PATCH_STAGES", ())


def read(rec):
    flattens = [(t0, t0 + d) for name, t0, d in rec.spans
                if name == "merge.flatten"]
    if not flattens or not _declared():
        return None
    starts = sorted(t0 for name, t0, _ in rec.spans if name == PATCH)
    held = sum(bisect.bisect_right(starts, b) > bisect.bisect_left(starts, a)
               for a, b in flattens)
    return 100.0 * held / len(flattens)
