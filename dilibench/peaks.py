"""The chip's published peaks and the work a call needs, counted from its
inputs and outputs only, so that the count reads the same whatever kernel
or table layout serves the call.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W power limit):
HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12

KEY_BYTES = 8        # an f64 query key, read once
ANSWER_BYTES = 9     # an i64 payload and a 1-byte found flag, written once
PAIR_BYTES = 16      # a stored key and payload that the batch finds


def lookup_bytes(n_lanes: int, n_distinct_found: int) -> int:
    """Bytes one lookup call must move: each query key read once, each
    answer written once, and the stored pair of each distinct key the
    batch finds read once."""
    return (n_lanes * (KEY_BYTES + ANSWER_BYTES)
            + n_distinct_found * PAIR_BYTES)


def distinct_found(queries: np.ndarray, found: np.ndarray) -> int:
    return int(len(np.unique(np.asarray(queries)[np.asarray(found, bool)])))
