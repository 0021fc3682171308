"""Merge policy and the λ-pressure trigger (port of the policy half of
`repro/online/merge.py`; DESIGN.md section 8).

Merge triggers (checked by the engine after every write batch):
  * `max_fill`      — overlay `full_fraction` reached (bounded write buffer);
  * `max_writes`    — merge lag: writes absorbed since the last publish;
  * adjustment pressure — a λ-style per-leaf trigger: if any single host leaf
    has pending writes exceeding `pressure_lambda ×` its current pair count,
    merging early lets Algorithm 7's adjustment re-spread that region;
  * explicit `flush()`.

`OnlineIndex` and the epoch publisher wait for the local-engine slice
(see ROADMAP.md).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from ..core.dili import DILI, LAMBDA
from .overlay import TombstoneOverlay


@dataclass(frozen=True)
class MergePolicy:
    max_fill: float = 0.5          # overlay full_fraction trigger
    max_writes: int = 4096         # merge-lag trigger (writes since publish)
    pressure_lambda: float = LAMBDA  # per-leaf pending/omega trigger
    pressure_check_every: int = 256  # amortize the host-side leaf walk
    # absolute floor for the pressure trigger: a leaf only counts toward a
    # λ-pressure merge once it holds this many pending writes
    pressure_min_pending: int = 64


def adjust_pressure(dili: DILI, ov: TombstoneOverlay,
                    min_pending: int = 1) -> float:
    """max over host leaves of pending-writes / current-pairs — the overlay
    analogue of Alg. 7's Δ/Ω > λκ adjustment test.  Leaves with fewer than
    `min_pending` pending writes are ignored (policy floor)."""
    if ov.count == 0:
        return 0.0
    keys, _, _ = ov.entries()
    hits: Counter = Counter()
    omega: dict[int, int] = {}
    for k in keys:
        leaf, _ = dili.locate_leaf(float(k))
        lid = id(leaf)
        hits[lid] += 1
        omega[lid] = leaf.omega
    return max((c / max(omega[lid], 1)
                for lid, c in hits.items() if c >= min_pending),
               default=0.0)
