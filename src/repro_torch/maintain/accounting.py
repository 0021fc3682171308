"""Per-leaf maintenance accounting: write counts, tombstone density, and a
drift statistic comparing recent key arrivals against the leaf's
build-time distribution.

The drift statistic needs no stored histogram: the leaf's linear model IS
its build-time distribution summary (least squares maps the build keys
roughly uniformly over the slot range).  Mapping recent arrival keys
through the model, `u = clip((a + b*k) / fo, 0, 1)`, a leaf still serving
its build distribution sees `u ~ uniform[0, 1]`; a drifted region piles
arrivals into a narrow slot band.  The Kolmogorov-Smirnov distance between
the arrival `u`s and uniform is the drift score — the same multicriteria
"has the model's error budget moved" view the PGM-index takes, localized
to DILI's equal-division subtrees.

`LeafAccounting.plan()` turns the accounts into a retrain list: leaves
whose drift crossed `drift_threshold` (with at least `retrain_min_writes`
arrivals) or whose tombstone density crossed `tombstone_trigger`.
`fold_with_accounting` is the drop-in replacement for
`online.overlay.fold_overlay` that feeds the accounts while folding.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.dili import DILI, Leaf, rebuild_subtree, split_leaf
from .config import MaintenanceConfig

PAUSE_EVERY = 8     # fold entries between calls of `pause` (~60 us each)


@dataclass
class LeafAccount:
    leaf: Leaf                  # strong ref: keeps the account's id stable
    writes: int = 0
    deletes: int = 0
    arrivals: list = field(default_factory=list)   # recent upsert keys
    # write heat (re-clustering signal): epoch of the last write and the
    # number of CONSECUTIVE merge epochs with at least one write — O(1)
    # bookkeeping per write, no per-epoch sweep over accounts
    last_epoch: int = 0
    hot_streak: int = 0

    def note(self, key: float, tomb: bool, window: int) -> None:
        self.writes += 1
        if tomb:
            self.deletes += 1
        else:
            self.arrivals.append(key)
            if len(self.arrivals) > window:
                del self.arrivals[: len(self.arrivals) - window]


def ks_uniform(u: np.ndarray) -> float:
    """Kolmogorov-Smirnov distance of samples `u` (in [0, 1]) vs uniform."""
    n = len(u)
    if n == 0:
        return 0.0
    u = np.sort(u)
    grid = np.arange(1, n + 1) / n
    return float(np.maximum(grid - u, u - (grid - 1 / n)).max())


def leaf_drift(leaf: Leaf, arrivals) -> float:
    """KS distance of arrival keys mapped through the leaf's model."""
    if len(arrivals) == 0 or leaf.fo <= 1:
        return 0.0
    k = np.asarray(arrivals, np.float64)
    u = np.clip((leaf.a + leaf.b * k) / leaf.fo, 0.0, 1.0)
    return ks_uniform(u)


class LeafAccounting:
    """Account book for one host DILI (or one shard's)."""

    def __init__(self, cfg: MaintenanceConfig):
        self.cfg = cfg
        self._accounts: dict[int, LeafAccount] = {}
        self._touched: set[int] = set()          # since the last plan()
        self.epoch = 0                           # merge epochs seen
        self._hot_touched: set[int] = set()      # since the last recluster plan

    def __len__(self) -> int:
        return len(self._accounts)

    def accounts(self) -> list[LeafAccount]:
        """The live accounts (read-only view for `obs.inspect`'s heat
        summaries)."""
        return list(self._accounts.values())

    def begin_epoch(self) -> None:
        """Advance the merge-epoch counter; called once per merge fold so
        `hot_streak` measures persistence ACROSS merges, not within one."""
        self.epoch += 1

    def note(self, leaf: Leaf, key: float, tomb: bool) -> None:
        lid = id(leaf)
        acct = self._accounts.get(lid)
        if acct is None or acct.leaf is not leaf:
            acct = self._accounts[lid] = LeafAccount(leaf)
        acct.note(key, tomb, self.cfg.arrival_window)
        if acct.last_epoch != self.epoch:
            acct.hot_streak = (acct.hot_streak + 1
                               if acct.last_epoch == self.epoch - 1 else 1)
            acct.last_epoch = self.epoch
        self._touched.add(lid)
        self._hot_touched.add(lid)

    # -- decisions -----------------------------------------------------------

    def tombstone_density(self, acct: LeafAccount) -> float:
        return acct.deletes / max(acct.leaf.omega + acct.deletes, 1)

    def should_retrain(self, acct: LeafAccount) -> bool:
        cfg = self.cfg
        if acct.leaf.omega < 2:
            return False
        if (acct.deletes >= cfg.retrain_min_writes
                and self.tombstone_density(acct) > cfg.tombstone_trigger):
            return True
        return (acct.writes >= cfg.retrain_min_writes
                and leaf_drift(acct.leaf, acct.arrivals)
                > cfg.drift_threshold)

    def plan(self) -> list[Leaf]:
        """Leaves (touched since the last plan) due for a retrain."""
        due = [self._accounts[lid] for lid in self._touched
               if lid in self._accounts]
        self._touched.clear()
        if not self.cfg.retrain:      # accounting kept for recluster only
            return []
        return [a.leaf for a in due if self.should_retrain(a)]

    def forget(self, leaf: Leaf) -> None:
        """Drop a retrained leaf's account (its region restarts clean)."""
        self._accounts.pop(id(leaf), None)

    def plan_reclusters(self, flattener) -> list[tuple[Leaf, int]]:
        """Persistently-hot large segments due for a locality split, hottest
        and largest first, as `(leaf, n_children)` pairs.

        A leaf qualifies when it has received writes in
        `recluster_hot_streak` consecutive merge epochs AND its cached
        flatten segment spans at least `recluster_min_rows` slot rows (the
        flattener's row count is the actual cost a dirty segment adds to a
        merge — pairs undercount conflict-chain slots).  The per-merge
        budget `recluster_max_per_merge` keeps any single publish bounded;
        leftover hot leaves re-qualify next merge if the writes persist."""
        cfg = self.cfg
        due = self._hot_touched
        self._hot_touched = set()
        if not cfg.recluster or flattener is None:
            return []
        cand: list[tuple[int, int, Leaf]] = []
        for lid in due:
            acct = self._accounts.get(lid)
            if acct is None or acct.hot_streak < cfg.recluster_hot_streak:
                continue
            rows = flattener.segment_rows(lid)
            if rows is None or rows < cfg.recluster_min_rows:
                continue
            cand.append((acct.hot_streak, rows, acct.leaf))
        cand.sort(key=lambda c: (c[0], c[1]), reverse=True)
        out = []
        for _, rows, leaf in cand[: cfg.recluster_max_per_merge]:
            fo = int(np.clip(-(-rows // max(cfg.recluster_target_pairs, 1)),
                             2, 256))
            out.append((leaf, fo))
        return out


def fold_with_accounting(dili: DILI, ov,
                         accounting: LeafAccounting | None,
                         pause=None) -> None:
    """`fold_overlay` plus per-write accounting: tombstones via Algorithm 8,
    live entries via Algorithm 7, each noted against the top-level leaf the
    write lands in (the incremental flattener's segment unit).

    One tree walk per entry: the leaf is located once and the Alg. 7/8
    bodies are driven with it directly — `dili.upsert`/`delete` would
    re-locate the same leaf, doubling the host-walk cost on the merge
    path this subsystem exists to shrink.  The dirty marking the public
    entry points perform happens here instead.  `pause`, when given, is
    called before every `PAUSE_EVERY` entries (the maintenance worker's
    yield to write calls)."""
    if accounting is not None:
        accounting.begin_epoch()
    keys, vals, tomb = ov.entries()
    for i, (k, v, t) in enumerate(zip(keys, vals, tomb)):
        if pause is not None and not i % PAUSE_EVERY:
            pause()
        k = float(k)
        leaf, _ = dili.locate_leaf(k)
        dili.dirty_ids.add(id(leaf))
        if accounting is not None:
            accounting.note(leaf, k, bool(t))
        if t:
            dili._delete_from_leaf(leaf, k)
        elif not dili._insert_to_leaf(leaf, k, int(v)):
            dili._set_payload_at(leaf, k, int(v))   # update in place


def run_retrains(dili: DILI, accounting: LeafAccounting) -> int:
    """Rebuild every leaf the accounting flagged; returns the count."""
    n = 0
    for leaf in accounting.plan():
        if rebuild_subtree(dili, leaf) is not None:
            accounting.forget(leaf)
            n += 1
    return n


def run_reclusters(dili: DILI, accounting: LeafAccounting,
                   flattener) -> int:
    """Split every persistently-hot large leaf the accounting flagged into
    its own fan of small splice segments (DESIGN.md section 12); returns
    the number of splits performed.  Runs AFTER `run_retrains` in the
    merge pipeline: a leaf both retrained and heat-flagged was already
    replaced (and its account forgotten), so the planner skips it and the
    fresh subtree re-qualifies from a cold streak if the heat persists."""
    n = 0
    for leaf, fo in accounting.plan_reclusters(flattener):
        if split_leaf(dili, leaf, fo) is not None:
            accounting.forget(leaf)
            n += 1
    return n
