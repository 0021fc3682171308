"""`MaintenanceConfig`: the knob set of the adaptive maintenance subsystem.

One frozen dataclass shared by every engine (threaded through
`api.IndexConfig.maintenance`) and by `OnlineIndex` directly.  `None`
anywhere a `MaintenanceConfig` is accepted means the legacy monolithic
path: full `flatten()` per merge, no drift accounting, no retrains, no
background thread.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MaintenanceConfig:
    """Adaptive maintenance knobs (DESIGN.md section 12).

    incremental       : splice-flatten — re-flatten only the subtrees the
                        merge dirtied and reassemble from cached segment
                        blocks; bit-identical to a full `flatten()`.
    retrain           : drift/tombstone-triggered subtree rebuilds — re-run
                        the paper's top-down fanout individualization
                        (Alg. 4/5) on degraded regions instead of letting
                        Alg. 7's per-leaf adjustment degrade globally.
    drift_threshold   : KS distance between recent arrival keys (mapped
                        through the leaf's own model) and the uniform slot
                        fill the model was fit to; above it the leaf's
                        region no longer looks like its build distribution.
    retrain_min_writes: per-leaf write floor before drift is trusted (a KS
                        statistic over a handful of arrivals is noise).
    tombstone_trigger : deletes / (live + deletes) density per leaf above
                        which the region is rebuilt to compact it.
    arrival_window    : per-leaf ring-buffer size of recent arrival keys
                        the drift statistic is computed over.
    background        : run merges + retrains on a `MaintenanceScheduler`
                        worker thread against the double-buffered
                        `SnapshotStore` (local engine only) so the writer
                        never blocks on a publish.
    max_queue         : background task-queue bound; triggers that find the
                        queue full coalesce into the next merge.
    max_merge_retries : background-merge attempts AFTER the first failure
                        (jittered exponential backoff between attempts;
                        re-folding a partially-applied overlay is
                        idempotent).  After exhaustion the index degrades
                        to synchronous merges and sets the `maint_degraded`
                        stats()/metrics() flag.  0 = fail on first error
                        (the pre-durability behavior).
    retry_backoff_s   : base backoff before retry k is
                        `retry_backoff_s * 2**k`, jittered to 50-150%.
    recluster         : locality-aware segment re-clustering — split leaves
                        that stay write-hot across consecutive merges into
                        many small leaf segments, so a skewed write stream
                        dirties O(hot segments) per merge instead of
                        re-flattening nearly every row (the zipfian
                        hashed-rank-scatter pathology, DESIGN.md section 12).
    recluster_hot_streak : consecutive merge epochs a leaf must receive
                        writes before it counts as persistently hot.
    recluster_min_rows: only split leaves whose flattened segment spans at
                        least this many slot rows — splitting already-small
                        segments churns node ids for no dirty-row savings.
    recluster_target_pairs : aim each child segment at roughly this many
                        pairs; the split fanout is ceil(pairs / target),
                        clamped to [2, 256].
    recluster_max_per_merge : per-merge split budget, bounding splice work
                        added to any single publish.  Sized to FINISH
                        adoption fast: under uniform-scatter skew nearly
                        every large segment eventually qualifies, and a
                        small budget prolongs the phase where merges pay
                        both high dirty fractions AND split cost — better
                        to front-load the one-time splits into a few
                        merges (visible as p95/p99 spikes) and reach the
                        low-dirty steady state early.
    """

    incremental: bool = True
    retrain: bool = True
    drift_threshold: float = 0.35
    retrain_min_writes: int = 96
    tombstone_trigger: float = 0.25
    arrival_window: int = 128
    background: bool = False
    max_queue: int = 4
    max_merge_retries: int = 2
    retry_backoff_s: float = 0.05
    recluster: bool = True
    recluster_hot_streak: int = 2
    recluster_min_rows: int = 2048
    recluster_target_pairs: int = 512
    recluster_max_per_merge: int = 1024

    # -- (de)serialization for api.IndexConfig round-trips -------------------

    def to_json_dict(self) -> dict:
        return dict(incremental=self.incremental, retrain=self.retrain,
                    drift_threshold=self.drift_threshold,
                    retrain_min_writes=self.retrain_min_writes,
                    tombstone_trigger=self.tombstone_trigger,
                    arrival_window=self.arrival_window,
                    background=self.background, max_queue=self.max_queue,
                    max_merge_retries=self.max_merge_retries,
                    retry_backoff_s=self.retry_backoff_s,
                    recluster=self.recluster,
                    recluster_hot_streak=self.recluster_hot_streak,
                    recluster_min_rows=self.recluster_min_rows,
                    recluster_target_pairs=self.recluster_target_pairs,
                    recluster_max_per_merge=self.recluster_max_per_merge)

    @classmethod
    def from_json_dict(cls, d: dict) -> "MaintenanceConfig":
        return cls(**d)
