"""`DurabilityConfig`: the knob set of the durability subsystem.

Threaded through `api.IndexConfig.durability`; `None` (the default
everywhere) means the legacy in-memory index — no WAL, no checkpoints,
`save()`/`load()` only.  The directory layout it governs:

    <dir>/wal/shard_00000/seg_0000000000000000.wal   (one WAL per shard)
    <dir>/ckpt/step_00000000/{state.npz, manifest.json}
    <dir>/ckpt/latest

fsync policy semantics (the group-commit knob):

  "always"    — fsync after every acknowledged append: a record survives
                both process death AND power loss before the caller sees
                the write return.
  "interval"  — flush to the OS per append (survives process death),
                fsync at most once per `fsync_interval_s` (bounded
                power-loss window, amortized syscall cost).
  "off"       — flush to the OS per append only; no fsync is ever issued
                (crash-consistent against process death, not power loss).
"""

from __future__ import annotations

from dataclasses import dataclass

FSYNC_MODES = ("always", "interval", "off")


@dataclass(frozen=True)
class DurabilityConfig:
    """Durability knobs (DESIGN.md section 14).

    dir                     : root directory for the WAL + checkpoints.
    fsync                   : "always" | "interval" | "off" (see module
                              docstring).
    fsync_interval_s        : group-commit window for fsync="interval".
    checkpoint_every_merges : write a checkpoint after every N-th merge
                              publish (1 = after each; the checkpoint is
                              what lets the WAL truncate).
    keep_checkpoints        : published checkpoints retained; the WAL is
                              only truncated below the OLDEST retained
                              checkpoint's watermark so a corrupt newest
                              checkpoint can still fall back and replay a
                              longer tail.
    """

    dir: str = ""
    fsync: str = "interval"
    fsync_interval_s: float = 0.05
    checkpoint_every_merges: int = 1
    keep_checkpoints: int = 3

    def __post_init__(self):
        if not self.dir:
            raise ValueError("DurabilityConfig.dir is required")
        if self.fsync not in FSYNC_MODES:
            raise ValueError(f"unknown fsync mode {self.fsync!r}; "
                             f"expected one of {FSYNC_MODES}")
        if self.checkpoint_every_merges < 1:
            raise ValueError("checkpoint_every_merges must be >= 1")
        if self.keep_checkpoints < 1:
            raise ValueError("keep_checkpoints must be >= 1")

    # -- (de)serialization for api.IndexConfig round-trips -------------------

    def to_json_dict(self) -> dict:
        return dict(dir=self.dir, fsync=self.fsync,
                    fsync_interval_s=self.fsync_interval_s,
                    checkpoint_every_merges=self.checkpoint_every_merges,
                    keep_checkpoints=self.keep_checkpoints)

    @classmethod
    def from_json_dict(cls, d: dict) -> "DurabilityConfig":
        return cls(**d)
