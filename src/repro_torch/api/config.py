"""`IndexConfig`: one declarative knob set for every engine (port of
`repro/api/config.py`).

The fields, their defaults, the JSON round-trip and `ENGINES` are the
reference's, so a config written by either package reads in the other.
Only `resolved_dtype` differs: it returns a torch dtype.  The device is
not a config field (that would change the JSON); engines take it as a
constructor argument.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..durability.config import DurabilityConfig
from ..maintain import MaintenanceConfig
from ..online.merge import MergePolicy

ENGINES = ("local", "pallas", "sharded")

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def manual_merge_policy() -> MergePolicy:
    """A policy that never auto-merges: writes stay in the overlay until an
    explicit `flush()`."""
    return MergePolicy(max_fill=1.1, max_writes=1 << 62,
                       pressure_check_every=1 << 62)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@dataclass(frozen=True)
class IndexConfig:
    """Configuration for `repro_torch.api.LearnedIndex`.

    engine            : "local" (the default: f64 or f32 keys, the
                        kernel instance with the overlay fused in) and
                        "pallas" (the f32 kernel engine) run on this port;
                        "sharded" is a valid name that raises
                        NotImplementedError at build.
    dtype             : key/model dtype (numpy or torch); None picks the
                        engine default (f64 for local/sharded, f32 for
                        pallas).
    pad               : pow2-pad device tables (the reference's shapes).
    merge             : `MergePolicy` deciding when pending writes fold
                        through the host tree (Alg. 7/8).
    maintenance       : `MaintenanceConfig` switching the merge to the
                        adaptive pipeline (splice flatten, retrains,
                        re-clusters) and, on the local engine only,
                        background merges (background on "pallas" is a
                        ValueError, as in the reference).  None = full
                        flatten merges.
    overlay_cap       : initial tombstone-overlay capacity (doubles).
    sample_stride     : bulk-load sampling stride (Alg. 4, Table 13).
    bulk_kw           : extra `core.dili.bulk_load` kwargs.
    n_shards, mesh_axis, lookup_strategy : sharded engine knobs (kept for
                        the JSON round-trip).
    interpret         : accepted for the round-trip; no effect (no Pallas).
    vmem_budget_bytes : accepted for the round-trip; no effect — the CUDA
                        kernel serves every table size.
    early_exit        : batch-convergence early exit (local engine).
    max_hits          : default per-query range-window bound.
    telemetry         : per-op latency histograms + merge-pipeline spans.
    durability        : `DurabilityConfig`; must be None until the
                        durability slice lands.
    """

    engine: str = "local"
    dtype: Any = None
    pad: bool = True
    merge: MergePolicy = field(default_factory=MergePolicy)
    maintenance: MaintenanceConfig | None = None
    overlay_cap: int = 4096
    sample_stride: int = 1
    bulk_kw: tuple = ()                      # (("lam", 4.0), ...) — hashable
    n_shards: int | None = None
    mesh_axis: str = "data"
    lookup_strategy: str = "gather"
    interpret: bool | None = None
    vmem_budget_bytes: int = 12 * 1024 * 1024
    early_exit: bool = True
    max_hits: int = 128
    telemetry: bool = False
    durability: DurabilityConfig | None = None

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"expected one of {ENGINES}")
        if self.lookup_strategy not in ("gather", "a2a"):
            raise ValueError(f"unknown lookup_strategy "
                             f"{self.lookup_strategy!r}")

    @property
    def resolved_dtype(self) -> torch.dtype:
        if self.dtype is not None:
            return _TORCH_DTYPES[_dtype_name(self.dtype)]
        return torch.float32 if self.engine == "pallas" else torch.float64

    def bulk_load_kw(self) -> dict:
        return dict(self.bulk_kw, sample_stride=self.sample_stride)

    # -- (de)serialization ----------------------------------------------------

    def to_json_dict(self) -> dict:
        return dict(
            engine=self.engine,
            dtype=None if self.dtype is None else _dtype_name(self.dtype),
            pad=self.pad,
            merge=dict(max_fill=self.merge.max_fill,
                       max_writes=self.merge.max_writes,
                       pressure_lambda=self.merge.pressure_lambda,
                       pressure_check_every=self.merge.pressure_check_every,
                       pressure_min_pending=self.merge.pressure_min_pending),
            maintenance=(None if self.maintenance is None
                         else self.maintenance.to_json_dict()),
            overlay_cap=self.overlay_cap,
            sample_stride=self.sample_stride,
            bulk_kw=list(list(kv) for kv in self.bulk_kw),
            n_shards=self.n_shards,
            mesh_axis=self.mesh_axis,
            lookup_strategy=self.lookup_strategy,
            interpret=self.interpret,
            vmem_budget_bytes=self.vmem_budget_bytes,
            early_exit=self.early_exit,
            max_hits=self.max_hits,
            telemetry=self.telemetry,
            durability=(None if self.durability is None
                        else self.durability.to_json_dict()),
        )

    @classmethod
    def from_json_dict(cls, d: dict) -> "IndexConfig":
        d = dict(d)
        merge = MergePolicy(**d.pop("merge"))
        maint = d.pop("maintenance", None)
        if maint is not None:
            maint = MaintenanceConfig.from_json_dict(maint)
        dur = d.pop("durability", None)
        if dur is not None:
            dur = DurabilityConfig.from_json_dict(dur)
        dtype = d.pop("dtype")
        bulk_kw = tuple(tuple(kv) for kv in d.pop("bulk_kw", []))
        return cls(merge=merge, maintenance=maint, durability=dur,
                   bulk_kw=bulk_kw,
                   dtype=None if dtype is None else np.dtype(dtype), **d)
