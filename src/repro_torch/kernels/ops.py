"""Public wrapper of the DILI lookup kernel (port of `repro/kernels/ops.py`).

The reference dispatches to its Pallas kernel only while the tables fit a
12 MiB VMEM budget and sends bigger tables to XLA.  Hopper has no VMEM and
the CUDA kernel reads device memory at any table size, so here the kernel
serves every size: `IndexConfig.vmem_budget_bytes` and `interpret` stay
accepted config keys with no effect on this path.  What is kept exactly:

  * +inf padding of the batch to a multiple of `BLOCK_Q` (pad lanes miss);
  * the recheck: when any lane comes back flagged `needs_fallback` (dense
    leaf, or out of depth), `core.search.search_batch` re-runs the WHOLE
    padded batch with its dense probe and its result replaces the flagged
    lanes — the reference's contract, so results match it lane for lane.

Keys are f32 on this path; the snapshot must have been built under
`placement_dtype(np.float32)` so construction and kernel arithmetic agree
(see core/dili.py).  `build_f32_index` does exactly that.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import search as core_search
from ..core.dili import bulk_load, placement_dtype
from ..core.flat import FlatDILI
from ..device import resolve_device
from .dili_search import BLOCK_Q, dili_search as dili_search_kernel


def build_f32_index(keys: np.ndarray, vals: np.ndarray | None = None, **kw):
    """Bulk-load a DILI whose placement arithmetic is exactly float32."""
    keys32 = np.unique(np.asarray(keys, np.float64).astype(np.float32))
    if vals is None:
        vals = np.arange(len(keys32), dtype=np.int64)
    with placement_dtype(np.float32):
        d = bulk_load(keys32.astype(np.float64), vals, **kw)
    return d, keys32


def kernel_arrays(flat: FlatDILI, device="cuda") -> dict:
    """Device tables in kernel dtypes (f32 keys/models, i32 the rest), on
    CUDA unless `device` says otherwise."""
    device = resolve_device(device)

    def t(x, np_dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(np_dtype))).to(device)

    return dict(
        a=t(flat.a, np.float32),
        b=t(flat.b, np.float32),
        base=t(flat.base, np.int32),
        fo=t(flat.fo, np.int32),
        dense=t(flat.dense, np.int32),
        tag=t(flat.tag, np.int32),
        key=t(flat.key, np.float32),
        val=t(flat.val, np.int32),
        root=t([flat.root], np.int32),
        max_depth=int(flat.max_depth),
    )


def table_bytes(arrs: dict) -> int:
    return sum(v.numel() * v.element_size()
               for v in arrs.values() if isinstance(v, torch.Tensor))


def dili_search(arrs: dict, queries: torch.Tensor,
                stats: dict | None = None):
    """Batched lookup through the kernel, with the flagged-lane recheck.

    Returns (vals i32, found bool) for the caller's `nq` queries.  With
    `stats`, adds this call's padded lane count to `stats["lanes"]` and
    its flagged lanes to `stats["flagged"]`."""
    max_depth = int(arrs["max_depth"])
    nq = queries.shape[0]
    pad = (-nq) % BLOCK_Q
    qp = torch.cat([queries, torch.full((pad,), torch.inf,
                                        dtype=queries.dtype,
                                        device=queries.device)])
    out, found, fb = dili_search_kernel(
        arrs["a"], arrs["b"], arrs["base"], arrs["fo"], arrs["dense"],
        arrs["tag"], arrs["key"], arrs["val"], arrs["root"], qp,
        max_depth=max_depth)
    n_flagged = int(fb.sum())
    if stats is not None:
        stats["lanes"] = stats.get("lanes", 0) + qp.shape[0]
        stats["flagged"] = stats.get("flagged", 0) + n_flagged
    if n_flagged:
        # dense leaves / overflow: recheck the batch with the torch search
        # (its dense probe handles the dense exit, so the snapshot's exact
        # depth is the right trip count here too)
        v2, f2 = core_search.search_batch(_as_search_idx(arrs), qp,
                                          max_depth=max_depth)
        out = torch.where(fb, v2, out)
        found = torch.where(fb, f2, found)
    return out[:nq], found[:nq]


def _as_search_idx(arrs: dict) -> dict:
    return dict(a=arrs["a"], b=arrs["b"], base=arrs["base"], fo=arrs["fo"],
                dense=arrs["dense"].to(torch.int8),
                tag=arrs["tag"].to(torch.int8), key=arrs["key"],
                val=arrs["val"], root=arrs["root"][0],
                max_depth=arrs["max_depth"])
