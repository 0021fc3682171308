"""Public wrapper of the DILI lookup kernel (port of `repro/kernels/ops.py`).

The reference dispatches to its Pallas kernel only while the tables fit a
12 MiB VMEM budget, sends bigger tables to XLA, and re-runs the batch
through XLA's `search_batch` whenever the kernel flags a lane (dense leaf,
or out of depth).  Hopper has no VMEM, and the CUDA kernel reads device
memory at any table size and runs the dense-leaf probe itself, so here one
launch gives every lane's final (val, found): no budget, no flags, no
recheck, and no padding of the batch (the Pallas tile's granule; pad lanes
missed, so no real lane changes).  `IndexConfig.vmem_budget_bytes` and
`interpret` stay accepted config keys with no effect on this path.  The
result is, lane for lane, the reference's `dili_search`.

The tables (`pack_tables`): row-packed records, so that the kernel reads
one node or one slot with one vector load, beside the f32 `key` column
that the dense probe reads:

  * `node_rec` int32 [n_nodes, 4] = (a bits, b bits, base, fo), with fo
    negated for a dense leaf;
  * `slot_rec` int32 [n_slots, 2] = (key bits, val), where a slot that is
    not a PAIR holds a NaN in place of its key: `CHILD_KEY_BITS` for a
    child, the quiet NaN `EMPTY_KEY_BITS` for an empty slot.  A PAIR whose
    key is NaN can never be hit, and is stored as an empty slot;
  * `key` f32 [n_slots], the key column as flattened;
  * host statics `root` (node id) and `max_depth`.

Keys are f32 on this path; the snapshot must have been built under
`placement_dtype(np.float32)` so construction and kernel arithmetic agree
(see core/dili.py).  `build_f32_index` does exactly that.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dili import bulk_load, placement_dtype
from ..core.flat import TAG_CHILD, TAG_EMPTY, TAG_PAIR, FlatDILI
from ..device import resolve_device
from .dili_search import dili_search as dili_search_kernel
from .ref import CHILD_KEY_BITS, EMPTY_KEY_BITS


def build_f32_index(keys: np.ndarray, vals: np.ndarray | None = None, **kw):
    """Bulk-load a DILI whose placement arithmetic is exactly float32."""
    keys32 = np.unique(np.asarray(keys, np.float64).astype(np.float32))
    if vals is None:
        vals = np.arange(len(keys32), dtype=np.int64)
    with placement_dtype(np.float32):
        d = bulk_load(keys32.astype(np.float64), vals, **kw)
    return d, keys32


def pack_tables(cols: dict, device="cuda") -> dict:
    """Kernel tables from the column tables `a, b, base, fo, dense, tag,
    key, val, root, max_depth` (numpy arrays or anything `np.asarray`
    takes, e.g. the JAX package's `kernel_arrays`), on CUDA unless `device`
    says otherwise.  Values are cast as the reference casts them: f32
    models and keys, int32 the rest."""
    device = resolve_device(device)
    a = np.asarray(cols["a"]).astype(np.float32)
    b = np.asarray(cols["b"]).astype(np.float32)
    base = np.asarray(cols["base"]).astype(np.int32)
    fo = np.asarray(cols["fo"]).astype(np.int32)
    dense = np.asarray(cols["dense"]) > 0
    tag = np.asarray(cols["tag"]).astype(np.int32)
    key = np.asarray(cols["key"]).astype(np.float32)
    val = np.asarray(cols["val"]).astype(np.int32)
    root = int(np.asarray(cols["root"]).reshape(-1)[0])
    if len(fo) and fo.min() < 1:
        raise ValueError("every node needs a fanout >= 1 (the dense flag "
                         "is the sign of fo)")
    if not np.isin(tag, (TAG_EMPTY, TAG_PAIR, TAG_CHILD)).all():
        raise ValueError("slot tags must be EMPTY, PAIR or CHILD")
    node_rec = np.stack([a.view(np.int32), b.view(np.int32), base,
                         np.where(dense, -fo, fo)], axis=1)
    kbits = key.view(np.int32).copy()
    kbits[(tag == TAG_EMPTY) | ((tag == TAG_PAIR) & np.isnan(key))] = (
        EMPTY_KEY_BITS)
    kbits[tag == TAG_CHILD] = CHILD_KEY_BITS
    slot_rec = np.stack([kbits, val], axis=1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return dict(node_rec=t(node_rec), slot_rec=t(slot_rec), key=t(key),
                root=root, max_depth=int(np.asarray(cols["max_depth"])))


def kernel_arrays(flat: FlatDILI, device="cuda") -> dict:
    """The kernel tables of a flattened snapshot (`pack_tables`), on CUDA
    unless `device` says otherwise."""
    return pack_tables(dict(a=flat.a, b=flat.b, base=flat.base, fo=flat.fo,
                            dense=flat.dense, tag=flat.tag, key=flat.key,
                            val=flat.val, root=flat.root,
                            max_depth=flat.max_depth), device=device)


def table_bytes(arrs: dict) -> int:
    """Device bytes of the kernel tables as uploaded."""
    return sum(v.numel() * v.element_size()
               for v in arrs.values() if isinstance(v, torch.Tensor))


def column_bytes(arrs: dict) -> int:
    """Bytes of the same tables in the reference's column layout, one
    4-byte word per field (five a node, three a slot, and the root): the
    `table_bytes` that `stats()` reports on every engine."""
    return 4 * (5 * arrs["node_rec"].shape[0] + 3 * arrs["key"].shape[0] + 1)


def dili_search(arrs: dict, queries: torch.Tensor,
                stats: dict | None = None):
    """Batched lookup through the kernel: (vals i32, found bool) for the
    f32 `queries`.  With `stats`, adds this call's lane count to
    `stats["lanes"]`."""
    out, found = dili_search_kernel(
        arrs["node_rec"], arrs["slot_rec"], arrs["key"], queries,
        root=arrs["root"], max_depth=arrs["max_depth"])
    if stats is not None:
        stats["lanes"] = stats.get("lanes", 0) + queries.shape[0]
    return out, found
