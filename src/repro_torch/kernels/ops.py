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

Keys are f32 on the `pallas` path; that snapshot must have been built
under `placement_dtype(np.float32)` so construction and kernel arithmetic
agree (see core/dili.py).  `build_f32_index` does exactly that.

The local engine's tables (`pack_tables(..., dtype=torch.float64)`) have
the same fields at twice the width: `node_rec` int64 [n_nodes, 4] =
(a bits, b bits, base and fo as the low and high int32 halves of one word,
padding), 32 bytes a node with fo signed as above; `slot_rec` int64
[n_slots, 2] = (key bits, val), with the quiet NaN `EMPTY_KEY_BITS_F64`
for an empty slot, and for a child the NaN `CHILD_KEY_HI_F64 << 32 | fo`
(the child's signed fo) beside `id | base << 32` (the child's node id
and base), so that the walk reads a child's base and fo with the slot
that names it; `key` f64.  Its lookup, `search_with_overlay`, also resolves the
pending-write overlay in the same launch.  At dtype=float32 the local
engine keeps int64 payloads (`pack_tables(..., dtype=torch.float32,
val_dtype=torch.int64)`): `node_rec` is the f32 one, `slot_rec` int64
[n_slots, 2] = (f32 key bits zero-extended to a word, val), 16 bytes a
slot, with the f32 sentinels; `key` f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dili import bulk_load, placement_dtype
from ..core.flat import TAG_CHILD, TAG_EMPTY, TAG_PAIR, FlatDILI
from ..device import resolve_device
from .dili_search import dili_search as dili_search_kernel
from .dili_search import dili_search_f32_i64, dili_search_f64
from .ref import (CHILD_KEY_BITS, CHILD_KEY_HI_F64, EMPTY_KEY_BITS,
                  EMPTY_KEY_BITS_F64)


def build_f32_index(keys: np.ndarray, vals: np.ndarray | None = None, **kw):
    """Bulk-load a DILI whose placement arithmetic is exactly float32."""
    keys32 = np.unique(np.asarray(keys, np.float64).astype(np.float32))
    if vals is None:
        vals = np.arange(len(keys32), dtype=np.int64)
    with placement_dtype(np.float32):
        d = bulk_load(keys32.astype(np.float64), vals, **kw)
    return d, keys32


_KEY_NP = {torch.float32: np.float32, torch.float64: np.float64}


_VAL_NP = {torch.int32: np.int32, torch.int64: np.int64}


def pack_tables(cols: dict, device="cuda", dtype=torch.float32,
                val_dtype: torch.dtype | None = None) -> dict:
    """Kernel tables from the column tables `a, b, base, fo, dense, tag,
    key, val, root, max_depth` (numpy arrays or anything `np.asarray`
    takes, e.g. the JAX package's `kernel_arrays`), on CUDA unless `device`
    says otherwise.  `dtype` is the key type and `val_dtype` the payload
    type (by default int32 at float32 and int64 at float64): at
    float32/int32, models and keys are f32 and payloads int32, as the
    reference's Pallas path casts them; at float64/int64 (the local
    engine), the records are twice as wide and the sentinels 64-bit NaNs;
    at float32/int64 (the local engine at f32), the node records are the
    f32 ones and a slot record is 16 bytes (see the module docstring)."""
    device = resolve_device(device)
    if val_dtype is None:
        val_dtype = torch.int64 if dtype == torch.float64 else torch.int32
    if (dtype, val_dtype) not in ((torch.float32, torch.int32),
                                  (torch.float64, torch.int64),
                                  (torch.float32, torch.int64)):
        raise TypeError(f"key and payload dtypes must be float32/int32, "
                        f"float64/int64 or float32/int64, got {dtype}/"
                        f"{val_dtype}")
    kdt = _KEY_NP[dtype]
    wide = kdt is np.float64
    bits, empty = ((np.int64, EMPTY_KEY_BITS_F64) if wide else
                   (np.int32, EMPTY_KEY_BITS))
    a = np.asarray(cols["a"]).astype(kdt)
    b = np.asarray(cols["b"]).astype(kdt)
    base = np.asarray(cols["base"]).astype(np.int32)
    fo = np.asarray(cols["fo"]).astype(np.int32)
    dense = np.asarray(cols["dense"]) > 0
    tag = np.asarray(cols["tag"]).astype(np.int32)
    key = np.asarray(cols["key"]).astype(kdt)
    val = np.asarray(cols["val"]).astype(bits)
    root = int(np.asarray(cols["root"]).reshape(-1)[0])
    if len(fo) and fo.min() < 1:
        raise ValueError("every node needs a fanout >= 1 (the dense flag "
                         "is the sign of fo)")
    if not np.isin(tag, (TAG_EMPTY, TAG_PAIR, TAG_CHILD)).all():
        raise ValueError("slot tags must be EMPTY, PAIR or CHILD")
    fo_signed = np.where(dense, -fo, fo)
    if wide:
        # 32 bytes a node: a, b, then base and fo as the two int32 halves
        # of one word, then a word of padding
        words = np.zeros((len(fo), 8), np.int32)
        words[:, 0:2] = a.view(np.int32).reshape(-1, 2)
        words[:, 2:4] = b.view(np.int32).reshape(-1, 2)
        words[:, 4] = base
        words[:, 5] = fo_signed
        node_rec = words.view(np.int64)
    else:
        node_rec = np.stack([a.view(np.int32), b.view(np.int32), base,
                             fo_signed], axis=1)
    kbits = key.view(bits).copy()
    kbits[(tag == TAG_EMPTY) | ((tag == TAG_PAIR) & np.isnan(key))] = empty
    is_child = tag == TAG_CHILD
    if wide:
        # the child's signed fo in the sentinel's low half, its id and
        # base in the val word's halves (ref.CHILD_KEY_HI_F64)
        cid = val[is_child]
        kbits[is_child] = ((CHILD_KEY_HI_F64 << 32)
                           | (fo_signed[cid].astype(np.int64) & 0xFFFFFFFF))
        val = val.copy()
        val[is_child] = cid | (base[cid].astype(np.int64) << 32)
    else:
        kbits[is_child] = CHILD_KEY_BITS
    if not wide and val_dtype == torch.int64:
        # {f32 key bits, 4 bytes of padding, i64 val}: the key bits are
        # the word's low half (little-endian), zero-extended
        val = np.asarray(cols["val"]).astype(np.int64)
        kbits = kbits.view(np.uint32).astype(np.int64)
    slot_rec = np.stack([kbits, val], axis=1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return dict(node_rec=t(node_rec), slot_rec=t(slot_rec), key=t(key),
                root=root, max_depth=int(np.asarray(cols["max_depth"])))


def kernel_arrays(flat: FlatDILI, device="cuda", dtype=torch.float32,
                  val_dtype: torch.dtype | None = None) -> dict:
    """The kernel tables of a flattened snapshot (`pack_tables`) with keys
    of `dtype` and payloads of `val_dtype`, on CUDA unless `device` says
    otherwise."""
    return pack_tables(dict(a=flat.a, b=flat.b, base=flat.base, fo=flat.fo,
                            dense=flat.dense, tag=flat.tag, key=flat.key,
                            val=flat.val, root=flat.root,
                            max_depth=flat.max_depth), device=device,
                       dtype=dtype, val_dtype=val_dtype)


def table_bytes(arrs: dict) -> int:
    """Device bytes of the kernel tables as uploaded."""
    return sum(v.numel() * v.element_size()
               for v in arrs.values() if isinstance(v, torch.Tensor))


def column_bytes(arrs: dict) -> int:
    """Bytes of the same tables in the reference's column layout (the
    `table_bytes` that `stats()` reports on the `pallas` engine): a node
    is a, b of the key's width and base, fo, dense of 4 bytes; a slot a
    4-byte tag, a key of the key's width and a val of the payload's
    (int32 or int64); and a 4-byte root."""
    w = arrs["key"].element_size()
    vw = arrs["slot_rec"].element_size()
    return (arrs["node_rec"].shape[0] * (2 * w + 12)
            + arrs["key"].shape[0] * (4 + w + vw) + 4)


def dili_search(arrs: dict, queries: torch.Tensor,
                stats: dict | None = None):
    """Batched lookup through the f32 kernel: (vals i32, found bool) for
    the f32 `queries`.  With `stats`, adds this call's lane count to
    `stats["lanes"]`."""
    out, found = dili_search_kernel(
        arrs["node_rec"], arrs["slot_rec"], arrs["key"], queries,
        root=arrs["root"], max_depth=arrs["max_depth"])
    if stats is not None:
        stats["lanes"] = stats.get("lanes", 0) + queries.shape[0]
    return out, found


def search_with_overlay(arrs: dict, ov: dict, queries: torch.Tensor, *,
                        early_exit: bool = True,
                        stats: dict | None = None):
    """The local engine's lookup: (vals i64, found bool) for the
    `queries` over the kernel tables with i64 payloads, with the overlay
    mirror `ov` resolved over the snapshot's result — the reference's
    `core/search.py::search_with_overlay`, in one launch of the f64/i64
    instance (f64 tables) or of the f32/i64 instance (f32 tables) on the
    card.  With `stats`, adds this call's lane count to
    `stats["lanes"]`."""
    fn = (dili_search_f64 if arrs["key"].dtype == torch.float64
          else dili_search_f32_i64)
    out, found = fn(
        arrs["node_rec"], arrs["slot_rec"], arrs["key"], queries,
        root=arrs["root"], max_depth=arrs["max_depth"], ov=ov,
        early_exit=early_exit)
    if stats is not None:
        stats["lanes"] = stats.get("lanes", 0) + queries.shape[0]
    return out, found
