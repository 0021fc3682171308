"""Plain PyTorch version of the DILI lookup kernel (port of
`repro/kernels/ref.py`, extended by the dense-leaf probe and, for the
instances with i64 payloads, the overlay resolve).

The same function as `csrc/dili_search.cu` on the same tables: decode the
packed records (`ops.pack_tables`) back into columns and run
`core/search.py::search_batch`, the Alg. 6 walk with its Alg. 1 dense
probe, at the given `max_depth`; the f64/i64 and f32/i64 instances then
run `core/search.py::resolve_overlay` over the overlay mirror, which is
the reference's `core/search.py::search_with_overlay`.  Mul-then-add slot
prediction with two roundings, XLA's saturating float->int32 cast.  The
CPU tests hold it against the JAX package (`kernels/ops.py::dili_search`,
the Pallas kernel plus its XLA recheck, at f32; `search_with_overlay` at
f64 and at f32); on the card the CUDA kernel is held against it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import search as S
from ..core.flat import TAG_CHILD, TAG_EMPTY, TAG_PAIR

# slot record key of a CHILD slot (a NaN) and of an EMPTY slot (the quiet
# NaN), per key width.  At f64 a CHILD slot's key word is a NaN whose high
# half is CHILD_KEY_HI_F64 and whose low half is the child's signed fanout
# (fo, negated for a dense leaf), and its val word holds the child's id in
# its low half and the child's base in its high half.
CHILD_KEY_BITS = 0x7FC00002
EMPTY_KEY_BITS = 0x7FC00000
CHILD_KEY_HI_F64 = 0x7FF80002
EMPTY_KEY_BITS_F64 = 0x7FF8000000000000
# the overlay filter's multiplicative hash: bit h(k) of an m-bit filter is
# the top log2(m) bits of (k's bits, -0 made +0) * FILTER_HASH mod 2^64
FILTER_HASH = 0x9E3779B97F4A7C15


def unpack_tables(node_rec, slot_rec, key) -> dict:
    """The column tables (`a, b, base, fo, dense, tag, key, val`) that the
    records hold, as `core.search` reads them.  f32 records are int32
    (node [n, 4] = a, b, base, fo; slot [n, 2] = key bits, val); f64
    records are int64 (node [n, 4] = a, b, then base and fo as two int32
    halves of one word, then padding; slot [n, 2] = key bits, val, where
    a CHILD slot's words also carry the child's fo and base: see
    CHILD_KEY_HI_F64).  With
    f32 keys and i64 payloads the node records are the f32 ones and the
    slot records int64 [n, 2] = (key bits in the low half, val); that
    instance predicts with one rounding, so its columns carry
    `fused=True` (see `core/search.py`)."""
    val = slot_rec[:, 1]
    if node_rec.dtype == torch.int64:
        words = node_rec.view(torch.int32)          # [n, 8]
        fdt = torch.float64
        base, fo_signed = words[:, 4], words[:, 5]
        kbits = slot_rec[:, 0]
        child = (kbits >> 32) == CHILD_KEY_HI_F64
        val = torch.where(child, val & 0xFFFFFFFF, val)
    else:
        fdt = torch.float32
        base, fo_signed = node_rec[:, 2], node_rec[:, 3]
        if slot_rec.dtype != node_rec.dtype:   # f32 key bits, int64 word
            kbits = slot_rec.view(torch.int32)[:, 0]
        else:
            kbits = slot_rec[:, 0]
        child = kbits == CHILD_KEY_BITS
    tag = torch.where(child, TAG_CHILD,
                      torch.where(torch.isnan(kbits.view(fdt)), TAG_EMPTY,
                                  TAG_PAIR)).to(torch.int32)
    return dict(a=node_rec[:, 0].view(fdt), b=node_rec[:, 1].view(fdt),
                base=base, fo=fo_signed.abs(),
                dense=(fo_signed < 0).to(torch.int32), tag=tag, key=key,
                val=val, fused=slot_rec.dtype != node_rec.dtype)


def dili_search_ref(node_rec, slot_rec, key, queries, root: int,
                    max_depth: int, early_exit: bool = False):
    """Returns (vals, found) per query; vals is -1 where not found."""
    idx = unpack_tables(node_rec, slot_rec, key)
    idx.update(root=torch.tensor(int(root), dtype=torch.int32,
                                 device=queries.device), has_dense=True)
    return S.search_batch(idx, queries, max_depth=int(max_depth),
                          early_exit=early_exit)


def search_with_overlay_ref(node_rec, slot_rec, key, queries, root: int,
                            max_depth: int, ov: dict | None = None,
                            early_exit: bool = False):
    """`dili_search_ref`, then the overlay mirror `ov` (keys, vals, tomb)
    resolved over its result; without `ov`, the snapshot's result."""
    v, f = dili_search_ref(node_rec, slot_rec, key, queries, root,
                           max_depth, early_exit=early_exit)
    if ov is None:
        return v, f
    return S.resolve_overlay(ov, queries, v, f)


def filter_hash(keys, log2m: int) -> np.ndarray:
    """h(k) of each f32 or f64 key (numpy): the top `log2m` bits of
    (k's bits, -0 made +0) * FILTER_HASH mod 2^64, as the kernel's
    `may_hold` computes it."""
    k = np.asarray(keys)
    k = k + k.dtype.type(0)
    bits = k.view(np.uint64 if k.dtype == np.float64 else np.uint32)
    return (bits.astype(np.uint64) * np.uint64(FILTER_HASH)) >> np.uint64(
        64 - log2m)


def filter_may_hold(filt, q) -> np.ndarray:
    """The kernel's filter test per query, in numpy: whether bit h(q) of
    the overlay filter `filt` (int32 words, `dili_search.overlay_filter`)
    is set, for queries of the filter's key dtype.  Clear only where no
    key equals q."""
    words = np.asarray(filt).view(np.uint32)
    h = filter_hash(q, (32 * len(words)).bit_length() - 1)
    return ((words[h >> 5] >> (h & 31).astype(np.uint32)) & 1).astype(bool)
