"""Plain PyTorch version of the DILI lookup kernel (port of
`repro/kernels/ref.py`, extended by the dense-leaf probe).

The same function as `csrc/dili_search.cu` on the same tables: decode the
packed records (`ops.pack_tables`) back into columns and run
`core/search.py::search_batch`, the Alg. 6 walk with its Alg. 1 dense
probe, at the given `max_depth`.  f32 keys and models, mul-then-add slot
prediction with two roundings, XLA's saturating float->int32 cast.  The
CPU tests hold it against the JAX package's `kernels/ops.py::dili_search`
(the Pallas kernel plus its XLA recheck); on the card the CUDA kernel is
held against it.
"""

from __future__ import annotations

import torch

from ..core import search as S
from ..core.flat import TAG_CHILD, TAG_EMPTY, TAG_PAIR

CHILD_KEY_BITS = 0x7FC00002      # slot record key of a CHILD slot (a NaN)
EMPTY_KEY_BITS = 0x7FC00000      # ... of an EMPTY slot (the quiet NaN)


def unpack_tables(node_rec, slot_rec, key) -> dict:
    """The column tables (`a, b, base, fo, dense, tag, key, val`) that the
    records hold, as `core.search` reads them."""
    kbits = slot_rec[:, 0]
    fo_signed = node_rec[:, 3]
    pair = torch.full_like(kbits, TAG_PAIR)
    tag = torch.where(kbits == CHILD_KEY_BITS, torch.full_like(kbits,
                                                               TAG_CHILD),
                      torch.where(torch.isnan(kbits.view(torch.float32)),
                                  torch.full_like(kbits, TAG_EMPTY), pair))
    return dict(a=node_rec[:, 0].view(torch.float32),
                b=node_rec[:, 1].view(torch.float32),
                base=node_rec[:, 2], fo=fo_signed.abs(),
                dense=(fo_signed < 0).to(torch.int32), tag=tag, key=key,
                val=slot_rec[:, 1])


def dili_search_ref(node_rec, slot_rec, key, queries, root: int,
                    max_depth: int):
    """Returns (vals i32, found bool) per query; vals is -1 where not
    found."""
    idx = unpack_tables(node_rec, slot_rec, key)
    idx.update(root=torch.tensor(int(root), dtype=torch.int32,
                                 device=queries.device), has_dense=True)
    return S.search_batch(idx, queries, max_depth=int(max_depth))
