"""`DeviceSnapshot`: the typed device snapshot (port of
`repro/api/snapshot.py`).

`arrays` holds every device table as a tensor (`a/b/base/fo/dense/tag/
key/val`, the sorted pair table, `root`, and the packed row mirrors when
the dtype supports them).  `max_depth` / `has_dense` / `dtype` are host
statics.  `core.search` accepts a `DeviceSnapshot` anywhere it accepts the
raw dict (duck-typed via `as_dict()`).

`from_numpy_tables` carries state across packages: it turns the JAX
package's device tables (`np.asarray` of `kernel_arrays` /
`device_arrays`) into this package's tensors, so both can be fed
identical tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core import search as S
from ..core.flat import FlatDILI
from ..device import resolve_device

_STATICS = {"max_depth": int, "has_dense": bool}


def from_numpy_tables(tables: dict, device="cuda") -> dict:
    """{name: numpy array} -> {name: tensor on `device`, CUDA unless asked
    otherwise}, dtypes kept.  `max_depth` and `has_dense` become host
    statics (int, bool)."""
    device = resolve_device(device)
    out = {}
    for name, x in tables.items():
        if name in _STATICS:
            out[name] = _STATICS[name](np.asarray(x))
        else:
            out[name] = torch.from_numpy(
                np.array(x, copy=True, order="C")).to(device)
    return out


@dataclass
class DeviceSnapshot:
    """Immutable device snapshot of one flattened DILI."""

    arrays: dict
    max_depth: int
    has_dense: bool
    dtype: Any = torch.float64

    @classmethod
    def from_flat(cls, flat: FlatDILI, dtype=torch.float64, pad: bool = True,
                  device="cuda") -> "DeviceSnapshot":
        """Upload a host `FlatDILI` (pow2-padded by default) to `device`,
        CUDA unless asked otherwise."""
        d = S.device_arrays(flat, dtype, pad=pad, device=device)
        has_dense = bool(d.pop("has_dense"))
        max_depth = int(d.pop("max_depth"))
        return cls(arrays=d, max_depth=max_depth, has_dense=has_dense,
                   dtype=dtype)

    def as_dict(self) -> dict:
        """The `core.search` dict view (arrays + embedded statics)."""
        return dict(self.arrays, max_depth=self.max_depth,
                    has_dense=self.has_dense)

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.arrays.values())

    def same_shapes(self, other: "DeviceSnapshot | None") -> bool:
        """True when every table of `other` has this snapshot's shape."""
        if other is None:
            return False
        return (set(self.arrays) == set(other.arrays)
                and all(self.arrays[k].shape == other.arrays[k].shape
                        for k in self.arrays))
