"""`repro_torch`: the PyTorch/CUDA port of the DILI system.

The JAX package `repro` stays the reference; this package imports neither
`jax` nor anything of `repro`, and keeps its own copies of the numpy host
code (bulk load, flatten).  Its layout mirrors the reference's, so each
counterpart sits at the same path:

    core/     host tree (copied) + batched search as torch ops
    kernels/  the hand-written CUDA lookup kernel (f32 and f64 instances),
              its plain version, ops
    online/   tombstone overlay, epoch snapshot store, merge policy,
              OnlineIndex
    obs/      metrics, spans, recompile watchdog
    api/      IndexConfig, DeviceSnapshot, the local and kernel engines,
              LearnedIndex

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from .api import IndexConfig, LearnedIndex

__all__ = ["IndexConfig", "LearnedIndex"]
