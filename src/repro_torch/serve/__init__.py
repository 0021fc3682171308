"""Concurrent serving front-end over `repro_torch.api.LearnedIndex` (port
of `repro/serve/`; DESIGN.md section 15): request batching/coalescing,
admission control, adaptive batch sizing, open-loop load generation, and
the LLM-serving session table.  Numpy and threads over the facade, copied
from the reference; only `SessionTable` takes a `device`.
"""

from .batcher import (AdaptiveBatchSizer, RejectedError, Request,
                      RequestBatcher, SERVE_OPS, ServeConfig, coalesce,
                      compatible, pow2_bucket)
from .frontend import ServeClient, ServeFrontend
from .loadgen import LoadReport, open_loop, saturation_search
from .sessions import SessionTable

__all__ = [
    "AdaptiveBatchSizer", "RejectedError", "Request", "RequestBatcher",
    "SERVE_OPS", "ServeConfig", "coalesce", "compatible", "pow2_bucket",
    "ServeClient", "ServeFrontend",
    "LoadReport", "open_loop", "saturation_search",
    "SessionTable",
]
