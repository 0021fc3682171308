"""The paper's own workload config: index bulk-load + query serving
(dataset sizes/distributions from section 7.1, scaled by --n-keys)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class IndexConfig:
    name: str = "dili-paper"
    n_keys: int = 2_000_000          # paper: 200M (FB/WikiTS/Logn), 800M (OSM/Books)
    distributions: tuple = ("fb", "wikits", "osm", "books", "logn")
    query_batch: int = 8192
    eta: float = 2.0                 # leaf enlarging ratio (Alg. 5)
    lam: float = 2.0                 # adjustment threshold (Alg. 7)
    rho: float = 0.2                 # level decay (Eq. 5)
    omega: int = 4096                # max average fanout (Alg. 3)


CONFIG = IndexConfig()
