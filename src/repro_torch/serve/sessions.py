"""Serving-side session table: session-id -> KV-cache slot, through a DILI.

Since the api redesign this sits on the public facade
(`repro_torch.api.LearnedIndex`): admissions are upserts, evictions are
deletes, reads are the engine's fused snapshot+overlay lookup, and the
merge policy decides when pending writes fold through the host tree
(Alg. 7/8) and a fresh epoch publishes — ONE `flatten()` per merge, never
per admit/evict (DESIGN.md sections 8-10).  The engine is a config
choice; the default local engine serves a session table fine, but a
sharded deployment only changes the `IndexConfig`.  Port of
`repro/serve/sessions.py`; the index lives on `device` (CUDA unless asked
otherwise, as every entry point of the port).
"""

from __future__ import annotations

import threading

import numpy as np

from ..api import IndexConfig, LearnedIndex, MergePolicy


class SessionTable:
    """Thread-safe from any number of frontend threads: slot allocation
    and the admit/evict check-then-act pairs serialize on one RLock, so
    two concurrent admits of the same session id cannot both pass the
    duplicate check, and a slot is never handed out twice.  Index I/O
    goes either straight to the facade (standalone) or — after
    `serve_through(frontend)` — through a `ServeClient`, so session
    traffic coalesces with everything else the batcher serves."""

    def __init__(self, n_slots: int, warm_ids=None,
                 policy: MergePolicy | None = None,
                 config: IndexConfig | None = None, device="cuda"):
        self.n_slots = n_slots
        self._lock = threading.RLock()
        self.free = list(range(n_slots))[::-1]
        warm = np.asarray(sorted(warm_ids or [1.0, 2.0]), np.float64)
        slots = np.array([self._take() for _ in warm], np.int64)
        if policy is not None and config is not None:
            raise ValueError("pass the merge policy inside `config` "
                             "(IndexConfig(merge=...)), not both")
        # small default buffer: a session table sees bursty admit/evict, so
        # merge on fill (64 pending) or 256 writes of lag
        cfg = config or IndexConfig(
            overlay_cap=64,
            merge=policy or MergePolicy(max_fill=1.0, max_writes=256))
        self.index = LearnedIndex.build(warm, slots, config=cfg,
                                        device=device)
        self._frontend = None
        self._io = self.index      # facade, or a ServeClient once served

    def serve_through(self, frontend) -> "SessionTable":
        """Route this table's index traffic through a serving front-end
        (`repro_torch.serve.ServeFrontend` over the SAME index).  After
        this, admits/evicts/lookups are batcher requests — coalesced with
        other clients, admission-controlled, journaled — and the table
        may be driven from many threads."""
        if frontend.index is not self.index:
            raise ValueError("frontend serves a different index")
        with self._lock:
            self._frontend = frontend
            self._io = frontend.client("sessions")
        return self

    def _take(self) -> int:
        if not self.free:
            raise RuntimeError("no free KV slots")
        return self.free.pop()

    @property
    def publish_count(self) -> int:
        """flatten+upload count — one per merge epoch (acceptance metric)."""
        return self.index.n_flattens

    @property
    def dili(self):
        """The host writer (stats/introspection; may lag the overlay)."""
        return self.index.host

    def admit(self, session_id: float) -> int:
        # the whole check-take-write sequence holds the lock: a racing
        # admit of the same id must see either the KeyError or the slot,
        # never a double allocation (the upsert ack is the batcher's or
        # facade's business; both return only once the write is applied)
        sid = float(session_id)
        with self._lock:
            if self._io.get(sid) is not None:
                raise KeyError(f"session {session_id} already admitted")
            slot = self._take()
            self._io.upsert(sid, slot)
        return slot

    def evict(self, session_id: float) -> None:
        sid = float(session_id)
        with self._lock:
            slot = self._io.get(sid)
            if slot is None:
                raise KeyError(session_id)
            self._io.delete(sid)
            self.free.append(int(slot))

    def flush(self):
        """Force a merge+publish (e.g. before a latency-critical window);
        when served, drains in-flight requests first."""
        if self._frontend is not None:
            return self._frontend.flush()
        return self.index.flush()

    def lookup_batch(self, session_ids) -> tuple[np.ndarray, np.ndarray]:
        # lock-free: reads need no slot-allocation consistency
        return self._io.lookup(np.asarray(session_ids, np.float64))
