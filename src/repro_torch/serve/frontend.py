"""`ServeFrontend` + `ServeClient`: the serving surface over one
`repro_torch.api.LearnedIndex` (DESIGN.md section 15).

The frontend owns a `RequestBatcher` (one worker thread, bounded
admission queue) and hands out lightweight per-client handles.  A client
handle is the unit of the ordering contract:

  * ops submitted through ONE client are enqueued in program order (the
    handle serializes its own submits), so the batcher's FIFO total
    order contains each client's program order as a subsequence;
  * a synchronous write returns only after the facade call returned —
    i.e. after the WAL append (when durability is armed) and the overlay
    apply — so the client's next read observes it: read-your-
    acknowledged-writes;
  * no ordering is promised BETWEEN clients beyond the single
    serialization the journal records.

Usage:

    with ServeFrontend(index) as fe:
        c = fe.client("tenant-a")
        c.upsert(keys, vals)            # acknowledged on return
        vals, found = c.lookup(keys)    # sees the upsert
    # fe.journal_batches() -> the exact committed interleaving,
    # replayable through WorkloadRunner for the oracle check
"""

from __future__ import annotations

import threading

from .batcher import (RejectedError, Request, RequestBatcher,  # noqa: F401
                      ServeConfig)

#: default client-blocking timeout — generous; a healthy batcher answers
#: in milliseconds, so hitting this means the serving loop is wedged
WAIT_S = 120.0


class ServeClient:
    """One logical client stream.  Sync methods block until the op is
    served (acknowledged); `*_async` return the `Request` future for
    open-loop load generation.  A handle may be driven by one thread at
    a time (the load generator gives each client thread its own)."""

    __slots__ = ("frontend", "client_id", "_lock")

    def __init__(self, frontend: "ServeFrontend", client_id: str):
        self.frontend = frontend
        self.client_id = client_id
        # serializes submits from this handle so the per-client program
        # order is well-defined even if a handle is shared across threads
        self._lock = threading.Lock()

    # -- async (open-loop) ----------------------------------------------------

    def submit(self, op: str, *, t_arrival: float | None = None,
               **payload) -> Request:
        # constructing the Request here is also where its causal trace id
        # is minted (Request.__init__) — one id per client submit, carried
        # through coalescing so `LearnedIndex.dump_trace` can draw the
        # request -> batch -> facade -> WAL -> merge chain
        req = Request(op, client_id=self.client_id,
                      max_hits=self.frontend.cfg.max_hits,
                      t_arrival=t_arrival, **payload)
        with self._lock:
            return self.frontend.batcher.submit(req)

    def lookup_async(self, keys, *, t_arrival=None) -> Request:
        return self.submit("lookup", keys=keys, t_arrival=t_arrival)

    def range_async(self, lo, hi, *, t_arrival=None) -> Request:
        return self.submit("range", lo=lo, hi=hi, t_arrival=t_arrival)

    def upsert_async(self, keys, vals, *, t_arrival=None) -> Request:
        return self.submit("upsert", keys=keys, vals=vals,
                           t_arrival=t_arrival)

    def delete_async(self, keys, *, t_arrival=None) -> Request:
        return self.submit("delete", keys=keys, t_arrival=t_arrival)

    # -- sync (acknowledged on return) ----------------------------------------

    def lookup(self, keys):
        return self.lookup_async(keys).wait(WAIT_S)

    def range(self, lo, hi):
        return self.range_async(lo, hi).wait(WAIT_S)

    def upsert(self, keys, vals) -> None:
        self.upsert_async(keys, vals).wait(WAIT_S)

    def delete(self, keys) -> None:
        self.delete_async(keys).wait(WAIT_S)

    def get(self, key) -> int | None:
        """Point read through the batched lookup path (facade-`get`
        shaped: value or None)."""
        vals, found = self.lookup([key])
        return int(vals[0]) if bool(found[0]) else None


class ServeFrontend:
    """Owns the batcher; hands out client handles; exports serve stats.

    The frontend is the index's ONLY caller while serving — clients go
    through `client()`, never touch the facade — which is how the
    engines' single-writer threading contract holds under N client
    threads."""

    def __init__(self, index, config: ServeConfig | None = None,
                 journal: bool = True):
        self.index = index
        self.cfg = config or ServeConfig()
        self.batcher = RequestBatcher(index, self.cfg, journal=journal)
        self._clients: dict[str, ServeClient] = {}
        self._clients_lock = threading.Lock()

    def client(self, client_id: str) -> ServeClient:
        with self._clients_lock:
            c = self._clients.get(client_id)
            if c is None:
                c = self._clients[client_id] = ServeClient(self, client_id)
            return c

    def journal_batches(self):
        """The committed facade batches in execution order (`OpBatch`
        list) — the deterministic interleaving.  Replaying it through
        `WorkloadRunner` on a fresh index with the same initial content
        must reproduce this run's final `items()` bit-exactly."""
        j = self.batcher.journal
        if j is None:
            raise RuntimeError("frontend built with journal=False")
        return list(j)

    def drain(self, timeout: float = WAIT_S) -> None:
        self.batcher.drain(timeout)

    def flush(self) -> dict:
        """Drain in-flight requests, then fold+republish the index (the
        sync/durability barrier).  Call between load legs, not during."""
        self.drain()
        return self.index.flush()

    def stats(self) -> dict:
        return self.batcher.stats()

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
