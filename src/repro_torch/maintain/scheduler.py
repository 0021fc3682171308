"""`MaintenanceScheduler`: one daemon worker draining maintenance tasks.

The serving thread never blocks on a publish: merge triggers enqueue a
task and return; the worker folds, retrains, flattens, and publishes
against the double-buffered `SnapshotStore` while reads keep serving the
previous epoch fused with the pending overlays.

Failure surface: a task exception is caught, recorded in `errors`, and the
worker keeps running.  `errors` is exported through engine `stats()`
(`maint_errors`) and checked by the workload runner, so a broken
background merge fails CI instead of silently stalling maintenance.
"""

from __future__ import annotations

import queue
import threading
import traceback


class MaintenanceScheduler:
    def __init__(self, max_queue: int = 4, name: str = "dili-maint"):
        self.max_queue = max_queue
        self.errors: list[str] = []
        self._q: queue.Queue = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._worker.start()

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                self._q.task_done()
                return
            try:
                task()
            except BaseException:
                self.errors.append(traceback.format_exc())
            finally:
                with self._lock:
                    self._pending -= 1
                self._q.task_done()

    # -- submission side -----------------------------------------------------

    @property
    def depth(self) -> int:
        """Tasks submitted but not yet finished (incl. the running one)."""
        with self._lock:
            return self._pending

    def submit(self, task) -> bool:
        """Enqueue `task` unless closed or the queue is full (the caller
        coalesces into a later trigger).  Returns whether it was taken."""
        with self._lock:
            if self._closed or self._pending >= self.max_queue:
                return False
            self._pending += 1
        self._q.put(task)
        return True

    def drain(self) -> None:
        """Block until every submitted task has finished."""
        self._q.join()

    def close(self) -> None:
        """Drain, then stop the worker (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.join()
        self._q.put(None)
        self._worker.join(timeout=30.0)
