"""Per-key in-flight latch: "compile once, others wait" (the port's copy
of ``ndstpu.engine.latch``).

Threads may share one ``Session`` and its ``CompilingExecutor``.  Two
of them running the same query text concurrently must not both pay the
plan/discovery/capture —
the first holds the key's latch while it builds, later arrivals block
on the latch and then find the entry in the (now-populated) cache.

A failed build must not poison anything: the latch is released in
``finally`` and nothing is cached, so the next arrival simply retries
the build itself.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict


class KeyedLatch:
    """A dynamic set of per-key re-entrant mutexes.

    ``holding(key)`` is a context manager that serializes all holders
    of the same key while holders of different keys proceed
    concurrently.  Re-entrant per thread (a query plan that recurses
    into the session under the same key must not self-deadlock).
    Lock objects are refcounted and dropped when the last holder
    leaves, so the map cannot grow beyond the live key set.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._latches: Dict[object, list] = {}  # key -> [RLock, refcount]

    @contextlib.contextmanager
    def holding(self, key):
        with self._lock:
            ent = self._latches.get(key)
            if ent is None:
                ent = self._latches[key] = [threading.RLock(), 0]
            ent[1] += 1
        ent[0].acquire()
        try:
            yield
        finally:
            ent[0].release()
            with self._lock:
                ent[1] -= 1
                if ent[1] == 0 and self._latches.get(key) is ent:
                    del self._latches[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._latches)
