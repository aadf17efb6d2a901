"""Runtime spine-materialization cache (cross-query MQO), the port of
``ndstpu.engine.spine``.

The analysis half (:mod:`ndstpu_torch.analysis.spines`) proves which
canonical plan subtrees recur across corpus parts; this module is the
runtime half: an LRU table cache keyed on the subtree's *value key*
(canonical fingerprint + hash over all slot values — a spine binding
different literals is a different materialized table).  The first query
to execute a flagged spine materializes the subtree and publishes the
result; later queries splice the cached table in place of the subtree
(``Session._splice_spines``) instead of recomputing the scan/filter/join
work.

A cached table lives on the session's device: its columns are the
tensors of an eager run of the subtree (:meth:`CompilingExecutor
.materialize`), and a spliced plan reads them with no host copy.  A graph
captured over a spliced plan holds those tensors' addresses, so an entry
that leaves the cache (evicted, replaced, or dropped as stale) is handed
to ``on_evict``, which lets go of every compiled plan that reads it
(``Session._release_spine``): only then is its memory free.

Admission is byte-budgeted with the memory-planner's model: entries
evict LRU-first so the cache never holds more than ``budget_bytes``,
and a table bigger than the whole budget is simply not cached (the
query still runs — it just doesn't share).  Entries carry the session
state (views epoch + catalog versions) they were built under and are
dropped on mismatch, mirroring ``Session._plan_cache`` semantics.

Counters: ``engine.spine.hit`` / ``engine.spine.miss`` per flagged-site
lookup, ``engine.spine.bytes`` cumulative bytes served from cache (the
bytes-saved proxy), ``engine.spine.evict`` per eviction, and
``engine.spine.errors`` per analysis failure that skipped splicing — all
flowing into the obs sidecars and the run ledger.  ``NDSTPU_SPINES=0`` is
the kill switch (checked by the splicer and the scheduler installer).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Set, Tuple

from ndstpu_torch.engine import memplan, plan as lp
from ndstpu_torch.engine.latch import KeyedLatch


def enabled() -> bool:
    """NDSTPU_SPINES=0 kills all spine sharing (analysis still runs)."""
    return os.environ.get("NDSTPU_SPINES", "1") not in ("", "0")


def runtime_budget_bytes(device=None) -> Tuple[int, str]:
    """Byte budget for the runtime cache: NDSTPU_SPINE_BUDGET_BYTES
    wins (tests / operator pin), else the memory planner's per-device
    budget (on a card its free memory) scaled by its SAFETY fraction —
    the spine cache competes with the device tables and the graphs for
    the same memory."""
    env = os.environ.get("NDSTPU_SPINE_BUDGET_BYTES")
    if env:
        return max(int(env), 1), "env"
    budget, source = memplan.device_budget_bytes(device)
    return max(int(budget * memplan.SAFETY), 1), source


def dictionary_nbytes(values) -> int:
    """Actual encoded byte size of a dictionary's text (UTF-8)
    (``ndstpu.io.gdict.dictionary_nbytes``)."""
    if values is None:
        return 0
    return int(sum(len(str(v).encode("utf-8")) for v in values))


def table_bytes(t) -> int:
    """Materialized size of a columnar.Table: its columns' device (or
    host) bytes, data + validity mask, plus the UTF-8 text bytes of
    string dictionaries and 8 B an entry (which stay on the host)."""
    n = 0
    for c in t.columns.values():
        n += int(c.data.nbytes)
        if c.valid is not None:
            n += int(c.valid.nbytes)
        if c.dictionary is not None:
            n += dictionary_nbytes(c.dictionary) + 8 * len(c.dictionary)
    return n


class SpineCache:
    """Byte-budgeted LRU of materialized spine tables.

    ``flagged`` is the set of value keys worth publishing (the scheduler
    flags keys that occur >= 2 times across its streams); ``None`` means
    every eligible site publishes (tests).  ``on_evict(table)`` is called
    for every table that leaves the cache.  Thread-safe; the per-key latch
    gives materialize-once semantics to callers that publish outside the
    session's execution lock."""

    def __init__(self, budget_bytes: int,
                 flagged: Optional[Set[str]] = None,
                 on_evict: Optional[Callable[[object], None]] = None):
        self.budget_bytes = max(int(budget_bytes), 0)
        self.flagged = flagged
        self.on_evict = on_evict
        self._lock = threading.RLock()
        self._latch = KeyedLatch()
        # value_key -> [state, table, nbytes]; insertion order = LRU
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def eligible(self, value_key: str) -> bool:
        return self.flagged is None or value_key in self.flagged

    def holding(self, value_key: str):
        return self._latch.holding(value_key)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, value_key: str, state):
        """The cached table for ``value_key`` built under ``state``, or
        None.  A stale-state entry is dropped (DML/view churn), exactly
        like the session's plan cache."""
        with self._lock:
            ent = self._entries.get(value_key)
            if ent is None:
                return None
            if ent[0] != state:
                # the catalog epoch moved under this entry (DML / view
                # churn): a hit here would serve a stale spine
                self._drop(value_key)
                _obs_inc("engine.snapshot.stale_drops")
                return None
            self._entries.move_to_end(value_key)
            return ent[1]

    def put(self, value_key: str, state, table) -> bool:
        """Publish a materialized spine; returns False when the table
        alone exceeds the whole budget (not cached — the publisher's
        query still ran, nothing is lost but the sharing)."""
        nbytes = table_bytes(table)
        with self._lock:
            if nbytes > self.budget_bytes:
                return False
            self._drop(value_key)
            while self._bytes + nbytes > self.budget_bytes and \
                    self._entries:
                old = next(iter(self._entries))
                self._drop(old)
                self.evictions += 1
                _obs_inc("engine.spine.evict")
            self._entries[value_key] = [state, table, nbytes]
            self._bytes += nbytes
            return True

    def clear(self) -> None:
        """Drop every entry."""
        with self._lock:
            for vk in list(self._entries):
                self._drop(vk)

    def _drop(self, value_key: str) -> None:
        ent = self._entries.pop(value_key, None)
        if ent is not None:
            self._bytes -= ent[2]
            if self.on_evict is not None:
                self.on_evict(ent[1])


def _obs_inc(name: str, value: float = 1) -> None:
    from ndstpu_torch import obs
    obs.inc(name, value)


def replace_nodes(plan: lp.Plan,
                  mapping: Dict[int, lp.Plan]) -> lp.Plan:
    """Non-mutating rebuild of ``plan`` with ``mapping[id(node)]``
    swapped in where present.  The cached plan object is shared across
    streams (Session._plan_cache), so splicing must never touch it."""
    r = mapping.get(id(plan))
    if r is not None:
        return r
    if isinstance(plan, (lp.Join, lp.SetOp)):
        return dataclasses.replace(
            plan,
            left=replace_nodes(plan.left, mapping),
            right=replace_nodes(plan.right, mapping))
    child = getattr(plan, "child", None)
    if isinstance(child, lp.Plan):
        return dataclasses.replace(plan,
                                   child=replace_nodes(child, mapping))
    return plan
