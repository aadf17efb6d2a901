"""Admission control for the query server: shed load, don't queue it.

A copy of the JAX package's ``ndstpu/serve/overload.py``.

Three guards run before a request touches the engine, each returning a
*typed* outcome instead of unbounded queuing (the reference delegates
this whole layer to Spark's scheduler backpressure):

* :class:`TenantBudgets` — per-tenant token buckets.  A tenant at
  budget gets :class:`Rejected` while other tenants proceed; tokens
  refill continuously so a backed-off client recovers on its own.
* :class:`AdmissionQueue` — a bounded count of admitted-but-unfinished
  requests.  At depth, new work gets :class:`Overloaded` (retriable,
  with a ``retry_after_s`` hint); a request whose ``deadline_s`` the
  projected queue wait already busts is shed as :class:`Rejected`
  ("deadline") — running it would waste device time on an answer the
  client will no longer accept.  The per-item wait estimate behind
  both hints is an **EWMA of observed service walls**
  (:meth:`AdmissionQueue.observe`), seeded by ``est_wait_s`` until the
  first completion — a slow corpus pushes clients off proportionally
  harder than a fast one, and the hint decays as the server speeds
  back up.  Depth itself can come from the memplan device-memory
  model (``engine/memplan.py:admission_budget``) instead of the
  static 64 when the server is configured with ``queue_depth=auto``.
* :class:`CircuitBreaker` — per canonical plan fingerprint, tripped by
  the :class:`~ndstpu_torch.faults.Quarantine` poison list: once a plan
  shape is quarantined the breaker fast-fails further requests for it
  (:class:`Rejected`, "circuit-open") instead of burning retries, and
  recovers via a half-open probe after ``cooldown_s``.

All guards take an injectable monotonic ``clock`` so the cooldown /
refill edges are unit-testable without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class Overloaded(Exception):
    """Server momentarily full — retriable after ``retry_after_s``."""

    # taxonomy hook (faults/taxonomy.py reads .kind first): a client
    # retry loop treats overload like any transient fault
    kind = "transient"

    def __init__(self, message: str, retry_after_s: float = 0.1):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Rejected(Exception):
    """Typed refusal (budget / deadline / circuit) — retrying the same
    request unchanged cannot help, so clients must not."""

    kind = "permanent"

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class TenantBudgets:
    """Continuous-refill token buckets, one per tenant (lazily made)."""

    def __init__(self, capacity: float = 8.0,
                 refill_per_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if capacity <= 0 or refill_per_s < 0:
            raise ValueError("capacity must be > 0, refill_per_s >= 0")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, list] = {}  # tenant -> [tokens, t_last]

    def acquire(self, tenant: str, cost: float = 1.0) -> None:
        """Spend ``cost`` tokens or raise :class:`Rejected`."""
        now = self._clock()
        with self._lock:
            b = self._buckets.setdefault(
                tenant, [self.capacity, now])
            b[0] = min(self.capacity,
                       b[0] + (now - b[1]) * self.refill_per_s)
            b[1] = now
            if b[0] < cost:
                wait = (cost - b[0]) / self.refill_per_s \
                    if self.refill_per_s > 0 else float("inf")
                raise Rejected(
                    f"tenant {tenant!r} at budget "
                    f"({b[0]:.2f}/{self.capacity:g} tokens; "
                    f"~{wait:.1f}s to afford this request)",
                    reason="tenant-budget")
            b[0] -= cost

    def tokens(self, tenant: str) -> float:
        now = self._clock()
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                return self.capacity
            return min(self.capacity,
                       b[0] + (now - b[1]) * self.refill_per_s)


class AdmissionQueue:
    """Bounded admitted-but-unfinished request count + deadline shed.

    ``est_wait_s`` is only the cold-start seed: every completed
    request's wall feeds :meth:`observe`, and the live estimate is an
    exponentially-weighted moving average (``ewma_alpha`` weight on
    the newest wall).  ``retry_after_s`` hints and deadline sheds both
    read the EWMA, so backoff tracks what the server is *actually*
    doing right now."""

    def __init__(self, depth: int = 64,
                 est_wait_s: float = 0.25,
                 ewma_alpha: float = 0.2,
                 clock: Callable[[], float] = time.monotonic):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], "
                             f"got {ewma_alpha}")
        self.depth = depth
        self.seed_wait_s = float(est_wait_s)  # pre-observation seed
        self.ewma_alpha = float(ewma_alpha)
        self._ewma_s: Optional[float] = None
        self.observed = 0                     # walls folded into EWMA
        self._clock = clock
        self._lock = threading.Lock()
        self._admitted = 0
        self.peak = 0

    @property
    def est_wait_s(self) -> float:
        """Projected wait per queued item: the service-wall EWMA once
        anything has completed, the static seed before that."""
        ewma = self._ewma_s
        return self.seed_wait_s if ewma is None else ewma

    def observe(self, wall_s: float) -> None:
        """Fold one completed request's service wall into the EWMA."""
        wall_s = max(float(wall_s), 0.0)
        with self._lock:
            if self._ewma_s is None:
                self._ewma_s = wall_s
            else:
                a = self.ewma_alpha
                self._ewma_s = a * wall_s + (1.0 - a) * self._ewma_s
            self.observed += 1

    def admit(self, deadline_s: Optional[float] = None) -> None:
        """Admit or raise.  ``deadline_s`` is the client's remaining
        deadline for this request; a projected queue wait beyond it
        sheds the request NOW rather than serving a dead answer."""
        with self._lock:
            est = (self.seed_wait_s if self._ewma_s is None
                   else self._ewma_s)
            if self._admitted >= self.depth:
                raise Overloaded(
                    f"admission queue full ({self._admitted}/"
                    f"{self.depth}; est {est:.3f}s/query)",
                    retry_after_s=max(est, 0.05))
            projected = self._admitted * est
            if deadline_s is not None and projected > deadline_s:
                raise Rejected(
                    f"projected queue wait {projected:.2f}s exceeds "
                    f"request deadline {deadline_s:g}s "
                    f"({self._admitted} ahead)", reason="deadline")
            self._admitted += 1
            self.peak = max(self.peak, self._admitted)

    def release(self) -> None:
        with self._lock:
            if self._admitted > 0:
                self._admitted -= 1

    @property
    def admitted(self) -> int:
        with self._lock:
            return self._admitted

    def snapshot(self) -> Dict[str, object]:
        """Health/probe view of the queue's live state."""
        with self._lock:
            est = (self.seed_wait_s if self._ewma_s is None
                   else self._ewma_s)
            return {"depth": self.depth, "admitted": self._admitted,
                    "peak": self.peak, "est_wait_s": round(est, 6),
                    "observed": self.observed}


class CircuitBreaker:
    """Per-canonical-fingerprint breaker over the quarantine list.

    States per key: ``closed`` (normal) → ``open`` (quarantined plan
    shape; fast-fail until ``cooldown_s`` elapses) → ``half-open``
    (exactly one probe request allowed through) → ``closed`` on probe
    success / back to ``open`` on probe failure."""

    def __init__(self, quarantine, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.quarantine = quarantine
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._opened_at: Dict[str, float] = {}
        self._probing: Dict[str, bool] = {}
        self.tripped = 0

    def state(self, key: str) -> str:
        with self._lock:
            if key not in self._opened_at:
                return "closed"
            if self._clock() - self._opened_at[key] < self.cooldown_s:
                return "open"
            return "half-open"

    def check(self, key: str) -> None:
        """Gate one request for ``key``: raise :class:`Rejected` while
        open; admit the single half-open probe after cooldown."""
        with self._lock:
            opened = self._opened_at.get(key)
            if opened is None:
                return
            age = self._clock() - opened
            if age < self.cooldown_s:
                raise Rejected(
                    f"circuit open for plan shape {key[:48]!r} "
                    f"(quarantined; retry in "
                    f"{self.cooldown_s - age:.1f}s)",
                    reason="circuit-open")
            if self._probing.get(key):
                raise Rejected(
                    f"circuit half-open for plan shape {key[:48]!r}: "
                    f"probe in flight", reason="circuit-open")
            self._probing[key] = True  # this request is the probe

    def note_success(self, key: str) -> None:
        with self._lock:
            self._opened_at.pop(key, None)
            self._probing.pop(key, None)

    def note_failure(self, key: str) -> bool:
        """Record a final (post-retry) failure; trips the breaker when
        the quarantine has poisoned the key.  Returns True on trip or
        re-open."""
        poisoned = self.quarantine is not None and \
            self.quarantine.is_quarantined(key)
        with self._lock:
            self._probing.pop(key, None)
            if not poisoned:
                return False
            first = key not in self._opened_at
            self._opened_at[key] = self._clock()
            if first:
                self.tripped += 1
            return True
