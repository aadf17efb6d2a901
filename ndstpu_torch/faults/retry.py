"""Bounded deterministic retry + per-key quarantine (poison handling).

A copy of the JAX package's ``ndstpu/faults/retry.py``, its imports changed.

``run_with_retry`` wraps one operation (a query execution, a stream
worker): transient failures (ndstpu_torch/faults/taxonomy.py) are retried up
to ``RetryPolicy.max_attempts`` with deterministic exponential backoff
(no jitter — chaos runs must be reproducible); permanent failures raise
immediately.  Counters: ``harness.retry.attempts`` (every extra
attempt), ``harness.retry.recovered`` (succeeded after retrying),
``harness.retry.exhausted`` (transient budget spent),
``harness.taxonomy.transient`` / ``harness.taxonomy.permanent`` (final
failures by class).

``Quarantine`` is the poison list: a key (query name) that keeps
failing — across retries, streams, and resumed runs of one harness
process — is quarantined after ``max_failures`` distinct final
failures.  The harness skips quarantined keys with an explicit
per-query ``partial_reason`` (they never silently vanish) and, per the
PR-4 invariant, a quarantined/failed key never publishes to shared
compile/plan caches.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ndstpu_torch import obs
from ndstpu_torch.faults import taxonomy

DEFAULT_MAX_ATTEMPTS = 2
DEFAULT_BASE_BACKOFF_S = 0.05
DEFAULT_MAX_BACKOFF_S = 2.0
DEFAULT_QUARANTINE_FAILURES = 2

RETRY_ENV = "NDSTPU_RETRY_MAX"


class RetryPolicy:
    """Attempt budget + deterministic exponential backoff."""

    def __init__(self, max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                 base_backoff_s: float = DEFAULT_BASE_BACKOFF_S,
                 max_backoff_s: float = DEFAULT_MAX_BACKOFF_S):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based: the wait
        after the first failure is ``backoff_s(1) = base``).  Pure
        doubling capped at ``max_backoff_s`` — no jitter, so two chaos
        runs with the same fault sequence take the same waits."""
        return min(self.base_backoff_s * (2 ** (attempt - 1)),
                   self.max_backoff_s)

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "RetryPolicy":
        import os
        env = env if env is not None else os.environ
        try:
            n = int(env.get(RETRY_ENV, DEFAULT_MAX_ATTEMPTS))
        except ValueError:
            n = DEFAULT_MAX_ATTEMPTS
        return cls(max_attempts=max(n, 1))


class Quarantine:
    """Thread-safe per-key poison list shared across stream workers."""

    def __init__(self, max_failures: int = DEFAULT_QUARANTINE_FAILURES):
        self.max_failures = max_failures
        self._lock = threading.Lock()
        self._failures: Dict[str, List[str]] = {}

    def note_failure(self, key: str, klass: str) -> bool:
        """Record one *final* failure (post-retry) for ``key``; returns
        True when this failure tips the key into quarantine."""
        with self._lock:
            fails = self._failures.setdefault(key, [])
            fails.append(klass)
            if len(fails) == self.max_failures:
                obs.inc("harness.quarantine.queries")
                return True
            return False

    def is_quarantined(self, key: str) -> bool:
        with self._lock:
            return len(self._failures.get(key, ())) >= self.max_failures

    def failures(self, key: str) -> List[str]:
        with self._lock:
            return list(self._failures.get(key, ()))

    def reason(self, key: str) -> str:
        fails = self.failures(key)
        return (f"quarantined: {len(fails)} prior failure(s) "
                f"[{', '.join(fails)}] on this query key "
                f"(poison; max_failures={self.max_failures})")

    def snapshot(self) -> Dict[str, List[str]]:
        with self._lock:
            return {k: list(v) for k, v in self._failures.items()
                    if len(v) >= self.max_failures}


def run_with_retry(fn: Callable[[], object], key: str,
                   policy: Optional[RetryPolicy] = None,
                   quarantine: Optional[Quarantine] = None,
                   sleep: Callable[[float], None] = time.sleep,
                   out: Callable[[str], None] = print
                   ) -> Tuple[object, int]:
    """Run ``fn`` with the retry/quarantine contract.

    Returns ``(result, attempts)``.  On final failure the original
    exception is re-raised with two attributes attached for the report
    layer: ``taxonomy`` ("transient"|"permanent") and ``attempts``.
    """
    policy = policy or RetryPolicy()
    attempt = 0
    while True:
        attempt += 1
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            klass = taxonomy.classify(e)
            if klass == taxonomy.TRANSIENT and \
                    attempt < policy.max_attempts:
                wait = policy.backoff_s(attempt)
                obs.inc("harness.retry.attempts")
                out(f"[retry] {key}: transient failure "
                    f"({type(e).__name__}: {e}) — attempt "
                    f"{attempt}/{policy.max_attempts}, retrying in "
                    f"{wait:g}s")
                sleep(wait)
                continue
            if klass == taxonomy.TRANSIENT:
                obs.inc("harness.retry.exhausted")
            obs.inc(f"harness.taxonomy.{klass}")
            # tag the enclosing query span so the sidecar/ledger/
            # sentinel can split `failed` into failed-<taxonomy>
            obs.annotate(error_taxonomy=klass, error_attempts=attempt)
            if quarantine is not None:
                quarantine.note_failure(key, klass)
            try:
                e.taxonomy = klass
                e.attempts = attempt
            except Exception:  # immutable exception type (rare)
                pass
            raise
        if attempt > 1:
            obs.inc("harness.retry.recovered")
            # surfaces in the ledger entry's extra: a recovered query's
            # timing includes the failed attempts' wall time
            obs.annotate(retry_attempts=attempt)
            out(f"[retry] {key}: recovered on attempt {attempt}")
        return result, attempt
