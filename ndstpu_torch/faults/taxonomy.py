"""Failure taxonomy: every exception is ``transient`` or ``permanent``.

A copy of the JAX package's ``ndstpu/faults/taxonomy.py``, its imports changed.

The split drives retry policy (ndstpu_torch/faults/retry.py) and the sentinel
verdicts (``failed-transient`` / ``failed-permanent``):

* **transient** — the operation might succeed on retry: RPC/connection
  faults, deadlines/timeouts (including the power watchdog's
  abandonment ``TimeoutError``), device preemption, and injected
  transient faults.
* **permanent** — retrying cannot help: planner rejections
  (``PlanError``), engine capability gaps (``Unsupported`` /
  ``DistUnsupported``), typecheck/contract violations (``TypeError``,
  ``ValueError``, ...), and injected permanent faults.

Classification is by exception-class *name* along the MRO plus message
keywords — never by importing engine modules — so the taxonomy is
usable from lint/CI contexts that must not pull jax.  Unknown
exceptions default to **permanent**: silently retrying a logic bug
hides it, while a misclassified transient merely fails one run.
"""

from __future__ import annotations

from typing import Tuple

TRANSIENT = "transient"
PERMANENT = "permanent"

# exception class names (matched along the MRO) that are retry-worthy
TRANSIENT_TYPE_NAMES = frozenset({
    "InjectedTransient",
    # losing a lake commit race (io/commit.py): reload + rebase + retry
    "CommitConflict",
    "TimeoutError",
    "ConnectionError",
    "ConnectionResetError",
    "ConnectionAbortedError",
    # refused MUST stay transient: during a fleet replica restart a
    # connect races the new incarnation's bind, and a client that
    # treats refusal as permanent abandons a server that is seconds
    # from ready (serve/client.py failover; tests/test_serve.py)
    "ConnectionRefusedError",
    "BrokenPipeError",
    "InterruptedError",
    # socket.timeout: an alias of TimeoutError since 3.10, but the
    # class *name* along the MRO is "timeout" on older pickles/paths —
    # a dropped serve connection must never classify permanent
    "timeout",
})

# class names that are definitely not retry-worthy, checked FIRST so a
# permanent subclass of a broad builtin never sneaks into retries
PERMANENT_TYPE_NAMES = frozenset({
    "InjectedPermanent",
    "PlanError",
    "Unsupported",
    "DistUnsupported",
    "NotImplementedError",
    "SyntaxError",
    "TypeError",
    "ValueError",
    "KeyError",
    "AttributeError",
    "AssertionError",
})

# message substrings that mark an otherwise-unknown runtime error
# (e.g. jax.errors.JaxRuntimeError wrapping an RPC failure) transient
TRANSIENT_MESSAGE_KEYWORDS = (
    "deadline exceeded",
    "timed out",
    "timeout",
    "rpc",
    "unavailable",
    "connection reset",
    "connection closed",
    "connection refused",
    "connection aborted",
    "broken pipe",
    "socket closed",
    "preempt",
    "temporarily",
    "try again",
)


def _mro_names(exc_type: type) -> Tuple[str, ...]:
    return tuple(c.__name__ for c in getattr(exc_type, "__mro__",
                                             (exc_type,)))


def classify_name(type_name: str, message: str = "") -> str:
    """Classify from a class name (+ optional message) alone — the
    sentinel path, which only has the span's recorded ``error`` attr."""
    if type_name in PERMANENT_TYPE_NAMES:
        return PERMANENT
    if type_name in TRANSIENT_TYPE_NAMES:
        return TRANSIENT
    low = (message or "").lower()
    if any(k in low for k in TRANSIENT_MESSAGE_KEYWORDS):
        return TRANSIENT
    return PERMANENT


def classify(exc: BaseException) -> str:
    """Classify a live exception: explicit taxonomy attribute first
    (injected faults carry ``.kind``), then MRO names, then message."""
    kind = getattr(exc, "kind", None)
    if kind in (TRANSIENT, PERMANENT):
        return kind
    names = _mro_names(type(exc))
    for n in names:
        if n in PERMANENT_TYPE_NAMES:
            return PERMANENT
    for n in names:
        if n in TRANSIENT_TYPE_NAMES:
            return TRANSIENT
    return classify_name(names[0] if names else "", str(exc))
