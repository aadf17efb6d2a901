"""Deterministic fault injection + failure taxonomy + retry/quarantine.

A copy of the JAX package's ``ndstpu/faults/__init__.py``, its imports changed.

Three pillars (docs/ROBUSTNESS.md):

* :mod:`ndstpu_torch.faults.injector` — named fault *sites* instrumented
  through the engine, io, and harness layers.  A seed-driven spec
  (``NDSTPU_FAULTS=execute:transient:0.2:seed7`` or a YAML block)
  raises synthetic transient/permanent/hang faults at those sites.
  Same seed => same fault sequence, so chaos runs are reproducible.
* :mod:`ndstpu_torch.faults.taxonomy` — classify any exception as
  ``transient`` (retry-worthy: RPC/timeout/injected-transient) or
  ``permanent`` (plan/typecheck/unsupported — retrying cannot help).
* :mod:`ndstpu_torch.faults.retry` — bounded deterministic backoff around a
  query runner, plus per-query-key quarantine (poison handling):
  a key that keeps failing is skipped with an explicit
  ``partial_reason`` and never publishes to shared caches.

The probe API is zero-cost when no spec is installed::

    from ndstpu_torch import faults
    faults.check("execute", key=query_name)   # no-op unless configured
"""

from __future__ import annotations

from ndstpu_torch.faults.injector import (  # noqa: F401
    SITES,
    FaultSpecError,
    InjectedFault,
    InjectedPermanent,
    InjectedTransient,
    Injector,
    active,
    check,
    install,
    install_from_env,
    parse_spec,
    uninstall,
)
from ndstpu_torch.faults.retry import (  # noqa: F401
    Quarantine,
    RetryPolicy,
    run_with_retry,
)
from ndstpu_torch.faults.taxonomy import classify, classify_name  # noqa: F401

__all__ = [
    "SITES", "FaultSpecError", "InjectedFault", "InjectedTransient",
    "InjectedPermanent", "Injector", "active", "check", "install",
    "install_from_env", "uninstall", "parse_spec",
    "classify", "classify_name",
    "RetryPolicy", "Quarantine", "run_with_retry",
]
