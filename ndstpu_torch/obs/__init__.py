"""Unified observability: span tracer + cost-attribution metrics.

A copy of the JAX package's ``ndstpu/obs/__init__.py``, its imports changed.

The engine (``jaxexec``), SPMD executor (``dplan``/``exchange``), and
harness (``power``/``bench``/``report``) all instrument through this
package's module-level facade over one process-global tracer:

    from ndstpu_torch import obs
    with obs.span("discovery", cat="plan-node", bucket="compile_s"):
        ...
    obs.inc("engine.cache.compiled.hit")

Default ON; ``NDSTPU_TRACE=0`` disables everything (spans become a
shared no-op, instruments early-return).  See docs/OBSERVABILITY.md for
the span model, instrument catalog, and export formats.
"""

from __future__ import annotations

from typing import Optional

from ndstpu_torch.obs import export as _export
from ndstpu_torch.obs.trace import NULL_SPAN, Span, Tracer, env_enabled

__all__ = [
    "Tracer", "Span", "NULL_SPAN", "env_enabled", "tracer", "enabled",
    "span", "record", "add_time", "annotate", "inc", "set_gauge",
    "counters_snapshot", "gauges_snapshot", "counter_delta",
    "export_jsonl", "export_chrome", "export_run", "run_metrics",
    "reset",
]

_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def reset(enabled: Optional[bool] = None) -> Tracer:
    """Replace the global tracer (tests / long-lived drivers starting a
    fresh measurement window).  Returns the new tracer."""
    global _TRACER
    _TRACER = Tracer(enabled=enabled)
    return _TRACER


def span(name: str, cat: str = "op", bucket: Optional[str] = None,
         collect: bool = False, **attrs):
    return _TRACER.span(name, cat=cat, bucket=bucket, collect=collect,
                        **attrs)


def record(name: str, cat: str, t0_epoch: float, wall_s: float,
           **attrs) -> None:
    _TRACER.record(name, cat, t0_epoch, wall_s, **attrs)


def add_time(bucket: str, seconds: float) -> None:
    _TRACER.add_time(bucket, seconds)


def annotate(**attrs) -> None:
    _TRACER.annotate(**attrs)


def inc(name: str, value: float = 1) -> None:
    _TRACER.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    _TRACER.set_gauge(name, value)


def counters_snapshot() -> dict:
    return _TRACER.counters_snapshot()


def gauges_snapshot() -> dict:
    return _TRACER.gauges_snapshot()


def counter_delta(before: dict, after: Optional[dict] = None) -> dict:
    """Non-zero counter movement between two snapshots (after defaults
    to the live registry) — the per-query metrics block contract."""
    if after is None:
        after = _TRACER.counters_snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def export_jsonl(path: str) -> str:
    return _export.export_jsonl(_TRACER, path)


def export_chrome(path: str) -> str:
    return _export.export_chrome(_TRACER, path)


def export_run(directory: str, base: str) -> dict:
    return _export.export_run(_TRACER, directory, base)


def run_metrics(extra: Optional[dict] = None) -> dict:
    return _export.run_metrics(_TRACER, extra)
