"""Trace/metrics export: JSONL event log + Chrome ``trace_event`` JSON.

A copy of the JAX package's ``ndstpu/obs/export.py``, its imports changed.

Two formats per run (tentpole contract):

* ``<base>.trace.jsonl`` — one JSON object per line: a ``meta`` header,
  one ``span`` line per finished span (epoch-anchored start, wall
  seconds, bucket totals on collectors), then ``counters`` and
  ``gauges`` lines.  Greppable, concatenable across processes.
* ``<base>.trace.json`` — ``{"traceEvents": [...]}`` with matched
  ``B``/``E`` duration events (µs timestamps), loadable in Perfetto /
  ``chrome://tracing``.  Span nesting renders as the flame stack.

``run_metrics(tracer)`` aggregates the same data into the dict the
harness writes as the ``<time_log>.metrics.json`` sidecar and
``docs/HW_METRICS_*.json`` embeds.
"""

from __future__ import annotations

import json
from typing import Optional

from ndstpu_torch.obs.trace import Tracer


def export_jsonl(tracer: Tracer, path: str) -> str:
    # imported lazily: obs.__init__ -> export -> io.atomic -> faults ->
    # obs would be a bootstrap cycle at module-import time
    from ndstpu_torch.io import atomic
    with tracer._lock:
        events = [dict(e) for e in tracer.events]
        counters = dict(tracer.counters)
        gauges = dict(tracer.gauges)
    with atomic.atomic_writer(path, "w") as f:
        f.write(json.dumps({"type": "meta", "format": "ndstpu-trace-v1",
                            "pid": tracer.pid,
                            "t0_epoch_s": tracer.t0_epoch}) + "\n")
        for e in events:
            f.write(json.dumps({"type": "span", **e}) + "\n")
        f.write(json.dumps({"type": "counters", "counters": counters})
                + "\n")
        f.write(json.dumps({"type": "gauges", "gauges": gauges}) + "\n")
    return path


def export_chrome(tracer: Tracer, path: str) -> str:
    """Perfetto-loadable trace: B/E pairs per span, µs epoch timestamps."""
    with tracer._lock:
        events = [dict(e) for e in tracer.events]
    out = []
    for e in events:
        ts = e["ts_epoch_s"] * 1e6
        dur = e["wall_s"] * 1e6
        base = {"name": e["name"], "cat": e["cat"],
                "pid": e["pid"], "tid": e["tid"]}
        args = dict(e.get("args", {}))
        if e.get("buckets"):
            args["buckets"] = e["buckets"]
        out.append({**base, "ph": "B", "ts": ts, "args": args})
        out.append({**base, "ph": "E", "ts": ts + dur})
    # B events at the same instant must open before they close; stable
    # sort on (ts, B-before-E at equal ts is wrong for zero-width spans
    # — keep pair adjacency by sorting on ts then original order)
    order = {id(e): i for i, e in enumerate(out)}
    out.sort(key=lambda e: (e["ts"], order[id(e)]))
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    from ndstpu_torch.io import atomic
    atomic.atomic_write_json(path, doc, indent=None)
    return path


def run_metrics(tracer: Tracer, extra: Optional[dict] = None) -> dict:
    """Aggregate a run: per-query attribution + instrument snapshot.

    ``queries[*].compile_s + execute_s`` over ``wall_s`` is the
    self-labeling cold/warm split; ``counters`` carries the cache
    hit/miss + exchange instruments."""
    queries = tracer.query_summaries()
    total_wall = sum(q["wall_s"] for q in queries)
    total_compile = sum(q["compile_s"] for q in queries)
    total_execute = sum(q["execute_s"] for q in queries)
    m = {
        "enabled": tracer.enabled,
        "queries": queries,
        "totals": {
            "n_queries": len(queries),
            "wall_s": round(total_wall, 6),
            "compile_s": round(total_compile, 6),
            "execute_s": round(total_execute, 6),
            "attributed_frac": round(
                (total_compile + total_execute) / total_wall, 4)
            if total_wall > 0 else 0.0,
            "cold_queries": sum(1 for q in queries
                                if q["mode"] == "cold"),
        },
        "counters": tracer.counters_snapshot(),
        "gauges": tracer.gauges_snapshot(),
    }
    if extra:
        m.update(extra)
    return m


def export_run(tracer: Tracer, directory: str, base: str) -> dict:
    """Write both trace formats under ``directory`` with stem ``base``;
    returns {'jsonl': path, 'chrome': path}."""
    import os
    os.makedirs(directory or ".", exist_ok=True)
    return {
        "jsonl": export_jsonl(
            tracer, os.path.join(directory, base + ".trace.jsonl")),
        "chrome": export_chrome(
            tracer, os.path.join(directory, base + ".trace.json")),
    }
