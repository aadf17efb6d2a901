"""Per-query benchmark report (JSON summary contract).

A copy of the JAX package's ``ndstpu/harness/report.py``, its imports
changed, ``engineVersion`` this package's, and its warning collector
made safe for concurrent streams (:class:`_WarningSinks`).

Mirrors the reference's PysparkBenchReport (PysparkBenchReport.py:42-122):
captures env vars (TOKEN/SECRET/PASSWORD redacted), engine configuration and
version, wall time, status taxonomy Completed / CompletedWithTaskFailures /
Failed with exception strings, and writes `{prefix}-{query}-{startTime}.json`
(the filename format is a downstream-pipeline contract).

The reference's JVM task-failure listener maps here to an in-process warning
collector: engine warnings during a query (e.g. schema coercion fallbacks)
mark the run CompletedWithTaskFailures.  The throughput run's stream
threads each hold a report open at once; ``warnings.catch_warnings`` swaps
process-wide state and restores it in whatever order the threads leave,
so there each report records the warnings of its own thread.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
import warnings
from typing import Callable

import ndstpu_torch
from ndstpu_torch import obs
from ndstpu_torch.faults import taxonomy
from ndstpu_torch.io import atomic


class _WarningSinks:
    """The warnings raised while reports are open, each recorded in the
    list of the report its thread opened.  One process-wide
    ``catch_warnings`` (every warning shown, none deduplicated) stays
    entered while any report is open.  A warning from a thread with no
    report of its own goes to the one open report (the power run's
    watchdog thread runs the query of the report its caller opened), and
    when several are open to stderr, since no report can claim it."""

    def __init__(self):
        self._lock = threading.Lock()
        # thread ident -> the recorded warnings of its open reports,
        # innermost last
        self._sinks: dict = {}
        self._saved = None

    def open(self) -> list:
        records: list = []
        with self._lock:
            if not self._sinks:
                self._saved = warnings.catch_warnings()
                self._saved.__enter__()
                warnings.simplefilter("always")
                warnings.showwarning = self._show
            self._sinks.setdefault(threading.get_ident(), []).append(records)
        return records

    def close(self) -> None:
        with self._lock:
            tid = threading.get_ident()
            self._sinks[tid].pop()
            if not self._sinks[tid]:
                del self._sinks[tid]
            if not self._sinks:
                self._saved.__exit__(None, None, None)
                self._saved = None

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        msg = warnings.WarningMessage(message, category, filename, lineno,
                                      file, line)
        with self._lock:
            stack = self._sinks.get(threading.get_ident())
            if stack is None and len(self._sinks) == 1:
                (stack,) = self._sinks.values()
            if stack is not None:
                stack[-1].append(msg)
                return
        sys.stderr.write(warnings.formatwarning(message, category, filename,
                                                lineno, line))


_WARNINGS = _WarningSinks()


class BenchReport:
    """Wraps one measured callable; accumulates the JSON summary."""

    def __init__(self, engine_conf: dict | None = None):
        self.engine_conf = dict(engine_conf or {})
        self.summary = {
            "env": {
                "envVars": {},
                "engineConf": {},
                "engineVersion": None,
            },
            "queryStatus": [],
            "exceptions": [],
            "taskFailures": [],
            "startTime": None,
            "queryTimes": [],
        }
        # Seed provenance: spec 4.3.1 chains the stream RNGSEED from
        # the load end timestamp unconditionally (reference
        # nds_bench.py:413-414).  The bench driver publishes which
        # policy this run used via NDSTPU_SEED_POLICY; a pinned seed is
        # a deliberate cache-warm trade and every summary carries the
        # non-compliance flag so the artifact cannot pass as spec.
        policy = os.environ.get("NDSTPU_SEED_POLICY")
        if policy:
            self.summary["specCompliance"] = {
                "seed_policy": policy,
                "rngseed_pinned": policy.startswith("pinned"),
                "spec_compliant_seed": not policy.startswith("pinned"),
                "note": ("spec 4.3.1 requires RNGSEED chained from the "
                         "load end timestamp (nds_bench.py:413-414); "
                         "pinned seeds reuse a warmed corpus"),
            }

    def report_on(self, fn: Callable, *args, query_name: str = None,
                  span_attrs: dict | None = None):
        redacted = ("TOKEN", "SECRET", "PASSWORD")
        self.summary["env"]["envVars"] = {
            k: v for k, v in os.environ.items()
            if not any(r in k.upper() for r in redacted)}
        self.summary["env"]["engineConf"] = self.engine_conf
        self.summary["env"]["engineVersion"] = ndstpu_torch.__version__
        start_time = int(time.time() * 1000)
        counters_before = obs.counters_snapshot()
        # span_attrs tags the query span for trace/ledger consumers —
        # the throughput harness stamps the stream id on every query
        # span so one shared trace stays attributable per stream
        qspan = obs.span(query_name or getattr(fn, "__name__", "query"),
                         cat="query", collect=True, **(span_attrs or {}))
        try:
            caught = _WARNINGS.open()
            try:
                with qspan:
                    fn(*args)
            finally:
                _WARNINGS.close()
            end_time = int(time.time() * 1000)
            if caught:
                self.summary["queryStatus"].append(
                    "CompletedWithTaskFailures")
                self.summary["taskFailures"].extend(
                    str(w.message) for w in caught)
            else:
                self.summary["queryStatus"].append("Completed")
        except Exception as e:  # noqa: BLE001 — benchmark must keep going
            print("ERROR BEGIN")
            print(e)
            traceback.print_tb(e.__traceback__)
            print("ERROR END")
            end_time = int(time.time() * 1000)
            self.summary["queryStatus"].append("Failed")
            self.summary["exceptions"].append(str(e))
            # classified failure contract (docs/ROBUSTNESS.md): every
            # failure carries its taxonomy class, never a bare string
            klass = getattr(e, "taxonomy", None) or taxonomy.classify(e)
            self.summary.setdefault("failureTaxonomy", []).append({
                "query": query_name,
                "class": klass,
                "type": type(e).__name__,
                "attempts": getattr(e, "attempts", 1),
            })
        finally:
            self.summary["startTime"] = start_time
            self.summary["queryTimes"].append(end_time - start_time)
            if obs.enabled():
                b = qspan.buckets or {}
                wall = qspan.wall_s
                compile_s = round(b.get("compile_s", 0.0), 6)
                execute_s = round(b.get("execute_s", 0.0), 6)
                self.summary.setdefault("metrics", []).append({
                    "query": query_name,
                    "wall_s": round(wall, 6),
                    "compile_s": compile_s,
                    "execute_s": execute_s,
                    "attributed_frac": round(
                        (compile_s + execute_s) / wall, 4)
                        if wall > 0 else 0.0,
                    "mode": "cold"
                        if compile_s > max(0.05 * wall, 1e-4) else "warm",
                    "buckets": {k: round(v, 6) for k, v in b.items()},
                    "counters": obs.counter_delta(counters_before),
                })
        return self.summary

    def write_summary(self, query_name: str, prefix: str = "") -> str:
        self.summary["query"] = query_name
        filename = (f"{prefix}-{query_name}-"
                    f"{self.summary['startTime']}.json")
        self.summary["filename"] = filename
        atomic.atomic_write_json(filename, self.summary)
        return filename
