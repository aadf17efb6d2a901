"""Span tracer + metrics registry (dependency-free, stdlib only).

A copy of the JAX package's ``ndstpu/obs/trace.py``, its imports changed.

One process-global :class:`Tracer` records a tree of timed spans
(``phase > stream > query > plan-node``) plus named counters and gauges.
Tracing defaults ON and is disabled with ``NDSTPU_TRACE=0``; a disabled
tracer hands out a shared no-op span, so instrumented code pays one
attribute read and nothing else.  Tracing never touches query data —
it only reads clocks and appends to in-process lists.

Cost-attribution model ("buckets"):

* A span may carry a *bucket* (``compile_s`` / ``execute_s``) naming the
  cost category its wall time belongs to.
* A span may be a *collector* (``collect=True``; the per-query spans the
  harness opens are).  When a bucketed span finishes, its SELF time —
  wall minus the wall of bucketed spans nested inside it — is added to
  the nearest enclosing collector's bucket totals.  Self-time accounting
  means nested buckets never double count: a ``compile_s`` discovery
  span inside an ``execute_s`` statement span splits the statement wall
  into compile + the remainder, and the bucket totals of a collector
  sum to (at most) its own wall.
* Collectors roll their bucket totals up into the nearest enclosing
  collector when they finish, so a stream span collects what its query
  spans collected.

Threading: each thread has its own span stack (the harness runs queries
under a watchdog thread).  A span opened on a thread with an empty
stack attributes to the most recently entered collector process-wide,
so worker-thread engine spans still land in the open query span.

Clocks: durations are ``time.perf_counter`` deltas (monotonic); every
span also records an epoch-anchored start timestamp so traces from
concurrent processes (throughput streams) can be laid side by side.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional


def env_enabled() -> bool:
    """NDSTPU_TRACE=0 (or empty/false) disables tracing; default on."""
    return os.environ.get("NDSTPU_TRACE", "1").lower() not in (
        "", "0", "false", "off")


class _NullSpan:
    """Shared no-op span: the disabled-tracer fast path."""

    __slots__ = ()
    wall_s = 0.0
    buckets: Dict[str, float] = {}
    attrs: Dict[str, object] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed region.  Context manager; not reusable."""

    __slots__ = ("tracer", "name", "cat", "bucket", "collect", "attrs",
                 "parent", "collector", "parent_collector", "buckets",
                 "child_bucketed_s", "t0", "t0_epoch", "wall_s", "tid",
                 "depth", "seq")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 bucket: Optional[str], collect: bool, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.bucket = bucket
        self.collect = collect
        self.attrs = attrs
        self.buckets: Dict[str, float] = {} if collect else None
        self.child_bucketed_s = 0.0
        self.wall_s = 0.0

    def __enter__(self):
        t = self.tracer
        stack = t._stack()
        self.parent = stack[-1] if stack else None
        self.depth = len(stack)
        if self.parent is not None:
            enclosing = self.parent.collector
        else:
            # cross-thread fallback: a span opened at the top of a worker
            # thread still attributes to the process's open query span
            enclosing = t._fallback_collector
        self.parent_collector = enclosing
        self.collector = self if self.collect else enclosing
        if self.collect:
            t._fallback_collector = self
        stack.append(self)
        self.tid = threading.get_ident()
        self.seq = t._next_seq()
        self.t0_epoch = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        t = self.tracer
        stack = t._stack()
        while stack and stack.pop() is not self:
            pass  # robustness: a leaked child must not wedge the stack
        self.wall_s = t1 - self.t0
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        if self.collect and t._fallback_collector is self:
            t._fallback_collector = self.parent_collector
        if self.bucket:
            self_s = max(self.wall_s - self.child_bucketed_s, 0.0)
            coll = self.collector
            if coll is not None and coll.buckets is not None:
                coll.buckets[self.bucket] = (
                    coll.buckets.get(self.bucket, 0.0) + self_s)
            if self.parent is not None:
                # the FULL wall (self + nested buckets) is already
                # accounted below this span; the parent must subtract
                # all of it from its own self time
                self.parent.child_bucketed_s += self.wall_s
        elif self.parent is not None:
            # transparent span: bucketed grandchildren still subtract
            # from an outer bucketed ancestor
            self.parent.child_bucketed_s += self.child_bucketed_s
        if self.collect and self.buckets:
            up = self.parent_collector
            if up is not None and up.buckets is not None:
                for k, v in self.buckets.items():
                    up.buckets[k] = up.buckets.get(k, 0.0) + v
        t._finish(self)
        return False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self


class Tracer:
    """Process-global span recorder + counter/gauge registry."""

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = env_enabled() if enabled is None else enabled
        self._lock = threading.Lock()
        self._local = threading.local()
        self._fallback_collector: Optional[Span] = None
        self._seq = 0
        self.events: List[dict] = []      # finished spans, end order
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.pid = os.getpid()
        # epoch anchor for cross-process timeline alignment
        self.t0_epoch = time.time()

    # -- span API -------------------------------------------------------------

    def span(self, name: str, cat: str = "op",
             bucket: Optional[str] = None, collect: bool = False,
             **attrs):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, bucket, collect, attrs)

    def record(self, name: str, cat: str, t0_epoch: float,
               wall_s: float, **attrs) -> None:
        """Log an already-measured region (explicit timestamps) — for
        overlapping regions a context manager cannot express, e.g. the
        throughput wrapper's concurrent stream processes."""
        if not self.enabled:
            return
        self._append_event({
            "name": name, "cat": cat, "ph": "X",
            "ts_epoch_s": round(t0_epoch, 6),
            "wall_s": round(wall_s, 6),
            "pid": self.pid, "tid": threading.get_ident(),
            "seq": self._next_seq(), "depth": 0,
            "args": attrs,
        })

    def add_time(self, bucket: str, seconds: float) -> None:
        """Attribute seconds to a bucket of the innermost collector on
        this thread (or the process fallback) without opening a span."""
        if not self.enabled:
            return
        stack = self._stack()
        coll = stack[-1].collector if stack else self._fallback_collector
        if coll is not None and coll.buckets is not None:
            coll.buckets[bucket] = coll.buckets.get(bucket, 0.0) + seconds

    def annotate(self, **attrs) -> None:
        """Attach attributes to the innermost collector span on this
        thread (or the process fallback) without opening a span — e.g.
        the engine tagging the enclosing query span with the diagnostic
        code of a runtime fallback.  Last write per key wins; they
        surface in ``query_summaries()`` under ``attrs``."""
        if not self.enabled:
            return
        stack = self._stack()
        coll = stack[-1].collector if stack else self._fallback_collector
        if coll is not None:
            coll.attrs.update(attrs)

    # -- instruments ----------------------------------------------------------

    def inc(self, name: str, value: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    def counters_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def gauges_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.gauges)

    # -- internal -------------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _finish(self, span: Span) -> None:
        ev = {
            "name": span.name, "cat": span.cat, "ph": "X",
            "ts_epoch_s": round(span.t0_epoch, 6),
            "wall_s": round(span.wall_s, 6),
            "pid": self.pid, "tid": span.tid,
            "seq": span.seq, "depth": span.depth,
            "args": span.attrs,
        }
        if span.bucket:
            ev["bucket"] = span.bucket
        if span.collect:
            ev["collect"] = True
            ev["buckets"] = {k: round(v, 6)
                             for k, v in span.buckets.items()}
        self._append_event(ev)

    def _append_event(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    # -- aggregation ----------------------------------------------------------

    def query_summaries(self) -> List[dict]:
        """Finished collector spans of cat='query', with the cold/warm
        classification the HW metrics artifact is built from."""
        with self._lock:
            evs = [e for e in self.events
                   if e.get("collect") and e["cat"] == "query"]
        out = []
        for e in evs:
            b = e.get("buckets", {})
            wall = e["wall_s"]
            compile_s = b.get("compile_s", 0.0)
            execute_s = b.get("execute_s", 0.0)
            out.append({
                "query": e["name"],
                "wall_s": wall,
                "compile_s": round(compile_s, 6),
                "execute_s": round(execute_s, 6),
                "attributed_frac": round(
                    (compile_s + execute_s) / wall, 4) if wall > 0 else 0.0,
                # cold = compile work happened (discovery / jit build /
                # warm-up XLA compile); warm replays have ~zero compile
                "mode": "cold" if compile_s > max(0.05 * wall, 1e-4)
                        else "warm",
                "buckets": dict(b),
                "attrs": dict(e.get("args", {})),
            })
        return out
