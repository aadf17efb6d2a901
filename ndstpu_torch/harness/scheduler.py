"""In-process multi-stream throughput scheduler (shared-engine path).

The port of the JAX package's ``ndstpu/harness/scheduler.py``.

The spec-faithful throughput shape (``--mode process``,
:mod:`ndstpu_torch.harness.throughput`) fans out N OS processes the way
the reference fans out spark-submit drivers: each stream pays its own
warehouse load, its own device tables, and its own discovery and capture
of every query, and on one card each process's tables and graphs take
their own share of its memory.  ``--mode inproc`` runs the same N streams
as worker threads against ONE shared
:class:`~ndstpu_torch.engine.session.Session`:

* the warehouse is loaded once (``--generate SF`` with ``-`` generates it
  once on the device), and the compile records are preloaded once and
  saved once;
* each distinct query text is planned once (the session's per-key
  latch), and each canonical key discovers and captures once: the
  scheduler keys texts by ``Session.canonical_key``, so renderings of one
  template share one compiled entry; a rendering whose binding fails the
  entry's guards rediscovers, as in any run;
* execution is serialized in the session (``Session._exec_lock``: one
  device runs one graph at a time, and no other stream thread works on the
  device while one captures), and device access is gated at query
  granularity by :class:`~ndstpu_torch.harness.admission.InprocAdmission`,
  the same ``slots`` semantics as the file-lock ``DeviceAdmission``;
* streams pick their next query through :class:`StreamScheduler` by the
  run ledger's priors, cheapest-cold-first, so compiles front-load and
  warm replays pack the tail, with ``BudgetedQueue`` budget semantics
  (explicit per-query ``partial_reason`` skips);
* all streams emit into ONE trace (stream id on every query span), one
  metrics sidecar with the ledger's rows and the sentinel's verdicts, and
  one overlap report whose top-level ``max_concurrent`` is the
  device-level peak the admission gate enforced (``<= slots``), beside
  the stream-wall ``concurrency_timeline`` evidence.

* the spine value keys that recur across the streams are flagged and a
  shared spine-materialization cache is installed on the session
  (:func:`_install_spine_cache`): the first stream to reach a flagged
  spine materializes it on the device and the others splice it in.

The continuous-feed mode of :class:`StreamScheduler` (``open_stream``,
``feed``, ``close``) is what the query server drives
(:mod:`ndstpu_torch.serve.server`), one stream a connection; the
throughput run against a server is ``throughput.run_streams_serve``.

Of the engine properties the ``spmd.*`` ones are applied to the inproc
mode's shared session (the JAX package's scheduler.py:361-368; out-of-core
execution, as in the power run); the rest are recorded and applied to
nothing (the JAX package's ``apply_engine_properties`` and its ``jax.*``
settings).  ``--floats`` must be shared by every stream and loads or
generates the shared warehouse with its DECIMAL columns as FLOAT64;
``--static_check`` on any stream runs the power run's gate
(:func:`power.static_check`) over every stream's parts before anything
executes, on every device.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import threading
import time
import traceback
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from ndstpu_torch import faults, obs
from ndstpu_torch.check import check_json_summary_folder
from ndstpu_torch.harness import admission as adm
from ndstpu_torch.harness import power, progress
from ndstpu_torch.io import atomic, loader


class _StreamView:
    """One stream's queue facade over the shared :class:`StreamScheduler`
    — the ``BudgetedQueue`` protocol ``run_stream`` expects
    (``next(elapsed_s)`` / ``projected_s()`` / ``skipped`` /
    ``done(name, failed)``)."""

    def __init__(self, sched: "StreamScheduler", sid: str,
                 names: List[str]):
        self._sched = sched
        self.sid = sid
        self._names = list(names)
        self._order = {n: i for i, n in enumerate(names)}
        self.phase = f"{sched.phase}:{sid}"
        self.budget_s = sched.budget_s
        self.skipped: Dict[str, str] = {}
        self.reordered = False

    # -- cost model: warm prior once ANY stream compiled/queued the text
    def cost(self, name: str) -> float:
        return self._sched._cost(self.sid, name)

    def projected_s(self) -> float:
        with self._sched._lock:
            return sum(self.cost(n) for n in self._names)

    @property
    def remaining(self) -> List[str]:
        with self._sched._lock:
            return list(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def next(self, elapsed_s: float) -> Optional[str]:
        return self._sched._next(self, elapsed_s)

    def done(self, name: str, failed: bool = False) -> None:
        self._sched._done(self.sid, name, failed)


class StreamScheduler:
    """Shared ledger-prior-driven scheduler for N in-process streams.

    Pick order per stream (all under one lock, so streams see each
    other's state):

    1. **cold, not in flight anywhere** — cheapest cold prior first, so
       every stream starts a *different* compile and the expensive
       discoveries front-load across the phase;
    2. **already compiled by any stream** — cheapest warm prior first
       (cheap replays fill the gaps while other streams compile);
    3. **in flight on another stream** — last: by the time the stream
       gets there the text is compiled (or the per-key latch makes the
       wait explicit).

    Budget semantics mirror ``BudgetedQueue``: on projected overrun the
    view logs the reorder event once, and queries that cannot fit are
    skipped with an explicit per-query ``partial_reason``.
    """

    def __init__(self, stream_queries: "Dict[str, Dict[str, str]]",
                 budget_s: Optional[float] = None,
                 est_cold: Optional[Callable[[str],
                                             Optional[float]]] = None,
                 est_warm: Optional[Callable[[str],
                                             Optional[float]]] = None,
                 phase: str = "throughput",
                 default_cost_s: float = progress.DEFAULT_COST_S,
                 on_event: Callable[[str], None] = print,
                 key_fn: Optional[Callable[[str], str]] = None):
        # key_fn maps SQL text -> dedup key.  Default: normalized text.
        # The inproc runner passes Session.canonical_key so streams
        # whose renderings differ only in bindable literals share one
        # compile entry — with text keys each stream's fresh RNG values
        # looked "cold" and the cheapest-cold-first pick order re-paid
        # every compile per stream.
        from ndstpu_torch.engine.sql import normalize_sql_key
        kf = key_fn or normalize_sql_key
        self._kf = kf
        self._lock = threading.RLock()
        # continuous-feed mode (serve layer): open streams may gain
        # work after construction; _next blocks on this condition when
        # an open stream's queue is momentarily empty
        self._cv = threading.Condition(self._lock)
        self._open: set = set()
        self.budget_s = budget_s if budget_s and budget_s > 0 else None
        self.phase = phase
        self.default_cost_s = default_cost_s
        self._est_cold = est_cold
        self._est_warm = est_warm
        self._on_event = on_event
        self.compiled: set = set()    # dedup keys known compiled
        self.inflight: Dict[str, str] = {}  # key -> stream building it
        self._key: Dict[tuple, str] = {}
        self._views: "OrderedDict[str, _StreamView]" = OrderedDict()
        for sid, qd in stream_queries.items():
            for name, sql in qd.items():
                self._key[(sid, name)] = kf(sql)
            self._views[sid] = _StreamView(self, sid, list(qd))

    def view(self, sid: str) -> _StreamView:
        return self._views[sid]

    # -- continuous-feed mode (serve layer) ---------------------------------
    #
    # The batch harness builds the scheduler from fixed per-stream work
    # lists.  A query server instead OPENS a stream per connection,
    # FEEDS it one request at a time, and CLOSES it when the client
    # hangs up; a view whose queue is momentarily empty but still open
    # blocks in next() instead of reporting done.  Cross-stream compile
    # dedup (compiled/inflight keyed by canonical key) works unchanged,
    # so concurrent connections sending the same plan shape share one
    # compile exactly like batch streams do.

    def open_stream(self, sid: str) -> _StreamView:
        """Create (or reopen) a continuously-fed stream."""
        with self._lock:
            if sid not in self._views:
                self._views[sid] = _StreamView(self, sid, [])
            self._open.add(sid)
            return self._views[sid]

    def feed(self, sid: str, name: str, sql: str) -> None:
        """Append one work item to an open stream; wakes its next()."""
        with self._lock:
            if sid not in self._open:
                raise ValueError(f"stream {sid!r} is not open for feed")
            view = self._views[sid]
            self._key[(sid, name)] = self._kf(sql)
            view._order[name] = len(view._order)
            view._names.append(name)
            self._cv.notify_all()

    def close(self, sid: str) -> None:
        """Stop feeding a stream: pending items still drain, then its
        next() returns None instead of blocking."""
        with self._lock:
            self._open.discard(sid)
            self._cv.notify_all()

    # -- internals (called by the views) -------------------------------------

    def _cost(self, sid: str, name: str) -> float:
        key = self._key[(sid, name)]
        warm = key in self.compiled or key in self.inflight
        est = self._est_warm if warm else self._est_cold
        c = est(name) if est else None
        return float(c) if c and c > 0 else self.default_cost_s

    def _class(self, sid: str, name: str) -> int:
        key = self._key[(sid, name)]
        if key in self.compiled:
            return 1
        if self.inflight.get(key) not in (None, sid):
            return 2
        return 0

    def _next(self, view: _StreamView, elapsed_s: float) -> Optional[str]:
        with self._lock:
            # continuous-feed: an open-but-empty stream waits for work
            # (or for close()); batch streams never enter the wait
            while not view._names and view.sid in self._open:
                self._cv.wait(timeout=0.5)
            if not view._names:
                return None
            if self.budget_s is not None:
                left = self.budget_s - elapsed_s
                projected = sum(view.cost(n) for n in view._names)
                if projected > left and not view.reordered:
                    view.reordered = True
                    self._on_event(
                        f"[budget] {view.phase}: projected "
                        f"{projected:.1f}s exceeds remaining "
                        f"{left:.1f}s of {self.budget_s:g}s budget - "
                        f"scheduling {len(view._names)} remaining "
                        f"queries cheapest-first (ledger priors)")
                    obs.inc("harness.budget.reordered")
                if left <= 0:
                    self._skip_all(view, lambda n: (
                        f"budget exhausted: {elapsed_s:.1f}s elapsed "
                        f">= {self.budget_s:g}s {view.phase} budget"))
                    return None
            pick = min(view._names,
                       key=lambda n: (self._class(view.sid, n),
                                      view.cost(n), view._order[n]))
            if self.budget_s is not None and \
                    view.cost(pick) > left:
                # cheapest-first means: if the cheapest remaining query
                # does not fit, nothing costlier will either
                self._skip_all(view, lambda n: (
                    f"budget: prior {view.cost(n):.2f}s exceeds "
                    f"remaining {left:.1f}s of {self.budget_s:g}s "
                    f"{view.phase} budget"))
                return None
            view._names.remove(pick)
            key = self._key[(view.sid, pick)]
            if key not in self.compiled:
                self.inflight.setdefault(key, view.sid)
            return pick

    def _done(self, sid: str, name: str, failed: bool) -> None:
        with self._lock:
            key = self._key[(sid, name)]
            if self.inflight.get(key) == sid:
                del self.inflight[key]
            if not failed:
                # a FAILED query must not publish its text as compiled:
                # other streams keep their own (cold) estimate and the
                # shared caches hold nothing for it (the engine only
                # caches successful plans/programs)
                self.compiled.add(key)

    def _skip_all(self, view: _StreamView,
                  reason_for: Callable[[str], str]) -> None:
        for n in view._names:
            view.skipped[n] = reason_for(n)
        if view._names:
            self._on_event(
                f"[budget] {view.phase}: cutting {len(view._names)} "
                f"queries ({', '.join(view._names[:8])}"
                + ("..." if len(view._names) > 8 else "")
                + ") - per-query partial_reason recorded in the report")
        view._names = []


@dataclasses.dataclass
class InprocRun:
    """Result of one in-process throughput phase (also the test hook:
    the shared session/scheduler/gate stay inspectable)."""
    rc: int
    records: List[dict]
    overlap: dict
    results: Dict[str, dict]
    errors: Dict[str, str]
    session: object
    scheduler: StreamScheduler
    gate: adm.InprocAdmission


def _power_tail(cmd_template: List[str]) -> List[str]:
    """The wrapped command must be an invocation of the port's power
    CLI; return its argv tail (everything after the module name)."""
    for i, a in enumerate(cmd_template):
        if a == "ndstpu_torch.harness.power":
            return list(cmd_template[i + 1:])
    raise ValueError(
        "--mode inproc requires the wrapped command to be "
        "`... -m ndstpu_torch.harness.power <args>` (the scheduler reuses "
        "the power CLI's argument contract in-process); got: "
        + " ".join(cmd_template))


def run_streams_inproc(stream_ids: List[str], cmd_template: List[str],
                       concurrent: Optional[int] = None,
                       budget_s: Optional[float] = None,
                       overlap_report: Optional[str] = None
                       ) -> InprocRun:
    """Run N query streams as threads over one shared Session.

    ``cmd_template`` is the same ``{}``-placeholder power command the
    process mode would Popen; it is parsed per stream with the power
    CLI's own parser so both modes share one argument contract.
    """
    from ndstpu_torch.engine.torchexec import resolve_device
    from ndstpu_torch.harness import throughput as tp

    tail = _power_tail(cmd_template)
    streams: "OrderedDict[str, object]" = OrderedDict()
    for sid in stream_ids:
        streams[sid] = power.parse_args(
            [a.replace("{}", sid) for a in tail])
    ns0 = next(iter(streams.values()))
    # the whole point is ONE engine: refuse stream templates that
    # resolve to different warehouses/devices instead of guessing
    for flag in ("input_prefix", "generate", "generate_seed", "device",
                 "input_format", "floats", "property_file", "property",
                 "compile_records"):
        vals = {str(getattr(ns, flag, None)) for ns in streams.values()}
        if len(vals) > 1:
            raise ValueError(
                f"inproc streams must share one {flag}; the {{}} "
                f"placeholder resolved to {sorted(map(str, vals))}")

    t0 = time.time()
    # no card and no --device cpu raises here, before anything runs
    device = resolve_device(ns0.device)
    if any(ns.output_prefix for ns in streams.values()):
        loader._pyarrow()   # writing outputs needs pyarrow: refuse now
    engine_conf = power.engine_properties(ns0)
    spmd = power.spmd_settings(engine_conf)
    engine_conf.setdefault("device", ns0.device)
    engine_conf.setdefault("input_format", ns0.input_format)
    engine_conf.setdefault("throughput_mode", "inproc")
    if ns0.floats:
        engine_conf.setdefault("floats", "true")

    # shared context: ONE catalog load / session / set of device tables
    # for all streams (vs one per process in --mode process)
    load_start = time.time()
    with obs.span("load_catalog", cat="phase"):
        session = power.Session(
            power._load(ns0, device, "spmd_chunk_rows" in spmd),
            device=device, **spmd)
    load_ms = int((time.time() - load_start) * 1000)
    if ns0.compile_records:
        obs.set_gauge("harness.compile_records.present",
                      1 if os.path.exists(ns0.compile_records) else 0)
        try:
            with obs.span("preload_compile_records", cat="phase"):
                n = session.preload_compiled(ns0.compile_records)
            obs.inc("harness.compile_records.preloaded", n)
            print(f"preloaded {n} compile records (shared)")
        except Exception as e:  # stale records must never kill the run
            print(f"WARNING: compile records not loaded: {e}")

    # per-stream query dicts (+ the power CLI's folder/subset checks)
    stream_queries: "OrderedDict[str, OrderedDict]" = OrderedDict()
    for sid, ns in streams.items():
        qd = power.gen_sql_from_stream(ns.query_stream_file)
        if ns.sub_queries:
            qd = power.get_query_subset(qd, ns.sub_queries.split(","))
        stream_queries[sid] = qd
    for folder in {ns.json_summary_folder for ns in streams.values()}:
        check_json_summary_folder(folder)

    if any(ns.static_check for ns in streams.values()):
        merged: "OrderedDict[str, str]" = OrderedDict()
        for qd in stream_queries.values():
            merged.update(qd)
        with obs.span("static_check", cat="phase"):
            offenders = power.static_check(
                session, merged, ns0.device,
                scale_factor=ns0.scale_factor)
        if offenders:
            raise SystemExit(
                "static check failed: query part(s) "
                f"{', '.join(offenders)} cannot lower on {ns0.device}")

    # ledger priors drive the cheapest-cold-first pick order; the port
    # discovers on either device, so a key's first run is cold unless
    # compile records exist
    led = power.open_ledger(ns0.ledger)
    engine = power.ledger_engine(device)
    if budget_s is None:
        budget_s = ns0.budget_s if ns0.budget_s and ns0.budget_s > 0 \
            else None
    warm_records = bool(ns0.compile_records and
                        os.path.exists(ns0.compile_records))
    est_cold = progress.ledger_estimator(
        led, engine=engine, scale_factor=ns0.scale_factor,
        warmth="warm" if warm_records else "cold")
    est_warm = progress.ledger_estimator(
        led, engine=engine, scale_factor=ns0.scale_factor, warmth="warm")
    sched = StreamScheduler(
        {sid: dict(qd) for sid, qd in stream_queries.items()},
        budget_s=budget_s, est_cold=est_cold, est_warm=est_warm,
        key_fn=session.canonical_key)
    _install_spine_cache(session, stream_queries)

    slots = concurrent if concurrent else 1
    gate = adm.InprocAdmission(slots)

    results: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    records: List[dict] = []
    rec_lock = threading.Lock()

    # shared across all stream threads: a query key poisoned in one
    # stream is quarantined for every other stream too (they run the
    # same permuted query set against one shared session)
    retry_policy = faults.RetryPolicy.from_env()
    quarantine = faults.Quarantine()

    def worker(sid: str, ns, qd) -> None:
        stream_name = os.path.splitext(
            os.path.basename(ns.query_stream_file))[0]
        hb = progress.Heartbeat(f"throughput:{sid}", total=len(qd),
                                budget_s=budget_s)
        if ns.json_summary_folder and ns.property_file:
            summary_prefix = os.path.join(
                ns.json_summary_folder,
                os.path.basename(ns.property_file).split(".")[0])
        else:
            summary_prefix = os.path.join(
                ns.json_summary_folder or "", "")

        def runner(sql, name):
            power.run_one_query(session, sql, name, ns.output_prefix,
                                ns.output_format)

        obs.inc("harness.throughput.streams_launched")
        start = time.time()
        code = 0
        try:
            faults.check("stream.worker", key=sid)
            res = power.run_stream(
                qd, queue=sched.view(sid), runner=runner, heartbeat=hb,
                engine=ns.device, stream_name=stream_name,
                engine_conf=engine_conf, gate=gate,
                json_summary_folder=ns.json_summary_folder,
                summary_prefix=summary_prefix, t0=t0,
                span_attrs={"stream": stream_name, "stream_id": sid,
                            "mode": "inproc"},
                retry_policy=retry_policy, quarantine=quarantine)
            results[sid] = res
            _write_stream_time_log(ns, res, load_ms, t0)
        except Exception as e:  # noqa: BLE001 — one stream's crash
            # must not take down the others
            traceback.print_exc()
            errors[sid] = f"{type(e).__name__}: {e}"
            obs.inc("harness.throughput.streams_failed")
            code = 1
        end = time.time()
        with rec_lock:
            rec = {
                "stream": sid,
                "start_epoch_s": round(start, 3),
                "end_epoch_s": round(end, 3),
                "wall_s": round(end - start, 3),
                "returncode": code,
            }
            res = results.get(sid)
            if res is not None:
                rec["executed"] = len(res["executed"])
                rec["failures"] = res["failures"]
                rec["skipped"] = len(res["skipped"])
            records.append(rec)

    threads = [threading.Thread(
        target=worker, args=(sid, ns, stream_queries[sid]),
        name=f"stream-{sid}", daemon=True)
        for sid, ns in streams.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()

    if ns0.compile_records:
        try:
            session.save_compiled(ns0.compile_records)
        except Exception as e:
            print(f"WARNING: compile records not saved: {e}")

    rc = 1 if errors else 0
    device_tl = gate.device_timeline()
    # top-level max_concurrent is what the admission gate ENFORCED at
    # the device (<= slots by construction); the stream-wall sweep —
    # which overlaps up to N streams, that being the point of the
    # shared engine — stays as stream_max_concurrent
    overlap_doc = tp.write_overlap_report(
        overlap_report, records, slots, budget_s, mode="inproc",
        extra={"max_concurrent": device_tl["max_concurrent"],
               "device_timeline": device_tl,
               "shared_load_ms": load_ms,
               "errors": errors or None})
    obs.set_gauge("harness.throughput.device_max_concurrent",
                  device_tl["max_concurrent"])

    _export_inproc_run(streams, results, errors, records, overlap_doc,
                       overlap_report, led, engine, budget_s, t0)
    return InprocRun(rc=rc, records=records, overlap=overlap_doc,
                     results=results, errors=errors, session=session,
                     scheduler=sched, gate=gate)


def _install_spine_cache(session, stream_queries) -> None:
    """Flag the spine value-keys that recur across this phase's streams
    and install the shared materialization cache on the session
    (engine/spine.py).  Planning already happened — the StreamScheduler
    constructor ran every text through ``session.canonical_key`` — so
    counting candidates here reuses the plan + spine-site memos.  A key
    occurring once shares with nobody and is not worth publishing.
    NDSTPU_SPINES=0 disables; any defect degrades to no sharing.

    On a card the spines and the captured graphs share one budget, half
    the free device memory (``CompilingExecutor.cache_budget``): the
    graphs are evicted to make room for the spines' bytes, and the spine
    cache itself takes at most half of it (unless
    NDSTPU_SPINE_BUDGET_BYTES pins its budget), so the graphs keep at
    least a quarter of the free memory and the eager runs the other
    half."""
    from ndstpu_torch.engine import spine as spine_mod
    if not spine_mod.enabled():
        return
    try:
        counts: Dict[str, int] = {}
        for qd in stream_queries.values():
            for sql in qd.values():
                for vk in session.spine_candidate_keys(sql):
                    counts[vk] = counts.get(vk, 0) + 1
        flagged = {vk for vk, n in counts.items() if n >= 2}
        if not flagged:
            return
        budget, source = spine_mod.runtime_budget_bytes(session.device)
        if source != "env" and session.device.type == "cuda":
            budget = min(budget, session.executor.cache_budget() // 2)
            source += ", half the graph budget"
        session.install_spine_cache(spine_mod.SpineCache(budget, flagged))
        obs.set_gauge("engine.spine.flagged", len(flagged))
        obs.set_gauge("engine.spine.budget_bytes", budget)
        print(f"[spine] {len(flagged)} shared spine(s) flagged across "
              f"{len(stream_queries)} streams "
              f"(budget {budget >> 20}MiB/{source})")
    except Exception as e:  # noqa: BLE001 — sharing is an optimization
        print(f"WARNING: spine cache not installed: {e}")


def _write_stream_time_log(ns, res: dict, load_ms: int,
                           t0: float) -> None:
    """Per-stream CSV time log with the same row contract as the power
    CLI (bench.get_throughput_time parses the Power Start/End rows), so
    the bench driver's throughput-elapsed math is mode-agnostic."""
    app_id = res["app_id"]
    rows = [(app_id, "CreateTempView all tables (shared)", load_ms)]
    rows.extend(res["rows"])
    power_start = int(res["start_epoch_s"])
    power_end = int(res["end_epoch_s"])
    rows.append((app_id, "Power Start Time", power_start))
    rows.append((app_id, "Power End Time", power_end))
    rows.append((app_id, "Power Test Time",
                 int((res["end_epoch_s"] - res["start_epoch_s"]) * 1000)))
    rows.append((app_id, "Total Time",
                 int((res["end_epoch_s"] - t0) * 1000)))
    header = ["application_id", "query", "time/milliseconds"]
    for path in (ns.time_log, ns.extra_time_log):
        if not path:
            continue
        with atomic.atomic_writer(path, "w", encoding="UTF8",
                                  newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)


def _merge_taxonomy(results: Dict[str, dict]) -> dict:
    """Phase-level failure taxonomy: per-class counts summed across
    streams plus the per-(stream, query) class map."""
    counts: Dict[str, int] = {}
    queries: Dict[str, str] = {}
    for sid, res in results.items():
        tx = res.get("taxonomy") or {}
        for klass, n in (tx.get("counts") or {}).items():
            counts[klass] = counts.get(klass, 0) + n
        for qname, klass in (tx.get("queries") or {}).items():
            queries[f"{sid}:{qname}"] = klass
    return {"counts": counts, "queries": queries}


def _export_inproc_run(streams, results, errors, records, overlap_doc,
                       overlap_report, led, engine, budget_s, t0) -> None:
    """ONE trace + ONE metrics sidecar for the whole phase (process
    mode writes one per stream subprocess), plus stream-tagged ledger
    rows and the sentinel verdict."""
    if not obs.enabled():
        return
    ns0 = next(iter(streams.values()))
    trace_dir = os.environ.get("NDSTPU_TRACE_DIR") or \
        (os.path.dirname(overlap_report or ns0.time_log) or ".")
    base = os.path.basename(overlap_report) if overlap_report \
        else "throughput_inproc"
    executed = {sid: set(res["executed"])
                for sid, res in results.items()}
    by_stream_name = {}
    for sid, ns in streams.items():
        stem = os.path.splitext(
            os.path.basename(ns.query_stream_file))[0]
        by_stream_name[stem] = sid
    qsums = []
    for q in obs.tracer().query_summaries():
        attrs = q.get("attrs") or {}
        sid = attrs.get("stream_id") or \
            by_stream_name.get(attrs.get("stream"))
        if sid is not None and q["query"] in executed.get(sid, ()):
            qsums.append(q)
    ledger_block, sentinel_block = power.record_run(
        led, qsums, engine=engine, scale_factor=ns0.scale_factor,
        seed=ns0.run_seed, source=base, extra={"mode": "inproc"})
    try:
        paths = obs.export_run(trace_dir, base)
        sidecar = os.path.join(trace_dir, base + ".metrics.json")
        with atomic.atomic_writer(sidecar, "w") as f:
            json.dump(obs.run_metrics({
                "mode": "inproc",
                "engine": ns0.device,
                "streams": records,
                "stream_apps": {sid: res["app_id"]
                                for sid, res in results.items()},
                "errors": errors or None,
                "budget_s": budget_s,
                "partial": any(res["skipped"]
                               for res in results.values()),
                "partial_reasons": {sid: res["skipped"]
                                    for sid, res in results.items()
                                    if res["skipped"]},
                "faultTaxonomy": _merge_taxonomy(results),
                "quarantined": next(
                    (res["quarantined"] for res in results.values()
                     if res.get("quarantined")), None),
                "overlap": {k: overlap_doc[k] for k in
                            ("max_concurrent", "stream_max_concurrent",
                             "admission_slots",
                             "total_pairwise_overlap_s")
                            if k in overlap_doc},
                "total_elapse_ms": int((time.time() - t0) * 1000),
                "ledger": ledger_block,
                "sentinel": sentinel_block,
            }), f, indent=2)
        print(f"====== Trace: {paths['jsonl']} | {paths['chrome']} "
              f"| {sidecar} ======")
    except Exception as e:  # observability must never fail the run
        print(f"WARNING: trace export failed: {e}")
