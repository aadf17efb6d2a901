"""Power run: execute a query stream serially on the port's engine, timed.

The port of the JAX package's ``ndstpu/harness/power.py``::

    python -m ndstpu_torch.harness.power <stream file> <warehouse> <time log>

runs one query stream (``query_N.sql``, as ``python -m
ndstpu_torch.queries.streamgen`` writes it) through
``ndstpu_torch.engine.session.Session.sql`` on ``cuda``, or on the CPU with
``--device cpu``, and writes what the JAX command writes: the
``application_id,query,time/milliseconds`` CSV time log with its
``CreateTempView all tables`` row, one row a query and the ``Power
Start/End Time``, ``Power Test Time`` and ``Total Time`` rows; per-query
JSON summaries (``--json_summary_folder``); the ``<time_log>.progress.jsonl``
resume journal; and, with tracing on (``NDSTPU_TRACE``, default on), the
run's traces and the ``<time_log>.metrics.json`` sidecar.  Transient
failures retry and a key that keeps failing is quarantined
(``ndstpu_torch.faults``); ``--resume`` skips the queries a killed run of
the same fingerprint finished; ``--budget_s`` cuts the stream explicitly;
``--compile_records`` preloads the size plans a previous run saved (its
first run of a key then captures without discovering) and saves this run's;
on the card each query runs under a watchdog thread
(``NDSTPU_POWER_QUERY_TIMEOUT_S``, 1,200 s; on the CPU only when it is set)
and a hung query is abandoned, the stream going on in a fresh session that
shares the device tables.

The load phase.  Given a warehouse directory, the tables are read from the
files ``python -m ndstpu.io.transcode`` writes (``ndstpu_torch.io.loader``,
which needs pyarrow).  The H100's machine has no pyarrow, so there the
warehouse comes from the port's generator instead: ``--generate SF`` (and
``--generate_seed N``, default 1) with ``-`` for the warehouse generates
every table on the device (``ndstpu_torch.datagen.generate``) and registers
it, and ``--scale_factor`` and ``--run_seed`` take their values from those
flags.  That is the port's counterpart of the JAX package's datagen,
transcode and ``load_catalog`` chain on a machine without pyarrow, not a
new feature.  Either way the load is timed as ``CreateTempView all
tables``, after a device synchronise.

Without ``--output_prefix`` a query ends with its result on the host
(``Session.sql`` reads it back once); with one, each result is written as
Parquet or CSV through pyarrow, and without pyarrow the run refuses to
start.

The run ledger (``--ledger``, default ``$NDSTPU_LEDGER`` or
``.bench_cache/ledger.jsonl``, ``none`` to turn it off;
:mod:`ndstpu_torch.obs.ledger`) gives each query its prior, which orders a
budget cut and the heartbeat's ETA; after the stream the regression
sentinel (:mod:`ndstpu_torch.obs.sentinel`) judges every query against the
ledger as it stood before the run, the run's rows are appended under the
engine ``torch-<device type>``, and the sidecar carries both.

Out-of-core execution: the engine properties ``spmd.chunk_rows`` (rows,
or ``auto``), ``spmd.prefetch_depth`` and ``spmd.threshold_rows`` (from
``--property_file`` or ``--property KEY=VALUE``, as the JAX package's
:452-477) set the session's ``spmd_*`` fields, which carry across the
watchdog's session rebuild.  With ``spmd.chunk_rows`` set, ``--generate``
keeps the seven fact tables in host memory (``datagen.generate(...,
host_facts=True)``), and queries stream them through the card.

``--floats`` runs the reference benchmark's decimals-as-doubles
configuration: the warehouse is read with the FLOAT64 schemas
(``transcode --floats``'s files) or generated with every DECIMAL column as
FLOAT64 (``datagen.generate(..., use_decimal=False)``), and the summaries'
engine settings record ``floats``.  ``--static_check`` runs the static
analyzer (:mod:`ndstpu_torch.analysis`) over the stream before anything
executes and refuses a stream with an error-severity diagnostic
(:func:`static_check`).  The JAX command skips the gate on its ``cpu``
engine, a numpy interpreter that lowers everything; the port's ``--device
cpu`` runs the card's executor, so the gate holds on both devices.

Not accepted here: ``--xla_cache_dir`` (the XLA compile cache has no
counterpart).  ``jax.*`` engine properties are recorded in the summaries
and applied to nothing.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional

from ndstpu_torch import faults, obs
from ndstpu_torch.check import (check_json_summary_folder,
                                check_query_subset_exists)
from ndstpu_torch.engine import columnar
from ndstpu_torch.engine.session import Session, abandonable
from ndstpu_torch.harness import admission, progress
from ndstpu_torch.harness.report import BenchReport
from ndstpu_torch.io import atomic, loader
from ndstpu_torch.obs import ledger as ledger_mod
from ndstpu_torch.obs import sentinel
from ndstpu_torch.queries.statements import _sql_statements

# One `-- start query N in stream M using template queryX.tpl` marker
# opens each query block (the spark.tpl dialect contract the stream
# generator reproduces; cf. reference nds_power.py:49-76).
_STREAM_MARKER = re.compile(
    r"^--\s*start\s+query\s+\d+\s+in\s+stream\s+\d+\s+using\s+template\s+"
    r"(?P<name>\w+)\.tpl\s*$",
    re.MULTILINE | re.IGNORECASE)


def gen_sql_from_stream(query_stream_file_path: str) -> "OrderedDict[str, str]":
    """Split a stream file into {query_name: sql}, splitting the
    multi-statement templates (14/23/24/39) into `_part1`/`_part2`
    entries (contract: nds_power.py:49-76)."""
    with open(query_stream_file_path) as f:
        text = f.read()
    markers = list(_STREAM_MARKER.finditer(text))
    queries: "OrderedDict[str, str]" = OrderedDict()
    for marker, nxt in zip(markers, markers[1:] + [None]):
        name = marker.group("name")
        block_end = nxt.start() if nxt is not None else len(text)
        body = text[marker.end():block_end]
        stmts = _sql_statements(body)
        if len(stmts) > 1:
            for k, stmt in enumerate(stmts, start=1):
                queries[f"{name}_part{k}"] = stmt + ";"
        else:
            # single-statement: keep the whole block, markers included
            queries[name] = text[marker.start():block_end]
    return queries


def ensure_valid_column_names(table: columnar.Table) -> columnar.Table:
    """Sanitize output column names for file formats
    (reference: nds_power.py:136-173)."""
    def ok(name: str) -> bool:
        return re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name) is not None

    cols = {}
    for i, (n, c) in enumerate(table.columns.items()):
        cols[n if ok(n) else f"column_{i}"] = c
    return columnar.Table(cols)


def get_query_subset(query_dict, subset: List[str]):
    check_query_subset_exists(query_dict, subset)
    return OrderedDict((q, query_dict[q]) for q in subset)


def static_check(sess: Session, query_dict, device,
                 scale_factor=None) -> List[str]:
    """``--static_check`` gate (the JAX package's ``static_check``): run
    the static analyzer over every queued query (plan only: no data, no
    device) and return the queries with error-severity diagnostics
    outside a subquery, printing each diagnostic's code and plan
    location.  A part the planner refuses gates too (``NDS000``).  The
    analyzer reads the decimal schemas, under ``--floats`` too, as the
    JAX package's does.  ``device`` is named for the record: the port
    runs one executor on every device, so every device gates."""
    from ndstpu_torch import analysis

    try:
        sf = float(scale_factor)
    except (TypeError, ValueError):
        sf = None
    tables = analysis.schema_tables()
    offenders: List[str] = []
    for name, sql in query_dict.items():
        try:
            plan, _cols = sess.plan(sql)
        except Exception as e:  # noqa: BLE001 — the run would die on it
            offenders.append(name)
            print(f"STATIC CHECK {name}: NDS000 at plan: {e}")
            continue
        try:
            res = analysis.analyze_plan(plan, tables=tables, query=name,
                                        scale_factor=sf)
        except Exception as e:  # noqa: BLE001 — analyzer gaps never gate
            print(f"WARNING: static check could not analyze {name}: {e}")
            continue
        gating = [d for d in res.diagnostics if d.severity == "error"
                  and "/subquery[" not in d.path]
        if gating:
            offenders.append(name)
            for d in gating:
                print(f"STATIC CHECK {name}: {d.code} at {d.path}: "
                      f"{d.message}")
    return offenders


def run_one_query(session: Session, query: str, query_name: str,
                  output_path: Optional[str], output_format: str) -> None:
    # Session.sql returns the result on the host, after one read-back
    # that waits for the device: the collect() analog
    result = session.sql(query)
    obs.annotate(result_rows=int(result.num_rows))
    if not output_path:
        return
    out = ensure_valid_column_names(result)
    dest = os.path.join(output_path, query_name)
    os.makedirs(dest, exist_ok=True)
    at = columnar.to_arrow(out)
    if output_format == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(at, os.path.join(dest, "part-0.parquet"))
    elif output_format == "csv":
        import pyarrow.csv as pacsv
        pacsv.write_csv(at, os.path.join(dest, "part-0.csv"))
    else:
        raise ValueError(f"unsupported output format {output_format}")


def load_properties(filename: str) -> Dict[str, str]:
    """java-properties style engine config (reference: nds_power.py:306-312)."""
    props = {}
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                props[k.strip()] = v.strip()
    return props


def engine_properties(args) -> Dict[str, str]:
    """The run's engine properties: ``--property_file``, then each
    ``--property KEY=VALUE`` (a later one wins)."""
    props: Dict[str, str] = {}
    if getattr(args, "property_file", None):
        props.update(load_properties(args.property_file))
    for kv in getattr(args, "property", None) or ():
        k, _, v = kv.partition("=")
        props[k.strip()] = v.strip()
    return props


def spmd_settings(engine_conf: Dict[str, str]) -> Dict[str, object]:
    """The session's out-of-core fields from the ``spmd.*`` engine
    properties (the JAX package's power.py:471-477)."""
    out: Dict[str, object] = {}
    if engine_conf.get("spmd.threshold_rows"):
        out["spmd_threshold"] = int(engine_conf["spmd.threshold_rows"])
    if engine_conf.get("spmd.chunk_rows"):
        raw = engine_conf["spmd.chunk_rows"]
        out["spmd_chunk_rows"] = raw if raw == "auto" else int(raw)
    if engine_conf.get("spmd.prefetch_depth"):
        out["spmd_prefetch_depth"] = int(engine_conf["spmd.prefetch_depth"])
    return out


def run_stream(query_dict, *, queue, runner,
               heartbeat: Optional[progress.Heartbeat] = None,
               engine: str = "cuda", app_id: Optional[str] = None,
               stream_name: str = "stream",
               engine_conf: Optional[Dict[str, str]] = None,
               gate=None, pre_query=None, post_query=None,
               json_summary_folder: Optional[str] = None,
               summary_prefix: str = "",
               t0: Optional[float] = None,
               span_attrs: Optional[dict] = None,
               retry_policy: Optional[faults.RetryPolicy] = None,
               quarantine: Optional[faults.Quarantine] = None,
               completed: Optional[set] = None) -> dict:
    """Run one query stream's per-query loop against an already-built
    execution context (the JAX package's ``run_stream``, less its XLA
    compile-cache gauges).

    * ``queue``      — BudgetedQueue: needs ``next(elapsed_s)``,
      ``projected_s()``, ``skipped``; an optional ``done(name,
      failed=...)`` is called after each query.
    * ``runner``     — ``runner(sql, query_name)`` executes one query
      (the CLI passes its watchdog-guarded closure).
    * ``gate``       — admission with ``acquire()``/``release()``, or None.
    * ``pre_query``  — optional hook returning a dict merged into the
      query summary (the CLI's zombie-thread bookkeeping).
    * ``post_query`` — optional ``post_query(name, summary, failed)``
      hook called after each query completes or fails (the resume
      journal appends its per-query record here).
    * ``retry_policy`` / ``quarantine`` — failure handling
      (ndstpu_torch/faults/retry.py): transient failures retry with
      bounded deterministic backoff; a key that keeps failing is
      quarantined and later occurrences skip with an explicit
      ``partial_reason``.
    * ``completed``  — query names already finished by a previous run
      of the same fingerprint (crash-safe resume); skipped up front
      and reported under ``resumed``.

    Returns ``{"app_id", "rows", "executed", "skipped", "failures",
    "start_epoch_s", "end_epoch_s", "taxonomy", "quarantined",
    "resumed"}`` where ``rows`` are ``(app_id, query, millis)``
    time-log tuples.
    """
    t0 = time.time() if t0 is None else t0
    app_id = app_id or f"ndstpu-{uuid.uuid4().hex[:12]}"
    engine_conf = engine_conf or {}
    mark_done = getattr(queue, "done", None)
    rows: List[tuple] = []
    executed: List[str] = []
    failures = 0
    taxonomy_counts: Dict[str, int] = {}
    taxonomy_queries: Dict[str, str] = {}
    resumed: List[str] = []
    base_runner = runner
    if retry_policy is not None or quarantine is not None:
        # run_with_retry classifies + annotates even at max_attempts=1
        def runner(sql, qname):  # noqa: F811 — deliberate shadowing
            faults.run_with_retry(lambda: base_runner(sql, qname),
                                  qname, policy=retry_policy,
                                  quarantine=quarantine)
    start_epoch = time.time()
    stream_span = obs.span(stream_name, cat="stream", collect=True,
                           engine=engine, n_queries=len(query_dict),
                           **(span_attrs or {}))
    stream_span.__enter__()
    try:
        while True:
            query_name = queue.next(time.time() - t0)
            if query_name is None:
                break
            if completed and query_name in completed:
                # crash-safe resume: finished by a previous run of the
                # same fingerprint — skip without touching the engine
                print(f"====== Skip {query_name} (resume: already "
                      f"completed) ======")
                resumed.append(query_name)
                if mark_done is not None:
                    mark_done(query_name, failed=False)
                continue
            if quarantine is not None and \
                    quarantine.is_quarantined(query_name):
                reason = quarantine.reason(query_name)
                print(f"====== Skip {query_name} ({reason}) ======")
                queue.skipped[query_name] = reason
                obs.inc("harness.quarantine.skips")
                if mark_done is not None:
                    mark_done(query_name, failed=True)
                continue
            q_content = query_dict[query_name]
            if heartbeat is not None:
                heartbeat.beat(len(executed) + 1, query_name,
                               time.time() - t0,
                               eta_s=queue.projected_s())
            print(f"====== Run {query_name} ======")
            summary_extra = pre_query(query_name) if pre_query else None
            q_report = BenchReport(engine_conf)
            # the gate sits outside report_on, so queryTimes is pure
            # execution and the wait is reported apart (admissionWaitMs)
            wait_ms = 0
            if gate is not None:
                wait_start = time.time()
                gate.acquire()
                wait_ms = int((time.time() - wait_start) * 1000)
            try:
                summary = q_report.report_on(runner, q_content,
                                             query_name,
                                             query_name=query_name,
                                             span_attrs=span_attrs)
            finally:
                if gate is not None:
                    gate.release()
            if gate is not None:
                summary["admissionWaitMs"] = wait_ms
            if summary_extra:
                summary.update(summary_extra)
            failed = bool(summary["queryStatus"]) and \
                summary["queryStatus"][-1] == "Failed"
            if failed:
                failures += 1
                for tx in summary.get("failureTaxonomy", []):
                    if tx.get("query") == query_name:
                        taxonomy_counts[tx["class"]] = \
                            taxonomy_counts.get(tx["class"], 0) + 1
                        taxonomy_queries[query_name] = tx["class"]
            if mark_done is not None:
                mark_done(query_name, failed=failed)
            print(f"Time taken: {summary['queryTimes']} millis for "
                  f"{query_name}")
            rows.append((app_id, query_name, summary["queryTimes"][0]))
            if json_summary_folder:
                q_report.write_summary(query_name,
                                       prefix=summary_prefix)
            executed.append(query_name)
            if post_query is not None:
                post_query(query_name, summary, failed)
    finally:
        stream_span.__exit__(None, None, None)
    if queue.skipped:
        budget = getattr(queue, "budget_s", None)
        print(f"WARNING: {getattr(queue, 'phase', 'run')} run partial "
              f"- {len(queue.skipped)} queries cut by the "
              f"{budget:g}s budget; per-query partial_reason recorded "
              f"in the metrics sidecar" if budget else
              f"WARNING: {len(queue.skipped)} queries skipped")
        obs.inc("harness.budget.queries_skipped", len(queue.skipped))
    return {
        "app_id": app_id,
        "rows": rows,
        "executed": executed,
        "skipped": dict(queue.skipped),
        "failures": failures,
        "taxonomy": {"counts": taxonomy_counts,
                     "queries": taxonomy_queries},
        "quarantined": quarantine.snapshot() if quarantine else {},
        "resumed": resumed,
        "start_epoch_s": start_epoch,
        "end_epoch_s": time.time(),
    }


def power_fingerprint(args) -> str:
    """Identity of a power run for crash-safe resume: two runs with the
    same fingerprint execute the same queries against the same data, so
    a query completed by one needn't re-run in the other."""
    import hashlib
    parts = [
        str(getattr(args, "device", "")),
        "floats" if getattr(args, "floats", False) else "decimal",
        str(getattr(args, "scale_factor", "")),
        str(getattr(args, "run_seed", "")),
        os.path.basename(getattr(args, "query_stream_file", "") or ""),
        str(getattr(args, "sub_queries", "") or ""),
        os.path.abspath(getattr(args, "input_prefix", "") or ""),
    ]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _load(args, device, host_facts: bool = False):
    """The load phase's catalog: generated on ``device`` with
    ``--generate`` (the fact tables in host memory with ``host_facts``),
    read from the warehouse's files otherwise; its DECIMAL columns as
    FLOAT64 with ``--floats``."""
    use_decimal = not getattr(args, "floats", False)
    if args.generate is None:
        return loader.load_catalog(args.input_prefix,
                                   use_decimal=use_decimal)
    import torch

    from ndstpu_torch import datagen
    catalog = datagen.generate(args.generate, args.generate_seed, device,
                               host_facts=host_facts,
                               use_decimal=use_decimal)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return catalog


def ledger_engine(device) -> str:
    """The engine name of the port's ledger rows: ``torch-`` and the
    device type.  The JAX package's engines are ``tpu``, ``tpu-spmd``
    and ``cpu``, so neither package takes the other's priors."""
    return f"torch-{device.type}"


def open_ledger(path: Optional[str]):
    """The run ledger at ``path`` (None: ``ledger.default_path()``;
    ``none``: no ledger), or None; a corrupt ledger warns and never
    fails the run."""
    if path is None:
        path = ledger_mod.default_path()
    if not path or path.lower() == "none":
        return None
    try:
        return ledger_mod.Ledger(path)
    except Exception as e:  # noqa: BLE001 — a bad ledger must not stop a run
        print(f"WARNING: ledger {path} not loaded: {e}")
        return None


def record_run(led, qsums: List[dict], *, engine: str, scale_factor,
               seed, source: str, extra: Dict[str, object]):
    """The regression sentinel's verdicts on ``qsums`` (the tracer's
    per-query summaries of the queries a run executed) against the ledger
    as it stands, then one ledger row for each query that did not fail:
    ``(ledger block, sentinel block)`` for the sidecar, both None without
    a ledger or a query.  The port reads no lake, so no row carries a
    snapshot epoch.  ``extra`` goes into every row's ``extra``, with the
    query's ``stream``, ``retry_attempts`` and ``result_rows`` where the
    run recorded them.  A failure warns and never fails the run."""
    if led is None or not qsums:
        return None, None
    try:
        verdicts = sentinel.classify_run(qsums, led, engine=engine,
                                         scale_factor=scale_factor)
        entries = []
        for q in qsums:
            attrs = q.get("attrs") or {}
            if attrs.get("error"):
                continue
            row_extra = dict(extra)
            for k in ("stream", "retry_attempts", "result_rows"):
                if attrs.get(k):
                    row_extra.setdefault(k, attrs[k])
            entries.append(ledger_mod.make_entry(
                q["query"], q["wall_s"], q["compile_s"], q["execute_s"],
                engine=engine, scale_factor=scale_factor, seed=seed,
                source=source,
                extra={k: v for k, v in row_extra.items() if v}))
        led.append(entries)
        if verdicts["regressions"]:
            print(f"WARNING: sentinel flagged warm-path regressions: "
                  f"{verdicts['regressions']}")
        return {"path": led.path, "appended": len(entries)}, verdicts
    except Exception as e:  # noqa: BLE001 — the ledger never fails a run
        print(f"WARNING: ledger/sentinel update failed: {e}")
        return None, None


def run_query_stream(args) -> None:
    from ndstpu_torch.engine.torchexec import resolve_device

    total_start = time.time()
    execution_times = []
    app_id = f"ndstpu-{uuid.uuid4().hex[:12]}"
    # no card and no --device cpu raises here, before anything runs
    device = resolve_device(args.device)
    if args.output_prefix:
        loader._pyarrow()   # writing outputs needs pyarrow: refuse now

    engine_conf = engine_properties(args)
    spmd = spmd_settings(engine_conf)
    engine_conf.setdefault("device", args.device)
    engine_conf.setdefault("input_format", args.input_format)
    if args.floats:
        engine_conf.setdefault("floats", "true")

    query_dict = gen_sql_from_stream(args.query_stream_file)

    # catalog load == table registration (TempView analog)
    load_start = time.time()
    with obs.span("load_catalog", cat="phase"):
        sess = Session(_load(args, device,
                             "spmd_chunk_rows" in spmd),
                       device=device, **spmd)
    execution_times.append(
        (app_id, "CreateTempView all tables",
         int((time.time() - load_start) * 1000)))
    if args.compile_records:
        # after the load-time row: preload re-plans every saved query and
        # must not be charged to table registration
        preload_start = time.time()
        obs.set_gauge("harness.compile_records.present",
                      1 if os.path.exists(args.compile_records) else 0)
        try:
            with obs.span("preload_compile_records", cat="phase"):
                n = sess.preload_compiled(args.compile_records)
            obs.inc("harness.compile_records.preloaded", n)
            print(f"preloaded {n} compile records")
        except Exception as e:  # stale records must never kill the run
            print(f"WARNING: compile records not loaded: {e}")
        execution_times.append(
            (app_id, "Preload compile records",
             int((time.time() - preload_start) * 1000)))

    check_json_summary_folder(args.json_summary_folder)
    if args.sub_queries:
        query_dict = get_query_subset(query_dict,
                                      args.sub_queries.split(","))

    if args.static_check:
        with obs.span("static_check", cat="phase"):
            offenders = static_check(sess, query_dict, args.device,
                                     scale_factor=args.scale_factor)
        if offenders:
            # the JAX command's text, the device for its engine
            raise SystemExit(
                "static check failed: query part(s) "
                f"{', '.join(offenders)} cannot lower on "
                f"{args.device} (diagnostics above); fix the query "
                "or drop --static_check to run with runtime fallback")
        print(f"static check passed: {len(query_dict)} part(s) lower on "
              f"{args.device}")

    # concurrent-stream admission: at most N streams execute on the
    # device at once (set by a throughput runner via env)
    gate = admission.from_env()

    # per-query watchdog: a wedged query otherwise blocks the stream
    # forever.  The abandoned thread keeps only the OLD session, so the
    # stream continues on a fresh one (sharing the device tables, with
    # the records preloaded again).  The abandoned thread stops at its
    # next cancellation point (``session.abandonable``), so once its hang
    # ends it discovers and counts nothing.  Abandoned threads are tracked in
    # `zombies`; before each query the stream grants them a short grace
    # join, and any still-alive zombie is recorded in the query's
    # summary (`zombieQueries`): it may still use the device, and
    # warnings it raises are captured by whichever later query's report
    # window is open.
    watchdog_s = float(os.environ.get(
        "NDSTPU_POWER_QUERY_TIMEOUT_S",
        "1200" if device.type == "cuda" else "0"))
    sess_holder = {"s": sess}
    zombies: List[dict] = []  # abandoned runs: {th, name, graced}

    def live_zombies(grace_s: float = 0.0) -> List[str]:
        # each zombie gets ONE grace join — a permanently-wedged thread
        # must not charge every remaining query the full grace window
        for z in zombies:
            if not z["graced"]:
                z["th"].join(grace_s)
                z["graced"] = True
        zombies[:] = [z for z in zombies if z["th"].is_alive()]
        return [z["name"] for z in zombies]

    def run_guarded(q_content, query_name):
        if watchdog_s <= 0:
            return run_one_query(sess_holder["s"], q_content, query_name,
                                 args.output_prefix, args.output_format)
        import threading
        slot: dict = {}
        abandoned = threading.Event()

        def work(s=sess_holder["s"]):
            try:
                with abandonable(abandoned):
                    run_one_query(s, q_content, query_name,
                                  args.output_prefix, args.output_format)
                slot["ok"] = True
            except Exception as e:  # noqa: BLE001
                slot["err"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(watchdog_s)
        if th.is_alive():
            # the thread stops at its next cancellation point
            abandoned.set()
            zombies.append({"th": th, "name": query_name, "graced": False})
            try:
                fresh = sess_holder["s"].fresh()
                # swap FIRST: preload failure is non-fatal, but the
                # stream must never continue on the session the
                # zombie thread still drives
                sess_holder["s"] = fresh
                if args.compile_records:
                    fresh.preload_compiled(args.compile_records)
            except Exception as e:  # noqa: BLE001
                print(f"WARNING: fresh session setup after hang "
                      f"incomplete: {e}")
            raise TimeoutError(
                f"{query_name} hung > {watchdog_s:.0f}s; abandoned "
                f"(stream continues on a fresh session)")
        if "err" in slot:
            raise slot["err"]

    stream_name = os.path.splitext(
        os.path.basename(args.query_stream_file))[0]

    # run ledger + budget heartbeat: priors feed the per-query ETA and
    # the cheapest-first deadline degradation; the ledger itself is
    # appended to after the stream.  The port discovers on either device,
    # so a query's first run is cold unless compile records exist
    led = open_ledger(args.ledger)
    engine = ledger_engine(device)
    expected_warmth = "warm" if (args.compile_records and os.path.exists(
        args.compile_records)) else "cold"
    budget_s = args.budget_s if args.budget_s and args.budget_s > 0 \
        else None
    est = progress.ledger_estimator(led, engine=engine,
                                    scale_factor=args.scale_factor,
                                    warmth=expected_warmth)
    queue = progress.BudgetedQueue(list(query_dict), budget_s, est,
                                   phase="power")
    hb = progress.Heartbeat("power", total=len(query_dict),
                            budget_s=budget_s)

    # -- failure handling + crash-safe resume -------------------------
    # transient failures retry (NDSTPU_RETRY_MAX attempts, deterministic
    # backoff); a per-query progress journal rides next to the time log
    # so a killed run can --resume past every query it already finished
    retry_policy = faults.RetryPolicy.from_env()
    quarantine = faults.Quarantine()
    progress_log = args.time_log + ".progress.jsonl"
    run_fp = power_fingerprint(args)
    completed: set = set()
    resumed_rows: List[tuple] = []
    if args.resume:
        for rec in atomic.read_jsonl(progress_log):
            if rec.get("fp") == run_fp and not rec.get("failed") and \
                    rec.get("query") in query_dict and \
                    rec["query"] not in completed:
                completed.add(rec["query"])
                resumed_rows.append((rec.get("app_id", app_id),
                                     rec["query"],
                                     rec.get("millis") or 0))
        if completed:
            print(f"====== Resume: skipping {len(completed)} queries "
                  f"already completed (fingerprint {run_fp[:12]}) "
                  f"======")
            obs.inc("harness.resume.queries_skipped", len(completed))
    elif os.path.exists(progress_log):
        os.unlink(progress_log)  # fresh run: the old journal is stale

    def post_query(name, summary, failed):
        try:
            atomic.append_jsonl(progress_log, {
                "fp": run_fp, "query": name, "failed": bool(failed),
                "millis": summary["queryTimes"][0]
                if summary["queryTimes"] else None,
                "app_id": app_id, "ts_epoch_s": time.time()})
        except Exception as e:  # journal must never fail the run
            print(f"WARNING: progress journal append failed: {e}")

    def pre_query(query_name):
        # abandoned-thread gate: give zombies a short grace window to
        # drain before sharing the device with the next query
        active_zombies = live_zombies(grace_s=10.0) if zombies else []
        if not active_zombies:
            return None
        print(f"WARNING: abandoned query threads still running: "
              f"{active_zombies} — device contention possible; "
              f"captured warnings may belong to them")
        return {"zombieQueries": active_zombies}

    if args.json_summary_folder and args.property_file:
        summary_prefix = os.path.join(
            args.json_summary_folder,
            os.path.basename(args.property_file).split(".")[0])
    else:
        summary_prefix = os.path.join(args.json_summary_folder or "", "")

    power_start = int(time.time())
    res = run_stream(query_dict, queue=queue, runner=run_guarded,
                     heartbeat=hb, engine=args.device, app_id=app_id,
                     stream_name=stream_name, engine_conf=engine_conf,
                     gate=gate, pre_query=pre_query,
                     post_query=post_query,
                     json_summary_folder=args.json_summary_folder,
                     summary_prefix=summary_prefix,
                     t0=total_start,
                     span_attrs={"stream": stream_name},
                     retry_policy=retry_policy, quarantine=quarantine,
                     completed=completed)
    execution_times.extend(resumed_rows)
    execution_times.extend(res["rows"])
    power_end = int(time.time())
    power_elapse = int((power_end - power_start) * 1000)
    total_elapse = int((time.time() - total_start) * 1000)
    print(f"====== Power Test Time: {power_elapse} milliseconds ======")
    print(f"====== Total Time: {total_elapse} milliseconds ======")
    execution_times.append((app_id, "Power Start Time", power_start))
    execution_times.append((app_id, "Power End Time", power_end))
    execution_times.append((app_id, "Power Test Time", power_elapse))
    execution_times.append((app_id, "Total Time", total_elapse))

    if args.compile_records:
        try:
            sess_holder["s"].save_compiled(args.compile_records)
        except Exception as e:
            print(f"WARNING: compile records not saved: {e}")

    header = ["application_id", "query", "time/milliseconds"]
    for path in filter(None, (args.time_log, args.extra_time_log)):
        with atomic.atomic_writer(path, "w",
                                  encoding="UTF8", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(execution_times)

    if obs.enabled():
        # one JSONL event log + one Perfetto-loadable Chrome trace per
        # run, next to the time log (NDSTPU_TRACE_DIR overrides), plus a
        # machine-readable metrics sidecar
        trace_dir = os.environ.get("NDSTPU_TRACE_DIR") or \
            (os.path.dirname(args.time_log) or ".")
        base = os.path.basename(args.time_log)
        # sentinel verdicts are judged against the pre-run ledger, then
        # this run's measurements are appended so the next run has priors
        executed = set(res["executed"])
        ledger_block, sentinel_block = record_run(
            led, [q for q in obs.tracer().query_summaries()
                  if q["query"] in executed],
            engine=engine, scale_factor=args.scale_factor,
            seed=args.run_seed, source=base,
            extra={"stream": stream_name})
        try:
            paths = obs.export_run(trace_dir, base)
            sidecar = args.time_log + ".metrics.json"
            with atomic.atomic_writer(sidecar, "w") as f:
                json.dump(obs.run_metrics({
                    "app_id": app_id,
                    "engine": args.device,
                    "stream": stream_name,
                    "power_elapse_ms": power_elapse,
                    "total_elapse_ms": total_elapse,
                    "budget_s": budget_s,
                    "partial": bool(queue.skipped),
                    "partial_reasons": queue.skipped,
                    "faultTaxonomy": res["taxonomy"],
                    "quarantined": res["quarantined"] or None,
                    "resumed": res["resumed"] or None,
                    "ledger": ledger_block,
                    "sentinel": sentinel_block,
                }), f, indent=2)
            print(f"====== Trace: {paths['jsonl']} | {paths['chrome']} "
                  f"| {sidecar} ======")
        except Exception as e:  # observability must never fail the run
            print(f"WARNING: trace export failed: {e}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="NDS power run (the PyTorch/CUDA port)")
    p.add_argument("query_stream_file",
                   help="query stream file (query_N.sql)")
    p.add_argument("input_prefix",
                   help="warehouse directory, or - with --generate")
    p.add_argument("time_log", help="per-query CSV time log output path")
    p.add_argument("--input_format", default="parquet",
                   choices=["parquet", "orc", "csv", "json"],
                   help="warehouse table format (recorded in the "
                        "summaries; the loader reads what it finds)")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (default cuda; "
                        "cpu for the tests)")
    p.add_argument("--generate", type=float, metavar="SF",
                   help="generate the warehouse on the device at this "
                        "scale factor instead of reading one "
                        "(input_prefix must be -)")
    p.add_argument("--generate_seed", type=int, default=1, metavar="N",
                   help="the generator's seed with --generate (default 1)")
    p.add_argument("--output_prefix",
                   help="write per-query results under this dir "
                        "(for validation; needs pyarrow); default = "
                        "collect only")
    p.add_argument("--output_format", default="parquet",
                   choices=["parquet", "csv"])
    p.add_argument("--property_file",
                   help="engine properties file (knobs recorded in "
                        "reports; spmd.* applied)")
    p.add_argument("--property", action="append", metavar="KEY=VALUE",
                   help="one engine property, after --property_file "
                        "(repeatable): spmd.chunk_rows=auto|N streams the "
                        "facts from host memory, spmd.prefetch_depth=N, "
                        "spmd.threshold_rows=N")
    p.add_argument("--json_summary_folder",
                   help="folder for per-query JSON summaries")
    p.add_argument("--sub_queries",
                   help="comma-separated query-name subset, e.g. "
                        "query1,query3_part1")
    p.add_argument("--extra_time_log",
                   help="secondary location for the CSV time log")
    p.add_argument("--compile_records",
                   help="path for persisted whole-query size-plan "
                        "records (skip per-query discovery on repeat "
                        "power runs)")
    p.add_argument("--budget_s", type=float,
                   default=float(os.environ.get(
                       "NDSTPU_PHASE_BUDGET_S", "0") or 0),
                   help="phase deadline budget in seconds (0 = none; "
                        "default from NDSTPU_PHASE_BUDGET_S). On "
                        "projected overrun the run degrades "
                        "explicitly: queries that cannot fit get a "
                        "per-query partial_reason in the metrics sidecar")
    p.add_argument("--ledger",
                   help="run-ledger JSONL path (default "
                        "$NDSTPU_LEDGER or .bench_cache/ledger.jsonl; "
                        "'none' disables). Serves ETA priors and "
                        "regression-sentinel baselines; executed "
                        "queries are appended after the run")
    p.add_argument("--scale_factor", default="unknown",
                   help="scale factor for the resume and ledger "
                        "fingerprints (set by --generate)")
    p.add_argument("--run_seed", default="unknown",
                   help="seed for the resume and ledger fingerprints "
                        "(set by --generate)")
    p.add_argument("--floats", action="store_true",
                   help="double mode (no decimals): every DECIMAL "
                        "column of the schema as FLOAT64")
    p.add_argument("--resume", action="store_true",
                   help="crash-safe resume: replay the per-query "
                        "progress journal (<time_log>.progress.jsonl) "
                        "and skip queries already completed by a "
                        "previous run of the same fingerprint (device, "
                        "floats, scale factor, seed, stream, subset, "
                        "warehouse); their time-log rows are carried "
                        "over")
    p.add_argument("--static_check", action="store_true",
                   help="run the static plan analyzer over the stream "
                        "before executing anything and reject queries "
                        "with error-severity diagnostics (code + plan "
                        "path printed), on every device")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The command line's arguments, checked: a warehouse directory, or
    ``-`` with ``--generate SF``, which also sets the fingerprints' scale
    factor and seed."""
    p = build_parser()
    args = p.parse_args(argv)
    if (args.generate is None) != (args.input_prefix != "-"):
        p.error("give a warehouse directory, or - with --generate SF")
    if args.generate is not None:
        args.scale_factor = f"{args.generate:g}"
        args.run_seed = str(args.generate_seed)
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    # a run's spans and counters start from nothing (the sidecar holds
    # this run's alone, also when a process runs more than one)
    obs.reset()
    run_query_stream(args)


if __name__ == "__main__":
    main()
