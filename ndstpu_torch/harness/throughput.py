"""Throughput test: N concurrent power runs (the `nds-throughput` analog).

The port of the JAX package's ``ndstpu/harness/throughput.py``.  The
reference fans out concurrent spark-submit processes with
`xargs -d, -P<n> -I{}` substituting the stream id into the command
(nds-throughput:18-23).  Two modes:

* ``--mode process`` (default, spec-faithful shape): each stream is one
  OS process running the port's power CLI with `{}` placeholders
  substituted the same way.  `--concurrent N` bounds how many streams
  execute on the shared card at once (the
  `spark.rapids.sql.concurrentGpuTasks` analog) via a cross-process
  file-lock semaphore — see ndstpu_torch.harness.admission.  Each process
  holds its own warehouse and its own CUDA graphs (their budget is half
  the card's free memory at a process's first capture), so two streams at
  a scale whose warehouse and largest query fill the card cannot run this
  way on one card.
* ``--mode inproc`` (shared session): the same N streams run as worker
  threads over ONE shared session so the warehouse loads once and each
  distinct canonical key discovers and captures once — see
  ndstpu_torch.harness.scheduler.  Same `--concurrent` slot semantics
  (in-process gate), same overlap-report format, same time-log contract.

* ``--mode serve --serve_socket SPEC``: the same N streams as clients of
  a running query server, or of a fleet's comma-separated endpoints
  (``python -m ndstpu_torch.harness.serve``): each stream is one
  connection under its own tenant, and the server decides what overlaps
  (see :func:`run_streams_serve`).  The wrapped power command only names
  each stream's file and ``--sub_queries``; the server holds the
  warehouse and the device.

``--floats`` (the decimals-as-doubles warehouse) goes in the wrapped
power command in the process and inproc modes, where every stream must
give it alike, and to the server (``harness.serve server --floats``) in
the serve mode.

Streams run on ``cuda`` unless the wrapped power command passes ``--device
cpu``::

    python -m ndstpu_torch.harness.throughput 1,2 --concurrent 2 -- \\
        python -m ndstpu_torch.harness.power ./query_{}.sql - \\
        ./time_{}.csv --generate 20
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from ndstpu_torch import obs
from ndstpu_torch.faults import taxonomy
from ndstpu_torch.harness import progress
from ndstpu_torch.io import atomic


def concurrency_timeline(records: List[dict]) -> dict:
    """Overlap evidence from per-stream (start, end) intervals: max
    concurrent streams (event sweep) + pairwise overlap seconds.  This
    is the committed evidence the ``admission.py`` ``concurrent: N``
    cap is judged against — with admission working, max_concurrent at
    the *device* stays <= N while the wall-clock streams still overlap
    (they queue at the gate, not in the driver)."""
    points = []
    for r in records:
        points.append((r["start_epoch_s"], 1))
        points.append((r["end_epoch_s"], -1))
    points.sort()
    cur = peak = 0
    for _, d in points:
        cur += d
        peak = max(peak, cur)
    pairwise: Dict[str, float] = {}
    total_overlap = 0.0
    for i, a in enumerate(records):
        for b in records[i + 1:]:
            ov = min(a["end_epoch_s"], b["end_epoch_s"]) - \
                max(a["start_epoch_s"], b["start_epoch_s"])
            ov = max(ov, 0.0)
            # records arrive in completion order; key order-stably
            key = "&".join(sorted((a["stream"], b["stream"])))
            pairwise[key] = round(ov, 3)
            total_overlap += ov
    return {
        "max_concurrent": peak,
        "pairwise_overlap_s": pairwise,
        "total_pairwise_overlap_s": round(total_overlap, 3),
    }


def write_overlap_report(overlap_report: Optional[str],
                         records: List[dict],
                         concurrent: Optional[int],
                         budget_s: Optional[float],
                         mode: str = "process",
                         extra: Optional[dict] = None) -> dict:
    """Build (and, when a path is given, write) the overlap-evidence
    document both throughput modes share.  ``stream_max_concurrent`` is
    always the stream-wall event sweep; in process mode
    ``max_concurrent`` is the same number (each stream process holds
    the device for its whole wall), while the inproc scheduler
    overrides it via ``extra`` with the admission gate's device-level
    peak — the number the ``concurrent: N`` cap is judged against."""
    timeline = concurrency_timeline(records)
    obs.set_gauge("harness.throughput.max_concurrent_streams",
                  timeline["max_concurrent"])
    doc = {
        "format": "ndstpu-throughput-overlap-v1",
        "mode": mode,
        "admission_slots": concurrent,
        "budget_s": budget_s,
        "streams": sorted(records, key=lambda r: r["start_epoch_s"]),
        **timeline,
        "stream_max_concurrent": timeline["max_concurrent"],
    }
    if extra:
        doc.update({k: v for k, v in extra.items() if v is not None})
    if overlap_report:
        atomic.atomic_write_json(overlap_report, doc)
        print(f"====== Overlap evidence: {overlap_report} "
              f"(max_concurrent={doc['max_concurrent']}, "
              f"admission_slots={concurrent}) ======")
    return doc


def run_throughput(stream_ids: List[str], cmd_template: List[str],
                   concurrent: Optional[int] = None,
                   budget_s: Optional[float] = None,
                   overlap_report: Optional[str] = None) -> int:
    env = None
    lock_dir = None
    child_env: Dict[str, str] = {}
    if concurrent is not None:
        lock_dir = tempfile.mkdtemp(prefix="ndstpu_adm")
        child_env.update(NDSTPU_ADMISSION_SLOTS=str(concurrent),
                         NDSTPU_ADMISSION_DIR=lock_dir)
    if budget_s:
        # each stream is a full power run on the same phase deadline;
        # the power CLI picks this up and degrades explicitly
        child_env["NDSTPU_PHASE_BUDGET_S"] = str(budget_s)
    if child_env:
        env = dict(os.environ, **child_env)
    try:
        t0 = time.time()
        pending = {}
        starts = {}
        for sid in stream_ids:
            cmd = [arg.replace("{}", sid) for arg in cmd_template]
            print("launch:", " ".join(cmd))
            starts[sid] = time.time()
            obs.inc("harness.throughput.streams_launched")
            pending[sid] = subprocess.Popen(cmd, env=env)
        rc = 0
        records: List[dict] = []
        # a stream subprocess that dies nonzero is restarted ONCE
        # (taxonomy: transient — a fresh process may succeed) before
        # the stream counts as failed; the overlap report records both
        # the restart and the first attempt's envelope
        restarted: Dict[str, dict] = {}
        hb = progress.Heartbeat("throughput", total=len(stream_ids),
                                budget_s=budget_s)
        last_hb = time.time()
        # poll instead of wait() so each stream's end timestamp is
        # observed when it actually exits (sequential wait() would
        # charge an early finisher the laggards' runtime and inflate
        # the overlap evidence); the poll interval backs off
        # exponentially while nothing exits — streams run minutes, so
        # a fixed short poll is pure busy-wait — and snaps back to
        # fine-grained on each completion so end timestamps stay sharp
        poll_s = 0.01
        while pending:
            completed = False
            for sid, p in list(pending.items()):
                code = p.poll()
                if code is None:
                    continue
                completed = True
                del pending[sid]
                end = time.time()
                wall = end - starts[sid]
                if code and sid not in restarted:
                    restarted[sid] = {
                        "returncode": code,
                        "start_epoch_s": round(starts[sid], 3),
                        "end_epoch_s": round(end, 3),
                        "wall_s": round(wall, 3),
                    }
                    cmd = [arg.replace("{}", sid)
                           for arg in cmd_template]
                    print(f"WARNING: stream {sid} exited {code} — "
                          f"restarting once (taxonomy: "
                          f"{taxonomy.TRANSIENT})")
                    obs.inc("harness.retry.stream_restarts")
                    starts[sid] = time.time()
                    pending[sid] = subprocess.Popen(cmd, env=env)
                    continue
                # stream lifetimes overlap, so a context-manager span
                # cannot express them — record each with explicit
                # timestamps (the per-query detail lives in each
                # stream process's own trace)
                obs.record(f"stream_{sid}", "stream", starts[sid],
                           wall, returncode=code)
                rec = {
                    "stream": sid,
                    "start_epoch_s": round(starts[sid], 3),
                    "end_epoch_s": round(end, 3),
                    "wall_s": round(wall, 3),
                    "returncode": code,
                }
                if sid in restarted:
                    rec["restarts"] = 1
                    rec["first_attempt"] = restarted[sid]
                    rec["taxonomy"] = taxonomy.TRANSIENT if code == 0 \
                        else taxonomy.PERMANENT
                records.append(rec)
                hb.beat(len(records), f"stream_{sid} done "
                        f"wall={wall:.1f}s", end - t0)
                if code:
                    obs.inc("harness.throughput.streams_failed")
                rc = rc or code
            if pending:
                poll_s = 0.01 if completed else min(poll_s * 2, 0.5)
                time.sleep(poll_s)
                if time.time() - last_hb >= 30.0:
                    last_hb = time.time()
                    hb.beat(len(records), "waiting", last_hb - t0)
        write_overlap_report(overlap_report, records, concurrent,
                             budget_s, mode="process")
        return rc
    finally:
        if lock_dir is not None:
            shutil.rmtree(lock_dir, ignore_errors=True)


def run_streams_serve(stream_ids: List[str], cmd_template: List[str],
                      serve_socket: str,
                      budget_s: Optional[float] = None,
                      overlap_report: Optional[str] = None) -> int:
    """Route the throughput phase through a running query server.

    ``cmd_template`` is the same ``{}``-placeholder power command the
    other modes take — parsed per stream with the power CLI's parser so
    all three modes share one argument contract — but here only the
    stream files/subsets matter: execution, admission, and output
    writing happen inside the server.  Each stream is one client
    connection (= one server-side scheduler stream) under its own
    tenant; queries go up serially per stream like a power run, and the
    server decides what overlaps.

    ``serve_socket`` may be a **fleet spec** — a comma-separated
    endpoint list (ndstpu_torch/serve/transport.py grammar) such as a
    FleetSupervisor's ``endpoints_spec()``.  Each stream client then
    fails over between replicas on connection faults and sheds; the
    overlap report records per-stream ``failovers``/``endpoint`` and
    per-replica health attribution under ``extra.replica_health``."""
    import threading

    from ndstpu_torch.harness import power, scheduler
    from ndstpu_torch.serve.client import ServeClient

    tail = scheduler._power_tail(cmd_template)
    parser = power.build_parser()
    t0 = time.time()
    records: List[dict] = []
    rec_lock = threading.Lock()
    health = {}

    def worker(sid: str) -> None:
        ns = parser.parse_args([a.replace("{}", sid) for a in tail])
        qd = power.gen_sql_from_stream(ns.query_stream_file)
        if ns.sub_queries:
            qd = power.get_query_subset(qd, ns.sub_queries.split(","))
        stem = os.path.splitext(
            os.path.basename(ns.query_stream_file))[0]
        # fleet specs get a larger attempt budget: under depth-1
        # backpressure every replica can shed for a full service
        # time, and the bench must ride it out rather than fail
        n_eps = len(str(serve_socket).split(","))
        cli = ServeClient(serve_socket, tenant=f"stream-{sid}",
                          retries=8 if n_eps == 1 else 8 + 4 * n_eps)
        start = time.time()
        code = executed = failures = skipped = 0
        obs.inc("harness.throughput.streams_launched")
        try:
            if not cli.wait_ready(60.0):
                raise ConnectionError(
                    f"server at {serve_socket} not ready")
            for qname, sql in qd.items():
                elapsed = time.time() - start
                if budget_s and elapsed >= budget_s:
                    skipped = len(qd) - executed - failures
                    print(f"[serve-stream {sid}] budget exhausted "
                          f"({elapsed:.1f}s >= {budget_s:g}s): "
                          f"skipping {skipped} queries")
                    break
                deadline = (budget_s - elapsed) if budget_s else None
                try:
                    cli.sql(sql, name=f"{stem}/{qname}"
                            if ns.output_prefix else None,
                            deadline_s=deadline)
                    executed += 1
                except Exception as e:  # noqa: BLE001 — per-query
                    failures += 1
                    print(f"[serve-stream {sid}] {qname} failed: "
                          f"{type(e).__name__}: {e}")
            code = 1 if failures else 0
        except Exception as e:  # noqa: BLE001 — stream-fatal
            print(f"[serve-stream {sid}] failed: "
                  f"{type(e).__name__}: {e}")
            obs.inc("harness.throughput.streams_failed")
            code = 1
        finally:
            try:
                health.update(cli.health())
            except Exception:  # noqa: BLE001 — evidence only
                pass
            cli.close()
        end = time.time()
        with rec_lock:
            records.append({
                "stream": sid,
                "start_epoch_s": round(start, 3),
                "end_epoch_s": round(end, 3),
                "wall_s": round(end - start, 3),
                "returncode": code,
                "executed": executed,
                "failures": failures,
                "skipped": skipped,
                "client_retries": cli.retried,
                "failovers": cli.failovers,
                "endpoint": cli.endpoint.spec,
            })

    threads = [threading.Thread(target=worker, args=(sid,),
                                name=f"serve-stream-{sid}",
                                daemon=True)
               for sid in stream_ids]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rc = 1 if any(r["returncode"] for r in records) else 0
    # per-replica attribution: each endpoint answers its OWN health
    # doc (counters are per-process), so a fleet run shows how load
    # and sheds distributed across replicas
    replica_health = {}
    from ndstpu_torch.serve import transport
    endpoints = transport.parse_endpoints(serve_socket)
    if len(endpoints) > 1:
        for ep in endpoints:
            one = ServeClient(ep.spec, retries=0,
                              connect_timeout_s=2.0)
            try:
                replica_health[ep.spec] = one.health()
            except Exception as e:  # noqa: BLE001 — evidence only
                replica_health[ep.spec] = {"alive": False,
                                           "error": str(e)}
            finally:
                one.close()
    # overlap evidence: stream walls from the client side; the device-
    # level peak is whatever the server's admission gate enforced,
    # reported via its health doc
    write_overlap_report(
        overlap_report, records, health.get("admitted_peak"),
        budget_s, mode="serve",
        extra={"serve_socket": serve_socket,
               "server_health": health or None,
               "replica_health": replica_health or None,
               "failovers_total": sum(r.get("failovers", 0)
                                      for r in records),
               "total_elapse_s": round(time.time() - t0, 3)})
    return rc


def main(argv: List[str]) -> int:
    # wrapper flags are parsed only from the part BEFORE the "--"
    # separator so the wrapped command's own flags are safe
    sep = argv.index("--") if "--" in argv else None
    head = argv[:sep] if sep is not None else argv

    def take(flag: str, cast, check=None):
        if flag not in head:
            return None, None
        i = head.index(flag)
        if i + 1 >= len(head):
            return None, f"{flag} requires a value"
        try:
            val = cast(head[i + 1])
        except ValueError:
            return None, f"{flag}: bad value: {head[i + 1]}"
        if check and not check(val):
            return None, f"{flag}: out of range: {val}"
        del head[i:i + 2]
        return val, None

    concurrent, err = take("--concurrent", int, lambda v: v >= 1)
    if err:
        print(err, file=sys.stderr)
        return 2
    budget_s, err = take("--budget_s", float, lambda v: v > 0)
    if err:
        print(err, file=sys.stderr)
        return 2
    overlap_report, err = take("--overlap_report", str)
    if err:
        print(err, file=sys.stderr)
        return 2
    mode, err = take("--mode", str,
                     lambda v: v in ("process", "inproc", "serve"))
    if err:
        print(err, file=sys.stderr)
        return 2
    serve_socket, err = take("--serve_socket", str)
    if err:
        print(err, file=sys.stderr)
        return 2
    if mode == "serve" and not serve_socket:
        print("--mode serve requires --serve_socket SPEC "
              "(a running `python -m ndstpu_torch.harness.serve server` or "
              "comma-separated fleet endpoints)", file=sys.stderr)
        return 2
    if budget_s is None and os.environ.get("NDSTPU_PHASE_BUDGET_S"):
        try:
            budget_s = float(os.environ["NDSTPU_PHASE_BUDGET_S"])
        except ValueError:
            pass
    if sep is not None:
        ids_arg, cmd = head, argv[sep + 1:]
    else:
        ids_arg, cmd = head[:1], head[1:]
    if not ids_arg or not cmd:
        print("usage: throughput <id,id,...> [--concurrent N] "
              "[--budget_s S] [--overlap_report PATH] "
              "[--mode process|inproc|serve] "
              "[--serve_socket SPEC[,SPEC...]] -- "
              "<command with {} placeholders>", file=sys.stderr)
        return 2
    stream_ids = [s for s in ids_arg[0].split(",") if s]
    if mode == "serve":
        return run_streams_serve(
            stream_ids, cmd, serve_socket, budget_s=budget_s,
            overlap_report=overlap_report)
    if mode == "inproc":
        from ndstpu_torch.harness import scheduler
        # the phase's spans and counters start from nothing (its one
        # sidecar holds this run's alone), as a power run's do
        obs.reset()
        return scheduler.run_streams_inproc(
            stream_ids, cmd, concurrent, budget_s=budget_s,
            overlap_report=overlap_report).rc
    return run_throughput(stream_ids, cmd, concurrent,
                          budget_s=budget_s,
                          overlap_report=overlap_report)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
