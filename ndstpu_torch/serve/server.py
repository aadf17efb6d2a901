"""The always-on query server: one shared Session behind a socket.

The port of the JAX package's ``ndstpu/serve/server.py``, over the port's
:class:`~ndstpu_torch.engine.session.Session` on ``cuda`` (or on the
device the caller names: ``cpu`` for the tests).

Execution model:

* one **accept thread** (``serve.accept`` fault probe) hands each
  connection a **reader thread** and an **executor thread**;
* a connection IS a stream: the reader admits requests (tenant budget
  -> bounded queue -> circuit breaker, serve/overload.py) and feeds them
  into the continuous-feed
  :class:`~ndstpu_torch.harness.scheduler.StreamScheduler` — the SAME
  cross-stream compile-dedup machinery the batch throughput phase
  uses, so concurrent connections sending one plan shape share one
  discovery and one graph;
* the executor drains its stream view through the
  :class:`~ndstpu_torch.harness.admission.InprocAdmission` device gate,
  runs each query snapshot-pinned (``Session.pin_snapshot`` — results
  stay consistent under concurrent DDL and DML) under the retry and
  quarantine contract of :mod:`ndstpu_torch.faults`, with the power
  watchdog idiom abandoning hung queries on a fresh session
  (``Session.fresh``, which shares the device tables) so neither the
  stream nor a drain ever wedges;
* the ``serve.dispatch`` fault probe sits BEFORE the retry wrapper:
  injected dispatch faults are client-visible typed errors, exercising
  the client's reconnect-and-retry path.

Only executor threads run work on the device, one query at a time
(``Session._exec_lock``): a reader thread plans (host work) and answers
the ops verbs from host state, so it never syncs with the card while a
graph is being captured.  A query that the watchdog abandons stops at
its next cancellation point (``session.abandonable``: before it plans,
and before it discovers or replays), but cannot be stopped while it runs
on the card; the fresh session takes its graph
budget from the free memory at its own first capture, so it never counts
on memory that the abandoned query still holds.  A failed kernel build
or launch fails its request as any engine error does; nothing reruns on
the CPU or with a plain kernel.

Crash safety: every successful request journals its SQL + canonical
key (lifecycle.ServeJournal) and compile records persist incrementally
(``Session.compiled_count`` delta -> ``save_compiled``), so a SIGKILL
loses nothing a warm restart needs.  SIGTERM runs the graceful drain.

Results: a request naming an output writes it under ``output_prefix``
through pyarrow (the server refuses to start with ``output_prefix`` and
no pyarrow, as the power run does); otherwise its rows return in the
response (``data``, at most ``max_rows``), which needs no pyarrow.

Fleet mode (serve/fleet.py) layers on top without changing the single
server: ``bind_early`` brings the listener(s) up before warmth so the
supervisor's ``probe`` verb can watch readiness flip, ``tcp`` adds a
TCP listener beside AF_UNIX (serve/transport.py), ``aot_corpus``
precompiles a full query corpus before readiness, ``replica_id`` tags
probe/health docs, and ``queue_depth=None`` derives admission depth
from the memplan device-memory model (``memplan.admission_budget``).

``floats`` serves the decimals-as-doubles warehouse (its DECIMAL columns
read or generated as FLOAT64), as the power run's ``--floats``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import torch

from ndstpu_torch import faults, obs
from ndstpu_torch.engine import columnar
from ndstpu_torch.engine.session import Session, abandonable
from ndstpu_torch.engine.torchexec import resolve_device
from ndstpu_torch.engine.sql import ast, parse_statement
from ndstpu_torch.harness import admission as adm
from ndstpu_torch.harness import power
from ndstpu_torch.harness.scheduler import StreamScheduler
from ndstpu_torch.obs import ledger as ledger_mod
from ndstpu_torch.serve import lifecycle, protocol, transport
from ndstpu_torch.serve.overload import (AdmissionQueue, CircuitBreaker,
                                   Overloaded, Rejected, TenantBudgets)

# per-query watchdog (power idiom): a query hung past this is
# abandoned on a zombie thread and the server swaps to a fresh session
TIMEOUT_ENV = "NDSTPU_SERVE_QUERY_TIMEOUT_S"
DEFAULT_QUERY_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ServeConfig:
    socket_path: str            # endpoint spec (unix path or tcp:H:P)
    input_prefix: Optional[str] = None  # "-" with generate
    device: str = "cuda"
    generate: Optional[float] = None    # generate the warehouse at SF
    generate_seed: int = 1
    output_prefix: Optional[str] = None
    output_format: str = "csv"
    compile_records: Optional[str] = None
    journal_path: Optional[str] = None
    slo_path: Optional[str] = None
    ledger_path: Optional[str] = None
    scale_factor: str = "unknown"
    floats: bool = False
    slots: int = 1
    queue_depth: Optional[int] = 64  # None/0 -> memplan admission model
    tenant_tokens: float = 64.0
    tenant_refill_per_s: float = 16.0
    breaker_cooldown_s: float = 5.0
    query_timeout_s: Optional[float] = None  # None -> env/default
    tcp: Optional[str] = None       # extra TCP listener (HOST:PORT)
    aot_corpus: Optional[str] = None  # stream file/dir to precompile
    bind_early: bool = False        # answer probes while warming
    replica_id: Optional[str] = None  # fleet identity in probe/health

    def resolved_timeout_s(self) -> float:
        if self.query_timeout_s is not None:
            return self.query_timeout_s
        try:
            return float(os.environ.get(
                TIMEOUT_ENV, DEFAULT_QUERY_TIMEOUT_S))
        except ValueError:
            return DEFAULT_QUERY_TIMEOUT_S


class _Conn:
    """One client connection = one scheduler stream."""

    def __init__(self, sid: str, sock: socket.socket):
        self.sid = sid
        self.sock = sock
        self.wlock = threading.Lock()
        self.pending: Dict[str, dict] = {}
        self.plock = threading.Lock()
        self.reader: Optional[threading.Thread] = None
        self.executor: Optional[threading.Thread] = None

    def send(self, obj: dict) -> None:
        with self.wlock:
            protocol.send_msg(self.sock, obj)


class QueryServer:
    """Front door + robustness control plane over one shared Session."""

    def __init__(self, config: ServeConfig,
                 session: Optional[Session] = None):
        self.config = config
        self.session = session
        self._session_lock = threading.Lock()
        self.ready = False
        self.draining = False
        self._drain_lock = threading.Lock()
        self._stopped = threading.Event()
        self._listeners: List[socket.socket] = []
        self.endpoints: List[transport.Endpoint] = []
        self._accept_threads: List[threading.Thread] = []
        self._conns: Dict[str, _Conn] = {}
        self._conns_lock = threading.Lock()
        self._conn_seq = 0
        self._req_seq = 0
        self._started_at = time.time()
        self._saved_compiled = 0
        self._zombies: List[dict] = []
        self.drain_summary: Optional[dict] = None
        self.aot_info: Optional[dict] = None

        self.retry_policy = faults.RetryPolicy.from_env()
        self.quarantine = faults.Quarantine()
        self.budgets = TenantBudgets(
            capacity=config.tenant_tokens,
            refill_per_s=config.tenant_refill_per_s)
        # queue_depth None/0 asks the memplan device-memory model how
        # many concurrently-admitted queries the budget supports — a
        # clamped NDSTPU_HBM_BYTES sheds instead of queueing
        self.admission_model: Optional[dict] = None
        depth = config.queue_depth
        if not depth:
            from ndstpu_torch.engine import memplan
            self.admission_model = memplan.admission_budget()
            depth = self.admission_model["depth"]
        self.queue = AdmissionQueue(depth=depth)
        self.breaker = CircuitBreaker(
            self.quarantine, cooldown_s=config.breaker_cooldown_s)
        self.slo = lifecycle.SLOTracker()
        self.journal = lifecycle.ServeJournal(
            config.journal_path or "serve_journal.jsonl")
        self.gate = adm.InprocAdmission(config.slots)
        # built here (not in start) so bind_early connections accepted
        # while the session still warms get their stream immediately
        self.scheduler: StreamScheduler = StreamScheduler(
            {}, key_fn=lambda sql: self.session.canonical_key(sql))
        self.ledger: Optional[ledger_mod.Ledger] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Build the session, warm-restart from the journal, precompile
        the AOT corpus, bind the socket, THEN flip readiness — a client
        that sees ready=True is guaranteed the replayed + precompiled
        warmth is already in place.  With ``bind_early`` the listener
        comes up first instead, answering probes (not-ready) and
        shedding sql as retryable ``overloaded`` while warming — the
        fleet supervisor's readiness gate.

        Without a prebuilt session, no card (and no ``device`` other than
        ``cuda``) raises here before anything binds, as does
        ``output_prefix`` without pyarrow."""
        from ndstpu_torch.io import loader
        if self.config.output_prefix:
            loader._pyarrow()   # writing outputs needs pyarrow: refuse now
        device = None
        if self.session is None:
            # no card and no device named: raises, nothing falls back
            device = resolve_device(self.config.device)
            if self.config.generate is None and (
                    not self.config.input_prefix
                    or self.config.input_prefix == "-"):
                raise ValueError("ServeConfig needs input_prefix, or "
                                 "generate with input_prefix '-' (or a "
                                 "prebuilt session)")
        if self.config.bind_early:
            self._bind()
            self._start_accepting()
        if self.session is None:
            from ndstpu_torch.harness.power import _load
            with obs.span("load_catalog", cat="phase"):
                self.session = Session(_load(self.config, device),
                                       device=device)
        restart = lifecycle.warm_restart(
            self.session, self.journal,
            compile_records=self.config.compile_records)
        self._aot_precompile()
        self._saved_compiled = self.session.compiled_count()
        if self.config.ledger_path and \
                self.config.ledger_path.lower() != "none":
            try:
                self.ledger = ledger_mod.Ledger(self.config.ledger_path)
            except Exception as e:  # noqa: BLE001 — priors only
                print(f"WARNING: serve ledger not loaded: {e}")
        self.journal.mark_start({
            "device": str(self.session.device),
            "warm": restart,
            "aot": self.aot_info,
            "pid": os.getpid()})
        if not self._listeners:
            self._bind()
        self.ready = True
        self._start_accepting()
        obs.inc("serve.started")
        print(f"[serve] ready on "
              f"{','.join(ep.spec for ep in self.endpoints)} "
              f"(device={self.session.device}, slots={self.config.slots},"
              f" depth={self.queue.depth}, warm={restart})")

    def _bind(self) -> None:
        specs = [self.config.socket_path]
        if self.config.tcp:
            tcp = str(self.config.tcp)
            specs.append(tcp if tcp.startswith("tcp:") else f"tcp:{tcp}")
        for ep in transport.parse_endpoints(specs):
            ls = transport.listen(ep)
            self._listeners.append(ls)
            self.endpoints.append(transport.bound_endpoint(ls))

    def _start_accepting(self) -> None:
        if self._accept_threads:
            return  # bind_early already started them
        for i, ls in enumerate(self._listeners):
            th = threading.Thread(
                target=self._accept_loop, args=(ls,),
                name=f"serve-accept-{i}", daemon=True)
            self._accept_threads.append(th)
            th.start()

    def _aot_precompile(self) -> None:
        """Full-corpus AOT warmth before readiness: plan every query in
        the configured stream file(s) (``canonical_key`` registers the
        fingerprint + plan cache without executing), so combined with
        preloaded compile records a replica's first seen-shape query
        compiles nothing.  Defects degrade to cold queries, never a
        failed boot."""
        corpus = self.config.aot_corpus
        if not corpus:
            return
        t0 = time.time()
        import glob as _glob
        if os.path.isdir(corpus):
            files = sorted(_glob.glob(os.path.join(corpus, "query_*.sql")))
        else:
            files = [corpus]
        planned = errors = 0
        for path in files:
            try:
                queries = power.gen_sql_from_stream(path)
            except Exception as e:  # noqa: BLE001
                print(f"WARNING: aot corpus {path} unreadable: {e}")
                errors += 1
                continue
            for name, sql in queries.items():
                try:
                    self.session.canonical_key(sql)
                    planned += 1
                except Exception as e:  # noqa: BLE001
                    errors += 1
                    print(f"WARNING: aot precompile skipped {name}: {e}")
        self.aot_info = {"files": len(files), "planned": planned,
                         "errors": errors,
                         "wall_s": round(time.time() - t0, 3)}
        obs.inc("serve.aot.planned", planned)
        print(f"[serve] aot precompile: {self.aot_info}")

    def serve_forever(self) -> None:
        self.start()
        self._stopped.wait()

    def drain(self, reason: str = "drain") -> dict:
        """Graceful shutdown: stop admission, finish in-flight work,
        flush artifacts, journal the clean marker.  Idempotent; a hung
        in-flight query is abandoned by the watchdog, so this returns
        within ~query_timeout even under a wedged engine."""
        with self._drain_lock:
            if self.draining:
                self._stopped.wait()
                return self.drain_summary or {}
            self.draining = True
        obs.inc("serve.drain.initiated")
        print(f"[serve] draining ({reason}): admission stopped, "
              f"finishing in-flight queries")
        for ls in self._listeners:
            try:
                ls.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns.values())
        for conn in conns:
            self.scheduler.close(conn.sid)
        timeout = self.config.resolved_timeout_s() + 30.0
        for conn in conns:
            th = conn.executor
            # a connection accepted a moment ago may not have started its
            # executor yet (the JAX server joins it and raises, and its
            # drain never ends); its stream is closed, so once started it
            # finds nothing to run
            if th is not None and th.ident is not None and \
                    th is not threading.current_thread():
                th.join(timeout)
        inflight_done = obs.counters_snapshot().get("serve.ok", 0)
        self._flush(reason)
        for conn in conns:
            try:
                conn.sock.close()
            except OSError:
                pass
        self.ready = False
        self.drain_summary = {
            "reason": reason,
            "ok_total": inflight_done,
            "connections": len(conns),
        }
        obs.inc("serve.drain.completed")
        print(f"[serve] drain complete: {self.drain_summary}")
        self._stopped.set()
        return self.drain_summary

    def _flush(self, reason: str) -> None:
        """Persist everything a restart (or postmortem) needs."""
        self._persist_compiled(force=True)
        if self.config.slo_path:
            try:
                self.slo.export(self.config.slo_path)
            except Exception as e:  # noqa: BLE001
                print(f"WARNING: SLO export failed: {e}")
        self.journal.mark_clean_shutdown({"reason": reason})

    # -- accept / per-connection threads -------------------------------------

    def _accept_loop(self, listener: socket.socket) -> None:
        while not self.draining:
            try:
                sock, _addr = listener.accept()
            except OSError:
                break  # listener closed by drain
            transport.configure(sock)  # per-connection read timeout
            try:
                faults.check("serve.accept")
            except Exception as e:  # noqa: BLE001 — injected fault:
                # drop the connection; the client's reconnect path is
                # exactly what this probe exists to exercise
                obs.inc("serve.accept.faulted")
                print(f"[serve] accept fault, dropping connection: {e}")
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            with self._conns_lock:
                self._conn_seq += 1
                sid = f"conn{self._conn_seq}"
                conn = _Conn(sid, sock)
                self._conns[sid] = conn
            obs.inc("serve.accepted")
            self.scheduler.open_stream(sid)
            conn.reader = threading.Thread(
                target=self._reader_loop, args=(conn,),
                name=f"serve-read-{sid}", daemon=True)
            conn.executor = threading.Thread(
                target=self._executor_loop, args=(conn,),
                name=f"serve-exec-{sid}", daemon=True)
            conn.reader.start()
            conn.executor.start()

    def _reader_loop(self, conn: _Conn) -> None:
        try:
            while True:
                try:
                    msg = protocol.recv_msg(conn.sock)
                except (protocol.ProtocolError, OSError) as e:
                    if not self.draining:
                        print(f"[serve] {conn.sid} read error: {e}")
                    break
                if msg is None:
                    break  # clean hangup
                try:
                    self._handle(conn, msg)
                except OSError:
                    break  # peer gone mid-reply
        finally:
            self.scheduler.close(conn.sid)
            obs.inc("serve.connections.closed")

    def _handle(self, conn: _Conn, msg: dict) -> None:
        op = msg.get("op")
        rid = str(msg.get("id") or f"r{self._next_req()}")
        if op == "ping":
            conn.send({"status": "ok", "id": rid, "pong": True})
        elif op == "ready":
            conn.send({"status": "ok", "id": rid,
                       "ready": self.ready and not self.draining})
        elif op == "health":
            conn.send({"status": "ok", "id": rid,
                       "health": self.health()})
        elif op == "probe":
            conn.send({"status": "ok", "id": rid,
                       "probe": self.probe_doc()})
        elif op == "stats":
            conn.send({"status": "ok", "id": rid,
                       "counters": obs.counters_snapshot(),
                       "slo": self.slo.snapshot(),
                       "engine": self.engine_doc()})
        elif op == "drain":
            conn.send({"status": "ok", "id": rid, "draining": True})
            threading.Thread(target=self.drain,
                             kwargs={"reason": "client-request"},
                             name="serve-drain", daemon=True).start()
        elif op == "sql":
            self._admit_sql(conn, rid, msg)
        else:
            conn.send({"status": "error", "id": rid,
                       "error": f"unknown op {op!r}",
                       "taxonomy": "permanent"})

    def _next_req(self) -> int:
        with self._conns_lock:
            self._req_seq += 1
            return self._req_seq

    def _admit_sql(self, conn: _Conn, rid: str, msg: dict) -> None:
        """Reader-side admission: typed shedding BEFORE any engine
        work, so an overloaded server answers in O(socket write)."""
        tenant = str(msg.get("tenant") or "default")
        sql = msg.get("sql")
        obs.inc("serve.requests")
        if not sql or not isinstance(sql, str):
            conn.send({"status": "error", "id": rid,
                       "error": "sql op needs a 'sql' string",
                       "taxonomy": "permanent"})
            return
        if self.draining:
            obs.inc("serve.draining_rejects")
            conn.send({"status": "draining", "id": rid,
                       "error": "server is draining"})
            return
        if not self.ready:
            # bind_early boot: the listener answers before the session
            # is warm.  Retryable overload (NOT draining) so a fleet
            # client's retry lands on a ready sibling and a lone
            # client just backs off until readiness flips.
            obs.inc("serve.warming_rejects")
            conn.send({"status": "overloaded", "id": rid,
                       "error": "server warming up (not ready)",
                       "retry_after_s": 0.25})
            return
        try:
            self.budgets.acquire(tenant)
            self.queue.admit(deadline_s=msg.get("deadline_s"))
        except Overloaded as e:
            obs.inc("serve.overloaded")
            self.slo.record(tenant, 0.0, "overloaded")
            conn.send({"status": "overloaded", "id": rid,
                       "error": str(e),
                       "retry_after_s": e.retry_after_s})
            return
        except Rejected as e:
            obs.inc("serve.rejected")
            obs.inc(f"serve.rejected.{e.reason}")
            self.slo.record(tenant, 0.0, "rejected")
            conn.send({"status": "rejected", "id": rid,
                       "error": str(e), "reason": e.reason})
            return
        # canonical key drives BOTH compile dedup and the breaker /
        # quarantine identity: a tripped plan SHAPE fast-fails every
        # rendering of it, whatever the literals
        canon = self.session.canonical_key(sql)
        try:
            self.breaker.check(canon)
        except Rejected as e:
            self.queue.release()
            obs.inc("serve.rejected")
            obs.inc("serve.rejected.circuit-open")
            self.slo.record(tenant, 0.0, "rejected")
            conn.send({"status": "rejected", "id": rid,
                       "error": str(e), "reason": e.reason})
            return
        req = {"id": rid, "sql": sql, "tenant": tenant,
               "name": msg.get("name"), "canon": canon,
               "max_rows": msg.get("max_rows", 100),
               "admitted_at": time.time()}
        with conn.plock:
            conn.pending[rid] = req
        try:
            self.scheduler.feed(conn.sid, rid, sql)
        except ValueError:  # stream closed by a racing drain
            with conn.plock:
                conn.pending.pop(rid, None)
            self.queue.release()
            obs.inc("serve.draining_rejects")
            conn.send({"status": "draining", "id": rid,
                       "error": "server is draining"})

    # -- executor ------------------------------------------------------------

    def _executor_loop(self, conn: _Conn) -> None:
        t0 = time.time()
        view = self.scheduler.view(conn.sid)
        while True:
            rid = view.next(time.time() - t0)
            if rid is None:
                break
            with conn.plock:
                req = conn.pending.get(rid)
            if req is None:
                view.done(rid, failed=True)
                continue
            failed = self._dispatch(conn, req)
            view.done(rid, failed=failed)
            with conn.plock:
                conn.pending.pop(rid, None)

    def _dispatch(self, conn: _Conn, req: dict) -> bool:
        """Run one admitted request end to end; returns failed?"""
        rid, tenant, canon = req["id"], req["tenant"], req["canon"]
        name = req.get("name") or rid
        qspan = obs.span(name, cat="query", collect=True,
                         tenant=tenant, serve=1)
        t0 = time.time()
        try:
            # fault injection only: an injected replica crash takes the
            # WHOLE process down mid-flight (a SIGKILL without the
            # signal) — the supervisor restarts us, the client fails
            # over to a sibling
            faults.check("serve.replica.crash", key=name)
        except faults.InjectedFault:
            obs.inc("serve.replica.crashed")
            print(f"[serve] injected replica crash on {name}; exiting",
                  flush=True)
            os._exit(17)
        try:
            # pre-retry, client-visible: an injected dispatch fault
            # reaches the client as a typed transient error and the
            # CLIENT retries
            faults.check("serve.dispatch", key=name)
            with qspan:
                result, attempts = faults.run_with_retry(
                    lambda: self._run_guarded(req),
                    key=canon, policy=self.retry_policy,
                    quarantine=self.quarantine)
        except Exception as e:  # noqa: BLE001 — classified reply
            from ndstpu_torch.faults import taxonomy
            klass = getattr(e, "taxonomy", None) or taxonomy.classify(e)
            wall = time.time() - t0
            obs.inc("serve.errors")
            if self.breaker.note_failure(canon):
                obs.inc("serve.breaker.tripped")
                print(f"[serve] circuit tripped for plan shape "
                      f"{canon[:48]!r}")
            self.slo.record(tenant, wall, "error")
            try:
                conn.send({"status": "error", "id": rid,
                           "error": str(e),
                           "type": type(e).__name__,
                           "taxonomy": klass,
                           "attempts": getattr(e, "attempts", 1)})
            except OSError:
                pass
            return True
        finally:
            self.queue.release()
        wall = qspan.wall_s or (time.time() - t0)
        obs.inc("serve.ok")
        self.breaker.note_success(canon)
        self.queue.observe(wall)  # EWMA behind retry_after_s hints
        self.slo.record(tenant, wall, "ok")
        self.journal.mark_query(name, req["sql"], canon_key=canon)
        self._persist_compiled()
        self._ledger_append(name, tenant, qspan)
        resp = {"status": "ok", "id": rid,
                "wall_s": round(wall, 6), "attempts": attempts}
        resp.update(result)
        try:
            conn.send(resp)
        except OSError:
            pass  # client gone; work is journaled regardless
        return False

    def _run_guarded(self, req: dict) -> dict:
        """One attempt, under the device gate + watchdog."""
        timeout = self.config.resolved_timeout_s()
        with self.gate.slot():
            if timeout <= 0:
                return self._run_query(self.session, req)
            slot: dict = {}
            abandoned = threading.Event()
            with self._session_lock:
                sess = self.session

            def work():
                try:
                    with abandonable(abandoned):
                        slot["result"] = self._run_query(sess, req)
                except Exception as e:  # noqa: BLE001
                    slot["err"] = e

            th = threading.Thread(target=work, daemon=True,
                                  name=f"serve-q-{req['id']}")
            th.start()
            th.join(timeout)
            if th.is_alive():
                # power watchdog idiom: abandon the wedged thread and
                # swap every future request onto a fresh session — the
                # drain path depends on this never blocking forever; the
                # thread stops at its next cancellation point
                abandoned.set()
                self._zombies.append({"th": th, "name": req["id"]})
                obs.inc("serve.watchdog.abandoned")
                self._swap_session(sess)
                raise TimeoutError(
                    f"{req['id']} hung > {timeout:.0f}s; abandoned "
                    f"(server continues on a fresh session)")
            if "err" in slot:
                raise slot["err"]
            return slot["result"]

    def _swap_session(self, old: Session) -> None:
        with self._session_lock:
            if self.session is not old:
                return  # another watchdog already swapped
            try:
                # the same catalog, views and device tables; none of the
                # old session's plans or graphs (the zombie may still use
                # them)
                fresh = old.fresh()
                self.session = fresh
                if self.config.compile_records:
                    fresh.preload_compiled(self.config.compile_records)
            except Exception as e:  # noqa: BLE001
                print(f"WARNING: fresh session setup after hang "
                      f"incomplete: {e}")

    def _run_query(self, session: Session, req: dict) -> dict:
        """Execute snapshot-pinned; write or collect the result."""
        sql = req["sql"]
        pin = None
        try:
            if isinstance(parse_statement(sql), ast.Query):
                pin = session.pin_snapshot()
        except Exception:  # noqa: BLE001 — let sql() raise properly
            pass
        result = session.sql(sql, pin=pin)
        if result is None:
            return {"rows": 0, "ddl": True}
        name = req.get("name")
        if name and self.config.output_prefix:
            safe = os.path.normpath(str(name))
            if safe.startswith(("..", "/")):
                raise ValueError(f"bad output name {name!r}")
            out = power.ensure_valid_column_names(result)
            dest = os.path.join(self.config.output_prefix, safe)
            os.makedirs(dest, exist_ok=True)
            at = columnar.to_arrow(out)
            if self.config.output_format == "parquet":
                import pyarrow.parquet as pq
                pq.write_table(at, os.path.join(dest, "part-0.parquet"))
            elif self.config.output_format == "csv":
                import pyarrow.csv as pacsv
                pacsv.write_csv(at, os.path.join(dest, "part-0.csv"))
            else:
                raise ValueError(f"unsupported output format "
                                 f"{self.config.output_format}")
            return {"rows": result.num_rows, "output": safe}
        rows = result.to_rows()
        cap = int(req.get("max_rows") or 100)
        return {"rows": len(rows),
                "columns": list(result.columns),
                "data": [list(r) for r in rows[:cap]],
                "truncated": len(rows) > cap}

    # -- persistence / health ------------------------------------------------

    def _persist_compiled(self, force: bool = False) -> None:
        """Incremental compile-record persistence: a SIGKILL'd server
        must warm-restart from everything compiled before the kill, so
        records save after every compile-growing request, not just on
        clean drain."""
        if not self.config.compile_records:
            return
        n = self.session.compiled_count()
        if not force and n <= self._saved_compiled:
            return
        try:
            self.session.save_compiled(self.config.compile_records)
            self._saved_compiled = n
        except Exception as e:  # noqa: BLE001
            print(f"WARNING: compile records not saved: {e}")

    def _ledger_append(self, name: str, tenant: str, qspan) -> None:
        if self.ledger is None:
            return
        try:
            b = qspan.buckets or {}
            self.ledger.append([ledger_mod.make_entry(
                name, qspan.wall_s, b.get("compile_s", 0.0),
                b.get("execute_s", 0.0),
                engine=power.ledger_engine(self.session.device),
                scale_factor=self.config.scale_factor, seed="serve",
                source="serve",
                extra={"tenant": tenant, "mode": "serve"})])
        except Exception as e:  # noqa: BLE001 — ledger never fails a
            print(f"WARNING: serve ledger append failed: {e}")  # query

    def probe_doc(self) -> dict:
        """The fleet supervisor's liveness/readiness view.  Cheap —
        answered even while a ``bind_early`` boot is still warming."""
        return {
            "alive": True,
            "ready": self.ready and not self.draining,
            "draining": self.draining,
            "pid": os.getpid(),
            "replica_id": self.config.replica_id,
            "endpoints": [ep.spec for ep in self.endpoints],
            "started_at": self._started_at,
            "uptime_s": round(time.time() - self._started_at, 3),
            "aot": self.aot_info,
            "queue": self.queue.snapshot(),
        }

    def engine_doc(self) -> dict:
        """The live session's executor counters and, on a card, its
        memory: host state only (the executor's counts and the caching
        allocator's statistics), so a reader thread may read it while an
        executor thread captures a graph."""
        sess = self.session
        if sess is None:
            return {}
        exe = sess.executor
        doc = {"device": str(sess.device),
               "discoveries": exe.n_discoveries,
               "segment_discoveries": exe.n_seg_discoveries,
               "captures": exe.n_captures,
               "evictions": exe.n_evictions,
               "guard_failures": exe.n_guard_failures,
               "replays": exe.n_replays,
               "oom_retries": exe.n_oom_retries,
               "compiled": sess.compiled_count(),
               "graph_budget_bytes": exe.graph_budget}
        if sess.device.type == "cuda":
            doc.update(
                allocated_bytes=torch.cuda.memory_allocated(sess.device),
                peak_bytes=torch.cuda.max_memory_allocated(sess.device),
                reserved_bytes=torch.cuda.memory_reserved(sess.device))
        return doc

    def health(self) -> dict:
        c = obs.counters_snapshot()
        return {
            "alive": True,
            "ready": self.ready and not self.draining,
            "draining": self.draining,
            "uptime_s": round(time.time() - self._started_at, 3),
            "device": str(self.session.device)
            if self.session is not None else self.config.device,
            "replica_id": self.config.replica_id,
            "endpoints": [ep.spec for ep in self.endpoints],
            "connections": len(self._conns),
            "admitted": self.queue.admitted,
            "admitted_peak": self.queue.peak,
            "queue_depth": self.queue.depth,
            "est_wait_s": round(self.queue.est_wait_s, 6),
            "admission_model": self.admission_model,
            "compiled": self.session.compiled_count()
            if self.session is not None else 0,
            "zombies": sum(1 for z in self._zombies
                           if z["th"].is_alive()),
            "requests": c.get("serve.requests", 0),
            "ok": c.get("serve.ok", 0),
            "errors": c.get("serve.errors", 0),
            "overloaded": c.get("serve.overloaded", 0),
            "rejected": c.get("serve.rejected", 0),
        }
