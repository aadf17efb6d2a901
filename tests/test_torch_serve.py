"""The port's serve layer (``ndstpu_torch/serve``) against the JAX
package's (``ndstpu/serve``), case by case.

Each case of ``tests/test_serve.py`` runs here once for each package
(``pkg``), on each package's own modules and, where it needs a server, on
a tiny table through each package's own ``Session`` on the CPU: protocol
round trips and truncated frames, connection faults classified
transient, the scheduler's continuous feed and its dedup, tenant budgets,
the admission queue and its EWMA hint, the circuit breaker, the journal's
replay state, the SLO percentiles, the server's typed answers (budget,
dispatch faults, drain behind a hung query, draining, transports,
failover, readiness, the AOT corpus planned before readiness), and the
fleet supervisor's adoption, restart with fencing, probe threshold, kill
switch and default endpoints.

Where a case has a JAX counterpart, the same inputs must give the same
outputs across the packages: frames byte for byte, endpoint parses,
admission, budget and breaker outcomes on one scripted clock, journal
replay states, SLO snapshots, fleet endpoints, and the two servers'
answers to the same requests over the same table.  The port alone adds
its warm restart (no discovery for a key the killed server saw), the
admission depth from its memory planner, the fresh session after a hang,
the fleet's launch of the port's server, and a drain that races a
connection's start (the JAX server's drain dies there).
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import socket
import threading
import time
import types
import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import ndstpu.faults as jax_faults
from ndstpu import obs as jax_obs
from ndstpu.engine import columnar as jax_columnar
from ndstpu.engine import memplan as jax_memplan
from ndstpu.engine.session import Session as JaxSession
from ndstpu.faults import taxonomy as jax_taxonomy
from ndstpu.harness import scheduler as jax_scheduler
from ndstpu.io import atomic as jax_atomic
from ndstpu.io import commit as jax_commit
from ndstpu.io import loader as jax_loader
from ndstpu.serve import client as jax_client
from ndstpu.serve import fleet as jax_fleet
from ndstpu.serve import lifecycle as jax_lifecycle
from ndstpu.serve import overload as jax_overload
from ndstpu.serve import protocol as jax_protocol
from ndstpu.serve import server as jax_server
from ndstpu.serve import transport as jax_transport
from ndstpu_torch import faults, obs
from ndstpu_torch.engine import columnar, memplan
from ndstpu_torch.engine.session import Session
from ndstpu_torch.faults import taxonomy
from ndstpu_torch.harness import scheduler
from ndstpu_torch.io import atomic, commit
from ndstpu_torch.io.catalog import Catalog
from ndstpu_torch.serve import (client, fleet, lifecycle, overload, protocol,
                                server, transport)


def _jax_session():
    cat = jax_loader.Catalog()
    cat.register("t", jax_columnar.Table({
        "a": jax_columnar.Column(np.arange(10, dtype=np.int32),
                                 jax_columnar.INT32, None),
        "b": jax_columnar.Column(np.arange(10, dtype=np.int32) % 3,
                                 jax_columnar.INT32, None)}))
    return JaxSession(cat, backend="cpu")


def _torch_session():
    cat = Catalog()
    cat.register("t", columnar.Table({
        "a": columnar.Column(np.arange(10, dtype=np.int32), columnar.INT32,
                             None),
        "b": columnar.Column(np.arange(10, dtype=np.int32) % 3,
                             columnar.INT32, None)}))
    return Session(cat, device="cpu")


PKG = {
    "jax": types.SimpleNamespace(
        name="jax", faults=jax_faults, obs=jax_obs, taxonomy=jax_taxonomy,
        scheduler=jax_scheduler, atomic=jax_atomic, commit=jax_commit,
        client=jax_client, fleet=jax_fleet, lifecycle=jax_lifecycle,
        overload=jax_overload, protocol=jax_protocol, server=jax_server,
        transport=jax_transport, session=_jax_session,
        config={"engine": "cpu"}),
    "torch": types.SimpleNamespace(
        name="torch", faults=faults, obs=obs, taxonomy=taxonomy,
        scheduler=scheduler, atomic=atomic, commit=commit, client=client,
        fleet=fleet, lifecycle=lifecycle, overload=overload,
        protocol=protocol, server=server, transport=transport,
        session=_torch_session, config={}),
}


@pytest.fixture(params=sorted(PKG))
def pkg(request):
    return PKG[request.param]


def _start(pkg, tmp_path, tag, session=None, **cfg):
    defaults = dict(
        socket_path=str(tmp_path / f"{tag}.sock"),
        journal_path=str(tmp_path / f"journal_{tag}.jsonl"),
        slo_path=str(tmp_path / f"SLO_{tag}.json"),
        ledger_path="none", query_timeout_s=30.0, **pkg.config)
    defaults.update(cfg)
    srv = pkg.server.QueryServer(pkg.server.ServeConfig(**defaults),
                                 session=session or pkg.session())
    srv.start()
    return srv


def _settled(srv, timeout_s: float = 10.0) -> None:
    """Wait until every connection the server accepted has started its
    executor thread.  The JAX server's drain joins each connection's
    thread, and joining one its accept thread made but has not started
    yet raises (``ndstpu/serve/server.py:309``, ROADMAP C); the port's
    drain skips such a thread.  Waiting first keeps that race of the
    reference out of what these cases compare."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        with srv._conns_lock:
            threads = [c.executor for c in srv._conns.values()]
        if all(th is None or th._started.is_set() for th in threads):
            return
        time.sleep(0.01)


@pytest.fixture
def serve_env(pkg, tmp_path):
    """A started server of ``pkg`` over its tiny cpu session and one
    client; drained on teardown.  A factory, so a case can tune
    ServeConfig."""
    made = []

    def make(session=None, **cfg):
        cfg.setdefault("output_prefix", str(tmp_path / f"out{len(made)}"))
        srv = _start(pkg, tmp_path, f"s{len(made)}", session, **cfg)
        cli = pkg.client.ServeClient(srv.config.socket_path, retries=4,
                                     connect_timeout_s=10.0)
        assert cli.wait_ready(10.0)
        made.append((srv, cli))
        return srv, cli

    yield make
    for srv, cli in made:
        cli.close()
        if not srv.draining:
            _settled(srv)
            srv.drain(reason="teardown")


# -- protocol -----------------------------------------------------------------

def test_protocol_roundtrip_and_bounds(pkg):
    a, b = socket.socketpair()
    try:
        msg = {"op": "sql", "sql": "SELECT 1; -- '\n\x00 unicode ☃"}
        pkg.protocol.send_msg(a, msg)
        assert pkg.protocol.recv_msg(b) == msg
        a.close()
        assert pkg.protocol.recv_msg(b) is None  # clean EOF
    finally:
        b.close()
    c, d = socket.socketpair()
    try:
        c.sendall(b"\x7f\xff\xff\xff")  # absurd length prefix
        with pytest.raises(pkg.protocol.ProtocolError):
            pkg.protocol.recv_msg(d)
    finally:
        c.close()
        d.close()


def test_protocol_truncated_frame_is_error(pkg):
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00\x00\x10partial")
        a.close()
        with pytest.raises(pkg.protocol.ProtocolError):
            pkg.protocol.recv_msg(b)
    finally:
        b.close()


FRAMES = [
    {"op": "ping", "id": "p1"},
    {"op": "sql", "id": "q", "sql": "SELECT 'é' AS x -- ☃\n", "tenant": "t",
     "deadline_s": 1.5, "max_rows": 7},
    {"status": "ok", "id": "r", "rows": 2, "columns": ["d", "s"],
     "data": [["2000-01-01", 12.34], [None, -0.0]], "truncated": False},
    {"status": "error", "error": "x" * 5000, "taxonomy": "permanent",
     "attempts": 3, "nested": {"a": [1, 2.5, None, True]}},
]


def _frame_bytes(proto, msg) -> bytes:
    a, b = socket.socketpair()
    try:
        proto.send_msg(a, msg)
        a.close()
        out = bytearray()
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return bytes(out)
            out.extend(chunk)
    finally:
        b.close()


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_are_byte_identical_across_packages(i):
    msg = FRAMES[i]
    got, want = _frame_bytes(protocol, msg), _frame_bytes(jax_protocol, msg)
    assert got == want
    assert protocol.MAX_FRAME_BYTES == jax_protocol.MAX_FRAME_BYTES
    # each package reads the other's frame
    for send, recv in ((protocol, jax_protocol), (jax_protocol, protocol)):
        a, b = socket.socketpair()
        try:
            send.send_msg(a, msg)
            assert recv.recv_msg(b) == json.loads(json.dumps(msg))
        finally:
            a.close()
            b.close()


# -- transports ---------------------------------------------------------------

SPECS = ["unix:/tmp/a.sock", "/tmp/b.sock", "tcp:127.0.0.1:9001",
         "localhost:80", "tcp:[::1]:7", "rel/dir:x", "unix:/a,tcp:h:1",
         ["tcp:h:2", "/c.sock,/d.sock"]]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_endpoint_parses_are_the_jax_ones(spec):
    got = [(e.kind, e.path, e.host, e.port, e.spec)
           for e in transport.parse_endpoints(spec)]
    want = [(e.kind, e.path, e.host, e.port, e.spec)
            for e in jax_transport.parse_endpoints(spec)]
    assert got == want


def test_bad_endpoint_specs_raise_alike():
    for bad in ("", "tcp:nohostport", "tcp::9"):
        with pytest.raises(ValueError):
            jax_transport.parse_endpoint(bad)
        with pytest.raises(ValueError):
            transport.parse_endpoint(bad)


def test_read_timeout_env(pkg, monkeypatch):
    monkeypatch.setenv(pkg.transport.READ_TIMEOUT_ENV, "0")
    assert pkg.transport.read_timeout_s() is None
    monkeypatch.setenv(pkg.transport.READ_TIMEOUT_ENV, "2.5")
    assert pkg.transport.read_timeout_s() == 2.5
    monkeypatch.setenv(pkg.transport.READ_TIMEOUT_ENV, "x")
    assert pkg.transport.read_timeout_s() == \
        pkg.transport.DEFAULT_READ_TIMEOUT_S


# -- connection-fault taxonomy ------------------------------------------------

def test_connection_faults_classify_transient(pkg):
    tx = pkg.taxonomy
    assert tx.classify(socket.timeout("timed out")) == "transient"
    assert tx.classify(
        ConnectionRefusedError("connection refused")) == "transient"
    assert tx.classify(ConnectionResetError()) == "transient"
    assert tx.classify(BrokenPipeError()) == "transient"
    assert tx.classify_name("timeout", "") == "transient"
    assert tx.classify_name(
        "SomeWrapperError", "upstream: Connection refused") == "transient"
    assert tx.classify_name(
        "SomeWrapperError", "Broken pipe on fd 7") == "transient"
    # the serve layer's typed errors carry their own kind
    assert tx.classify(pkg.overload.Overloaded("full")) == "transient"
    assert tx.classify(pkg.overload.Rejected("no", "deadline")) == \
        "permanent"
    assert tx.classify(pkg.client.NoHealthyEndpoint(["a"], "x")) == \
        "transient"
    assert tx.classify(pkg.client.ServerDraining("d")) == "transient"


# -- continuous-feed scheduler ------------------------------------------------

def test_scheduler_continuous_feed(pkg):
    sched = pkg.scheduler.StreamScheduler({})
    view = sched.open_stream("c1")
    sched.feed("c1", "q1", "SELECT 1")
    sched.feed("c1", "q2", "SELECT 2")
    assert view.next(0.0) in ("q1", "q2")
    view.done("q1")
    got = []

    def drain_view():
        while True:
            n = view.next(0.0)
            if n is None:
                return
            got.append(n)
            view.done(n)

    th = threading.Thread(target=drain_view, daemon=True)
    th.start()
    time.sleep(0.1)
    sched.feed("c1", "q3", "SELECT 3")  # wakes the blocked next()
    time.sleep(0.2)
    sched.close("c1")
    th.join(5.0)
    assert not th.is_alive()
    assert set(got) == {"q2", "q3"}
    with pytest.raises(ValueError):
        sched.feed("c1", "q4", "SELECT 4")  # closed stream


def test_scheduler_feed_dedups_across_streams(pkg):
    sched = pkg.scheduler.StreamScheduler(
        {}, key_fn=lambda s: " ".join(s.lower().split()))
    sched.open_stream("a")
    sched.open_stream("b")
    sched.feed("a", "qa", "SELECT * FROM t")
    sched.feed("b", "qb", "select  *  from  t")  # same normalized key
    va, vb = sched.view("a"), sched.view("b")
    assert va.next(0.0) == "qa"
    assert vb.next(0.0) == "qb"
    va.done("qa")
    assert sched._key[("a", "qa")] == sched._key[("b", "qb")]
    assert sched._key[("a", "qa")] in sched.compiled


# -- overload primitives ------------------------------------------------------

def test_tenant_budget_isolation(pkg):
    clock = [0.0]
    budgets = pkg.overload.TenantBudgets(capacity=2, refill_per_s=1.0,
                                         clock=lambda: clock[0])
    budgets.acquire("a")
    budgets.acquire("a")
    with pytest.raises(pkg.overload.Rejected) as ei:
        budgets.acquire("a")
    assert ei.value.reason == "tenant-budget"
    budgets.acquire("b")  # other tenants unaffected
    clock[0] += 1.5  # refill restores tenant a
    budgets.acquire("a")


def test_admission_queue_overload_and_deadline_shed(pkg):
    q = pkg.overload.AdmissionQueue(depth=2, est_wait_s=1.0)
    q.admit()
    q.admit(deadline_s=10.0)
    with pytest.raises(pkg.overload.Overloaded) as ei:
        q.admit()
    assert ei.value.retry_after_s > 0
    q.release()
    with pytest.raises(pkg.overload.Rejected) as ei:
        q.admit(deadline_s=0.5)
    assert ei.value.reason == "deadline"
    q.admit(deadline_s=5.0)


def test_admission_queue_ewma_hint_grows_and_decays(pkg):
    q = pkg.overload.AdmissionQueue(depth=2, est_wait_s=0.25, ewma_alpha=0.5)
    assert q.est_wait_s == pytest.approx(0.25)
    for _ in range(4):
        q.observe(2.0)
    grown = q.est_wait_s
    assert grown > 1.0
    for _ in range(8):
        q.observe(0.01)
    assert q.est_wait_s < 0.1 < grown
    snap = q.snapshot()
    assert snap["observed"] == 12
    assert snap["est_wait_s"] == pytest.approx(q.est_wait_s, abs=1e-5)


def test_admission_queue_shed_hint_tracks_ewma(pkg):
    q = pkg.overload.AdmissionQueue(depth=1, est_wait_s=0.25, ewma_alpha=1.0)
    q.observe(3.0)
    q.admit()
    with pytest.raises(pkg.overload.Overloaded) as ei:
        q.admit()
    assert ei.value.retry_after_s == pytest.approx(3.0)
    q.release()


def test_circuit_breaker_trips_and_recovers_after_cooldown(pkg):
    clock = [0.0]
    quarantine = pkg.faults.Quarantine(max_failures=1)
    cb = pkg.overload.CircuitBreaker(quarantine, cooldown_s=10.0,
                                     clock=lambda: clock[0])
    cb.check("fp1")
    quarantine.note_failure("fp1", "permanent")
    assert cb.note_failure("fp1") is True
    assert cb.state("fp1") == "open"
    with pytest.raises(pkg.overload.Rejected) as ei:
        cb.check("fp1")
    assert ei.value.reason == "circuit-open"
    clock[0] += 11.0
    assert cb.state("fp1") == "half-open"
    cb.check("fp1")
    with pytest.raises(pkg.overload.Rejected):
        cb.check("fp1")
    cb.note_success("fp1")
    assert cb.state("fp1") == "closed"
    cb.check("fp1")
    assert cb.note_failure("fp2") is False
    cb.check("fp2")


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e), getattr(e, "reason", None),
                getattr(e, "retry_after_s", None))
    return ("ok",)


def _overload_trace(ov, flt, ops):
    """Run one scripted sequence of guard operations on one scripted clock;
    the outcomes and the guards' states after each."""
    clock = [0.0]
    tick = lambda: clock[0]  # noqa: E731
    q = ov.AdmissionQueue(depth=3, est_wait_s=0.5, ewma_alpha=0.3,
                          clock=tick)
    tb = ov.TenantBudgets(capacity=3, refill_per_s=0.5, clock=tick)
    quarantine = flt.Quarantine(max_failures=2)
    cb = ov.CircuitBreaker(quarantine, cooldown_s=4.0, clock=tick)
    out = []
    for op, arg in ops:
        if op == "wait":
            clock[0] += arg
            res = ("ok",)
        elif op == "admit":
            res = _outcome(lambda: q.admit(deadline_s=arg))
        elif op == "release":
            res = _outcome(q.release)
        elif op == "observe":
            res = _outcome(lambda: q.observe(arg))
        elif op == "acquire":
            res = _outcome(lambda: tb.acquire(f"t{int(arg) % 2}"))
        elif op == "check":
            res = _outcome(lambda: cb.check(f"k{int(arg) % 2}"))
        elif op == "fail":
            key = f"k{int(arg) % 2}"
            quarantine.note_failure(key, "permanent")
            res = ("tripped", cb.note_failure(key))
        else:
            res = _outcome(lambda: cb.note_success(f"k{int(arg) % 2}"))
        out.append((res, q.snapshot(), round(tb.tokens("t0"), 9),
                    cb.state("k0"), cb.state("k1"), cb.tripped))
    return out


_OPS = st.lists(st.tuples(
    st.sampled_from(["wait", "admit", "release", "observe", "acquire",
                     "check", "fail", "success"]),
    st.one_of(st.none(), st.floats(0, 6, allow_nan=False))).map(
        lambda t: (t[0], (t[1] or 0.0) if t[0] != "admit" else t[1])),
    max_size=30)


@settings(max_examples=60, deadline=None)
@given(_OPS)
def test_overload_outcomes_are_the_jax_ones(ops):
    assert _overload_trace(overload, faults, ops) == \
        _overload_trace(jax_overload, jax_faults, ops)


# -- lifecycle: journal replay, SLO -------------------------------------------

def test_journal_replay_state(pkg, tmp_path):
    lc = pkg.lifecycle
    j = lc.ServeJournal(str(tmp_path / "j.jsonl"))
    assert j.replay_state() == {"sqls": [], "clean": True}
    j.mark_start()
    j.mark_query("q1", "SELECT 1", canon_key="k1")
    j.mark_query("q1", "SELECT 1")  # dedup
    j.mark_query("q2", "SELECT 2")
    state = lc.ServeJournal(str(tmp_path / "j.jsonl")).replay_state()
    assert [r["sql"] for r in state["sqls"]] == ["SELECT 1", "SELECT 2"]
    assert state["clean"] is False
    j.mark_clean_shutdown()
    assert lc.ServeJournal(str(tmp_path / "j.jsonl")).replay_state()[
        "clean"] is True


def _strip_times(x):
    if isinstance(x, dict):
        return {k: _strip_times(v) for k, v in x.items()
                if k not in ("t", "exported_epoch_s",
                             "window_started_epoch_s")}
    if isinstance(x, list):
        return [_strip_times(v) for v in x]
    return x


JOURNALS = {
    "fresh": [],
    "crashed": [("start",), ("query", "q1", "SELECT 1", "k1"),
                ("query", "q2", "SELECT 2", None)],
    "clean": [("start",), ("query", "q1", "SELECT 1", "k1"), ("clean",)],
    "restarted after clean": [("start",), ("clean",), ("start",),
                              ("query", "q3", "SELECT 3", "k3"),
                              ("query", "q3b", "SELECT 3", "k3")],
}


@pytest.mark.parametrize("case", list(JOURNALS))
def test_journal_replay_states_are_the_jax_ones(case, tmp_path):
    states = []
    for lc, tag in ((lifecycle, "torch"), (jax_lifecycle, "jax")):
        j = lc.ServeJournal(str(tmp_path / f"{tag}.jsonl"))
        for ev in JOURNALS[case]:
            if ev[0] == "start":
                j.mark_start({"pid": 1})
            elif ev[0] == "clean":
                j.mark_clean_shutdown({"reason": "test"})
            else:
                j.mark_query(ev[1], ev[2], canon_key=ev[3])
        states.append(_strip_times(
            lc.ServeJournal(str(tmp_path / f"{tag}.jsonl")).replay_state()))
    assert states[0] == states[1]


def test_slo_tracker_percentiles_and_export(pkg, tmp_path):
    slo = pkg.lifecycle.SLOTracker()
    for ms in range(1, 101):
        slo.record("a", ms / 1000.0, "ok")
    slo.record("a", 0.0, "overloaded")
    slo.record("b", 0.005, "ok")
    doc = slo.export(str(tmp_path / "SLO.json"))
    assert doc["artifact"] == pkg.lifecycle.SLO_ARTIFACT
    a = doc["tenants"]["a"]
    assert a["count"] == 101 and a["overloaded"] == 1
    assert a["p50_ms"] == pytest.approx(50.0, abs=2.0)
    assert a["p95_ms"] == pytest.approx(95.0, abs=2.0)
    assert a["p99_ms"] == pytest.approx(99.0, abs=2.0)
    assert doc["tenants"]["b"]["p50_ms"] == pytest.approx(5.0, abs=1.0)
    assert json.loads((tmp_path / "SLO.json").read_text()) == doc


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(
    st.sampled_from(["a", "b", "c"]), st.floats(0, 5, allow_nan=False),
    st.sampled_from(["ok", "ok", "error", "overloaded", "rejected"])),
    max_size=60), st.integers(1, 8))
def test_slo_snapshots_are_the_jax_ones(records, window):
    docs = []
    for lc in (lifecycle, jax_lifecycle):
        slo = lc.SLOTracker(max_samples_per_tenant=window)
        for tenant, wall, outcome in records:
            slo.record(tenant, wall, outcome)
        docs.append(_strip_times(slo.snapshot()))
    assert docs[0] == docs[1]


# -- the server, end to end ---------------------------------------------------

def test_sql_roundtrip_output_and_journal(serve_env, pkg):
    srv, cli = serve_env()
    r = cli.sql("SELECT a, b FROM t WHERE a < 4 ORDER BY a")
    assert r["rows"] == 4 and r["data"][0] == [0, 0]
    r2 = cli.sql("SELECT sum(a) AS s FROM t", name="q_out")
    assert r2["rows"] == 1
    assert os.path.exists(os.path.join(
        srv.config.output_prefix, "q_out", "part-0.csv"))
    events = [rec["event"] for rec in
              pkg.atomic.read_jsonl(srv.config.journal_path)]
    assert events[0] == pkg.lifecycle.JOURNAL_START
    assert events.count(pkg.lifecycle.JOURNAL_QUERY) == 2
    health = cli.health()
    assert health["ready"] and health["ok"] >= 2


def test_bad_sql_is_permanent_error(serve_env, pkg):
    _, cli = serve_env()
    with pytest.raises(pkg.client.ServeError) as ei:
        cli.sql("SELEKT nope")
    assert ei.value.taxonomy == "permanent"


def test_tenant_at_budget_rejected_while_others_proceed(serve_env, pkg):
    _, cli = serve_env(tenant_tokens=2, tenant_refill_per_s=0.001)
    cli.sql("SELECT count(*) AS c FROM t", tenant="greedy")
    cli.sql("SELECT count(*) AS c FROM t", tenant="greedy")
    with pytest.raises(pkg.overload.Rejected) as ei:
        cli.sql("SELECT count(*) AS c FROM t", tenant="greedy")
    assert ei.value.reason == "tenant-budget"
    r = cli.sql("SELECT count(*) AS c FROM t", tenant="modest")
    assert r["status"] == "ok"


def test_dispatch_fault_is_client_visible_and_retried(serve_env, pkg):
    _, cli = serve_env()
    pkg.faults.install("serve.dispatch:transient:1:times=1")
    try:
        before = pkg.obs.counters_snapshot()
        r = cli.sql("SELECT max(a) AS m FROM t")
        assert r["status"] == "ok"
        delta = pkg.obs.counter_delta(before)
        assert delta.get("faults.injected.serve.dispatch.transient") == 1
        assert cli.retried >= 1
        assert delta.get("serve.errors") == 1
        assert delta.get("serve.ok") == 1
    finally:
        pkg.faults.uninstall()


def test_drain_with_hung_query_hits_watchdog(serve_env, pkg):
    """A wedged in-flight query does not block the drain: the watchdog
    abandons it on a zombie thread, swaps a fresh session, and the retry
    answers the request."""
    srv, cli = serve_env(query_timeout_s=0.5)
    old = srv.session
    pkg.faults.install("execute:hang:1:times=1:hang=8")
    try:
        before = pkg.obs.counters_snapshot()
        got = {}

        def send():
            got["resp"] = cli.sql("SELECT min(a) AS m FROM t")

        th = threading.Thread(target=send, daemon=True)
        th.start()
        time.sleep(0.2)
        t0 = time.time()
        summary = srv.drain(reason="SIGTERM-test")
        drain_wall = time.time() - t0
        th.join(15.0)
        assert not th.is_alive()
        assert got["resp"]["status"] == "ok"
        assert got["resp"]["attempts"] >= 2
        assert got["resp"]["data"] == [[0]]
        delta = pkg.obs.counter_delta(before)
        assert delta.get("serve.watchdog.abandoned", 0) >= 1
        assert drain_wall < 8.0
        assert summary["reason"] == "SIGTERM-test"
        assert srv.session is not old
        events = [rec["event"] for rec in
                  pkg.atomic.read_jsonl(srv.config.journal_path)]
        assert events[-1] == pkg.lifecycle.JOURNAL_CLEAN
    finally:
        pkg.faults.uninstall()


TORCH_ONLY = pytest.mark.parametrize("pkg", [PKG["torch"]], ids=["torch"])


@TORCH_ONLY
def test_fresh_session_after_a_hang_shares_the_device_tables(serve_env, pkg):
    srv, cli = serve_env(session=_torch_session())
    cli.sql("SELECT count(*) AS n FROM t")
    old = srv.session
    srv._swap_session(old)
    assert srv.session is not old
    assert srv.session.executor._device_cache["t"][1] is \
        old.executor._device_cache["t"][1]
    assert srv.session.compiled_count() == 0
    assert cli.sql("SELECT count(*) AS n FROM t")["data"] == [[10]]


def test_draining_rejects_new_requests(serve_env, pkg):
    srv, cli = serve_env()
    cli.sql("SELECT 1 AS one FROM t")
    srv.draining = True
    with pytest.raises(pkg.client.ServerDraining):
        cli.sql("SELECT 2 AS two FROM t")
    srv.draining = False


def test_tcp_unix_parity_same_request_same_response(serve_env, pkg):
    srv, _cli = serve_env(tcp="127.0.0.1:0")
    specs = [ep.spec for ep in srv.endpoints]
    assert any(s.startswith("unix:") for s in specs)
    assert any(s.startswith("tcp:") for s in specs)
    for msg in ({"op": "ping", "id": "par-1"},
                {"op": "ready", "id": "par-2"},
                {"op": "sql", "id": "par-3", "tenant": "parity",
                 "sql": "SELECT b, sum(a) AS s FROM t GROUP BY b "
                        "ORDER BY b"}):
        answers = [_ask(pkg, spec, dict(msg)) for spec in specs]
        assert answers[0] == answers[1]


def _ask(pkg, spec, msg):
    s = pkg.transport.connect(spec, connect_timeout_s=10.0)
    try:
        pkg.protocol.send_msg(s, msg)
        resp = pkg.protocol.recv_msg(s)
    finally:
        s.close()
    resp.pop("wall_s", None)
    return resp


def _tenant_for_index(idx: int, n: int) -> str:
    for i in range(1000):
        t = f"t{i}"
        if zlib.crc32(t.encode()) % n == idx:
            return t
    raise AssertionError("unreachable")


def test_client_fails_over_from_refused_endpoint(serve_env, pkg, tmp_path):
    srv, _cli = serve_env()
    live = srv.endpoints[0].spec
    dead = str(tmp_path / "nobody-listening.sock")
    cli = pkg.client.ServeClient(f"{dead},{live}",
                                 tenant=_tenant_for_index(0, 2), retries=4,
                                 connect_timeout_s=10.0)
    try:
        assert cli.endpoint.spec != live
        assert cli.ping()["pong"] is True
        assert cli.failovers >= 1
        assert cli.endpoint.spec == live
        r = cli.sql("SELECT count(*) AS n FROM t")
        assert r["status"] == "ok" and r["data"] == [[10]]
    finally:
        cli.close()


def test_client_all_endpoints_down_raises_typed_transient(pkg, tmp_path):
    d1 = str(tmp_path / "d1.sock")
    d2 = str(tmp_path / "d2.sock")
    cli = pkg.client.ServeClient(f"{d1},{d2}", retries=0,
                                 connect_timeout_s=0.3, backoff_s=0.01)
    with pytest.raises(pkg.client.NoHealthyEndpoint) as ei:
        cli.ping()
    assert sorted(ei.value.endpoints) == sorted(
        [f"unix:{d1}", f"unix:{d2}"])
    assert pkg.taxonomy.classify(ei.value) == "transient"
    solo = pkg.client.ServeClient(d1, retries=0, connect_timeout_s=0.3,
                                  backoff_s=0.01)
    with pytest.raises(OSError) as ei2:
        solo.ping()
    assert not isinstance(ei2.value, pkg.client.NoHealthyEndpoint)


def test_bind_early_probe_answers_and_sql_sheds_until_ready(pkg, tmp_path):
    gate = threading.Event()
    entered = threading.Event()

    class SlowBoot(pkg.server.QueryServer):
        def _aot_precompile(self):
            entered.set()
            assert gate.wait(30.0)
            super()._aot_precompile()

    sock = str(tmp_path / "warm_gate.sock")
    srv = SlowBoot(pkg.server.ServeConfig(
        socket_path=sock, journal_path=str(tmp_path / "j.jsonl"),
        ledger_path="none", bind_early=True, replica_id="r-gate",
        **pkg.config), session=pkg.session())
    boot = threading.Thread(target=srv.start, daemon=True)
    boot.start()
    try:
        assert entered.wait(30.0)
        cli = pkg.client.ServeClient(sock, retries=0, connect_timeout_s=10.0)
        probe = cli.probe()
        assert probe["alive"] is True and probe["ready"] is False
        assert probe["replica_id"] == "r-gate"
        resp = cli._roundtrip({"op": "sql", "id": "w1",
                               "sql": "SELECT count(*) FROM t",
                               "tenant": "warm"})
        assert resp["status"] == "overloaded"
        assert resp["retry_after_s"] > 0
        before = pkg.obs.counters_snapshot()
        gate.set()
        boot.join(30.0)
        assert not boot.is_alive()
        assert cli.wait_ready(10.0)
        assert cli.probe()["ready"] is True
        assert cli.sql("SELECT count(*) AS n FROM t")["data"] == [[10]]
        assert pkg.obs.counter_delta(before).get(
            "serve.warming_rejects", 0) == 0
        cli.close()
    finally:
        gate.set()
        if not srv.draining:
            srv.drain(reason="test")


REQUESTS = [
    {"op": "ping"},
    {"op": "ready"},
    {"op": "sql", "sql": "SELECT b, sum(a) AS s, count(*) AS n FROM t "
                         "GROUP BY b ORDER BY b"},
    {"op": "sql", "sql": "SELECT a, b FROM t WHERE a > 3 ORDER BY a DESC",
     "max_rows": 3},
    {"op": "sql", "sql": "SELECT avg(a) AS m, min(b) AS lo FROM t"},
    {"op": "sql", "sql": "SELECT a FROM t WHERE a > 100"},
    {"op": "sql", "sql": "SELEKT nope"},
    {"op": "sql", "sql": ""},
    {"op": "bogus"},
]


def test_the_two_servers_answer_alike(tmp_path):
    """The same requests over the same table get the same answers from
    the port's server and the JAX server (the wall clock aside)."""
    answers = {}
    for tag in ("jax", "torch"):
        pkg = PKG[tag]
        srv = _start(pkg, tmp_path, tag)
        try:
            answers[tag] = [
                _ask(pkg, srv.endpoints[0].spec,
                     dict(req, id=f"r{i}", tenant="same"))
                for i, req in enumerate(REQUESTS)]
        finally:
            _settled(srv)
            srv.drain(reason="test")
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][2]["data"] == [[0, 18, 4], [1, 12, 3],
                                           [2, 15, 3]]


# -- the port's own: warm restart, memory-planned depth -----------------------

def test_warm_restart_runs_a_seen_key_with_no_discovery(tmp_path):
    """A server stopped with no drain (the SIGKILL of a process, here its
    listeners closed) leaves compile records and a journal; a restarted
    server over a fresh session answers a key the first one saw with no
    discovery (``engine.discoveries`` and ``engine.cache.compiled.miss``
    flat) and the same rows."""
    records = str(tmp_path / "records.pkl")
    cfg = dict(compile_records=records,
               journal_path=str(tmp_path / "j.jsonl"))
    sql = "SELECT b, sum(a) AS s FROM t GROUP BY b ORDER BY b"
    srv1 = _start(PKG["torch"], tmp_path, "warm1", **cfg)
    cli = client.ServeClient(srv1.config.socket_path)
    r1 = cli.sql(sql)
    cli.close()
    assert os.path.exists(records)
    for ls in srv1._listeners:
        ls.close()
    srv2 = _start(PKG["torch"], tmp_path, "warm2", **cfg)
    try:
        cli2 = client.ServeClient(srv2.config.socket_path)
        assert cli2.wait_ready(10.0)
        before = obs.counters_snapshot()
        r2 = cli2.sql(sql)
        delta = obs.counter_delta(before)
        cli2.close()
    finally:
        srv2.drain(reason="test")
    assert r2["data"] == r1["data"] == [[0, 18], [1, 12], [2, 15]]
    assert delta.get("engine.discoveries", 0) == 0, delta
    assert delta.get("engine.cache.compiled.miss", 0) == 0, delta
    assert delta.get("engine.cache.compiled.hit", 0) >= 1
    assert srv2.session.executor.n_discoveries == 0


@TORCH_ONLY
def test_server_auto_queue_depth_from_memplan(serve_env, pkg, monkeypatch):
    monkeypatch.setenv("NDSTPU_HBM_BYTES", str(192 << 20))
    srv, cli = serve_env(session=_torch_session(), queue_depth=None)
    h = cli.health()
    assert h["admission_model"]["budget_source"] == "env"
    assert h["admission_model"]["depth"] == 1
    assert h["queue_depth"] == 1
    assert h["admission_model"] == jax_memplan.admission_budget()
    stats = cli.stats()
    assert stats["engine"]["device"] == "cpu"
    assert stats["engine"]["discoveries"] == 0


@pytest.mark.parametrize("budget,per_query", [
    (8 << 30, 64 << 20), (16 << 20, 64 << 20), (1 << 50, 1), (1, 1 << 30)])
def test_admission_budgets_are_the_jax_ones(budget, per_query):
    assert memplan.admission_budget(budget_bytes=budget,
                                    bytes_per_query=per_query) == \
        jax_memplan.admission_budget(budget_bytes=budget,
                                     bytes_per_query=per_query)


# -- fleet supervisor units (injectable probe/launcher) -----------------------

class _FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.rc = None
        self.returncode = None

    def poll(self):
        self.returncode = self.rc
        return self.rc

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        self.returncode = self.rc
        return self.rc


def _fleet_cfg(pkg, tmp_path, **kw):
    defaults = dict(input_prefix=str(tmp_path / "wh"),
                    replicas=2, run_dir=str(tmp_path / "fleet"),
                    probe_interval_s=30.0, probe_fail_threshold=3,
                    restart_backoff_s=0.0, restart_backoff_max_s=0.0)
    defaults.update(kw)
    return pkg.fleet.FleetConfig(**defaults)


def test_fleet_adopts_live_replicas_instead_of_double_starting(pkg,
                                                               tmp_path):
    launched = []

    def launcher(rep):
        launched.append(rep.replica_id)
        return _FakeProc(pid=1000 + len(launched))

    def probe(rep):
        if rep.replica_id == "r0":
            return {"alive": True, "ready": True, "pid": 4242}
        raise ConnectionRefusedError("r1 not running")

    sup = pkg.fleet.FleetSupervisor(
        _fleet_cfg(pkg, tmp_path, probe_fail_threshold=99),
        probe_fn=probe, launcher=launcher)
    sup.start()
    try:
        r0, _r1 = sup.replicas
        assert r0.adopted and r0.pid == 4242 and r0.ready
        assert launched == ["r1"]
        doc = sup.health_doc()
        assert doc["artifact"] == "ndstpu-fleet-health-v1"
        assert doc["replicas"][0]["adopted"] is True
        assert os.path.exists(sup.health_path)
    finally:
        sup._stopped.set()


def test_fleet_restarts_dead_replica_and_fences_stale_lock(pkg, tmp_path):
    wh = tmp_path / "wh" / "store_sales"
    wh.mkdir(parents=True)
    launched = []

    def launcher(rep):
        p = _FakeProc(pid=1000 + len(launched))
        launched.append(p)
        return p

    sup = pkg.fleet.FleetSupervisor(
        _fleet_cfg(pkg, tmp_path, replicas=1),
        probe_fn=lambda rep: {"alive": True, "ready": True, "pid": None},
        launcher=launcher)
    rep = sup.replicas[0]
    sup._start_replica(rep)
    assert len(launched) == 1 and rep.pid == 1000
    stale = wh / pkg.commit.LOCK_BASENAME
    stale.write_text(json.dumps({"pid": rep.pid, "ts": 0}))
    live_dir = tmp_path / "wh" / "other"
    live_dir.mkdir()
    (live_dir / pkg.commit.LOCK_BASENAME).write_text(
        json.dumps({"pid": os.getpid(), "ts": 0}))
    launched[0].rc = 9
    sup._check_one(rep)
    assert rep.restarts == 1
    assert len(launched) == 2
    assert rep.pid == launched[1].pid
    assert not stale.exists()
    assert (live_dir / pkg.commit.LOCK_BASENAME).exists()


def test_fleet_probe_failures_restart_only_at_threshold(pkg, tmp_path):
    launched = []

    def launcher(rep):
        p = _FakeProc(pid=2000 + len(launched))
        launched.append(p)
        return p

    def probe(rep):
        raise ConnectionRefusedError("injected probe failure")

    sup = pkg.fleet.FleetSupervisor(
        _fleet_cfg(pkg, tmp_path, replicas=1, probe_fail_threshold=3,
                   boot_grace_s=0.5),
        probe_fn=probe, launcher=launcher)
    rep = sup.replicas[0]
    sup._start_replica(rep)
    sup._check_one(rep)
    assert rep.consecutive_failures == 0
    rep.launched_at -= 1.0
    sup._check_one(rep)
    sup._check_one(rep)
    assert rep.restarts == 0
    sup._check_one(rep)
    assert rep.restarts == 1 and len(launched) == 2


def test_fleet_kill_switch_degenerates_to_one_replica(pkg, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv(pkg.fleet.FLEET_ENV, "0")
    sup = pkg.fleet.FleetSupervisor(
        _fleet_cfg(pkg, tmp_path, replicas=3),
        probe_fn=lambda rep: {"alive": True, "ready": True},
        launcher=lambda rep: _FakeProc(pid=1))
    assert len(sup.replicas) == 1
    assert "," not in sup.endpoints_spec()


def test_fleet_default_endpoints_stable_and_short(pkg, tmp_path):
    a = pkg.fleet.default_endpoints(str(tmp_path / "fleet"), 3)
    assert a == pkg.fleet.default_endpoints(str(tmp_path / "fleet"), 3)
    assert len(set(a)) == 3
    assert all(len(p) < 100 for p in a)
    assert pkg.fleet.default_endpoints(str(tmp_path / "other"), 3) != a
    # the two packages' supervisors probe the same sockets for a run dir
    assert a == (jax_fleet if pkg is PKG["torch"] else fleet) \
        .default_endpoints(str(tmp_path / "fleet"), 3)


def test_fleet_launches_the_ports_server(tmp_path, monkeypatch):
    """A replica is ``python -m ndstpu_torch.harness.serve server`` on the
    fleet's device and generated warehouse, bound early, under the
    shared compile records."""
    seen = {}

    class Popen:
        def __init__(self, argv, **kw):
            seen["argv"] = argv
            self.pid = 7

    monkeypatch.setattr(fleet.subprocess, "Popen", Popen)
    sup = fleet.FleetSupervisor(_fleet_cfg(
        PKG["torch"], tmp_path, replicas=1, input_prefix="-",
        generate=0.5, generate_seed=3, device="cpu"))
    sup._launch_proc(sup.replicas[0])
    argv = seen["argv"]
    assert argv[1:5] == ["-m", "ndstpu_torch.harness.serve", "server",
                         "--socket"]
    opts = dict(zip(argv[4::1], argv[5::1]))
    assert opts["--input_prefix"] == "-"
    assert opts["--device"] == "cpu"
    assert opts["--generate"] == "0.5" and opts["--generate_seed"] == "3"
    assert opts["--compile_records"] == sup.shared_records
    assert "--bind_early" in argv
    assert commit.LOCK_BASENAME == jax_commit.LOCK_BASENAME
    assert sup._fence(sup.replicas[0]) == 0   # "-" is no directory


@TORCH_ONLY
def test_drain_skips_an_executor_not_yet_started(serve_env, pkg):
    """A drain that races a connection's start (its executor thread made
    but not started, as the accept thread leaves it for a moment) ends:
    the JAX server's drain joins that thread, raises, and never marks its
    clean shutdown."""
    srv, _cli = serve_env()
    conn = server._Conn("conn-new", socket.socket(socket.AF_UNIX))
    conn.executor = threading.Thread(target=lambda: None)
    with srv._conns_lock:
        srv._conns[conn.sid] = conn
    srv.scheduler.open_stream(conn.sid)
    summary = srv.drain(reason="race")
    assert summary["reason"] == "race"
    events = [rec["event"] for rec in
              atomic.read_jsonl(srv.config.journal_path)]
    assert events[-1] == lifecycle.JOURNAL_CLEAN


def test_aot_corpus_plans_before_ready(pkg, tmp_path):
    """``aot_corpus`` plans every query of a stream file before the server
    reports ready, so the plan cache then hits; a text that does not plan
    costs nothing at boot (``canonical_key`` keys it by its text), in
    both packages."""
    stream = tmp_path / "query_0.sql"
    stream.write_text(
        "-- start query 1 in stream 0 using template query1.tpl\n"
        "select b, count(*) as n from t group by b order by b;\n"
        "-- end query 1 in stream 0 using template query1.tpl\n"
        "-- start query 2 in stream 0 using template query2.tpl\n"
        "select nope from nowhere;\n"
        "-- end query 2 in stream 0 using template query2.tpl\n")
    srv = _start(pkg, tmp_path, "aot", aot_corpus=str(tmp_path))
    try:
        assert srv.aot_info["files"] == 1
        assert (srv.aot_info["planned"], srv.aot_info["errors"]) == (2, 0)
        assert srv.probe_doc()["aot"] == srv.aot_info
        before = pkg.obs.counters_snapshot()
        cli = pkg.client.ServeClient(srv.config.socket_path)
        assert cli.sql("select b, count(*) as n from t group by b "
                       "order by b")["data"] == [[0, 4], [1, 3], [2, 3]]
        cli.close()
        delta = pkg.obs.counter_delta(before)
        assert delta.get("engine.cache.plan.hit", 0) >= 1
        assert delta.get("engine.cache.plan.miss", 0) == 0
    finally:
        srv.drain(reason="test")
