"""The port's query server against the JAX package's, over one warehouse.

The warehouse is ``ndstpu_torch.datagen.generate(0.002, seed=1)`` on the
CPU, handed to the JAX package as numpy columns
(``test_torch_corpus_common.jax_catalog``).  The port's ``QueryServer``
(in this process, over ``Session(device="cpu")``) and the JAX package's
(over ``Session(backend="tpu")`` with its warm-up replay off,
``jax_reference``) answer the same requests: stream 1's renderings of
``PARTS`` and two queries of dates, decimals and floats.  Each response's
``rows``, ``columns`` and ``data`` must agree: ints, decimals, dates and
strings exactly, float columns within 1e-5 relative.

Then the port alone:

* ``python -m ndstpu_torch.harness.throughput 1,2 --mode serve`` (its
  ``main``) against the port's server exits 0 with the JAX command's
  report keys, and the server's answers to each stream's renderings are
  the rows of the same streams run ``--mode inproc``;
* snapshot pins on the session, held against the JAX session's: DDL and
  DML under a pin raise; a query pinned before a DELETE returns the
  pre-DELETE rows (eager on the pinned tables), the live query the
  post-DELETE rows, each as the JAX session answers;
* the command line's refusals (no card without ``--device cpu``; outputs
  without pyarrow; a warehouse and ``--generate`` together);
* the server as a process (``python -m ndstpu_torch.harness.serve server
  --device cpu`` over a one-table Parquet warehouse): SIGTERM with a query
  in flight (held by an injected ``execute`` hang) answers it, then
  answers ``draining``, exits 0 and journals the clean-shutdown marker;
  SIGKILL with a query in flight, then a restart on the same state
  directory: the client's retry is answered, and a key the killed server
  saw runs with no discovery (``engine.discoveries`` flat over the
  ``stats`` op) and the same answer.
"""

import datetime
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ndstpu.engine.session import Session as JaxSession
from ndstpu.harness import throughput as jax_throughput
from ndstpu.serve import server as jax_server
from ndstpu_torch import datagen
from ndstpu_torch.engine.session import Session
from ndstpu_torch.harness import power, scheduler, serve, throughput
from ndstpu_torch.io import loader
from ndstpu_torch.io.catalog import Catalog
from ndstpu_torch.queries import streamgen
from ndstpu_torch.serve import client, server
from test_torch_corpus_common import jax_catalog, jax_reference

SCALE = 0.002
# parts with rows at SCALE, seed 1: strings, decimals and float ratios
# (q12, q20, whose programs the JAX engine shares), and a count (q96)
PARTS = ["query12", "query20", "query96"]
ADHOC = {
    "dates": "select d_date, d_year, d_day_name from date_dim "
             "where d_date_sk between 2451545 and 2451551 order by d_date",
    "sums": "select avg(ss_quantity) as q, sum(ss_net_paid) as paid, "
            "count(*) as n, max(ss_sold_date_sk) as last from store_sales",
}
MAX_ROWS = 100000


def _write_streams(root):
    full = root / "full"
    streamgen.generate_query_streams(None, "07291122510", str(full), 3)
    d = root / "streams"
    d.mkdir()
    texts = {}
    for sid in ("1", "2"):
        parts = power.gen_sql_from_stream(str(full / f"query_{sid}.sql"))
        texts[sid] = {n: parts[n] for n in PARTS}
        (d / f"query_{sid}.sql").write_text("".join(
            f"-- start query {i} in stream {sid} using template {n}.tpl\n"
            f"{parts[n].strip()}\n" for i, n in enumerate(PARTS, 1)))
    return d, texts


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The warehouse, streams 1 and 2 cut to ``PARTS``, and both servers,
    started in this process: {"root", "cat", "streams", "texts", "port",
    "jax"}."""
    root = tmp_path_factory.mktemp("serve")
    cat = datagen.generate(SCALE, seed=1, device="cpu")
    streams, texts = _write_streams(root)
    port = server.QueryServer(server.ServeConfig(
        socket_path=str(root / "port.sock"), device="cpu",
        journal_path=str(root / "port_journal.jsonl"), ledger_path="none",
        query_timeout_s=120.0, slots=2),
        session=Session(cat, device="cpu"))
    jax = jax_server.QueryServer(jax_server.ServeConfig(
        socket_path=str(root / "jax.sock"), engine="tpu",
        journal_path=str(root / "jax_journal.jsonl"), ledger_path="none",
        query_timeout_s=120.0, slots=2),
        session=jax_reference(jax_catalog(cat)))
    port.start()
    jax.start()
    try:
        yield {"root": root, "cat": cat, "streams": streams, "texts": texts,
               "port": port, "jax": jax}
    finally:
        port.drain(reason="teardown")
        jax.drain(reason="teardown")


def _ask(srv, sql):
    cli = client.ServeClient(srv.endpoints[0].spec, tenant="same",
                             retries=2, connect_timeout_s=10.0)
    try:
        resp = cli.sql(sql, max_rows=MAX_ROWS)
    finally:
        cli.close()
    assert resp["status"] == "ok", resp
    return resp


def _float_columns(cat, sql):
    """The float64 columns of ``sql``'s result (a decimal returns as a
    float on the wire but is exact)."""
    out = Session(cat, device="cpu").sql(sql)
    return [c.ctype.kind == "float64" for c in out.columns.values()]


def assert_answers_agree(want, got, floats):
    assert got["rows"] == want["rows"]
    assert got["columns"] == want["columns"]
    assert got["truncated"] == want["truncated"]
    assert len(got["data"]) == len(want["data"])
    for w, g in zip(want["data"], got["data"]):
        assert len(w) == len(g) == len(floats)
        for a, b, is_float in zip(w, g, floats):
            if is_float and a is not None and b is not None:
                assert math.isclose(a, b, rel_tol=1e-5, abs_tol=0.0) or \
                    a == b, (w, g)
            else:
                assert type(a) is type(b) and a == b, (w, g)


CASES = [("stream 1", n) for n in PARTS] + [("adhoc", n) for n in ADHOC]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}:{c[1]}")
def test_answers_equal_the_jax_servers(world, case):
    kind, name = case
    sql = world["texts"]["1"][name] if kind == "stream 1" else ADHOC[name]
    want, got = _ask(world["jax"], sql), _ask(world["port"], sql)
    assert got["rows"] > 0
    assert_answers_agree(want, got, _float_columns(world["cat"], sql))


def _power_cmd(streams, side, *extra):
    return ["python", "-m", "ndstpu_torch.harness.power",
            str(streams / "query_{}.sql"), "-", str(side / "time_{}.csv"),
            "--generate", f"{SCALE:g}", "--device", "cpu", *extra]


def _wire(rows):
    """Rows as a response carries them (JSON, ``default=str``)."""
    return json.loads(json.dumps([list(r) for r in rows], default=str))


def test_throughput_mode_serve_answers_as_inproc(world, tmp_path):
    streams = world["streams"]
    port_sock = world["port"].endpoints[0].spec
    for side in ("serve", "jax", "inproc"):
        (tmp_path / side).mkdir()
    rc = throughput.main(
        ["1,2", "--mode", "serve", "--serve_socket", port_sock,
         "--overlap_report", str(tmp_path / "serve" / "overlap.json"),
         "--", *_power_cmd(streams, tmp_path / "serve")])
    assert rc == 0
    rc = jax_throughput.main(
        ["1,2", "--mode", "serve", "--serve_socket",
         world["jax"].endpoints[0].spec,
         "--overlap_report", str(tmp_path / "jax" / "overlap.json"), "--",
         "python", "-m", "ndstpu.harness.power",
         str(streams / "query_{}.sql"), "wh",
         str(tmp_path / "jax" / "time_{}.csv")])
    assert rc == 0
    got = json.loads((tmp_path / "serve" / "overlap.json").read_text())
    want = json.loads((tmp_path / "jax" / "overlap.json").read_text())
    assert got["mode"] == want["mode"] == "serve"
    assert set(got) == set(want)
    assert set(got["server_health"]) - {"device"} == \
        set(want["server_health"]) - {"engine"}
    for rec in got["streams"]:
        assert set(rec) == set(want["streams"][0])
        assert (rec["returncode"], rec["executed"], rec["failures"],
                rec["skipped"]) == (0, len(PARTS), 0, 0)
        assert rec["endpoint"] == port_sock
        assert rec["client_retries"] == rec["failovers"] == 0

    run = scheduler.run_streams_inproc(
        ["1", "2"], _power_cmd(streams, tmp_path / "inproc"), 2)
    assert run.rc == 0 and not run.errors
    for sid, texts in world["texts"].items():
        for name, sql in texts.items():
            resp = _ask(world["port"], sql)
            rows = run.session.sql(sql).to_rows()
            assert resp["rows"] == len(rows) > 0
            assert resp["data"] == _wire(rows), f"{sid}:{name}"


# -- snapshot pins ------------------------------------------------------------

PINNED = ("select ss_store_sk, count(*) as n, sum(ss_net_paid) as paid, "
          "avg(ss_quantity) as q from store_sales group by ss_store_sk "
          "order by ss_store_sk")
DELETE = "delete from store_sales where ss_quantity > 50"


def _copy(cat) -> Catalog:
    """A catalog of its own over the same tables (a DELETE replaces an
    entry; it never writes a table)."""
    return Catalog(tables=dict(cat.tables), meta=dict(cat.meta),
                   versions=dict(cat.versions))


def test_ddl_is_rejected_under_a_pin(world):
    port = Session(_copy(world["cat"]), device="cpu")
    jax = JaxSession(jax_catalog(world["cat"]), backend="cpu")
    for sess in (jax, port):
        pin = sess.pin_snapshot()
        for stmt in (DELETE, "create temp view v as select 1 as one",
                     "drop table store_sales"):
            with pytest.raises(ValueError, match="snapshot pin"):
                sess.sql(stmt, pin=pin)
    assert port.catalog.get("store_sales").num_rows == \
        world["cat"].get("store_sales").num_rows
    assert "v" not in port.views


def test_a_pinned_query_reads_the_pre_delete_rows(world):
    port = Session(_copy(world["cat"]), device="cpu")
    jax = JaxSession(jax_catalog(world["cat"]), backend="cpu")
    exe = port.executor
    before = port.sql(PINNED).to_rows()          # discovery
    pin = port.pin_snapshot()
    replays = exe.n_replays
    assert port.sql(PINNED, pin=pin).to_rows() == before
    assert exe.n_replays == replays + 1          # a pin at the live epoch
    jpin = jax.pin_snapshot()
    assert pin.epoch == port.snapshot_epoch() and pin.epoch.startswith("mem")
    port.sql(DELETE)
    jax.sql(DELETE)
    assert pin.epoch != port.snapshot_epoch()
    discoveries = exe.n_discoveries
    pinned = port.sql(PINNED, pin=pin).to_rows()
    assert exe.n_discoveries == discoveries      # eager, no discovery
    live = port.sql(PINNED).to_rows()
    assert pinned == before != live
    assert pinned == jax.sql(PINNED, pin=jpin).to_rows()
    assert live == jax.sql(PINNED).to_rows()
    # the pin still reads its own tables after the live ones changed
    assert port.sql(PINNED, pin=pin).to_rows() == before
    assert sum(r[1] for r in live) < sum(r[1] for r in before)


# -- the command line's refusals ----------------------------------------------

def test_no_card_and_no_device_cpu_is_refused(tmp_path, capsys):
    for cmd in (["server", "--socket", str(tmp_path / "s.sock")],
                ["fleet", "--run_dir", str(tmp_path / "f")]):
        assert serve.main(cmd + ["--input_prefix", "-", "--generate",
                                 "0.01"]) == 2
        err = capsys.readouterr().err
        assert "CUDA" in err and "cpu" in err


def test_outputs_without_pyarrow_are_refused(tmp_path, capsys, monkeypatch):
    def no_pyarrow():
        raise ModuleNotFoundError("reading a warehouse's files needs "
                                  "pyarrow, which is not installed")

    monkeypatch.setattr(loader, "_pyarrow", no_pyarrow)
    assert serve.main(["server", "--socket", str(tmp_path / "s.sock"),
                       "--input_prefix", "-", "--generate", "0.01",
                       "--device", "cpu", "--output_prefix",
                       str(tmp_path / "out")]) == 2
    assert "pyarrow" in capsys.readouterr().err
    with pytest.raises(ModuleNotFoundError, match="pyarrow"):
        server.QueryServer(server.ServeConfig(
            socket_path=str(tmp_path / "t.sock"), device="cpu",
            input_prefix="-", generate=0.01,
            output_prefix=str(tmp_path / "out"))).start()


@pytest.mark.parametrize("args", [["--input_prefix", "-"],
                                  ["--input_prefix", "wh", "--generate",
                                   "1"]], ids=["dash alone", "both"])
def test_warehouse_or_generate(tmp_path, args):
    with pytest.raises(SystemExit) as ei:
        serve.main(["server", "--socket", str(tmp_path / "s.sock"),
                    "--device", "cpu", *args])
    assert ei.value.code == 2


# -- the server as a process: SIGTERM drain, SIGKILL and warm restart ---------

ONE_TABLE = ("select d_moy, count(*) as n, min(d_date) as first "
             "from date_dim group by d_moy order by d_moy")
OTHER = "select max(d_date_sk) as m from date_dim where d_moy = 2"


@pytest.fixture(scope="module")
def tiny_wh(tmp_path_factory):
    """A one-table Parquet warehouse (60 days of date_dim)."""
    root = tmp_path_factory.mktemp("tinywh")
    (root / "date_dim").mkdir()
    n = 60
    pq.write_table(pa.table({
        "d_date_sk": pa.array(range(2451545, 2451545 + n), pa.int32()),
        "d_date": pa.array([datetime.date(2000, 1, 1)
                            + datetime.timedelta(days=i) for i in range(n)],
                           pa.date32()),
        "d_year": pa.array([2000] * n, pa.int32()),
        "d_moy": pa.array([1 + i // 31 for i in range(n)], pa.int32())}),
        str(root / "date_dim" / "part-0.parquet"))
    return root


def _server_proc(tiny_wh, tmp_path, tag, faults=None):
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    env.pop("NDSTPU_FAULTS", None)
    if faults:
        env["NDSTPU_FAULTS"] = faults
    log = open(tmp_path / f"server_{tag}.log", "a")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "ndstpu_torch.harness.serve", "server",
             "--socket", str(tmp_path / f"{tag}.sock"), "--input_prefix",
             str(tiny_wh), "--device", "cpu", "--state_dir",
             str(tmp_path / f"state_{tag}")],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


# the injected hangs that hold a query in flight: the SIGTERM case's first
# query; the SIGKILL case's second (seed 0 fires the probe's second call,
# not its first)
FAULTS = {"term": "execute:hang:1:times=1:hang=3",
          "kill": "execute:hang:0.5:seed0:times=1:hang=6"}


@pytest.fixture(scope="module", autouse=True)
def processes(tiny_wh, tmp_path_factory):
    """The server processes of the SIGTERM and SIGKILL cases, started
    with the module so that their start overlaps the cases before them,
    and killed at its end where they still run: {"root", "term", "kill",
    "restarted"}."""
    root = tmp_path_factory.mktemp("procs")
    procs = {"root": root, "restarted": []}
    for tag, spec in FAULTS.items():
        procs[tag] = _server_proc(tiny_wh, root, tag, faults=spec)
    yield procs
    for p in (procs["term"], procs["kill"], *procs["restarted"]):
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def _events(path):
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line).get("event"))
        except ValueError:
            pass  # a torn tail from a SIGKILL
    return out


def test_sigterm_drains_with_the_inflight_query_answered(processes):
    root, proc = processes["root"], processes["term"]
    cli = client.ServeClient(str(root / "term.sock"), retries=2,
                             connect_timeout_s=60.0)
    assert cli.wait_ready(60.0)
    got = {}
    th = threading.Thread(target=lambda: got.update(
        resp=cli.sql(ONE_TABLE)), daemon=True)
    th.start()
    time.sleep(1.0)          # the query hangs in its execute probe
    proc.send_signal(signal.SIGTERM)
    th.join(60.0)
    assert not th.is_alive()
    assert got["resp"]["status"] == "ok"
    assert got["resp"]["data"] == [[1, 31, "2000-01-01"],
                                   [2, 29, "2000-02-01"]]
    with pytest.raises((client.ServerDraining, OSError, ConnectionError)):
        cli.sql(OTHER)
    cli.close()
    assert proc.wait(timeout=60) == 0
    events = _events(root / "state_term" / "serve_journal.jsonl")
    assert events[0] == "server-start" and "query" in events
    assert events[-1] == "clean-shutdown"


def test_sigkill_and_warm_restart_discover_nothing_for_a_seen_key(
        tiny_wh, processes):
    root, proc = processes["root"], processes["kill"]
    sock = str(root / "kill.sock")
    cli = client.ServeClient(sock, connect_timeout_s=60.0)
    assert cli.wait_ready(60.0)
    first = cli.sql(ONE_TABLE)
    cli.close()
    kill_cli = client.ServeClient(sock, retries=30, connect_timeout_s=60.0)
    killed = {}
    th = threading.Thread(target=lambda: killed.update(
        resp=kill_cli.sql(OTHER)), daemon=True)
    th.start()
    time.sleep(1.0)          # the second query hangs in its execute probe
    proc.kill()
    proc.wait(timeout=30)
    processes["restarted"].append(_server_proc(tiny_wh, root, "kill"))
    th.join(120.0)
    assert not th.is_alive()
    assert killed["resp"]["status"] == "ok"
    assert killed["resp"]["data"] == [[2451604]]
    assert kill_cli.retried >= 1
    kill_cli.close()

    cli2 = client.ServeClient(sock, connect_timeout_s=60.0)
    assert cli2.wait_ready(60.0)
    before = cli2.stats()
    again = cli2.sql(ONE_TABLE)
    after = cli2.stats()
    cli2.close()
    assert again["data"] == first["data"]
    assert after["counters"].get("engine.discoveries", 0) == \
        before["counters"].get("engine.discoveries", 0)
    assert after["engine"]["discoveries"] == before["engine"]["discoveries"]
    assert after["counters"].get("engine.cache.compiled.hit", 0) > \
        before["counters"].get("engine.cache.compiled.hit", 0)
    assert after["counters"].get("serve.restart.preloaded_records", 0) >= 1
    events = _events(root / "state_kill" / "serve_journal.jsonl")
    assert events.count("server-start") == 2
    assert "clean-shutdown" not in events
