"""``--floats`` through the port's command lines, wherever the JAX package
takes it: the power run (``--generate`` and a ``transcode --floats``
warehouse), the throughput run's process and inproc modes and ``--mode
serve``, the server and the fleet.  Each run's answers are the port's
``Session`` over the same decimals-as-doubles warehouse
(``datagen.generate(..., use_decimal=False)``, or ``loader.load_catalog(...,
use_decimal=False)``), every money column of it FLOAT64; the summaries
record ``floats`` in their engine settings; the inproc mode refuses
streams whose ``floats`` differ, as it refuses any flag the shared
session cannot take two ways."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import json

import pyarrow.parquet as pq
import pytest

from ndstpu_torch import datagen
from ndstpu_torch.engine import columnar
from ndstpu_torch.engine.session import Session
from ndstpu_torch.harness import power, scheduler, throughput
from ndstpu_torch.harness import serve as serve_cli
from ndstpu_torch.io import loader
from ndstpu_torch.queries import streamgen
from ndstpu_torch.serve import client, fleet, server
from test_torch_floats_common import jax_floats_warehouse

PARTS = ["query3", "query7", "query42"]
SCALE = 0.002


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Streams 0, 1 and 2 of rngseed 07291122510."""
    d = tmp_path_factory.mktemp("streams")
    streamgen.generate_query_streams(None, "07291122510", str(d), 3)
    return d


@pytest.fixture(scope="module")
def floats_session():
    return Session(datagen.generate(SCALE, 1, "cpu", use_decimal=False),
                   device="cpu")


def _assert_doubles(sess):
    col = sess.catalog.get("store_sales").column("ss_net_paid")
    assert col.ctype.kind == "float64"


def _answers(sess, stream, names):
    sql = power.gen_sql_from_stream(str(stream))
    return {q: columnar.to_arrow(power.ensure_valid_column_names(
        sess.sql(sql[q]))) for q in names}


def _outputs(prefix, names):
    return {q: pq.read_table(prefix / q / "part-0.parquet") for q in names}


def test_power_generate_floats(streams, floats_session, tmp_path):
    power.main([str(streams / "query_0.sql"), "-", str(tmp_path / "t.csv"),
                "--generate", f"{SCALE:g}", "--device", "cpu", "--floats",
                "--sub_queries", ",".join(PARTS), "--output_prefix",
                str(tmp_path / "out"), "--json_summary_folder",
                str(tmp_path / "json")])
    want = _answers(floats_session, streams / "query_0.sql", PARTS)
    got = _outputs(tmp_path / "out", PARTS)
    for q in PARTS:
        assert got[q].equals(want[q]), q
    assert any(pa_type == "double" for pa_type in
               map(str, got["query7"].schema.types))
    for f in (tmp_path / "json").iterdir():
        env = json.loads(f.read_text())["env"]
        assert env["engineConf"]["floats"] == "true"


def test_power_floats_warehouse(streams, tmp_path, tmp_path_factory):
    wh = jax_floats_warehouse(tmp_path_factory)
    power.main([str(streams / "query_0.sql"), str(wh),
                str(tmp_path / "t.csv"), "--device", "cpu", "--floats",
                "--sub_queries", ",".join(PARTS), "--output_prefix",
                str(tmp_path / "out")])
    sess = Session(loader.load_catalog(str(wh), use_decimal=False),
                   device="cpu")
    _assert_doubles(sess)
    want = _answers(sess, streams / "query_0.sql", PARTS)
    got = _outputs(tmp_path / "out", PARTS)
    for q in PARTS:
        assert got[q].equals(want[q]), q


def test_floats_is_part_of_the_resume_fingerprint():
    args = power.parse_args(["s.sql", "-", "t.csv", "--generate", "1"])
    floats = power.parse_args(["s.sql", "-", "t.csv", "--generate", "1",
                               "--floats"])
    assert power.power_fingerprint(args) != power.power_fingerprint(floats)


def _cmd(streams, side, *extra):
    return ["python", "-m", "ndstpu_torch.harness.power",
            str(streams / "query_{}.sql"), "-", str(side / "time_{}.csv"),
            "--generate", f"{SCALE:g}", "--device", "cpu", "--floats",
            "--sub_queries", ",".join(PARTS), *extra]


def test_throughput_inproc_floats(streams, floats_session, tmp_path):
    run = scheduler.run_streams_inproc(
        ["1", "2"], _cmd(streams, tmp_path, "--output_prefix",
                         str(tmp_path / "out_{}")), 2)
    assert run.rc == 0 and not run.errors
    _assert_doubles(run.session)
    for sid in ("1", "2"):
        want = _answers(floats_session, streams / f"query_{sid}.sql", PARTS)
        got = _outputs(tmp_path / f"out_{sid}", PARTS)
        for q in PARTS:
            assert got[q].equals(want[q]), (sid, q)


def test_throughput_process_floats(streams, floats_session, tmp_path):
    rc = throughput.main(["1,2", "--", *_cmd(
        streams, tmp_path, "--output_prefix", str(tmp_path / "out_{}"))])
    assert rc == 0
    for sid in ("1", "2"):
        want = _answers(floats_session, streams / f"query_{sid}.sql", PARTS)
        got = _outputs(tmp_path / f"out_{sid}", PARTS)
        for q in PARTS:
            assert got[q].equals(want[q]), (sid, q)


def test_inproc_refuses_streams_whose_floats_differ(streams, tmp_path,
                                                    monkeypatch):
    parse = power.parse_args

    def stream_2_without_floats(argv):
        ns = parse(argv)
        ns.floats = "query_2.sql" not in argv[0]
        return ns

    monkeypatch.setattr(power, "parse_args", stream_2_without_floats)
    with pytest.raises(ValueError, match="share one floats"):
        scheduler.run_streams_inproc(["1", "2"], _cmd(streams, tmp_path))


def test_server_and_mode_serve_floats(streams, floats_session, tmp_path):
    """A server started with ``floats`` (its warehouse generated, as
    ``harness.serve server --generate --floats`` starts it) answers as the
    floats session does, and ``throughput --mode serve`` runs two streams
    through it."""
    srv = server.QueryServer(server.ServeConfig(
        socket_path=str(tmp_path / "s.sock"), input_prefix="-",
        generate=SCALE, device="cpu", floats=True, ledger_path="none",
        journal_path=str(tmp_path / "journal.jsonl"), query_timeout_s=120.0))
    srv.start()
    try:
        _assert_doubles(srv.session)
        sql = power.gen_sql_from_stream(str(streams / "query_1.sql"))
        cli = client.ServeClient(srv.endpoints[0].spec, retries=2,
                                 connect_timeout_s=10.0)
        try:
            resp = cli.sql(sql["query7"], max_rows=1000)
        finally:
            cli.close()
        rows = floats_session.sql(sql["query7"]).to_rows()
        assert resp["status"] == "ok" and resp["rows"] == len(rows) > 0
        assert resp["data"] == json.loads(json.dumps(
            [list(r) for r in rows], default=str))
        rc = throughput.main(
            ["1,2", "--mode", "serve", "--serve_socket",
             srv.endpoints[0].spec, "--overlap_report",
             str(tmp_path / "overlap.json"), "--", *_cmd(streams, tmp_path)])
        assert rc == 0
        report = json.loads((tmp_path / "overlap.json").read_text())
        assert [(r["returncode"], r["executed"], r["failures"])
                for r in report["streams"]] == [(0, len(PARTS), 0)] * 2
    finally:
        srv.drain(reason="teardown")


def test_serve_command_line_passes_floats(monkeypatch, tmp_path):
    """``harness.serve server --floats`` and ``fleet --floats`` configure
    the server and the fleet with ``floats``; each replica's command line
    carries ``--floats``, which the server's parser reads back."""
    seen = {}

    class Server:
        def __init__(self, cfg):
            seen["server"] = cfg

        def serve_forever(self):
            pass

    monkeypatch.setattr(server, "QueryServer", Server)
    monkeypatch.setattr("ndstpu_torch.serve.lifecycle."
                        "install_signal_handlers", lambda s: None)
    monkeypatch.setattr(fleet, "serve_fleet_forever",
                        lambda cfg: seen.setdefault("fleet", cfg) and 0)
    base = ["--input_prefix", "-", "--generate", "0.01", "--device", "cpu"]
    assert serve_cli.main(["server", "--socket", str(tmp_path / "s.sock"),
                           "--state_dir", str(tmp_path / "st"), "--floats",
                           *base]) == 0
    assert seen["server"].floats is True
    serve_cli.main(["fleet", "--run_dir", str(tmp_path / "fl"), "--floats",
                    *base])
    cfg = seen["fleet"]
    assert cfg.floats is True

    launched = []

    class Popen:
        def __init__(self, argv, **kw):
            launched.append(argv)

    monkeypatch.setattr(fleet.subprocess, "Popen", Popen)
    sup = fleet.FleetSupervisor(cfg)
    sup._launch_proc(fleet._Replica("r0", str(tmp_path / "r0.sock"),
                                    str(tmp_path / "r0")))
    (argv,) = launched
    assert "--floats" in argv
    i = argv.index("server")
    args = serve_cli.build_parser().parse_args(argv[i:])
    assert args.floats and args.generate == 0.01
