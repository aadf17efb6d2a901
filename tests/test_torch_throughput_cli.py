"""The port's throughput run against the JAX package's, on one small warehouse.

The warehouse is the one ``tests/test_torch_power.py`` reads: the JAX
package's generator (``ndstpu.datagen.driver``) at SF 0.002, then
``ndstpu.io.transcode``, built once a test session
(``test_torch_corpus_common.jax_warehouse``).  Streams 1 and 2 of rngseed 07291122510
(``streamgen --streams 3``) are cut to the parts ``query3``, ``query42``
and ``query14_part1``, and stream 2 gets one more query, ``query100``,
which names a column no table has, so that it fails on both sides.

``python -m ndstpu.harness.throughput 1,2 --mode inproc --concurrent 2``
over ``python -m ndstpu.harness.power ... --engine tpu`` (the JAX engine on
the CPU, in a process of its own) runs beside the port's
``scheduler.run_streams_inproc`` (in this process: its session and
scheduler stay open to inspection) and ``throughput.main`` with the same
arguments, both over ``python -m ndstpu_torch.harness.power ... --device
cpu``.  They must agree on each stream's time-log rows (the order of a
stream's queries is the scheduler's, decided by which stream thread asks
first, so the queries are compared as a set between the fixed rows), each
summary's ``queryStatus`` and taxonomy class, each output under the
validator's comparison, and the keys of the overlap report, of its stream
records and of the sidecar.  On the port's side the session plans each
text once, keeps nothing of the failing query, and answers as a serial
run of each stream does.  The port's process mode (``--concurrent 1``, a
power process a stream) answers the same, with one sidecar a stream; an
inproc run over ``--generate 0.002`` answers as ``Session`` does over
``datagen.generate(0.002, 1, "cpu")``; and a power run with ``--ledger``
appends rows of the engine ``torch-cpu``, against which a second run's
sentinel judges.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import csv
import json
import os
import subprocess
import sys

import pyarrow.parquet as pq
import pytest

from ndstpu.harness import validate
from ndstpu_torch import datagen, obs
from ndstpu_torch.engine import columnar
from ndstpu_torch.engine.session import Session
from ndstpu_torch.engine.sql import normalize_sql_key
from ndstpu_torch.harness import power, scheduler, throughput
from ndstpu_torch.io import loader
from ndstpu_torch.queries import streamgen
from test_torch_corpus_common import jax_warehouse

PARTS = ["query3", "query42", "query14_part1"]
FAILING = "query100"
STREAMS = {"1": PARTS, "2": PARTS + [FAILING]}
FIXED_FIRST = "CreateTempView all tables (shared)"
FIXED_LAST = ["Power Start Time", "Power End Time", "Power Test Time",
              "Total Time"]


def _write_streams(root):
    """Streams 1 and 2 cut to ``PARTS`` (each part its own block, so that
    the power CLI names it as the full stream does), ``FAILING`` appended
    to stream 2."""
    full = root / "full"
    streamgen.generate_query_streams(None, "07291122510", str(full), 3)
    d = root / "streams"
    d.mkdir()
    for sid, names in STREAMS.items():
        parts = power.gen_sql_from_stream(str(full / f"query_{sid}.sql"))
        parts[FAILING] = "select no_such_column from store_sales;"
        (d / f"query_{sid}.sql").write_text("".join(
            f"-- start query {i} in stream {sid} using template {n}.tpl\n"
            f"{parts[n].strip()}\n" for i, n in enumerate(names, 1)))
    return d


def _port_cmd(streams, wh, side):
    return ["python", "-m", "ndstpu_torch.harness.power",
            str(streams / "query_{}.sql"), wh, str(side / "time_{}.csv"),
            "--device", "cpu", "--json_summary_folder",
            str(side / "json_{}"), "--output_prefix", str(side / "out_{}")]


def _throughput_args(side, mode, concurrent):
    return ["1,2", "--mode", mode, "--concurrent", str(concurrent),
            "--overlap_report", str(side / "overlap.json"), "--"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The warehouse, the streams and every side's run:
    {"root", "streams", "wh", "run" (the in-process InprocRun)}."""
    root = tmp_path_factory.mktemp("throughput")
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    # the SF 0.002 warehouse the template and engine files read, built
    # once a test session by the same two commands
    streams, wh = _write_streams(root), str(jax_warehouse(tmp_path_factory))
    for side in ("jax", "port", "main", "process", "generated", "ledger"):
        (root / side).mkdir()
    jax_cmd = [sys.executable, "-m", "ndstpu.harness.throughput",
               *_throughput_args(root / "jax", "inproc", 2),
               "python", "-m", "ndstpu.harness.power",
               str(streams / "query_{}.sql"), wh,
               str(root / "jax" / "time_{}.csv"), "--engine", "tpu",
               "--json_summary_folder", str(root / "jax" / "json_{}"),
               "--output_prefix", str(root / "jax" / "out_{}")]
    process_cmd = [sys.executable, "-m", "ndstpu_torch.harness.throughput",
                   *_throughput_args(root / "process", "process", 1),
                   *_port_cmd(streams, wh, root / "process")]
    # the JAX run takes most of the time: the port's in-process runs
    # beside it, the port's process mode after it, on one thread a process
    # (the tier-1 run's other workers share the cores)
    with open(root / "log.txt", "w") as log:
        # the JAX engine's warm-up replay off: a query's first run returns
        # its discovery's rows either way (test_torch_corpus_common
        # .jax_reference)
        jax = subprocess.Popen(jax_cmd, env=dict(env, NDSTPU_WARM_REPLAY="0"),
                               stdout=log,
                               stderr=subprocess.STDOUT)
        try:
            obs.reset()
            run = scheduler.run_streams_inproc(
                ["1", "2"], _port_cmd(streams, wh, root / "port"),
                concurrent=2,
                overlap_report=str(root / "port" / "overlap.json"))
            assert throughput.main(
                _throughput_args(root / "main", "inproc", 2) +
                _port_cmd(streams, wh, root / "main")) == 0
            obs.reset()
            gen = root / "generated"
            scheduler.run_streams_inproc(
                ["1", "2"], ["python", "-m", "ndstpu_torch.harness.power",
                             str(streams / "query_{}.sql"), "-",
                             str(gen / "time_{}.csv"), "--generate",
                             "0.002", "--device", "cpu", "--output_prefix",
                             str(gen / "out_{}"), "--ledger",
                             str(gen / "ledger.jsonl")], concurrent=2,
                overlap_report=str(gen / "overlap.json"))
            for n in (1, 2):
                power.main([str(streams / "query_1.sql"), wh,
                            str(root / "ledger" / f"time{n}.csv"),
                            "--device", "cpu", "--ledger",
                            str(root / "ledger" / "ledger.jsonl")])
        finally:
            rcs = [jax.wait(timeout=600)]
        rcs.append(subprocess.run(
            process_cmd, env=dict(env, OMP_NUM_THREADS="1"), stdout=log,
            stderr=subprocess.STDOUT, timeout=600).returncode)
    assert rcs == [0, 0], (root / "log.txt").read_text()[-3000:]
    assert run.rc == 0 and not run.errors
    return {"root": root, "streams": streams, "wh": wh, "run": run}


def _json(path):
    return json.loads(path.read_text())


def _time_log(path):
    with open(path) as f:
        return [r["query"] for r in csv.DictReader(f)]


def _summary(side_dir, sid, query):
    (path,) = (side_dir / f"json_{sid}").glob(f"*-{query}-*.json")
    return _json(path)


@pytest.mark.parametrize("sid", list(STREAMS))
def test_time_logs_agree(runs, sid):
    root = runs["root"]
    jax = _time_log(root / "jax" / f"time_{sid}.csv")
    for side in ("port", "main"):
        got = _time_log(root / side / f"time_{sid}.csv")
        assert got[0] == jax[0] == FIXED_FIRST
        assert got[-4:] == jax[-4:] == FIXED_LAST
        assert sorted(got[1:-4]) == sorted(jax[1:-4]) == sorted(STREAMS[sid])
    # process mode writes the power run's log, in the stream's order
    assert _time_log(root / "process" / f"time_{sid}.csv") == [
        "CreateTempView all tables", *STREAMS[sid], *FIXED_LAST]


@pytest.mark.parametrize("sid,query", [(s, q) for s, names in STREAMS.items()
                                       for q in names])
def test_summaries_agree(runs, sid, query):
    root = runs["root"]
    jax = _summary(root / "jax", sid, query)
    want = ["Failed"] if query == FAILING else ["Completed"]
    assert jax["queryStatus"] == want
    for side in ("port", "main", "process"):
        got = _summary(root / side, sid, query)
        assert sorted(got) == sorted(jax) and got["queryStatus"] == want
        assert [t["class"] for t in got.get("failureTaxonomy", [])] == \
            [t["class"] for t in jax.get("failureTaxonomy", [])]


@pytest.mark.parametrize("sid,query", [(s, q) for s in STREAMS
                                       for q in PARTS])
def test_outputs_agree(runs, sid, query):
    root = runs["root"]
    jax = str(root / "jax" / f"out_{sid}" / query)
    port = root / "port" / f"out_{sid}" / query / "part-0.parquet"
    assert validate.compare_results(jax, str(port.parent), query,
                                    ignore_ordering=False)
    for side in ("main", "process"):
        other = root / side / f"out_{sid}" / query / "part-0.parquet"
        assert pq.read_table(other).equals(pq.read_table(port)), side


def test_overlap_reports_agree(runs):
    root = runs["root"]
    jax = _json(root / "jax" / "overlap.json")
    for side in ("port", "main"):
        got = _json(root / side / "overlap.json")
        assert sorted(got) == sorted(jax)
        assert [sorted(r) for r in got["streams"]] == \
            [sorted(r) for r in jax["streams"]]
        assert got["mode"] == "inproc" and got["admission_slots"] == 2
        assert got["stream_max_concurrent"] == 2
        assert got["device_timeline"]["gated_queries"] == 7
        assert 1 <= got["max_concurrent"] <= 2
    proc = _json(root / "process" / "overlap.json")
    assert proc["mode"] == "process" and proc["admission_slots"] == 1
    assert [r["returncode"] for r in proc["streams"]] == [0, 0]


def test_sidecars_agree(runs):
    root = runs["root"]
    jax = _json(root / "jax" / "overlap.json.metrics.json")
    for side in ("port", "main"):
        got = _json(root / side / "overlap.json.metrics.json")
        assert sorted(got) == sorted(jax)
        assert got["mode"] == "inproc" and got["engine"] == "cpu"
        assert got["faultTaxonomy"] == jax["faultTaxonomy"] == {
            "counts": {"permanent": 1},
            "queries": {f"2:{FAILING}": "permanent"}}
        assert got["ledger"] is None and got["sentinel"] is None
    # process mode: one sidecar a stream process, the power run's
    for sid in STREAMS:
        side = _json(root / "process" / f"time_{sid}.csv.metrics.json")
        assert side["stream"] == f"query_{sid}"


def test_the_session_plans_each_text_once(runs):
    run, root = runs["run"], runs["root"]
    side = _json(root / "port" / "overlap.json.metrics.json")
    texts = {sid: power.gen_sql_from_stream(
        str(runs["streams"] / f"query_{sid}.sql")) for sid in STREAMS}
    distinct = {normalize_sql_key(sql) for qd in texts.values()
                for sql in qd.values()}
    # every text misses once, when the scheduler keys it; the failing
    # one is never cached, so the spine cache's installer (which plans
    # every text for its spines, as the JAX scheduler's does) and its run
    # miss again
    assert side["counters"]["engine.cache.plan.miss"] == len(distinct) + 2
    bad = normalize_sql_key(texts["2"][FAILING])
    assert bad not in run.session._plan_cache
    assert bad not in run.scheduler.compiled and not run.scheduler.inflight
    keys = {run.session.canonical_key(texts[sid][q]) for sid in STREAMS
            for q in PARTS}
    assert keys <= run.scheduler.compiled
    assert side["counters"]["engine.cache.compiled.miss"] >= len(keys)


@pytest.mark.parametrize("sid", list(STREAMS))
def test_inproc_answers_as_a_serial_run(runs, sid, tmp_path):
    sess = Session(loader.load_catalog(runs["wh"]), device="cpu")
    qd = power.gen_sql_from_stream(str(runs["streams"] / f"query_{sid}.sql"))
    for q in PARTS:
        power.run_one_query(sess, qd[q], q, str(tmp_path), "parquet")
        got = runs["root"] / "port" / f"out_{sid}" / q / "part-0.parquet"
        assert pq.read_table(got).equals(
            pq.read_table(tmp_path / q / "part-0.parquet")), q


def test_generated_warehouse_answers_as_session_does(runs):
    gen = runs["root"] / "generated"
    sess = Session(datagen.generate(0.002, 1, "cpu"), device="cpu")
    for sid in STREAMS:
        qd = power.gen_sql_from_stream(
            str(runs["streams"] / f"query_{sid}.sql"))
        for q in PARTS:
            want = columnar.to_arrow(
                power.ensure_valid_column_names(sess.sql(qd[q])))
            got = pq.read_table(gen / f"out_{sid}" / q / "part-0.parquet")
            assert got.equals(want), (sid, q)
    side = _json(gen / "overlap.json.metrics.json")
    assert side["ledger"]["appended"] == 2 * len(PARTS)
    with open(gen / "ledger.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert {(r["engine"], r["scale_factor"], r["extra"]["mode"])
            for r in rows} == {("torch-cpu", "0.002", "inproc")}


def test_ledger_feeds_the_next_runs_sentinel(runs):
    d = runs["root"] / "ledger"
    first, second = (_json(d / f"time{n}.csv.metrics.json") for n in (1, 2))
    assert first["ledger"]["appended"] == len(PARTS)
    assert first["sentinel"]["counts"] == {"cold-compile": len(PARTS)}
    with open(d / "ledger.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2 * len(PARTS)
    assert {r["engine"] for r in rows} == {"torch-cpu"}
    assert {r["extra"]["stream"] for r in rows} == {"query_1"}
    verdicts = second["sentinel"]["verdicts"]
    assert sorted(v["query"] for v in verdicts) == sorted(PARTS)
    assert all(v["baseline_warm_s"] is not None for v in verdicts)
