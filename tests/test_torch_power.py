"""The port's power run against the JAX package's, on one small warehouse.

The warehouse is the one ``tests/test_harness.py`` builds for itself: the
JAX package's generator (``ndstpu.datagen.driver``) at SF 0.002, then
``ndstpu.io.transcode`` with its default Parquet layout, built once a test
session (``test_torch_corpus_common.jax_warehouse``).  Stream 0 (rngseed
07291122510) gets one more query, ``query100``, which names a column no
table has, so that it fails on both sides.  Over the parts ``query3``,
``query42``, ``query14_part1``, ``query14_part2`` and ``query100``,
``python -m ndstpu.harness.power --engine tpu`` (the JAX engine on the CPU,
in a process of its own) and the port's ``power.main(..., "--device",
"cpu")`` (in this process, each query on the watchdog's thread) must
agree on:

* the time log's query column, row by row, fixed rows included;
* each summary's keys, ``queryStatus`` and ``failureTaxonomy`` classes;
* the metrics sidecar's keys;
* each output directory, under the validator's comparison
  (``ndstpu.harness.validate``: in order, floats within 1e-5 relative),
  and every value that is not a float exactly;

and a run with a budget too small for any query is partial on both sides,
with the same ``partial_reasons`` keys.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import csv
import json
import os
import subprocess
import sys

import pytest

from ndstpu.harness import validate
from ndstpu_torch.harness import power
from test_torch_corpus_common import jax_warehouse

PARTS = ["query3", "query42", "query14_part1", "query14_part2"]
FAILING = "query100"
SUBSET = ",".join(PARTS + [FAILING])


def _jax_power(env, *args, log):
    return subprocess.Popen(
        [sys.executable, "-m", "ndstpu.harness.power", *args,
         "--engine", "tpu"], env=env, stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The warehouse, then both sides' runs: {side: {"dir", "budget"}}."""
    root = tmp_path_factory.mktemp("power")
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    # the SF 0.002 warehouse the template and engine files read, built
    # once a test session by the same two commands
    wh = str(jax_warehouse(tmp_path_factory))
    from ndstpu.queries import streamgen
    (path,) = streamgen.generate_query_streams(None, "07291122510",
                                               str(root), 1)
    stream = root / "stream.sql"
    stream.write_text(open(path).read() + (
        f"\n-- start query 100 in stream 0 using template {FAILING}.tpl\n"
        f"select no_such_column from store_sales;\n"
        f"-- end query 100 in stream 0 using template {FAILING}.tpl\n"))

    def args(side, budget=False):
        d = root / side
        if budget:
            return [str(stream), wh, str(d / "budget.csv"), "--sub_queries",
                    SUBSET, "--budget_s", "0.001"]
        return [str(stream), wh, str(d / "time.csv"), "--sub_queries",
                SUBSET, "--json_summary_folder", str(d / "json"),
                "--output_prefix", str(d / "out")]

    # the JAX runs take most of the time: they run beside the port's
    (root / "jax").mkdir()
    with open(root / "jax" / "log.txt", "w") as log:
        # the JAX engine's warm-up replay off: a query's first run returns
        # its discovery's rows either way (test_torch_corpus_common
        # .jax_reference)
        jax_env = dict(env, NDSTPU_WARM_REPLAY="0")
        procs = [_jax_power(jax_env, *args("jax"), log=log),
                 _jax_power(jax_env, *args("jax", budget=True), log=log)]
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("NDSTPU_POWER_QUERY_TIMEOUT_S", "600")
                power.main(args("port") + ["--device", "cpu"])
                power.main(args("port", budget=True) + ["--device", "cpu"])
        finally:
            rcs = [p.wait(timeout=600) for p in procs]
    assert rcs == [0, 0], (root / "jax" / "log.txt").read_text()[-3000:]
    return {side: root / side for side in ("jax", "port")}


def _time_log(path):
    with open(path) as f:
        return [r["query"] for r in csv.DictReader(f)]


def _summary(side_dir, query):
    (path,) = (side_dir / "json").glob(f"*-{query}-*.json")
    return json.loads(path.read_text())


def _sidecar(side_dir, name="time.csv"):
    return json.loads((side_dir / f"{name}.metrics.json").read_text())


def test_time_logs_agree(runs):
    jax, port = (_time_log(runs[s] / "time.csv") for s in ("jax", "port"))
    assert port == jax
    assert port == ["CreateTempView all tables", *PARTS, FAILING,
                    "Power Start Time", "Power End Time", "Power Test Time",
                    "Total Time"]


@pytest.mark.parametrize("query", PARTS + [FAILING])
def test_summaries_agree(runs, query):
    jax, port = (_summary(runs[s], query) for s in ("jax", "port"))
    assert sorted(port) == sorted(jax)
    assert port["queryStatus"] == jax["queryStatus"] == (
        ["Failed"] if query == FAILING else ["Completed"])
    assert [t["class"] for t in port.get("failureTaxonomy", [])] == \
        [t["class"] for t in jax.get("failureTaxonomy", [])]
    assert port["env"]["engineVersion"]


def test_sidecars_agree(runs):
    jax, port = (_sidecar(runs[s]) for s in ("jax", "port"))
    assert sorted(port) == sorted(jax)
    assert port["faultTaxonomy"] == jax["faultTaxonomy"] == {
        "counts": {"permanent": 1}, "queries": {FAILING: "permanent"}}
    assert port["ledger"] is None and port["sentinel"] is None
    # the executor's spans: every query's first run discovers
    assert port["counters"]["engine.discoveries"] == len(PARTS)
    assert all(q["mode"] == "cold" for q in port["queries"]
               if q["query"] in PARTS)


@pytest.mark.parametrize("query", PARTS)
def test_outputs_agree(runs, query):
    a, b = (str(runs[s] / "out" / query) for s in ("jax", "port"))
    assert validate.compare_results(a, b, query, ignore_ordering=False)
    for ra, rb in zip(validate.collect_results(a, False),
                      validate.collect_results(b, False)):
        for x, y in zip(ra, rb):
            if not isinstance(x, float):
                assert x == y, (ra, rb)


def test_budget_cut_agrees(runs):
    jax, port = (_sidecar(runs[s], "budget.csv") for s in ("jax", "port"))
    assert port["partial"] and jax["partial"]
    assert sorted(port["partial_reasons"]) == sorted(jax["partial_reasons"])
    assert sorted(port["partial_reasons"]) == sorted(PARTS + [FAILING])
