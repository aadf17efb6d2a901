"""The port's power and stream-generator command lines, on the CPU.

* ``python -m ndstpu_torch.queries.streamgen`` writes the same stream files
  as the JAX package's writer;
* ``power.main([..., "--generate", "0.002", "--device", "cpu"])`` answers as
  ``Session`` does over ``datagen.generate(0.002, 1, "cpu")``; a second run
  with the first's ``--compile_records`` discovers nothing and answers the
  same; ``--resume`` skips the queries the journal holds for the same
  fingerprint, and none for another;
* a query the watchdog abandons is retried on a fresh session that shares
  the old one's device tables;
* with no card and no ``--device cpu``, or an output prefix and no pyarrow,
  the run refuses to start;
* the copied ``faults.classify``, ``BudgetedQueue`` and
  ``atomic.read_jsonl`` equal the JAX package's on a table of cases.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import csv
import json
import os
import subprocess
import sys

import pyarrow.parquet as pq
import pytest
import torch

from ndstpu import faults as jax_faults
from ndstpu.harness import progress as jax_progress
from ndstpu.io import atomic as jax_atomic
from ndstpu.queries import streamgen as jax_streamgen
from ndstpu_torch import datagen, faults
from ndstpu_torch.engine import columnar
from ndstpu_torch.engine.session import Session
from ndstpu_torch.harness import power, progress
from ndstpu_torch.io import atomic, loader
from ndstpu_torch.queries import corpus

SEED = "07291122510"
PARTS = ["query3", "query42", "query14_part1"]


@pytest.mark.parametrize("mode", [["--streams", "3"],
                                  ["--template", "query14"]],
                         ids=["streams", "template"])
def test_streamgen_cli_writes_the_jax_files(tmp_path, mode):
    port, jax = tmp_path / "port", tmp_path / "jax"
    subprocess.run([sys.executable, "-m", "ndstpu_torch.queries.streamgen",
                    "--output_dir", str(port), "--rngseed", SEED, *mode],
                   check=True, env=dict(os.environ, PYTHONPATH=os.getcwd()),
                   stdout=subprocess.DEVNULL)
    if mode[0] == "--streams":
        jax_streamgen.generate_query_streams(None, SEED, str(jax), 3)
    else:
        jax_streamgen.generate_single_template(mode[1], None, SEED, str(jax))
    names = sorted(os.listdir(jax))
    assert sorted(os.listdir(port)) == names and names
    for n in names:
        assert (port / n).read_bytes() == (jax / n).read_bytes(), n


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    (path,) = jax_streamgen.generate_query_streams(None, SEED, str(d), 1)
    return path


def test_stream_parts_are_the_corpus(stream):
    from ndstpu.harness.power import gen_sql_from_stream
    parts = power.gen_sql_from_stream(stream)
    assert parts == gen_sql_from_stream(stream)
    assert list(parts) == [name for name, _sql in corpus()]


def _main(stream, time_log, *extra):
    power.main([stream, "-", str(time_log), "--generate", "0.002",
                "--device", "cpu", "--sub_queries", ",".join(PARTS), *extra])


def _sidecar(time_log):
    with open(f"{time_log}.metrics.json") as f:
        return json.load(f)


def _outputs(prefix):
    return {q: pq.read_table(os.path.join(prefix, q, "part-0.parquet"))
            for q in PARTS}


@pytest.fixture(scope="module")
def generated(stream, tmp_path_factory):
    """Four runs over the generated warehouse: cold with compile records,
    preloading them, and two resumes of the second's journal (the same
    fingerprint, then another seed)."""
    d = tmp_path_factory.mktemp("generated")
    rec = str(d / "records.pkl")
    _main(stream, d / "cold.csv", "--compile_records", rec,
          "--output_prefix", str(d / "cold"))
    _main(stream, d / "warm.csv", "--compile_records", rec,
          "--output_prefix", str(d / "warm"))
    sides = {"warm": _sidecar(d / "warm.csv")}
    _main(stream, d / "warm.csv", "--resume")
    sides["resumed"] = _sidecar(d / "warm.csv")
    _main(stream, d / "warm.csv", "--resume", "--generate_seed", "2")
    return d, sides


def test_generated_warehouse_answers_as_session_does(generated):
    d, _ = generated
    sess = Session(datagen.generate(0.002, 1, "cpu"), device="cpu")
    sql = dict(corpus())
    got = _outputs(d / "cold")
    for q in PARTS:
        want = columnar.to_arrow(
            power.ensure_valid_column_names(sess.sql(sql[q])))
        assert got[q].equals(want), q
    side = _sidecar(d / "cold.csv")
    assert side["counters"]["engine.discoveries"] == len(PARTS)
    assert {q["query"]: q["attrs"]["result_rows"]
            for q in side["queries"]} == {q: got[q].num_rows for q in PARTS}


def test_compile_records_skip_discovery(generated):
    d, sides = generated
    counters = sides["warm"]["counters"]
    assert counters["harness.compile_records.preloaded"] == len(PARTS)
    assert counters.get("engine.discoveries", 0) == 0
    assert counters["engine.cache.compiled.hit"] == len(PARTS)
    assert sides["warm"]["totals"]["cold_queries"] == 0
    cold, warm = _outputs(d / "cold"), _outputs(d / "warm")
    assert all(warm[q].equals(cold[q]) for q in PARTS)


def test_resume_skips_the_same_fingerprint_only(generated):
    d, sides = generated
    resumed = sides["resumed"]
    assert resumed["resumed"] == PARTS
    assert "engine.discoveries" not in resumed["counters"]
    again = _sidecar(d / "warm.csv")
    assert again["resumed"] is None
    assert again["counters"]["engine.discoveries"] == len(PARTS)
    with open(d / "warm.csv") as f:
        assert [r["query"] for r in csv.DictReader(f)][1:4] == PARTS


def test_hung_query_is_retried_on_a_fresh_session(stream, tmp_path,
                                                  monkeypatch):
    # the watchdog leaves each query 4 s, ten times what a part here takes
    # alone, so that a loaded machine does not time the retry out too
    monkeypatch.setenv("NDSTPU_POWER_QUERY_TIMEOUT_S", "4")
    faults.install("execute:hang:1:times=1:hang=6")
    try:
        _main(stream, tmp_path / "t.csv", "--json_summary_folder",
              str(tmp_path / "json"))
    finally:
        faults.uninstall()
    side = _sidecar(tmp_path / "t.csv")
    assert side["counters"]["faults.injected.total"] == 1
    assert side["counters"]["harness.retry.recovered"] == 1
    statuses = {}
    for p in (tmp_path / "json").glob("*.json"):
        s = json.loads(p.read_text())
        statuses[s["query"]] = s["queryStatus"]
    assert statuses == {q: ["Completed"] for q in PARTS}


@pytest.fixture(scope="module")
def q3_tables():
    return datagen.generate(0.002, 1, "cpu",
                            tables=["store_sales", "date_dim", "item"])


def test_fresh_session_shares_device_tables(q3_tables):
    sess = Session(q3_tables, device="cpu")
    sess.sql(dict(corpus())["query3"])
    fresh = sess.fresh()
    cache = sess.executor._device_cache
    assert cache and all(fresh.executor._device_cache[t][1] is cache[t][1]
                         for t in cache)
    assert fresh.compiled_count() == 0 and fresh.executor is not sess.executor


def test_compile_records_keep_the_discovery_peak(q3_tables, tmp_path):
    # a preloaded record's capture is sized by its discovery's peak bytes
    # (measured on a card only, so set here by hand)
    sql = dict(corpus())["query3"]
    sess = Session(q3_tables, device="cpu")
    sess.sql(sql)
    sess.compiled_plan(sql).peak_bytes = 123456789
    sess.save_compiled(str(tmp_path / "records.pkl"))
    other = Session(q3_tables, device="cpu")
    assert other.preload_compiled(str(tmp_path / "records.pkl")) == 1
    assert other.compiled_plan(sql).peak_bytes == 123456789


def test_no_card_refuses(stream, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        power.main([stream, "-", str(tmp_path / "t.csv"), "--generate",
                    "0.002"])


def test_output_prefix_without_pyarrow_refuses(stream, tmp_path,
                                               monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] == "pyarrow"]:
        monkeypatch.setitem(sys.modules, m, None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ModuleNotFoundError, match="pyarrow"):
        _main(stream, tmp_path / "t.csv", "--output_prefix",
              str(tmp_path / "out"))
    with pytest.raises(ModuleNotFoundError, match="pyarrow"):
        loader.load_catalog(str(tmp_path))
    assert not (tmp_path / "t.csv").exists()


def test_warehouse_and_generate_exclude_each_other(stream, tmp_path):
    with pytest.raises(SystemExit):
        power.main([stream, str(tmp_path), str(tmp_path / "t.csv"),
                    "--generate", "0.002", "--device", "cpu"])
    with pytest.raises(SystemExit):
        power.main([stream, "-", str(tmp_path / "t.csv"), "--device", "cpu"])


# -- the copies against the JAX package's ------------------------------------

class PlanError(Exception):
    pass


class CommitConflict(RuntimeError):
    pass


EXCEPTIONS = [
    TimeoutError("query hung"), ConnectionResetError("peer"),
    ValueError("bad"), KeyError("k"), TypeError("t"), PlanError("no column"),
    CommitConflict("lost the race"), NotImplementedError("later"),
    RuntimeError("DEADLINE EXCEEDED while waiting"),
    RuntimeError("CUDA error: device-side assert triggered\nCUDA kernel "
                 "errors might be asynchronously reported at some other API "
                 "call"),
    RuntimeError("CUDA out of memory. Tried to allocate 5.33 GiB"),
    OSError("connection refused by peer"), OSError("disk full"),
    Exception(""),
]


@pytest.mark.parametrize("exc", EXCEPTIONS, ids=lambda e: repr(e)[:40])
def test_classify_equals_jax(exc):
    assert faults.classify(exc) == jax_faults.classify(exc)
    port = faults.InjectedTransient("x", "execute")
    jax = jax_faults.InjectedTransient("x", "execute")
    assert faults.classify(port) == jax_faults.classify(jax) == "transient"


def test_device_assert_is_permanent():
    assert faults.classify(EXCEPTIONS[9]) == "permanent"


QUEUES = [
    # names, budget, costs by name, elapsed seconds at each next()
    (["a", "b", "c"], None, {}, [0, 1, 2, 3]),
    (["a", "b", "c"], 100.0, {"a": 30, "b": 10, "c": 20}, [0, 1, 2, 3]),
    (["a", "b", "c"], 25.0, {"a": 30, "b": 10, "c": 20}, [0, 12, 24, 30]),
    (["a", "b", "c"], 0.001, {}, [5]),
    (["a", "b", "c", "d"], 12.0, {"c": 1}, [0, 6, 11, 11.5]),
]


@pytest.mark.parametrize("names,budget,costs,elapsed", QUEUES)
def test_budgeted_queue_equals_jax(names, budget, costs, elapsed):
    def drain(mod):
        events = []
        q = mod.BudgetedQueue(names, budget, costs.get, phase="power",
                              on_event=events.append)
        got = [q.next(e) for e in elapsed]
        return got, q.skipped, q.reordered, events, q.projected_s()
    assert drain(progress) == drain(jax_progress)
    assert progress.ledger_estimator(None)("a") is None


JOURNALS = [
    '{"a": 1}\n{"a": 2}\n',
    '{"a": 1}\n\n{"a": 2}\n',
    '{"a": 1}\n{"a": 2',
    '{"a": 1}\n{"a"\n{"a": 3}\n',
    '',
    None,
]


@pytest.mark.parametrize("text", JOURNALS)
def test_read_jsonl_equals_jax(tmp_path, text):
    path = tmp_path / "j.jsonl"
    if text is not None:
        path.write_text(text)

    def read(mod):
        try:
            return mod.read_jsonl(str(path))
        except ValueError as e:
            return type(e).__name__
    assert read(atomic) == read(jax_atomic)
    atomic.append_jsonl(str(tmp_path / "k.jsonl"), {"q": 1})
    assert atomic.read_jsonl(str(tmp_path / "k.jsonl")) == [{"q": 1}]


def test_preloaded_record_replays_with_no_host_sync(q3_tables, tmp_path):
    # a fresh process's first run of a preloaded record captures on a card
    # with no table uploaded yet: the upload must happen outside the replay
    from test_torch_corpus_common import replays_without_sync
    sql = dict(corpus())["query3"]
    sess = Session(q3_tables, device="cpu")
    want = sess.sql(sql)
    sess.save_compiled(str(tmp_path / "records.pkl"))
    other = Session(q3_tables, device="cpu")
    other.preload_compiled(str(tmp_path / "records.pkl"))
    with replays_without_sync(other.executor):
        got = other.sql(sql)
    assert other.executor.n_discoveries == 0
    assert columnar.to_arrow(got).equals(columnar.to_arrow(want))
