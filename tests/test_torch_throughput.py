"""The port's throughput pieces against the JAX package's, on tables of cases.

* ``throughput.concurrency_timeline`` equals the JAX function on
  hypothesis-drawn stream intervals;
* ``scheduler.StreamScheduler`` makes the JAX scheduler's picks, skips and
  events, and ends with its ``compiled`` and ``inflight``, on the same
  streams, priors and ``next``/``done`` sequences (a failed query, budget
  cuts, continuous feed);
* ``admission.InprocAdmission`` caps concurrency at its slots and reports
  the JAX gate's ``device_timeline`` keys;
* ``throughput.run_throughput`` restarts a failed stream once and counts a
  second failure permanent, as the JAX runner does with a stand-in stream
  process;
* ``throughput.main`` refuses what the JAX ``main`` refuses, with 2, and
  ``--mode serve`` without ``--serve_socket`` with 2 and a message naming
  the flag and the port's server;
* the inproc runner takes only the port's power command and streams that
  share one warehouse;
* ``obs.ledger`` and ``obs.sentinel`` give the JAX modules' rows, priors
  and verdicts on one seeded ledger;
* two stream threads' reports, open at once, each record the warnings of
  their own thread, and a thread the query starts reports to the one open
  report.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import json
import sys
import textwrap
import threading
import time
import warnings

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from ndstpu.harness import admission as jax_admission
from ndstpu.harness import scheduler as jax_scheduler
from ndstpu.harness import throughput as jax_throughput
from ndstpu.obs import ledger as jax_ledger
from ndstpu.obs import sentinel as jax_sentinel
from ndstpu_torch.faults import taxonomy
from ndstpu_torch.harness import admission, scheduler, throughput
from ndstpu_torch.harness.report import BenchReport
from ndstpu_torch.obs import ledger, sentinel


# -- the concurrency timeline -------------------------------------------------

_interval = st.tuples(st.floats(0, 1e4, allow_nan=False),
                      st.floats(0, 1e3, allow_nan=False))


@settings(max_examples=200, deadline=None)
@given(st.lists(_interval, max_size=8))
def test_concurrency_timeline_is_the_jax_one(intervals):
    records = [{"stream": str(i), "start_epoch_s": round(s, 3),
                "end_epoch_s": round(s + d, 3)}
               for i, (s, d) in enumerate(intervals)]
    assert throughput.concurrency_timeline(records) == \
        jax_throughput.concurrency_timeline(records)


# -- the stream scheduler -----------------------------------------------------

TEXTS = {"a": "select 1", "b": "select 2", "c": "select 3",
         "d": "select  1"}     # d normalizes to a's key
COLD = {"a": 10.0, "b": 2.0, "c": 5.0, "d": 7.0}

# (streams, budget, cold priors, warm priors, steps); a step is
# ("next", stream, elapsed), ("done", stream, name, failed),
# ("open", stream), ("feed", stream, name, text) or ("close", stream)
SCHEDULES = {
    "cold cheapest first, then shared": (
        {"1": ["a", "b", "c"], "2": ["a", "b", "c"]}, None, COLD,
        {"a": 1.0, "b": 1.0, "c": 1.0},
        [("next", "1", 0), ("next", "2", 0), ("done", "1", "b", False),
         ("next", "2", 0), ("next", "2", 0), ("done", "2", "c", False),
         ("done", "2", "a", False), ("done", "2", "b", False),
         ("next", "1", 0), ("next", "1", 0), ("next", "1", 0)]),
    "a failed query is not published": (
        {"1": ["a", "c"], "2": ["a", "c"]}, None, COLD, None,
        [("next", "1", 0), ("next", "1", 0), ("done", "1", "c", True),
         ("next", "2", 0), ("done", "1", "a", False), ("next", "2", 0),
         ("next", "1", 0)]),
    "one key, two texts": (
        {"1": ["a", "d"], "2": ["d", "c"]}, None, COLD, None,
        [("next", "2", 0), ("next", "1", 0), ("next", "1", 0),
         ("done", "2", "c", False), ("next", "2", 0)]),
    "budget: the cheapest does not fit": (
        {"1": ["a", "b"]}, 10.0, {"a": 4.0, "b": 20.0}, {"a": 1.0},
        [("next", "1", 0), ("done", "1", "a", False), ("next", "1", 5.0),
         ("next", "1", 6.0)]),
    "budget exhausted": (
        {"1": ["a", "c"], "2": ["b"]}, 5.0, COLD, None,
        [("next", "2", 1.0), ("next", "1", 6.0), ("next", "2", 7.0)]),
    "continuous feed": (
        {"1": ["b"]}, None, COLD, None,
        [("open", "9"), ("feed", "9", "a", "select 1"), ("next", "1", 0),
         ("next", "9", 0), ("feed", "9", "c", "select 3"),
         ("done", "9", "a", False), ("close", "9"), ("next", "9", 0),
         ("next", "9", 0), ("next", "1", 0)]),
}


def _drive(module, streams, budget, cold, warm, steps):
    events = []
    sched = module.StreamScheduler(
        {sid: {n: TEXTS[n] for n in names} for sid, names in
         streams.items()}, budget_s=budget,
        est_cold=cold.get if cold else None,
        est_warm=warm.get if warm else None, on_event=events.append)
    seen = []
    for step in steps:
        op, sid = step[0], step[1]
        if op == "next":
            seen.append(sched.view(sid).next(step[2]))
        elif op == "done":
            sched.view(sid).done(step[2], failed=step[3])
        elif op == "open":
            sched.open_stream(sid)
        elif op == "feed":
            sched.feed(sid, step[2], step[3])
        else:
            sched.close(sid)
    views = {sid: sched.view(sid) for sid in streams}
    return {"picks": seen, "events": events,
            "skipped": {sid: v.skipped for sid, v in views.items()},
            "projected": {sid: v.projected_s() for sid, v in views.items()},
            "compiled": sorted(sched.compiled),
            "inflight": dict(sched.inflight)}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_stream_scheduler_is_the_jax_one(case):
    port = _drive(scheduler, *SCHEDULES[case])
    assert port == _drive(jax_scheduler, *SCHEDULES[case])
    assert any(port["picks"])


def test_stream_scheduler_reports_the_cuts():
    got = _drive(scheduler, *SCHEDULES["budget: the cheapest does not fit"])
    assert got["picks"] == ["a", None, None]
    assert "exceeds remaining" in got["skipped"]["1"]["b"]
    assert any("cheapest-first" in e for e in got["events"])
    got = _drive(scheduler, *SCHEDULES["budget exhausted"])
    assert got["picks"] == ["b", None, None]
    assert set(got["skipped"]["1"]) == {"a", "c"}
    assert "budget exhausted" in got["skipped"]["1"]["a"]


def test_feed_refuses_a_closed_stream():
    sched = scheduler.StreamScheduler({})
    with pytest.raises(ValueError, match="not open"):
        sched.feed("1", "a", "select 1")


# -- the in-process admission gate -------------------------------------------

@pytest.mark.parametrize("slots", [1, 2, 3])
def test_inproc_admission_caps_concurrency(slots):
    gates = [admission.InprocAdmission(slots),
             jax_admission.InprocAdmission(slots)]
    inside, peak, mu = [0], [0], threading.Lock()

    def work(gate):
        with gate.slot():
            with mu:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            time.sleep(0.02)
            with mu:
                inside[0] -= 1

    threads = [threading.Thread(target=work, args=(gates[0],))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    tl = gates[0].device_timeline()
    assert 1 <= peak[0] <= tl["max_concurrent"] <= slots
    assert tl["slots"] == slots and tl["gated_queries"] == 6
    assert tl["busy_s_total"] > 0
    assert sorted(tl) == sorted(gates[1].device_timeline())
    with pytest.raises(ValueError):
        admission.InprocAdmission(0)


# -- the process runner's restart --------------------------------------------

def _flaky_stream_script(tmp_path, fail_rc, then_succeed):
    """A stand-in stream process: exits ``fail_rc`` on the first run
    for a given stream id and, when ``then_succeed``, 0 afterwards."""
    script = tmp_path / "stream.py"
    script.write_text(textwrap.dedent(f"""\
        import pathlib, sys
        marker = pathlib.Path(sys.argv[1]) / ("ran_" + sys.argv[2])
        if marker.exists() and {then_succeed!r}:
            sys.exit(0)
        marker.touch()
        sys.exit({fail_rc})
        """))
    return str(script)


def test_run_throughput_restarts_a_failed_stream_once(tmp_path, capsys):
    script = _flaky_stream_script(tmp_path, fail_rc=3, then_succeed=True)
    report = tmp_path / "overlap.json"
    rc = throughput.run_throughput(
        ["0", "1"], [sys.executable, script, str(tmp_path), "{}"],
        concurrent=1, overlap_report=str(report))
    assert rc == 0
    assert "restarting once (taxonomy: transient)" in capsys.readouterr().out
    doc = json.loads(report.read_text())
    assert doc["format"] == "ndstpu-throughput-overlap-v1"
    assert doc["mode"] == "process" and doc["admission_slots"] == 1
    assert len(doc["streams"]) == 2
    for rec in doc["streams"]:
        assert rec["returncode"] == 0 and rec["restarts"] == 1
        assert rec["first_attempt"]["returncode"] == 3
        assert rec["taxonomy"] == taxonomy.TRANSIENT


def test_run_throughput_second_failure_is_permanent(tmp_path):
    script = _flaky_stream_script(tmp_path, fail_rc=4, then_succeed=False)
    report = tmp_path / "overlap.json"
    rc = throughput.run_throughput(
        ["0"], [sys.executable, script, str(tmp_path), "{}"],
        overlap_report=str(report))
    assert rc == 4
    rec = json.loads(report.read_text())["streams"][0]
    assert rec["restarts"] == 1 and rec["returncode"] == 4
    assert rec["taxonomy"] == taxonomy.PERMANENT


# -- the command line ---------------------------------------------------------

BAD_ARGS = {
    "no arguments": [],
    "no command": ["1,2"],
    "concurrent 0": ["1,2", "--concurrent", "0", "--", "true"],
    "concurrent not a number": ["1", "--concurrent", "x", "--", "true"],
    "concurrent without a value": ["1", "--concurrent"],
    "budget not positive": ["1", "--budget_s", "-1", "--", "true"],
    "report without a value": ["1", "--overlap_report"],
    "unknown mode": ["1", "--mode", "bogus", "--", "true"],
    "serve": ["1", "--mode", "serve", "--", "true"],
}


@pytest.mark.parametrize("case", list(BAD_ARGS))
def test_main_refuses_what_the_jax_main_refuses(case, capsys):
    assert jax_throughput.main(list(BAD_ARGS[case])) == 2
    capsys.readouterr()
    assert throughput.main(list(BAD_ARGS[case])) == 2
    err = capsys.readouterr().err
    if case == "serve":
        assert "--serve_socket" in err and "ndstpu_torch.harness.serve" in err


def test_inproc_takes_only_the_ports_power_command(tmp_path):
    with pytest.raises(ValueError, match="ndstpu_torch.harness.power"):
        scheduler.run_streams_inproc(
            ["1"], ["python", "-m", "ndstpu.harness.power", "q.sql", "wh",
                    "t.csv"])
    with pytest.raises(ValueError, match="share one input_prefix"):
        scheduler.run_streams_inproc(
            ["1", "2"], ["python", "-m", "ndstpu_torch.harness.power",
                         "q_{}.sql", str(tmp_path / "wh_{}"), "t_{}.csv",
                         "--device", "cpu"])
    with pytest.raises(ValueError, match="share one generate"):
        scheduler.run_streams_inproc(
            ["1", "2"], ["python", "-m", "ndstpu_torch.harness.power",
                         "q_{}.sql", "-", "t_{}.csv", "--generate",
                         "0.00{}", "--device", "cpu"])


# -- the run ledger and the regression sentinel ------------------------------

QUERIES = [f"query{i}" for i in range(1, 9)]
ENGINES = ["torch-cuda", "torch-cpu", "tpu"]
SCALES = ["1", "20"]


def _seeded_entries(module):
    rng = np.random.default_rng(7)
    out = []
    for i in range(300):
        wall = float(rng.uniform(0.01, 5.0))
        kind = rng.integers(4)
        compile_s = wall * 0.8 if kind == 0 else 0.0
        execute_s = wall - compile_s if kind != 3 else 0.0
        extra = {"stream": f"query_{i % 3}"}
        if kind == 2:
            extra["spine_hits"] = 1
        if i % 11 == 0:
            extra["snapshot_epoch"] = f"e{i % 2}"
        out.append(module.make_entry(
            QUERIES[rng.integers(len(QUERIES))], wall, compile_s, execute_s,
            engine=ENGINES[rng.integers(len(ENGINES))],
            scale_factor=SCALES[rng.integers(len(SCALES))], seed="1",
            source="seeded", ts=1.0e9 + i, extra=extra))
    return out


def test_ledger_rows_and_priors_are_the_jax_ones(tmp_path):
    rows = _seeded_entries(ledger)
    assert rows == _seeded_entries(jax_ledger)
    path = tmp_path / "ledger.jsonl"
    jax_ledger.Ledger(str(path)).append(rows[:150])
    ledger.Ledger(str(path)).append(rows[150:])
    with open(path, "a") as f:
        f.write("{not json\n")
    port, jax = ledger.Ledger(str(path)), jax_ledger.Ledger(str(path))
    assert port.entries == jax.entries == rows
    assert port.corrupt_lines == jax.corrupt_lines == 1
    assert port.append(rows[:5], dedupe=True) == 0
    for q in QUERIES + ["query99"]:
        for eng in ENGINES + [None]:
            for sf in SCALES + [None]:
                for warmth in ("warm", "cold"):
                    args = dict(engine=eng, scale_factor=sf, warmth=warmth,
                                default=3.5)
                    assert port.estimate(q, **args) == \
                        jax.estimate(q, **args)
                assert port.best_warm(q, eng, sf, "e1") == \
                    jax.best_warm(q, eng, sf, "e1")
                assert port.warm_epochs(q, eng, sf) == \
                    jax.warm_epochs(q, eng, sf)
    assert port.queries() == jax.queries()
    assert ledger.default_path("/r") == jax_ledger.default_path("/r")


def test_sentinel_verdicts_are_the_jax_ones(tmp_path):
    led = ledger.Ledger()
    led.append(_seeded_entries(ledger))
    jled = jax_ledger.Ledger()
    jled.append(_seeded_entries(jax_ledger))
    rng = np.random.default_rng(11)
    run = []
    for q in QUERIES + ["query99"]:
        wall = float(rng.uniform(0.01, 6.0))
        attrs = {}
        if q == "query3":
            attrs = {"error": "boom", "error_taxonomy": "permanent",
                     "error_attempts": 1}
        elif q == "query4":
            attrs = {"error": "boom"}
        elif q == "query5":
            attrs = {"spine_hits": 2, "spine_bytes_saved": 10}
        run.append({"query": q, "wall_s": wall,
                    "compile_s": wall * 0.5 if q == "query6" else 0.0,
                    "execute_s": wall, "attrs": attrs})
    for eng in ENGINES:
        for sf in SCALES:
            for epoch in (None, "e0"):
                port = sentinel.classify_run(run, led, engine=eng,
                                             scale_factor=sf,
                                             snapshot_epoch=epoch)
                assert port == jax_sentinel.classify_run(
                    run, jled, engine=eng, scale_factor=sf,
                    snapshot_epoch=epoch)
    assert {v["verdict"] for v in port["verdicts"]} >= {
        "failed-permanent", "failed", "cold-compile"}
    assert sentinel.markdown_table(port) == jax_sentinel.markdown_table(port)
    paths = sentinel.write_reports(port, str(tmp_path / "r.json"),
                                   str(tmp_path / "r.md"))
    assert json.loads((tmp_path / "r.json").read_text()) == port
    assert sorted(paths) == ["json", "md"]


# -- the reports of concurrent streams ---------------------------------------

def test_concurrent_reports_keep_their_own_warnings():
    """Stream a's report opens first and closes first, with b's open
    throughout: a process-wide ``catch_warnings`` a report recorded a's
    warning in b's report and showed b's on stderr instead of recording
    it."""
    a_warned, b_open, out = threading.Event(), threading.Event(), {}
    before = warnings.showwarning

    def a():
        def fn():
            b_open.wait(10)
            warnings.warn("from a")
        out["a"] = BenchReport().report_on(fn, query_name="a")
        a_warned.set()

    def b():
        def fn():
            b_open.set()
            a_warned.wait(10)
            warnings.warn("from b")
        out["b"] = BenchReport().report_on(fn, query_name="b")

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    for name in ("a", "b"):
        assert out[name]["queryStatus"] == ["CompletedWithTaskFailures"]
        assert out[name]["taskFailures"] == [f"from {name}"]
    assert warnings.showwarning is before


def test_a_query_thread_reports_to_the_open_report():
    def fn():
        th = threading.Thread(target=warnings.warn, args=("from a worker",))
        th.start()
        th.join(10)

    got = BenchReport().report_on(fn, query_name="q")
    assert got["taskFailures"] == ["from a worker"]
    assert BenchReport().report_on(lambda: None, query_name="q")[
        "queryStatus"] == ["Completed"]
