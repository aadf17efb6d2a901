"""Replay attribution and the engine's remaining spans and counters, on
the CPU, against the JAX package's names.

* With ``NDSTPU_ATTRIB=1`` every replay leaves ``last_attribution`` with
  the JAX keys (``host_prep_s``, ``device_s``, ``fetch_s``,
  ``fetched_bytes``, ``n_programs``, ``flops``), the three times within
  the query's wall time, ``flops`` None (XLA's cost analysis has no
  counterpart), and puts it on the query's summary, so that the power
  run's sidecar carries it a query.  Without it ``last_attribution``
  stays None, and only the always-on part remains: the
  ``engine.fetched_bytes`` counter and the ``replay`` span's
  ``host_prep_s`` and ``fetched_bytes``.
* A canonicalization failure (patched in) counts ``engine.canon.errors``
  and annotates the query ``canon_error``, and the query still answers,
  under its text; ``NDSTPU_CANON=0`` turns canonicalization off.
* ``engine.cache.device.miss`` and ``engine.dict.lookups``/``misses``
  count as the JAX engine's do on the same parts over one warehouse
  (misses: one upload a table; lookups: one a ``=``/``<>`` string
  binding a run), and device-cache hits are counted in both.
* The out-of-core executor's spine runs under the JAX name
  ``spine_trace_exec``.
* ``python -m ndstpu_torch.profile --corpus --attrib --device cpu`` prints
  a line a part with its split and dominant share."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import json

import pytest

from ndstpu import obs as jax_obs
from ndstpu.io import loader as jax_loader
from ndstpu_torch import carry, datagen, obs, profile
from ndstpu_torch.analysis import canon
from ndstpu_torch.engine.session import Session
from ndstpu_torch.harness import power
from ndstpu_torch.queries import streamgen
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import SQL, jax_reference, jax_warehouse

KEYS = {"host_prep_s", "device_s", "fetch_s", "fetched_bytes", "n_programs",
        "flops"}
PARTS = ["query3", "query7", "query14_part1", "query42"]


@pytest.fixture(scope="module")
def catalog():
    return datagen.generate(0.002, 1, "cpu")


def _query(sess, name):
    """``name`` under a query span; (result, wall seconds, summary)."""
    with obs.span(name, cat="query", collect=True) as sp:
        out = sess.sql(SQL[name])
    (summary,) = [q for q in obs.tracer().query_summaries()
                  if q["query"] == name]
    return out, sp.wall_s, summary


def _replay_spans():
    return [e for e in obs.tracer().events if e.get("name") == "replay"]


def test_attribution_on(catalog, monkeypatch):
    monkeypatch.setenv("NDSTPU_ATTRIB", "1")
    sess = Session(catalog, device="cpu")
    exe = sess.executor
    assert exe.attrib_enabled
    for name in PARTS:
        sess.sql(SQL[name])                 # discovery
        assert exe.last_attribution is None
        obs.reset(enabled=True)
        _out, wall, summary = _query(sess, name)
        a = exe.last_attribution
        assert set(a) == KEYS and a["flops"] is None
        assert a["host_prep_s"] + a["device_s"] + a["fetch_s"] <= wall
        assert a["fetched_bytes"] > 0 and a["n_programs"] == \
            len(sess.compiled_plan(SQL[name]).programs)
        assert exe.n_syncs == 1
        assert summary["attrs"]["attribution"] == a
        (span,) = _replay_spans()
        assert {k: span["args"][k] for k in ("device_s", "fetch_s")} == \
            {k: a[k] for k in ("device_s", "fetch_s")}
        exe.last_attribution = None


def test_attribution_off_keeps_the_always_on_part(catalog, monkeypatch):
    monkeypatch.delenv("NDSTPU_ATTRIB", raising=False)
    sess = Session(catalog, device="cpu")
    assert not sess.executor.attrib_enabled
    sess.sql(SQL["query3"])
    obs.reset(enabled=True)
    _out, _wall, summary = _query(sess, "query3")
    assert sess.executor.last_attribution is None
    assert "attribution" not in summary["attrs"]
    (span,) = _replay_spans()
    assert span["args"]["fetched_bytes"] == \
        obs.counters_snapshot()["engine.fetched_bytes"] > 0
    assert span["args"]["host_prep_s"] >= 0
    assert "device_s" not in span["args"]


def test_power_sidecar_carries_the_split(tmp_path, monkeypatch):
    monkeypatch.setenv("NDSTPU_ATTRIB", "1")
    stream = tmp_path / "query_0.sql"
    stream.write_text("".join(
        f"-- start query {i} in stream 0 using template {n}.tpl\n"
        f"{SQL[n].rstrip().rstrip(';')};\n"
        for i, n in enumerate(PARTS, 1)))
    args = [str(stream), "-", str(tmp_path / "t.csv"), "--generate",
            "0.002", "--device", "cpu", "--compile_records",
            str(tmp_path / "records.pkl")]
    power.main(args)            # discovers, saves the records
    power.main(args)            # preloads them: every part replays
    with open(tmp_path / "t.csv.metrics.json") as f:
        side = json.load(f)
    assert [q["query"] for q in side["queries"]] == PARTS
    for q in side["queries"]:
        a = q["attrs"]["attribution"]
        assert set(a) == KEYS
        assert a["host_prep_s"] + a["device_s"] + a["fetch_s"] <= q["wall_s"]
    assert side["counters"]["engine.fetched_bytes"] == sum(
        q["attrs"]["attribution"]["fetched_bytes"] for q in side["queries"])


def test_canonicalization_failure_is_counted_and_answers(catalog,
                                                         monkeypatch):
    want = Session(catalog, device="cpu").sql(SQL["query42"])
    sess = Session(catalog, device="cpu")

    def broken(plan, **kw):
        raise RuntimeError("analyzer gap")

    monkeypatch.setattr(canon, "canonicalize", broken)
    obs.reset(enabled=True)
    got, _wall, summary = _query(sess, "query42")
    assert_tables_match(want, got, ordered=True)
    assert obs.counters_snapshot()["engine.canon.errors"] >= 1
    assert summary["attrs"]["canon_error"] == "RuntimeError: analyzer gap"
    assert not sess.canonical_key(SQL["query42"]).startswith("c:")


def test_canonicalize_span_and_valve(catalog, monkeypatch):
    sess = Session(catalog, device="cpu")
    obs.reset(enabled=True)
    sess.sql(SQL["query3"])
    assert any(e.get("name") == "canonicalize"
               for e in obs.tracer().events)
    assert sess.canonical_key(SQL["query3"]).startswith("c:")
    monkeypatch.setenv("NDSTPU_CANON", "0")
    off = Session(catalog, device="cpu")
    obs.reset(enabled=True)
    assert_tables_match(sess.sql(SQL["query3"]), off.sql(SQL["query3"]),
                        ordered=True)
    assert not any(e.get("name") == "canonicalize"
                   for e in obs.tracer().events)
    assert not off.canonical_key(SQL["query3"]).startswith("c:")


def _counts(snapshot) -> dict:
    return {k: snapshot.get(k, 0) for k in (
        "engine.cache.device.miss", "engine.dict.lookups",
        "engine.dict.misses")}


def test_device_cache_and_dictionary_counters_equal_the_jax_engine(
        tmp_path_factory):
    """Stream 0's and stream 1's renderings of parts that bind string
    equalities (q7's gender, marital status and promotion channels; q19's
    manager; q53's categories), each run twice, through both engines
    over one warehouse."""
    cat = jax_loader.load_catalog(str(jax_warehouse(tmp_path_factory)))
    plain = {t: {n: (c.data, (c.ctype.kind, c.ctype.precision,
                              c.ctype.scale), c.valid, c.dictionary)
                 for n, c in tab.columns.items()}
             for t, tab in cat.tables.items()}
    jax_sess = jax_reference(cat)
    sess = Session(carry.catalog_from_numpy(plain), device="cpu")
    texts = [sql for sid in (0, 1) for name, sql in
             streamgen.render_power_corpus(streamgen.BENCH_RNGSEED, sid)
             if name in ("query7", "query19", "query26", "query53")]
    jax_obs.reset(enabled=True)
    obs.reset(enabled=True)
    for sql in texts:
        for _ in range(2):
            jax_sess.sql(sql)
            sess.sql(sql)
    want = jax_obs.counters_snapshot()
    got = obs.counters_snapshot()
    assert _counts(got) == _counts(want)
    assert got["engine.dict.lookups"] > 0
    assert got["engine.cache.device.hit"] > 0 and \
        want["engine.cache.device.hit"] > 0


def test_spine_trace_exec_span(catalog):
    sess = Session(catalog, device="cpu", spmd_threshold=500,
                   spmd_chunk_rows=1000)
    obs.reset(enabled=True)
    sess.sql(SQL["query3"])
    assert sess.last_spmd is not None
    spans = [e for e in obs.tracer().events
             if e.get("name") == "spine_trace_exec"]
    assert spans and spans[0]["args"].get("chunked") is True


def test_profile_attrib_on_the_cpu(capsys):
    assert profile.main(["--corpus", "--attrib", "--device", "cpu",
                         "--scale", "0.002", "--queries",
                         "query3,query96"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert [r["query"] for r in lines] == ["query3", "query96"]
    for r in lines:
        assert KEYS <= set(r) and r["card"] == "cpu"
        assert r["host_prep_s"] + r["device_s"] + r["fetch_s"] <= r["wall_s"]
        assert r["bound"] in ("dispatch-floor", "host", "compute",
                              "transfer")
        assert r["host_syncs"] == 1
    assert profile.classify(1.0, {"host_prep_s": 0.1, "device_s": 0.7,
                                  "fetch_s": 0.1,
                                  "fetched_bytes": 10}, 0.0) == "compute"
    assert profile.classify(1e-5, {"host_prep_s": 1e-6, "device_s": 5e-6,
                                   "fetch_s": 1e-6, "fetched_bytes": 10},
                            2e-5) == "dispatch-floor"
