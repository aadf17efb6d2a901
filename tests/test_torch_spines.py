"""Cross-query spine sharing in the port against the JAX package's.

* Analysis: on every part of the power corpus (stream 0 of rngseed
  07291122510), planned on the zero-row schema catalogs, the port's
  ``canon.canonicalize_subtrees`` and ``spines.subtree_sites`` give the
  JAX package's subtrees and sites (paths, kinds, sizes, fingerprints,
  value keys, verdicts, byte estimates), and ``spines.build_index`` and
  ``index_to_doc`` over the whole corpus give its index, diagnostics and
  summary.  The committed ``MQO_AUDIT.json`` names every shared spine the
  sweep finds, and its counts are the sweep's plus those of the entries
  that neither package's sweep finds any more (the file predates the JAX
  analyzer it is compared with here: one spine of q16, q32, q92, q94 and
  q95 is now filed under another).
* ``engine.spine``: ``table_bytes`` counts a device table as the JAX
  function counts the same table on the host; ``SpineCache`` keeps its
  budget LRU-first, refuses a table larger than the budget, drops an entry
  built under another state, and hands each table that leaves to
  ``on_evict``; the budgets read ``NDSTPU_SPINE_BUDGET_BYTES`` and
  ``NDSTPU_HBM_BYTES`` as the JAX package's do, and ``memplan`` sizes
  streams as the JAX ``memplan`` does.
* A tiny in-process throughput run (streams 1 and 2 cut to parts whose
  spines recur across the two streams, ``--generate 0.002 --device
  cpu``) with the spine cache installed writes each stream's rows as the
  same run with ``NDSTPU_SPINES=0`` does, and counts the spine hits and
  misses of the JAX package's in-process run over the same warehouse and
  streams.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import json
import pathlib

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from ndstpu import analysis as jax_analysis
from ndstpu.analysis import canon as jax_canon
from ndstpu.analysis import spines as jax_spines
from ndstpu.engine import columnar as jax_columnar
from ndstpu.engine import memplan as jax_memplan
from ndstpu.engine import spine as jax_spine
from ndstpu.engine.session import Session as JaxSession
from ndstpu.harness import scheduler as jax_scheduler
from ndstpu.schema import DType as JaxDType
from ndstpu_torch import analysis, datagen
from ndstpu_torch.analysis import canon, spines
from ndstpu_torch.engine import columnar, memplan, spine
from ndstpu_torch.engine.session import Session
from ndstpu_torch.harness import power, scheduler
from ndstpu_torch.queries import corpus, streamgen
from test_torch_corpus_common import jax_catalog

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = [n for n, _ in corpus()]


def _subtrees(subs):
    return [(s.path, s.kind, s.size) + (
        None if s.canon is None else (s.canon.fingerprint,
                                      s.canon.cache_key, s.canon.values))
        for s in subs]


def _sites(sites):
    return [(s.path, s.kind, s.size, s.fingerprint, s.value_key,
             s.shareable, s.reason, s.scans, s.est_rows, s.est_row_bytes)
            for s in sites]


@pytest.fixture(scope="module")
def sweep():
    """part -> (port (subtrees, sites), JAX (subtrees, sites)), as
    ``scripts/mqo_audit.py`` sweeps the corpus (scale factor 1)."""
    tsess = Session(analysis.schema_catalog(), device="cpu")
    jsess = JaxSession(jax_analysis.schema_catalog())
    ttables, jtables = analysis.schema_tables(), jax_analysis.schema_tables()
    out = {}
    for name, sql in corpus():
        plan = tsess.plan(sql)[0]
        subs = canon.canonicalize_subtrees(plan, ttables, name)
        port = (subs, spines.subtree_sites(plan, ttables, query=name,
                                           scale_factor=1.0, subtrees=subs))
        jplan = jsess.plan(sql)[0]
        jsubs = jax_canon.canonicalize_subtrees(jplan, jtables, name)
        ref = (jsubs, jax_spines.subtree_sites(
            jplan, jtables, query=name, scale_factor=1.0, subtrees=jsubs))
        out[name] = (port, ref)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_subtrees_and_sites_are_the_references(sweep, name):
    (subs, sites), (jsubs, jsites) = sweep[name]
    assert _subtrees(subs) == _subtrees(jsubs)
    assert _sites(sites) == _sites(jsites)
    assert _sites(spines.eligible_sites(sites)) == \
        _sites(jax_spines.eligible_sites(jsites))


def test_index_is_the_references_and_the_audit(sweep):
    index, diags = spines.build_index({n: p[1] for n, (p, _r) in
                                       sweep.items()})
    jindex, jdiags = jax_spines.build_index({n: r[1] for n, (_p, r) in
                                             sweep.items()})
    assert index == jindex
    assert [d.as_dict() for d in diags] == [d.as_dict() for d in jdiags]
    doc = spines.index_to_doc(index)
    assert doc == jax_spines.index_to_doc(jindex)
    assert doc["summary"]["shared_spine_candidates"] > 100
    audit = json.loads((ROOT / "MQO_AUDIT.json").read_text())
    ours = {s["fingerprint"]: s for s in doc["shared_spines"]}
    theirs = {s["fingerprint"]: s for s in audit["shared_spines"]}
    assert set(ours) <= set(theirs)
    gone = [theirs[fp] for fp in set(theirs) - set(ours)]
    want = dict(doc["summary"], subtrees_indexed=doc["subtrees_indexed"],
                budget_bytes=doc["budget_bytes"])
    for s in gone:
        want["shared"] += 1
        want["shared_spine_candidates"] += s["shareable"]
        want["param_divergent"] += s["shareable"] and s["n_value_sets"] > 1
        want["order_sensitive"] += not s["shareable"]
        want["over_budget"] += s["over_budget"]
        want["subtrees_indexed"] += 1
    assert want == {k: audit["meta"][k] for k in want}


# -- the runtime cache ---------------------------------------------------------


def _tables(seed: int, n: int):
    """(port table on the CPU, the same table for the JAX package)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1000, n, dtype=np.int64)
    valid = rng.random(n) > 0.1
    codes = rng.integers(0, 3, n).astype(np.int32)
    words = np.array(["a", "bcd", "éf"], dtype=object)
    port = columnar.Table({
        "x": columnar.Column(torch.as_tensor(data), columnar.INT64,
                             torch.as_tensor(valid)),
        "s": columnar.Column(torch.as_tensor(codes), columnar.STRING,
                             None, words)})
    ref = jax_columnar.Table({
        "x": jax_columnar.Column(data, JaxDType("int64"), valid),
        "s": jax_columnar.Column(codes, JaxDType("string"), None, words)})
    return port, ref


def test_table_bytes_is_the_references():
    for seed, n in ((0, 1), (1, 100), (2, 4097)):
        port, ref = _tables(seed, n)
        assert spine.table_bytes(port) == jax_spine.table_bytes(ref)


def test_spine_cache_budget_lru_state_and_evictions():
    tables = [_tables(i, 100)[0] for i in range(4)]
    size = spine.table_bytes(tables[0])
    gone = []
    cache = spine.SpineCache(2 * size + 1, flagged={"a", "b", "c"},
                             on_evict=gone.append)
    assert cache.eligible("a") and not cache.eligible("d")
    assert cache.put("a", 1, tables[0]) and cache.put("b", 1, tables[1])
    assert cache.get("a", 1) is tables[0]          # "b" is now LRU
    assert cache.put("c", 1, tables[2])
    assert (len(cache), cache.evictions, gone) == (2, 1, [tables[1]])
    assert cache.get("b", 1) is None
    assert cache.total_bytes == 2 * size
    # an entry built under another state is dropped, not served
    assert cache.get("a", 2) is None
    assert gone == [tables[1], tables[0]] and len(cache) == 1
    # a table larger than the whole budget is refused, nothing evicted
    big = spine.SpineCache(size - 1, on_evict=gone.append)
    assert not big.put("a", 1, tables[3]) and len(big) == 0
    cache.clear()
    assert (len(cache), cache.total_bytes, gone[-1]) == (0, 0, tables[2])


def test_budgets_are_the_references(monkeypatch):
    for env in ({}, {"NDSTPU_HBM_BYTES": "123456789"},
                {"NDSTPU_SPINE_BUDGET_BYTES": "4242"}):
        for k in ("NDSTPU_HBM_BYTES", "NDSTPU_SPINE_BUDGET_BYTES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert memplan.device_budget_bytes("cpu") == \
            jax_memplan.device_budget_bytes(jax_cpu_device())
        assert spine.runtime_budget_bytes("cpu")[0] == \
            jax_spine.runtime_budget_bytes()[0]
        assert spines.spine_budget_bytes() == \
            jax_spines.spine_budget_bytes()
    for args in ((10 ** 6, 40, 1), (10 ** 9, 120, 4), (5000, 8, 2)):
        for budget in (None, 1 << 20, 1 << 33):
            assert dataclasses.astuple(
                memplan.plan_stream(*args, budget_bytes=budget)) == \
                dataclasses.astuple(
                    jax_memplan.plan_stream(*args, budget_bytes=budget))


def jax_cpu_device():
    import jax
    return jax.devices("cpu")[0]


# -- a tiny in-process throughput run --------------------------------------------

# parts whose spines recur between streams 1 and 2 of the bench rngseed
PARTS = ["query15", "query21"]


def _write_streams(root):
    full = root / "full"
    streamgen.generate_query_streams(None, streamgen.BENCH_RNGSEED,
                                     str(full), 3)
    d = root / "streams"
    d.mkdir()
    for sid in ("1", "2"):
        parts = power.gen_sql_from_stream(str(full / f"query_{sid}.sql"))
        (d / f"query_{sid}.sql").write_text("".join(
            f"-- start query {i} in stream {sid} using template {n}.tpl\n"
            f"{parts[n].strip()}\n" for i, n in enumerate(PARTS, 1)))
    return d


def _rows(folder: pathlib.Path):
    """query -> its output's rows, in order."""
    out = {}
    for q in sorted(p.name for p in folder.iterdir()):
        t = pq.read_table(str(folder / q))
        out[q] = list(zip(*(t.column(c).to_pylist()
                            for c in t.column_names)))
    return out


@pytest.fixture(scope="module")
def throughput(tmp_path_factory):
    root = tmp_path_factory.mktemp("spines")
    streams = _write_streams(root)
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        for side, on in (("on", "1"), ("off", "0")):
            mp.setenv("NDSTPU_SPINES", on)
            runs[side] = scheduler.run_streams_inproc(
                ["1", "2"],
                ["python", "-m", "ndstpu_torch.harness.power",
                 str(streams / "query_{}.sql"), "-",
                 str(root / side / "time_{}.csv"), "--generate", "0.002",
                 "--device", "cpu",
                 "--output_prefix", str(root / side / "out_{}")],
                concurrent=2)
        mp.setenv("NDSTPU_SPINES", "1")
        # the JAX engine's run over the port's warehouse (its first run of
        # a key returns its discovery's rows; the warm-up replay is off)
        mp.setenv("NDSTPU_WARM_REPLAY", "0")
        cat = jax_catalog(datagen.generate(0.002, 1, "cpu"))
        mp.setattr(jax_scheduler.loader, "load_catalog",
                   lambda *_a, **_k: cat)
        runs["jax"] = jax_scheduler.run_streams_inproc(
            ["1", "2"],
            ["python", "-m", "ndstpu.harness.power",
             str(streams / "query_{}.sql"), str(root / "unused"),
             str(root / "jax" / "time_{}.csv"), "--engine", "tpu"],
            concurrent=2)
    finally:
        mp.undo()
    return root, runs


def test_throughput_with_spines_answers_as_without(throughput):
    root, runs = throughput
    assert all(runs[s].rc == 0 for s in runs)
    cache = runs["on"].session.spine_cache
    assert cache is not None and runs["off"].session.spine_cache is None
    assert cache.hits > 0
    for sid in ("1", "2"):
        on, off = _rows(root / "on" / f"out_{sid}"), \
            _rows(root / "off" / f"out_{sid}")
        assert list(on) == list(off) and len(on) == len(PARTS)
        assert on == off


def test_throughput_spine_counts_are_the_references(throughput):
    _root, runs = throughput
    got, want = runs["on"].session.spine_cache, \
        runs["jax"].session.spine_cache
    assert want is not None
    assert (got.hits, got.misses, len(got.flagged)) == \
        (want.hits, want.misses, len(want.flagged))
    assert got.flagged == want.flagged
