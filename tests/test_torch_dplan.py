"""The port's out-of-core executor against the JAX package's: the same
seeded catalog through ``Session(backend="tpu", spmd_threshold=500,
spmd_chunk_rows=1000)`` (``tests/test_parallel.py:595-625``) and through
the port's ``Session(spmd_threshold=500, spmd_chunk_rows=1000)``.

Each query's rows must agree (ints, decimals, dates and strings exactly,
floats within 1e-5 relative; in order where the plan fixes it), chunking
must engage, and both packages must record the same NDS3xx attempt codes
and the same fall-through counters.  The queries are
``tests/test_stream.py``'s ``Q_AGG`` and ``Q_ROWS``, one corpus part for
each executor path the corpus reaches at this scale (broadcast joins,
union-aggregate, subquery offload, grouping sets), and, for the paths no
corpus part takes here, a shuffle join (a build side over the broadcast
limit), a window and a device tail, plus a plan that falls through in
both packages.  The splitmix64 hash that places rows must be
bit-identical."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import os

import numpy as np
import pytest
import torch

from ndstpu import obs as jax_obs
from ndstpu.engine.session import Session as JaxSession
from ndstpu.parallel import dplan as jax_dplan, exchange as jax_exchange
from ndstpu.parallel import mesh as jax_mesh
from ndstpu_torch import datagen, obs
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from ndstpu_torch.io.catalog import Catalog
from ndstpu_torch.parallel import dplan, exchange, mesh as pmesh
from ndstpu_torch.queries import corpus
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import jax_catalog

SQL = dict(corpus())
TABLES = ["store_sales", "store_returns", "catalog_sales", "web_sales",
          "date_dim", "item", "reason", "store", "time_dim"]
Q_AGG = ("select d_year, i_brand_id, sum(ss_ext_sales_price) as s, "
         "count(*) as n from store_sales, date_dim, item "
         "where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk "
         "group by d_year, i_brand_id")
Q_ROWS = ("select ss_item_sk, ss_quantity from store_sales "
          "where ss_quantity > 90")
Q_WINDOW = ("select ss_item_sk, ss_ticket_number, rank() over (partition "
            "by ss_store_sk order by ss_net_paid) as r from store_sales "
            "where ss_quantity > 95")
Q_TAIL = ("select ss_item_sk, ss_ticket_number, ss_net_paid from "
          "store_sales where ss_quantity > 50 order by ss_net_paid desc, "
          "ss_item_sk limit 25")
Q_SHUFFLE = ("select sr_reason_sk, count(*) as n, sum(ss_net_paid) as p "
             "from store_sales, store_returns "
             "where ss_ticket_number = sr_ticket_number "
             "and ss_item_sk = sr_item_sk group by sr_reason_sk")
Q_FALLS = ("select count(*) as n from store_sales full outer join "
           "store_returns on ss_ticket_number = sr_ticket_number "
           "and ss_item_sk = sr_item_sk")
CASES = {
    "agg": (Q_AGG, "aggregate"),
    "rows": (Q_ROWS, "row spine"),
    "query3": (SQL["query3"], "broadcast join"),
    "query71": (SQL["query71"], "union-aggregate"),
    "query9": (SQL["query9"], "subquery offload"),
    "query86": (SQL["query86"], "grouping sets"),
    "window": (Q_WINDOW, "window"),
    "tail": (Q_TAIL, "row spine with device tail"),
}


@pytest.fixture(scope="module")
def sessions():
    cat = datagen.generate(0.01, seed=1, device="cpu", tables=TABLES)
    jc = jax_catalog(cat)
    js = JaxSession(jc, backend="tpu", spmd_threshold=500,
                    spmd_chunk_rows=1000)
    js._jax_executor().warm_replay = False
    ts = Session(cat, device="cpu", spmd_threshold=500, spmd_chunk_rows=1000)
    return cat, jc, js, ts


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("NDSTPU_SPMD_STRICT", "1")
    obs.reset(enabled=True)
    jax_obs.reset(enabled=True)
    yield
    obs.reset()
    jax_obs.reset()


def _fallbacks(delta: dict) -> dict:
    return {k: v for k, v in delta.items()
            if k.startswith("engine.spmd.fallback.")
            or k in ("engine.spmd.unsupported_fallbacks",
                     "engine.spmd.error_fallbacks")}


def _run_both(sessions, sql):
    cat, _jc, js, ts = sessions
    jb, tb = jax_obs.counters_snapshot(), obs.counters_snapshot()
    want = js.sql(sql)
    got = ts.sql(sql)
    jd, td = jax_obs.counter_delta(jb), obs.counter_delta(tb)
    assert want.column_names == got.column_names
    assert_tables_match(want, got, ordered=fixes_order(ts.plan(sql)[0]))
    return want, got, jd, td


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_session_matches_jax(sessions, case):
    sql, path = CASES[case]
    _cat, _jc, js, ts = sessions
    _want, _got, jd, td = _run_both(sessions, sql)
    assert _fallbacks(jd) == _fallbacks(td) == {}
    exe = ts.last_spmd
    assert exe is not None and path in exe.paths, exe and exe.paths
    jexe = [ent[1] for ent in js._spmd_cache.values()][-1]
    if case == "window":
        # a window needs every row of a partition in one launch: both
        # executors run its spine resident
        assert [why for *_, why in exe.streams] == ["window"]
        assert not jexe._chunk_info[0]
    else:
        # chunking engaged on some spine of the plan
        assert any(why is None and launches >= 2
                   for *_, launches, why in exe.streams), exe.streams
    assert sorted(jexe.attempt_codes) == sorted(exe.attempt_codes)
    # the cached executors run again, with the same answer
    _run_both(sessions, sql)


def test_row_spine_keeps_the_jax_row_order(sessions):
    want, got, _jd, _td = _run_both(sessions, Q_ROWS)
    assert [tuple(r) for r in want.to_rows()] == [
        tuple(r) for r in got.to_rows()]


def test_fall_through_counters_match(sessions):
    _want, _got, jd, td = _run_both(sessions, Q_FALLS)
    assert _fallbacks(td) == _fallbacks(jd)
    assert td.get("engine.spmd.unsupported_fallbacks") == 1
    assert [k for k in td if k.startswith("engine.spmd.fallback.")]


def test_shuffle_join_matches_jax(sessions):
    """A build side over the broadcast limit takes the shuffle path in
    both executors, with the same rows."""
    cat, jc, _js, ts = sessions
    plan, _ = ts.plan(Q_SHUFFLE)
    exe = dplan.DistributedPlanExecutor(
        cat, pmesh.make_mesh(1), shard_threshold_rows=500,
        broadcast_limit_rows=50, chunk_rows=1000, device="cpu",
        cost_advisor=None)
    got = exe.execute_plan(plan)
    from ndstpu.engine.session import Session as JS
    jplan, _ = JS(jc, backend="cpu").plan(Q_SHUFFLE)
    jexe = jax_dplan.DistributedPlanExecutor(
        jc, jax_mesh.make_mesh(1), shard_threshold_rows=500,
        broadcast_limit_rows=50, chunk_rows=1000, cost_advisor=None)
    want = jexe.execute_plan(jplan)
    assert "shuffle join" in exe.paths
    assert exe._chunk_info[0] and jexe._chunk_info[0]
    assert_tables_match(want, got)
    assert exe.attempt_codes == jexe.attempt_codes


def test_mix64_bit_identical_to_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(20261018)
    x = rng.integers(0, 2 ** 64 - 1, 4096, dtype=np.uint64,
                     endpoint=True)
    x[:4] = [0, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1]
    assert (x >= np.uint64(2 ** 63)).sum() > 1000
    assert np.array_equal(exchange.mix64_np(x), jax_exchange.mix64_np(x))
    # and to the device hash the JAX package's probe shuffle computes
    assert np.array_equal(exchange.mix64_np(x),
                          np.asarray(jax_exchange._mix64(jnp.asarray(x))))
    # the signed keys a build side holds hash as their uint64 bits
    k = x.view(np.int64)
    assert np.array_equal(exchange.mix64_np(k), jax_exchange.mix64_np(k))


def test_world_size_one_only(sessions):
    cat, _jc, _js, _ts = sessions
    assert pmesh.make_mesh(1).n_dev == 1
    with pytest.raises(ValueError):
        pmesh.make_mesh(2)

    class TwoRanks:
        n_dev = 2
    with pytest.raises(exchange.DistUnsupported) as e:
        dplan.DistributedPlanExecutor(cat, TwoRanks(), device="cpu")
    assert e.value.code == "NDS301"


def test_strict_mode_raises_a_defect(sessions, monkeypatch):
    """A defect in the chunked executor is never silent: strict raises
    it; otherwise it is counted, warned, and the query falls back."""
    cat, _jc, _js, _ts = sessions

    def broken(self, *a, **k):
        raise RuntimeError("injected defect")

    monkeypatch.setattr(dplan.DistributedPlanExecutor, "_run_spine",
                        broken)
    sess = Session(cat, device="cpu", spmd_threshold=500,
                   spmd_chunk_rows=1000)
    with pytest.raises(RuntimeError, match="injected defect"):
        sess.sql(Q_AGG)
    monkeypatch.delenv("NDSTPU_SPMD_STRICT")
    sess = Session(cat, device="cpu", spmd_threshold=500,
                   spmd_chunk_rows=1000)
    before = obs.counters_snapshot()
    with pytest.warns(UserWarning, match="injected defect"):
        out = sess.sql(Q_AGG)
    assert out.num_rows > 0 and sess._spmd_errors
    assert obs.counter_delta(before).get("engine.spmd.error_fallbacks") == 1
    assert os.environ.get("NDSTPU_SPMD_STRICT") is None


RAGGED = {
    "inner": ("select i_category, count(*) as n, sum(cs_quantity) as q "
              "from store_sales, catalog_sales, item "
              "where ss_item_sk = cs_item_sk and ss_item_sk = i_item_sk "
              "and ss_quantity > 90 group by i_category"),
    "left": ("select ss_item_sk, count(sr_ticket_number) as n from "
             "store_sales left join store_returns on ss_item_sk = "
             "sr_item_sk where ss_quantity > 95 group by ss_item_sk"),
    "semi": ("select count(*) as n from store_sales where ss_quantity > 80 "
             "and exists (select 1 from catalog_sales where cs_item_sk = "
             "ss_item_sk and cs_quantity > ss_quantity)"),
}


class HostFacts(Catalog):
    """The catalog an out-of-core session on a card sees: the fact
    tables held in host memory, off the executor's device (the
    dimensions on it)."""

    def on_host(self, name, device):
        return name in datagen.FACTS


@pytest.mark.parametrize("limit", [8_000_000, 50], ids=["broadcast",
                                                        "shuffle"])
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_joins_by_whole_key_runs(sessions, case, limit):
    """Where the JAX package's executor refuses a join for its key runs
    (longer than its 8-copy tiling or 32-deep residual probe, a left
    join's duplicates, an expansion on a shuffle build side) it raises
    in the port too over a resident catalog.  Over one whose facts are
    held in host memory, off the executor's device (out of core, where
    the resident path could not hold them), it joins by whole runs, and
    the answer equals the resident one."""
    from ndstpu_torch.engine.torchexec import results_differ
    cat, _jc, _js, ts = sessions
    sql = RAGGED[case]
    plan, _ = ts.plan(sql)
    host = HostFacts()
    for name in cat.tables:
        host.register(name, cat.get(name))

    def run(catalog):
        return dplan.DistributedPlanExecutor(
            catalog, pmesh.make_mesh(1), shard_threshold_rows=500,
            broadcast_limit_rows=limit, chunk_rows=1000, device="cpu",
            cost_advisor=None)

    strict = run(cat)
    with pytest.raises(dplan.DistUnsupported):
        strict.execute_plan(plan)
    exe = run(host)
    got = exe.execute_plan(plan)
    assert any(j.ragged for j in exe.joins.values()) or exe.build_reduced
    assert exe._chunk_info[0]
    assert results_differ(ts.executor.execute_to_host(plan), got) is None
