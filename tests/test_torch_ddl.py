"""The port's session statements beyond queries, against the JAX
session's on the CPU.

CREATE [OR REPLACE] [TEMP] VIEW, CREATE TABLE AS, INSERT INTO, DELETE
FROM and DROP VIEW/TABLE through ``Session(device="cpu").sql`` and
``Session(backend="tpu").sql`` over forks of one warehouse
(``test_torch_dm_common``); tables and query results held together under
``tests/test_jaxexec.py::assert_tables_match`` (decimals, ints, dates and
strings exact, floats within 1e-5 relative).  Then the compiled path
around them: the views epoch in the executor's keys, a replayed query
rediscovering after an INSERT into its table, and compile records
written under the keys of before the prefix preloading."""

import pytest

from ndstpu.engine.planner import PlanError as JaxPlanError
from ndstpu_torch.engine.planner import PlanError
from ndstpu_torch.engine.session import Session
from ndstpu_torch.engine.sql import normalize_sql_key, parse_statement
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import jax_catalog
from test_torch_dm_common import fork, sessions, warehouse


@pytest.fixture(scope="module")
def cat():
    return warehouse(refresh=False)


@pytest.fixture(scope="module")
def jcat(cat):
    return jax_catalog(cat)


@pytest.fixture
def both(cat, jcat):
    return sessions(cat, jcat)


def _same(jsess, sess, sql, ordered=False):
    want, got = jsess.sql(sql), sess.sql(sql)
    assert want.column_names == got.column_names
    assert_tables_match(want, got, ordered=ordered)
    return got


def _same_table(jsess, sess, name):
    want, got = jsess.catalog.get(name), sess.catalog.get(name)
    assert want.column_names == got.column_names
    assert [c.ctype.kind for c in want.columns.values()] == \
        [c.ctype.kind for c in got.columns.values()]
    assert_tables_match(want, got)


def _both(jsess, sess, sql):
    assert jsess.sql(sql) is None
    assert sess.sql(sql) is None


_VIEW_SQL = "select i_category, count(*) n from v group by i_category"


def test_view_and_redefined_view(both):
    jsess, sess = both
    _both(jsess, sess, "create temp view v as select i_item_sk, i_category "
                       "from item where i_current_price > 50")
    first = _same(jsess, sess, _VIEW_SQL)
    epoch = sess._views_epoch
    d0 = sess.executor.n_discoveries
    sess.sql(_VIEW_SQL)
    assert sess.executor.n_discoveries == d0      # replayed
    _both(jsess, sess, "create or replace temp view v as select i_item_sk, "
                       "i_category from item where i_current_price <= 50")
    assert sess._views_epoch == epoch + 1
    second = _same(jsess, sess, _VIEW_SQL)
    # a redefined view plans and discovers anew, never replaying the
    # old view's plan
    assert sess.executor.n_discoveries == d0 + 1
    assert sorted(first.to_rows()) != sorted(second.to_rows())
    assert sess.compiled_plan(_VIEW_SQL).key.startswith(f"{epoch + 1}|")


def test_ctas(both):
    jsess, sess = both
    sql = ("create table big_items as select i_item_sk, i_item_id, "
           "i_current_price * 2 dbl from item where i_current_price > 80")
    _both(jsess, sess, sql)
    _same_table(jsess, sess, "big_items")
    _same(jsess, sess, "select count(*) c, sum(dbl) s from big_items")


def test_insert_out_of_precision_becomes_null(both):
    jsess, sess = both
    _both(jsess, sess, "create table t_dec as select ss_item_sk, "
                       "ss_sales_price from store_sales "
                       "where ss_quantity = 1")
    n0 = sess.catalog.get("t_dec").num_rows
    # decimal(7,2) target: sales prices of 100.00 and up times 1,000
    # overflow its precision and become NULL (Spark's non-ANSI cast)
    _both(jsess, sess, "insert into t_dec select ss_item_sk, "
                       "ss_sales_price * 1000 from store_sales "
                       "where ss_quantity = 2")
    _same_table(jsess, sess, "t_dec")
    col = sess.catalog.get("t_dec").column("ss_sales_price")
    assert col.ctype.precision == 7 and col.valid is not None
    inserted = col.valid[n0:]
    assert 0 < int((~inserted).sum()) < len(inserted)


def test_insert_into_fact_table(both):
    jsess, sess = both
    _both(jsess, sess, "insert into store_returns select * from "
                       "store_returns where sr_return_quantity > 40")
    _same_table(jsess, sess, "store_returns")


def test_insert_arity_mismatch(both):
    jsess, sess = both
    for s in (jsess, sess):
        with pytest.raises(ValueError, match="values for"):
            s.sql("insert into reason select r_reason_sk from reason")


@pytest.mark.parametrize("where", [
    # a scalar subquery on each side; NULL sold dates stay
    "ss_sold_date_sk >= (select min(d_date_sk) from date_dim "
    "where d_year = 2001) and ss_sold_date_sk <= (select max(d_date_sk) "
    "from date_dim where d_year = 2001)",
    # an IN subquery; NULL customers stay
    "ss_customer_sk in (select c_customer_sk from customer "
    "where c_birth_year < 1950)",
    # a plain predicate over a nullable column
    "ss_promo_sk > 10",
], ids=["scalar", "in", "plain"])
def test_delete_keeps_null_rows(both, where):
    jsess, sess = both
    before = sess.catalog.get("store_sales").num_rows
    _both(jsess, sess, f"delete from store_sales where {where}")
    _same_table(jsess, sess, "store_sales")
    t = sess.catalog.get("store_sales")
    assert 0 < t.num_rows < before
    hit = sess.sql(f"select count(*) c from store_sales where {where}")
    assert hit.to_rows() == [(0,)]
    # the predicate's column is NULL on rows that stay
    nulls = sess.sql(f"select count(*) c from store_sales "
                     f"where {where.split()[0]} is null").to_rows()[0][0]
    assert nulls > 0


def test_delete_without_where(both):
    jsess, sess = both
    v0 = sess.catalog.versions["reason"]
    _both(jsess, sess, "delete from reason")
    _same_table(jsess, sess, "reason")
    assert sess.catalog.get("reason").num_rows == 0
    assert sess.catalog.versions["reason"] == v0 + 1
    _same(jsess, sess, "select count(*) c from reason")


def test_drop_view_and_table(both):
    jsess, sess = both
    _both(jsess, sess, "create view dv as select r_reason_sk from reason")
    _both(jsess, sess, "create table dt as select r_reason_sk from reason")
    _both(jsess, sess, "drop view dv")
    _both(jsess, sess, "drop table dt")
    assert "dt" not in sess.catalog and "dv" not in sess.views
    for s, err in ((jsess, JaxPlanError), (sess, PlanError)):
        for name in ("dv", "dt"):
            with pytest.raises(err):
                s.sql(f"select count(*) from {name}")


def test_sql_script(both):
    jsess, sess = both
    script = ("create temp view sv as select r_reason_sk k from reason; "
              "create table st as select k from sv where k > 3; "
              "insert into st select k from sv where k <= 3; "
              "select count(*) c, sum(k) s from st")
    want, got = jsess.sql_script(script), sess.sql_script(script)
    assert got[:3] == [None, None, None] and want[:3] == [None, None, None]
    assert_tables_match(want[3], got[3])
    _same_table(jsess, sess, "st")


_REPLAY_SQL = ("select i_category, count(*) n, sum(ss_net_paid) s "
               "from store_sales join item on ss_item_sk = i_item_sk "
               "where ss_quantity > 20 group by i_category")


def test_replayed_query_rediscovers_after_insert(both):
    jsess, sess = both
    exe = sess.executor
    sess.sql(_REPLAY_SQL)
    d0, r0 = exe.n_discoveries, exe.n_replays
    sess.sql(_REPLAY_SQL)
    assert (exe.n_discoveries, exe.n_replays) == (d0, r0 + 1)
    epoch = sess.snapshot_epoch()
    _both(jsess, sess, "insert into store_sales select * from store_sales "
                       "where ss_quantity > 90")
    assert sess.snapshot_epoch() != epoch
    got = _same(jsess, sess, _REPLAY_SQL)
    assert exe.n_discoveries == d0 + 1
    assert got.num_rows > 0
    sess.sql(_REPLAY_SQL)
    assert exe.n_replays == r0 + 2


def test_records_without_the_epoch_prefix_preload(cat, tmp_path):
    """Compile records written before the executor's keys carried the
    views epoch (a key then was the bare canonical key) preload and
    replay with no discovery."""
    old = Session(fork(cat), device="cpu")
    norm = normalize_sql_key(_REPLAY_SQL)
    plan, _disp, canon = old._plan_cached(parse_statement(_REPLAY_SQL), norm)
    old.executor.execute_cached(canon.exec_plan, canon.cache_key,
                                params=canon.binding, sql=norm)
    path = str(tmp_path / "records.pkl")
    assert old.save_compiled(path) == 1
    new = Session(fork(cat), device="cpu")
    assert new.preload_compiled(path) == 1
    want = old.executor.execute_to_host(plan)
    got = new.sql(_REPLAY_SQL)
    assert new.executor.n_discoveries == 0
    assert new.executor.n_replays == 1
    assert_tables_match(want, got)
