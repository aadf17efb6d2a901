"""Differential tests: the PyTorch port against the JAX engine.

The same SF 0.002 warehouse (built as tests/test_jaxexec.py builds it) is
read by ``ndstpu`` and carried across to ``ndstpu_torch`` as plain numpy
values (``ndstpu_torch.carry``).  Every query runs through
``ndstpu_torch`` ``Session(device="cpu")`` and ``ndstpu``
``Session(backend="tpu")`` (JAX on the CPU) and the results must agree
row by row, in order where the query fixes one.  Tolerance: bit-exact for
int, decimal, date and string columns; 1e-5 relative for float columns
(``tests/test_jaxexec.py::assert_tables_match``, the nds_validate rule)."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

from ndstpu.engine import jaxexec
from ndstpu.io import loader
from ndstpu.queries import streamgen
from ndstpu_torch import carry
from ndstpu_torch.engine import columnar as tcolumnar, torchexec
from ndstpu_torch.engine.session import Session
from ndstpu_torch.ops import segsum
from ndstpu_torch.queries import STORE_QUERIES
# the JAX engine's own differential rule (row order, NULLs, float epsilon)
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import (jax_reference, jax_warehouse,
                                      shared_xla_cache)

FAMILY = ("query3", "query42", "query52", "query55")


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return jax_warehouse(tmp_path_factory)


def _plain_values(tables):
    """The JAX package's host tables as plain values (carry.py's input)."""
    return {t: {n: (c.data, (c.ctype.kind, c.ctype.precision,
                             c.ctype.scale), c.valid, c.dictionary)
                for n, c in tab.columns.items()}
            for t, tab in tables.items()}


@pytest.fixture(scope="module")
def catalogs(warehouse):
    cat = loader.load_catalog(str(warehouse))
    return cat, carry.catalog_from_numpy(_plain_values(cat.tables))


@pytest.fixture(scope="module")
def jax_sess(catalogs, tmp_path_factory):
    with shared_xla_cache(tmp_path_factory):
        yield jax_reference(catalogs[0])


@pytest.fixture(scope="module")
def torch_sess(catalogs):
    return Session(catalogs[1], device="cpu")


def _render(tpl):
    return [sql for _n, sql in streamgen.render_template_parts(
        str(streamgen.TEMPLATE_DIR / f"{tpl}.tpl"), "07291122510", 0)]


def _both(jax_sess, torch_sess, sql, ordered=False):
    want = jax_sess.sql(sql)
    got = torch_sess.sql(sql)
    assert want.column_names == got.column_names
    assert_tables_match(want, got, ordered=ordered)
    return got


@pytest.mark.parametrize("tpl", FAMILY)
def test_family_template(jax_sess, torch_sess, tpl):
    """q3/q42/q52/q55 as streamgen renders them, in the queries' order
    (each ends in ORDER BY ... LIMIT)."""
    for sql in _render(tpl):
        _both(jax_sess, torch_sess, sql, ordered=True)


# the family's spine with the dimension filters widened, so the tiny
# warehouse yields many groups on both group-by paths
_SPINES = [
    # q3 shape: brand_id domain too wide -> sort group-by path
    "select dt.d_year, item.i_brand_id brand_id, item.i_brand brand, "
    "sum(ss_ext_sales_price) sum_agg from date_dim dt, store_sales, item "
    "where dt.d_date_sk = store_sales.ss_sold_date_sk "
    "and store_sales.ss_item_sk = item.i_item_sk "
    "and item.i_manufact_id < 500 and dt.d_moy in (11, 12) "
    "group by dt.d_year, item.i_brand_id, item.i_brand "
    "order by dt.d_year, sum_agg desc, brand_id limit 100",
    # q42 shape: small (year, category) domain -> linearized ids + kernel
    "select dt.d_year, item.i_category_id, item.i_category, "
    "sum(ss_ext_sales_price) total from date_dim dt, store_sales, item "
    "where dt.d_date_sk = store_sales.ss_sold_date_sk "
    "and store_sales.ss_item_sk = item.i_item_sk "
    "and item.i_manager_id <= 50 and dt.d_moy = 12 "
    "group by dt.d_year, item.i_category_id, item.i_category "
    "order by total desc, dt.d_year, item.i_category_id, item.i_category "
    "limit 100",
]


@pytest.mark.parametrize("i", range(len(_SPINES)))
def test_family_spine_nonempty(jax_sess, torch_sess, i):
    out = _both(jax_sess, torch_sess, _SPINES[i], ordered=True)
    assert out.num_rows > 5


def test_q42_reaches_segment_sum(torch_sess, monkeypatch):
    """q42's aggregate goes to the segment-sum wrapper, which on CPU
    tensors runs its plain version (and launches nothing)."""
    calls = []
    plain = segsum.segment_sum_decimal_plain

    def counting(*args):
        calls.append(args[3])
        return plain(*args)

    monkeypatch.setattr(segsum, "segment_sum_decimal_plain", counting)
    launches = segsum.LAUNCHES
    for sql in _render("query42"):
        torch_sess.sql(sql)
    assert calls and segsum.LAUNCHES == launches


def test_q88_cross_join_nonempty(jax_sess, torch_sess):
    """q88's cross join of four aggregated 4-way joins on non-zero
    counts: the template's store name ('ese') names no generated store,
    so the analog takes the store with the most sales and widens the
    dependant count."""
    busiest = jax_sess.sql(
        "select s_store_name, count(*) c from store_sales, store "
        "where ss_store_sk = s_store_sk group by s_store_name "
        "order by c desc, s_store_name limit 1")
    name = busiest.column("s_store_name").to_pylist()[0]
    sql = STORE_QUERIES["q88"]
    assert sql.count("'ese'") == 4 and sql.count("hd_dep_count = 3") == 4
    sql = sql.replace("'ese'", f"'{name}'").replace(
        "hd_dep_count = 3", "hd_dep_count <= 5")
    out = _both(jax_sess, torch_sess, sql)
    counts = out.to_rows()
    assert len(counts) == 1 and min(counts[0]) > 0, counts


def test_filter_project(jax_sess, torch_sess):
    _both(jax_sess, torch_sess,
          "select ss_item_sk, ss_quantity * 2 as q2, ss_sales_price "
          "from store_sales where ss_quantity > 10 and ss_sales_price > 50")


def test_join_groupby_sort(jax_sess, torch_sess):
    _both(jax_sess, torch_sess,
          "select i_category, count(*) as cnt, sum(ss_ext_sales_price) as s "
          "from store_sales, item where ss_item_sk = i_item_sk "
          "group by i_category order by i_category", ordered=True)


def test_decimal_agg_exact(jax_sess, torch_sess):
    out = _both(jax_sess, torch_sess,
                "select sum(ss_net_paid) as total, avg(ss_net_paid) as a, "
                "min(ss_net_paid) as lo, max(ss_net_paid) as hi "
                "from store_sales")
    assert out.num_rows == 1


def test_limit_after_sort(jax_sess, torch_sess):
    _both(jax_sess, torch_sess,
          "select ss_item_sk, ss_net_paid from store_sales "
          "order by ss_net_paid desc, ss_item_sk limit 10", ordered=True)


_GB_QUERIES = [
    # small int key, int + decimal sums, counts
    "select ss_store_sk, count(*) as n, sum(ss_quantity) as q, "
    "sum(ss_net_paid) as p from store_sales group by ss_store_sk",
    # dictionary-coded string key + decimal avg + int min/max
    "select i_category, avg(i_current_price) as p, min(i_brand_id) as lo, "
    "max(i_brand_id) as hi from item group by i_category",
    # composite key across a join, NULL keys (2% NULL sold dates)
    "select d_year, ss_store_sk, sum(ss_ext_sales_price) as s, "
    "count(ss_item_sk) as n from store_sales, date_dim "
    "where ss_sold_date_sk = d_date_sk group by d_year, ss_store_sk",
    # huge int domain (ticket numbers): sort path under every mode
    "select ss_ticket_number, count(*) as n from store_sales "
    "group by ss_ticket_number",
]


@pytest.mark.parametrize("mode", torchexec.GROUPBY_MODES)
def test_groupby_modes(catalogs, jax_sess, mode):
    """sort / auto / kernel group-by all equal the JAX engine."""
    sess = Session(catalogs[1], device="cpu", groupby=mode)
    for sql in _GB_QUERIES + _SPINES:
        want, got = jax_sess.sql(sql), sess.sql(sql)
        assert want.column_names == got.column_names
        assert_tables_match(want, got)


def test_round_trip_every_kind(catalogs):
    """to_device -> to_host returns every column kind unchanged, with the
    same static bounds jaxexec derives at upload."""
    jcat, tcat = catalogs
    kinds = set()
    for name in ("store_sales", "item", "date_dim", "customer"):
        t = tcat.get(name)
        dt = torchexec.to_device(t, "cpu")
        back = torchexec.to_host(dt)
        jdt = jaxexec.to_device(jcat.get(name))
        for col in t.column_names:
            a, b = t.column(col), back.column(col)
            kinds.add(a.ctype.kind)
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.validity(), b.validity())
            assert a.ctype == b.ctype
            if a.dictionary is not None:
                assert list(a.dictionary) == list(b.dictionary)
            assert dt.columns[col].bounds == jdt.columns[col].bounds, col
    assert {"int32", "int64", "decimal", "date", "string"} <= kinds
    # bool and float64 do not occur in the warehouse: a table of its own
    rng = np.random.RandomState(3)
    valid = rng.rand(50) < 0.8
    t = tcolumnar.Table({
        "b": tcolumnar.Column(rng.rand(50) < 0.5, tcolumnar.BOOL, valid),
        "f": tcolumnar.Column(rng.randn(50), tcolumnar.FLOAT64, valid)})
    back = torchexec.to_host(torchexec.to_device(t, "cpu"))
    for col in ("b", "f"):
        np.testing.assert_array_equal(t.column(col).data,
                                      back.column(col).data)
        np.testing.assert_array_equal(t.column(col).valid,
                                      back.column(col).valid)


def test_unsupported_raises_with_code(torch_sess):
    """No numpy fallback: a node outside the port raises Unsupported with
    jaxexec's diagnostic code where it has one, and names the plan node
    that refused."""
    with pytest.raises(torchexec.Unsupported) as e:
        torch_sess.sql("select i_category, lag(i_item_sk) over (partition "
                       "by i_category order by i_item_sk) r from item")
    assert (e.value.code, e.value.node) == ("NDS209", "Window")
    with pytest.raises(torchexec.Unsupported) as e:
        torch_sess.sql("select i_category, stddev_samp(distinct "
                       "i_current_price) c from item group by i_category")
    assert (e.value.code, e.value.node) == ("NDS207", "Aggregate")


def test_cuda_is_the_default_device(catalogs, monkeypatch):
    """Without a card, a Session that did not ask for the CPU raises."""
    monkeypatch.setattr(torchexec.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(catalogs[1])
