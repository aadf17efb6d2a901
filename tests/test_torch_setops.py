"""Set operations, DISTINCT, distinct aggregates and the plan-subtree
memo: the port against the JAX engine.

Two seeded numpy tables are read by ``ndstpu`` and carried across to
``ndstpu_torch`` as plain values.  Each case runs one SQL statement
through ``Session(backend="tpu")`` (JAX on the CPU) and through the port's
``Session(device="cpu")``; the results must agree under
``tests/test_jaxexec.py::assert_tables_match``: int, decimal, date and
string columns exactly, floats within 1e-5 relative, in order where the
statement ends in ORDER BY.  The memo cases count the port's executions
of a node with a spy, as tests/test_torch_window.py spies on the kernel
gate."""

import numpy as np
import pytest

from ndstpu.engine import columnar as jcolumnar
from ndstpu.engine.session import Session as JaxSession
from ndstpu.io.loader import Catalog as JaxCatalog
from ndstpu.schema import DType as JaxDType
from ndstpu_torch import carry
from ndstpu_torch.engine import torchexec
from ndstpu_torch.engine.session import Session
from test_jaxexec import assert_tables_match


def _values(n: int, words, seed: int):
    """Plain values of one table of ``n`` rows: a row id ``pk``, a small
    int ``i`` (NULLs), a bigint ``j``, a string ``s`` over ``words``
    (NULLs), a decimal(7,2) ``d`` (NULLs) and a decimal(9,3) ``d3`` that
    often equals some ``d``, a wide decimal(15,2) ``w`` with repeated
    values, a float ``f`` with repeats (NULLs), a date ``dt`` (NULLs), a
    bool ``b`` and group keys ``g`` (int) and ``h`` (string)."""
    rng = np.random.default_rng(seed)
    words = np.array(sorted(words), dtype=object)
    hs = np.array(["east", "north", "south", "west"], dtype=object)
    wide = rng.integers(-10 ** 9, 10 ** 9, 30)
    return {
        "pk": (np.arange(n, dtype=np.int32), ("int32", 0, 0), None, None),
        "i": (rng.integers(0, 8, n).astype(np.int32), ("int32", 0, 0),
              rng.random(n) > 0.1, None),
        "j": (rng.integers(0, 6, n).astype(np.int64), ("int64", 0, 0),
              None, None),
        "s": (rng.integers(0, len(words), n).astype(np.int32),
              ("string", 0, 0), rng.random(n) > 0.1, words),
        "d": (rng.integers(-300, 300, n).astype(np.int64),
              ("decimal", 7, 2), rng.random(n) > 0.1, None),
        "d3": (rng.integers(-300, 300, n).astype(np.int64) * 10 +
               (rng.random(n) < 0.3) * 5, ("decimal", 9, 3), None, None),
        "w": (wide[rng.integers(0, len(wide), n)].astype(np.int64),
              ("decimal", 15, 2), rng.random(n) > 0.1, None),
        "f": (rng.integers(-12, 12, n) / 4.0, ("float64", 0, 0),
              rng.random(n) > 0.1, None),
        "dt": (rng.integers(10950, 10970, n).astype(np.int32),
               ("date", 0, 0), rng.random(n) > 0.1, None),
        "b": (rng.random(n) > 0.5, ("bool", 0, 0), None, None),
        "g": (rng.integers(0, 6, n).astype(np.int32), ("int32", 0, 0),
              None, None),
        "h": (rng.integers(0, len(hs), n).astype(np.int32),
              ("string", 0, 0), None, hs),
    }


@pytest.fixture(scope="module")
def sessions():
    # the two sides' string dictionaries differ, and overlap
    plain = {"t1": _values(240, ["ash", "birch", "cedar", "elm"], 11),
             "t2": _values(180, ["birch", "elm", "fir", "oak"], 12)}
    cat = JaxCatalog()
    for name, cols in plain.items():
        cat.register(name, jcolumnar.Table({
            n: jcolumnar.Column(data, JaxDType(kind, precision=p, scale=s),
                                valid, dictionary)
            for n, (data, (kind, p, s), valid, dictionary) in
            cols.items()}))
    return (JaxSession(cat, backend="tpu"),
            Session(carry.catalog_from_numpy(plain), device="cpu"))


def _ends_in_order(sql: str) -> bool:
    return " order by " in sql.rsplit(")", 1)[-1]


def _check(sessions, sql):
    jax_sess, torch_sess = sessions
    want = jax_sess.sql(sql)
    got = torch_sess.sql(sql)
    assert want.column_names == got.column_names
    assert got.num_rows > 0
    assert_tables_match(want, got, ordered=_ends_in_order(sql))
    return got


SETOPS = {
    # NULLs on both sides, the string columns' dictionaries differ
    "union all": "select i, s, d from t1 union all select i, s, d from t2",
    "union": "select i, s from t1 union select i, s from t2",
    "intersect": "select i, s from t1 intersect select i, s from t2",
    "except": "select i, s from t1 except select i, s from t2",
    "except, right to left": "select s, j from t2 except select s, j "
                             "from t1",
    "union, strings of two dictionaries": "select s from t1 union select "
                                          "s from t2 order by s",
    "union, decimals at two scales": "select d from t1 union select d3 "
                                     "from t2",
    "intersect, decimals at two scales": "select d from t1 intersect "
                                         "select d3 from t2",
    "union all, int and bigint": "select i from t1 union all select j "
                                 "from t2",
    "union, int and bigint": "select i, g from t1 union select j, g from "
                             "t2",
    "union under an aggregate": "select s, count(*) c, sum(d) sd from "
                                "(select s, d from t1 where g < 3 union "
                                "all select s, d from t2 where g > 2) u "
                                "group by s order by s",
    "union all of three": "select i from t1 where g = 0 union all select "
                          "j from t2 where g = 1 union all select i from "
                          "t1 where g = 2",
}


@pytest.mark.parametrize("case", list(SETOPS))
def test_set_operation(sessions, case):
    _check(sessions, SETOPS[case])


DISTINCTS = {
    "strings and floats": "select distinct s, f from t1",
    "dates and ints": "select distinct dt, i from t1",
    "bools and strings": "select distinct b, h from t1",
    "decimals, ordered": "select distinct d from t1 order by d",
    "wide decimals and NULLs": "select distinct w, s from t2",
    "over a join": "select distinct t1.s, t2.h from t1, t2 where t1.g = "
                   "t2.g and t1.i = t2.i",
}


@pytest.mark.parametrize("case", list(DISTINCTS))
def test_distinct(sessions, case):
    _check(sessions, DISTINCTS[case])


# (statement, does it take the presence bitmap)
DISTINCT_AGGS = {
    # a small-domain int: the bitmap, keyless and keyed
    "small int, keyless": ("select count(distinct i) c, sum(distinct i) "
                           "s, avg(distinct i) a from t1", True),
    "small int, keyed": ("select g, count(distinct i) c, sum(distinct i) "
                         "s, avg(distinct i) a from t1 group by g", True),
    "small decimal, keyed by string": ("select h, sum(distinct d) s, "
                                       "avg(distinct d) a, count(distinct "
                                       "d) c from t2 group by h", True),
    # a wide decimal: the sort path
    "wide decimal, keyless": ("select count(distinct w) c, sum(distinct w)"
                              " s, avg(distinct w) a from t1", False),
    "wide decimal, keyed": ("select h, count(distinct w) c, sum(distinct "
                            "w) s, avg(distinct w) a from t1 group by h",
                            False),
    # a float: the sort path, float64 sums
    "float, keyless": ("select count(distinct f) c, sum(distinct f) s, "
                       "avg(distinct f) a from t2", False),
    "float, keyed": ("select g, count(distinct f) c, sum(distinct f) s, "
                     "avg(distinct f) a from t1 group by g", False),
    # beside plain aggregates; DISTINCT is a no-op for min and max
    "beside plain aggregates": ("select g, count(distinct i) cd, count(i) "
                                "c, min(distinct d) mn, max(distinct s) mx,"
                                " sum(d) sd from t1 group by g order by g",
                                True),
    "after a filter": ("select h, count(distinct j) c from t2 where d > 0 "
                       "group by h", True),
}


@pytest.mark.parametrize("case", list(DISTINCT_AGGS))
def test_distinct_aggregate(sessions, case):
    """Each distinct aggregate agrees with the JAX engine, and takes the
    path its column's static metadata chooses."""
    sql, bitmap = DISTINCT_AGGS[case]
    exe = sessions[1].executor
    calls = []
    real = exe._agg_distinct_bitmap

    def spy(*args):
        calls.append(args[3])           # ngseg
        return real(*args)

    exe._agg_distinct_bitmap = spy
    try:
        _check(sessions, sql)
    finally:
        del exe._agg_distinct_bitmap
    assert bool(calls) == bitmap, calls


def test_distinct_column_type_is_refused_as_the_reference_refuses():
    """A column kind outside the distinct set raises Unsupported (the
    reference raises it uncoded too)."""
    ones = torchexec.torch.ones(3, dtype=torchexec.torch.bool)
    col = torchexec.DCol(torchexec.torch.zeros(3, dtype=torchexec.torch.int32),
                         ones, torchexec.DType("timestamp"))
    exe = torchexec.TorchExecutor(None, "cpu")
    with pytest.raises(torchexec.Unsupported) as got:
        exe._distinct_of(torchexec.DTable({"x": col}, ones))
    assert got.value.code is None


# -- the plan-subtree memo ---------------------------------------------------

_CTE_TWICE = ("with a as (select g, sum(d) sd, count(*) c from t1 group by g)"
              " select x.g, x.sd, y.c from a x, a y where x.g = y.g "
              "order by x.g")


def _spy_calls(exe, method):
    """Count the calls of one of ``exe``'s methods: (counter, undo)."""
    calls = [0]
    real = getattr(exe, method)

    def spy(*args):
        calls[0] += 1
        return real(*args)

    setattr(exe, method, spy)
    return calls, lambda: delattr(exe, method)


def test_memo_runs_a_twice_referenced_cte_once(sessions):
    """The CTE's Aggregate is in the plan twice and runs once."""
    plan = sessions[1].plan(_CTE_TWICE)[0]
    n_aggs = sum(type(q).__name__ == "Aggregate" for q in plan.walk())
    assert n_aggs == 2
    exe = sessions[1].executor
    calls, undo = _spy_calls(exe, "_exec_aggregate")
    try:
        _check(sessions, _CTE_TWICE)
    finally:
        undo()
    assert calls[0] == 1 and exe.n_memo_hits == 1
    # released after its last use
    assert exe._memo == {} and exe._memo_left == {}


@pytest.mark.parametrize("sql", [
    "select g, sum(d) sd from t1 group by g order by g",
    "select t1.g, count(*) c from t1, t2 where t1.i = t2.i group by t1.g",
])
def test_memo_retains_no_subtree_that_occurs_once(sessions, sql):
    """A plan whose subtrees each occur once keeps nothing in the memo at
    any point of its execution."""
    assert torchexec._memo_uses(sessions[1].plan(sql)[0]) == {}
    exe = sessions[1].executor
    held = []
    real = exe.execute

    def spy(p):
        out = real(p)
        held.append(len(exe._memo))
        return out

    exe.execute = spy
    try:
        _check(sessions, sql)
    finally:
        del exe.execute
    assert held and max(held) == 0


def test_memo_of_a_subquery_is_its_own(sessions):
    """A scalar subquery whose Aggregate is identical to a main-plan
    subtree runs it in a memo of its own: the main plan runs the CTE
    once for its two references, the subquery once more, and the answer
    agrees with the JAX engine."""
    sql = ("with a as (select g, sum(d) sd from t1 group by g) "
           "select x.g, x.sd, y.sd from a x, a y where x.g = y.g and "
           "x.sd > (select min(sd) from a) order by x.g")
    exe = sessions[1].executor
    calls, undo = _spy_calls(exe, "_exec_aggregate")
    try:
        _check(sessions, sql)
    finally:
        undo()
    # main plan: one run for two references; subquery: the CTE's
    # aggregate and its min
    assert calls[0] == 3 and exe.n_memo_hits == 1
