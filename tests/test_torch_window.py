"""Window functions and grouping sets: the port against the JAX engine.

One seeded numpy table is read by ``ndstpu`` and carried across to
``ndstpu_torch`` as plain values.  Each case runs one SQL statement
through ``Session(backend="tpu")`` (JAX on the CPU) and through the port's
``Session(device="cpu")``; the results must agree under
``tests/test_jaxexec.py::assert_tables_match``: int, decimal, date and
string columns exactly, floats within 1e-5 relative, in order where the
statement ends in ORDER BY."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

from ndstpu.engine import columnar as jcolumnar, jaxexec
from ndstpu.engine.session import Session as JaxSession
from ndstpu.io.loader import Catalog as JaxCatalog
from ndstpu.schema import DType as JaxDType
from ndstpu_torch import carry
from ndstpu_torch.engine import torchexec
from ndstpu_torch.engine.session import Session
from test_jaxexec import assert_tables_match

N = 240


def _values(seed: int = 5):
    """Plain values of table ``t``: partition keys ``g`` (int, NULLs) and
    ``h`` (string), order keys ``k1`` (int, NULLs) and ``k2`` (few
    values, so rows tie on both), a decimal ``d`` (NULLs), a float ``f``,
    a string ``s`` and a row id ``pk``."""
    rng = np.random.default_rng(seed)
    words = np.array(sorted(["ash", "birch", "cedar", "elm", "fir", "oak",
                             "pine"]), dtype=object)
    hs = np.array(["east", "north", "south", "west"], dtype=object)
    return {
        "pk": (np.arange(N, dtype=np.int32), ("int32", 0, 0), None, None),
        "g": (rng.integers(0, 6, N).astype(np.int32), ("int32", 0, 0),
              rng.random(N) > 0.1, None),
        "h": (rng.integers(0, len(hs), N).astype(np.int32),
              ("string", 0, 0), None, hs),
        "k1": (rng.integers(0, 5, N).astype(np.int32), ("int32", 0, 0),
               rng.random(N) > 0.15, None),
        "k2": (rng.integers(0, 3, N).astype(np.int64), ("int64", 0, 0),
               None, None),
        "d": (rng.integers(-50000, 90000, N).astype(np.int64),
              ("decimal", 7, 2), rng.random(N) > 0.1, None),
        "f": (rng.standard_normal(N) * 100.0, ("float64", 0, 0), None,
              None),
        "s": (rng.integers(0, len(words), N).astype(np.int32),
              ("string", 0, 0), rng.random(N) > 0.1, words),
    }


@pytest.fixture(scope="module")
def sessions():
    plain = {"t": _values()}
    cat = JaxCatalog()
    cat.register("t", jcolumnar.Table({
        n: jcolumnar.Column(data, JaxDType(kind, precision=p, scale=s),
                            valid, dictionary)
        for n, (data, (kind, p, s), valid, dictionary) in
        plain["t"].items()}))
    return (JaxSession(cat, backend="tpu"),
            Session(carry.catalog_from_numpy(plain), device="cpu"))


CASES = {
    # ranks, with ties on both order keys; NULLs first (asc), last (desc)
    "row_number": "select pk, g, row_number() over (partition by g order by "
                  "k1, k2) rn from t",
    "rank desc": "select pk, g, rank() over (partition by g order by k1 "
                 "desc, k2) rk from t",
    "dense_rank": "select pk, h, dense_rank() over (partition by h order by "
                  "k1, k2 desc) dr from t",
    "rank, no partition": "select pk, rank() over (order by k2, k1) rk "
                          "from t",
    # whole-partition aggregates
    "partition sum and avg": "select pk, sum(d) over (partition by g) sd, "
                             "avg(d) over (partition by g) ad, sum(f) over "
                             "(partition by h) sf, avg(f) over (partition "
                             "by h) af from t",
    "partition count, min, max": "select pk, count(*) over (partition by "
                                 "g) c, count(d) over (partition by h) cd, "
                                 "min(s) over (partition by g) mn, max(s) "
                                 "over (partition by g, h) mx from t",
    # running frames: peers share the run value under RANGE (the default
    # frame; the grammar spells out only ROWS), not under ROWS
    "running sum, range": "select pk, sum(d) over (partition by g order by "
                          "k1) rs, count(*) over (partition by g order by "
                          "k1, k2) rc from t",
    "running sum, rows": "select pk, sum(d) over (partition by g order by "
                         "k1, pk rows between unbounded preceding and "
                         "current row) rs, avg(f) over (partition by h "
                         "order by k2 rows between unbounded preceding and "
                         "current row) ra from t",
    "running max, one-row partitions": "select pk, max(d) over (partition "
                                       "by pk order by k1) mx, min(s) over "
                                       "(partition by pk order by k2) mn "
                                       "from t",
    "running min and max": "select pk, min(k1) over (partition by h order "
                           "by k2) mn, max(f) over (partition by g order "
                           "by k1) mx from t",
    # grouping sets
    "rollup with grouping()": "select g, h, sum(d) sd, count(*) c, "
                              "grouping(g) + grouping(h) lvl from t group "
                              "by rollup(g, h) order by lvl, g, h",
    "grouping sets, stddev": "select g, h, stddev_samp(f) sf, avg(d) ad "
                             "from t group by grouping sets ((g, h), (h), "
                             "()) order by g, h",
    "rollup under a rank": "select h, g, sum(d) sd, rank() over (partition "
                           "by grouping(h) + grouping(g) order by sum(d) "
                           "desc) rk from t group by rollup(h, g) order by "
                           "h, g",
}


def _ends_in_order(sql: str) -> bool:
    return " order by " in sql.rsplit(")", 1)[-1]


@pytest.mark.parametrize("case", list(CASES))
def test_window_and_grouping_sets(sessions, case):
    jax_sess, torch_sess = sessions
    sql = CASES[case]
    want = jax_sess.sql(sql)
    got = torch_sess.sql(sql)
    assert want.column_names == got.column_names
    assert got.num_rows > 0
    assert_tables_match(want, got, ordered=_ends_in_order(sql))


def test_rollup_finest_grain_asks_the_kernel_gate(sessions):
    """A rollup whose finest grain (h x g: 5 x 7 slots) is under the
    kernel's segment gate asks ``_kernel_sum_ok`` for its decimal sum,
    and still agrees with the JAX engine."""
    jax_sess, torch_sess = sessions
    exe = torch_sess.executor
    asked = []
    gate = exe._kernel_sum_ok

    def spy_gate(c, ngseg):
        ok = gate(c, ngseg)
        asked.append((ngseg, ok))
        return ok

    exe._kernel_sum_ok = spy_gate
    try:
        sql = "select h, g, sum(d) sd from t group by rollup(h, g)"
        got = torch_sess.sql(sql)
    finally:
        del exe._kernel_sum_ok
    assert (5 * 7 + 1, True) in asked, asked
    assert_tables_match(jax_sess.sql(sql), got)


@pytest.mark.parametrize("sql", [
    "select pk, lag(d) over (partition by g order by k1) x from t",
    "select pk, lead(d) over (partition by g) x from t",
])
def test_refused_as_the_reference_refuses(sessions, sql):
    """A window function the JAX executor refuses (NDS209) is refused by
    the port with the same code."""
    jax_sess, torch_sess = sessions
    node = jax_sess.plan(sql)[0]
    while type(node).__name__ != "Window":
        node = node.child
    # the node's own method: JaxExecutor.execute would hand the refused
    # node to its numpy interpreter
    with pytest.raises(jaxexec.Unsupported) as want:
        jaxexec.JaxExecutor(jax_sess.catalog)._exec_window(node)
    with pytest.raises(torchexec.Unsupported) as got:
        torch_sess.sql(sql)
    assert want.value.code == got.value.code == "NDS209"


def test_descale_is_the_ieee_quotient():
    """Decimals descale to float64 by a true division on every device (a
    CUDA tensor divided by a Python number is multiplied by its
    reciprocal instead), so a ratio, and the rank or tie built on it,
    equals the reference's."""
    cents = np.arange(1, 200_001, dtype=np.int64)
    want = cents.astype(np.float64) / 100
    x = torchexec.torch.as_tensor(cents).double()
    assert (torchexec._true_div(x, 100).numpy() == want).all()
    # the reciprocal's product misses the quotient for many of them
    assert ((x * (1 / 100)).numpy() != want).sum() > 1000
