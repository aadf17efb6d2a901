"""Shared part of the corpus differential (tests/test_torch_corpus_
{1,2,3,4,5}.py and tests/test_torch_corpus_rows_{1,2}.py): every part of the
power corpus through the port and the JAX engine, over the port's own
generated warehouse.

The warehouse is ``ndstpu_torch.datagen.generate(SCALE, seed=1)`` on the
CPU, all 25 tables; the JAX engine reads the same numpy columns through a
``loader.Catalog``.  Each of the five numbered files takes a fifth of the
103 parts (``render_power_corpus()``, rngseed 07291122510, stream 0) and
parametrises over it.  A part passes when the port runs it with no
exception, its result agrees with ``Session(backend="tpu")`` under
``tests/test_jaxexec.py::assert_tables_match`` (in order where the plan
ends in a sort), and it comes back empty exactly when it is one of
``EMPTY``, the parts the generator's models leave without a row at this
scale.  The parts of ``EMPTY`` that a larger warehouse gives rows
(``FEW_ROWS``) are held the same way there, where each must find a
row.  This module holds no tests itself."""

import pytest

from ndstpu.engine import columnar as jax_columnar
from ndstpu.engine.session import Session as JaxSession
from ndstpu.io import loader
from ndstpu.schema import DType as JaxDType
from ndstpu_torch import datagen
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from ndstpu_torch.queries import corpus
from test_jaxexec import assert_tables_match

SCALE = 0.01
SQL = dict(corpus())
NAMES = list(SQL)
PARTS = 5

# the parts with no row at SCALE: values or ranges the generator's models
# never make at any scale (q56's colors, q53's and q63's brands, q62's and
# q65's months before the sales window), or too few rows at this size
# (one store, four reasons, 1,962 items)
EMPTY = {
    "query1", "query8", "query24_part1", "query24_part2", "query31", "query34",
    "query36", "query37", "query39_part2", "query41", "query44", "query49",
    "query53", "query54", "query56", "query58", "query62", "query63",
    "query64", "query65", "query68", "query84", "query85", "query91",
    "query93", "query99",
}
# the parts of EMPTY that a larger warehouse gives rows, for each of the
# two rows files: (scale, seed) -> the parts held there; the rest of EMPTY
# find no row in any of these
FEW_ROWS = (
    {(0.3, 1): ("query31", "query36", "query37", "query39_part2", "query49",
                "query58", "query64", "query68", "query84", "query91")},
    {(1, 1): ("query1", "query41", "query85", "query93"),
     (1, 3): ("query54",)},
)


def part(i: int):
    """The i-th fifth (1-based) of the corpus parts: every fifth part,
    so that the heavy templates spread over the five files."""
    return NAMES[i - 1::PARTS]


def jax_catalog(cat) -> loader.Catalog:
    """The JAX package's catalog over the numpy columns of the port's
    CPU catalog ``cat``."""
    out = loader.Catalog()
    for name, table in cat.tables.items():
        out.register(name, jax_columnar.Table({
            c: jax_columnar.Column(
                col.data.numpy(),
                JaxDType(col.ctype.kind, precision=col.ctype.precision,
                         scale=col.ctype.scale),
                None if col.valid is None else col.valid.numpy(),
                col.dictionary)
            for c, col in table.columns.items()}))
    return out


def make_sessions(scale: float, seed: int):
    """(JAX session, port session) over one generated warehouse."""
    cat = datagen.generate(scale, seed=seed, device="cpu")
    return JaxSession(jax_catalog(cat), backend="tpu"), Session(
        cat, device="cpu")


@pytest.fixture(scope="module")
def sessions():
    return make_sessions(SCALE, 1)


def rows_cases(i: int):
    """The (warehouse, part) cases of the i-th (1-based) rows file."""
    return [(where, name) for where, names in FEW_ROWS[i - 1].items()
            for name in names]


@pytest.fixture(scope="module")
def larger():
    """(scale, seed) -> sessions, one warehouse held at a time."""
    made = {}

    def get(where):
        if where not in made:
            made.clear()
            made[where] = make_sessions(*where)
        return made[where]
    return get


def check_part(sessions, name: str, empty=EMPTY):
    """``name`` through both engines: their results agree, and it is
    empty exactly when it is one of ``empty``."""
    jax_sess, torch_sess = sessions
    sql = SQL[name]
    table = torch_sess.sql(sql)
    want = jax_sess.sql(sql)
    assert want.column_names == table.column_names
    assert_tables_match(want, table,
                        ordered=fixes_order(torch_sess.plan(sql)[0]))
    assert (table.num_rows == 0) == (name in empty), \
        f"{name}: {table.num_rows} rows"
