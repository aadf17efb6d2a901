"""Shared part of the template differential (tests/test_torch_templates_
{1,2,3}.py): every NDS template through the port and the JAX engine.

Each of the three files takes a third of ``streamgen.list_templates()``
(rendered with rngseed 07291122510, stream 0) and parametrises over it, so
each template counts as one test.  A case passes when the port's result
agrees with ``Session(backend="tpu")`` under
``tests/test_jaxexec.py::assert_tables_match`` (in order where the plan
ends in a sort).  Any exception, ``Unsupported`` included, and any
disagreement fails it.  Each file also holds its third of the accepted
and refused sets (``refusals``): the port's outcome of each template, as
its ``test_template`` met it (``PORT_RAN``), or run again where that
test did not run the template through the port.
The warehouse is the SF 0.002 one tests/test_torch_engine.py reads
(``test_torch_corpus_common.jax_warehouse``, built once a test session).
This module holds no tests itself."""

import pytest

from ndstpu.io import loader
from ndstpu.queries import streamgen
from ndstpu_torch import carry
from ndstpu_torch.engine import torchexec
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import (jax_reference, jax_warehouse,
                                      shared_xla_cache)

TEMPLATES = [t[:-len(".tpl")] for t in streamgen.list_templates()]
PARTS = 3


def part(i: int):
    """The i-th third (1-based) of the templates."""
    per = -(-len(TEMPLATES) // PARTS)
    return TEMPLATES[(i - 1) * per: i * per]


def render(tpl: str):
    return [sql for _n, sql in streamgen.render_template_parts(
        str(streamgen.TEMPLATE_DIR / f"{tpl}.tpl"), "07291122510", 0)]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(JAX session, port session) over one SF 0.002 warehouse."""
    cat = loader.load_catalog(str(jax_warehouse(tmp_path_factory)))
    plain = {t: {n: (c.data, (c.ctype.kind, c.ctype.precision,
                              c.ctype.scale), c.valid, c.dictionary)
                 for n, c in tab.columns.items()}
             for t, tab in cat.tables.items()}
    with shared_xla_cache(tmp_path_factory):
        yield (jax_reference(cat),
               Session(carry.catalog_from_numpy(plain), device="cpu"))


# template -> the Unsupported the port raised on one of its renderings, or
# None when the port ran every rendering (check_template, this process)
PORT_RAN = {}


def check_template(sessions, tpl: str):
    jax_sess, torch_sess = sessions
    tables = []
    for sql in render(tpl):
        try:
            tables.append(torch_sess.sql(sql))
        except torchexec.Unsupported as u:
            PORT_RAN[tpl] = u
            raise
    PORT_RAN[tpl] = None
    for sql, table in zip(render(tpl), tables):
        want = jax_sess.sql(sql)
        assert want.column_names == table.column_names
        assert_tables_match(want, table,
                            ordered=fixes_order(torch_sess.plan(sql)[0]))


def refusals(sessions, templates):
    """Each of ``templates`` the port refuses -> the Unsupported it
    raised: ``PORT_RAN``'s outcome, or the port's run of the template's
    renderings where it has none."""
    out = {}
    for tpl in templates:
        if tpl in PORT_RAN:
            if PORT_RAN[tpl] is not None:
                out[tpl] = PORT_RAN[tpl]
            continue
        for sql in render(tpl):
            try:
                sessions[1].sql(sql)
            except torchexec.Unsupported as u:
                out[tpl] = u
                break
    return out


# the templates the port accepted before (the q3 family's slice), the
# four store-channel reports, the templates that needed only windows or
# grouping sets, and those that needed set operations, DISTINCT or
# distinct aggregates
_ACCEPTED_BEFORE = (1, 3, 7, 13, 25, 26, 29, 30, 37, 42, 46, 48, 52, 55,
                    64, 65, 68, 73, 81, 82, 96)
_STORE_CHANNEL = (9, 43, 88, 93)
_WINDOWS_AND_GROUPING_SETS = (12, 18, 20, 22, 27, 36, 44, 47, 51, 53, 57,
                              63, 67, 70, 86, 89, 98)
_SETOPS_AND_DISTINCT = (2, 4, 5, 6, 8, 11, 14, 16, 23, 28, 33, 38, 41, 49,
                        54, 56, 60, 66, 71, 74, 75, 76, 77, 80, 87, 94, 95)
ACCEPTED = {f"query{i}" for i in _ACCEPTED_BEFORE + _STORE_CHANNEL +
            _WINDOWS_AND_GROUPING_SETS + _SETOPS_AND_DISTINCT}


def check_accepted(refused, templates):
    """The templates of ``templates`` the port accepted include every one
    of ``ACCEPTED`` among them."""
    accepted = set(templates) - set(refused)
    want = ACCEPTED & set(templates)
    assert want <= accepted, sorted(want - accepted)


def check_refused(refused):
    """No family is left to port: the port refuses no template (every
    part of the corpus runs through the port, the CPU analog of
    tests/test_jaxexec.py::test_corpus_compile_coverage)."""
    got = {tpl: (u.node, u.code, str(u)) for tpl, u in refused.items()}
    assert got == {}
