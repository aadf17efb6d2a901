"""Shared part of the template differential (tests/test_torch_templates_
{1,2,3}.py): every NDS template through the port and the JAX engine.

Each of the three files takes a third of ``streamgen.list_templates()``
(rendered with rngseed 07291122510, stream 0) and parametrises over it, so
each template counts as one test.  A case passes when the port's result
agrees with ``Session(backend="tpu")`` under
``tests/test_jaxexec.py::assert_tables_match`` (in order where the plan
ends in a sort).  Any exception, ``Unsupported`` included, and any
disagreement fails it.
The warehouse is the SF 0.002 one tests/test_torch_engine.py builds.
This module holds no tests itself."""

import os
import subprocess

import pytest

from ndstpu.engine.session import Session as JaxSession
from ndstpu.io import loader
from ndstpu.queries import streamgen
from ndstpu_torch import carry
from ndstpu_torch.engine import plan as lp
from ndstpu_torch.engine.session import Session
from test_jaxexec import assert_tables_match

TEMPLATES = [t[:-len(".tpl")] for t in streamgen.list_templates()]
PARTS = 3


def part(i: int):
    """The i-th third (1-based) of the templates."""
    per = -(-len(TEMPLATES) // PARTS)
    return TEMPLATES[(i - 1) * per: i * per]


def render(tpl: str):
    return [sql for _n, sql in streamgen.render_template_parts(
        str(streamgen.TEMPLATE_DIR / f"{tpl}.tpl"), "07291122510", 0)]


def fixes_order(plan) -> bool:
    """Does the plan end in a sort (under projections and a limit)?"""
    while isinstance(plan, (lp.Limit, lp.Project, lp.SubqueryAlias)):
        plan = plan.child
    return isinstance(plan, lp.Sort)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(JAX session, port session) over one SF 0.002 warehouse."""
    data = tmp_path_factory.mktemp("raw")
    wh = tmp_path_factory.mktemp("wh")
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    subprocess.run(["python", "-m", "ndstpu.datagen.driver", "local", "0.002",
                    "2", str(data)], check=True, env=env,
                   stdout=subprocess.DEVNULL)
    subprocess.run(["python", "-m", "ndstpu.io.transcode",
                    "--input_prefix", str(data),
                    "--output_prefix", str(wh),
                    "--report_file", str(wh / "load.txt")],
                   check=True, env=env, stdout=subprocess.DEVNULL)
    cat = loader.load_catalog(str(wh))
    plain = {t: {n: (c.data, (c.ctype.kind, c.ctype.precision,
                              c.ctype.scale), c.valid, c.dictionary)
                 for n, c in tab.columns.items()}
             for t, tab in cat.tables.items()}
    return (JaxSession(cat, backend="tpu"),
            Session(carry.catalog_from_numpy(plain), device="cpu"))


def check_template(sessions, tpl: str):
    jax_sess, torch_sess = sessions
    for sql in render(tpl):
        table = torch_sess.sql(sql)
        want = jax_sess.sql(sql)
        assert want.column_names == table.column_names
        assert_tables_match(want, table,
                            ordered=fixes_order(torch_sess.plan(sql)[0]))
