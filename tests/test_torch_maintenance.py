"""The 11 data-maintenance functions through the JAX package's helpers on
``Session(backend="tpu")`` and through the port's on
``Session(device="cpu")``, over the port's CPU warehouse at SF 0.01 and
its refresh set 1 (``test_torch_dm_common``).

Each function runs in both packages in the reference's order; after each,
every fact table of the two catalogs must match under
``tests/test_jaxexec.py::assert_tables_match`` (decimals, ints, dates and
strings exact, floats within 1e-5 relative).  A table that neither
function replaced since it last matched (its catalog version unchanged in
both) still matches, so only the replaced ones are compared again.  The
functions that fail in the JAX package (LF_CR, LF_SR and LF_WR, at
``planner.py:257``) fail alike in the port; each other LF function
inserts rows and each DF function deletes some."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

from ndstpu.harness import maintenance as jax_dm
from ndstpu_torch.harness import maintenance as dm
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import jax_catalog
from test_torch_dm_common import FAILING, sessions, warehouse


def _run(run_dm_query, sess, stmts):
    """The function's error (a string), or None; as ``BenchReport``
    records a failed function and the run goes on."""
    try:
        run_dm_query(sess, stmts)
    except Exception as e:  # noqa: BLE001
        return f"{type(e).__name__}: {e}"
    return None


@pytest.fixture(scope="module")
def runs():
    """{function: (JAX error, port error, rows before, rows after,
    unmatched tables)}, each function run in both packages in order."""
    cat = warehouse()
    jsess, sess = sessions(cat, jax_catalog(cat))
    jq = jax_dm.get_maintenance_queries(jsess, jax_dm.DM_FUNCS)
    pq = dm.get_maintenance_queries(sess, dm.DM_FUNCS)
    assert list(jq) == list(pq) == dm.DM_FUNCS
    assert jq == pq
    out = {}
    checked = {t: None for t in dm.FACT_TABLES}
    for fn in dm.DM_FUNCS:
        before = dm.fact_rows(sess)
        jerr = _run(jax_dm.run_dm_query, jsess, jq[fn])
        perr = _run(dm.run_dm_query, sess, pq[fn])
        bad = {}
        for t in dm.FACT_TABLES:
            state = (jsess.catalog.versions[t], sess.catalog.versions[t])
            if checked[t] == state:
                continue
            try:
                assert_tables_match(jsess.catalog.get(t), sess.catalog.get(t))
                checked[t] = state
            except AssertionError as e:
                bad[t] = str(e)[:300]
        out[fn] = (jerr, perr, before, dm.fact_rows(sess), bad)
    return out


@pytest.mark.parametrize("fn", dm.DM_FUNCS)
def test_function_leaves_fact_tables_equal(runs, fn):
    jerr, perr, before, after, bad = runs[fn]
    assert not bad, f"{fn}: tables differ: {bad}"
    if fn in FAILING:
        assert jerr is not None and perr is not None
        assert "non-equi left join unsupported" in jerr
        assert perr == jerr
        assert after == before
        return
    assert jerr is None and perr is None, (jerr, perr)
    changed = {t for t in dm.FACT_TABLES if after[t] != before[t]}
    if fn.startswith("LF"):
        assert len(changed) == 1
        (t,) = changed
        assert after[t] > before[t]
    else:
        assert changed
        assert all(after[t] < before[t] for t in changed)
