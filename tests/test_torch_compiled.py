"""The port's compiling executor against the JAX engine's.

``Session(device="cpu").sql`` discovers a query key's size plan at its
first run and replays it after: on the CPU the replay runs the plan's
operators at the recorded padded capacities, without the CUDA graph
capture it gets on a card.  Each test holds the port's results against
``Session(backend="tpu")`` (JAX on the CPU) over one generated warehouse
(``ndstpu_torch.datagen.generate(0.01, seed=1)``, the corpus
differential's), under ``tests/test_jaxexec.py::assert_tables_match``:
ints, decimals, dates and strings exact, floats within 1e-5 relative.

The first three port tests of ``tests/test_jaxexec.py`` on the same SQL
(replay path, steady state, compile records); then parameter sharing,
rediscovery, the key latch, and parameters evaluated against literals.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import threading
import warnings

import numpy as np
import pytest
import torch

from ndstpu_torch.engine import expr as ex, torchexec
from ndstpu_torch.engine.columnar import (DATE, FLOAT64, INT32, STRING,
                                          decimal)
from ndstpu_torch.engine.session import Session
from ndstpu_torch.queries import streamgen
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import make_sessions

_REPLAY_SQL = ("select i_category, count(*) as cnt, "
               "sum(ss_ext_sales_price) as s "
               "from store_sales join item on ss_item_sk = i_item_sk "
               "where ss_quantity > 5 "
               "group by i_category order by i_category")
_STEADY_SQL = ("select i_category, count(*) as n, sum(ss_net_paid) as s "
               "from store_sales join item on ss_item_sk = i_item_sk "
               "where ss_quantity > 2 group by i_category "
               "order by i_category")
_RECORD_SQL = ("select i_category, count(*) as n, sum(ss_net_paid) as s "
               "from store_sales join item on ss_item_sk = i_item_sk "
               "group by i_category order by i_category")


@pytest.fixture(scope="module")
def sessions():
    return make_sessions(0.01, 1)


def _fresh(sessions):
    """A new port session over the module's catalog."""
    return Session(sessions[1].catalog, device="cpu")


def test_compiled_replay_path(sessions):
    """The second run of a query replays its compiled plan and agrees
    with the first run and with the JAX engine."""
    jax_sess, _ = sessions
    sess = _fresh(sessions)
    exe = sess.executor
    first = sess.sql(_REPLAY_SQL)
    cp = sess.compiled_plan(_REPLAY_SQL)
    assert cp is not None and cp.record
    assert (exe.n_discoveries, exe.n_replays) == (1, 0)
    second = sess.sql(_REPLAY_SQL)      # replay path
    assert (exe.n_discoveries, exe.n_replays) == (1, 1)
    assert exe.n_syncs == 1             # its one read-back
    assert_tables_match(first, second, ordered=True)
    assert_tables_match(jax_sess.sql(_REPLAY_SQL), second, ordered=True)


def test_steady_state_no_retrace(sessions):
    """With the warm replay on, the first run discovers and replays once;
    every later run only replays: no discovery, no capture."""
    jax_sess, _ = sessions
    sess = _fresh(sessions)
    exe = sess.executor
    exe.warm_replay = True          # a card's first run replays at once
    first = sess.sql(_STEADY_SQL)
    assert (exe.n_discoveries, exe.n_replays) == (1, 1)
    disc, captures = exe.n_discoveries, exe.n_captures
    for i in range(2):
        got = sess.sql(_STEADY_SQL)
        assert_tables_match(first, got, ordered=True)
        assert exe.n_replays == 2 + i
    assert exe.n_discoveries == disc, "steady-state run re-discovered"
    assert exe.n_captures == captures, "steady-state run re-captured"
    assert_tables_match(jax_sess.sql(_STEADY_SQL), got, ordered=True)


def test_compile_record_persistence(sessions, tmp_path):
    """Saved size-plan records let a fresh session skip discovery and go
    straight to replay, with identical results."""
    jax_sess, _ = sessions
    s1 = _fresh(sessions)
    want = s1.sql(_RECORD_SQL)
    path = str(tmp_path / "plans.pkl")
    assert s1.save_compiled(path) >= 1
    s2 = _fresh(sessions)
    assert s2.preload_compiled(path) >= 1
    cp = s2.compiled_plan(_RECORD_SQL)
    assert cp is not None and cp.preloaded
    got = s2.sql(_RECORD_SQL)
    assert s2.executor.n_discoveries == 0
    assert s2.executor.n_replays == 1 and not cp.preloaded
    assert_tables_match(want, got, ordered=True)
    assert_tables_match(jax_sess.sql(_RECORD_SQL), got, ordered=True)


def _renderings(template: str):
    """Stream 0's and stream 1's rendering of a one-part template."""
    out = []
    for stream in (0, 1):
        ((_name, sql),) = streamgen.render_template_parts(
            str(streamgen.TEMPLATE_DIR / f"{template}.tpl"),
            streamgen.BENCH_RNGSEED, stream)
        out.append(sql)
    return out


def test_two_renderings_share_one_compiled_entry(sessions):
    """q52's two stream renderings differ only in bindable literals:
    one canonical key, one compiled entry, discovered once, the second
    rendering replayed under its own binding; each equals the JAX
    engine."""
    jax_sess, _ = sessions
    sess = _fresh(sessions)
    exe = sess.executor
    a, b = _renderings("query52")
    assert a != b and sess.canonical_key(a) == sess.canonical_key(b)
    for sql in (a, b):
        got = sess.sql(sql)
        assert_tables_match(jax_sess.sql(sql), got, ordered=True)
    assert sess.compiled_count() == 1
    assert sess.compiled_plan(a) is sess.compiled_plan(b)
    assert (exe.n_discoveries, exe.n_replays, exe.n_guard_failures) == \
        (1, 1, 0)


def test_catalog_version_bump_rediscovers(sessions):
    """Re-registering a table (its version bumps) drops the compiled
    plan: the next run discovers again, over the new rows, and equals
    the JAX engine over the same rows."""
    jax_sess, sess0 = sessions
    from ndstpu.engine.session import Session as JaxSession
    from test_torch_corpus_common import jax_catalog
    from ndstpu_torch.io.catalog import Catalog
    cat = Catalog(tables=dict(sess0.catalog.tables),
                  meta=dict(sess0.catalog.meta),
                  versions=dict(sess0.catalog.versions))
    sess = Session(cat, device="cpu")
    exe = sess.executor
    sess.sql(_REPLAY_SQL)
    item = cat.get("item")
    keep = torch.arange(item.num_rows) % 3 != 0
    from ndstpu_torch.engine.columnar import Column, Table
    cat.register("item", Table({
        n: Column(c.data[keep], c.ctype,
                  None if c.valid is None else c.valid[keep], c.dictionary)
        for n, c in item.columns.items()}))
    got = sess.sql(_REPLAY_SQL)
    assert exe.n_discoveries == 2 and exe.n_replays == 0
    want = JaxSession(jax_catalog(cat), backend="tpu").sql(_REPLAY_SQL)
    assert_tables_match(want, got, ordered=True)
    assert got.to_rows() != sess0.sql(_REPLAY_SQL).to_rows()


_OVERFLOWS = {
    # the compaction under the LIMIT outgrows its recorded capacity
    "compaction": ("select ss_item_sk, ss_ticket_number from store_sales "
                   "where ss_quantity < {} order by ss_item_sk, "
                   "ss_ticket_number limit 5000", 5000),
    # the join's expansion outgrows its recorded capacity: replay must
    # keep every index in range while its guard fails
    "join expansion": ("select i_category, count(*) as n from store_sales "
                       "join item on ss_item_sk = i_item_sk where "
                       "ss_quantity < {} group by i_category "
                       "order by i_category", None),
}


@pytest.mark.parametrize("case", list(_OVERFLOWS))
def test_overflowing_binding_rediscovers(sessions, case):
    """A rendering whose rows outgrow the capacities its key recorded
    fails a replay guard and is rediscovered: the answer still equals the
    JAX engine's, and the key keeps one compiled entry."""
    jax_sess, _ = sessions
    sess = _fresh(sessions)
    exe = sess.executor
    template, rows = _OVERFLOWS[case]
    few, many = template.format(2), template.format(90)
    assert sess.canonical_key(few) == sess.canonical_key(many)
    sess.sql(few)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = sess.sql(many)
    assert any("rediscovering" in str(w.message) for w in caught)
    assert (exe.n_discoveries, exe.n_guard_failures) == (2, 1)
    if rows is not None:
        assert got.num_rows == rows
    assert_tables_match(jax_sess.sql(many), got, ordered=True)
    assert sess.compiled_count() == 1
    # the rediscovered plan serves the first rendering again by replay
    # (the replay that failed its guard was the first)
    again = sess.sql(few)
    assert (exe.n_discoveries, exe.n_replays) == (2, 2)
    assert_tables_match(jax_sess.sql(few), again, ordered=True)


_TWICE = ("with a as (select i_category, count(*) c from item where "
          "i_current_price > 10 group by i_category) select x.i_category, "
          "x.c, y.c as c2 from a x join a y on x.i_category = y.i_category "
          "order by x.i_category")


def test_memo_sharing_follows_the_binding(sessions):
    """The CTE's two copies get a slot each, bound to one value: the memo
    runs the CTE once, as in the literal plan.  A binding that gives the
    two slots different values cannot replay that sharing: it has a
    compiled entry of its own under the same key, discovered at its first
    run with no guard failure, and its copies differ (JAX cannot render
    it: the copies come from one CTE text).  The two bindings then
    alternate by replay, neither evicting the other."""
    jax_sess, _ = sessions
    sess = _fresh(sessions)
    exe = sess.executor
    got = sess.sql(_TWICE)
    assert exe.n_memo_hits == 1
    assert_tables_match(jax_sess.sql(_TWICE), got, ordered=True)
    plan, _disp, c = sess._plan_cached(*_stmt_and_key(_TWICE))
    assert c.values == (10, 10)
    key = sess._exec_key(c.cache_key)   # the key sess.sql runs under
    other = ex.ParamBinding(values=(10, 20), scalars=c.binding.scalars)
    split = exe.execute_cached(c.exec_plan, key, params=other)
    assert (exe.n_discoveries, exe.n_guard_failures,
            exe.n_memo_sig_misses) == (2, 0, 1)
    assert exe.n_memo_hits == 0
    assert sess.compiled_count() == 2
    replays = exe.n_replays
    for binding, hits in ((c.binding, 1), (other, 0), (c.binding, 1)):
        exe.execute_cached(c.exec_plan, key, params=binding)
        assert exe.n_memo_hits == hits
    assert (exe.n_discoveries, exe.n_replays - replays) == (2, 3)
    want = _fresh(sessions).executor.execute_cached(c.exec_plan, "k",
                                                    params=other)
    assert_tables_match(want, split, ordered=True)
    cols = list(split.columns.values())
    assert (cols[1].data != cols[2].data).any()


def _stmt_and_key(sql):
    from ndstpu_torch.engine.sql import normalize_sql_key, parse_statement
    return parse_statement(sql), normalize_sql_key(sql)


def test_canonical_plans_keep_the_literal_plans_memo_hits():
    """Over every part of the corpus, the parameterized plan under its
    rendering's binding hits the memo where the literal plan does."""
    from ndstpu_torch import analysis
    from ndstpu_torch.analysis import canon
    from ndstpu_torch.queries import corpus
    sess = Session(analysis.schema_catalog(), device="cpu")
    for name, sql in corpus():
        plan = sess.plan(sql)[0]
        c = canon.canonicalize(plan, query=name)
        assert torchexec._memo_uses(plan) == {} or \
            sorted(torchexec._memo_uses(plan).values()) == sorted(
                torchexec._memo_uses(c.exec_plan, c.values).values()), name


def test_two_threads_discover_once(sessions):
    """Two threads running one text at once: the key's latch lets the
    first discover while the second waits, then replays."""
    jax_sess, _ = sessions
    sess = _fresh(sessions)
    exe = sess.executor
    barrier = threading.Barrier(2)
    results, errors = [None, None], []

    def run(i):
        try:
            barrier.wait()
            results[i] = sess.sql(_REPLAY_SQL)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert (exe.n_discoveries, exe.n_replays) == (1, 1)
    want = jax_sess.sql(_REPLAY_SQL)
    for got in results:
        assert_tables_match(want, got, ordered=True)


# -- a parameter evaluates like its literal --------------------------------

_DEC = decimal(7, 2)


def _table():
    """Eight rows of every kind a parameter binds, with NULLs."""
    valid = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool)

    def col(values, ctype, dictionary=None):
        return torchexec.DCol(torch.tensor(values,
                                           dtype=torchexec.torch_dtype(ctype)),
                              valid, ctype, dictionary)
    dic = np.array(["apple", "kiwi", "pear", "plum"], dtype=object)
    cols = {
        "i": col([3, 7, 0, 12, -4, 7, 9, 100], INT32),
        "d": col([1250, -300, 0, 99999, 1250, 5, 7, 40000], _DEC),
        "dt": col([10957, 11000, 0, 10000, 12000, 10957, 3, 11500], DATE),
        "f": col([0.5, -2.25, 0.0, 1e9, 3.0, 0.5, 1.0, -7.5], FLOAT64),
        "s": col([0, 1, -1, 2, 3, 1, -1, 0], STRING, dic),
    }
    alive = torch.ones(8, dtype=torch.bool)
    return torchexec.DTable(cols, alive)


_C = ex.ColumnRef
_CASES = {
    "int >": (ex.BinOp(">", _C("i"), "P"), 7, INT32),
    "decimal =": (ex.BinOp("=", _C("d"), "P"), 12.5, _DEC),
    "date >=": (ex.BinOp(">=", _C("dt"), "P"), 10957, DATE),
    "float <": (ex.BinOp("<", _C("f"), "P"), 0.5, FLOAT64),
    "int arithmetic": (ex.BinOp("+", _C("i"), "P"), 1000, INT32),
    "string =": (ex.BinOp("=", _C("s"), "P"), "kiwi", STRING),
    "string = absent": (ex.BinOp("=", _C("s"), "P"), "fig", STRING),
    "string <": (ex.BinOp("<", _C("s"), "P"), "orange", STRING),
    "string swapped <>": (ex.BinOp("<>", "P", _C("s")), "pear", STRING),
    "int IN": ("IN", _C("i"), (7, 12, 55)),
    "int NOT IN": ("NOT IN", _C("i"), (7, 12, 55)),
    "decimal IN": ("IN", _C("d"), (12.5, 50.0)),
    "string IN": ("IN", _C("s"), ("plum", "apple", "fig")),
}


def _forms(case):
    """(expression with the literal, expression with slot 0, binding)."""
    spec = _CASES[case]
    if spec[0] in ("IN", "NOT IN"):
        neg, operand, values = spec[0] == "NOT IN", spec[1], spec[2]
        return (ex.InList(operand, values, neg),
                ex.InParam(operand, 0, len(values), neg),
                ex.ParamBinding(values=(values,), scalars=()))
    e, value, ctype = spec
    lit, par = ex.Literal(value, ctype), ex.Param(0, ctype)

    def put(x):
        return lambda s: x if s == "P" else s
    left, right = (put(lit)(e.left), put(lit)(e.right))
    pl, pr = (put(par)(e.left), put(par)(e.right))
    scalars = () if ctype.kind == "string" else ((0, ctype),)
    return (ex.BinOp(e.op, left, right), ex.BinOp(e.op, pl, pr),
            ex.ParamBinding(values=(value,), scalars=scalars))


@pytest.mark.parametrize("case", list(_CASES))
def test_param_evaluates_like_its_literal(case):
    """A parameter evaluates like the literal it was lifted from, bound
    from host values (discovery) and from device buffers rebuilt for the
    binding out of the recorded spec (replay)."""
    dt = _table()
    lit_e, par_e, binding = _forms(case)
    want = torchexec.JEval(dt).eval(lit_e)
    spec = []
    ctx = torchexec._ParamCtx(binding.values, "concrete", spec=spec,
                              record=True)
    with torchexec._params_bound(ctx):
        concrete = torchexec.JEval(dt).eval(par_e)
    bufs = {k: torch.as_tensor(v) for k, v in
            torchexec._param_args_np(spec, binding).items()}
    ctx = torchexec._ParamCtx(None, "replay", spec=spec, bufs=bufs)
    with torchexec._params_bound(ctx):
        replayed = torchexec.JEval(dt).eval(par_e)
    assert ctx.pos == len(spec)
    for got in (concrete, replayed):
        assert got.ctype == want.ctype
        ok = want.valid & dt.alive
        assert torch.equal(got.valid & dt.alive, ok)
        assert torch.equal(got.data[ok], want.data[ok]), case


def test_unbound_parameter_is_refused():
    """A parameter evaluated with no binding raises Unsupported, as
    jaxexec does (NDS201)."""
    with pytest.raises(torchexec.Unsupported) as e:
        torchexec.JEval(_table()).eval(ex.Param(0, INT32))
    assert e.value.code == "NDS201"


def test_nonzero_static_and_isin_match_torch():
    """The sync-free helpers of the replay path equal the torch calls
    they stand for."""
    gen = torch.Generator().manual_seed(5)
    mask = torch.rand(1000, generator=gen) < 0.3
    idx = torchexec._nonzero_static(mask, 400)
    want = torch.nonzero(mask).squeeze(1)
    assert torch.equal(idx[:len(want)], want)
    assert bool((idx[len(want):] == 0).all())
    assert torch.equal(torchexec._nonzero_static(mask, 10), want[:10])
    x = torch.randint(0, 50, (500,), generator=gen)
    test = torch.randint(0, 50, (40,), generator=gen)
    assert torch.equal(torchexec._isin(x, test), torch.isin(x, test))
    assert not torchexec._isin(x, test[:0]).any()


def test_size_class_ladder():
    """Four capacity classes an octave from 256 up, each holding its
    count, at most a quarter above it."""
    assert [torchexec.size_class(n) for n in
            (0, 1, 256, 257, 320, 321, 512, 513, 1000, 10 ** 6)] == \
        [256, 256, 256, 320, 320, 384, 512, 640, 1024, 1048576]
    for n in range(257, 70000, 97):
        c = torchexec.size_class(n)
        assert n <= c <= n * 1.25 + 1
