"""Shared part of the out-of-core corpus check (tests/test_torch_ooc_
{1,2,3}.py): every part of the power corpus through the port's chunked
session (``Session(spmd_threshold=500, spmd_chunk_rows=N)``, the
distributed plan executor over a one-rank mesh) against the port's
resident answer (the compiling executor), over the corpus tests' warehouse
(``datagen.generate(0.01, seed=1)`` on the CPU).

A part's chunk size is half its largest table of the threshold's size,
and where a fact it streams then fits one chunk, half the smallest such
fact: every streamed fact runs in at least two chunks.  A part passes when
its answer equals the resident one (ints, decimals, dates and strings
exactly, floats within 1e-5 relative, in order where the plan fixes it),
and it falls through to the compiling executor exactly when the JAX
package's chunked session does on the same warehouse, with the same code
(``JAX_FALLTHROUGH``).  This module holds no tests itself."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
import torch

from ndstpu_torch import datagen, obs
from ndstpu_torch.engine import expr as ex, plan as lp
from ndstpu_torch.engine.optimizer import _plan_exprs
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from ndstpu_torch.engine.torchexec import results_differ
from ndstpu_torch.queries import corpus
from test_jaxexec import assert_tables_match

SCALE = 0.01
THRESHOLD = 500
SQL = dict(corpus())
NAMES = list(SQL)
PARTS = 3

# The parts the JAX package's chunked session
# (Session(backend="tpu", spmd_threshold=500, spmd_chunk_rows=1000)) lets
# fall through to its single-chip executor on this warehouse, each with
# its engine.spmd.fallback code (None: uncoded).  Obtained by running all
# 103 parts through that session over jax_catalog(datagen.generate(0.01,
# seed=1)) and reading its counters: none falls through.
JAX_FALLTHROUGH = {}


def part(i: int):
    """The i-th third (1-based) of the corpus parts, every third part."""
    return NAMES[i - 1::PARTS]


@pytest.fixture(scope="module")
def warehouse():
    cat = datagen.generate(SCALE, seed=1, device="cpu")
    return cat, Session(cat, device="cpu")


def _scans(plan):
    """The plan's scans, those of its subqueries' plans included."""
    for node in plan.walk():
        if isinstance(node, lp.Scan):
            yield node
        for e in _plan_exprs(node):
            for x in e.walk():
                if isinstance(x, ex.SubqueryExpr) and x.plan is not None:
                    yield from _scans(x.plan)


def _largest(cat, sess, sql) -> int:
    plan, _ = sess.plan(sql)
    return max((cat.get(n.table).num_rows for n in _scans(plan)
                if cat.get(n.table).num_rows >= THRESHOLD), default=1)


def run_chunked(cat, sql, chunk_rows):
    """One run of ``sql`` through a fresh chunked session: (result, the
    executor or None when the part fell through, the counters it moved)."""
    sess = Session(cat, device="cpu", spmd_threshold=THRESHOLD,
                   spmd_chunk_rows=chunk_rows)
    obs.reset(enabled=True)
    before = obs.counters_snapshot()
    out = sess.sql(sql)
    return out, sess.last_spmd, obs.counter_delta(before)


def check_ooc_part(warehouse, name: str, monkeypatch):
    monkeypatch.setenv("NDSTPU_SPMD_STRICT", "1")
    cat, resident = warehouse
    sql = SQL[name]
    want = resident.sql(sql)
    chunk = -(-_largest(cat, resident, sql) // 2)
    got, exe, moved = run_chunked(cat, sql, chunk)
    fits = [n for _t, n, _m, _l, why in (exe.streams if exe else ())
            if why == "fits"]
    if fits:
        chunk = max(-(-min(fits) // 2), 1)
        got, exe, moved = run_chunked(cat, sql, chunk)
    codes = sorted(k[len("engine.spmd.fallback."):] for k in moved
                   if k.startswith("engine.spmd.fallback."))
    if name in JAX_FALLTHROUGH:
        assert exe is None and codes == [c for c in [JAX_FALLTHROUGH[name]]
                                         if c], (name, codes)
    else:
        assert exe is not None, f"{name} fell through: {codes}"
        # every fact streams in two chunks or more, but where the JAX
        # package's executor keeps the spine resident (DISTINCT, window)
        assert exe.streams and all(
            launches >= 2 if why is None else why in ("distinct", "window")
            for *_, launches, why in exe.streams), (name, exe.streams)
    plan, _ = resident.plan(sql)
    diff = results_differ(want, got)
    assert diff is None, f"{name}: {diff}"
    if fixes_order(plan):
        # the rows in the resident order, row by row (floats within
        # assert_tables_match's tolerance)
        assert_tables_match(want, got, ordered=True)
