"""Shared part of the floats corpus differential (tests/test_torch_floats_
{1,2,3,4,5}.py): every part of the power corpus through the port and the
JAX engine over the decimals-as-doubles warehouse of the reference
benchmark's ``--floats`` configuration.

The warehouse is ``ndstpu_torch.datagen.generate(SCALE, seed=1,
use_decimal=False)`` on the CPU, all 25 tables, every DECIMAL column of
the schema a FLOAT64 one (the nearest double to each decimal value); the
JAX engine reads the same numpy columns through a ``loader.Catalog``
(``test_torch_corpus_common.jax_catalog``), as the decimal differential
does.  Each numbered file takes a fifth of the 103 parts.  A part passes
when the port runs it twice with no exception (discovery, then a replay
that makes no host sync), each result agrees with
``Session(backend="tpu")`` (ints, dates and strings exactly, floats within
1e-5 relative: ``tests/test_jaxexec.py::_rows_equal``), and it is empty
exactly when it is one of ``test_torch_corpus_common.EMPTY`` (the same 26
parts as with decimals).

The ordering rule.  A float sum depends on the order of its additions,
which differs between engines and, on a card, between runs (float64
atomics), so sums that are equal as decimals may differ in the last bits
and two rows whose ORDER BY keys tie may come in either order.  So a
result whose plan ends in a sort is held in order, except inside a run
of rows whose sort keys are equal within 1e-5 relative (each key to the
run's first row's; NULL equal to NULL only), which is compared as a
multiset within tolerance; a run cut by the LIMIT is held as a choice:
each row of the cut run must match a distinct row of the whole run.  The
runs and the whole runs come from the port's eager run of the plan
without its LIMIT on the CPU, whose top sort's key values are read as it
sorts; the rule applies only where the plain comparison in order fails
(``held_in_order``), and the parts that needed it are printed.  The code
is ``chip_smoke.py``'s (``tie_rule``), which applies it to the card's
runs against the CPU's.  The tolerance is ``_rows_equal``'s, not a wider
one.  This module holds no tests itself."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import fcntl
import os
import shutil
import subprocess

import pytest

from chip_smoke import engine_rows, tie_rule
from ndstpu_torch import datagen
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import (EMPTY, NAMES, PARTS, SCALE, SQL,
                                      _session_dir, jax_catalog,
                                      jax_reference, jax_warehouse,
                                      replays_without_sync)


def part(i: int):
    """The i-th fifth (1-based) of the corpus parts, as the decimal
    differential splits them."""
    return NAMES[i - 1::PARTS]


def floats_catalog(scale: float = SCALE, seed: int = 1):
    return datagen.generate(scale, seed=seed, device="cpu",
                            use_decimal=False)


@pytest.fixture(scope="module")
def sessions():
    """(JAX session, port session) over the floats warehouse."""
    cat = floats_catalog()
    return jax_reference(jax_catalog(cat)), Session(cat, device="cpu")


def held_in_order(catalog, plan, name: str, *tables) -> None:
    """Each of ``tables`` (results of one ordered part) under the
    ordering rule, against the port's eager rows of ``plan`` over
    ``catalog`` (``chip_smoke.tie_rule``, the rule as the card's check
    applies it)."""
    assert tie_rule(catalog, plan,
                    [engine_rows(t, nulls=True) for t in tables]), \
        f"{name}: rows out of order beyond tied sort keys"
    print(f"{name}: held under the ordering rule")


def check_part(sessions, name: str):
    """``name`` through both engines over the floats warehouse: the
    port's discovery and its replay (no host sync) each agree with the
    JAX engine, under the ordering rule where the plan ends in a sort."""
    jax_sess, torch_sess = sessions
    sql = SQL[name]
    exe = torch_sess.executor
    first = torch_sess.sql(sql)
    replays, discoveries = exe.n_replays, exe.n_discoveries
    with replays_without_sync(exe):
        second = torch_sess.sql(sql)
    assert (exe.n_replays, exe.n_discoveries) == \
        (replays + 1, discoveries), "the second run did not replay"
    want = jax_sess.sql(sql)
    plan = torch_sess.plan(sql)[0]
    ordered = fixes_order(plan)
    try:
        for table in (first, second):
            assert want.column_names == table.column_names
            assert_tables_match(want, table, ordered=ordered)
    except AssertionError:
        if not ordered:
            raise
        held_in_order(torch_sess.catalog, plan, name, want, first, second)
    assert (first.num_rows == 0) == (name in EMPTY), \
        f"{name}: {first.num_rows} rows"


def jax_floats_warehouse(tmp_path_factory):
    """The SF 0.002 raw CSV of ``jax_warehouse`` transcoded with the JAX
    package's ``transcode --floats``, built once for the test session
    under a lock as that warehouse is."""
    wh = jax_warehouse(tmp_path_factory)
    root = _session_dir(tmp_path_factory) / "jax_sf0002_floats"
    with open(str(root) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "load.txt").exists():
            shutil.rmtree(root, ignore_errors=True)
            env = dict(os.environ, PYTHONPATH=os.getcwd())
            subprocess.run(["python", "-m", "ndstpu.io.transcode",
                            "--floats", "--input_prefix",
                            str(wh.parent / "raw"), "--output_prefix",
                            str(root), "--report_file",
                            str(root / "load.txt")],
                           check=True, env=env, stdout=subprocess.DEVNULL)
    return root
