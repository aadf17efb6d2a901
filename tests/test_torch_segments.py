"""Segmented compilation in the port's compiling executor
(``torchexec._cut_segments`` and the segments of ``CompilingExecutor``)
against the JAX package's (``jaxexec._cut_segments`` and its
``CompilingExecutor``).

* On every part of the power corpus (stream 0 of rngseed 07291122510),
  planned and canonicalized on the zero-row schema catalogs, the port cuts
  the plan it runs into the JAX package's segments: the same fingerprints
  in the same order, and the same parent (``jaxexec._plan_fp``).
* At SF 0.01 (the corpus differential's warehouse,
  ``tests/test_torch_corpus_common.py``) one port session runs parts that
  cut into segments, in an order where a part shares the segment of the
  one before it (q24's two parts, q39's two parts, q88 and q96): each
  part's first run and its replay (under ``NoHostSync``)
  give ``Session(backend="tpu")``'s rows, and a segment an earlier part
  compiled is not discovered again but shared.  The copies of a CTE
  whose values the binding makes equal share one segment (q4).
* Dropping the compiled segment q88 and q96 share makes both rediscover,
  q88 with its segments and q96 sharing the new one; a guard that
  fails inside a segment (a recorded capacity cut below what the segment
  needs) makes its part rediscover; both answer as before.
* Compile records round-trip with their segments: a fresh session over the
  same tables that preloads them runs the parts with no discovery, with
  the same segment fingerprints and the shared segment shared; a file of
  the earlier format loads nothing.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import pickle

import pytest

from ndstpu import analysis as jax_analysis
from ndstpu.engine import jaxexec
from ndstpu.engine import sql as jax_sql
from ndstpu.engine.session import Session as JaxSession
from ndstpu_torch import analysis
from ndstpu_torch.engine import torchexec
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from ndstpu_torch.engine.sql import normalize_sql_key, parse_statement
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import (EMPTY, NAMES, SCALE, SQL,
                                      make_sessions, replays_without_sync)

# run in this order: each part after its partner shares its segment
RUNS = ["query24_part1", "query24_part2", "query39_part1", "query39_part2",
        "query88", "query96"]
SHARES = {"query24_part2": "query24_part1", "query39_part2": "query39_part1",
          "query96": "query88"}


@pytest.fixture(scope="module")
def planners():
    """(port session, JAX session) over the zero-row schema catalogs."""
    return (Session(analysis.schema_catalog(), device="cpu"),
            JaxSession(jax_analysis.schema_catalog()))


def _port_plan(sess, sql):
    """The plan the port's session runs for ``sql``, its key and
    binding."""
    return sess._run_args(parse_statement(sql), normalize_sql_key(sql))[:3]


@pytest.mark.parametrize("name", NAMES)
def test_cut_is_the_references(planners, name):
    port, ref = planners
    sql = SQL[name]
    plan = _port_plan(port, sql)[0]
    jplan, _disp, canon = ref._plan_cached(jax_sql.parse_statement(sql),
                                           jax_sql.normalize_sql_key(sql))
    if canon is not None:
        jplan = canon.exec_plan
    parent, segs = torchexec._cut_segments(plan)
    jparent, jsegs = jaxexec._cut_segments(jplan)
    assert list(segs) == list(jsegs)
    assert torchexec._plan_fp(parent, content=True) == \
        jaxexec._plan_fp(jparent)
    for fp, sub in segs.items():
        assert torchexec._plan_fp(sub, content=True) == fp


def test_copies_of_a_cte_share_one_segment(planners):
    """q4's six references to ``year_total`` cut into 18 segments (each
    copy binds parameter slots of its own), of which its binding's values
    make 3 distinct results: the parts compile and run 3 programs, as the
    plan-subtree memo runs 3 aggregates."""
    plan, _key, params = _port_plan(planners[0], SQL["query4"])
    segs = torchexec._cut_segments(plan)[1]
    alias = torchexec._seg_aliases(segs, params.values)
    assert (len(segs), len(segs) - len(alias)) == (18, 3)
    assert set(alias.values()) <= set(segs) - set(alias)


@pytest.fixture(scope="module")
def state():
    """The SF 0.01 sessions (the JAX engine's warm-up replay off: its
    first run returns its discovery's rows either way) and the JAX
    engine's rows of each part, made once."""
    jax_sess, torch_sess = make_sessions(SCALE, 1)
    want = {}

    def reference(name):
        if name not in want:
            want[name] = jax_sess.sql(SQL[name])
        return want[name]
    return {"port": torch_sess, "reference": reference}


def _agrees(state, name, table):
    sess = state["port"]
    want = state["reference"](name)
    assert want.column_names == table.column_names
    assert_tables_match(want, table,
                        ordered=fixes_order(sess.plan(SQL[name])[0]))
    assert (table.num_rows == 0) == (name in EMPTY)


@pytest.mark.parametrize("name", RUNS)
def test_segments_answer_as_the_reference(state, name):
    sess = state["port"]
    exe = sess.executor
    sql = SQL[name]
    plan, _key, params = _port_plan(sess, sql)
    segs = torchexec._cut_segments(plan)[1]
    assert segs, f"{name} cuts into no segment"
    alias = torchexec._seg_aliases(segs, params.values)
    cut = [fp for fp in segs if fp not in alias]
    known = {slot[0] for slot in exe._seg_compiled}
    new = [fp for fp in cut if torchexec._seg_argname(fp) not in known]
    seg_d0 = exe.n_seg_discoveries
    first = sess.sql(sql)
    assert exe.n_seg_discoveries - seg_d0 == len(new)
    replays, discoveries = exe.n_replays, exe.n_discoveries
    with replays_without_sync(exe):
        second = sess.sql(sql)
    assert (exe.n_replays, exe.n_discoveries, exe.n_seg_discoveries) == \
        (replays + 1, discoveries, seg_d0 + len(new))
    for table in (first, second):
        _agrees(state, name, table)
    cp = sess.compiled_plan(sql)
    assert cp.seg_fps == cut and len(cp.segs) == len(cut)
    assert cp.seg_alias == alias
    partner = SHARES.get(name)
    if partner is not None:
        assert len(new) < len(cut), f"{name} shares no segment"
        other = sess.compiled_plan(SQL[partner])
        shared = set(cp.seg_fps) & set(other.seg_fps)
        assert shared
        for fp in shared:
            assert cp.segs[cp.seg_fps.index(fp)] is \
                other.segs[other.seg_fps.index(fp)]


def test_a_dropped_shared_segment_rediscovers_its_parents(state):
    sess = state["port"]
    exe = sess.executor
    for name in ("query88", "query96"):
        sess.sql(SQL[name])     # compiled (when run alone)
    a, b = (sess.compiled_plan(SQL[n]) for n in ("query88", "query96"))
    (fp,) = set(a.seg_fps) & set(b.seg_fps)
    seg = a.segs[a.seg_fps.index(fp)]
    exe._drop_segment(seg.slot)
    g0, d0 = exe.n_guard_failures, exe.n_seg_discoveries
    with pytest.warns(UserWarning, match="rediscovering"):
        got = {n: sess.sql(SQL[n]) for n in ("query88", "query96")}
    # query88's rediscovery drops and rediscovers its segments (a guard
    # may have failed in any); query96's finds the shared one again
    assert (exe.n_guard_failures - g0, exe.n_seg_discoveries - d0) == \
        (2, len(a.seg_fps))
    a, b = (sess.compiled_plan(SQL[n]) for n in ("query88", "query96"))
    assert a.segs[a.seg_fps.index(fp)] is b.segs[b.seg_fps.index(fp)]
    assert a.segs[a.seg_fps.index(fp)] is not seg
    for name, table in got.items():
        _agrees(state, name, table)


def test_a_guard_failing_in_a_segment_rediscovers(state):
    sess = state["port"]
    exe = sess.executor
    sql = SQL["query39_part1"]
    sess.sql(sql)
    cp = sess.compiled_plan(sql)
    seg = cp.segs[0]
    caps = [i for i, r in enumerate(seg.record)
            if r[0] == "cap" and r[1] > 1]
    assert caps
    i = max(caps, key=lambda j: seg.record[j][1])
    seg.record[i] = ("cap", 1)
    g0, d0 = exe.n_guard_failures, exe.n_seg_discoveries
    with pytest.warns(UserWarning, match="rediscovering"):
        table = sess.sql(sql)
    assert (exe.n_guard_failures - g0, exe.n_seg_discoveries - d0) == (1, 1)
    assert seg not in sess.compiled_plan(sql).segs
    _agrees(state, "query39_part1", table)


def test_compile_records_round_trip_with_segments(state, tmp_path):
    sess = state["port"]
    names = ("query24_part1", "query24_part2", "query96")
    for name in names:
        sess.sql(SQL[name])
    path = str(tmp_path / "records.pkl")
    assert sess.save_compiled(path) >= len(names)
    with open(path, "rb") as f:
        data = pickle.load(f)
    assert data["\x00fmt"] == 3 and data["\x00segments"]
    fresh = Session(sess.catalog, device="cpu")
    assert fresh.preload_compiled(path) >= len(names)
    exe = fresh.executor
    for name in names:
        table = fresh.sql(SQL[name])
        _agrees(state, name, table)
        assert fresh.compiled_plan(SQL[name]).seg_fps == \
            sess.compiled_plan(SQL[name]).seg_fps
    assert (exe.n_discoveries, exe.n_seg_discoveries) == (0, 0)
    a, b = (fresh.compiled_plan(SQL[n]) for n in names[:2])
    (fp,) = set(a.seg_fps) & set(b.seg_fps)
    assert a.segs[a.seg_fps.index(fp)] is b.segs[b.seg_fps.index(fp)]
    # the format before segments: nothing is read, the keys discover
    old = str(tmp_path / "format2.pkl")
    with open(old, "wb") as f:
        pickle.dump({"\x00fmt": 2, "select 1": ()}, f)
    assert Session(sess.catalog, device="cpu").preload_compiled(old) == 0
