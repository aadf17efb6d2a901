"""A query its watchdog abandons stops at its next cancellation point.

The power run's and the server's watchdogs cannot stop a hung query's
thread; they set the event that ``session.abandonable`` runs it under.
Once the hang ends, the thread raises ``QueryAbandoned`` before it
discovers or replays anything, so it counts nothing into the process's
counters behind the fresh session's back.  A thread whose event stays
clear answers as usual.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import threading

import numpy as np
import pytest

from ndstpu_torch import faults, obs
from ndstpu_torch.engine import columnar
from ndstpu_torch.engine.session import QueryAbandoned, Session, abandonable
from ndstpu_torch.io.catalog import Catalog


@pytest.fixture
def session():
    cat = Catalog()
    cat.register("t", columnar.Table({
        "a": columnar.Column(np.arange(10, dtype=np.int32), columnar.INT32,
                             None)}))
    return Session(cat, device="cpu")


def _run_hung(session, abandon: bool) -> dict:
    got, ev = {}, threading.Event()

    def work():
        try:
            with abandonable(ev):
                got["table"] = session.sql("SELECT min(a) AS m FROM t")
        except Exception as e:  # noqa: BLE001
            got["err"] = e

    obs.reset(enabled=True)
    faults.install("execute:hang:1:times=1:hang=1")
    try:
        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(0.2)
        assert th.is_alive()            # hung at the execute site
        if abandon:
            ev.set()
        th.join(10.0)
        assert not th.is_alive()
    finally:
        faults.uninstall()
    got["counters"] = obs.counters_snapshot()
    return got


@pytest.mark.parametrize("abandon", [True, False], ids=["set", "clear"])
def test_abandoned_query_stops_before_it_discovers(session, abandon):
    got = _run_hung(session, abandon)
    if abandon:
        assert isinstance(got.get("err"), QueryAbandoned)
        assert "engine.discoveries" not in got["counters"]
        assert session.compiled_count() == 0
    else:
        assert "err" not in got
        assert got["table"].to_rows() == [(0,)]
        assert got["counters"]["engine.discoveries"] == 1


def test_set_event_stops_the_next_query_before_it_plans(session):
    ev = threading.Event()
    ev.set()
    with abandonable(ev), pytest.raises(QueryAbandoned):
        session.sql("SELECT max(a) AS m FROM t")
    # the event belongs to the block: outside it the session answers
    assert session.sql("SELECT max(a) AS m FROM t").to_rows() == [(9,)]
