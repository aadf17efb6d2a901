"""Serve robustness control plane: journal, warm restart, drain, SLO.

A copy of the JAX package's ``ndstpu/serve/lifecycle.py`` over the port's
session.

**Journal** (``serve_journal.jsonl``, RUN_STATE idiom via
``atomic.append_jsonl``): ``server-start`` on boot, one ``query``
record per *successful* request (SQL text + canonical fingerprint),
``clean-shutdown`` at the end of a graceful drain.  Torn trailing
lines from a SIGKILL are tolerated by ``read_jsonl``.

**Warm restart**: on boot with an existing journal, the server (1)
preloads the compile-record set the previous incarnation persisted
incrementally (``Session.preload_compiled`` — records register under
canonical keys), (2) replays the journaled SQL texts through
``Session.canonical_key`` so the plan cache re-warms, and only then
(3) flips readiness.  A previously-seen plan shape served by the
restarted process runs with ZERO new discoveries: the counter
``engine.discoveries`` (and ``engine.cache.compiled.miss``) stays flat.
On a card a preloaded record still captures its CUDA graph at its first
replay (``engine.jit_builds`` counts the capture), as in a preloaded
power run: a record keeps the size plan, not the graph.

**Drain** (SIGTERM): stop admission (new SQL answers ``draining``),
let in-flight queries finish (a hung one is abandoned via the power
watchdog idiom, never blocking shutdown), flush ledger + compile
records + ``SLO.json``, then journal the clean-shutdown marker.

**SLO**: per-tenant latency reservoirs export p50/p95/p99 to
``SLO.json`` (a runtime artifact like RUN_STATE.json, never
committed).
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Dict, List, Optional

from ndstpu_torch import obs
from ndstpu_torch.io import atomic

JOURNAL_START = "server-start"
JOURNAL_QUERY = "query"
JOURNAL_CLEAN = "clean-shutdown"

SLO_ARTIFACT = "ndstpu-slo-v1"


class ServeJournal:
    """Append-only lifecycle journal (one JSON record per line)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        # dedup replay work: a SQL text journaled once is enough
        self._seen: set = set()

    def records(self) -> List[dict]:
        return atomic.read_jsonl(self.path)

    def mark_start(self, meta: Optional[dict] = None) -> None:
        rec = {"event": JOURNAL_START, "t": round(time.time(), 3)}
        rec.update(meta or {})
        with self._lock:
            atomic.append_jsonl(self.path, rec)

    def mark_query(self, name: str, sql: str,
                   canon_key: Optional[str] = None) -> None:
        with self._lock:
            if sql in self._seen:
                return
            self._seen.add(sql)
            atomic.append_jsonl(self.path, {
                "event": JOURNAL_QUERY, "name": name, "sql": sql,
                "canon_key": canon_key, "t": round(time.time(), 3)})

    def mark_clean_shutdown(self, meta: Optional[dict] = None) -> None:
        rec = {"event": JOURNAL_CLEAN, "t": round(time.time(), 3)}
        rec.update(meta or {})
        with self._lock:
            atomic.append_jsonl(self.path, rec)

    def replay_state(self) -> dict:
        """What a restart inherits: the journaled SQL set and whether
        the previous incarnation shut down cleanly (the last lifecycle
        event decides — a start after a clean marker means a crash)."""
        sqls: List[dict] = []
        seen: set = set()
        clean = True  # no journal at all = first boot, trivially clean
        for rec in self.records():
            ev = rec.get("event")
            if ev == JOURNAL_START:
                clean = False
            elif ev == JOURNAL_CLEAN:
                clean = True
            elif ev == JOURNAL_QUERY and rec.get("sql") and \
                    rec["sql"] not in seen:
                seen.add(rec["sql"])
                sqls.append(rec)
        self._seen |= seen
        return {"sqls": sqls, "clean": clean}


def warm_restart(session, journal: ServeJournal,
                 compile_records: Optional[str] = None,
                 out=print) -> dict:
    """Replay the journal + compile records into a fresh session BEFORE
    the server flips readiness.  Defects degrade to a cold start —
    warmth is an optimization, recovery must never fail the boot."""
    state = journal.replay_state()
    preloaded = 0
    if compile_records:
        try:
            preloaded = session.preload_compiled(compile_records)
        except Exception as e:  # noqa: BLE001
            out(f"WARNING: serve compile records not preloaded: {e}")
    replayed = 0
    for rec in state["sqls"]:
        try:
            # canonical_key plans the text (plan cache + canonical
            # registration) without executing it — AOT warmth for the
            # fingerprint set the previous incarnation served
            session.canonical_key(rec["sql"])
            replayed += 1
        except Exception as e:  # noqa: BLE001
            out(f"WARNING: journal replay skipped {rec.get('name')}: "
                f"{e}")
    obs.inc("serve.restart.preloaded_records", preloaded)
    obs.inc("serve.restart.replayed_sql", replayed)
    if not state["clean"]:
        obs.inc("serve.restart.after_crash")
    return {"preloaded": preloaded, "replayed": replayed,
            "clean_shutdown": state["clean"],
            "journaled": len(state["sqls"])}


class SLOTracker:
    """Per-tenant latency reservoirs -> p50/p95/p99 in ``SLO.json``."""

    def __init__(self, max_samples_per_tenant: int = 4096):
        self.max_samples = max_samples_per_tenant
        self._lock = threading.Lock()
        self._lat_ms: Dict[str, List[float]] = {}
        self._counts: Dict[str, Dict[str, int]] = {}
        self.started_epoch_s = round(time.time(), 3)

    def record(self, tenant: str, wall_s: float,
               outcome: str = "ok") -> None:
        with self._lock:
            c = self._counts.setdefault(
                tenant, {"ok": 0, "error": 0, "overloaded": 0,
                         "rejected": 0})
            c[outcome] = c.get(outcome, 0) + 1
            if outcome == "ok":
                lats = self._lat_ms.setdefault(tenant, [])
                lats.append(wall_s * 1000.0)
                if len(lats) > self.max_samples:
                    # keep the newest window; SLOs describe current
                    # behavior, not the whole process lifetime
                    del lats[:len(lats) - self.max_samples]

    @staticmethod
    def _pct(sorted_ms: List[float], p: float) -> float:
        if not sorted_ms:
            return 0.0
        idx = min(len(sorted_ms) - 1,
                  max(0, int(round(p / 100.0 * (len(sorted_ms) - 1)))))
        return sorted_ms[idx]

    def snapshot(self) -> dict:
        with self._lock:
            tenants = {}
            for tenant, counts in sorted(self._counts.items()):
                lats = sorted(self._lat_ms.get(tenant, ()))
                tenants[tenant] = {
                    "count": sum(counts.values()),
                    "ok": counts.get("ok", 0),
                    "error": counts.get("error", 0),
                    "overloaded": counts.get("overloaded", 0),
                    "rejected": counts.get("rejected", 0),
                    "p50_ms": round(self._pct(lats, 50), 3),
                    "p95_ms": round(self._pct(lats, 95), 3),
                    "p99_ms": round(self._pct(lats, 99), 3),
                }
        return {"artifact": SLO_ARTIFACT,
                "window_started_epoch_s": self.started_epoch_s,
                "exported_epoch_s": round(time.time(), 3),
                "tenants": tenants}

    def export(self, path: str) -> dict:
        doc = self.snapshot()
        atomic.atomic_write_json(path, doc)
        return doc


def install_signal_handlers(server) -> None:
    """SIGTERM/SIGINT -> graceful drain.  The handler only flags; the
    drain itself runs on a dedicated thread so signal context stays
    async-signal-safe-ish and a hung in-flight query cannot wedge the
    handler (the watchdog abandons it)."""
    def _handler(signum, frame):  # noqa: ARG001
        threading.Thread(target=server.drain,
                         kwargs={"reason": signal.Signals(signum).name},
                         name="serve-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
