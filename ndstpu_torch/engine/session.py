"""Engine session: SQL text in, result table out (ndstpu.engine.session).

``Session.sql`` runs the JAX package's main path: it keys each query by
its normalized text, plans it once through the text-keyed plan cache
(Planner + optimize), parameter-lifts the plan
(:func:`ndstpu_torch.analysis.canon.canonicalize`) and runs the
parameterized plan through :class:`CompilingExecutor.execute_cached`
under its canonical key, with this rendering's literals as the binding:
the key's first run discovers, every later run — and every rendering of
the template that shares the key — replays (on CUDA, one captured
graph).  DDL/DML, views, snapshot pins, spine splicing and the SPMD
backends are later slices.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List

from ndstpu_torch import faults, obs
from ndstpu_torch.engine import columnar, planner as pl
from ndstpu_torch.engine.latch import KeyedLatch
from ndstpu_torch.engine.optimizer import optimize
from ndstpu_torch.engine.sql import ast, normalize_sql_key, parse_statement
from ndstpu_torch.engine.torchexec import (
    GROUPBY_DEFAULT,
    CompilingExecutor,
    resolve_device,
)


class Session:
    """Holds the catalog and runs queries on one device:
    ``cuda`` unless ``device`` names another (``"cpu"`` for the tests).
    ``groupby`` picks the group-by strategy (torchexec.GROUPBY_MODES).

    Threads may share a session: the plan cache plans each text once
    (a per-key latch), and execution is serialized (the executor keeps
    per-query state; one device runs one graph at a time)."""

    def __init__(self, catalog, device=None,
                 groupby: str = GROUPBY_DEFAULT):
        self.catalog = catalog
        self.device = resolve_device(device)
        # the executor accessor (jaxexec's Session._jax_executor): one per
        # session, keeping the device tables and the compiled plans
        self.executor = CompilingExecutor(catalog, self.device,
                                          groupby=groupby)
        self._cache_lock = threading.RLock()
        self._exec_lock = threading.RLock()
        self._plan_latch = KeyedLatch()
        # normalized text -> (catalog versions, plan, display names,
        # CanonResult or None)
        self._plan_cache: Dict[str, tuple] = {}

    def fresh(self) -> "Session":
        """A new session over the same catalog and device that shares
        this one's device tables (the executor never writes them) and
        none of its plans, compiled plans or graphs: the power run's
        watchdog continues on one while an abandoned query still runs on
        this one."""
        new = Session(self.catalog, device=self.device,
                      groupby=self.executor.groupby_mode)
        new.executor.share_tables(self.executor)
        return new

    def sql(self, text: str) -> columnar.Table:
        """Execute one query; returns its result table on the host."""
        # the whole statement is execute_s; the cold-path work nested in
        # it (discovery, capture) carries its own compile_s bucket, which
        # the tracer's self-time accounting subtracts
        with obs.span("statement", cat="plan-node", bucket="execute_s",
                      device=str(self.device)):
            stmt = parse_statement(text)
            if not isinstance(stmt, ast.Query):
                raise NotImplementedError(
                    f"statement {type(stmt).__name__}: only queries are "
                    f"ported")
            norm = normalize_sql_key(text)
            plan, key, params, disp = self._run_args(stmt, norm)
            with self._exec_lock:
                faults.check("execute", key=norm)
                out = self.executor.execute_cached(plan, key, params=params,
                                                   sql=norm)
            return columnar.Table(dict(zip(disp, out.columns.values())))

    def _run_args(self, stmt: "ast.Query", norm: str):
        """What ``sql`` hands the executor for a query: ``(plan, key,
        binding, display names)``.  Under canonicalization (the
        shape-keyed compile cache) every rendering of a template shares
        one key, its literals bound; otherwise the plan runs under its
        normalized text with no binding."""
        plan, disp, canon = self._plan_cached(stmt, norm)
        if canon is not None:
            return canon.exec_plan, canon.cache_key, canon.binding, disp
        return plan, norm, None, disp

    def plan(self, text: str):
        """The optimized plan of one query and its output columns."""
        stmt = parse_statement(text)
        if not isinstance(stmt, ast.Query):
            raise ValueError("plan() expects a query")
        plan, cols, _disp = self._plan_fresh(stmt)
        return plan, cols

    def _plan_cached(self, stmt: "ast.Query", key: str):
        """Plan + optimize + canonicalize through the text-keyed plan
        cache: ``(plan, display names, CanonResult or None)``.  One slot
        a text, replaced when the catalog versions change; concurrent
        threads plan a text once (later arrivals wait on its latch)."""
        faults.check("plan", key=key)
        with self._plan_latch.holding(key):
            state = tuple(sorted(self.catalog.versions.items()))
            with self._cache_lock:
                ent = self._plan_cache.get(key)
            if ent is not None and ent[0] != state:
                ent = None
            obs.inc("engine.cache.plan.hit" if ent is not None
                    else "engine.cache.plan.miss")
            if ent is not None:
                return ent[1:]
            with obs.span("plan", cat="plan-node"):
                plan, _cols, disp = self._plan_fresh(stmt)
            canon = self._canonicalize(plan, key)
            with self._cache_lock:
                self._plan_cache[key] = (state, plan, disp, canon)
            return plan, disp, canon

    @staticmethod
    def _canonicalize(plan, key: str):
        """Parameter-lift an optimized plan for shape-keyed compile
        caching; None (→ text keying) when canonicalization fails, as in
        the JAX session: a wrong analyzer costs compiles, never
        answers."""
        from ndstpu_torch.analysis import canon
        try:
            return canon.canonicalize(plan, query=key)
        except Exception:  # noqa: BLE001 — the analyzer, never the data
            return None

    def _plan_fresh(self, stmt: "ast.Query"):
        planner = pl.Planner(self.catalog, {})
        plan, cols = planner.plan_query(stmt)
        # display names: strip alias qualifiers
        disp = self._dedupe(planner._display_names(cols))
        return optimize(plan, self.catalog), cols, disp

    @staticmethod
    def _dedupe(names: List[str]) -> List[str]:
        seen: Dict[str, int] = {}
        out = []
        for n in names:
            if n in seen:
                seen[n] += 1
                out.append(f"{n}_{seen[n]}")
            else:
                seen[n] = 0
                out.append(n)
        return out

    # -- compile-cache introspection and persistence -------------------------

    def canonical_key(self, text: str) -> str:
        """The key a query text runs under: its canonical plan key when
        canonicalization succeeds, its normalized text otherwise.  Two
        renderings of a template that differ only in bindable literals
        share it."""
        norm = normalize_sql_key(text)
        try:
            stmt = parse_statement(text)
            if not isinstance(stmt, ast.Query):
                return norm
            _plan, _disp, canon = self._plan_cached(stmt, norm)
        except Exception:  # noqa: BLE001 — unparseable/unplannable text
            return norm
        return canon.cache_key if canon is not None else norm

    def compiled_plan(self, text: str):
        """The compiled plan a query text runs (or None): its canonical
        key's, under its binding's memo signature."""
        plan, key, params, _disp = self._run_args(
            parse_statement(text), normalize_sql_key(text))
        return self.executor.compiled(plan, key, params)

    def compiled_count(self) -> int:
        """Number of compiled plans this session holds."""
        return len(self.executor._compiled)

    def save_compiled(self, path: str) -> int:
        """Persist the compiled plans' size-plan records."""
        return self.executor.save_compile_records(path)

    def preload_compiled(self, path: str) -> int:
        """Preload size-plan records: a later ``sql`` of one of their
        texts skips discovery and captures (or on the CPU replays) at
        once.  Records re-plan their SQL and re-canonicalize, so they
        register under the key a fresh rendering probes."""
        def plan_for_sql(sql):
            try:
                stmt = parse_statement(sql)
                if not isinstance(stmt, ast.Query):
                    return None
                key = normalize_sql_key(sql)
                plan, _disp, canon = self._plan_cached(stmt, key)
            except Exception:  # noqa: BLE001
                return None
            if canon is not None:
                return canon.exec_plan, canon.cache_key
            return plan, key

        if not os.path.exists(path):
            return 0
        return self.executor.load_compile_records(path, plan_for_sql)
