"""Engine session: SQL text in, result table out (ndstpu.engine.session).

``Session.sql`` parses one query, plans it (Planner + optimize) and runs
the plan on the device through :class:`TorchExecutor`.  This slice ports
the query path only: DDL/DML, the plan cache, snapshot pins, canonical
plan keys, spine splicing and the SPMD backends are later slices.
"""

from __future__ import annotations

from typing import Dict, List

from ndstpu_torch.engine import columnar, planner as pl
from ndstpu_torch.engine.optimizer import optimize
from ndstpu_torch.engine.sql import ast, parse_statement
from ndstpu_torch.engine.torchexec import (
    GROUPBY_DEFAULT,
    TorchExecutor,
    resolve_device,
)


class Session:
    """Holds the catalog and runs queries on one device:
    ``cuda`` unless ``device`` names another (``"cpu"`` for the tests).
    ``groupby`` picks the group-by strategy (torchexec.GROUPBY_MODES)."""

    def __init__(self, catalog, device=None,
                 groupby: str = GROUPBY_DEFAULT):
        self.catalog = catalog
        self.device = resolve_device(device)
        self.executor = TorchExecutor(catalog, self.device, groupby=groupby)

    def sql(self, text: str) -> columnar.Table:
        """Execute one query; returns its result table on the host."""
        stmt = parse_statement(text)
        if not isinstance(stmt, ast.Query):
            raise NotImplementedError(
                f"statement {type(stmt).__name__}: only queries are ported")
        plan, _cols, disp = self._plan_fresh(stmt)
        out = self.executor.execute_to_host(plan)
        return columnar.Table(dict(zip(disp, out.columns.values())))

    def plan(self, text: str):
        """The optimized plan of one query and its output columns."""
        stmt = parse_statement(text)
        if not isinstance(stmt, ast.Query):
            raise ValueError("plan() expects a query")
        plan, cols, _disp = self._plan_fresh(stmt)
        return plan, cols

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
