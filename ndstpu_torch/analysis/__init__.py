"""Static plan analysis: the port's copy of ``ndstpu.analysis`` — schema
inference (:mod:`.typecheck`, NDS1xx), the lowering audit
(:mod:`.lowering`, NDS2xx and NDS3xx), plan canonicalization
(:mod:`.canon`, NDS4xx), common spines (:mod:`.spines`, NDS5xx) and the
cost model (:mod:`.cost`, NDS6xx), with their diagnostics
(:mod:`.diagnostics`), over the schema of :mod:`ndstpu_torch.schema`.  No
data is read and nothing runs on a device.

Typical use (the power run's ``--static_check``)::

    from ndstpu_torch import analysis
    res = analysis.analyze_sql(sess, name, sql, scale_factor=1.0)
    res.verdict            # "device" | "fallback"
    res.diagnostics        # typing + lowering + SPMD findings
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ndstpu_torch import schema as nds_schema
from ndstpu_torch.analysis import (canon, cost, diagnostics, lowering,
                                   spines, typecheck)
from ndstpu_torch.analysis.canon import CanonResult, canonicalize
from ndstpu_torch.analysis.diagnostics import Diagnostic
from ndstpu_torch.analysis.lowering import audit_plan
from ndstpu_torch.analysis.typecheck import infer_plan
from ndstpu_torch.engine import columnar


def schema_tables(use_decimal: bool = True) -> Dict[str, object]:
    """All table schemas (source + maintenance views' bases) by name."""
    tables = dict(nds_schema.get_schemas(use_decimal=use_decimal))
    tables.update(nds_schema.get_maintenance_schemas(
        use_decimal=use_decimal))
    return tables


def schema_catalog(use_decimal: bool = True):
    """Zero-row engine catalog over the full TPC-DS schema — enough for
    ``Session.plan()`` (parse → plan → optimize) without any warehouse."""
    from ndstpu_torch.io.catalog import Catalog

    cat = Catalog()
    for name, ts in schema_tables(use_decimal=use_decimal).items():
        cols = {}
        for spec in ts.columns:
            dt = columnar.numpy_dtype(spec.dtype)
            cols[spec.name] = columnar.Column(
                np.empty(0, dtype=dt), spec.dtype,
                valid=None,
                dictionary=(np.empty(0, dtype=object)
                            if spec.dtype.kind == "string" else None))
        cat.register(name, columnar.Table(cols))
    return cat


@dataclasses.dataclass
class AnalysisResult:
    """Combined static analysis of one query part."""

    query: str
    verdict: str                      # "device" | "fallback"
    diagnostics: List[Diagnostic]     # NDS1xx..NDS4xx, sorted
    schema: typecheck.Schema
    canon: Optional[CanonResult] = None   # plan-shape canonicalization
    spine_sites: Optional[List["spines.SpineSite"]] = None  # NDS5xx pass
    cost_report: Optional["cost.CostReport"] = None  # NDS6xx pass

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def fallback_codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics
                       if d.severity == "error" and
                       "/subquery[" not in d.path})


def analyze_plan(plan, tables: Optional[Dict[str, object]] = None,
                 query: str = "",
                 scale_factor: Optional[float] = None,
                 spmd: bool = True,
                 spine_pass: bool = False,
                 cost_pass: bool = False) -> AnalysisResult:
    """Run schema inference (NDS1xx) + lowerability audit (NDS2xx/3xx)
    over an optimized logical plan.  ``spine_pass=True`` also classifies
    the plan's candidate common spines (NDS5xx inputs — the per-query
    half of :func:`spines.build_index`); ``cost_pass=True`` runs the
    static cost model (NDS6xx) and attaches its :class:`cost.CostReport`
    with the NDS6xx findings merged into ``diagnostics``.  The default
    analysis stays cost-free."""
    tables = tables if tables is not None else schema_tables()
    out_schema, type_diags = infer_plan(plan, tables, query=query,
                                        scale_factor=scale_factor)
    audit = audit_plan(plan, tables, query=query,
                       scale_factor=scale_factor, spmd=spmd)
    cres = canonicalize(plan, tables=tables, query=query)
    sites = None
    if spine_pass:
        sites = spines.subtree_sites(plan, tables, query=query,
                                     scale_factor=scale_factor)
    cost_report = None
    cost_diags: List[Diagnostic] = []
    if cost_pass:
        cost_report = cost.audit_cost(plan, tables, query=query,
                                      scale_factor=scale_factor)
        cost_diags = cost_report.diagnostics
    diags = diagnostics.sort_diagnostics(
        type_diags + audit.diagnostics + list(cres.diagnostics)
        + cost_diags)
    return AnalysisResult(query=query, verdict=audit.verdict,
                          diagnostics=diags, schema=out_schema,
                          canon=cres, spine_sites=sites,
                          cost_report=cost_report)


def analyze_sql(session, query: str, sql: str,
                tables: Optional[Dict[str, object]] = None,
                scale_factor: Optional[float] = None,
                spmd: bool = True,
                spine_pass: bool = False,
                cost_pass: bool = False) -> AnalysisResult:
    """Plan one SQL statement through ``session`` (no data is touched by
    planning) and analyze it.  ``session`` is an
    ``ndstpu_torch.engine.session.Session`` — usually over
    :func:`schema_catalog` so no data is touched."""
    plan, _cols = session.plan(sql)
    return analyze_plan(plan, tables=tables, query=query,
                        scale_factor=scale_factor, spmd=spmd,
                        spine_pass=spine_pass, cost_pass=cost_pass)


__all__ = [
    "AnalysisResult", "CanonResult", "Diagnostic", "analyze_plan",
    "analyze_sql", "audit_plan", "canon", "canonicalize", "cost",
    "diagnostics", "infer_plan", "lowering", "schema_catalog",
    "schema_tables", "spines", "typecheck",
]
