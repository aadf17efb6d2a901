"""Cross-query common-spine analysis (multi-query optimization, NDS5xx).

The scheduler already dedups *identical* canonical plans across streams;
this pass finds shared *sub*-plans.  Most corpus parts walk the same
fact-scan + dimension-join spines (date_dim filters, store_sales joins),
and a subtree-level canonical fingerprint (``canon.canonicalize_subtrees``
— slot numbering restarts per subtree, so a shared spine under different
enclosing plans still collapses) makes that overlap visible:

* :func:`subtree_sites` classifies one plan's candidate spines —
  scan+filter stacks, join build sides, pre-aggregation subtrees — as
  *shareable* (runtime-spliceable) or not, with a reason,
* :func:`build_index` sweeps many queries' sites into the global
  subtree→queries index and emits the NDS5xx diagnostics:

  ======= ==========================================================
  NDS501  shared-spine candidate (recurs across parts, spliceable)
  NDS502  param-divergent spine (same shape, different literal values)
  NDS503  nondeterministic/row-order-sensitive subtree (sort/window/
          limit inside) — excluded from materialization
  NDS504  estimated bytes exceed the memory-planner budget
  ======= ==========================================================

* :func:`index_to_doc` renders the deterministic MQO_AUDIT payload that
  ``scripts/mqo_audit.py`` writes and CI gates against
  ``docs/mqo_audit_baseline.json``.

The runtime consumer (``engine/spine.py`` + ``Session._splice_spines``)
imports the same :func:`subtree_sites` / :func:`eligible_sites` /
:func:`value_key` helpers, so what the analyzer flags and what the
spine-materialization cache splices cannot drift.

Import-hygienic like the rest of ``ndstpu_torch.analysis``: numpy only, no
jax — :func:`spine_budget_bytes` deliberately reads env/defaults instead
of calling ``memplan.device_budget_bytes()`` (which probes a backend).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ndstpu_torch.engine import columnar, memplan, plan as lp
from ndstpu_torch.analysis.canon import SubtreeCanon, canonicalize_subtrees
from ndstpu_torch.analysis.diagnostics import Diagnostic
from ndstpu_torch.analysis.typecheck import infer_plan

__all__ = ["SpineSite", "subtree_sites", "eligible_sites", "value_key",
           "build_index", "index_to_doc", "spine_budget_bytes",
           "SF1_ROWS"]

#: TPC-DS per-table row counts at scale factor 1 (dsdgen table of
#: contents; date/time dims are SF-invariant).  Drives the NDS504
#: estimated-bytes check: est rows for a spine = the largest scanned
#: base table, scaled by the sweep's scale factor for the fact tables.
SF1_ROWS: Dict[str, int] = {
    "call_center": 6,
    "catalog_page": 11_718,
    "catalog_returns": 144_067,
    "catalog_sales": 1_441_548,
    "customer": 100_000,
    "customer_address": 50_000,
    "customer_demographics": 1_920_800,
    "date_dim": 73_049,
    "household_demographics": 7_200,
    "income_band": 20,
    "inventory": 11_745_000,
    "item": 18_000,
    "promotion": 300,
    "reason": 35,
    "ship_mode": 20,
    "store": 12,
    "store_returns": 287_514,
    "store_sales": 2_880_404,
    "time_dim": 86_400,
    "warehouse": 5,
    "web_page": 60,
    "web_returns": 71_763,
    "web_sales": 719_384,
    "web_site": 30,
}

#: tables whose row counts scale with the scale factor (facts + the
#: customer cluster); dimensions stay near-constant
_SCALED_TABLES = {
    "catalog_returns", "catalog_sales", "customer", "customer_address",
    "inventory", "store_returns", "store_sales", "web_returns",
    "web_sales",
}

#: subtree root types worth sharing (a bare Scan is already shared via
#: the warehouse; a bare Sort/Limit tail is per-query presentation)
_CANDIDATE_ROOTS = (lp.Filter, lp.Project, lp.Join, lp.Aggregate,
                    lp.Distinct)

#: nodes that make a subtree row-order-sensitive / tie-nondeterministic
_ORDER_SENSITIVE = (lp.Sort, lp.Window, lp.Limit)


def spine_budget_bytes() -> Tuple[int, str]:
    """Byte budget for materialized spines and where it came from.

    ``NDSTPU_SPINE_BUDGET_BYTES`` wins (tests / operator pin); then
    ``NDSTPU_HBM_BYTES`` x memplan.SAFETY; then the memplan default x
    SAFETY.  Never probes a device — this must run in the jax-free
    analysis context (CI lint, doc tooling)."""
    env = os.environ.get("NDSTPU_SPINE_BUDGET_BYTES")
    if env:
        return max(int(env), 1), "env"
    hbm = os.environ.get("NDSTPU_HBM_BYTES")
    if hbm:
        return max(int(int(hbm) * memplan.SAFETY), 1), "hbm"
    return int(memplan.DEFAULT_BUDGET_BYTES * memplan.SAFETY), "default"


# ---------------------------------------------------------------------------
# per-plan site classification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpineSite:
    """One candidate spine occurrence inside one plan."""

    path: str                  # canon-convention path from the plan root
    kind: str                  # subtree root node type name
    size: int                  # plan nodes in the subtree
    fingerprint: str           # subtree canonical fingerprint
    value_key: str             # fingerprint + hash over ALL slot values
    shareable: bool
    reason: str                # "" when shareable, else why not
    node: lp.Plan = dataclasses.field(compare=False, hash=False,
                                      default=None)
    scans: Tuple[str, ...] = ()          # base tables read, sorted
    est_rows: Optional[int] = None       # NDS504 row model (None=unknown)
    est_row_bytes: Optional[int] = None  # memplan row-width model

    @property
    def est_bytes(self) -> Optional[int]:
        if self.est_rows is None or self.est_row_bytes is None:
            return None
        return self.est_rows * self.est_row_bytes


def value_key(canon) -> str:
    """Runtime materialization-cache key: the subtree fingerprint plus a
    hash over ALL slot values (bind and shape alike — a spine serving a
    different literal is a different materialized table)."""
    vh = hashlib.sha256(repr(canon.values).encode()).hexdigest()[:16]
    return f"{canon.fingerprint}:{vh}"


def _has_work(node: lp.Plan) -> bool:
    for n in node.walk():
        if isinstance(n, (lp.Filter, lp.Join, lp.Aggregate, lp.Distinct)):
            return True
        if isinstance(n, lp.Scan) and n.predicate is not None:
            return True
    return False


def _estimate(node: lp.Plan, tables, query: str, scans: Tuple[str, ...],
              scale_factor: Optional[float]
              ) -> Tuple[Optional[int], Optional[int]]:
    """(est_rows, est_row_bytes) for the subtree's output, or Nones.

    Rows: the largest scanned base table bounds the spine's output for
    the shareable shapes (filters/joins/pre-aggregations never exceed
    the driving fact here).  Width: the inferred output schema through
    memplan's row-width model (strings count their int32 dict-code
    width, the form a cached device table holds)."""
    rows = None
    for t in scans:
        base = SF1_ROWS.get(t)
        if base is None:
            continue
        if scale_factor and t in _SCALED_TABLES:
            base = int(base * scale_factor)
        rows = base if rows is None else max(rows, base)
    if rows is None:
        return None, None
    try:
        schema, _ = infer_plan(node, tables, query)
    except Exception:
        return rows, None
    if not schema.known:
        return rows, None
    sizes = []
    for _, ct in schema.cols:
        if ct.ctype is None:
            return rows, None
        sizes.append(np.dtype(columnar.numpy_dtype(ct.ctype)).itemsize)
    return rows, memplan.row_bytes(sizes)


def subtree_sites(plan: lp.Plan, tables: Optional[Dict[str, object]] = None,
                  query: str = "",
                  scale_factor: Optional[float] = None,
                  subtrees: Optional[List[SubtreeCanon]] = None
                  ) -> List[SpineSite]:
    """Classify every candidate spine in one optimized plan, root-first.

    A subtree is a *candidate* when its root is a Filter/Project/Join/
    Aggregate/Distinct that is not the plan root, it reads at least one
    base table, and it does real work (a filter, join, aggregate, or
    distinct — a bare column projection shares nothing worth caching).
    A candidate is *shareable* unless it contains an order-sensitive
    node (NDS503) or failed to canonicalize."""
    if subtrees is None:
        subtrees = canonicalize_subtrees(plan, tables, query)
    sites: List[SpineSite] = []
    for sub in subtrees:
        if "/" not in sub.path:        # the plan root shares via the
            continue                   # whole-plan canonical cache
        if not isinstance(sub.node, _CANDIDATE_ROOTS):
            continue
        scans = tuple(sorted({n.table for n in sub.node.walk()
                              if isinstance(n, lp.Scan)}))
        if not scans or not _has_work(sub.node):
            continue
        if sub.canon is None:
            sites.append(SpineSite(
                path=sub.path, kind=sub.kind, size=sub.size,
                fingerprint="", value_key="", shareable=False,
                reason="canonicalization failed", node=sub.node,
                scans=scans))
            continue
        order = any(isinstance(n, _ORDER_SENSITIVE)
                    for n in sub.node.walk())
        est_rows, est_rb = _estimate(sub.node, tables, query, scans,
                                     scale_factor)
        sites.append(SpineSite(
            path=sub.path, kind=sub.kind, size=sub.size,
            fingerprint=sub.canon.fingerprint,
            value_key=value_key(sub.canon),
            shareable=not order,
            reason="order-sensitive (sort/window/limit inside)"
                   if order else "",
            node=sub.node, scans=scans,
            est_rows=est_rows, est_row_bytes=est_rb))
    return sites


def eligible_sites(sites: List[SpineSite]) -> List[SpineSite]:
    """Outermost non-overlapping shareable sites, in root-first order —
    the set the runtime splicer actually materializes (splicing a spine
    subsumes everything underneath it)."""
    kept: List[SpineSite] = []
    for s in sites:
        if not s.shareable:
            continue
        if any(s.path.startswith(k.path + "/") for k in kept):
            continue
        kept.append(s)
    return kept


# ---------------------------------------------------------------------------
# cross-corpus index
# ---------------------------------------------------------------------------


def build_index(per_query_sites: Dict[str, List[SpineSite]],
                budget_bytes: Optional[int] = None
                ) -> Tuple[Dict[str, dict], List[Diagnostic]]:
    """Fold per-query sites into the global fingerprint index and emit
    the NDS5xx diagnostics.

    Diagnostics are bounded to one per (query, fingerprint-class): the
    first site path in a query anchors the finding even when the spine
    recurs inside that one plan.  Only fingerprints seen in >= 2 distinct
    queries diagnose at all, so a subset sweep's diagnostic set is a
    subset of the full-corpus baseline (monotone gating)."""
    if budget_bytes is None:
        budget_bytes, _ = spine_budget_bytes()
    index: Dict[str, dict] = {}
    for q in sorted(per_query_sites):
        for s in per_query_sites[q]:
            if not s.fingerprint:
                continue
            rec = index.setdefault(s.fingerprint, {
                "fingerprint": s.fingerprint, "kind": s.kind,
                "size": s.size, "queries": {}, "value_keys": set(),
                "scans": set(), "shareable": s.shareable,
                "reason": s.reason, "est_bytes": None,
            })
            rec["queries"].setdefault(q, s.path)
            rec["value_keys"].add(s.value_key)
            rec["scans"].update(s.scans)
            rec["shareable"] = rec["shareable"] and s.shareable
            if s.reason and not rec["reason"]:
                rec["reason"] = s.reason
            if s.est_bytes is not None:
                rec["est_bytes"] = max(rec["est_bytes"] or 0, s.est_bytes)

    diags: List[Diagnostic] = []
    for fp in sorted(index):
        rec = index[fp]
        if len(rec["queries"]) < 2:
            continue
        qlist = ", ".join(sorted(rec["queries"])[:6])
        for q in sorted(rec["queries"]):
            path = rec["queries"][q]
            if not rec["shareable"]:
                diags.append(Diagnostic(
                    code="NDS503",
                    message=f"subtree {fp} ({rec['kind']}, "
                            f"{len(rec['queries'])} queries) is "
                            f"order-sensitive; excluded from spine "
                            f"materialization",
                    path=path, query=q))
                continue
            diags.append(Diagnostic(
                code="NDS501",
                message=f"spine {fp} ({rec['kind']} over "
                        f"{'/'.join(sorted(rec['scans']))}) shared by "
                        f"{len(rec['queries'])} queries: {qlist}",
                path=path, query=q))
            if len(rec["value_keys"]) > 1:
                diags.append(Diagnostic(
                    code="NDS502",
                    message=f"spine {fp} binds "
                            f"{len(rec['value_keys'])} distinct value "
                            f"sets across its occurrences",
                    path=path, query=q))
            if rec["est_bytes"] is not None and \
                    rec["est_bytes"] > budget_bytes:
                diags.append(Diagnostic(
                    code="NDS504",
                    message=f"spine {fp} estimated "
                            f"{rec['est_bytes']} B exceeds the "
                            f"{budget_bytes} B materialization budget",
                    path=path, query=q))
    return index, diags


def index_to_doc(index: Dict[str, dict],
                 budget_bytes: Optional[int] = None) -> dict:
    """Deterministic JSON payload for MQO_AUDIT.json: the shared-spine
    table (sorted by sharing degree then fingerprint) plus summary
    counts the CI gate asserts on."""
    if budget_bytes is None:
        budget_bytes, _ = spine_budget_bytes()
    shared = []
    for fp, rec in index.items():
        if len(rec["queries"]) < 2:
            continue
        shared.append({
            "fingerprint": fp,
            "kind": rec["kind"],
            "size": rec["size"],
            "queries": sorted(rec["queries"]),
            "n_queries": len(rec["queries"]),
            "n_value_sets": len(rec["value_keys"]),
            "scans": sorted(rec["scans"]),
            "shareable": rec["shareable"],
            "reason": rec["reason"],
            "est_bytes": rec["est_bytes"],
            "over_budget": (rec["est_bytes"] is not None and
                            rec["est_bytes"] > budget_bytes),
        })
    shared.sort(key=lambda r: (-r["n_queries"], r["fingerprint"]))
    candidates = [r for r in shared if r["shareable"]]
    return {
        "budget_bytes": budget_bytes,
        "subtrees_indexed": len(index),
        "shared_spines": shared,
        "summary": {
            "shared": len(shared),
            "shared_spine_candidates": len(candidates),
            "param_divergent": sum(1 for r in candidates
                                   if r["n_value_sets"] > 1),
            "order_sensitive": sum(1 for r in shared
                                   if not r["shareable"]),
            "over_budget": sum(1 for r in shared if r["over_budget"]),
        },
    }
