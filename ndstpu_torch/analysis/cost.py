"""Static cost model: calibrated cardinality/byte estimation (NDS6xx).

Bottom-up row-count / byte / selectivity estimation over canonical
logical plans — the static half of the adaptive-execution story the
reference harness delegates wholesale to Spark AQE (ROADMAP item 4).
Everything runs over the ZERO-ROW schema catalog: SF-scaled base
cardinalities come from the dsdgen table of contents
(:data:`~ndstpu.analysis.spines.SF1_ROWS`), filter selectivities from
per-predicate-class heuristics, join fan-out from key-domain NDV
(surrogate-key columns resolve to their referenced dimension's row
count), and aggregate/distinct group counts from per-column NDV
heuristics.  Estimates are *calibrated* when a run ledger with
observed output cardinalities is available (:class:`Calibration`):
the per-query observed/estimated ratio recenters the estimate and the
cross-query ratio dispersion replaces the model's coarse confidence
band.

Diagnostic family (registered in analysis/diagnostics.py, swept by
scripts/cost_lint.py into COST_LINT.json / COST_LINT.md):

======= ==============================================================
NDS601  broadcast build side over the replication byte budget
        (memplan's device budget x :data:`BROADCAST_FRACTION`) — the
        cost model demotes it to the shuffle (all_to_all) path
NDS602  spill-risk working set: predicted per-device bytes
        (memplan's COMPUTE_MULT model + resident broadcast builds)
        exceed the device budget, so the plan must stream out-of-core
NDS603  exchange-heavy plan: predicted collective (all_to_all) bytes
        across shuffle-placed joins exceed the heavy-traffic threshold
NDS604  misestimate: static estimate vs ledger-observed output
        cardinality beyond :data:`MISESTIMATE_RATIO` (only emitted
        when calibration data is supplied — scripts/cost_lint.py
        --calibrate)
======= ==============================================================

The same :func:`choose_strategy` is consumed by BOTH the static
analyzer (lowering.py's upgraded NDS305 placement prediction) and the
runtime executor (parallel/dplan.py's :class:`CostAdvisor`), the
repo's usual single-source-of-truth idiom, so what the analyzer
predicts and what the runtime picks cannot drift.  ``NDSTPU_COST=0``
disables the runtime consumers (fixed structural rules, the
pre-cost-model behavior); the static lint is always available.

Import-hygienic like the rest of ``ndstpu.analysis``: numpy only, no
jax — :func:`cost_budget_bytes` reads env/defaults instead of probing
a device (mirror of spines.spine_budget_bytes).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ndstpu_torch.engine import columnar, memplan, plan as lp
from ndstpu_torch.engine import expr as ex
from ndstpu_torch.analysis.diagnostics import Diagnostic
from ndstpu_torch.analysis.spines import SF1_ROWS, _SCALED_TABLES
from ndstpu_torch.analysis.typecheck import TypeChecker, _child_path

__all__ = [
    "BROADCAST_FRACTION", "Calibration", "CostAdvisor", "CostEstimate",
    "CostModel", "CostReport", "Decision", "JoinPlacement",
    "MISESTIMATE_RATIO", "audit_cost", "choose_strategy",
    "cost_budget_bytes", "default_advisor", "enabled",
    "misestimate_diags", "observed_rows_from_ledger",
]

# -- tuning constants --------------------------------------------------------

#: fraction of the device budget a replicated (broadcast) build side may
#: occupy — the rest is the spine's streaming working set
BROADCAST_FRACTION = 0.25

#: predicted collective traffic above this fraction of the device
#: budget marks a plan exchange-heavy (NDS603)
EXCHANGE_HEAVY_FRACTION = 0.5

#: observed/estimated cardinality ratio beyond which NDS604 fires
MISESTIMATE_RATIO = 4.0

#: selectivity heuristics per predicate class (Selinger-style defaults;
#: equality resolves through column NDV when the column is recognized)
SEL_EQ = 0.05
SEL_RANGE = 1.0 / 3.0
SEL_NEQ = 0.9
SEL_LIKE = 0.15
SEL_NULL = 0.02
SEL_IN_PARAM = 0.2
SEL_SUBQUERY = 0.5
SEL_DEFAULT = 0.25

#: floor so stacked predicates never estimate to zero rows
SEL_FLOOR = 1e-4

#: anti-join survivor floor (a filterless anti join rarely drops all)
ANTI_FLOOR = 0.05

#: confidence band doubles per heuristic step, capped at 2**6 = 64x
MAX_BAND_STEPS = 6

#: per-column NDV by name fragment (TPC-DS date/demographic attributes)
_NAME_NDV = {
    "year": 200, "qoy": 4, "moy": 12, "dom": 31, "dow": 7,
    "quarter": 4, "month": 12, "gender": 2, "marital": 5,
    "education": 7, "state": 50, "county": 200, "country": 200,
}

#: surrogate-key suffix -> referenced dimension (key domain = that
#: table's row count; suffixes checked longest-first so e.g.
#: ``cdemo_sk`` never falls through to a shorter match)
_SK_REF_TABLES = {
    "item_sk": "item", "date_sk": "date_dim", "time_sk": "time_dim",
    "store_sk": "store", "customer_sk": "customer",
    "cdemo_sk": "customer_demographics",
    "hdemo_sk": "household_demographics",
    "addr_sk": "customer_address", "promo_sk": "promotion",
    "warehouse_sk": "warehouse", "web_site_sk": "web_site",
    "web_page_sk": "web_page", "call_center_sk": "call_center",
    "ship_mode_sk": "ship_mode", "reason_sk": "reason",
    "catalog_page_sk": "catalog_page", "income_band_sk": "income_band",
    "band_sk": "income_band",
}
_SK_SUFFIXES = sorted(_SK_REF_TABLES, key=len, reverse=True)


def enabled() -> bool:
    """Runtime kill switch: ``NDSTPU_COST=0`` restores the fixed
    structural rules in dplan/memplan (bit-identical results — the
    cost model only picks among semantically equivalent strategies)."""
    return os.environ.get("NDSTPU_COST", "1") != "0"


def cost_budget_bytes() -> Tuple[int, str]:
    """Per-device byte budget for the static passes and where it came
    from: ``NDSTPU_COST_BUDGET_BYTES`` (tests / operator pin), then
    ``NDSTPU_HBM_BYTES`` x memplan.SAFETY, then the memplan default x
    SAFETY.  Never probes a device — the analyzer must run jax-free."""
    env = os.environ.get("NDSTPU_COST_BUDGET_BYTES")
    if env:
        return max(int(env), 1), "env"
    hbm = os.environ.get("NDSTPU_HBM_BYTES")
    if hbm:
        return max(int(int(hbm) * memplan.SAFETY), 1), "hbm"
    return int(memplan.DEFAULT_BUDGET_BYTES * memplan.SAFETY), "default"


# ---------------------------------------------------------------------------
# estimates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Estimated output cardinality with a multiplicative confidence
    band: the model believes the true row count lies in
    ``[rows * lo, rows * hi]``."""

    rows: float
    row_bytes: Optional[int] = None
    lo: float = 1.0
    hi: float = 1.0

    @property
    def bytes(self) -> Optional[int]:
        if self.row_bytes is None:
            return None
        return int(self.rows * self.row_bytes)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-query observed/estimated output-cardinality ratios from the
    run ledger, plus their cross-query geometric dispersion — the
    replacement confidence band for calibrated queries."""

    ratios: Dict[str, float]
    dispersion: float = 2.0

    @classmethod
    def from_pairs(cls, estimated: Dict[str, float],
                   observed: Dict[str, float]) -> "Calibration":
        ratios = {}
        for q, est in estimated.items():
            obs = observed.get(q)
            if obs is None or est is None:
                continue
            ratios[q] = float(obs) / max(float(est), 1.0)
        if ratios:
            logs = [math.log(max(r, 1e-9)) for r in ratios.values()]
            mu = sum(logs) / len(logs)
            var = sum((v - mu) ** 2 for v in logs) / len(logs)
            disp = max(math.exp(math.sqrt(var)), 1.25)
        else:
            disp = 2.0
        return cls(ratios=ratios, dispersion=disp)

    @classmethod
    def from_ledger(cls, path: str,
                    estimated: Dict[str, float]) -> "Calibration":
        return cls.from_pairs(estimated, observed_rows_from_ledger(path))


def observed_rows_from_ledger(path: str) -> Dict[str, float]:
    """query -> last observed output row count, from ledger entries
    whose ``extra.result_rows`` was recorded by the harness (power.py
    annotates every successful query's result cardinality)."""
    out: Dict[str, float] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                rows = (e.get("extra") or {}).get("result_rows")
                if rows is None or not e.get("query"):
                    continue
                out[e["query"]] = float(rows)
    except OSError:
        pass
    return out


def misestimate_diags(estimated: Dict[str, CostEstimate],
                      observed: Dict[str, float],
                      threshold: float = MISESTIMATE_RATIO
                      ) -> List[Diagnostic]:
    """NDS604 per query whose observed output cardinality falls outside
    ``threshold`` x the static estimate (in either direction)."""
    diags: List[Diagnostic] = []
    for q in sorted(estimated):
        obs = observed.get(q)
        if obs is None:
            continue
        est = max(estimated[q].rows, 1.0)
        ratio = max(float(obs), 1.0) / est
        if ratio > threshold or ratio < 1.0 / threshold:
            diags.append(Diagnostic(
                code="NDS604",
                message=f"static estimate {est:.0f} rows vs observed "
                        f"{obs:.0f} (ratio {ratio:.2f} beyond "
                        f"{threshold:g}x): recalibrate or revisit the "
                        "selectivity class",
                path="Plan", query=q))
    return diags


class CostModel:
    """Bottom-up per-node cardinality/byte estimator over one plan.

    ``row_counts`` overrides the SF-scaled dsdgen base cardinalities
    with actual per-table counts (the runtime agreement tests hand in
    the loaded warehouse's sizes so static and runtime decisions are
    comparable on tiny fixtures)."""

    def __init__(self, tables: Dict[str, object],
                 scale_factor: Optional[float] = None,
                 row_counts: Optional[Dict[str, int]] = None,
                 calibration: Optional[Calibration] = None,
                 query: str = ""):
        self.tables = tables
        self.sf = scale_factor
        self.row_counts = dict(row_counts or {})
        self.calibration = calibration
        self.query = query
        self.tc = TypeChecker(tables, query=query,
                              scale_factor=scale_factor)
        self._memo: Dict[int, CostEstimate] = {}

    # -- base cardinalities --------------------------------------------------

    def base_rows(self, table: str) -> Optional[float]:
        if table in self.row_counts:
            return float(self.row_counts[table])
        base = SF1_ROWS.get(table)
        if base is None:
            return None
        if self.sf and table in _SCALED_TABLES:
            base = base * self.sf
        return float(base)

    # -- NDV heuristics ------------------------------------------------------

    def column_ndv(self, name: str, owner_rows: float) -> float:
        """Distinct-value estimate for one column: surrogate keys span
        their referenced dimension, recognized date/demographic
        attributes use fixed domains, everything else falls back to
        the square-root heuristic."""
        low = name.lower()
        for suf in _SK_SUFFIXES:
            if low.endswith(suf):
                ref = self.base_rows(_SK_REF_TABLES[suf])
                if ref is not None:
                    return max(ref, 1.0)
                break
        for frag, ndv in _NAME_NDV.items():
            if frag in low:
                return float(min(ndv, max(owner_rows, 1.0)))
        return float(min(max(math.sqrt(max(owner_rows, 1.0)), 2.0),
                         max(owner_rows, 1.0)))

    def _owner_rows(self, name: str, scans: List[lp.Scan]) -> float:
        """Unfiltered row count of the base table owning ``name``."""
        for s in scans:
            ts = self.tables.get(s.table)
            if ts is not None and any(c.name == name
                                      for c in ts.columns):
                r = self.base_rows(s.table)
                if r is not None:
                    return r
        best = 0.0
        for s in scans:
            r = self.base_rows(s.table)
            if r:
                best = max(best, r)
        return best or 1000.0

    def _expr_ndv(self, e: ex.Expr, scans: List[lp.Scan]) -> float:
        cols = [nd.name for nd in e.walk() if isinstance(nd, ex.ColumnRef)]
        if not cols:
            return 2.0
        return max(self.column_ndv(c, self._owner_rows(c, scans))
                   for c in cols)

    # -- selectivity ---------------------------------------------------------

    def selectivity(self, e: ex.Expr, scans: List[lp.Scan]) -> float:
        """Fraction of rows a boolean predicate keeps, by predicate
        class; AND multiplies (independence), OR is inclusion-
        exclusion, NOT complements."""
        return float(min(max(self._sel(e, scans), SEL_FLOOR), 1.0))

    def _sel(self, e: ex.Expr, scans: List[lp.Scan]) -> float:
        if isinstance(e, ex.BinOp):
            op = e.op
            if op == "and":
                return self._sel(e.left, scans) * self._sel(e.right, scans)
            if op == "or":
                s1 = self._sel(e.left, scans)
                s2 = self._sel(e.right, scans)
                return s1 + s2 - s1 * s2
            if op == "=":
                for side in (e.left, e.right):
                    if isinstance(side, ex.ColumnRef):
                        ndv = self.column_ndv(
                            side.name, self._owner_rows(side.name, scans))
                        return 1.0 / max(ndv, 1.0 / SEL_EQ)
                return SEL_EQ
            if op == "<>":
                return SEL_NEQ
            if op in ("<", "<=", ">", ">="):
                return SEL_RANGE
            return 1.0
        if isinstance(e, ex.UnaryOp):
            if e.op == "not":
                return 1.0 - self._sel(e.operand, scans)
            if e.op == "isnull":
                return SEL_NULL
            if e.op == "isnotnull":
                return 1.0 - SEL_NULL
            return 1.0
        if isinstance(e, ex.InList):
            ndv = self._expr_ndv(e.operand, scans)
            s = min(len(e.values) / max(ndv, 1.0), 0.5)
            return (1.0 - s) if e.negated else s
        if isinstance(e, ex.InParam):
            return SEL_IN_PARAM
        if isinstance(e, ex.Func) and e.name == "like":
            return SEL_LIKE
        if isinstance(e, ex.SubqueryExpr):
            return SEL_SUBQUERY
        if isinstance(e, ex.Literal):
            if e.value is True:
                return 1.0
            if e.value is False:
                return 0.0
            return 1.0
        if isinstance(e, ex.Case):
            return SEL_DEFAULT
        return SEL_DEFAULT

    # -- per-node estimation -------------------------------------------------

    def estimate(self, node: lp.Plan) -> CostEstimate:
        """Estimated output of ``node``'s subtree (memoized by node
        identity — plans are DAG-free trees)."""
        got = self._memo.get(id(node))
        if got is None:
            got = self._estimate(node)
            self._memo[id(node)] = got
        return got

    def estimate_query(self, plan: lp.Plan) -> CostEstimate:
        """Root estimate with the confidence band attached: the band
        doubles per heuristic step (filter/join/aggregate/distinct),
        capped at 2**:data:`MAX_BAND_STEPS`; a calibrated query instead
        recenters on the ledger-observed ratio and carries the
        calibration set's dispersion as its band."""
        est = self.estimate(plan)
        steps = sum(
            1 for n in plan.walk()
            if isinstance(n, (lp.Filter, lp.Join, lp.Aggregate,
                              lp.Distinct))
            or (isinstance(n, lp.Scan) and n.predicate is not None))
        k = min(steps, MAX_BAND_STEPS)
        rows, lo, hi = est.rows, 2.0 ** -k, 2.0 ** k
        if self.calibration is not None:
            ratio = self.calibration.ratios.get(self.query)
            if ratio is not None:
                d = self.calibration.dispersion
                rows, lo, hi = rows * ratio, 1.0 / d, d
        return CostEstimate(rows=rows, row_bytes=est.row_bytes,
                            lo=lo, hi=hi)

    def _row_bytes(self, node: lp.Plan) -> Optional[int]:
        """Output row width through memplan's model (string columns
        count their int32 dict-code width, the device-resident form)."""
        try:
            schema = self.tc.infer(node)
        except Exception:  # noqa: BLE001 — width is advisory
            return None
        if not schema.known:
            return None
        sizes = []
        for _, ct in schema.cols:
            if ct.ctype is None:
                return None
            sizes.append(np.dtype(
                columnar.numpy_dtype(ct.ctype)).itemsize)
        return memplan.row_bytes(sizes)

    def _scans(self, node: lp.Plan) -> List[lp.Scan]:
        return [n for n in node.walk() if isinstance(n, lp.Scan)]

    def _estimate(self, node: lp.Plan) -> CostEstimate:
        rb = self._row_bytes(node)
        if isinstance(node, lp.Scan):
            rows = self.base_rows(node.table)
            rows = 1000.0 if rows is None else rows
            if node.predicate is not None:
                rows *= self.selectivity(node.predicate, [node])
            return CostEstimate(max(rows, 0.0), rb)
        if isinstance(node, lp.InlineTable):
            n = getattr(node.table, "num_rows", None)
            return CostEstimate(float(n if n is not None else 10), rb)
        if isinstance(node, lp.Filter):
            child = self.estimate(node.child)
            sel = self.selectivity(node.condition,
                                   self._scans(node.child))
            return CostEstimate(child.rows * sel, rb)
        if isinstance(node, lp.Join):
            return self._estimate_join(node, rb)
        if isinstance(node, lp.Aggregate):
            child = self.estimate(node.child)
            scans = self._scans(node.child)
            if not node.group_by:
                groups = 1.0
            else:
                groups = 1.0
                for _, e in node.group_by:
                    groups = min(groups * self._expr_ndv(e, scans),
                                 2.0 ** 62)
                groups = min(groups, max(child.rows, 1.0))
            if node.grouping_sets:
                groups = min(groups * len(node.grouping_sets),
                             max(child.rows, 1.0) *
                             len(node.grouping_sets))
            return CostEstimate(groups, rb)
        if isinstance(node, lp.Distinct):
            child = self.estimate(node.child)
            return CostEstimate(
                min(child.rows, max(child.rows * 0.1, 1.0)), rb)
        if isinstance(node, lp.Limit):
            child = self.estimate(node.child)
            n = node.n if node.n else 0
            return CostEstimate(min(child.rows, float(n))
                                if n else child.rows, rb)
        if isinstance(node, lp.SetOp):
            left = self.estimate(node.left)
            right = self.estimate(node.right)
            if node.kind == "union":
                rows = left.rows + right.rows
                if not node.all:
                    rows *= 0.9
            elif node.kind == "intersect":
                rows = min(left.rows, right.rows) * 0.5
            else:  # except
                rows = left.rows * 0.5
            return CostEstimate(rows, rb)
        if isinstance(node, lp.DeviceResult):
            return CostEstimate(1000.0, rb)
        kids = node.children()
        if kids:
            child = self.estimate(kids[0])
            return CostEstimate(child.rows, rb)
        return CostEstimate(1000.0, rb)

    def _estimate_join(self, node: lp.Join,
                       rb: Optional[int]) -> CostEstimate:
        left = self.estimate(node.left)
        right = self.estimate(node.right)
        l, r = max(left.rows, 0.0), max(right.rows, 0.0)
        if node.kind == "cross" or not node.keys:
            rows = l * r if node.kind in ("cross", "inner") else l
            return CostEstimate(rows, rb)
        lscans = self._scans(node.left)
        rscans = self._scans(node.right)
        ndv_l = ndv_r = 1.0
        for le, re_ in node.keys:
            ndv_l = min(ndv_l * self._expr_ndv(le, lscans), 2.0 ** 62)
            ndv_r = min(ndv_r * self._expr_ndv(re_, rscans), 2.0 ** 62)
        domain = max(ndv_l, ndv_r, 1.0)
        inner = l * r / domain
        coverage = min(r / domain, 1.0)    # P(probe key has a match)
        kind = node.kind
        if kind == "inner":
            rows = inner
        elif kind == "left":
            rows = max(inner, l)
        elif kind == "right":
            rows = max(inner, r)
        elif kind == "full":
            rows = max(inner, l + r)
        elif kind == "semi":
            rows = l * coverage
        elif kind in ("anti", "nullaware_anti"):
            rows = l * max(1.0 - coverage, ANTI_FLOOR)
        elif kind == "mark":
            rows = l
        else:
            rows = inner
        return CostEstimate(max(rows, 0.0), rb)


# ---------------------------------------------------------------------------
# strategy choice (shared: analysis NDS305 prediction + dplan runtime)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decision:
    """One exchange-placement decision for a spine join."""

    strategy: str       # broadcast | shuffle | build-reduce
    structural: str     # what the fixed pre-cost rule would pick
    reason: str

    @property
    def overrode(self) -> bool:
        return self.strategy != self.structural


def choose_strategy(build_rows: float, build_bytes: Optional[float], *,
                    broadcast_limit_rows: int, budget_bytes: int,
                    reducible: bool = False) -> Decision:
    """Exchange placement for one spine join's build side.

    The structural (pre-cost) rule is rows-only: over the broadcast
    row limit -> shuffle, else broadcast.  The cost model adds the byte
    dimension: a build whose replicated footprint exceeds
    :data:`BROADCAST_FRACTION` of the device budget is demoted to the
    shuffle path even under the row limit (NDS601).  ``reducible``
    marks an existence-join build containing a sharded-size table —
    the distributed distinct-key reduction (dplan._reduce_build) wins
    outright.  Demote-only by design: the shuffle->broadcast promotion
    direction is never taken, so operator-forced shuffle coverage
    (tests pinning ``broadcast_limit_rows``) keeps its meaning."""
    structural = "shuffle" if build_rows > broadcast_limit_rows \
        else "broadcast"
    if reducible:
        return Decision("build-reduce", structural,
                        "existence build reduces to distinct key "
                        "tuples distributed")
    bcast_budget = int(budget_bytes * BROADCAST_FRACTION)
    if build_bytes is not None and build_bytes > bcast_budget:
        return Decision(
            "shuffle", structural,
            f"build ~{int(build_bytes)} B over the {bcast_budget} B "
            "replication budget")
    if structural == "shuffle":
        return Decision("shuffle", structural,
                        "build rows over the broadcast limit")
    return Decision("broadcast", structural,
                    "build under the broadcast row limit and "
                    "replication budget")


@dataclasses.dataclass
class CostAdvisor:
    """Runtime strategy chooser handed to dplan (see
    :func:`default_advisor`).  Decisions are recorded by the executor
    (``engine.cost.decisions`` / ``engine.cost.overrides`` counters,
    ``cost_decisions`` span attr -> ledger extra)."""

    broadcast_limit_rows: int
    budget_bytes: int
    calibration: Optional[Calibration] = None

    def decide_join(self, *, build_rows: int,
                    build_bytes: Optional[int], kind: str,
                    dup_max: int, order_safe: bool) -> Decision:
        d = choose_strategy(build_rows, build_bytes,
                            broadcast_limit_rows=self.broadcast_limit_rows,
                            budget_bytes=self.budget_bytes)
        if not d.overrode:
            return d
        if not order_safe:
            # a row-spine's output order depends on where rows live;
            # only aggregate spines may re-place safely
            return Decision(d.structural, d.structural,
                            "cost override suppressed: "
                            "row-order-sensitive spine")
        if d.strategy == "shuffle" and dup_max and kind == "inner":
            # the shuffle path cannot expand duplicate build key runs
            return Decision(d.structural, d.structural,
                            "cost override suppressed: expanding "
                            "inner join cannot shuffle")
        return d


def default_advisor(broadcast_limit_rows: int,
                    calibration: Optional[Calibration] = None
                    ) -> CostAdvisor:
    """Advisor over the *runtime* device budget (memplan probes the
    backend here — this is the jax-loaded side of the fence)."""
    budget, _src = memplan.device_budget_bytes()
    return CostAdvisor(
        broadcast_limit_rows=broadcast_limit_rows,
        budget_bytes=int(budget * memplan.SAFETY),
        calibration=calibration)


# ---------------------------------------------------------------------------
# static plan audit (NDS601/602/603)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JoinPlacement:
    """Predicted exchange placement for one spine join."""

    path: str
    kind: str
    build_rows: float
    build_bytes: Optional[int]
    decision: Decision


@dataclasses.dataclass
class CostReport:
    """Static cost audit of one query part (scripts/cost_lint.py)."""

    query: str
    root: CostEstimate
    placements: List[JoinPlacement]
    working_set_bytes: Optional[int]
    exchange_bytes: int
    budget_bytes: int
    diagnostics: List[Diagnostic]

    def placement_counts(self) -> Dict[str, int]:
        out = {"broadcast": 0, "shuffle": 0, "build-reduce": 0}
        for p in self.placements:
            out[p.decision.strategy] += 1
        return out

    def as_dict(self) -> dict:
        return {
            "est_rows": round(self.root.rows, 1),
            "band": [round(self.root.lo, 4), round(self.root.hi, 4)],
            "row_bytes": self.root.row_bytes,
            "working_set_bytes": self.working_set_bytes,
            "exchange_bytes": self.exchange_bytes,
            "placements": [
                {"path": p.path, "kind": p.kind,
                 "build_rows": round(p.build_rows, 1),
                 "build_bytes": p.build_bytes,
                 "strategy": p.decision.strategy,
                 "structural": p.decision.structural,
                 "reason": p.decision.reason}
                for p in self.placements],
        }


def _walk_paths(node: lp.Plan,
                path: str = "") -> Iterator[Tuple[lp.Plan, str]]:
    path = path or type(node).__name__
    yield node, path
    for i, c in enumerate(node.children()):
        yield from _walk_paths(c, _child_path(path, c, i))


def audit_cost(plan: lp.Plan,
               tables: Optional[Dict[str, object]] = None,
               query: str = "",
               scale_factor: Optional[float] = None,
               budget_bytes: Optional[int] = None,
               n_dev: int = 1,
               broadcast_limit_rows: Optional[int] = None,
               shard_threshold_rows: int = 65536,
               row_counts: Optional[Dict[str, int]] = None,
               calibration: Optional[Calibration] = None) -> CostReport:
    """Static cost audit of one optimized plan: root estimate, per-join
    exchange placement (mirroring dplan._prepare's decision points via
    the shared :func:`choose_strategy`), predicted working set, and the
    NDS601/NDS602/NDS603 diagnostics."""
    from ndstpu_torch.analysis import lowering as lowreg

    if tables is None:
        from ndstpu_torch import analysis
        tables = analysis.schema_tables()
    if budget_bytes is None:
        budget_bytes, _src = cost_budget_bytes()
    if broadcast_limit_rows is None:
        broadcast_limit_rows = lowreg.SPMD_BROADCAST_LIMIT_ROWS
    model = CostModel(tables, scale_factor=scale_factor,
                      row_counts=row_counts, calibration=calibration,
                      query=query)
    root = model.estimate_query(plan)
    diags: List[Diagnostic] = []
    placements: List[JoinPlacement] = []

    # candidate sharded fact: largest base table over the shard
    # threshold (dplan tries largest-first; the first candidate is the
    # one the static placement prediction anchors on)
    target: Optional[lp.Scan] = None
    target_path = type(plan).__name__
    best = -1.0
    for node, npath in _walk_paths(plan):
        if isinstance(node, lp.Scan):
            rows = model.base_rows(node.table) or 0.0
            if rows >= shard_threshold_rows and rows > best:
                best, target, target_path = rows, node, npath
    working_set: Optional[int] = None
    exchange = 0
    if target is not None:
        bcast_budget = int(budget_bytes * BROADCAST_FRACTION)
        bcast_bytes = 0
        fact_est = model.estimate(target)
        for node, npath in _walk_paths(plan):
            if not isinstance(node, lp.Join):
                continue
            in_l = any(n is target for n in node.left.walk())
            in_r = any(n is target for n in node.right.walk())
            if in_l == in_r:       # neither side, or a self-join artifact
                continue
            if node.kind not in lowreg.SPMD_SPINE_JOIN_KINDS \
                    or not node.keys:
                continue
            if in_r and node.kind != "inner":
                if node.kind in lowreg.SPMD_REDUCIBLE_BUILD_JOIN_KINDS \
                        and not (node.kind == "nullaware_anti"
                                 and node.extra is not None):
                    # probe-anchored elsewhere, this build reduces to
                    # its distinct key tuples (NDS308 / _reduce_build)
                    best_build = model.estimate(node.right)
                    placements.append(JoinPlacement(
                        path=npath, kind=node.kind,
                        build_rows=best_build.rows,
                        build_bytes=best_build.bytes,
                        decision=choose_strategy(
                            best_build.rows, best_build.bytes,
                            broadcast_limit_rows=broadcast_limit_rows,
                            budget_bytes=budget_bytes,
                            reducible=True)))
                continue           # non-reducible: single-chip fallback
            build = node.left if in_r else node.right
            est = model.estimate(build)
            reducible = (
                node.kind in lowreg.SPMD_REDUCIBLE_BUILD_JOIN_KINDS
                and not (node.kind == "nullaware_anti"
                         and node.extra is not None)
                and any(isinstance(n, lp.Scan)
                        and (model.base_rows(n.table) or 0.0)
                        >= shard_threshold_rows
                        for n in build.walk()))
            d = choose_strategy(est.rows, est.bytes,
                                broadcast_limit_rows=broadcast_limit_rows,
                                budget_bytes=budget_bytes,
                                reducible=reducible)
            placements.append(JoinPlacement(
                path=npath, kind=node.kind, build_rows=est.rows,
                build_bytes=est.bytes, decision=d))
            if d.structural == "broadcast" and est.bytes is not None \
                    and est.bytes > bcast_budget:
                diags.append(Diagnostic(
                    code="NDS601",
                    message=f"broadcast build ~{est.bytes} B over the "
                            f"{bcast_budget} B replication budget "
                            f"({budget_bytes} B device budget x "
                            f"{BROADCAST_FRACTION:g}): cost model "
                            "places it on the shuffle path",
                    path=npath, query=query))
            if d.strategy == "broadcast" and est.bytes is not None:
                bcast_bytes += est.bytes
            if d.strategy == "shuffle":
                exchange += int(est.bytes or 0) + int(fact_est.bytes or 0)
        if fact_est.row_bytes is not None:
            shard_rows = math.ceil(max(fact_est.rows, 1.0)
                                   / max(n_dev, 1))
            working_set = int(shard_rows * fact_est.row_bytes
                              * memplan.COMPUTE_MULT) + bcast_bytes
            if working_set > budget_bytes:
                diags.append(Diagnostic(
                    code="NDS602",
                    message=f"predicted per-device working set "
                            f"~{working_set} B (COMPUTE_MULT="
                            f"{memplan.COMPUTE_MULT} model + "
                            f"{bcast_bytes} B resident broadcast "
                            f"builds over {n_dev} device(s)) exceeds "
                            f"the {budget_bytes} B budget: the fact "
                            "must stream out-of-core",
                    path=target_path, query=query))
        heavy = int(budget_bytes * EXCHANGE_HEAVY_FRACTION)
        if exchange > heavy:
            diags.append(Diagnostic(
                code="NDS603",
                message=f"predicted collective (all_to_all) traffic "
                        f"~{exchange} B across shuffle-placed joins "
                        f"exceeds {heavy} B "
                        f"({EXCHANGE_HEAVY_FRACTION:g} x budget)",
                path=target_path, query=query))
    return CostReport(query=query, root=root, placements=placements,
                      working_set_bytes=working_set,
                      exchange_bytes=exchange,
                      budget_bytes=budget_bytes, diagnostics=diags)
