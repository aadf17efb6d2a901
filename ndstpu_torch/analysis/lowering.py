"""Supported-op registry and static lowerability audit.

The registry below is THE single source of truth for what the jax device
executor (``engine/jaxexec.py``) and the SPMD spine compiler
(``parallel/dplan.py``) can lower — extracted from their raise sites and
consumed back by both (jaxexec's membership checks and
``scripts/spmd_coverage.py`` import these sets), so the analyzer and the
runtime cannot drift apart silently.

On top of the registry, :func:`audit_plan` walks a logical plan and
predicts device-vs-fallback per query part *without executing anything*:

* NDS2xx (error): a node/expression jaxexec will refuse —
  ``_execute_node`` catches :class:`~ndstpu.engine.jaxexec.Unsupported`
  and interprets the node on host numpy, so any NDS2xx error outside a
  subquery sub-plan means verdict ``fallback``.
* NDS213/NDS214 (info): data-dependent capacity guards and per-set
  grouping-set passes — the plan still compiles for the device.
* NDS3xx (warning/info): SPMD spine restrictions mirrored from dplan.
  They never affect the device verdict: ``Session`` degrades
  ``DistUnsupported`` to single-chip execution gracefully.

Subquery sub-plans (``SubqueryExpr.plan``) are audited under a
``.../subquery[i]`` path segment and excluded from the verdict, exactly
like jaxexec's ``_resolve_subqueries`` isolates ``_used_fallback``.

Import-hygienic: no jax — safe for CI lint and doc tooling processes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ndstpu_torch.engine import expr as ex
from ndstpu_torch.engine import plan as lp
from ndstpu_torch.analysis.diagnostics import Diagnostic, sort_diagnostics
from ndstpu_torch.analysis.typecheck import Schema, TypeChecker, _child_path

# ---------------------------------------------------------------------------
# Registry (mirrors jaxexec raise sites; consumed by jaxexec + dplan tools)
# ---------------------------------------------------------------------------

#: JEval._binop — comparison/logic/arith/concat (jaxexec "binop {op}")
SUPPORTED_BINOPS = frozenset({
    "and", "or", "=", "<>", "<", "<=", ">", ">=",
    "+", "-", "*", "/", "%", "||",
})

#: JEval._unary (jaxexec "unary {op}")
SUPPORTED_UNARY_OPS = frozenset({"not", "neg", "isnull", "isnotnull"})

#: JEval.cast target kinds; string targets only parse FROM string
#: (jaxexec "cast {src} -> {target}" and "cast-to-string on device")
SUPPORTED_CAST_TARGET_KINDS = frozenset({
    "float64", "decimal", "int32", "int64", "date", "bool",
})

#: JEval._func (jaxexec "function {name}")
DEVICE_FUNCS = frozenset({
    "concat", "coalesce", "like", "substr", "substring", "upper",
    "lower", "trim", "length", "abs", "round", "floor", "ceil", "sqrt",
    "year", "month", "day", "nullif",
})

#: device funcs whose argument must already be a string column
#: (jaxexec _as_string: "cast-to-string on device")
STRING_ARG_FUNCS = frozenset({"upper", "lower", "trim", "length"})

#: literal python types JEval._lit accepts (None is always accepted)
SUPPORTED_LITERAL_TYPES = (bool, int, float, str)

#: _check_agg_supported (jaxexec "aggregate {func}")
SUPPORTED_AGG_FUNCS = frozenset({
    "sum", "count", "avg", "min", "max",
    "stddev_samp", "var_samp", "stddev", "variance",
})

#: _check_agg_supported (jaxexec "distinct aggregate {func} on device")
DISTINCT_AGG_FUNCS = frozenset({"sum", "count", "avg", "min", "max"})

#: aggregates whose grouping-set partials re-combine into coarser groups
#: in one pass (jaxexec._GS_COMBINABLE); others run one pass per set —
#: still on device, just more programs
GS_COMBINABLE_AGGS = frozenset({"count", "sum", "avg", "min", "max"})

#: _window_column ranking path (jaxexec "window {func}")
WINDOW_RANKING_FUNCS = frozenset({"rank", "dense_rank", "row_number"})

#: _window_column partition-aggregate path
WINDOW_AGG_FUNCS = frozenset({"count", "sum", "avg", "min", "max"})

#: _running_window (order_by present: "running window {func}")
RUNNING_WINDOW_FUNCS = frozenset({"count", "sum", "avg", "min", "max"})

#: keyless joins (jaxexec "non-equi {kind} join")
KEYLESS_JOIN_KINDS = frozenset({"cross", "inner"})

#: equi-join kinds (jaxexec _exec_join/_equi_join "join kind {kind}")
EQUI_JOIN_KINDS = frozenset({
    "inner", "left", "right", "full", "semi", "anti", "mark",
    "nullaware_anti",
})

#: subquery kinds _resolve_subqueries can inline (exists is host-only;
#: jaxexec "subquery kind {kind}")
DEVICE_SUBQUERY_KINDS = frozenset({"scalar", "in"})

# -- SPMD spine registry (mirrors parallel/dplan.py) -------------------------

#: join kinds allowed on the sharded spine (dplan "{kind} join on spine")
SPMD_SPINE_JOIN_KINDS = frozenset({
    "inner", "left", "semi", "anti", "nullaware_anti", "mark",
})

#: aggregate functions decomposable into per-device partials
#: (dplan._AGG_FUNCS, "agg {func} on spine")
SPMD_AGG_FUNCS = frozenset({
    "sum", "count", "avg", "min", "max",
    "stddev_samp", "var_samp", "stddev", "variance",
})

#: join-key dtype kinds shardable on the spine (dplan._KEY_KINDS; string
#: keys additionally need a dictionary — "{kind} join key on spine")
SPMD_KEY_KINDS = frozenset({"int32", "int64", "date"})

#: build sides larger than this broadcast limit take the shuffle-join
#: (all_to_all) path (dplan broadcast_limit_rows default)
SPMD_BROADCAST_LIMIT_ROWS = 8_000_000

#: sharded-size fact tables (SF-scaled): scans of these anchor a spine
SPMD_FACT_TABLES = frozenset({
    "store_sales", "store_returns", "catalog_sales", "catalog_returns",
    "web_sales", "web_returns", "inventory",
})

#: existence-join kinds whose sharded build side reduces to its distinct
#: (key, residual-column) tuples via a child distributed aggregate
#: before broadcasting (dplan._reduce_build — existence semantics are
#: insensitive to duplicate build rows, so the reduction is lossless)
SPMD_REDUCIBLE_BUILD_JOIN_KINDS = frozenset({
    "semi", "anti", "nullaware_anti", "mark",
})


def spmd_window_ok(node: lp.Window) -> bool:
    """True when a Window node runs sharded on the spine
    (dplan._exec_window_dist): every expr is a plain WindowExpr — no
    subqueries anywhere — computing a ranking or a whole-partition
    aggregate.  Running frames (agg func + ORDER BY) need the
    cross-row prefix scan and stay single-chip."""
    for _name, e in node.exprs:
        if not isinstance(e, ex.WindowExpr):
            return False
        if any(isinstance(x, ex.SubqueryExpr) for x in e.walk()):
            return False
        if e.func in WINDOW_RANKING_FUNCS:
            continue
        if e.func in WINDOW_AGG_FUNCS and not e.order_by:
            continue
        return False
    return True


def plan_path_to(root: lp.Plan, target: lp.Plan
                 ) -> Optional[List[lp.Plan]]:
    """Root-to-target node path, or None when target is not in the
    tree (shared by dplan's union splitter and this audit)."""
    if root is target:
        return [root]
    for c in root.children():
        p = plan_path_to(c, target)
        if p is not None:
            return [root] + p
    return None


def union_distributive_path(root: lp.Plan, target: lp.Plan) -> bool:
    """Aggregation over the union at `target` may be split per branch
    only when every node between them distributes over UNION ALL:
    row-wise ops, inner joins (either side), and probe-side-only for
    left/semi/anti/mark joins (a build-side union would change match
    semantics)."""
    path = plan_path_to(root, target)
    if path is None:
        return False
    for i, nd in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(nd, (lp.Project, lp.Filter, lp.SubqueryAlias)):
            continue
        if isinstance(nd, lp.SetOp) and nd.kind == "union" and nd.all:
            continue
        if isinstance(nd, lp.Join):
            if nd.kind == "inner" or (nxt is nd.left and nd.kind in
                                      ("left", "semi", "anti",
                                       "nullaware_anti", "mark")):
                continue
            return False
        return False
    return True


# ---------------------------------------------------------------------------
# Audit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AuditResult:
    """Static lowerability prediction for one query part."""

    verdict: str                     # "device" | "fallback"
    diagnostics: List[Diagnostic]

    @property
    def fallback_codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics
                       if d.severity == "error" and
                       "/subquery[" not in d.path})


def verdict_from(diags: List[Diagnostic]) -> str:
    """Device iff no error-severity lowering diagnostic on the main plan
    (subquery sub-plan fallbacks are isolated at runtime and don't make
    the outer plan non-compilable)."""
    for d in diags:
        if d.severity == "error" and "/subquery[" not in d.path:
            return "fallback"
    return "device"


class LoweringAuditor:
    """Plan walker emitting NDS2xx/NDS3xx diagnostics."""

    def __init__(self, tables: Dict[str, object], query: str = "",
                 scale_factor: Optional[float] = None, spmd: bool = True):
        self.tables = tables
        self.query = query
        self.spmd = spmd
        self.tc = TypeChecker(tables, query=query,
                              scale_factor=scale_factor)
        self.diags: List[Diagnostic] = []

    def _emit(self, code: str, message: str, path: str) -> None:
        self.diags.append(Diagnostic(code=code, message=message, path=path,
                                     query=self.query))

    # -- entry ---------------------------------------------------------------

    def audit(self, plan: lp.Plan) -> AuditResult:
        self._node(plan, type(plan).__name__)
        if self.spmd:
            self._audit_spine(plan)
        return AuditResult(verdict_from(self.diags),
                           sort_diagnostics(self.diags))

    # -- per-node checks -----------------------------------------------------

    def _node(self, p: lp.Plan, path: str) -> None:
        schemas = [self.tc.infer(c, _child_path(path, c, i))
                   for i, c in enumerate(p.children())]
        if isinstance(p, lp.Scan) and p.predicate is not None:
            self._expr(p.predicate, self.tc.infer(p), path)
        elif isinstance(p, lp.Filter):
            self._expr(p.condition, schemas[0], path)
        elif isinstance(p, lp.Project):
            for _, e in p.exprs:
                self._expr(e, schemas[0], path)
        elif isinstance(p, lp.Join):
            self._join(p, schemas[0], schemas[1], path)
        elif isinstance(p, lp.Aggregate):
            self._aggregate(p, schemas[0], path)
        elif isinstance(p, lp.Window):
            self._window(p, schemas[0], path)
        elif isinstance(p, lp.Sort):
            for entry in p.keys:
                self._expr(entry[0], schemas[0], path)
        for i, c in enumerate(p.children()):
            self._node(c, _child_path(path, c, i))

    def _join(self, p: lp.Join, left: Schema, right: Schema,
              path: str) -> None:
        if not p.keys:
            if p.kind not in KEYLESS_JOIN_KINDS:
                self._emit("NDS210", f"non-equi {p.kind} join without "
                           "keys is host-only", path)
        elif p.kind not in EQUI_JOIN_KINDS:
            self._emit("NDS210", f"join kind {p.kind} is host-only", path)
        for i, (le, re_) in enumerate(p.keys):
            self._expr(le, left, f"{path}/keys[{i}]")
            self._expr(re_, right, f"{path}/keys[{i}]")
        if p.extra is not None:
            merged = Schema(
                (left.cols or []) + (right.cols or [])
                if left.known and right.known else None)
            self._expr(p.extra, merged, path)

    def _aggregate(self, p: lp.Aggregate, child: Schema,
                   path: str) -> None:
        for _, e in p.group_by:
            self._expr(e, child, path, allow_agg=False)
        not_combinable = set()
        for name, e in p.aggs:
            self._agg_output(e, child, path)
            for sub in e.walk():
                if isinstance(sub, ex.AggExpr) and (
                        sub.func not in GS_COMBINABLE_AGGS or
                        sub.distinct):
                    not_combinable.add(
                        f"{sub.func}{' distinct' if sub.distinct else ''}")
        if p.grouping_sets is not None and not_combinable:
            self._emit(
                "NDS214",
                f"grouping sets with non-combinable aggregates "
                f"({', '.join(sorted(not_combinable))}): one device pass "
                f"per set ({len(p.grouping_sets)} sets) instead of one "
                "combinable pass", path)

    def _agg_output(self, e: ex.Expr, schema: Schema, path: str) -> None:
        """Mirror jaxexec._eval_agg: an aggregate output expression must
        be an AggExpr / grouping() / literal-cast-binop-case combination
        over those ("aggregate output {type}")."""
        if isinstance(e, ex.AggExpr):
            if e.func not in SUPPORTED_AGG_FUNCS:
                self._emit("NDS207", f"aggregate {e.func} is host-only",
                           path)
            elif e.distinct and e.func not in DISTINCT_AGG_FUNCS:
                self._emit("NDS207", f"distinct aggregate {e.func} is "
                           "host-only", path)
            if not isinstance(e.arg, ex.Star):
                self._expr(e.arg, schema, path, allow_agg=False)
            return
        if isinstance(e, ex.Func) and e.name == "grouping":
            return
        if isinstance(e, ex.Literal):
            self._check_literal(e, path)
            return
        if isinstance(e, ex.Cast):
            self._check_cast(e, schema, path)
            self._agg_output(e.operand, schema, path)
            return
        if isinstance(e, ex.BinOp):
            if e.op not in SUPPORTED_BINOPS:
                self._emit("NDS202", f"binop {e.op} is host-only", path)
            self._agg_output(e.left, schema, path)
            self._agg_output(e.right, schema, path)
            return
        if isinstance(e, ex.Case):
            for c, v in e.whens:
                self._agg_output(c, schema, path)
                self._agg_output(v, schema, path)
            if e.default is not None:
                self._agg_output(e.default, schema, path)
            return
        if isinstance(e, ex.Func):
            if e.name not in DEVICE_FUNCS:
                self._emit("NDS205", f"function {e.name} is host-only",
                           path)
            for a in e.args:
                self._agg_output(a, schema, path)
            return
        self._emit("NDS208", f"aggregate output {type(e).__name__} "
                   f"({e}) is host-only", path)

    def _window(self, p: lp.Window, child: Schema, path: str) -> None:
        for _, e in p.exprs:
            if not isinstance(e, ex.WindowExpr):
                self._emit("NDS209", f"non-window expr "
                           f"{type(e).__name__} in Window node", path)
                continue
            w: ex.WindowExpr = e
            if w.func in WINDOW_RANKING_FUNCS:
                pass
            elif w.func in WINDOW_AGG_FUNCS:
                if w.order_by and w.func not in RUNNING_WINDOW_FUNCS:
                    self._emit("NDS209", f"running window {w.func} is "
                               "host-only", path)
            else:
                self._emit("NDS209", f"window {w.func} is host-only",
                           path)
            for pe in w.partition_by:
                self._expr(pe, child, path, allow_agg=False)
            for oe, _ in w.order_by:
                self._expr(oe, child, path, allow_agg=False)
            if w.arg is not None and not isinstance(w.arg, ex.Star):
                self._expr(w.arg, child, path, allow_agg=False)

    # -- expression checks ---------------------------------------------------

    def _expr(self, e: ex.Expr, schema: Schema, path: str,
              allow_agg: bool = False) -> None:
        if isinstance(e, (ex.ColumnRef, ex.Star)):
            return
        if isinstance(e, ex.Literal):
            self._check_literal(e, path)
            return
        if isinstance(e, ex.Cast):
            self._check_cast(e, schema, path)
            self._expr(e.operand, schema, path, allow_agg)
            return
        if isinstance(e, ex.BinOp):
            if e.op not in SUPPORTED_BINOPS:
                self._emit("NDS202", f"binop {e.op} is host-only", path)
            elif e.op == "||":
                lt = self.tc.expr_type(e.left, schema)
                rt = self.tc.expr_type(e.right, schema)
                for side, t in (("left", lt), ("right", rt)):
                    if t.known and t.kind != "string":
                        self._emit("NDS206", f"|| {side} operand is "
                                   f"{t.kind}, not string", path)
                if lt.kind == rt.kind == "string":
                    self._emit("NDS213", "|| builds a dictionary "
                               "cross-product on device (guarded at 2^20 "
                               "entries)", path)
            self._expr(e.left, schema, path, allow_agg)
            self._expr(e.right, schema, path, allow_agg)
            return
        if isinstance(e, ex.UnaryOp):
            if e.op not in SUPPORTED_UNARY_OPS:
                self._emit("NDS203", f"unary {e.op} is host-only", path)
            self._expr(e.operand, schema, path, allow_agg)
            return
        if isinstance(e, ex.Case):
            for c, v in e.whens:
                self._expr(c, schema, path, allow_agg)
                self._expr(v, schema, path, allow_agg)
            if e.default is not None:
                self._expr(e.default, schema, path, allow_agg)
            return
        if isinstance(e, ex.Func):
            self._check_func(e, schema, path)
            for a in e.args:
                self._expr(a, schema, path, allow_agg)
            return
        if isinstance(e, ex.InList):
            self._check_in_list(e, schema, path)
            self._expr(e.operand, schema, path, allow_agg)
            return
        if isinstance(e, ex.Param):
            # lifted literal (analysis/canon.py): binds a supported-type
            # value at runtime, lowerable wherever a Literal is
            return
        if isinstance(e, ex.InParam):
            self._expr(e.operand, schema, path, allow_agg)
            return
        if isinstance(e, ex.SubqueryExpr):
            if e.kind not in DEVICE_SUBQUERY_KINDS:
                self._emit("NDS211", f"subquery kind {e.kind} is "
                           "host-only", path)
            if e.operand is not None:
                self._expr(e.operand, schema, path, allow_agg)
            if e.plan is not None:
                # audited in isolation, mirroring _resolve_subqueries'
                # _used_fallback save/restore: sub-plan fallbacks never
                # make the outer plan non-compilable
                counts = getattr(self, "_sub_counts", None)
                if counts is None:
                    counts = self._sub_counts = {}
                n = counts.get(path, 0)
                counts[path] = n + 1
                self._node(e.plan, f"{path}/subquery[{n}]")
            return
        if isinstance(e, (ex.AggExpr, ex.WindowExpr)) and not allow_agg:
            self._emit("NDS201", f"expr {type(e).__name__} outside its "
                       "node is host-only", path)
            return

    def _check_literal(self, e: ex.Literal, path: str) -> None:
        v = e.value
        if v is not None and not isinstance(v, SUPPORTED_LITERAL_TYPES):
            self._emit("NDS201", f"literal {v!r} "
                       f"({type(v).__name__}) is host-only", path)

    def _check_cast(self, e: ex.Cast, schema: Schema, path: str) -> None:
        tk = e.target.kind
        if tk in SUPPORTED_CAST_TARGET_KINDS:
            return
        src = self.tc.expr_type(e.operand, schema)
        if tk == "string" and (not src.known or src.kind == "string"):
            return  # identity string cast compiles
        self._emit("NDS204", f"cast {src.kind or '?'} -> {e.target} is "
                   "host-only", path)

    def _check_func(self, e: ex.Func, schema: Schema, path: str) -> None:
        if e.name not in DEVICE_FUNCS:
            self._emit("NDS205", f"function {e.name} is host-only", path)
            return
        if e.name in STRING_ARG_FUNCS and e.args:
            t = self.tc.expr_type(e.args[0], schema)
            if t.known and t.kind != "string":
                self._emit("NDS206", f"{e.name}() argument is {t.kind}; "
                           "device has no cast-to-string", path)

    def _check_in_list(self, e: ex.InList, schema: Schema,
                       path: str) -> None:
        t = self.tc.expr_type(e.operand, schema)
        if not t.known or t.kind == "string":
            return
        vals, _had_null = ex.coerce_in_values(t.ctype, list(e.values))
        if any(isinstance(v, str) for v in vals):
            self._emit("NDS212", f"IN-list string literals against "
                       f"{t.kind} column", path)

    # -- SPMD spine checks (mirror parallel/dplan.py) ------------------------

    def _audit_spine(self, plan: lp.Plan) -> None:
        scans = [n for n in plan.walk() if isinstance(n, lp.Scan)]
        facts = [n for n in scans if n.table in SPMD_FACT_TABLES]
        if not facts:
            self._emit("NDS301", "no sharded-size base-table scan: plan "
                       "runs single-chip", type(plan).__name__)
            return
        usite = self._union_agg_site(plan)
        if usite is not None:
            # dplan._try_union_agg runs before the spine split: each
            # union-all branch becomes its own sharded spine and the
            # decomposable partials combine on the host, so the spine
            # restrictions below never apply to this plan shape
            self._emit("NDS309", "aggregate distributes over a union-all "
                       "of sharded branches: per-branch spines, partials "
                       "combined on the host", usite)
            return
        target = facts[0]  # dplan tries largest-first; facts dominate
        chain = self._chain_to(plan, target)
        if chain is None:
            return
        spine_idx = len(chain) - 1
        for i in range(len(chain) - 1, -1, -1):
            if self._spine_ok(chain[i][0]):
                spine_idx = i
            else:
                break
        spine_path = chain[spine_idx][1]
        spine = chain[spine_idx][0]
        if spine_idx > 0 and isinstance(chain[spine_idx - 1][0],
                                        lp.Aggregate):
            self._spmd_check_agg(chain[spine_idx - 1][0],
                                 chain[spine_idx - 1][1])
            spine = chain[spine_idx - 1][0]
            spine_path = chain[spine_idx - 1][1]
        # exchange placement now comes from the cost model's estimated
        # build cardinality/bytes through the SAME choose_strategy the
        # runtime advisor uses (analysis/cost.py), not the old
        # fact-in-build structural proxy — NDS305 reports the predicted
        # strategy mix plus the estimated replicated build bytes
        from ndstpu_torch.analysis import cost as costmod
        model = costmod.CostModel(self.tables,
                                  scale_factor=self.tc.scale_factor,
                                  query=self.query)
        budget, _src = costmod.cost_budget_bytes()
        broadcast = shuffle = reduced = 0
        bcast_bytes = 0
        for node, npath in self._walk_with_paths(spine, spine_path):
            if not isinstance(node, lp.Join):
                continue
            fact_left = any(n is target for n in node.left.walk())
            fact_right = any(n is target for n in node.right.walk())
            if not (fact_left or fact_right):
                continue
            if node.kind not in SPMD_SPINE_JOIN_KINDS:
                self._emit("NDS303", f"{node.kind} join on the spine "
                           "forces single-chip", npath)
                continue
            if not node.keys:
                self._emit("NDS304", "non-equi join on the spine forces "
                           "single-chip", npath)
                continue
            if fact_right and node.kind != "inner":
                if node.kind in SPMD_REDUCIBLE_BUILD_JOIN_KINDS and not (
                        node.kind == "nullaware_anti" and
                        node.extra is not None):
                    self._emit("NDS308", f"sharded build side of a "
                               f"{node.kind} join reduces to its "
                               "distinct key tuples distributed",
                               npath)
                else:
                    self._emit("NDS303", f"sharded table on the build "
                               f"side of a {node.kind} join forces "
                               "single-chip", npath)
            build = node.left if fact_right else node.right
            bschema = self.tc.infer(build)
            for i, (le, re_) in enumerate(node.keys):
                be = le if fact_right else re_
                t = self.tc.expr_type(be, bschema)
                if t.known and t.kind not in SPMD_KEY_KINDS and \
                        t.kind != "string":
                    self._emit("NDS307", f"{t.kind} join key is not "
                               "shardable on the spine",
                               f"{npath}/keys[{i}]")
                elif t.known and t.kind == "string":
                    from ndstpu_torch.io import gdict
                    if gdict.enabled():
                        # static mirror of dplan._probe_keys' identity
                        # path: with warehouse-wide frozen dictionaries
                        # both sides share one code space and the key
                        # shards on raw codes
                        self._emit("NDS312", "string join key shards "
                                   "on frozen global-dictionary codes",
                                   f"{npath}/keys[{i}]")
            est = model.estimate(build)
            reducible = (
                node.kind in SPMD_REDUCIBLE_BUILD_JOIN_KINDS
                and not (node.kind == "nullaware_anti"
                         and node.extra is not None)
                and any(isinstance(n, lp.Scan)
                        and n.table in SPMD_FACT_TABLES
                        for n in build.walk()))
            d = costmod.choose_strategy(
                est.rows, est.bytes,
                broadcast_limit_rows=SPMD_BROADCAST_LIMIT_ROWS,
                budget_bytes=budget, reducible=reducible)
            if d.strategy == "shuffle":
                shuffle += 1
            elif d.strategy == "build-reduce":
                reduced += 1
            else:
                broadcast += 1
                if est.bytes is not None:
                    bcast_bytes += est.bytes
        if broadcast or shuffle or reduced:
            self._emit(
                "NDS305",
                f"predicted exchange placement over {target.table}: "
                f"{broadcast} broadcast join(s) (~{bcast_bytes} est "
                f"build B), {shuffle} shuffle (all_to_all) join(s), "
                f"{reduced} build-reduce join(s)", spine_path)
        if isinstance(spine, lp.Aggregate):
            return
        # mirror dplan._split's tail/window detection: a Sort+Limit (or
        # bare Limit) directly above the spine finalizes as a per-device
        # top-k, and absorbed Window nodes run sharded — either one is
        # distributed work, so NDS306 no longer applies
        has_win = any(isinstance(chain[j][0], lp.Window)
                      for j in range(spine_idx, len(chain)))
        has_tail = False
        i = spine_idx - 1
        if i >= 0 and isinstance(chain[i][0], lp.Sort):
            i -= 1
        if i >= 0 and isinstance(chain[i][0], lp.Limit) and \
                chain[i][0].n and int(chain[i][0].n) > 0:
            has_tail = True
        if has_tail or has_win:
            what = []
            if has_tail:
                what.append("per-device top-k sort/limit gathers only "
                            "the k-row result")
            if has_win:
                what.append("window runs sharded over the partition-"
                            "colocating exchange")
            self._emit("NDS310", "row spine finalizes on-device: "
                       + "; ".join(what), spine_path)
        elif not any(
                isinstance(nd, (lp.Join, lp.Filter)) or
                (isinstance(nd, lp.Scan) and nd.predicate is not None)
                for nd in spine.walk()):
            self._emit("NDS306", "row spine does no distributed work: "
                       "every sharded row ships back to the host",
                       spine_path)

    def _spmd_check_agg(self, node: lp.Aggregate, path: str) -> None:
        for _, e in node.aggs:
            for sub in e.walk():
                if isinstance(sub, ex.AggExpr):
                    if sub.func not in SPMD_AGG_FUNCS:
                        self._emit("NDS302", f"agg {sub.func} is not "
                                   "decomposable on the spine", path)
                    if sub.distinct and (isinstance(sub.arg, ex.Star) or
                                         sub.arg is None):
                        self._emit("NDS302", "distinct star agg is not "
                                   "decomposable on the spine", path)
                    if sub.distinct and node.grouping_sets is not None:
                        self._emit("NDS302", "distinct agg under "
                                   "grouping sets is not decomposable "
                                   "on the spine", path)
                if isinstance(sub, ex.WindowExpr):
                    self._emit("NDS302", "window inside aggregate is "
                               "not decomposable on the spine", path)

    @staticmethod
    def _spine_ok(node: lp.Plan) -> bool:
        if isinstance(node, lp.Join):
            return node.kind in SPMD_SPINE_JOIN_KINDS
        if isinstance(node, lp.Window):
            return spmd_window_ok(node)
        return isinstance(node, (lp.Scan, lp.Filter, lp.Project,
                                 lp.SubqueryAlias))

    def _union_agg_site(self, plan: lp.Plan) -> Optional[str]:
        """Path of the deepest Aggregate that dplan._try_union_agg will
        split over a distributive union-all of fact-bearing branches —
        the site must pass the runtime's gating: decomposable agg funcs,
        no DISTINCT leaves (cross-branch dedup unsupported), no window
        inside the aggregate.  None when the plan takes the spine path."""
        best: Optional[Tuple[int, str]] = None

        def agg_ok(p: lp.Aggregate) -> bool:
            for _, e in p.aggs:
                for sub in e.walk():
                    if isinstance(sub, ex.WindowExpr):
                        return False
                    if isinstance(sub, ex.AggExpr) and (
                            sub.func not in SPMD_AGG_FUNCS or
                            sub.distinct):
                        return False
            return True

        def walk(p: lp.Plan, path: str, depth: int) -> None:
            nonlocal best
            if isinstance(p, lp.Aggregate) and agg_ok(p):
                direct = [
                    s for s in p.child.walk()
                    if isinstance(s, lp.SetOp) and s.kind == "union"
                    and s.all and union_distributive_path(p.child, s)
                    and any(isinstance(n, lp.Scan) and
                            n.table in SPMD_FACT_TABLES
                            for n in s.walk())]
                if direct and (best is None or depth > best[0]):
                    best = (depth, path)
            for i, c in enumerate(p.children()):
                walk(c, _child_path(path, c, i), depth + 1)

        walk(plan, type(plan).__name__, 0)
        return best[1] if best is not None else None

    @staticmethod
    def _chain_to(plan: lp.Plan, target: lp.Plan
                  ) -> Optional[List[Tuple[lp.Plan, str]]]:
        chain: List[Tuple[lp.Plan, str]] = []

        def descend(node: lp.Plan, path: str) -> bool:
            chain.append((node, path))
            if node is target:
                return True
            for i, c in enumerate(node.children()):
                if descend(c, _child_path(path, c, i)):
                    return True
            chain.pop()
            return False

        return chain if descend(plan, type(plan).__name__) else None

    def _walk_with_paths(self, node: lp.Plan, path: str):
        yield node, path
        for i, c in enumerate(node.children()):
            yield from self._walk_with_paths(c, _child_path(path, c, i))


def audit_plan(plan: lp.Plan, tables: Dict[str, object], query: str = "",
               scale_factor: Optional[float] = None,
               spmd: bool = True) -> AuditResult:
    """Predict device-vs-fallback for ``plan`` and collect NDS2xx/NDS3xx
    diagnostics; see module docstring for verdict semantics."""
    return LoweringAuditor(tables, query=query, scale_factor=scale_factor,
                           spmd=spmd).audit(plan)
