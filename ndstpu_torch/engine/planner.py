"""Planner: SQL AST -> logical plan (name binding, aggregate extraction,
subquery decorrelation).

Binding model: every base-table column is exposed under the globally unique
internal name ``"{alias}.{col}"`` (a Project over each Scan does the rename),
so self-joins like ``date_dim d1, date_dim d2`` need no special casing.
Derived tables and CTEs expose ``"{alias}.{output}"``.

Decorrelation rewrites (the reference corpus' patterns):
  * ``x IN (subquery)``            -> semi join   (NOT IN -> anti join)
  * ``EXISTS (corr. subquery)``    -> semi join on extracted equality keys
  * ``x <op> (corr. scalar agg)``  -> group subquery by its correlation keys,
                                      inner join, filter (TPC-DS q1/q6 shape)
  * uncorrelated scalar subqueries stay as SubqueryExpr leaves, resolved by
    the executor pre-pass (physical plans execute them once and inline).
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Dict, List, Optional, Sequence, Tuple

from ndstpu_torch.engine import columnar, expr as ex, plan as lp
from ndstpu_torch.engine.columnar import DATE, DType, FLOAT64, INT32, INT64, STRING
from ndstpu_torch.engine.sql import ast
from ndstpu_torch.schema import decimal as decimal_t

import numpy as np


class PlanError(Exception):
    pass


def _suggest(col: str, candidates: List[str]) -> str:
    """Near-miss suffix for unresolved-column errors — a typo'd
    reference names its likely targets instead of a bare failure."""
    close = difflib.get_close_matches(col, candidates, n=3, cutoff=0.6)
    return f" (did you mean: {', '.join(close)}?)" if close else ""


def _parse_type(name: str) -> DType:
    base = name.split("(")[0]
    if base in ("int", "integer", "smallint", "tinyint"):
        return INT32
    if base in ("bigint", "long"):
        return INT64
    if base in ("double", "float", "real"):
        return FLOAT64
    if base in ("decimal", "numeric"):
        if "(" in name:
            args = name[name.index("(") + 1:-1].split(",")
            p = int(args[0])
            s = int(args[1]) if len(args) > 1 else 0
            return decimal_t(p, s)
        return decimal_t(10, 0)
    if base == "date":
        return DATE
    if base in ("string", "char", "varchar", "text"):
        return STRING
    raise PlanError(f"unsupported cast type {name}")


def _date_to_days(s: str) -> int:
    return columnar.parse_date_days(s)


@dataclasses.dataclass
class Source:
    """One FROM source: its visible alias and output columns."""
    alias: str
    columns: List[str]  # base column names (unqualified)

    def internal(self, col: str) -> str:
        return f"{self.alias}.{col}"


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self.sources: List[Source] = []
        self.parent = parent
        self.outer_refs: List[str] = []  # internal names resolved via parent

    def add(self, src: Source) -> None:
        for s in self.sources:
            if s.alias == src.alias:
                raise PlanError(f"duplicate alias {src.alias}")
        self.sources.append(src)

    def resolve(self, table: Optional[str], col: str) -> Tuple[str, bool]:
        """-> (internal name, is_outer).  A resolution that climbs to the
        parent is recorded as an outer ref on EVERY scope it climbs through,
        so any enclosing query level can see that its subquery is
        correlated."""
        if table is not None:
            for s in self.sources:
                if s.alias == table:
                    if col not in s.columns:
                        raise PlanError(f"no column {col} in {table}"
                                        + _suggest(col, s.columns))
                    return s.internal(col), False
        else:
            hits = [s for s in self.sources if col in s.columns]
            if len(hits) > 1:
                raise PlanError(f"ambiguous column {col}")
            if hits:
                return hits[0].internal(col), False
        if self.parent is not None:
            try:
                name, _ = self.parent.resolve(table, col)
            except PlanError as e:
                if getattr(e, "unresolved", False):
                    # re-raise with THIS scope's (wider) candidate set:
                    # the innermost frame unwinds last, so the surfaced
                    # message suggests over everything the reference
                    # could actually see
                    raise self._unresolved(table, col) from None
                raise
            self.outer_refs.append(name)
            return name, True
        raise self._unresolved(table, col)

    def _unresolved(self, table: Optional[str], col: str) -> PlanError:
        where = f"{table}.{col}" if table else col
        e = PlanError(f"cannot resolve column {where}"
                      + _suggest(col, self._candidates()))
        e.unresolved = True
        return e

    def _candidates(self) -> List[str]:
        """Every column name visible from this scope (chain upward)."""
        out: List[str] = []
        sc: Optional["Scope"] = self
        while sc is not None:
            for s in sc.sources:
                for c in s.columns:
                    if c not in out:
                        out.append(c)
            sc = sc.parent
        return out


class Planner:
    def __init__(self, catalog, views: Optional[Dict] = None):
        """catalog: ndstpu.io.loader.Catalog (or any object with .tables
        dict of engine Tables); views: name -> logical Plan."""
        self.catalog = catalog
        self.views: Dict[str, lp.Plan] = views if views is not None else {}
        self._gen = 0

    def fresh(self, prefix: str) -> str:
        self._gen += 1
        return f"#{prefix}{self._gen}"

    # -- entry ---------------------------------------------------------------

    def plan_query(self, q: ast.Query,
                   scope: Optional[Scope] = None) -> Tuple[lp.Plan, List[str]]:
        """-> (plan, output column internal names == display names)."""
        cte_saved = {}
        for name, col_aliases, sub in q.ctes:
            plan, cols = self.plan_query(sub)
            if col_aliases:
                plan = lp.Project(plan, [
                    (a, ex.ColumnRef(c)) for a, c in zip(col_aliases, cols)])
                cols = list(col_aliases)
            cte_saved[name] = self.views.get(name)
            self.views[name] = lp.Project(plan, [
                (c, ex.ColumnRef(c0)) for c, c0 in
                zip(self._display_names(cols), cols)])
        try:
            if isinstance(q.body, ast.Select):
                plan, cols = self._plan_select(q.body, scope, q.order_by)
            else:
                plan, cols = self._plan_body(q.body, scope)
                if q.order_by:
                    plan = self._apply_order(plan, cols, q.order_by, scope)
            if q.limit is not None:
                plan = lp.Limit(plan, q.limit)
            return plan, cols
        finally:
            for name, _ca, _s in q.ctes:
                if cte_saved.get(name) is None:
                    self.views.pop(name, None)
                else:
                    self.views[name] = cte_saved[name]

    @staticmethod
    def _display_names(cols: List[str]) -> List[str]:
        out = []
        for c in cols:
            base = c.split(".")[-1] if "." in c and not c.startswith("#") \
                else c
            out.append(base)
        return out

    def _plan_body(self, body: ast.Node,
                   scope: Optional[Scope]) -> Tuple[lp.Plan, List[str]]:
        if isinstance(body, ast.SetExpr):
            lplan, lcols = self._plan_body(body.left, scope)
            rplan, rcols = self._plan_body(body.right, scope)
            if len(lcols) != len(rcols):
                raise PlanError("set operation column count mismatch")
            return lp.SetOp(body.kind, lplan, rplan, body.all), lcols
        if isinstance(body, ast.Select):
            return self._plan_select(body, scope)
        if isinstance(body, ast.SubqueryRef):  # parenthesized query
            return self.plan_query(body.query, scope)
        raise PlanError(f"unsupported query body {type(body).__name__}")

    # -- FROM ----------------------------------------------------------------

    def _plan_from(self, node: Optional[ast.Node],
                   scope: Scope) -> lp.Plan:
        if node is None:
            import numpy as _np
            from ndstpu_torch.engine.columnar import Column, Table
            one = Table({"#dummy": Column(_np.zeros(1, _np.int32), INT32)})
            return lp.InlineTable(one, "dual")
        if isinstance(node, ast.TableRef):
            alias = node.alias or node.name
            if node.name in self.views:
                # each reference gets its own copy: the optimizer mutates
                # plans in place (predicates/column pruning)
                sub = lp.copy_plan(self.views[node.name])
                cols = self._plan_output_names(sub)
                src = Source(alias, cols)
                scope.add(src)
                return lp.Project(sub, [
                    (src.internal(c), ex.ColumnRef(c)) for c in cols])
            if node.name not in self.catalog.tables:
                raise PlanError(f"unknown table {node.name}")
            base_cols = self.catalog.tables[node.name].column_names
            src = Source(alias, list(base_cols))
            scope.add(src)
            scan = lp.Scan(node.name, alias)
            return lp.Project(scan, [
                (src.internal(c), ex.ColumnRef(c)) for c in base_cols])
        if isinstance(node, ast.SubqueryRef):
            sub, cols = self.plan_query(node.query, scope)
            names = node.column_aliases or self._display_names(cols)
            src = Source(node.alias, names)
            scope.add(src)
            return lp.Project(sub, [
                (src.internal(n), ex.ColumnRef(c))
                for n, c in zip(names, cols)])
        if isinstance(node, ast.JoinRef):
            left = self._plan_from(node.left, scope)
            right = self._plan_from(node.right, scope)
            if node.kind == "cross" and node.condition is None:
                return lp.Join(left, right, "cross", [])
            cond = self._bind(node.condition, scope) \
                if node.condition is not None else None
            keys, extra = self._split_equi_keys(cond, left, right)
            if not keys and node.kind in ("left", "right", "full"):
                raise PlanError(f"non-equi {node.kind} join unsupported")
            return lp.Join(left, right, node.kind, keys, extra)
        raise PlanError(f"unsupported FROM node {type(node).__name__}")

    def _plan_output_names(self, p: lp.Plan) -> List[str]:
        if isinstance(p, lp.Project):
            return [n for n, _ in p.exprs]
        if isinstance(p, lp.Aggregate):
            return [n for n, _ in p.group_by] + [n for n, _ in p.aggs]
        if isinstance(p, (lp.Filter, lp.Sort, lp.Limit, lp.Distinct)):
            return self._plan_output_names(p.child)
        if isinstance(p, lp.SetOp):
            return self._plan_output_names(p.left)
        if isinstance(p, lp.InlineTable):
            return list(p.table.column_names)
        if isinstance(p, lp.Window):
            return self._plan_output_names(p.child) + [n for n, _ in p.exprs]
        if isinstance(p, lp.Join):
            if p.kind == "mark":
                return self._plan_output_names(p.left) + [p.mark]
            if p.kind in ("semi", "anti", "nullaware_anti"):
                return self._plan_output_names(p.left)
            return (self._plan_output_names(p.left) +
                    self._plan_output_names(p.right))
        if isinstance(p, lp.SubqueryAlias):
            return self._plan_output_names(p.child)
        raise PlanError(f"output names of {type(p).__name__}")

    def _plan_columns(self, p: lp.Plan) -> set:
        return set(self._plan_output_names(p))

    def _split_equi_keys(self, cond: Optional[ex.Expr], left: lp.Plan,
                         right: lp.Plan):
        """Split a bound join condition into equi-key pairs + residual."""
        if cond is None:
            return [], None
        lcols = self._plan_columns(left)
        rcols = self._plan_columns(right)
        keys: List[Tuple[ex.Expr, ex.Expr]] = []
        residual: List[ex.Expr] = []

        def side(e: ex.Expr) -> Optional[str]:
            cols = [n.name for n in e.walk() if isinstance(n, ex.ColumnRef)]
            if not cols:
                return "either"
            if all(c in lcols for c in cols):
                return "l"
            if all(c in rcols for c in cols):
                return "r"
            return None

        for conj in _conjuncts(cond):
            if isinstance(conj, ex.BinOp) and conj.op == "=":
                ls, rs = side(conj.left), side(conj.right)
                if ls == "l" and rs == "r":
                    keys.append((conj.left, conj.right))
                    continue
                if ls == "r" and rs == "l":
                    keys.append((conj.right, conj.left))
                    continue
            residual.append(conj)
        extra = _conjoin(residual)
        return keys, extra

    # -- SELECT --------------------------------------------------------------

    def _plan_select(self, sel: ast.Select, parent: Optional[Scope],
                     order_by=None) -> Tuple[lp.Plan, List[str]]:
        scope = Scope(parent)
        plan = self._plan_from(sel.from_, scope)

        if sel.where is not None:
            plan = self._apply_where(plan, sel.where, scope)

        # expand stars
        items: List[Tuple[Optional[str], ast.Node]] = []
        for it in sel.items:
            if isinstance(it.expr, ast.StarExpr):
                for s in scope.sources:
                    if it.expr.table is None or it.expr.table == s.alias:
                        for c in s.columns:
                            items.append((c, ast.Col(s.alias, c)))
            else:
                items.append((it.alias, it.expr))

        bound: List[Tuple[Optional[str], ex.Expr]] = []
        has_agg = sel.group is not None or sel.having is not None
        has_window = False
        for alias, e in items:
            be = self._bind(e, scope)
            if _contains_agg(be):
                has_agg = True
            if _contains_window(be):
                has_window = True
            bound.append((alias, be))

        if has_agg:
            plan, cols = self._plan_aggregate(plan, sel, scope, items, bound,
                                              order_by)
            if sel.distinct:
                plan = lp.Distinct(plan)
            return plan, cols

        if has_window:
            plan, cols = self._plan_window_select(plan, scope, items, bound)
        else:
            exprs = []
            cols = []
            seen: Dict[str, int] = {}
            for i, (alias, be) in enumerate(bound):
                name = alias or self._expr_display(items[i][1], i)
                if name in seen:
                    seen[name] += 1
                    name = f"{name}_{seen[name]}"
                else:
                    seen[name] = 0
                exprs.append((name, be))
                cols.append(name)
            plan = lp.Project(plan, exprs)
        if sel.distinct:
            plan = lp.Distinct(plan)
        if order_by:
            # resolve keys against output; unresolvable keys become hidden
            # projected columns bound in the select scope
            keys: List[Tuple[ex.Expr, bool]] = []
            hidden: List[Tuple[str, ex.Expr]] = []
            for e, asc, nf in order_by:
                try:
                    keys.append((self._resolve_order_key(e, cols, bound,
                                                         items), asc, nf))
                except PlanError:
                    if sel.distinct:
                        raise
                    name = self.fresh("o")
                    hidden.append((name, self._bind(e, scope)))
                    keys.append((ex.ColumnRef(name), asc, nf))
            if hidden:
                assert isinstance(plan, lp.Plan)
                # widen the projection, sort, then narrow back
                inner = plan
                if isinstance(inner, lp.Project):
                    inner.exprs = inner.exprs + hidden
                    plan = lp.Project(lp.Sort(inner, keys),
                                      [(c, ex.ColumnRef(c)) for c in cols])
                else:
                    plan = lp.Project(
                        lp.Sort(lp.Project(inner, [
                            (c, ex.ColumnRef(c)) for c in cols] + hidden),
                            keys),
                        [(c, ex.ColumnRef(c)) for c in cols])
            else:
                plan = lp.Sort(plan, keys)
        return plan, cols

    def _resolve_order_key(self, e: ast.Node, cols: List[str], bound,
                           items) -> ex.Expr:
        """Match an ORDER BY key against the select output (position, alias,
        unique base name, or identical expression)."""
        if isinstance(e, ast.Lit) and isinstance(e.value, int):
            return ex.ColumnRef(cols[e.value - 1])
        # identical expression to some select item
        try:
            scope_free = self._bind_against_output(e, cols)
            return scope_free
        except PlanError:
            pass
        raise PlanError("order key not in output")

    def _expr_display(self, e: ast.Node, i: int) -> str:
        if isinstance(e, ast.Col):
            return e.name
        return f"#c{i}"

    # -- WHERE + decorrelation ----------------------------------------------

    def _apply_where(self, plan: lp.Plan, where: ast.Node,
                     scope: Scope) -> lp.Plan:
        plain: List[ex.Expr] = []
        for conj in _ast_conjuncts(where):
            handled, plan = self._try_subquery_conjunct(plan, conj, scope)
            if handled:
                continue
            if _ast_contains_exists(conj):
                # EXISTS under OR (q10/q35 shape): plan each EXISTS as a
                # mark join producing a boolean column, then filter on the
                # rewritten predicate referencing the marks
                plan, conj = self._rewrite_exists_marks(plan, conj, scope)
            plain.append(self._bind(conj, scope))
        cond = _conjoin(plain)
        if cond is not None:
            plan = lp.Filter(plan, cond)
        return plan

    def _rewrite_exists_marks(self, plan: lp.Plan, node: ast.Node,
                              scope: Scope) -> Tuple[lp.Plan, ast.Node]:
        """Replace every EXISTS inside an arbitrary boolean expression with
        a MarkRef to a mark-join column appended to `plan`."""
        import dataclasses as _dc

        def walk(n):
            nonlocal plan
            if isinstance(n, ast.Exists):
                name = self.fresh("mark")
                plan = self._plan_exists_mark(plan, n.query, scope, name)
                ref: ast.Node = ast.MarkRef(name)
                return ast.Un("not", ref) if n.negated else ref
            if isinstance(n, (ast.ScalarQuery, ast.InQuery, ast.Query)):
                return n
            if isinstance(n, ast.Node):
                kw = {f.name: walk_val(getattr(n, f.name))
                      for f in _dc.fields(n)}
                return type(n)(**kw)
            return n

        def walk_val(v):
            if isinstance(v, ast.Node):
                return walk(v)
            if isinstance(v, list):
                return [walk_val(x) for x in v]
            if isinstance(v, tuple):
                return tuple(walk_val(x) for x in v)
            return v

        rewritten = walk(node)  # mutates `plan` via nonlocal
        return plan, rewritten

    def _plan_exists_mark(self, plan: lp.Plan, q: ast.Query, scope: Scope,
                          name: str) -> lp.Plan:
        sub_scope = Scope(scope)
        sub_plan, _cols = self.plan_query(q, sub_scope)
        if not sub_scope.outer_refs:
            raise PlanError("uncorrelated EXISTS unsupported")
        sub_plan, corr, residual = self._extract_correlation(
            sub_plan, scope, collect_residual=True)
        if not corr:
            raise PlanError("EXISTS without equality correlation unsupported")
        keys = [(ex.ColumnRef(o), ex.ColumnRef(i)) for o, i in corr]
        return lp.Join(plan, sub_plan, "mark", keys, _conjoin(residual), name)

    def _try_subquery_conjunct(self, plan: lp.Plan, conj: ast.Node,
                               scope: Scope) -> Tuple[bool, lp.Plan]:
        # x IN (subquery) / x NOT IN (subquery)
        if isinstance(conj, ast.InQuery):
            return True, self._plan_in_subquery(plan, conj, scope)
        if isinstance(conj, ast.Un) and conj.op == "not" and \
                isinstance(conj.operand, ast.InQuery):
            inner = conj.operand
            return True, self._plan_in_subquery(
                plan, ast.InQuery(inner.operand, inner.query,
                                  not inner.negated), scope)
        # EXISTS / NOT EXISTS
        if isinstance(conj, ast.Exists):
            return True, self._plan_exists(plan, conj.query, conj.negated,
                                           scope)
        if isinstance(conj, ast.Un) and conj.op == "not" and \
                isinstance(conj.operand, ast.Exists):
            return True, self._plan_exists(plan, conj.operand.query,
                                           not conj.operand.negated, scope)
        # comparison against a (possibly arithmetic-wrapped) correlated
        # scalar aggregate: x > (sub), x > 1.2 * (sub), ...
        if isinstance(conj, ast.Bin) and conj.op in ("=", "<>", "<", "<=",
                                                     ">", ">="):
            for this, other, flip in ((conj.right, conj.left, False),
                                      (conj.left, conj.right, True)):
                sub = _find_scalar_subquery(this)
                if sub is None:
                    continue
                sub_scope = Scope(scope)
                sub_plan, sub_cols = self.plan_query(sub.query, sub_scope)
                if sub_scope.outer_refs:
                    op = conj.op if not flip else _flip_op(conj.op)
                    # wrapper expression around the subquery value
                    marker = "__scalar__"
                    wrapped_ast = _replace_scalar_subquery(
                        this, sub, ast.Col(None, marker))
                    return True, self._plan_corr_scalar_cmp(
                        plan, other, op, sub_plan, sub_cols, scope,
                        wrapped_ast, marker)
                # uncorrelated: leave as SubqueryExpr literal
                be = ex.BinOp(
                    conj.op,
                    self._bind(conj.left, scope),
                    self._bind(conj.right, scope))
                return True, lp.Filter(plan, be)
        return False, plan

    def _plan_in_subquery(self, plan: lp.Plan, node: ast.InQuery,
                          scope: Scope) -> lp.Plan:
        operand = self._bind(node.operand, scope)
        sub_scope = Scope(scope)
        sub_plan, sub_cols = self.plan_query(node.query, sub_scope)
        if len(sub_cols) != 1:
            raise PlanError("IN subquery must produce one column")
        if sub_scope.outer_refs:
            # correlated IN: extract equality correlation from the subplan
            sub_plan, corr = self._extract_correlation(sub_plan, scope)
            keys = [(operand, ex.ColumnRef(sub_cols[0]))] + \
                [(ex.ColumnRef(o), ex.ColumnRef(i)) for o, i in corr]
            return lp.Join(plan, sub_plan,
                           "anti" if node.negated else "semi", keys)
        kind = "nullaware_anti" if node.negated else "semi"
        return lp.Join(plan, sub_plan, kind,
                       [(operand, ex.ColumnRef(sub_cols[0]))])

    def _plan_exists(self, plan: lp.Plan, q: ast.Query, negated: bool,
                     scope: Scope) -> lp.Plan:
        sub_scope = Scope(scope)
        sub_plan, _cols = self.plan_query(q, sub_scope)
        if not sub_scope.outer_refs:
            raise PlanError("uncorrelated EXISTS unsupported")
        sub_plan, corr, residual = self._extract_correlation(
            sub_plan, scope, collect_residual=True)
        if not corr:
            raise PlanError("EXISTS without equality correlation unsupported")
        keys = [(ex.ColumnRef(o), ex.ColumnRef(i)) for o, i in corr]
        return lp.Join(plan, sub_plan, "anti" if negated else "semi", keys,
                       _conjoin(residual))

    def _extract_correlation(self, sub_plan: lp.Plan, outer_scope: Scope,
                             collect_residual: bool = False):
        """Pull `outer_col = inner_col` predicates out of the subplan's
        filters.  Returns (rewritten subplan, [(outer_internal,
        inner_internal)]) — plus a residual predicate list when
        `collect_residual` (non-equi correlated conjuncts like
        ``cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk`` in q16/q94, which
        become the semi/anti join's `extra`)."""
        outer_cols = set()
        sc = outer_scope
        while sc is not None:
            for s in sc.sources:
                for c in s.columns:
                    outer_cols.add(s.internal(c))
            sc = sc.parent

        corr: List[Tuple[str, str]] = []
        residual: List[ex.Expr] = []
        residual_inner: List[str] = []  # inner cols the residual needs

        def rewrite(p: lp.Plan) -> lp.Plan:
            if isinstance(p, lp.Filter):
                child = rewrite(p.child)
                child_cols = self._plan_columns(child)
                keep: List[ex.Expr] = []
                for conj in _conjuncts(_factor_or_common(p.condition)):
                    if isinstance(conj, ex.BinOp) and conj.op == "=" and \
                            isinstance(conj.left, ex.ColumnRef) and \
                            isinstance(conj.right, ex.ColumnRef):
                        # the outer side must NOT be producible by the
                        # subplan itself (membership in outer_cols alone is
                        # ambiguous when inner and outer scan the same
                        # unaliased table, e.g. q32/q92 catalog_sales)
                        l, r = conj.left.name, conj.right.name
                        if l in outer_cols and l not in child_cols and \
                                r in child_cols:
                            corr.append((l, r))
                            continue
                        if r in outer_cols and r not in child_cols and \
                                l in child_cols:
                            corr.append((r, l))
                            continue
                    if collect_residual:
                        refs = {n.name for n in conj.walk()
                                if isinstance(n, ex.ColumnRef)}
                        out_refs = refs & (outer_cols - child_cols)
                        if out_refs and (refs - out_refs) <= child_cols:
                            residual.append(conj)
                            residual_inner.extend(refs & child_cols)
                            continue
                    keep.append(conj)
                cond = _conjoin(keep)
                return lp.Filter(child, cond) if cond is not None else child
            if isinstance(p, lp.Project):
                # push through projects that just rename
                return lp.Project(rewrite(p.child), p.exprs)
            for attr in ("child",):
                if hasattr(p, attr):
                    setattr(p, attr, rewrite(getattr(p, attr)))
                    return p
            return p

        sub_plan = rewrite(sub_plan)
        # correlation columns must be visible in subplan output for the join:
        # wrap subplan in a project exposing them
        sub_cols = self._plan_output_names(sub_plan)
        missing = [i for i in
                   dict.fromkeys([i for _o, i in corr] + residual_inner)
                   if i not in sub_cols]
        if missing:
            sub_plan = _expose_columns(sub_plan, missing)
        if collect_residual:
            return sub_plan, corr, residual
        return sub_plan, corr

    def _plan_corr_scalar_cmp(self, plan: lp.Plan, other_ast: ast.Node,
                              op: str, sub_plan: lp.Plan,
                              sub_cols: List[str], scope: Scope,
                              wrapper_ast: Optional[ast.Node] = None,
                              marker: Optional[str] = None) -> lp.Plan:
        """outer_expr <op> f(correlated scalar aggregate subquery) — f is an
        optional arithmetic wrapper with the subquery replaced by `marker`."""
        sub_plan, corr = self._extract_correlation(sub_plan, scope)
        if not corr:
            raise PlanError("correlated scalar subquery without equality "
                            "correlation unsupported")
        # the subplan must be an Aggregate (possibly under projects); group it
        # by its correlation keys
        agg = _find_aggregate(sub_plan)
        if agg is None:
            raise PlanError("correlated scalar subquery must aggregate")
        inner_keys = [i for _o, i in corr]
        agg.group_by = agg.group_by + [(k, ex.ColumnRef(k))
                                      for k in inner_keys
                                      if k not in [n for n, _ in agg.group_by]]
        sub_plan = _expose_columns(sub_plan, inner_keys)
        other = self._bind(other_ast, scope)
        val_col = sub_cols[0]
        keys = [(ex.ColumnRef(o), ex.ColumnRef(i)) for o, i in corr]
        joined = lp.Join(plan, sub_plan, "inner", keys)
        if wrapper_ast is not None and not (
                isinstance(wrapper_ast, ast.Col) and
                wrapper_ast.name == marker):
            value = self._bind(wrapper_ast, scope,
                               alias_map={marker: ex.ColumnRef(val_col)})
        else:
            value = ex.ColumnRef(val_col)
        cond = ex.BinOp(op, other, value)
        filtered = lp.Filter(joined, cond)
        # project away subquery columns
        keep = self._plan_output_names(plan)
        return lp.Project(filtered, [(c, ex.ColumnRef(c)) for c in keep])

    # -- aggregate select ----------------------------------------------------

    def _plan_aggregate(self, plan: lp.Plan, sel: ast.Select, scope: Scope,
                        items, bound,
                        order_by=None) -> Tuple[lp.Plan, List[str]]:
        group_keys: List[Tuple[str, ex.Expr]] = []
        key_repr: Dict[str, str] = {}  # repr(bound expr) -> key name
        gsets: Optional[List[List[int]]] = None
        alias_map = {alias: be for (alias, _e), (a2, be) in
                     zip([(a, e) for a, e in items], bound) if alias}
        if sel.group is not None:
            gexprs = []
            for e in sel.group.exprs:
                # group-by alias or position
                if isinstance(e, ast.Col) and e.table is None and \
                        e.name in alias_map:
                    be = alias_map[e.name]
                elif isinstance(e, ast.Lit) and isinstance(e.value, int):
                    be = bound[e.value - 1][1]
                else:
                    be = self._bind(e, scope)
                gexprs.append(be)
            for i, be in enumerate(gexprs):
                name = self.fresh("g")
                group_keys.append((name, be))
                key_repr[repr(be)] = name
            if sel.group.kind == "rollup":
                n = len(group_keys)
                gsets = [list(range(k)) for k in range(n, -1, -1)]
            elif sel.group.kind == "cube":
                n = len(group_keys)
                gsets = [[i for i in range(n) if (m >> i) & 1]
                         for m in range(2 ** n - 1, -1, -1)]
            elif sel.group.kind == "sets":
                gsets = []
                for s in sel.group.sets:
                    idxs = []
                    for e in s:
                        be = self._bind(e, scope)
                        if repr(be) not in key_repr:
                            raise PlanError("grouping set expr not in keys")
                        idxs.append([n for n, _ in group_keys].index(
                            key_repr[repr(be)]))
                    gsets.append(idxs)

        aggs: List[Tuple[str, ex.Expr]] = []
        wexprs: List[Tuple[str, ex.Expr]] = []  # windows over the aggregate
        out_names: List[str] = []
        out_exprs: List[Tuple[str, ex.Expr]] = []

        agg_seen: Dict[str, str] = {}  # repr(AggExpr) -> hidden column name

        def hidden_agg(be: ex.Expr) -> ex.Expr:
            r = repr(be)
            if r not in agg_seen:
                h = self.fresh("a")
                aggs.append((h, be))
                agg_seen[r] = h
            return ex.ColumnRef(agg_seen[r])

        def to_agg_output(be: ex.Expr) -> ex.Expr:
            """Rewrite a select expression into one over the aggregate's
            OUTPUT columns: group-key subtrees -> key refs, AggExprs (and
            grouping()) -> hidden aggregate columns, windows hoisted above
            the Aggregate node."""
            r = repr(be)
            if r in key_repr:
                return ex.ColumnRef(key_repr[r])
            if isinstance(be, ex.AggExpr):
                return hidden_agg(be)
            if isinstance(be, ex.Func) and be.name == "grouping":
                # rewrite the argument to the generated group-key name so the
                # executor can match it against the grouping-set subset
                return hidden_agg(ex.Func(
                    "grouping", (to_agg_output(be.args[0]),)))
            if isinstance(be, ex.BinOp):
                return ex.BinOp(be.op, to_agg_output(be.left),
                                to_agg_output(be.right))
            if isinstance(be, ex.Cast):
                return ex.Cast(to_agg_output(be.operand), be.target)
            if isinstance(be, ex.Func):
                return ex.Func(be.name,
                               tuple(to_agg_output(a) for a in be.args))
            if isinstance(be, ex.InList):
                return ex.InList(to_agg_output(be.operand), be.values,
                                 be.negated)
            if isinstance(be, ex.Case):
                return ex.Case(tuple((to_agg_output(c), to_agg_output(v))
                                     for c, v in be.whens),
                               to_agg_output(be.default)
                               if be.default is not None else None)
            if isinstance(be, (ex.Literal,)):
                return be
            if isinstance(be, ex.SubqueryExpr) and not be.correlated_predicates:
                # uncorrelated scalar subquery (e.g. q44's HAVING
                # `avg(x) > 0.9 * (select ...)`) — a constant at exec time
                return be
            if isinstance(be, ex.UnaryOp):
                return ex.UnaryOp(be.op, to_agg_output(be.operand))
            if isinstance(be, ex.WindowExpr):
                # window over the aggregate output (revenue-ratio pattern):
                # components become post-aggregate exprs, the WindowExpr is
                # hoisted above the Aggregate node
                w2 = ex.WindowExpr(
                    be.func,
                    None if be.arg is None or isinstance(be.arg, ex.Star)
                    else to_agg_output(be.arg),
                    tuple(to_agg_output(x) for x in be.partition_by),
                    tuple((to_agg_output(o), asc)
                          for o, asc in be.order_by),
                    be.frame)
                name = self.fresh("w")
                wexprs.append((name, w2))
                return ex.ColumnRef(name)
            raise PlanError(
                f"select expr not derivable from group keys/aggregates: {be}")

        seen_names: Dict[str, int] = {}
        for i, (alias, be) in enumerate(bound):
            name = alias or self._expr_display(items[i][1], i)
            if name in seen_names:
                seen_names[name] += 1
                name = f"{name}_{seen_names[name]}"
            else:
                seen_names[name] = 0
            out_exprs.append((name, to_agg_output(be)))
            out_names.append(name)

        agg_plan = lp.Aggregate(plan, group_keys, aggs, gsets)

        if sel.having is not None:
            hb = self._bind(sel.having, scope, allow_aggs=True,
                            alias_map=alias_map)
            agg_plan = lp.Filter(agg_plan, to_agg_output(hb))

        keys: List[Tuple] = []
        hidden: List[Tuple[str, ex.Expr]] = []
        if order_by:
            for e, asc, nf in order_by:
                try:
                    keys.append((self._resolve_order_key(e, out_names, bound,
                                                         items), asc, nf))
                    continue
                except PlanError:
                    pass
                be = self._bind(e, scope, allow_aggs=True,
                                alias_map=alias_map)
                # to_agg_output registers new aggregates on the shared aggs
                # list (the Aggregate node holds the same object) and may
                # hoist new window exprs — the Window node is built below,
                # after all select AND order-by expressions are processed
                name = self.fresh("o")
                hidden.append((name, to_agg_output(be)))
                keys.append((ex.ColumnRef(name), asc, nf))

        if wexprs:
            # windows computed over the (filtered) aggregate output
            agg_plan = lp.Window(agg_plan, wexprs)

        if order_by:
            proj = lp.Project(lp.Sort(
                lp.Project(agg_plan, out_exprs + hidden), keys),
                [(n, ex.ColumnRef(n)) for n in out_names])
            return proj, out_names
        proj = lp.Project(agg_plan, out_exprs)
        return proj, out_names

    def _plan_window_select(self, plan: lp.Plan, scope: Scope, items,
                            bound) -> Tuple[lp.Plan, List[str]]:
        wexprs: List[Tuple[str, ex.Expr]] = []
        out_exprs: List[Tuple[str, ex.Expr]] = []
        out_names: List[str] = []

        def hoist(be: ex.Expr) -> ex.Expr:
            if isinstance(be, ex.WindowExpr):
                name = self.fresh("w")
                wexprs.append((name, be))
                return ex.ColumnRef(name)
            if isinstance(be, ex.BinOp):
                return ex.BinOp(be.op, hoist(be.left), hoist(be.right))
            if isinstance(be, ex.Cast):
                return ex.Cast(hoist(be.operand), be.target)
            if isinstance(be, ex.Func):
                return ex.Func(be.name, tuple(hoist(a) for a in be.args))
            return be

        for i, (alias, be) in enumerate(bound):
            name = alias or self._expr_display(items[i][1], i)
            out_exprs.append((name, hoist(be)))
            out_names.append(name)
        wplan = lp.Window(plan, wexprs)
        return lp.Project(wplan, out_exprs), out_names

    # -- ORDER BY ------------------------------------------------------------

    def _apply_order(self, plan: lp.Plan, cols: List[str], order_by,
                     scope: Optional[Scope]) -> lp.Plan:
        keys: List[Tuple] = []
        for e, asc, nf in order_by:
            if isinstance(e, ast.Lit) and isinstance(e.value, int):
                keys.append((ex.ColumnRef(cols[e.value - 1]), asc, nf))
                continue
            if isinstance(e, ast.Col) and e.table is None and e.name in cols:
                keys.append((ex.ColumnRef(e.name), asc, nf))
                continue
            try:
                be = self._bind_against_output(e, cols)
                keys.append((be, asc, nf))
            except PlanError:
                if scope is None:
                    raise
                keys.append((self._bind(e, scope), asc, nf))
        return lp.Sort(plan, keys)

    def _bind_against_output(self, e: ast.Node, cols: List[str]) -> ex.Expr:
        if isinstance(e, ast.Col) and e.table is None:
            if e.name in cols:
                return ex.ColumnRef(e.name)
            raise PlanError(f"order-by column {e.name} not in output")
        if isinstance(e, ast.Col):
            # qualified ref: the projection dropped the qualifier — match by
            # base name if unambiguous (ORDER BY s.qty after SELECT s.qty)
            if f"{e.table}.{e.name}" in cols:
                return ex.ColumnRef(f"{e.table}.{e.name}")
            hits = [c for c in cols if c == e.name or
                    c.split(".")[-1] == e.name]
            if len(hits) == 1:
                return ex.ColumnRef(hits[0])
            raise PlanError("qualified order-by ref not in output")
        if isinstance(e, ast.Bin):
            return ex.BinOp(e.op, self._bind_against_output(e.left, cols),
                            self._bind_against_output(e.right, cols))
        if isinstance(e, ast.Lit):
            return ex.Literal(e.value)
        if isinstance(e, ast.FuncCall):
            return ex.Func(e.name, tuple(
                self._bind_against_output(a, cols) for a in e.args))
        raise PlanError(f"unsupported order-by expr {type(e).__name__}")

    # -- expression binding --------------------------------------------------

    _AGG_FUNCS = {"sum", "avg", "count", "min", "max", "stddev_samp",
                  "stddev", "var_samp", "variance"}
    _WINDOW_FUNCS = {"rank", "dense_rank", "row_number"}

    def _bind(self, e: ast.Node, scope: Scope, allow_aggs: bool = True,
              alias_map: Optional[Dict[str, ex.Expr]] = None) -> ex.Expr:
        b = lambda x: self._bind(x, scope, allow_aggs, alias_map)  # noqa: E731
        if isinstance(e, ast.Col):
            if alias_map and e.table is None and e.name in alias_map:
                return alias_map[e.name]
            name, _outer = scope.resolve(e.table, e.name)
            return ex.ColumnRef(name)
        if isinstance(e, ast.MarkRef):
            return ex.ColumnRef(e.name)
        if isinstance(e, ast.Lit):
            return ex.Literal(e.value)
        if isinstance(e, ast.DateLit):
            return ex.Literal(_date_to_days(e.value), DATE)
        if isinstance(e, ast.Interval):
            if e.unit != "days":
                raise PlanError(f"interval unit {e.unit} unsupported")
            return ex.Literal(e.n)
        if isinstance(e, ast.Bin):
            if e.op.endswith(("_all", "_any", "_some")):
                return self._bind_quantified(e, scope)
            return ex.BinOp(e.op, b(e.left), b(e.right))
        if isinstance(e, ast.Un):
            return ex.UnaryOp("not" if e.op == "not" else "neg", b(e.operand))
        if isinstance(e, ast.IsNull):
            return ex.UnaryOp("isnotnull" if e.negated else "isnull",
                              b(e.operand))
        if isinstance(e, ast.Between):
            lo = ex.BinOp(">=", b(e.operand), b(e.lo))
            hi = ex.BinOp("<=", b(e.operand), b(e.hi))
            both = ex.BinOp("and", lo, hi)
            return ex.UnaryOp("not", both) if e.negated else both
        if isinstance(e, ast.InVals):
            vals = []
            for v in e.values:
                if isinstance(v, ast.Lit):
                    vals.append(v.value)
                elif isinstance(v, ast.DateLit):
                    vals.append(_date_to_days(v.value))
                elif isinstance(v, ast.Un) and v.op == "neg" and \
                        isinstance(v.operand, ast.Lit):
                    vals.append(-v.operand.value)
                else:
                    # non-literal IN list: expand to OR chain
                    ors = None
                    for v2 in e.values:
                        eq = ex.BinOp("=", b(e.operand), b(v2))
                        ors = eq if ors is None else ex.BinOp("or", ors, eq)
                    return ex.UnaryOp("not", ors) if e.negated else ors
            return ex.InList(b(e.operand), tuple(vals), e.negated)
        if isinstance(e, ast.LikeOp):
            like = ex.Func("like", (b(e.operand), ex.Literal(e.pattern)))
            return ex.UnaryOp("not", like) if e.negated else like
        if isinstance(e, ast.CaseExpr):
            if e.operand is not None:
                whens = tuple(
                    (ex.BinOp("=", b(e.operand), b(c)), b(v))
                    for c, v in e.whens)
            else:
                whens = tuple((b(c), b(v)) for c, v in e.whens)
            return ex.Case(whens, b(e.default) if e.default is not None
                           else None)
        if isinstance(e, ast.CastExpr):
            return ex.Cast(b(e.operand), _parse_type(e.type_name))
        if isinstance(e, ast.FuncCall):
            if e.name in self._AGG_FUNCS:
                if not allow_aggs:
                    raise PlanError(f"aggregate {e.name} not allowed here")
                arg = ex.Star() if e.star else b(e.args[0])
                fname = "stddev_samp" if e.name == "stddev" else e.name
                return ex.AggExpr(fname, arg, e.distinct)
            if e.name == "grouping":
                return ex.Func("grouping", (b(e.args[0]),))
            return ex.Func(e.name, tuple(b(a) for a in e.args))
        if isinstance(e, ast.WindowCall):
            fc = e.func
            arg = None
            if fc.star:
                arg = ex.Star()
            elif fc.args:
                arg = b(fc.args[0])
            return ex.WindowExpr(
                fc.name, arg,
                tuple(b(p) for p in e.partition_by),
                tuple((b(o), asc) for o, asc in e.order_by),
                e.frame)
        if isinstance(e, ast.ScalarQuery):
            sub_scope = Scope(scope)
            sub_plan, sub_cols = self.plan_query(e.query, sub_scope)
            if sub_scope.outer_refs:
                raise PlanError("correlated scalar subquery in this position "
                                "unsupported")
            return ex.SubqueryExpr("scalar", sub_plan)
        if isinstance(e, ast.InQuery):
            sub_scope = Scope(scope)
            sub_plan, sub_cols = self.plan_query(e.query, sub_scope)
            if sub_scope.outer_refs:
                raise PlanError("correlated IN in this position unsupported")
            return ex.SubqueryExpr("in", sub_plan, self._bind(e.operand,
                                                              scope),
                                   e.negated)
        if isinstance(e, ast.Exists):
            raise PlanError("EXISTS only supported as a WHERE conjunct")
        raise PlanError(f"unsupported expression {type(e).__name__}")

    def _bind_quantified(self, e: ast.Bin, scope: Scope) -> ex.Expr:
        """x <op> ALL/ANY (subquery) -> comparison against min/max of the
        subquery (empty-subquery edge: yields NULL instead of TRUE for ALL —
        acceptable for the benchmark corpus, which never hits it)."""
        op, quant = e.op.rsplit("_", 1)
        if quant == "some":
            quant = "any"
        assert isinstance(e.right, ast.ScalarQuery)
        if quant == "any" and op == "=":
            return self._bind(ast.InQuery(e.left, e.right.query, False),
                              scope)
        agg = {("<", "all"): "min", ("<=", "all"): "min",
               (">", "all"): "max", (">=", "all"): "max",
               ("<", "any"): "max", ("<=", "any"): "max",
               (">", "any"): "min", (">=", "any"): "min"}.get((op, quant))
        if agg is None:
            raise PlanError(f"unsupported quantified comparison {e.op}")
        sub_scope = Scope(scope)
        sub_plan, sub_cols = self.plan_query(e.right.query, sub_scope)
        if sub_scope.outer_refs:
            raise PlanError("correlated quantified subquery unsupported")
        name = self.fresh("q")
        agg_plan = lp.Aggregate(sub_plan, [], [
            (name, ex.AggExpr(agg, ex.ColumnRef(sub_cols[0])))])
        return ex.BinOp(op, self._bind(e.left, scope),
                        ex.SubqueryExpr("scalar", agg_plan))


# -- helpers -----------------------------------------------------------------


def _conjuncts(e: Optional[ex.Expr]) -> List[ex.Expr]:
    if e is None:
        return []
    if isinstance(e, ex.BinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _ast_conjuncts(e: ast.Node) -> List[ast.Node]:
    if isinstance(e, ast.Bin) and e.op == "and":
        return _ast_conjuncts(e.left) + _ast_conjuncts(e.right)
    return [e]


def _ast_contains_exists(e) -> bool:
    """True if an EXISTS occurs anywhere inside the expression (without
    descending into nested sub-queries, whose own planning handles them)."""
    import dataclasses as _dc
    if isinstance(e, ast.Exists):
        return True
    if isinstance(e, (ast.ScalarQuery, ast.InQuery, ast.Query)):
        return False
    if isinstance(e, ast.Node):
        return any(_ast_contains_exists(getattr(e, f.name))
                   for f in _dc.fields(e))
    if isinstance(e, (list, tuple)):
        return any(_ast_contains_exists(x) for x in e)
    return False


def _factor_or_common(e: ex.Expr) -> ex.Expr:
    """Factor conjuncts common to both branches of an OR:
    ``(A and X) or (A and Y)`` -> ``A and (X or Y)`` (recursively).  Makes
    equality correlations inside disjunctions visible to the decorrelator
    (q41 shape)."""
    if isinstance(e, ex.BinOp) and e.op == "and":
        return ex.BinOp("and", _factor_or_common(e.left),
                        _factor_or_common(e.right))
    if isinstance(e, ex.BinOp) and e.op == "or":
        l = _factor_or_common(e.left)
        r = _factor_or_common(e.right)
        lc, rc = _conjuncts(l), _conjuncts(r)
        common = [c for c in lc if c in rc]
        if not common:
            return ex.BinOp("or", l, r)
        lrest = [c for c in lc if c not in common]
        rrest = [c for c in rc if c not in common]
        if not lrest or not rrest:
            # (A) or (A and X)  ->  A
            return _conjoin(common)
        return _conjoin(common + [ex.BinOp("or", _conjoin(lrest),
                                           _conjoin(rrest))])
    return e


def _conjoin(parts: Sequence[ex.Expr]) -> Optional[ex.Expr]:
    out: Optional[ex.Expr] = None
    for p in parts:
        out = p if out is None else ex.BinOp("and", out, p)
    return out


def _flip_op(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "=": "=", "<>": "<>"}[op]


def _find_scalar_subquery(e: ast.Node):
    """First ScalarQuery inside an arithmetic wrapper (Bin/Un/Cast chains)."""
    if isinstance(e, ast.ScalarQuery):
        return e
    if isinstance(e, ast.Bin):
        return _find_scalar_subquery(e.left) or \
            _find_scalar_subquery(e.right)
    if isinstance(e, ast.Un):
        return _find_scalar_subquery(e.operand)
    if isinstance(e, ast.CastExpr):
        return _find_scalar_subquery(e.operand)
    return None


def _replace_scalar_subquery(e: ast.Node, target, replacement) -> ast.Node:
    if e is target:
        return replacement
    if isinstance(e, ast.Bin):
        return ast.Bin(e.op,
                       _replace_scalar_subquery(e.left, target, replacement),
                       _replace_scalar_subquery(e.right, target, replacement))
    if isinstance(e, ast.Un):
        return ast.Un(e.op,
                      _replace_scalar_subquery(e.operand, target,
                                               replacement))
    if isinstance(e, ast.CastExpr):
        return ast.CastExpr(
            _replace_scalar_subquery(e.operand, target, replacement),
            e.type_name)
    return e


def _contains_agg(e: ex.Expr) -> bool:
    return any(isinstance(x, ex.AggExpr) for x in e.walk())


def _contains_window(e: ex.Expr) -> bool:
    return any(isinstance(x, ex.WindowExpr) for x in e.walk())


def _find_aggregate(p: lp.Plan) -> Optional[lp.Aggregate]:
    if isinstance(p, lp.Aggregate):
        return p
    for c in p.children():
        if isinstance(c, (lp.Aggregate, lp.Project, lp.Filter)):
            found = _find_aggregate(c)
            if found is not None:
                return found
    return None


def _expose_columns(p: lp.Plan, names: List[str]) -> lp.Plan:
    """Ensure `names` appear in p's output by widening trailing Projects."""
    if isinstance(p, lp.Project):
        have = {n for n, _ in p.exprs}
        child_cols = set()
        try:
            child_cols = set(Planner._plan_output_names(Planner, p.child))  # type: ignore
        except Exception:
            pass
        extra = [(n, ex.ColumnRef(n)) for n in names
                 if n not in have and n in child_cols]
        missing = [n for n in names if n not in have and n not in child_cols]
        if missing:
            p.child = _expose_columns(p.child, missing)
            extra += [(n, ex.ColumnRef(n)) for n in missing]
        p.exprs = p.exprs + extra
        return p
    if isinstance(p, lp.Aggregate):
        have = {n for n, _ in p.group_by} | {n for n, _ in p.aggs}
        for n in names:
            if n not in have:
                p.group_by = p.group_by + [(n, ex.ColumnRef(n))]
        return p
    if isinstance(p, (lp.Filter, lp.Sort, lp.Limit, lp.Distinct)):
        p.child = _expose_columns(p.child, names)
        return p
    return p
