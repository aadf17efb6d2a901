"""Bottom-up schema/type inference over the logical plan IR.

Static twin of the two evaluators: for every operator in
``engine/plan.py`` and every expression in ``engine/expr.py`` it derives
the output schema — column name, dtype (kind + decimal precision/scale),
nullability — **without touching data**, mirroring the numpy
``expr.Evaluator`` / jax ``jaxexec.JEval`` result-type rules exactly
(``/`` is always float64 and NULL on zero, decimal ``*`` adds scales at
precision 38, CASE unifies numerics via ``common_type``, COALESCE uses
the shared ``coalesce_common_type``, date ± int stays date, ...).

On top of inference it emits NDS1xx typing diagnostics
(analysis/diagnostics.py): join-key dtype mismatches, lossy casts,
int32-aggregate overflow advisories at a given scale factor, SetOp
arity/type drift, and under-specified sort keys ahead of a LIMIT.

Import-hygienic: numpy only (via engine.columnar) — never jax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ndstpu_torch.engine import expr as ex
from ndstpu_torch.engine import plan as lp
from ndstpu_torch.engine.columnar import (
    BOOL,
    DATE,
    FLOAT64,
    INT32,
    INT64,
    STRING,
    DType,
    decimal,
)
from ndstpu_torch.analysis.diagnostics import Diagnostic

#: row count of the largest SF1 fact table (store_sales ≈ 2.88M rows);
#: the NDS103 overflow advisory scales it linearly with the scale factor.
_SF1_MAX_FACT_ROWS = 2_880_000


@dataclasses.dataclass(frozen=True)
class ColType:
    """Inferred column type; ``ctype is None`` means statically unknown
    (DeviceResult subtrees, unresolved names) — unknown types propagate
    silently and never produce diagnostics."""

    ctype: Optional[DType]
    nullable: bool = True

    @property
    def known(self) -> bool:
        return self.ctype is not None

    @property
    def kind(self) -> Optional[str]:
        return self.ctype.kind if self.ctype is not None else None


UNKNOWN = ColType(None, True)


class Schema:
    """Ordered (name, ColType) list; ``cols=None`` = wholly unknown."""

    def __init__(self, cols: Optional[List[Tuple[str, ColType]]]):
        self.cols = cols

    @property
    def known(self) -> bool:
        return self.cols is not None

    @property
    def names(self) -> List[str]:
        return [n for n, _ in self.cols] if self.known else []

    def get(self, name: str) -> ColType:
        if not self.known:
            return UNKNOWN
        for n, t in self.cols:
            if n == name:
                return t
        return UNKNOWN

    def __repr__(self):
        if not self.known:
            return "Schema(?)"
        return "Schema(" + ", ".join(
            f"{n}:{t.kind or '?'}{'?' if t.nullable else ''}"
            for n, t in self.cols) + ")"


def _child_path(path: str, child: lp.Plan, i: int) -> str:
    return f"{path}/{type(child).__name__}[{i}]"


class TypeChecker:
    """One pass per query part; collects diagnostics in ``self.diags``."""

    def __init__(self, tables: Dict[str, object], query: str = "",
                 scale_factor: Optional[float] = None):
        # tables: name -> ndstpu.schema.TableSchema (ColumnSpec columns)
        self.tables = tables
        self.query = query
        self.scale_factor = scale_factor
        self.diags: List[Diagnostic] = []

    def _emit(self, code: str, message: str, path: str) -> None:
        self.diags.append(Diagnostic(code=code, message=message, path=path,
                                     query=self.query))

    # -- plan nodes ----------------------------------------------------------

    def infer(self, p: lp.Plan, path: str = "") -> Schema:
        path = path or type(p).__name__
        meth = getattr(self, "_infer_" + type(p).__name__.lower(), None)
        if meth is None:
            return Schema(None)
        saved = getattr(self, "_path", "")
        self._path = path
        try:
            return meth(p, path)
        finally:
            self._path = saved

    def _children(self, p: lp.Plan, path: str) -> List[Schema]:
        return [self.infer(c, _child_path(path, c, i))
                for i, c in enumerate(p.children())]

    def _infer_scan(self, p: lp.Scan, path: str) -> Schema:
        ts = self.tables.get(p.table)
        if ts is None:
            return Schema(None)
        names = p.columns if p.columns is not None else \
            [c.name for c in ts.columns]
        specs = {c.name: c for c in ts.columns}
        cols = []
        for n in names:
            spec = specs.get(n)
            cols.append((n, ColType(spec.dtype, spec.nullable)
                         if spec is not None else UNKNOWN))
        return Schema(cols)

    def _infer_inlinetable(self, p: lp.InlineTable, path: str) -> Schema:
        t = p.table
        try:
            return Schema([
                (n, ColType(t.column(n).ctype,
                            t.column(n).valid is not None))
                for n in t.column_names])
        except Exception:
            return Schema(None)

    def _infer_filter(self, p: lp.Filter, path: str) -> Schema:
        child, = self._children(p, path)
        self.expr_type(p.condition, child)
        return child

    def _infer_project(self, p: lp.Project, path: str) -> Schema:
        child, = self._children(p, path)
        return Schema([(n, self.expr_type(e, child)) for n, e in p.exprs])

    def _infer_subqueryalias(self, p: lp.SubqueryAlias,
                             path: str) -> Schema:
        child, = self._children(p, path)
        if p.column_aliases is not None and child.known:
            return Schema([(a, t) for a, (_, t)
                           in zip(p.column_aliases, child.cols)])
        return child

    def _infer_limit(self, p: lp.Limit, path: str) -> Schema:
        child, = self._children(p, path)
        if isinstance(p.child, lp.Sort) and child.known and \
                len(p.child.keys) < len(child.cols):
            # ties among equal sort keys make which rows survive the
            # LIMIT backend-dependent (CPU-vs-TPU validation hazard)
            self._emit(
                "NDS105",
                f"LIMIT {p.n} above a sort on {len(p.child.keys)} of "
                f"{len(child.cols)} output columns: ties are broken "
                "nondeterministically", path)
        return child

    def _infer_distinct(self, p: lp.Distinct, path: str) -> Schema:
        return self._children(p, path)[0]

    def _infer_sort(self, p: lp.Sort, path: str) -> Schema:
        child, = self._children(p, path)
        for entry in p.keys:
            self.expr_type(entry[0], child)
        return child

    def _infer_deviceresult(self, p: lp.DeviceResult, path: str) -> Schema:
        return Schema(None)

    def _infer_setop(self, p: lp.SetOp, path: str) -> Schema:
        left, right = self._children(p, path)
        if not (left.known and right.known):
            return Schema(None)
        if len(left.cols) != len(right.cols):
            self._emit("NDS104",
                       f"{p.kind} arity mismatch: {len(left.cols)} vs "
                       f"{len(right.cols)} columns", path)
            return left
        out = []
        for (n, lt), (rn, rt) in zip(left.cols, right.cols):
            nullable = lt.nullable or rt.nullable
            if not (lt.known and rt.known):
                out.append((n, ColType(None, nullable)))
                continue
            if ex.is_numeric(lt.ctype) and ex.is_numeric(rt.ctype):
                ct = ex.common_type(lt.ctype, rt.ctype)
            elif lt.kind == rt.kind:
                ct = lt.ctype
            else:
                self._emit("NDS104",
                           f"{p.kind} column {n!r}: {lt.kind} vs "
                           f"{rt.kind} ({rn!r})", path)
                ct = lt.ctype
            out.append((n, ColType(ct, nullable)))
        return Schema(out)

    def _infer_join(self, p: lp.Join, path: str) -> Schema:
        left, right = self._children(p, path)
        for i, (le, re_) in enumerate(p.keys):
            lt = self.expr_type(le, left)
            rt = self.expr_type(re_, right)
            if lt.known and rt.known and lt.kind != rt.kind and not (
                    ex.is_numeric(lt.ctype) and ex.is_numeric(rt.ctype)):
                self._emit("NDS101",
                           f"join key {i}: {lt.kind} vs {rt.kind} "
                           f"({le} = {re_})", f"{path}/keys[{i}]")
        if p.extra is not None:
            merged = Schema(
                (left.cols or []) + (right.cols or [])
                if left.known and right.known else None)
            self.expr_type(p.extra, merged)
        kind = p.kind
        if not (left.known and right.known):
            if kind in ("semi", "anti", "nullaware_anti", "mark") \
                    and left.known:
                pass  # right side unknown is fine for left-only outputs
            else:
                return Schema(None)
        if kind in ("semi", "anti", "nullaware_anti"):
            return left
        if kind == "mark":
            return Schema(list(left.cols) +
                          [(p.mark, ColType(BOOL, False))])
        lnull = kind in ("right", "full")
        rnull = kind in ("left", "full")
        lcols = [(n, ColType(t.ctype, t.nullable or lnull))
                 for n, t in left.cols]
        rcols = [(n, ColType(t.ctype, t.nullable or rnull))
                 for n, t in right.cols]
        return Schema(lcols + rcols)

    def _infer_aggregate(self, p: lp.Aggregate, path: str) -> Schema:
        child, = self._children(p, path)
        out = []
        for name, e in p.group_by:
            t = self.expr_type(e, child)
            if p.grouping_sets is not None:
                # rollup rows carry NULL for the excluded keys
                t = ColType(t.ctype, True)
            out.append((name, t))
        for name, e in p.aggs:
            out.append((name, self.expr_type(e, child)))
            self._check_int32_overflow(e, child, path)
        return Schema(out)

    def _infer_window(self, p: lp.Window, path: str) -> Schema:
        child, = self._children(p, path)
        if not child.known:
            return Schema(None)
        return Schema(list(child.cols) +
                      [(n, self.expr_type(e, child)) for n, e in p.exprs])

    def _check_int32_overflow(self, e: ex.Expr, schema: Schema,
                              path: str) -> None:
        """NDS103: sum over an int32 column can exceed int64 once the
        (linearly scaled) fact row estimate crosses 2^32 rows — advisory
        only, keyed to the caller-supplied scale factor."""
        if self.scale_factor is None:
            return
        rows = self.scale_factor * _SF1_MAX_FACT_ROWS
        if rows < 2 ** 32:
            return
        for sub in e.walk():
            if isinstance(sub, ex.AggExpr) and sub.func == "sum" and \
                    not isinstance(sub.arg, ex.Star):
                at = self.expr_type(sub.arg, schema)
                if at.kind == "int32":
                    self._emit(
                        "NDS103",
                        f"sum({sub.arg}) over int32 at SF "
                        f"{self.scale_factor:g}: ~{rows:.2g} rows can "
                        "overflow the int64 accumulator", path)

    # -- expressions ---------------------------------------------------------

    def agg_result(self, func: str, arg_t: ColType,
                   is_star: bool) -> ColType:
        """Result type of one aggregate call (mirrors jaxexec._agg_column
        and physical's aggregate path)."""
        if func == "count":
            return ColType(INT64, False)
        if func == "sum":
            if is_star or not arg_t.known:
                return UNKNOWN
            k = arg_t.kind
            if k == "decimal":
                return ColType(decimal(38, arg_t.ctype.scale), True)
            if k in ("int32", "int64", "bool"):
                return ColType(INT64, True)
            return ColType(FLOAT64, True)
        if func == "avg":
            return ColType(FLOAT64, True)
        if func in ("min", "max"):
            return ColType(arg_t.ctype, True)
        if func in ("stddev_samp", "var_samp", "stddev", "variance"):
            return ColType(FLOAT64, True)
        return UNKNOWN

    def expr_type(self, e: ex.Expr, schema: Schema) -> ColType:
        if isinstance(e, ex.ColumnRef):
            return schema.get(e.name)
        if isinstance(e, ex.Literal):
            return self._literal_type(e)
        if isinstance(e, ex.Star):
            return UNKNOWN
        if isinstance(e, ex.Cast):
            return self._cast_type(e, schema)
        if isinstance(e, ex.BinOp):
            return self._binop_type(e, schema)
        if isinstance(e, ex.UnaryOp):
            t = self.expr_type(e.operand, schema)
            if e.op == "not":
                return ColType(BOOL, t.nullable)
            if e.op == "neg":
                return t
            return ColType(BOOL, False)  # isnull / isnotnull
        if isinstance(e, ex.Case):
            return self._case_type(e, schema)
        if isinstance(e, ex.Func):
            return self._func_type(e, schema)
        if isinstance(e, ex.InList):
            t = self.expr_type(e.operand, schema)
            return ColType(BOOL, t.nullable)
        if isinstance(e, ex.Param):
            # lifted literal (analysis/canon.py): typed like the literal
            # it replaced — parameters are never NULL (None is not lifted)
            return ColType(e.ctype, False)
        if isinstance(e, ex.InParam):
            t = self.expr_type(e.operand, schema)
            return ColType(BOOL, t.nullable)
        if isinstance(e, ex.AggExpr):
            arg_t = UNKNOWN if isinstance(e.arg, ex.Star) else \
                self.expr_type(e.arg, schema)
            return self.agg_result(e.func, arg_t,
                                   isinstance(e.arg, ex.Star))
        if isinstance(e, ex.WindowExpr):
            if e.func in ("rank", "dense_rank", "row_number"):
                return ColType(INT64, False)
            arg_t = UNKNOWN if e.arg is None or isinstance(e.arg, ex.Star) \
                else self.expr_type(e.arg, schema)
            return self.agg_result(e.func, arg_t,
                                   e.arg is None or
                                   isinstance(e.arg, ex.Star))
        if isinstance(e, ex.SubqueryExpr):
            if e.kind in ("in", "exists"):
                return ColType(BOOL, True)
            sub = TypeChecker(self.tables, self.query, self.scale_factor)
            s = sub.infer(e.plan)
            if s.known and s.cols:
                return ColType(s.cols[0][1].ctype, True)
            return UNKNOWN
        return UNKNOWN

    def _literal_type(self, e: ex.Literal) -> ColType:
        v = e.value
        if v is None:
            return ColType(e.ctype or INT32, True)
        if isinstance(v, bool):
            return ColType(BOOL, False)
        if isinstance(v, int):
            ct = e.ctype or (INT64 if abs(v) > 2 ** 31 - 1 else INT32)
            return ColType(ct, False)
        if isinstance(v, float):
            if e.ctype is not None and e.ctype.kind == "decimal":
                return ColType(e.ctype, False)
            return ColType(FLOAT64, False)
        if isinstance(v, str):
            return ColType(STRING, False)
        return UNKNOWN

    def _cast_type(self, e: ex.Cast, schema: Schema) -> ColType:
        src = self.expr_type(e.operand, schema)
        tgt = e.target
        if not src.known:
            return ColType(tgt, True)
        k, tk = src.kind, tgt.kind
        nullable = src.nullable
        lossy = None
        if k == "decimal" and tk == "decimal":
            if tgt.scale < src.ctype.scale:
                lossy = "decimal scale narrowed " \
                    f"{src.ctype.scale}->{tgt.scale} (rounds)"
            elif (tgt.precision - tgt.scale) < \
                    (src.ctype.precision - src.ctype.scale):
                lossy = "decimal integer digits narrowed " \
                    f"({src.ctype.precision},{src.ctype.scale})->" \
                    f"({tgt.precision},{tgt.scale}) (overflow -> NULL)"
                nullable = True
        elif k == "decimal" and tk in ("int32", "int64"):
            if src.ctype.scale > 0:
                lossy = f"decimal(.,{src.ctype.scale}) -> {tk} truncates"
        elif k == "float64" and tk in ("int32", "int64", "decimal"):
            lossy = f"float64 -> {tk} loses fraction"
        elif k == "int64" and tk == "int32":
            lossy = "int64 -> int32 may wrap"
        elif k == "string" and tk != "string":
            # parse cast: unparseable strings become NULL, not lossy
            nullable = True
        if lossy is not None:
            self._emit("NDS102",
                       f"lossy cast {k} -> {tgt} in {e}: {lossy}",
                       getattr(self, "_path", "expr"))
        return ColType(tgt, nullable)

    def _binop_type(self, e: ex.BinOp, schema: Schema) -> ColType:
        lt = self.expr_type(e.left, schema)
        rt = self.expr_type(e.right, schema)
        nullable = lt.nullable or rt.nullable
        op = e.op
        if op in ("and", "or"):
            return ColType(BOOL, nullable)
        if op in ("=", "<>", "<", "<=", ">", ">="):
            return ColType(BOOL, nullable)
        if op == "||":
            return ColType(STRING, nullable)
        # arithmetic (mirrors Evaluator._arith)
        if op == "/":
            return ColType(FLOAT64, True)  # x/0 -> NULL
        if not (lt.known and rt.known):
            return ColType(None, nullable)
        lk, rk = lt.kind, rt.kind
        if lk == "date" and rk in ("int32", "int64"):
            return ColType(DATE, nullable)
        if "decimal" in (lk, rk):
            if "float64" in (lk, rk):
                return ColType(FLOAT64, nullable)
            ls = lt.ctype.scale if lk == "decimal" else 0
            rs = rt.ctype.scale if rk == "decimal" else 0
            if op == "*":
                return ColType(decimal(38, ls + rs), nullable)
            s = max(ls, rs)
            return ColType(decimal(38, s),
                           True if op == "%" else nullable)
        tgt = ex.common_type(lt.ctype, rt.ctype)
        return ColType(tgt, True if op == "%" else nullable)

    def _case_type(self, e: ex.Case, schema: Schema) -> ColType:
        cands = [self.expr_type(v, schema) for _, v in e.whens]
        if e.default is not None:
            cands.append(self.expr_type(e.default, schema))
        if any(not c.known for c in cands):
            return UNKNOWN
        tgt = cands[0].ctype
        for c in cands[1:]:
            if ex.is_numeric(c.ctype) and ex.is_numeric(tgt):
                tgt = ex.common_type(tgt, c.ctype)
            elif c.ctype.kind != tgt.kind:
                tgt = c.ctype if tgt.kind == "int32" else tgt
        nullable = e.default is None or any(c.nullable for c in cands)
        return ColType(tgt, nullable)

    def _func_type(self, e: ex.Func, schema: Schema) -> ColType:
        name = e.name
        args = [self.expr_type(a, schema) for a in e.args]
        any_null = any(a.nullable for a in args)
        if name == "coalesce":
            if any(not a.known for a in args):
                return ColType(None, all(a.nullable for a in args))
            tgt = ex.coalesce_common_type(
                list(e.args), [a.ctype for a in args])
            return ColType(tgt, all(a.nullable for a in args))
        if name == "like":
            return ColType(BOOL, args[0].nullable if args else True)
        if name in ("substr", "substring", "upper", "lower", "trim",
                    "concat"):
            return ColType(STRING, any_null)
        if name == "length":
            return ColType(INT32, args[0].nullable if args else True)
        if name == "abs":
            return args[0] if args else UNKNOWN
        if name == "round":
            if not args or not args[0].known:
                return UNKNOWN
            a = args[0]
            if a.kind == "decimal":
                nd = 0
                if len(e.args) > 1 and isinstance(e.args[1], ex.Literal):
                    nd = int(e.args[1].value)
                if nd >= a.ctype.scale:
                    return a
                return ColType(decimal(a.ctype.precision, nd), a.nullable)
            return ColType(FLOAT64, a.nullable)
        if name in ("floor", "ceil", "sqrt"):
            return ColType(FLOAT64, args[0].nullable if args else True)
        if name in ("year", "month", "day"):
            return ColType(INT32, args[0].nullable if args else True)
        if name == "nullif":
            a = args[0] if args else UNKNOWN
            return ColType(a.ctype, True)
        if name == "grouping":
            return ColType(INT32, False)
        return UNKNOWN


def infer_plan(plan: lp.Plan, tables: Dict[str, object], query: str = "",
               scale_factor: Optional[float] = None
               ) -> Tuple[Schema, List[Diagnostic]]:
    """Infer the output schema of ``plan`` and return typing diagnostics.

    ``tables`` maps table name -> :class:`ndstpu.schema.TableSchema`
    (e.g. ``schema.get_schemas()`` merged with
    ``schema.get_maintenance_schemas()``).
    """
    tc = TypeChecker(tables, query=query, scale_factor=scale_factor)
    out = tc.infer(plan)
    return out, tc.diags
