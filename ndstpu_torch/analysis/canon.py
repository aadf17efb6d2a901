"""Plan canonicalization: parameter lifting, safety classification, and
shape-keyed fingerprints.

The port's copy of ``ndstpu.analysis.canon`` with its imports changed,
and an inline table's fingerprint read from its ``content_fp`` where it
has one (a spine on the device).  Fingerprints and cache keys equal the JAX
package's for the same plan (``tests/test_torch_canon.py``), so "one
compiled XLA program" below reads "one captured CUDA graph" here.

The corpus renders 99 templates into hundreds of SQL texts that differ
only in substituted literals (dsqgen semantics, PAPER.md §3).  Text-keyed
compile caches treat every rendering as a brand-new program; this pass
proves, statically, which texts share plan *structure* and which literals
are safe to hoist into runtime parameters, so one compiled XLA program
serves every stream permutation and every RNGSEED.

``canonicalize(optimized_plan)`` walks the plan bottom-up and replaces
each literal with a typed parameter slot (:class:`ndstpu_torch.engine.expr.Param`
/ :class:`~ndstpu_torch.engine.expr.InParam`), emitting:

* a **canonical fingerprint** — sha256 of the structural tree with slot
  markers in place of values (process-stable, keys the compile caches),
* a **binding list** — slot → original literal, resolved parameter type,
  and the source column the literal predicates (schema lookup shared with
  ``typecheck.py``),
* a **safety classification** per slot: *runtime-bindable* slots stay
  :class:`Param` in the executed plan and their values travel as
  execution inputs; *shape-affecting* slots (``LIMIT n``, date-interval
  widths, bounded CASE values, host-static function arguments, literals
  inside pre-resolved subqueries) are substituted back as concrete
  literals and their values join the cache key as a residual signature,
  each carrying a stable NDS4xx diagnostic.

Classification errors are a *performance* hazard, never a correctness
hazard: a value wrongly classified bindable still executes through the
same expression kernels as a broadcast column, and the executor's
recorded capacity/branch guards force rediscovery whenever a new binding
busts the discovered size plan (`jaxexec._capacity_for` ok-checks).  A
value wrongly classified shape-affecting merely costs an extra compile.

Import-hygienic like the rest of ``ndstpu_torch.analysis``: numpy only, no jax,
no engine executors — safe for CI lint and doc tooling.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ndstpu_torch.engine import columnar, expr as ex, plan as lp
from ndstpu_torch.engine.columnar import (
    BOOL, DATE, FLOAT64, INT32, INT64, STRING, DType)
from ndstpu_torch.analysis.diagnostics import Diagnostic

__all__ = ["CanonResult", "Slot", "SubtreeCanon", "canonicalize",
           "canonicalize_subtrees", "column_source"]

_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}

# functions whose trailing arguments are read host-side by the engine
# (jaxexec pulls `e.args[k].value` while building the trace) — those
# positions can never bind at runtime
_HOST_STATIC_ARGS = {"substr": 1, "substring": 1, "round": 1, "like": 1}


# ---------------------------------------------------------------------------
# schema helpers (the same table specs typecheck.py infers from)
# ---------------------------------------------------------------------------


def _schema_tables(tables):
    if tables is not None:
        return tables
    from ndstpu_torch import analysis
    return analysis.schema_tables()


def column_source(tables: Dict[str, object]) -> Dict[str, Tuple[str, DType]]:
    """Unqualified column name -> (table, dtype).  TPC-DS column names are
    globally unique by table prefix; a name that does collide maps to
    nothing (conservative: unknown type)."""
    out: Dict[str, Tuple[str, DType]] = {}
    dead = set()
    for tname, ts in tables.items():
        for spec in ts.columns:
            if spec.name in out and out[spec.name][0] != tname:
                dead.add(spec.name)
            out.setdefault(spec.name, (tname, spec.dtype))
    for name in dead:
        out.pop(name, None)
    return out


def _fold_neg(e: ex.Expr) -> ex.Expr:
    """neg(Literal n) -> Literal(-n): the sign is part of the VALUE, not
    the structure, so `= -6` and `= 6` canonicalize to one fingerprint."""
    if isinstance(e, ex.UnaryOp) and e.op == "neg" and \
            isinstance(e.operand, ex.Literal) and \
            isinstance(e.operand.value, (int, float)) and \
            not isinstance(e.operand.value, bool):
        return ex.Literal(-e.operand.value, e.operand.ctype)
    return e


def projection_defs(plan: lp.Plan) -> Dict[str, ex.Expr]:
    """Output name -> defining expression for every projected/aggregated/
    windowed column in the plan.  Lets the classifier see through the
    optimizer's internal renames (`__pv_*` pre-projections): a compare
    against such a name resolves to the base column it carries.  Names
    are plan-wide (no scoping) — good enough for TYPING, and a wrong
    scope can only misclassify a slot, which is a perf hazard, never a
    correctness one."""
    defs: Dict[str, ex.Expr] = {}
    for node in plan.walk():
        if isinstance(node, lp.Project) or isinstance(node, lp.Window):
            pairs = node.exprs
        elif isinstance(node, lp.Aggregate):
            pairs = list(node.group_by) + list(node.aggs)
        else:
            continue
        for name, e in pairs:
            if isinstance(e, ex.ColumnRef) and \
                    e.name.split(".")[-1] == name:
                continue  # identity rename: colmap already covers it
            defs.setdefault(name, e)
    return defs


# ---------------------------------------------------------------------------
# result model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Slot:
    """One lifted literal occurrence."""

    slot: int
    value: object                      # original python value (tuple for IN)
    ctype: DType                       # resolved parameter type
    kind: str                          # "bind" | "shape"
    code: Optional[str]                # NDS4xx for shape slots
    reason: str                        # classification detail
    column: Optional[Tuple[str, str]]  # (table, column) predicated, if any
    paths: Tuple[str, ...]             # plan paths of the occurrences
    orig_ctype: Optional[DType]        # Literal.ctype as written
    in_list: bool = False
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class CanonResult:
    """Canonicalization of one optimized plan."""

    query: str
    fingerprint: str        # sha256[:16] over the slot-marked structure
    structure: str          # the raw structural string (debugging aid)
    canon_plan: object      # plan with Param/InParam at every slot
    exec_plan: object       # shape slots substituted back; safe to execute
    slots: Tuple[Slot, ...]
    values: Tuple[object, ...]
    diagnostics: Tuple[Diagnostic, ...]

    @property
    def bindable(self) -> List[Slot]:
        return [s for s in self.slots if s.kind == "bind"]

    @property
    def shape_affecting(self) -> List[Slot]:
        return [s for s in self.slots if s.kind == "shape"]

    @property
    def residual(self) -> str:
        """Stable signature of the shape-affecting slot values — the part
        of the cache key that still depends on literal content."""
        return ";".join(f"S{s.slot}={s.value!r}"
                        for s in self.shape_affecting)

    @property
    def cache_key(self) -> str:
        res = self.residual
        if not res:
            return f"c:{self.fingerprint}"
        rh = hashlib.sha256(res.encode()).hexdigest()[:12]
        return f"c:{self.fingerprint}:{rh}"

    @property
    def binding(self) -> ex.ParamBinding:
        # string binds are excluded: they reach the device only as
        # dictionary hit tables (recorded per-use in param_spec), never
        # as broadcast scalars — there is no device scalar for a string
        scalars = tuple((s.slot, s.ctype) for s in self.slots
                        if s.kind == "bind" and not s.in_list
                        and s.ctype.kind != "string")
        return ex.ParamBinding(values=self.values, scalars=scalars)


# ---------------------------------------------------------------------------
# canonicalizer
# ---------------------------------------------------------------------------


class _Canon:
    def __init__(self, tables: Dict[str, object], query: str,
                 defs: Optional[Dict[str, ex.Expr]] = None):
        self.query = query
        self.colmap = column_source(tables)
        self.defs = defs or {}
        self._deref: set = set()   # re-entrancy guard for defs lookups
        self.slots: List[dict] = []
        self.diags: List[Diagnostic] = []
        self.force_shape = 0      # >0 inside pre-resolved subquery plans
        self.limit_slots: Dict[int, int] = {}   # id(Limit node) -> slot

    # -- slot bookkeeping ----------------------------------------------------

    def _slot(self, kind: str, value, ctype: DType, path: str, *,
              code: Optional[str] = None, reason: str = "",
              column=None, orig_ctype=None, in_list=False,
              negated=False, tag: str = "") -> int:
        # One slot per literal OCCURRENCE, assigned in walk order.  Never
        # dedup by value: two distinct template parameters can render to
        # the same literal in one stream and different literals in the
        # next, and a value-sensitive slot assignment would give those
        # renderings different structures — the exact instability this
        # pass exists to remove.  Optimizer-duplicated literals simply
        # occupy several slots bound to the same value.
        idx = len(self.slots)
        self.slots.append(dict(
            slot=idx, value=value, ctype=ctype, kind=kind, code=code,
            reason=reason, column=column, paths=[path],
            orig_ctype=orig_ctype, in_list=in_list, negated=negated))
        if kind == "shape" and code is not None:
            self._diag(code, f"slot S{idx} value {value!r}: {reason}", path)
        return idx

    def _diag(self, code: str, message: str, path: str) -> None:
        d = Diagnostic(code=code, message=message, path=path,
                       query=self.query)
        if all(x.key() != d.key() for x in self.diags):
            self.diags.append(d)

    # -- typing helpers ------------------------------------------------------

    def _param_ctype(self, value, orig: Optional[DType]) -> DType:
        """Mirror of jaxexec.JEval._lit / expr.literal_column typing so a
        Param evaluates to the exact dtype the literal would have."""
        if isinstance(value, bool):
            return BOOL
        if isinstance(value, int):
            if orig is not None:
                return orig
            return INT64 if abs(value) > 2 ** 31 - 1 else INT32
        if isinstance(value, float):
            if orig is not None and orig.kind == "decimal":
                return orig
            return FLOAT64
        if isinstance(value, str):
            return STRING
        return orig or INT32

    def _static_type(self, e: ex.Expr) -> Optional[DType]:
        """Best-effort static type of an expression via the shared schema
        column map.  None = unknown (classify conservatively)."""
        if isinstance(e, ex.ColumnRef):
            base = e.name.split(".")[-1]
            hit = self.colmap.get(base)
            if hit:
                return hit[1]
            d = self.defs.get(base)
            if d is not None and base not in self._deref:
                self._deref.add(base)
                try:
                    return self._static_type(d)
                finally:
                    self._deref.discard(base)
            return None
        if isinstance(e, ex.Literal):
            if e.value is None:
                return e.ctype
            return self._param_ctype(e.value, e.ctype)
        if isinstance(e, ex.Param):
            return e.ctype
        if isinstance(e, ex.Cast):
            return e.target
        if isinstance(e, ex.Func):
            if e.name in ("upper", "lower", "trim", "substr", "substring"):
                return STRING
            if e.name in ("year", "month", "day", "length"):
                return INT32
            if e.name in ("coalesce", "nullif", "abs", "round") and e.args:
                return self._static_type(e.args[0])
            return None
        if isinstance(e, ex.BinOp) and e.op in ("+", "-", "*"):
            lt, rt = self._static_type(e.left), self._static_type(e.right)
            if lt is not None and rt is not None and \
                    lt.is_numeric and rt.is_numeric:
                return ex.common_type(lt, rt)
            if lt is not None and lt.kind == "date":
                return DATE
            if rt is not None and rt.kind == "date":
                return DATE
            return None
        if isinstance(e, ex.UnaryOp) and e.op == "neg":
            return self._static_type(e.operand)
        return None

    def _source_column(self, e: ex.Expr) -> Optional[Tuple[str, str]]:
        """First base-table column the expression reads, as (table, col)."""
        for node in e.walk():
            if isinstance(node, ex.ColumnRef):
                name = node.name.split(".")[-1]
                hit = self.colmap.get(name)
                if hit:
                    return (hit[0], name)
                d = self.defs.get(name)
                if d is not None and name not in self._deref:
                    self._deref.add(name)
                    try:
                        src = self._source_column(d)
                    finally:
                        self._deref.discard(name)
                    if src is not None:
                        return src
        return None

    # -- expression rewriting ------------------------------------------------

    def _lift(self, e: ex.Literal, path: str, *, shape_code=None,
              reason="", column=None, tag="") -> ex.Expr:
        """Lift one literal into a slot.  None literals and non-scalar
        values stay structural (a NULL needs no runtime value)."""
        v = e.value
        if v is None or not isinstance(v, (bool, int, float, str)):
            return e
        ct = self._param_ctype(v, e.ctype)
        if self.force_shape and shape_code is None:
            shape_code = "NDS402"
            reason = "literal inside a pre-resolved subquery is baked " \
                     "into the recorded size plan"
        if shape_code is None and isinstance(v, str):
            # string values outside the pdict compare/IN contexts have no
            # runtime binding mechanism (dictionaries bake into traces)
            shape_code = "NDS403"
            reason = reason or "string literal outside a dictionary " \
                               "predicate context"
        if shape_code is not None:
            idx = self._slot("shape", v, ct, path, code=shape_code,
                             reason=reason, column=column,
                             orig_ctype=e.ctype, tag=tag)
            return ex.Param(idx, ct, shape=True)
        idx = self._slot("bind", v, ct, path, reason=reason or "bindable",
                         column=column, orig_ctype=e.ctype, tag=tag)
        return ex.Param(idx, ct)

    def _expr(self, e: ex.Expr, path: str) -> ex.Expr:
        if isinstance(e, (ex.ColumnRef, ex.Star, ex.Param, ex.InParam)):
            return e
        if isinstance(e, ex.Literal):
            return self._lift(e, path)
        if isinstance(e, ex.Cast):
            # fold cast('YYYY-MM-DD' as date) into a DATE-typed slot: the
            # commonest parameterized form in the corpus
            if e.target.kind == "date" and isinstance(e.operand, ex.Literal) \
                    and isinstance(e.operand.value, str) \
                    and not self.force_shape:
                try:
                    days = columnar.parse_date_days(e.operand.value)
                except Exception:
                    days = None
                if days is not None:
                    idx = self._slot("bind", days, DATE, path,
                                     reason="date literal (cast folded)",
                                     orig_ctype=None, tag="date")
                    return ex.Param(idx, DATE)
            if isinstance(e.operand, ex.Literal) and \
                    isinstance(e.operand.value, str) and \
                    e.target.kind != "string":
                # other string-parse casts run host-side over the literal's
                # one-entry dictionary — keep concrete
                op = self._lift(e.operand, path, shape_code="NDS403",
                                reason=f"string literal under a parse cast "
                                       f"to {e.target}")
                return ex.Cast(op, e.target)
            return ex.Cast(self._expr(e.operand, path), e.target)
        if isinstance(e, ex.BinOp):
            return self._binop(e, path)
        if isinstance(e, ex.UnaryOp):
            folded = _fold_neg(e)
            if folded is not e:
                return self._expr(folded, path)
            return ex.UnaryOp(e.op, self._expr(e.operand, path))
        if isinstance(e, ex.Case):
            whens = []
            for c, v in e.whens:
                cc = self._expr(c, path)
                whens.append((cc, self._case_value(v, path)))
            dflt = self._case_value(e.default, path) \
                if e.default is not None else None
            return ex.Case(tuple(whens), dflt)
        if isinstance(e, ex.Func):
            return self._func(e, path)
        if isinstance(e, ex.InList):
            return self._in_list(e, path)
        if isinstance(e, ex.AggExpr):
            if isinstance(e.arg, ex.Star):
                return e
            return ex.AggExpr(e.func, self._expr(e.arg, path), e.distinct)
        if isinstance(e, ex.WindowExpr):
            return ex.WindowExpr(
                e.func,
                None if e.arg is None or isinstance(e.arg, ex.Star)
                else self._expr(e.arg, path),
                tuple(self._expr(x, path) for x in e.partition_by),
                tuple((self._expr(k[0], path),) + tuple(k[1:])
                      for k in e.order_by),
                e.frame)
        if isinstance(e, ex.SubqueryExpr):
            # the subquery executes once at discovery and its RESULT is
            # recorded into the replay program — any literal underneath is
            # baked into that recorded value, so lift shape-only (the
            # differing value must change the cache key)
            self.force_shape += 1
            try:
                sub = self._node(e.plan, f"{path}/subquery") \
                    if e.plan is not None else None
                oper = self._expr(e.operand, path) \
                    if e.operand is not None else None
            finally:
                self.force_shape -= 1
            return ex.SubqueryExpr(e.kind, sub, oper, e.negated,
                                   e.correlated_predicates)
        return e

    def _case_value(self, e: ex.Expr, path: str) -> ex.Expr:
        """Direct literal THEN/ELSE values keep the point bounds that the
        engine's small-domain group-by paths plan around (jaxexec._lit) —
        binding them would change compiled path selection, so they stay
        concrete as shape slots."""
        if isinstance(e, ex.Literal) and e.value is not None and \
                not isinstance(e.value, str):
            return self._lift(e, path, shape_code="NDS401",
                              reason="CASE branch value carries point "
                                     "bounds for domain planning",
                              tag="case")
        return self._expr(e, path)

    def _binop(self, e: ex.BinOp, path: str) -> ex.Expr:
        op = e.op
        if op in _CMP_OPS:
            for lit, other, swapped in ((e.left, e.right, False),
                                        (e.right, e.left, True)):
                if not (isinstance(lit, ex.Literal) and
                        isinstance(lit.value, str)):
                    continue
                ot = self._static_type(other)
                if ot is not None and ot.kind == "string" and \
                        not self.force_shape:
                    # string parameter in a dictionary compare: bound at
                    # dispatch as a host-computed hit vector over the
                    # counterpart column's dictionary
                    idx = self._slot(
                        "bind", lit.value, STRING, path,
                        reason=f"string compare ({op})",
                        column=self._source_column(other),
                        orig_ctype=lit.ctype, tag="str")
                    pnode = ex.Param(idx, STRING)
                    oc = self._expr(other, path)
                    return ex.BinOp(op, oc, pnode) if swapped \
                        else ex.BinOp(op, pnode, oc)
                if ot is not None and ot.kind == "date" and \
                        not self.force_shape:
                    # bare date-string vs a date column: both backends'
                    # implicit string->date compare coercion parses it,
                    # so bind the parsed days as a DATE slot — the same
                    # shape as the cast-folded date literal, closing the
                    # '2002-4-01'-style NDS403 cache-key residuals
                    try:
                        days = columnar.parse_date_days(lit.value)
                    except ValueError:
                        days = None
                    if days is not None:
                        idx = self._slot(
                            "bind", days, DATE, path,
                            reason="date string compare (implicit "
                                   "string->date coercion)",
                            column=self._source_column(other),
                            orig_ctype=None, tag="date")
                        pnode = ex.Param(idx, DATE)
                        oc = self._expr(other, path)
                        return ex.BinOp(op, oc, pnode) if swapped \
                            else ex.BinOp(op, pnode, oc)
            # date +/- int literal lives below; comparisons recurse with
            # source-column attribution for the binding report
            left = self._cmp_side(e.left, e.right, path)
            right = self._cmp_side(e.right, e.left, path)
            return ex.BinOp(op, left, right)
        if op in ("+", "-"):
            for lit, other in ((e.left, e.right), (e.right, e.left)):
                ot = self._static_type(other)
                if isinstance(lit, ex.Literal) and \
                        isinstance(lit.value, int) and \
                        not isinstance(lit.value, bool) and \
                        ot is not None and ot.kind == "date":
                    # interval width: feeds date-range capacity planning
                    lc = self._lift(
                        lit, path, shape_code="NDS401",
                        reason="interval width in date arithmetic "
                               "changes padded capacities",
                        column=self._source_column(other), tag="interval")
                    oc = self._expr(other, path)
                    return ex.BinOp(op, lc, oc) if lit is e.left \
                        else ex.BinOp(op, oc, lc)
        return ex.BinOp(op, self._expr(e.left, path),
                        self._expr(e.right, path))

    def _cmp_side(self, side: ex.Expr, other: ex.Expr,
                  path: str) -> ex.Expr:
        side = _fold_neg(side)
        if isinstance(side, ex.Literal):
            return self._lift(side, path,
                              column=self._source_column(other))
        if isinstance(side, ex.Cast) and side.target.kind == "date" \
                and isinstance(side.operand, ex.Literal) \
                and isinstance(side.operand.value, str) \
                and not self.force_shape:
            # folded date literal in a comparison: attribute the slot to
            # the column it predicates (the param_audit binding report)
            try:
                days = columnar.parse_date_days(side.operand.value)
            except Exception:
                days = None
            if days is not None:
                idx = self._slot("bind", days, DATE, path,
                                 reason="date literal (cast folded)",
                                 column=self._source_column(other),
                                 orig_ctype=None, tag="date")
                return ex.Param(idx, DATE)
        return self._expr(side, path)

    def _func(self, e: ex.Func, path: str) -> ex.Expr:
        if e.name == "grouping":
            return e  # resolved statically per grouping set
        if e.name == "coalesce":
            # coalesce_common_type() inspects Literal nodes to keep exact
            # decimal typing (the q75 drift fix) — literal args must
            # survive as literals
            args = []
            for a in e.args:
                if isinstance(a, ex.Literal):
                    args.append(self._lift(
                        a, path, shape_code="NDS403",
                        reason="coalesce argument participates in exact "
                               "literal typing"))
                else:
                    args.append(self._expr(a, path))
            return ex.Func(e.name, tuple(args))
        host = _HOST_STATIC_ARGS.get(e.name)
        args = []
        for i, a in enumerate(e.args):
            if host is not None and i >= host and \
                    isinstance(a, ex.Literal):
                args.append(self._lift(
                    a, path, shape_code="NDS403",
                    reason=f"{e.name}() argument {i} is read host-side "
                           "while building the trace",
                    column=self._source_column(e.args[0])))
            else:
                args.append(self._expr(a, path))
        return ex.Func(e.name, tuple(args))

    def _in_list(self, e: ex.InList, path: str) -> ex.Expr:
        operand = self._expr(e.operand, path)
        vals = tuple(e.values)
        if not vals or any(v is None for v in vals) or self.force_shape:
            return ex.InList(operand, vals, e.negated)
        ot = self._static_type(e.operand)
        col = self._source_column(e.operand)
        if ot is not None and ot.kind == "string" and \
                all(isinstance(v, str) for v in vals):
            idx = self._slot("bind", vals, STRING, path,
                             reason="string IN-list (dictionary membership)",
                             column=col, in_list=True, negated=e.negated,
                             tag="in")
            return ex.InParam(operand, idx, len(vals), e.negated)
        if ot is not None and (ot.is_numeric or ot.kind == "date"):
            coerced, had_null = ex.coerce_in_values(ot, vals)
            if not had_null and len(coerced) == len(vals):
                idx = self._slot("bind", vals, ot, path,
                                 reason=f"IN-list over {ot} operand",
                                 column=col, in_list=True,
                                 negated=e.negated, tag="in")
                return ex.InParam(operand, idx, len(vals), e.negated)
            self._diag("NDS403", f"IN-list values {vals!r} do not coerce "
                                 f"cleanly to {ot}; kept literal", path)
            return ex.InList(operand, vals, e.negated)
        self._diag("NDS403", "IN-list operand type unresolved; values "
                             "kept literal", path)
        return ex.InList(operand, vals, e.negated)

    # -- plan rewriting ------------------------------------------------------

    def _node(self, p: lp.Plan, path: str) -> lp.Plan:
        t = type(p).__name__

        def child(c, i=0):
            return self._node(c, f"{path}/{type(c).__name__}[{i}]")

        if isinstance(p, lp.Scan):
            pred = self._expr(p.predicate, path) \
                if p.predicate is not None else None
            return lp.Scan(p.table, p.alias,
                           None if p.columns is None else list(p.columns),
                           pred)
        if isinstance(p, lp.InlineTable):
            return lp.InlineTable(p.table, p.name)
        if isinstance(p, lp.Filter):
            return lp.Filter(child(p.child), self._expr(p.condition, path))
        if isinstance(p, lp.Project):
            return lp.Project(child(p.child),
                              [(n, self._expr(e, path)) for n, e in p.exprs])
        if isinstance(p, lp.Join):
            keys = []
            for le, re_ in p.keys:
                keys.append((self._join_key(le, path),
                             self._join_key(re_, path)))
            extra = self._expr(p.extra, path) if p.extra is not None else None
            return lp.Join(child(p.left, 0),
                           self._node(p.right,
                                      f"{path}/{type(p.right).__name__}[1]"),
                           p.kind, keys, extra, p.mark)
        if isinstance(p, lp.Aggregate):
            gb = [(n, self._group_key(e, path)) for n, e in p.group_by]
            aggs = [(n, self._expr(e, path)) for n, e in p.aggs]
            return lp.Aggregate(child(p.child), gb, aggs,
                                None if p.grouping_sets is None
                                else [list(s) for s in p.grouping_sets])
        if isinstance(p, lp.Window):
            return lp.Window(child(p.child),
                             [(n, self._expr(e, path)) for n, e in p.exprs])
        if isinstance(p, lp.Sort):
            # keys are (expr, asc) or (expr, asc, nulls_first)
            return lp.Sort(child(p.child),
                           [(self._expr(k[0], path),) + tuple(k[1:])
                            for k in p.keys])
        if isinstance(p, lp.Limit):
            node = lp.Limit(child(p.child), p.n)
            if not self.force_shape:
                idx = self._slot("shape", p.n, INT32, path, code="NDS401",
                                 reason="LIMIT row count is a static "
                                        "output shape", tag="limit")
                self.limit_slots[id(node)] = idx
            return node
        if isinstance(p, lp.Distinct):
            return lp.Distinct(child(p.child))
        if isinstance(p, lp.SetOp):
            return lp.SetOp(p.kind, child(p.left, 0),
                            self._node(p.right,
                                       f"{path}/{type(p.right).__name__}[1]"),
                            p.all)
        if isinstance(p, lp.SubqueryAlias):
            return lp.SubqueryAlias(child(p.child), p.alias,
                                    None if p.column_aliases is None
                                    else list(p.column_aliases))
        if isinstance(p, lp.DeviceResult):
            return p
        raise TypeError(f"canonicalize: unknown plan node {t}")

    def _join_key(self, e: ex.Expr, path: str) -> ex.Expr:
        if isinstance(e, ex.Literal) and e.value is not None:
            # join machinery plans radix/LUT layout from key bounds —
            # a literal key's point bounds must survive
            return self._lift(e, path, shape_code="NDS401",
                              reason="literal join key feeds radix "
                                     "planning bounds", tag="joinkey")
        return self._expr(e, path)

    def _group_key(self, e: ex.Expr, path: str) -> ex.Expr:
        if isinstance(e, ex.Literal) and e.value is not None:
            return self._lift(e, path, shape_code="NDS401",
                              reason="literal group key bounds the "
                                     "group-by domain", tag="groupkey")
        return self._expr(e, path)


# ---------------------------------------------------------------------------
# fingerprint (jax-free twin of jaxexec._plan_fp with slot markers)
# ---------------------------------------------------------------------------


def _inline_table_fp(t) -> str:
    # a table whose columns live on a device (a materialized spine,
    # ndstpu_torch.engine.spine) carries its identity, made when it was
    # built, so that fingerprinting it reads nothing back
    given = getattr(t, "content_fp", None)
    if given is not None:
        return given
    parts = []
    for name in t.column_names:
        c = t.columns[name]
        data = np.ascontiguousarray(np.asarray(c.data))
        crc = zlib.crc32(data.tobytes())
        if c.valid is not None:
            crc = zlib.crc32(np.ascontiguousarray(c.valid).tobytes(), crc)
        if c.dictionary is not None:
            crc = zlib.crc32(str(len(c.dictionary)).encode(), crc)
            for s in c.dictionary:
                b = str(s).encode()
                crc = zlib.crc32(f"{len(b)}:".encode() + b, crc)
        parts.append(f"{name}:{c.ctype!r}:{data.dtype}{data.shape}:{crc}")
    return f"T({t.num_rows};" + ";".join(parts) + ")"


def _structure(o, limit_slots: Dict[int, int], out: List[str]) -> None:
    if isinstance(o, lp.InlineTable):
        out.append(f"IT{_inline_table_fp(o.table)}")
    elif isinstance(o, lp.Limit) and id(o) in limit_slots:
        out.append(f"Limit(S{limit_slots[id(o)]},")
        _structure(o.child, limit_slots, out)
        out.append(")")
    elif isinstance(o, ex.Param):
        # slot marker only: the VALUE lives in the binding (bindable) or
        # the residual signature (shape) — never in the structure
        k = "S" if o.shape else "P"
        out.append(f"{k}{o.slot}:{o.ctype!r}")
    elif isinstance(o, ex.InParam):
        neg = "!" if o.negated else ""
        out.append(f"IN{neg}(P{o.slot}[{o.n}],")
        _structure(o.operand, limit_slots, out)
        out.append(")")
    elif dataclasses.is_dataclass(o) and not isinstance(o, type):
        out.append(type(o).__name__)
        out.append("(")
        for f in dataclasses.fields(o):
            _structure(getattr(o, f.name), limit_slots, out)
            out.append(",")
        out.append(")")
    elif isinstance(o, (list, tuple)):
        out.append("[")
        for x in o:
            _structure(x, limit_slots, out)
            out.append(",")
        out.append("]")
    elif isinstance(o, np.ndarray):
        out.append(f"ND{o.dtype}{o.shape}{zlib.crc32(o.tobytes())}")
    else:
        out.append(repr(o))


# ---------------------------------------------------------------------------
# exec-plan substitution (shape slots back to literals)
# ---------------------------------------------------------------------------


def _substitute_expr(e: ex.Expr, slots: List[dict]) -> ex.Expr:
    if isinstance(e, ex.Param):
        if not e.shape:
            return e
        s = slots[e.slot]
        return ex.Literal(s["value"], s["orig_ctype"])
    if isinstance(e, ex.InParam):
        return ex.InParam(_substitute_expr(e.operand, slots), e.slot,
                          e.n, e.negated)
    if isinstance(e, ex.Literal) or isinstance(
            e, (ex.ColumnRef, ex.Star)):
        return e
    if isinstance(e, ex.Cast):
        return ex.Cast(_substitute_expr(e.operand, slots), e.target)
    if isinstance(e, ex.BinOp):
        return ex.BinOp(e.op, _substitute_expr(e.left, slots),
                        _substitute_expr(e.right, slots))
    if isinstance(e, ex.UnaryOp):
        return ex.UnaryOp(e.op, _substitute_expr(e.operand, slots))
    if isinstance(e, ex.Case):
        return ex.Case(
            tuple((_substitute_expr(c, slots), _substitute_expr(v, slots))
                  for c, v in e.whens),
            _substitute_expr(e.default, slots)
            if e.default is not None else None)
    if isinstance(e, ex.Func):
        return ex.Func(e.name, tuple(_substitute_expr(a, slots)
                                     for a in e.args))
    if isinstance(e, ex.InList):
        return ex.InList(_substitute_expr(e.operand, slots), e.values,
                         e.negated)
    if isinstance(e, ex.AggExpr):
        if isinstance(e.arg, ex.Star):
            return e
        return ex.AggExpr(e.func, _substitute_expr(e.arg, slots),
                          e.distinct)
    if isinstance(e, ex.WindowExpr):
        return ex.WindowExpr(
            e.func,
            None if e.arg is None or isinstance(e.arg, ex.Star)
            else _substitute_expr(e.arg, slots),
            tuple(_substitute_expr(x, slots) for x in e.partition_by),
            tuple((_substitute_expr(k[0], slots),) + tuple(k[1:])
                  for k in e.order_by),
            e.frame)
    if isinstance(e, ex.SubqueryExpr):
        return ex.SubqueryExpr(
            e.kind,
            _substitute_plan(e.plan, slots) if e.plan is not None else None,
            _substitute_expr(e.operand, slots)
            if e.operand is not None else None,
            e.negated, e.correlated_predicates)
    return e


def _substitute_plan(p: lp.Plan, slots: List[dict]) -> lp.Plan:
    sub = lambda e: _substitute_expr(e, slots)  # noqa: E731
    if isinstance(p, lp.Scan):
        return lp.Scan(p.table, p.alias,
                       None if p.columns is None else list(p.columns),
                       sub(p.predicate) if p.predicate is not None else None)
    if isinstance(p, lp.InlineTable):
        return lp.InlineTable(p.table, p.name)
    if isinstance(p, lp.Filter):
        return lp.Filter(_substitute_plan(p.child, slots), sub(p.condition))
    if isinstance(p, lp.Project):
        return lp.Project(_substitute_plan(p.child, slots),
                          [(n, sub(e)) for n, e in p.exprs])
    if isinstance(p, lp.Join):
        return lp.Join(_substitute_plan(p.left, slots),
                       _substitute_plan(p.right, slots), p.kind,
                       [(sub(a), sub(b)) for a, b in p.keys],
                       sub(p.extra) if p.extra is not None else None,
                       p.mark)
    if isinstance(p, lp.Aggregate):
        return lp.Aggregate(_substitute_plan(p.child, slots),
                            [(n, sub(e)) for n, e in p.group_by],
                            [(n, sub(e)) for n, e in p.aggs],
                            None if p.grouping_sets is None
                            else [list(s) for s in p.grouping_sets])
    if isinstance(p, lp.Window):
        return lp.Window(_substitute_plan(p.child, slots),
                         [(n, sub(e)) for n, e in p.exprs])
    if isinstance(p, lp.Sort):
        return lp.Sort(_substitute_plan(p.child, slots),
                       [(sub(k[0]),) + tuple(k[1:]) for k in p.keys])
    if isinstance(p, lp.Limit):
        return lp.Limit(_substitute_plan(p.child, slots), p.n)
    if isinstance(p, lp.Distinct):
        return lp.Distinct(_substitute_plan(p.child, slots))
    if isinstance(p, lp.SetOp):
        return lp.SetOp(p.kind, _substitute_plan(p.left, slots),
                        _substitute_plan(p.right, slots), p.all)
    if isinstance(p, lp.SubqueryAlias):
        return lp.SubqueryAlias(_substitute_plan(p.child, slots), p.alias,
                                None if p.column_aliases is None
                                else list(p.column_aliases))
    if isinstance(p, lp.DeviceResult):
        return p
    raise TypeError(f"substitute: unknown plan node {type(p).__name__}")


# the optimizer's fused-sibling rewrite names its internal bucket/agg
# columns __ssa<md5-of-conjuncts> (optimizer._build_fused) — a hash OVER
# LITERAL VALUES, so two renderings of one template get different
# internal names for the same structure.  The names never escape the
# plan (the final projection uses template aliases), so renumber them by
# first occurrence before fingerprinting.
_GENERATED_NAME = re.compile(r"__ssa[0-9a-f]{8}x*")


def _normalize_generated_names(structure: str) -> str:
    seen: Dict[str, str] = {}

    def sub(m: "re.Match") -> str:
        return seen.setdefault(m.group(0), f"__ssa{len(seen)}")

    return _GENERATED_NAME.sub(sub, structure)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def canonicalize(plan: lp.Plan, tables: Optional[Dict[str, object]] = None,
                 query: str = "") -> CanonResult:
    """Canonicalize an OPTIMIZED logical plan.

    Returns the canonical plan (every lifted literal a Param slot), the
    executable plan (shape slots substituted back), the structural
    fingerprint, the slot binding list, and NDS4xx diagnostics for the
    shape-affecting residue."""
    c = _Canon(_schema_tables(tables), query, defs=projection_defs(plan))
    canon_plan = c._node(plan, type(plan).__name__)
    out: List[str] = []
    _structure(canon_plan, c.limit_slots, out)
    structure = _normalize_generated_names("".join(out))
    fp = hashlib.sha256(structure.encode()).hexdigest()[:16]
    exec_plan = _substitute_plan(canon_plan, c.slots)
    slots = tuple(Slot(slot=s["slot"], value=s["value"], ctype=s["ctype"],
                       kind=s["kind"], code=s["code"], reason=s["reason"],
                       column=s["column"], paths=tuple(s["paths"]),
                       orig_ctype=s["orig_ctype"], in_list=s["in_list"],
                       negated=s["negated"])
                  for s in c.slots)
    return CanonResult(
        query=query, fingerprint=fp, structure=structure,
        canon_plan=canon_plan, exec_plan=exec_plan, slots=slots,
        values=tuple(s["value"] for s in c.slots),
        diagnostics=tuple(c.diags))

# ---------------------------------------------------------------------------
# subtree canonicalization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubtreeCanon:
    """Canonicalization of one plan SUBTREE treated as its own root.

    Slot numbering restarts per subtree, so a spine shared by two queries
    collapses to one fingerprint even when the enclosing plans lift a
    different number of literals before reaching it."""

    path: str                      # canon-convention path from the plan root
    node: lp.Plan = dataclasses.field(compare=False, hash=False)
    kind: str = ""                 # root node type name
    size: int = 0                  # plan nodes in the subtree
    canon: Optional[CanonResult] = dataclasses.field(
        default=None, compare=False, hash=False)


def _plan_children(p: lp.Plan) -> List[lp.Plan]:
    """Plan-node children in the ordinal order `_Canon._node` paths use."""
    if isinstance(p, (lp.Join, lp.SetOp)):
        return [p.left, p.right]
    child = getattr(p, "child", None)
    return [child] if isinstance(child, lp.Plan) else []


def _subtree_size(p: lp.Plan) -> int:
    return 1 + sum(_subtree_size(c) for c in _plan_children(p))


def canonicalize_subtrees(plan: lp.Plan,
                          tables: Optional[Dict[str, object]] = None,
                          query: str = "") -> List[SubtreeCanon]:
    """Canonicalize EVERY plan subtree as its own root, root-first.

    Paths follow the `_Canon._node` convention
    (``RootType/ChildType[i]/...``) so subtree records line up with the
    NDS diagnostics anchored on the same plan.  A subtree whose
    canonicalization raises is recorded with ``canon=None`` rather than
    aborting the sweep — the callers (spines.py, session splicing) treat
    it as opaque/unshareable."""
    tables = _schema_tables(tables)
    out: List[SubtreeCanon] = []

    def visit(p: lp.Plan, path: str) -> None:
        try:
            c = canonicalize(p, tables, query)
        except Exception:
            c = None
        out.append(SubtreeCanon(
            path=path, node=p, kind=type(p).__name__,
            size=_subtree_size(p), canon=c))
        for i, ch in enumerate(_plan_children(p)):
            visit(ch, f"{path}/{type(ch).__name__}[{i}]")

    visit(plan, type(plan).__name__)
    return out
