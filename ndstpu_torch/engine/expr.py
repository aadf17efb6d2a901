"""Expression IR and null-aware columnar evaluation (numpy reference path).

Implements Spark-SQL-compatible semantics the validator depends on
(cf. reference nds_validate.py equality rules):

* three-valued logic for comparisons and AND/OR over NULLs
* decimal arithmetic on scale-shifted int64 (add/sub align scales,
  multiply adds scales, divide produces float64)
* string predicates (LIKE, substr, ||) evaluated once per dictionary entry,
  then gathered by code — O(|dict|) instead of O(rows)
* date arithmetic as int32 day counts (+ INTERVAL n DAYS)

The same IR is compiled to jax expressions by ndstpu.engine.kernels for the
TPU path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import re
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ndstpu_torch.engine import columnar
from ndstpu_torch.engine.columnar import (
    BOOL,
    DATE,
    FLOAT64,
    INT32,
    INT64,
    STRING,
    Column,
    DType,
    Table,
    decimal,
)

# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


class Expr:
    def children(self) -> Sequence["Expr"]:
        return ()

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    name: str

    def __repr__(self):
        return f"col({self.name})"


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: object  # python int/float/str/bool/None
    ctype: Optional[DType] = None

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclasses.dataclass(frozen=True)
class Star(Expr):
    """COUNT(*) argument."""


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / = <> < <= > >= and or
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # not, neg, isnull, isnotnull
    operand: Expr

    def children(self):
        return (self.operand,)


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    target: DType

    def children(self):
        return (self.operand,)


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    default: Optional[Expr]

    def children(self):
        out = []
        for c, v in self.whens:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Func(Expr):
    name: str  # substr, coalesce, like, upper, lower, abs, round, extract...
    args: Tuple[Expr, ...]

    def children(self):
        return self.args


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    operand: Expr
    values: Tuple[object, ...]
    negated: bool = False

    def children(self):
        return (self.operand,)


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """A literal lifted into a typed runtime-parameter slot by
    ndstpu.analysis.canon.  The slot's value travels outside the plan (in
    the canonical binding) so structurally identical queries share one
    compiled program.  `shape=True` marks slots whose value participates
    in static shape planning; those are substituted back to concrete
    literals before execution and exist only for fingerprinting."""

    slot: int
    ctype: DType  # always resolved by the canonicalizer, never None
    shape: bool = False

    def __repr__(self):
        k = "S" if self.shape else "P"
        return f"param({k}{self.slot}:{self.ctype!r})"


@dataclasses.dataclass(frozen=True)
class InParam(Expr):
    """An IN-list whose value tuple is lifted into one parameter slot.
    The arity is static (part of the compiled program's shape); only the
    member values are bound at execution time."""

    operand: Expr
    slot: int
    n: int
    negated: bool = False

    def children(self):
        return (self.operand,)

    def __repr__(self):
        neg = "not " if self.negated else ""
        return f"inparam({self.operand} {neg}in P{self.slot}[{self.n}])"


@dataclasses.dataclass(frozen=True)
class ParamBinding:
    """Slot values for one execution of a canonical plan.

    ``values`` is indexed by slot id (IN-list slots hold the value tuple,
    shape slots hold the substituted-back literal).  ``scalars`` lists the
    runtime-bindable scalar slots with their resolved types — the compiled
    program declares one traced argument per entry, so the set must be a
    pure function of the canonical fingerprint (it is: both derive from
    the same canonicalization)."""

    values: Tuple[object, ...]
    scalars: Tuple[Tuple[int, DType], ...] = ()


# Active parameter binding for the numpy evaluator (and any fallback path
# that re-evaluates canonical subtrees host-side).  Thread-local because
# harness streams share one Session from worker threads.
_PARAMS = threading.local()


def active_params() -> Optional[Tuple[object, ...]]:
    return getattr(_PARAMS, "values", None)


@contextlib.contextmanager
def bound_params(values: Optional[Sequence[object]]):
    prev = getattr(_PARAMS, "values", None)
    _PARAMS.values = tuple(values) if values is not None else None
    try:
        yield
    finally:
        _PARAMS.values = prev


@dataclasses.dataclass(frozen=True)
class AggExpr(Expr):
    func: str  # sum, avg, count, min, max, stddev_samp, count_distinct
    arg: Expr  # Star() for count(*)
    distinct: bool = False

    def children(self):
        return (self.arg,) if not isinstance(self.arg, Star) else ()

    def __repr__(self):
        d = "distinct " if self.distinct else ""
        return f"{self.func}({d}{self.arg})"


@dataclasses.dataclass(frozen=True)
class WindowExpr(Expr):
    func: str  # rank, dense_rank, row_number, sum, avg, min, max, count
    arg: Optional[Expr]
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[Tuple[Expr, bool], ...]  # (expr, ascending)
    # "rows" | "range" running frame (UNBOUNDED PRECEDING..CURRENT ROW);
    # None = no explicit frame (aggregates with order_by still run as a
    # RANGE running frame, Spark's default)
    frame: Optional[str] = None

    def children(self):
        out = list(self.partition_by) + [e for e, _ in self.order_by]
        if self.arg is not None and not isinstance(self.arg, Star):
            out.append(self.arg)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class SubqueryExpr(Expr):
    """Scalar / IN / EXISTS subquery — replaced by the planner (decorrelation
    or pre-execution) before evaluation; evaluating one directly is an error
    unless `resolved` has been filled with a literal/column."""

    kind: str  # scalar, in, exists
    plan: object  # logical plan node
    operand: Optional[Expr] = None  # for IN
    negated: bool = False
    correlated_predicates: Tuple = ()

    def children(self):
        return (self.operand,) if self.operand is not None else ()


# ---------------------------------------------------------------------------
# Type utilities
# ---------------------------------------------------------------------------


def is_numeric(ct: DType) -> bool:
    return ct.kind in ("int32", "int64", "float64", "decimal")


def literal_decimal_type(e) -> Optional[DType]:
    """Spark literal typing for fractional literals: `0.0` parses as
    DECIMAL(1,1), `1.25` as DECIMAL(3,2) (scientific notation stays
    double).  Returns None when `e` is not an exactly-decimal float
    literal.  Reference behavior: Spark's Literal(BigDecimal)."""
    if not isinstance(e, Literal) or not isinstance(e.value, float):
        return None
    if e.ctype is not None and e.ctype.kind != "float64":
        return None
    from decimal import Decimal
    d = Decimal(str(e.value))
    exp = -d.as_tuple().exponent
    if exp < 0 or exp > 12 or float(d) != e.value:
        return None
    # BigDecimal("0.0") is precision 1 scale 1 (digits (0,) count as
    # one digit, all fractional)
    prec = max(len(d.as_tuple().digits), exp, 1)
    return decimal(prec, exp)


def coalesce_common_type(arg_exprs, arg_ctypes) -> DType:
    """COALESCE result type with Spark-faithful literal typing: an
    exact fractional literal (`0.0`) counts as DECIMAL, so
    coalesce(decimal_col, 0.0) stays DECIMAL instead of promoting to
    float.  Exactness matters beyond fidelity: TPU f64 is emulated at
    reduced precision, and a float-promoted money column made q75's
    UNION-distinct collapse different duplicate sets on TPU vs the
    numpy interpreter (6 of 100 groups drifted by a few counts).
    Shared by both evaluators so the backends agree."""
    eff = []
    for a, ct in zip(arg_exprs, arg_ctypes):
        if ct.kind == "float64":
            dt = literal_decimal_type(a)
            if dt is not None:
                ct = dt
        eff.append(ct)
    tgt = eff[0]
    for ct in eff[1:]:
        if is_numeric(ct) and is_numeric(tgt):
            tgt = common_type(tgt, ct)
    return tgt


def common_type(a: DType, b: DType) -> DType:
    """Numeric type unification (Spark-ish)."""
    if a.kind == b.kind == "decimal":
        s = max(a.scale, b.scale)
        return decimal(max(a.precision - a.scale, b.precision - b.scale) + s, s)
    if "float64" in (a.kind, b.kind):
        return FLOAT64
    if "decimal" in (a.kind, b.kind):
        d = a if a.kind == "decimal" else b
        return d
    if "int64" in (a.kind, b.kind):
        return INT64
    if a.kind == "date" or b.kind == "date":
        return DATE
    return INT32


def coerce_in_values(ctype: DType, values) -> Tuple[list, bool]:
    """Coerce untyped string IN-list literals to a non-string operand
    column's domain (SQL implicit cast: `d_date in ('2000-06-30', ...)`).
    A literal that fails the cast is NULL in SQL: dropped from the match
    set (it can never compare equal), but reported via the second return
    so NOT IN can apply NULL semantics (never TRUE).  For decimal
    columns the returned values are scale-shifted int64.  Shared by both
    the numpy and JAX evaluators so the backends agree."""
    out, had_null = [], False
    for v in values:
        try:
            if ctype.kind == "decimal":
                if isinstance(v, str):
                    try:
                        v = int(v)  # exact for integral literals > 2^53
                    except ValueError:
                        v = float(v)
                if isinstance(v, int):
                    v = v * 10 ** ctype.scale
                else:
                    v = round(float(v) * 10 ** ctype.scale)
            elif isinstance(v, str):
                if ctype.kind == "date":
                    v = columnar.parse_date_days(v)
                else:
                    try:
                        v = int(v)  # int first: float would lose >2^53
                    except ValueError:
                        v = float(v)
        except ValueError:
            had_null = True
            continue
        out.append(v)
    return out, had_null


def cast_column(c: Column, target: DType) -> Column:
    k, tk = c.ctype.kind, target.kind
    if k == tk and (tk != "decimal" or c.ctype.scale == target.scale):
        if tk == "decimal" and c.ctype.precision != target.precision:
            # same scale -> same representation; retag the precision, but
            # values that overflow the narrower precision become NULL
            # (Spark non-ANSI overflow semantics)
            if target.precision < c.ctype.precision:
                limit = 10 ** target.precision
                ok = np.abs(c.data) < limit
                valid = ok if c.valid is None else (c.valid & ok)
                return Column(c.data, target,
                              None if valid.all() else valid, c.dictionary)
            return Column(c.data, target, c.valid, c.dictionary)
        return c
    v = c.valid

    def _strings_to_floats():
        """Per-value parse; unparseable -> NULL (Spark cast semantics)."""
        out = np.zeros(len(c.data), dtype=np.float64)
        valid = c.validity().copy()
        for i, x in enumerate(c.to_pylist()):
            if x is None:
                valid[i] = False
                continue
            try:
                out[i] = float(x)
            except ValueError:
                valid[i] = False
        return out, (None if valid.all() else valid)

    def _half_up(x: np.ndarray) -> np.ndarray:
        return np.floor(np.abs(x) + 0.5) * np.sign(x)

    if tk == "float64":
        if k == "decimal":
            data = c.data.astype(np.float64) / (10 ** c.ctype.scale)
        elif k == "string":
            data, v = _strings_to_floats()
        else:
            data = c.data.astype(np.float64)
        return Column(data, FLOAT64, v)
    if tk == "decimal":
        scale = 10 ** target.scale
        if k == "decimal":
            shift = target.scale - c.ctype.scale
            data = (c.data * (10 ** shift) if shift >= 0
                    else _div_round_half_up(c.data, 10 ** (-shift)))
        elif k == "float64":
            data = _half_up(c.data * scale)  # Spark HALF_UP, not banker's
        elif k == "string":
            floats, v = _strings_to_floats()
            data = _half_up(floats * scale)
        else:
            data = c.data.astype(np.int64) * scale
        return Column(data.astype(np.int64), target, v)
    if tk in ("int32", "int64"):
        dt = np.int64 if tk == "int64" else np.int32
        if k == "decimal":
            data = _div_trunc(c.data, 10 ** c.ctype.scale).astype(dt)
        elif k == "float64":
            data = c.data.astype(dt)
        elif k == "string":
            out = np.zeros(len(c.data), dtype=dt)
            valid = c.validity().copy()
            for i, x in enumerate(c.to_pylist()):
                if x is None:
                    valid[i] = False
                    continue
                try:
                    out[i] = int(float(x))
                except ValueError:
                    valid[i] = False
            return Column(out, target, valid)
        else:
            data = c.data.astype(dt)
        return Column(data, target, v)
    if tk == "date":
        if k == "string":
            out = np.zeros(len(c.data), dtype=np.int32)
            valid = c.validity().copy()
            for i, x in enumerate(c.to_pylist()):
                if x is None:
                    valid[i] = False
                    continue
                out[i] = columnar.parse_date_days(x)
            return Column(out, DATE, valid)
        return Column(c.data.astype(np.int32), DATE, v)
    if tk == "string":
        vals = c.to_pylist()
        strs = [None if x is None else _to_str(x, c.ctype) for x in vals]
        return Column.from_strings(strs)
    if tk == "bool":
        return Column(c.data.astype(bool), BOOL, v)
    raise NotImplementedError(f"cast {c.ctype} -> {target}")


def parse_dictionary_days(dictionary) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a string dictionary's entries as dates: (days, parse_ok)
    per entry.  Shared by both backends' implicit string->date compare
    coercion so their NULL semantics for unparseable values agree."""
    n = len(dictionary) if dictionary is not None else 0
    days = np.zeros(n, dtype=np.int32)
    ok = np.ones(n, dtype=bool)
    for i in range(n):
        try:
            days[i] = columnar.parse_date_days(str(dictionary[i]))
        except ValueError:
            ok[i] = False
    return days, ok


def string_to_date_column(c: Column) -> Column:
    """Implicit string->date coercion for compares: decode via the
    (small) dictionary, unparseable entries and negative codes become
    NULL."""
    days, ok = parse_dictionary_days(c.dictionary)
    codes_ok = c.data >= 0
    if len(days):
        idx = np.clip(c.data, 0, len(days) - 1)
        out = np.where(codes_ok, days[idx], np.int32(0))
        valid = c.validity() & codes_ok & ok[idx]
    else:
        out = np.zeros(len(c.data), dtype=np.int32)
        valid = np.zeros(len(c.data), dtype=bool)
    return Column(out.astype(np.int32), DATE, valid)


def _to_str(x, ct: DType) -> str:
    if ct.kind == "decimal":
        return f"{x:.{ct.scale}f}"
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return str(x)


def _div_round_half_up(a: np.ndarray, d: int) -> np.ndarray:
    sign = np.sign(a)
    return sign * ((np.abs(a) + d // 2) // d)


def _div_trunc(a: np.ndarray, d: int) -> np.ndarray:
    return np.trunc(a / d).astype(np.int64)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}
_ARITH_OPS = {"+", "-", "*", "/", "%"}


def literal_column(value, n: int, ctype: Optional[DType] = None) -> Column:
    if value is None:
        ct = ctype or INT32
        data = np.zeros(n, dtype=columnar.numpy_dtype(ct))
        return Column(data, ct, np.zeros(n, dtype=bool))
    if isinstance(value, bool):
        return Column(np.full(n, value, dtype=bool), BOOL)
    if isinstance(value, int):
        ct = ctype or (INT64 if abs(value) > 2**31 - 1 else INT32)
        if ct.kind == "decimal":
            return Column(np.full(n, value * 10 ** ct.scale, np.int64), ct)
        return Column(np.full(n, value, columnar.numpy_dtype(ct)), ct)
    if isinstance(value, float):
        if ctype and ctype.kind == "decimal":
            return Column(
                np.full(n, round(value * 10 ** ctype.scale), np.int64), ctype)
        return Column(np.full(n, value, np.float64), FLOAT64)
    if isinstance(value, str):
        d = np.array([value], dtype=object)
        return Column(np.zeros(n, dtype=np.int32), STRING, None, d)
    raise NotImplementedError(f"literal {value!r}")


class Evaluator:
    """Evaluates an Expr against a Table (numpy backend)."""

    def __init__(self, table: Table):
        self.table = table
        self.n = table.num_rows

    def eval(self, e: Expr) -> Column:
        if isinstance(e, ColumnRef):
            return self.table.column(e.name)
        if isinstance(e, Literal):
            return literal_column(e.value, self.n, e.ctype)
        if isinstance(e, Cast):
            return cast_column(self.eval(e.operand), e.target)
        if isinstance(e, BinOp):
            return self._binop(e)
        if isinstance(e, UnaryOp):
            return self._unary(e)
        if isinstance(e, Case):
            return self._case(e)
        if isinstance(e, Func):
            return self._func(e)
        if isinstance(e, InList):
            return self._in_list(e)
        if isinstance(e, Param):
            vals = active_params()
            if vals is None or e.shape:
                raise RuntimeError(
                    f"unbound parameter slot {e.slot} reached evaluation")
            return literal_column(vals[e.slot], self.n, e.ctype)
        if isinstance(e, InParam):
            vals = active_params()
            if vals is None:
                raise RuntimeError(
                    f"unbound parameter slot {e.slot} reached evaluation")
            return self._in_list(
                InList(e.operand, tuple(vals[e.slot]), e.negated))
        if isinstance(e, SubqueryExpr):
            raise RuntimeError(
                "unresolved subquery reached evaluation — planner bug")
        raise NotImplementedError(f"eval {type(e).__name__}")

    # -- operators -----------------------------------------------------------

    def _binop(self, e: BinOp) -> Column:
        op = e.op
        if op in ("and", "or"):
            return self._logical(op, self.eval(e.left), self.eval(e.right))
        lc = self.eval(e.left)
        rc = self.eval(e.right)
        if op in _CMP_OPS:
            return self._compare(op, lc, rc)
        if op in _ARITH_OPS:
            return self._arith(op, lc, rc)
        if op == "||":
            return self._concat(lc, rc)
        raise NotImplementedError(f"binop {op}")

    def _logical(self, op: str, lc: Column, rc: Column) -> Column:
        lv, rv = lc.validity(), rc.validity()
        ld = lc.data.astype(bool) & lv
        rd = rc.data.astype(bool) & rv
        if op == "and":
            data = ld & rd
            # null unless (false anywhere) or (both valid)
            definite_false = (~lc.data.astype(bool) & lv) | \
                             (~rc.data.astype(bool) & rv)
            valid = (lv & rv) | definite_false
        else:
            data = ld | rd
            definite_true = ld | rd
            valid = (lv & rv) | definite_true
        return Column(data, BOOL, None if valid.all() else valid)

    def _align_for_compare(self, lc: Column, rc: Column):
        """Return comparable numpy arrays for the two sides."""
        lk, rk = lc.ctype.kind, rc.ctype.kind
        if lk == "string" and rk == "string":
            if lc.dictionary is not None and rc.dictionary is not None:
                if len(rc.dictionary) and len(lc.dictionary) and \
                        np.array_equal(lc.dictionary, rc.dictionary):
                    return lc.data, rc.data
                # translate right codes into left's dictionary ordering via
                # string rank comparison: compare decoded order keys
                merged = columnar.merge_dictionaries([lc, rc])
                ltr = columnar.translate_codes(lc, merged)
                rtr = columnar.translate_codes(rc, merged)
                return ltr, rtr
        if lk == "decimal" or rk == "decimal":
            s = max(lc.ctype.scale if lk == "decimal" else 0,
                    rc.ctype.scale if rk == "decimal" else 0)
            tgt = decimal(38, s)
            if "float64" in (lk, rk):
                return (cast_column(lc, FLOAT64).data,
                        cast_column(rc, FLOAT64).data)
            return cast_column(lc, tgt).data, cast_column(rc, tgt).data
        if lk == "float64" or rk == "float64":
            return (cast_column(lc, FLOAT64).data,
                    cast_column(rc, FLOAT64).data)
        return lc.data, rc.data

    def _compare(self, op: str, lc: Column, rc: Column) -> Column:
        # implicit string->date coercion (Spark semantics): a string
        # compared against a date parses as a date, unparseable -> NULL.
        # Without it both backends fell through to comparing date days
        # against raw dictionary codes — `d_date >= '2002-4-01'` matched
        # every date since 1970 (the string's code is 0).
        if lc.ctype.kind == "date" and rc.ctype.kind == "string":
            rc = string_to_date_column(rc)
        elif rc.ctype.kind == "date" and lc.ctype.kind == "string":
            lc = string_to_date_column(lc)
        ld, rd = self._align_for_compare(lc, rc)
        if op == "=":
            data = ld == rd
        elif op == "<>":
            data = ld != rd
        elif op == "<":
            data = ld < rd
        elif op == "<=":
            data = ld <= rd
        elif op == ">":
            data = ld > rd
        else:
            data = ld >= rd
        valid = lc.validity() & rc.validity()
        return Column(np.asarray(data, dtype=bool), BOOL,
                      None if valid.all() else valid)

    def _arith(self, op: str, lc: Column, rc: Column) -> Column:
        lk, rk = lc.ctype.kind, rc.ctype.kind
        valid = lc.validity() & rc.validity()
        vopt = None if valid.all() else valid
        # date +/- interval days (int)
        if lk == "date" and rk in ("int32", "int64"):
            data = (lc.data.astype(np.int64) +
                    (rc.data if op == "+" else -rc.data)).astype(np.int32)
            return Column(data, DATE, vopt)
        if op == "/":
            ld = cast_column(lc, FLOAT64).data
            rd = cast_column(rc, FLOAT64).data
            safe = np.where(rd == 0, 1.0, rd)
            data = ld / safe
            valid = valid & (rd != 0)  # Spark: x/0 -> NULL
            return Column(data, FLOAT64,
                          None if valid.all() else valid)
        if lk == "decimal" or rk == "decimal":
            if "float64" in (lk, rk):
                ld = cast_column(lc, FLOAT64).data
                rd = cast_column(rc, FLOAT64).data
                data = {"+": ld + rd, "-": ld - rd, "*": ld * rd,
                        "%": np.mod(ld, np.where(rd == 0, 1, rd))}[op]
                return Column(data, FLOAT64, vopt)
            ls = lc.ctype.scale if lk == "decimal" else 0
            rs = rc.ctype.scale if rk == "decimal" else 0
            if op == "*":
                data = lc.data.astype(np.int64) * rc.data.astype(np.int64)
                return Column(data, decimal(38, ls + rs), vopt)
            s = max(ls, rs)
            ld = lc.data.astype(np.int64) * (10 ** (s - ls))
            rd = rc.data.astype(np.int64) * (10 ** (s - rs))
            if op == "%":
                safe = np.where(rd == 0, 1, rd)
                data = np.mod(ld, safe)
                valid = valid & (rd != 0)
                return Column(data, decimal(38, s),
                              None if valid.all() else valid)
            data = ld + rd if op == "+" else ld - rd
            return Column(data, decimal(38, s), vopt)
        tgt = common_type(lc.ctype, rc.ctype)
        ld = cast_column(lc, tgt).data
        rd = cast_column(rc, tgt).data
        if op == "%":
            safe = np.where(rd == 0, 1, rd)
            data = np.mod(ld, safe)
            valid = valid & (rd != 0)
            return Column(data, tgt, None if valid.all() else valid)
        data = {"+": ld + rd, "-": ld - rd, "*": ld * rd}[op]
        return Column(data, tgt, vopt)

    def _concat(self, lc: Column, rc: Column) -> Column:
        ls = cast_column(lc, STRING)
        rs = cast_column(rc, STRING)
        lv, rv = ls.to_pylist(), rs.to_pylist()
        return Column.from_strings(
            [None if a is None or b is None else a + b
             for a, b in zip(lv, rv)])

    def _unary(self, e: UnaryOp) -> Column:
        c = self.eval(e.operand)
        if e.op == "not":
            v = c.validity()
            return Column(~c.data.astype(bool), BOOL,
                          None if v.all() else v)
        if e.op == "neg":
            return Column(-c.data, c.ctype, c.valid)
        if e.op == "isnull":
            return Column(~c.validity(), BOOL)
        if e.op == "isnotnull":
            return Column(c.validity().copy(), BOOL)
        raise NotImplementedError(f"unary {e.op}")

    def _case(self, e: Case) -> Column:
        n = self.n
        conds = []
        vals = []
        for cond, val in e.whens:
            cc = self.eval(cond)
            conds.append(cc.data.astype(bool) & cc.validity())
            vals.append(self.eval(val))
        default = (self.eval(e.default) if e.default is not None
                   else None)
        # unify result type
        cands = vals + ([default] if default is not None else [])
        tgt = cands[0].ctype
        for c in cands[1:]:
            if is_numeric(c.ctype) and is_numeric(tgt):
                tgt = common_type(tgt, c.ctype)
            elif c.ctype.kind != tgt.kind:
                tgt = c.ctype if tgt.kind == "int32" else tgt
        if tgt.kind == "string":
            out: List = [None] * n
            taken = np.zeros(n, dtype=bool)
            for cond, val in zip(conds, vals):
                sv = cast_column(val, STRING).to_pylist()
                idx = np.nonzero(cond & ~taken)[0]
                for i in idx:
                    out[i] = sv[i]
                taken |= cond
            if default is not None:
                dv = cast_column(default, STRING).to_pylist()
                for i in np.nonzero(~taken)[0]:
                    out[i] = dv[i]
            return Column.from_strings(out)
        data = np.zeros(n, dtype=columnar.numpy_dtype(tgt))
        valid = np.zeros(n, dtype=bool)
        taken = np.zeros(n, dtype=bool)
        for cond, val in zip(conds, vals):
            vc = cast_column(val, tgt)
            sel = cond & ~taken
            data = np.where(sel, vc.data, data)
            valid = np.where(sel, vc.validity(), valid)
            taken |= cond
        if default is not None:
            dc = cast_column(default, tgt)
            data = np.where(taken, data, dc.data)
            valid = np.where(taken, valid, dc.validity())
        return Column(data.astype(columnar.numpy_dtype(tgt)), tgt,
                      None if valid.all() else valid)

    def _in_list(self, e: InList) -> Column:
        c = self.eval(e.operand)
        had_null = False
        if c.ctype.kind == "string":
            vals = set(str(v) for v in e.values)
            hit_codes = np.array(
                [i for i, d in enumerate(c.dictionary) if str(d) in vals],
                dtype=np.int32)
            data = np.isin(c.data, hit_codes)
        elif c.ctype.kind == "decimal":
            vals, had_null = coerce_in_values(c.ctype, e.values)
            data = np.isin(c.data, np.array(vals, dtype=np.int64)) \
                if vals else np.zeros(len(c.data), dtype=bool)
        else:
            vals, had_null = coerce_in_values(c.ctype, e.values)
            data = np.isin(c.data, np.array(vals)) if vals else \
                np.zeros(len(c.data), dtype=bool)
        if e.negated:
            # x NOT IN (..., NULL) is never TRUE (NULL semantics)
            data = np.zeros_like(data) if had_null else ~data
        v = c.validity()
        return Column(data, BOOL, None if v.all() else v)

    # -- functions -----------------------------------------------------------

    def _dict_map(self, c: Column, fn) -> Column:
        """Apply a python string function per dictionary entry, re-encode."""
        if c.ctype.kind != "string":
            c = cast_column(c, STRING)
        new_vals = [fn(str(x)) for x in c.dictionary]
        uniq = np.unique(np.asarray(new_vals, dtype=str)) if new_vals else \
            np.empty(0, dtype=object)
        remap = np.searchsorted(uniq, np.asarray(new_vals, dtype=str)).astype(
            np.int32) if new_vals else np.empty(0, np.int32)
        out = np.full(len(c.data), -1, dtype=np.int32)
        ok = c.data >= 0
        out[ok] = remap[c.data[ok]]
        return Column(out, STRING, c.valid, uniq.astype(object))

    def _dict_pred(self, c: Column, fn) -> Column:
        """Apply a python predicate per dictionary entry -> bool column."""
        if c.ctype.kind != "string":
            c = cast_column(c, STRING)
        hits = np.array([bool(fn(str(x))) for x in c.dictionary], dtype=bool)
        data = np.zeros(len(c.data), dtype=bool)
        ok = c.data >= 0
        data[ok] = hits[c.data[ok]]
        v = c.validity()
        return Column(data, BOOL, None if v.all() else v)

    def _func(self, e: Func) -> Column:
        name = e.name
        if name == "coalesce":
            cols = [self.eval(a) for a in e.args]
            tgt = coalesce_common_type(e.args, [c.ctype for c in cols])
            if tgt.kind == "string":
                lists = [cast_column(c, STRING).to_pylist() for c in cols]
                out = [next((x for x in row if x is not None), None)
                       for row in zip(*lists)]
                return Column.from_strings(out)
            data = np.zeros(self.n, dtype=columnar.numpy_dtype(tgt))
            valid = np.zeros(self.n, dtype=bool)
            for c in cols:
                cc = cast_column(c, tgt)
                take = ~valid & cc.validity()
                data = np.where(take, cc.data, data)
                valid |= cc.validity()
            return Column(data.astype(columnar.numpy_dtype(tgt)), tgt,
                          None if valid.all() else valid)
        if name == "like":
            c = self.eval(e.args[0])
            pattern = e.args[1].value  # literal
            rx = re.compile(_like_to_regex(pattern), re.S)
            return self._dict_pred(c, lambda s: rx.fullmatch(s) is not None)
        if name in ("substr", "substring"):
            c = self.eval(e.args[0])
            start = int(e.args[1].value)
            length = int(e.args[2].value) if len(e.args) > 2 else None

            def sub(s: str) -> str:
                i = start - 1 if start > 0 else len(s) + start
                return s[i:i + length] if length is not None else s[i:]
            return self._dict_map(c, sub)
        if name == "upper":
            return self._dict_map(self.eval(e.args[0]), str.upper)
        if name == "lower":
            return self._dict_map(self.eval(e.args[0]), str.lower)
        if name == "trim":
            return self._dict_map(self.eval(e.args[0]), str.strip)
        if name == "length":
            c = self.eval(e.args[0])
            if c.ctype.kind != "string":
                c = cast_column(c, STRING)
            lens = np.array([len(str(x)) for x in c.dictionary],
                            dtype=np.int32)
            data = np.zeros(len(c.data), dtype=np.int32)
            ok = c.data >= 0
            data[ok] = lens[c.data[ok]]
            return Column(data, INT32, c.valid)
        if name == "abs":
            c = self.eval(e.args[0])
            return Column(np.abs(c.data), c.ctype, c.valid)
        if name == "round":
            c = self.eval(e.args[0])
            nd = int(e.args[1].value) if len(e.args) > 1 else 0
            if c.ctype.kind == "decimal":
                if nd >= c.ctype.scale:
                    return c
                return cast_column(c, decimal(c.ctype.precision, nd))
            # float round-half-up (Spark semantics), not banker's rounding
            m = 10.0 ** nd
            data = np.floor(np.abs(c.data) * m + 0.5) / m * np.sign(c.data)
            return Column(data, FLOAT64, c.valid)
        if name == "floor":
            c = cast_column(self.eval(e.args[0]), FLOAT64)
            return Column(np.floor(c.data), FLOAT64, c.valid)
        if name == "ceil":
            c = cast_column(self.eval(e.args[0]), FLOAT64)
            return Column(np.ceil(c.data), FLOAT64, c.valid)
        if name == "sqrt":
            c = cast_column(self.eval(e.args[0]), FLOAT64)
            with np.errstate(invalid="ignore"):
                return Column(np.sqrt(np.maximum(c.data, 0)), FLOAT64, c.valid)
        if name == "year":
            c = self.eval(e.args[0])
            days = c.data.astype("datetime64[D]")
            years = days.astype("datetime64[Y]").astype(int) + 1970
            return Column(years.astype(np.int32), INT32, c.valid)
        if name == "month":
            c = self.eval(e.args[0])
            days = c.data.astype("datetime64[D]")
            months = days.astype("datetime64[M]").astype(int) % 12 + 1
            return Column(months.astype(np.int32), INT32, c.valid)
        if name == "day":
            c = self.eval(e.args[0])
            days = c.data.astype("datetime64[D]")
            dom = (days - days.astype("datetime64[M]")).astype(int) + 1
            return Column(dom.astype(np.int32), INT32, c.valid)
        if name == "concat":
            cols = [cast_column(self.eval(a), STRING).to_pylist()
                    for a in e.args]
            out = [None if any(x is None for x in row) else "".join(row)
                   for row in zip(*cols)]
            return Column.from_strings(out)
        if name == "nullif":
            a = self.eval(e.args[0])
            b = self.eval(e.args[1])
            eqc = self._compare("=", a, b)
            eq = eqc.data & eqc.validity()
            valid = a.validity() & ~eq
            return Column(a.data, a.ctype, None if valid.all() else valid,
                          a.dictionary)
        raise NotImplementedError(f"function {name}")


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def eval_predicate(table: Table, e: Expr) -> np.ndarray:
    """Evaluate a predicate to a keep-mask (NULL -> False, SQL WHERE)."""
    c = Evaluator(table).eval(e)
    return np.asarray(c.data, dtype=bool) & c.validity()
