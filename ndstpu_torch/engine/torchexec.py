"""PyTorch execution backend — the port of ``ndstpu.engine.jaxexec``.

Executes the optimized logical plans of ``ndstpu_torch.engine.plan`` on
torch tensors that live on one device (``cuda``, or ``cpu`` when the
caller asks for it).  This is the eager executor, the counterpart of
``jaxexec.JaxExecutor``; the compiling executor with its discovery and
replay is a later slice.

Design, kept from jaxexec:

* **Alive mask.**  A table is a set of columns plus a boolean ``alive``
  vector.  Filters only AND the mask; compaction happens at the few points
  that need it (LIMIT), and data-dependent output sizes (join fan-out)
  sync one scalar to the host.  jaxexec pads every table to a power-of-two
  size class so XLA retraces per class, not per row count; eager PyTorch
  does not retrace, so the port sizes tables exactly (at least one row).
  Padding comes back with the CUDA-graph replay slice, where captured
  shapes must be static.
* **Sort-based relational operators.**  Group-by = lexicographic stable
  sort → adjacent-difference dense group ids → segment reductions (exact
  int64 for decimals), or linearized ids over a small static key domain.
  Equi-join = mixed-radix composite key → direct-addressed lookup table
  (or one sort of both sides) → ragged expansion.
* **Strings never touch the device.**  String columns are int32 codes into
  per-column sorted dictionaries; dictionary work is done on the host.
* **Exact decimals.**  decimal(p,s) is scale-shifted int64; grouped sums
  go through the hand-written kernel ``ndstpu_torch.ops.segsum``.

There is no numpy fallback: a plan node or expression without a port
raises :class:`Unsupported`, with the NDS2xx code jaxexec uses where it
has one, so no plan quietly leaves the device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ndstpu_torch.engine import columnar, expr as ex, plan as lp
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
from ndstpu_torch.ops import segsum

# Sentinels (int64 key space)
_NULL_KEY = -(2 ** 62)      # NULL group/join key
_DEAD_KEY = 2 ** 62         # filtered-out rows
# int32 key space (narrow keys whose domain fits int32)
_NULL32 = -(2 ** 30)
_DEAD32 = 2 ** 30
_ORD_DEAD32 = 2 ** 30 + 1   # order keys: dead strictly last
_NARROW_LIM = 2 ** 30       # |value| bound for int32 keys

# aggregate registries (ndstpu/analysis/lowering.py SUPPORTED_AGG_FUNCS,
# DISTINCT_AGG_FUNCS), kept as literals: the port imports nothing of ndstpu
SUPPORTED_AGG_FUNCS = frozenset({
    "sum", "count", "avg", "min", "max",
    "stddev_samp", "var_samp", "stddev", "variance",
})
DISTINCT_AGG_FUNCS = frozenset({"sum", "count", "avg", "min", "max"})

# group-by strategy: "sort" = lexsort dense ids only; "auto" = linearized
# ids when the key domain is small (no sort); "kernel" = auto + the exact
# segment-sum kernel for int/decimal sum and avg (jaxexec's "pallas")
GROUPBY_MODES = ("sort", "auto", "kernel")
GROUPBY_DEFAULT = "kernel"

_TORCH_DTYPES = {
    "int32": torch.int32,
    "int64": torch.int64,
    "float64": torch.float64,
    "decimal": torch.int64,
    "date": torch.int32,
    "string": torch.int32,
    "bool": torch.bool,
}


def torch_dtype(ct: DType) -> torch.dtype:
    return _TORCH_DTYPES[ct.kind]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises when CUDA is asked for (or defaulted to) and
    there is no card — no quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return dev


@dataclasses.dataclass
class _View:
    """Shared row indirection for lazily-gathered columns: ``idx`` maps
    the current capacity into a BASE column's capacity (always one
    level — compositions fold into a single gather), ``mask`` is an
    accumulated validity-kill at the current capacity (or None)."""

    idx: torch.Tensor
    mask: Optional[torch.Tensor] = None


class DCol:
    """Device column: data + validity (meaningful where alive).

    Either materialized (``data``/``valid`` tensors) or a lazy view over a
    base column (``src_data``/``src_valid`` + shared :class:`_View`) that
    materializes on first ``.data``/``.valid`` access with ONE gather from
    the base."""

    __slots__ = ("_data", "_valid", "ctype", "dictionary", "bounds",
                 "src_data", "src_valid", "view")

    def __init__(self, data, valid, ctype: DType,
                 dictionary: Optional[np.ndarray] = None,
                 bounds: Optional[Tuple[int, int]] = None):
        self._data = data
        self._valid = valid
        self.ctype = ctype
        # host-side, sorted dictionary for string columns
        self.dictionary = dictionary
        # host-side static (lo, hi) over the column's valid values, set at
        # upload and preserved by row-subset ops (gather/filter); lets
        # group-by linearize small integer key domains without sorting
        self.bounds = bounds
        self.src_data = None
        self.src_valid = None
        self.view = None

    @classmethod
    def lazy(cls, src_data, src_valid, view: _View, ctype: DType,
             dictionary=None, bounds=None) -> "DCol":
        c = cls(None, None, ctype, dictionary, bounds)
        c.src_data = src_data
        c.src_valid = src_valid
        c.view = view
        return c

    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            self._data = self.src_data[self.view.idx]
        return self._data

    @property
    def valid(self) -> torch.Tensor:
        if self._valid is None:
            v = self.view.mask
            if self.src_valid is not None:
                sv = self.src_valid[self.view.idx]
                v = sv if v is None else (sv & v)
            if v is None:
                v = torch.ones(self.view.idx.shape[0], dtype=torch.bool,
                               device=self.view.idx.device)
            self._valid = v
        return self._valid

    @property
    def capacity(self) -> int:
        if self._data is not None:
            return int(self._data.shape[0])
        return int(self.view.idx.shape[0])


def _gather_cols(cols: Dict[str, DCol], idx: torch.Tensor,
                 extra_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, DCol]:
    """Lazily gather every column by ``idx``: columns sharing a view
    compose index/mask ONCE; materialized sources just wrap.  With
    ``extra_mask`` the gathered validity is additionally ANDed (at the
    output capacity)."""
    ident = _View(idx, extra_mask)
    memo: Dict[int, _View] = {}
    out: Dict[str, DCol] = {}
    for n, c in cols.items():
        if c.view is None:
            out[n] = DCol.lazy(c._data, c._valid, ident, c.ctype,
                               c.dictionary, c.bounds)
            continue
        v2 = memo.get(id(c.view))
        if v2 is None:
            nidx = c.view.idx[idx]
            nmask = c.view.mask[idx] if c.view.mask is not None else None
            if extra_mask is not None:
                nmask = extra_mask if nmask is None else \
                    (nmask & extra_mask)
            v2 = memo[id(c.view)] = _View(nidx, nmask)
        out[n] = DCol.lazy(c.src_data, c.src_valid, v2, c.ctype,
                           c.dictionary, c.bounds)
    return out


@dataclasses.dataclass
class DTable:
    """Device table: named columns + alive mask, all of one capacity."""

    columns: Dict[str, DCol]
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> DCol:
        return self.columns[name]

    def select(self, names: Sequence[str]) -> "DTable":
        return DTable({n: self.columns[n] for n in names}, self.alive)

    def gather(self, idx: torch.Tensor, alive: torch.Tensor) -> "DTable":
        return DTable(_gather_cols(self.columns, idx), alive)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def to_device(t: Table, device) -> DTable:
    """Host (or already device-resident) table -> DTable on ``device``.
    Column data may be numpy arrays or torch tensors; tensors already on
    ``device`` are used as they are.  An empty table keeps one dead row,
    so every operator can clip indices into ``[0, capacity)``."""
    device = torch.device(device)
    n = t.num_rows
    cap = max(n, 1)
    cols: Dict[str, DCol] = {}
    for name, c in t.columns.items():
        data = torch.as_tensor(c.data).to(device=device,
                                          dtype=torch_dtype(c.ctype))
        if c.valid is None:
            valid = torch.ones(cap, dtype=torch.bool, device=device)
        else:
            valid = torch.as_tensor(c.valid).to(device)
        if n == 0:
            data = torch.zeros(cap, dtype=data.dtype, device=device)
            valid = torch.zeros(cap, dtype=torch.bool, device=device)
        bounds = None
        if c.ctype.kind in ("int32", "int64", "date", "decimal") and n > 0:
            hv = data if c.valid is None else data[valid]
            if hv.numel():
                lo, hi = torch.aminmax(hv)
                bounds = (int(lo), int(hi))
        cols[name] = DCol(data, valid, c.ctype, c.dictionary, bounds)
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return DTable(cols, alive)


def to_host(dt: DTable) -> Table:
    alive = dt.alive
    cols: Dict[str, Column] = {}
    for name, c in dt.columns.items():
        data = c.data[alive].cpu().numpy()
        valid = c.valid[alive].cpu().numpy()
        cols[name] = Column(data, c.ctype,
                            None if valid.all() else valid, c.dictionary)
    return Table(cols)


class Unsupported(Exception):
    """Raised when an expr/plan node has no port yet.

    ``code`` is the static-analyzer diagnostic (NDS2xx, see
    ndstpu/analysis/diagnostics.py) jaxexec raises at the same place;
    nodes jaxexec runs but the port does not yet stay uncoded."""

    def __init__(self, msg: str, code: Optional[str] = None):
        super().__init__(msg)
        self.code = code


# ---------------------------------------------------------------------------
# dictionary helpers (host work, device gathers)
# ---------------------------------------------------------------------------


def _dict_lookup_bool(c: DCol, fn) -> torch.Tensor:
    """Host predicate per dictionary entry -> device bool gather."""
    hits = np.array([bool(fn(str(x))) for x in c.dictionary], dtype=bool)
    table = torch.as_tensor(np.concatenate([hits, [False]])).to(
        c.data.device)                                    # -1 -> False
    return table[c.data]


def _translate(c: DCol, merged: np.ndarray) -> torch.Tensor:
    """Device codes of `c` re-expressed in `merged` dictionary order.
    Unmatched/-1 codes become -2 (never equal to a valid code)."""
    dev = c.data.device
    if c.dictionary is None or len(c.dictionary) == 0:
        return torch.full(c.data.shape, -2, dtype=torch.int32, device=dev)
    pos = np.searchsorted(merged, c.dictionary.astype(str))
    posc = np.clip(pos, 0, max(len(merged) - 1, 0))
    hit = merged[posc] == c.dictionary.astype(str) if len(merged) else \
        np.zeros(len(c.dictionary), dtype=bool)
    mapping = np.where(hit, posc, -2).astype(np.int32)
    table = torch.as_tensor(
        np.concatenate([mapping, [-2]]).astype(np.int32)).to(dev)
    return table[c.data]


def _merged_dict(cols: Sequence[DCol]) -> np.ndarray:
    parts = [c.dictionary.astype(str) for c in cols
             if c.dictionary is not None and len(c.dictionary)]
    if not parts:
        return np.empty(0, dtype=str)
    return np.unique(np.concatenate(parts))


class JEval:
    """Evaluates an Expr over a DTable with torch ops (jaxexec.JEval).

    Ported so far: column refs, literals, casts, comparisons, and/or/not,
    null tests, arithmetic and IN-lists."""

    _CMP = {"=", "<>", "<", "<=", ">", ">="}
    _ARITH = {"+", "-", "*", "/", "%"}

    def __init__(self, table: DTable):
        self.t = table
        self.cap = table.capacity
        self.device = table.alive.device

    def _full(self, value, dtype) -> torch.Tensor:
        return torch.full((self.cap,), value, dtype=dtype,
                          device=self.device)

    def _ones(self) -> torch.Tensor:
        return torch.ones(self.cap, dtype=torch.bool, device=self.device)

    # -- helpers -------------------------------------------------------------

    def _lit(self, value, ctype: Optional[DType]) -> DCol:
        cap = self.cap
        if value is None:
            ct = ctype or INT32
            return DCol(torch.zeros(cap, dtype=torch_dtype(ct),
                                    device=self.device),
                        torch.zeros(cap, dtype=torch.bool,
                                    device=self.device), ct,
                        np.empty(0, object) if ct.kind == "string" else None)
        valid = self._ones()
        if isinstance(value, bool):
            return DCol(self._full(value, torch.bool), valid, BOOL)
        if isinstance(value, int):
            # point bounds: every valid row is exactly this value
            ct = ctype or (INT64 if abs(value) > 2 ** 31 - 1 else INT32)
            if ct.kind == "decimal":
                v = value * 10 ** ct.scale
                return DCol(self._full(v, torch.int64), valid, ct,
                            bounds=(v, v))
            return DCol(self._full(value, torch_dtype(ct)), valid, ct,
                        bounds=(int(value), int(value)))
        if isinstance(value, float):
            if ctype and ctype.kind == "decimal":
                v = round(value * 10 ** ctype.scale)
                return DCol(self._full(v, torch.int64), valid, ctype,
                            bounds=(v, v))
            return DCol(self._full(value, torch.float64), valid, FLOAT64)
        if isinstance(value, str):
            d = np.array([value], dtype=object)
            return DCol(self._full(0, torch.int32), valid, STRING, d)
        raise Unsupported(f"literal {value!r}", code="NDS201")

    def cast(self, c: DCol, target: DType) -> DCol:
        k, tk = c.ctype.kind, target.kind
        if k == tk and (tk != "decimal" or c.ctype.scale == target.scale):
            if tk != "decimal":
                return c
            if target.precision < c.ctype.precision:
                # Spark non-ANSI overflow: out-of-precision values -> NULL
                limit = 10 ** target.precision
                ok = torch.abs(c.data) < limit
                b = (-(limit - 1), limit - 1)
                if c.bounds is not None:
                    b = (max(b[0], c.bounds[0]), min(b[1], c.bounds[1]))
                return DCol(c.data, c.valid & ok, target, c.dictionary,
                            bounds=b if b[0] <= b[1] else None)
            return DCol(c.data, c.valid, target, c.dictionary,
                        bounds=c.bounds)
        if tk == "float64":
            if k == "decimal":
                data = c.data.to(torch.float64) / (10 ** c.ctype.scale)
            elif k == "string":
                data, valid = self._string_parse_float(c)
                return DCol(data, valid, FLOAT64)
            else:
                data = c.data.to(torch.float64)
            return DCol(data, c.valid, FLOAT64)
        if tk == "decimal":
            scale = 10 ** target.scale
            bounds = None
            if k == "decimal":
                shift = target.scale - c.ctype.scale
                if shift >= 0:
                    data = c.data * (10 ** shift)
                    if c.bounds is not None:
                        m = 10 ** shift
                        bounds = (c.bounds[0] * m, c.bounds[1] * m)
                else:
                    d = 10 ** (-shift)
                    sign = torch.sign(c.data)
                    data = sign * torch.div(torch.abs(c.data) + d // 2, d,
                                            rounding_mode="floor")
                    if c.bounds is not None:
                        # round-half-away-from-zero is monotonic
                        def _rd(v: int) -> int:
                            s = -1 if v < 0 else 1
                            return s * ((abs(v) + d // 2) // d)
                        bounds = (_rd(c.bounds[0]), _rd(c.bounds[1]))
            elif k == "float64":
                x = c.data * scale
                data = (torch.floor(torch.abs(x) + 0.5) *
                        torch.sign(x)).to(torch.int64)
            elif k == "string":
                f, valid = self._string_parse_float(c)
                x = f * scale
                data = (torch.floor(torch.abs(x) + 0.5) *
                        torch.sign(x)).to(torch.int64)
                return DCol(data, valid, target)
            else:
                data = c.data.to(torch.int64) * scale
                if k in ("int32", "int64") and c.bounds is not None:
                    bounds = (c.bounds[0] * scale, c.bounds[1] * scale)
                elif k == "bool":
                    bounds = (0, scale)
            return DCol(data.to(torch.int64), c.valid, target,
                        bounds=bounds)
        if tk in ("int32", "int64"):
            dt = torch.int64 if tk == "int64" else torch.int32
            bounds = None
            if k == "decimal":
                data = torch.trunc(
                    c.data.to(torch.float64) / (10 ** c.ctype.scale)).to(dt)
                if c.bounds is not None and \
                        max(abs(c.bounds[0]), abs(c.bounds[1])) < (1 << 53):
                    # the data path divides in float64; below 2^53 the
                    # scaled value is exact and trunc(fl(v/s)) == v//s
                    s = 10 ** c.ctype.scale

                    def _tr(v: int) -> int:
                        return -((-v) // s) if v < 0 else v // s
                    bounds = (_tr(c.bounds[0]), _tr(c.bounds[1]))
            elif k == "string":
                f, valid = self._string_parse_float(c)
                return DCol(f.to(dt), valid, target)
            else:
                data = c.data.to(dt)
                if k in ("int32", "int64") and c.bounds is not None:
                    bounds = c.bounds
                elif k == "bool":
                    bounds = (0, 1)
            if bounds is not None and tk == "int32" and not (
                    -(1 << 31) <= bounds[0] and bounds[1] < (1 << 31)):
                # narrowing may wrap valid values; no safe bounds
                bounds = None
            return DCol(data, c.valid, target, bounds=bounds)
        if tk == "date":
            if k == "string":
                return self._string_parse_date(c)
            return DCol(c.data.to(torch.int32), c.valid, DATE)
        if tk == "bool":
            return DCol(c.data.to(torch.bool), c.valid, BOOL)
        raise Unsupported(f"cast {c.ctype} -> {target}", code="NDS204")

    def _dict_table(self, c: DCol, vals: np.ndarray, ok: np.ndarray):
        data = torch.as_tensor(vals).to(self.device)[c.data]
        valid = c.valid & torch.as_tensor(ok).to(self.device)[c.data]
        return data, valid

    def _string_parse_float(self, c: DCol):
        vals = np.zeros(len(c.dictionary) + 1, dtype=np.float64)
        ok = np.zeros(len(c.dictionary) + 1, dtype=bool)
        for i, s in enumerate(c.dictionary):
            try:
                vals[i] = float(str(s))
                ok[i] = True
            except ValueError:
                pass
        return self._dict_table(c, vals, ok)

    def _string_parse_date(self, c: DCol) -> DCol:
        vals = np.zeros(len(c.dictionary) + 1, dtype=np.int32)
        ok = np.zeros(len(c.dictionary) + 1, dtype=bool)
        for i, s in enumerate(c.dictionary):
            try:
                vals[i] = columnar.parse_date_days(str(s))
                ok[i] = True
            except ValueError:
                pass
        data, valid = self._dict_table(c, vals, ok)
        return DCol(data, valid, DATE)

    # -- entry ---------------------------------------------------------------

    def eval(self, e: ex.Expr) -> DCol:
        if isinstance(e, ex.ColumnRef):
            return self.t.column(e.name)
        if isinstance(e, ex.Literal):
            return self._lit(e.value, e.ctype)
        if isinstance(e, ex.Cast):
            return self.cast(self.eval(e.operand), e.target)
        if isinstance(e, ex.BinOp):
            return self._binop(e)
        if isinstance(e, ex.UnaryOp):
            return self._unary(e)
        if isinstance(e, ex.InList):
            return self._in_list(e)
        if isinstance(e, ex.Func):
            raise Unsupported(f"function {e.name} is not ported yet",
                              code="NDS205")
        raise Unsupported(f"expr {type(e).__name__}", code="NDS201")

    def predicate(self, e: ex.Expr) -> torch.Tensor:
        c = self.eval(e)
        return c.data.to(torch.bool) & c.valid & self.t.alive

    # -- operators -----------------------------------------------------------

    def _binop(self, e: ex.BinOp) -> DCol:
        op = e.op
        if op in ("and", "or"):
            lc, rc = self.eval(e.left), self.eval(e.right)
            lb, rb = lc.data.to(torch.bool), rc.data.to(torch.bool)
            ld = lb & lc.valid
            rd = rb & rc.valid
            if op == "and":
                data = ld & rd
                definite_false = (~lb & lc.valid) | (~rb & rc.valid)
                valid = (lc.valid & rc.valid) | definite_false
            else:
                data = ld | rd
                valid = (lc.valid & rc.valid) | ld | rd
            return DCol(data, valid, BOOL)
        lc, rc = self.eval(e.left), self.eval(e.right)
        if op in self._CMP:
            return self._compare(op, lc, rc)
        if op in self._ARITH:
            return self._arith(op, lc, rc)
        raise Unsupported(f"binop {op}", code="NDS202")

    def _align_compare(self, lc: DCol, rc: DCol):
        lk, rk = lc.ctype.kind, rc.ctype.kind
        if lk == "string" and rk == "string":
            if lc.dictionary is not None and rc.dictionary is not None and \
                    len(lc.dictionary) == len(rc.dictionary) and \
                    np.array_equal(lc.dictionary, rc.dictionary):
                return lc.data, rc.data
            merged = _merged_dict([lc, rc])
            return _translate(lc, merged), _translate(rc, merged)
        if lk == "decimal" or rk == "decimal":
            if "float64" in (lk, rk):
                return (self.cast(lc, FLOAT64).data,
                        self.cast(rc, FLOAT64).data)
            s = max(lc.ctype.scale if lk == "decimal" else 0,
                    rc.ctype.scale if rk == "decimal" else 0)
            tgt = decimal(38, s)
            return self.cast(lc, tgt).data, self.cast(rc, tgt).data
        if lk == "float64" or rk == "float64":
            return (self.cast(lc, FLOAT64).data,
                    self.cast(rc, FLOAT64).data)
        return lc.data, rc.data

    def _compare(self, op: str, lc: DCol, rc: DCol) -> DCol:
        # implicit string->date coercion (Spark semantics), mirroring
        # ex.Evaluator._compare so every backend stays bit-identical
        if lc.ctype.kind == "date" and rc.ctype.kind == "string":
            rc = self._string_to_date(rc)
        elif rc.ctype.kind == "date" and lc.ctype.kind == "string":
            lc = self._string_to_date(lc)
        ld, rd = self._align_compare(lc, rc)
        data = {"=": torch.eq, "<>": torch.ne, "<": torch.lt,
                "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op](ld, rd)
        return DCol(data, lc.valid & rc.valid, BOOL)

    def _string_to_date(self, c: DCol) -> DCol:
        """Parse string codes as dates through a host-parsed dictionary
        table; unparseable entries and negative codes become NULL
        (same table as ex.string_to_date_column)."""
        days, ok = ex.parse_dictionary_days(c.dictionary)
        if not len(days):
            return DCol(torch.zeros(self.cap, dtype=torch.int32,
                                    device=self.device),
                        torch.zeros(self.cap, dtype=torch.bool,
                                    device=self.device), DATE)
        codes_ok = c.data >= 0
        idx = torch.clamp(c.data, 0, len(days) - 1)
        days_t = torch.as_tensor(days).to(self.device)
        out = torch.where(codes_ok, days_t[idx], torch.zeros_like(days_t[idx]))
        valid = c.valid & codes_ok & torch.as_tensor(ok).to(self.device)[idx]
        return DCol(out.to(torch.int32), valid, DATE)

    def _arith(self, op: str, lc: DCol, rc: DCol) -> DCol:
        lk, rk = lc.ctype.kind, rc.ctype.kind
        valid = lc.valid & rc.valid
        if lk == "date" and rk in ("int32", "int64"):
            delta = rc.data.to(torch.int32)
            data = lc.data + (delta if op == "+" else -delta)
            return DCol(data, valid, DATE)
        if op == "/":
            ld = self.cast(lc, FLOAT64).data
            rd = self.cast(rc, FLOAT64).data
            safe = torch.where(rd == 0, torch.ones_like(rd), rd)
            return DCol(ld / safe, valid & (rd != 0), FLOAT64)
        if lk == "decimal" or rk == "decimal":
            if "float64" in (lk, rk):
                ld = self.cast(lc, FLOAT64).data
                rd = self.cast(rc, FLOAT64).data
                if op == "%":
                    data = torch.remainder(
                        ld, torch.where(rd == 0, torch.ones_like(rd), rd))
                else:
                    data = {"+": torch.add, "-": torch.sub,
                            "*": torch.mul}[op](ld, rd)
                return DCol(data, valid, FLOAT64)
            ls = lc.ctype.scale if lk == "decimal" else 0
            rs = rc.ctype.scale if rk == "decimal" else 0
            if op == "*":
                data = lc.data.to(torch.int64) * rc.data.to(torch.int64)
                return DCol(data, valid, decimal(38, ls + rs))
            s = max(ls, rs)
            ld = lc.data.to(torch.int64) * (10 ** (s - ls))
            rd = rc.data.to(torch.int64) * (10 ** (s - rs))
            if op == "%":
                safe = torch.where(rd == 0, torch.ones_like(rd), rd)
                return DCol(torch.remainder(ld, safe), valid & (rd != 0),
                            decimal(38, s))
            data = ld + rd if op == "+" else ld - rd
            return DCol(data, valid, decimal(38, s))
        tgt = ex.common_type(lc.ctype, rc.ctype)
        ld = self.cast(lc, tgt).data
        rd = self.cast(rc, tgt).data
        if op == "%":
            safe = torch.where(rd == 0, torch.ones_like(rd), rd)
            return DCol(torch.remainder(ld, safe), valid & (rd != 0), tgt)
        data = {"+": torch.add, "-": torch.sub, "*": torch.mul}[op](ld, rd)
        return DCol(data, valid, tgt)

    def _unary(self, e: ex.UnaryOp) -> DCol:
        c = self.eval(e.operand)
        if e.op == "not":
            return DCol(~c.data.to(torch.bool), c.valid, BOOL)
        if e.op == "neg":
            return DCol(-c.data, c.valid, c.ctype)
        if e.op == "isnull":
            return DCol(~c.valid, self._ones(), BOOL)
        if e.op == "isnotnull":
            return DCol(c.valid, self._ones(), BOOL)
        raise Unsupported(f"unary {e.op}", code="NDS203")

    def _in_list(self, e: ex.InList) -> DCol:
        c = self.eval(e.operand)
        had_null = False
        if c.ctype.kind == "string":
            vals = set(str(v) for v in e.values)
            data = _dict_lookup_bool(c, lambda s: s in vals)
        else:
            vals, had_null = ex.coerce_in_values(c.ctype, e.values)
            if not vals:
                data = torch.zeros(c.capacity, dtype=torch.bool,
                                   device=self.device)
            else:
                arr = np.array(vals, dtype=np.int64) \
                    if c.ctype.kind == "decimal" else np.asarray(vals)
                if arr.dtype == object or arr.dtype.kind in "US":
                    raise Unsupported(f"IN-list literals {arr.dtype} for "
                                      f"{c.ctype.kind} column",
                                      code="NDS212")
                # compare in the promoted type, as jnp.isin does
                test = torch.as_tensor(arr).to(self.device)
                dt = torch.promote_types(c.data.dtype, test.dtype)
                data = torch.isin(c.data.to(dt), test.to(dt))
        if e.negated:
            # x NOT IN (..., NULL) is never TRUE (NULL semantics)
            data = torch.zeros_like(data) if had_null else ~data
        return DCol(data, c.valid, BOOL)


# ---------------------------------------------------------------------------
# key helpers
# ---------------------------------------------------------------------------


def _iota(n: int, device, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def _segment_sum(vals: torch.Tensor, gid: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum for in-range ids (every caller's gids are)."""
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, gid, vals)


def _minmax_vals(data: torch.Tensor, valid: torch.Tensor, kind: str,
                 is_min: bool) -> torch.Tensor:
    """Reduction input for min/max in the data's NATIVE dtype: invalid
    rows filled with the dtype's own extremum (the reduction identity).
    Bool widens to int32."""
    if kind == "bool":
        data = data.to(torch.int32)
    info = torch.iinfo(data.dtype)
    return data.masked_fill(~valid, info.max if is_min else info.min)


def _sum_input(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact int64 summation input for decimal/int sums."""
    return data.to(torch.int64).masked_fill(~valid, 0)


def _key_i64(c: DCol, alive: torch.Tensor,
             peer: Optional[DCol] = None) -> torch.Tensor:
    """Column -> int64 key with NULL/dead sentinels (grouping/join space).
    For strings, translates into a dictionary merged with `peer` when
    dictionaries differ.  The data is widened BEFORE the sentinels are
    written: they do not fit the int32 columns."""
    if c.ctype.kind == "string":
        if peer is not None and peer.ctype.kind == "string" and not (
                c.dictionary is not None and peer.dictionary is not None and
                len(c.dictionary) == len(peer.dictionary) and
                np.array_equal(c.dictionary, peer.dictionary)):
            merged = _merged_dict([c, peer])
            data = _translate(c, merged).to(torch.int64)
        else:
            data = c.data.to(torch.int64)
    elif c.ctype.kind == "float64":
        # float64 keys stay float64; NaNs fold to DBL_MAX (one NaN group),
        # the sentinel magnitudes (2^62) are exactly representable
        data = c.data.to(torch.float64)
        data = torch.nan_to_num(data, nan=torch.finfo(torch.float64).max,
                                posinf=float("inf"), neginf=float("-inf"))
        data = data.masked_fill(~c.valid, float(_NULL_KEY))
        return data.masked_fill(~alive, float(_DEAD_KEY))
    else:
        data = c.data.to(torch.int64)
    data = data.masked_fill(~c.valid, _NULL_KEY)
    return data.masked_fill(~alive, _DEAD_KEY)


def _lexsort_order(keys: List[torch.Tensor]) -> torch.Tensor:
    """Stable argsort by multiple keys; keys[0] is the primary.

    ``lax.sort(num_keys=k, is_stable=True)`` has no single torch call: the
    port chains stable sorts from the least significant key to the most,
    so ties keep the order of the less significant keys and, at the end,
    the row order (ORDER BY results depend on it)."""
    order = torch.sort(keys[-1], stable=True)[1]
    for k in reversed(keys[:-1]):
        order = order[torch.sort(k[order], stable=True)[1]]
    return order


def _inv_permute(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = vals[i] for a permutation `order` (unique
    destinations, so the scatter is deterministic)."""
    out = torch.empty_like(vals)
    out[order] = vals
    return out


def _group_ids(keys: List[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense group ids by one lexicographic sort: (gid int32, order,
    newgrp)."""
    n = keys[0].shape[0]
    order = _lexsort_order(keys)
    diff = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
    diff[:1] = True
    for k in keys:
        ks = k[order]
        diff[1:] |= ks[1:] != ks[:-1]
    gid_sorted = torch.cumsum(diff, 0, dtype=torch.int32) - 1
    gid = _inv_permute(order, gid_sorted)
    return gid, order, diff


def _dense_rank_pair(a: torch.Tensor, b: torch.Tensor):
    """Joint dense rank of two arrays (values aligned across both).
    Ranks are int32 (row counts are always < 2^31)."""
    both = torch.cat([a, b])
    n = both.shape[0]
    s, order = torch.sort(both, stable=True)
    diff = torch.zeros(n, dtype=torch.int32, device=both.device)
    diff[1:] = (s[1:] != s[:-1]).to(torch.int32)
    rank_sorted = torch.cumsum(diff, 0, dtype=torch.int32)
    ranks = _inv_permute(order, rank_sorted)
    return ranks[:a.shape[0]], ranks[a.shape[0]:]


def _narrow_span(c: DCol) -> Optional[Tuple[int, int]]:
    """(lo, hi) when every valid value of ``c`` fits the int32 key
    space (|v| < 2^30), else None.  Strings qualify via dictionary
    size (codes are 0..len-1); int-like kinds need static bounds."""
    if c.ctype.kind == "string":
        nd = 0 if c.dictionary is None else len(c.dictionary)
        return (0, max(nd - 1, 0)) if nd < _NARROW_LIM else None
    if c.ctype.kind in ("int32", "int64", "date", "decimal") and \
            c.bounds is not None:
        lo, hi = c.bounds
        if -_NARROW_LIM < lo and hi < _NARROW_LIM:
            return (int(lo), int(hi))
    return None


def _key_col(c: DCol, alive: torch.Tensor) -> torch.Tensor:
    """Single-table grouping/sort key in the narrowest dtype: int32
    with int32 sentinels when the value domain fits, else the int64
    (or float64) encoding of :func:`_key_i64`."""
    if c.ctype.kind == "float64":
        return _key_i64(c, alive)
    if _narrow_span(c) is not None:
        data = c.data.to(torch.int32).masked_fill(~c.valid, _NULL32)
        return data.masked_fill(~alive, _DEAD32)
    return _key_i64(c, alive)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class TorchExecutor:
    """Eager plan executor on torch tensors (jaxexec.JaxExecutor).

    ``n_syncs`` counts the host syncs of the last query: each
    data-dependent capacity (join fan-out, compaction) and each bounds
    check reads one value back from the device."""

    # the segment-sum kernel takes aggregates over at most this many
    # segments (jaxexec._PALLAS_SEGS_MAX, kept so the port routes the same
    # aggregates to its kernel); jaxexec's row limit is lifted, since the
    # CUDA kernel accumulates in int64
    _KERNEL_SEGS_MAX = 32768
    # linearized group ids only below this many key slots (jaxexec's
    # NDSTPU_GROUPBY_DOMAIN default)
    _GROUPBY_DOMAIN_CAP = 1 << 21
    # direct-addressed join tables only below this many key slots
    # (jaxexec's NDSTPU_JOIN_LUT_CAP default)
    _JOIN_LUT_CAP = 1 << 25

    def __init__(self, catalog, device, groupby: str = GROUPBY_DEFAULT):
        if groupby not in GROUPBY_MODES:
            raise ValueError(f"groupby must be one of {GROUPBY_MODES}, "
                             f"got {groupby!r}")
        self.catalog = catalog
        self.device = torch.device(device)
        self.groupby_mode = groupby
        self._device_cache: Dict[str, Tuple[int, DTable]] = {}
        self.n_syncs = 0

    # -- public --------------------------------------------------------------

    def execute_to_host(self, p: lp.Plan) -> Table:
        self.n_syncs = 0
        return to_host(self.execute(p))

    def execute(self, p: lp.Plan) -> DTable:
        m = getattr(self, "_exec_" + type(p).__name__.lower(), None)
        if m is None:
            code = {"Window": "NDS209"}.get(type(p).__name__)
            raise Unsupported(f"plan node {type(p).__name__} is not ported "
                              f"yet", code=code)
        return m(p)

    # -- sync points -----------------------------------------------------------

    def _capacity_for(self, count) -> Tuple[int, int]:
        """Host-sync a data-dependent output count: (capacity, count).
        The capacity is exact (at least 1) — see the module note on
        padding."""
        n = int(count)
        self.n_syncs += 1
        return max(n, 1), n

    # -- leaves --------------------------------------------------------------

    def _table_device(self, name: str) -> DTable:
        version = self.catalog.versions.get(name)
        cached = self._device_cache.get(name)
        if cached is not None and cached[0] == version:
            return cached[1]
        dt = to_device(self.catalog.get(name), self.device)
        self._device_cache[name] = (version, dt)
        return dt

    def _exec_scan(self, p: lp.Scan) -> DTable:
        dt = self._table_device(p.table)
        if p.columns is not None:
            cols = list(p.columns) or dt.column_names[:1]
            dt = dt.select(cols)
        if p.predicate is not None:
            mask = JEval(dt).predicate(p.predicate)
            dt = DTable(dt.columns, dt.alive & mask)
        return dt

    def _exec_subqueryalias(self, p: lp.SubqueryAlias) -> DTable:
        dt = self.execute(p.child)
        if p.column_aliases:
            dt = DTable(dict(zip(p.column_aliases, dt.columns.values())),
                        dt.alive)
        return dt

    # -- row ops -------------------------------------------------------------

    def _exec_filter(self, p: lp.Filter) -> DTable:
        dt = self.execute(p.child)
        mask = JEval(dt).predicate(p.condition)
        return DTable(dt.columns, dt.alive & mask)

    def _exec_project(self, p: lp.Project) -> DTable:
        dt = self.execute(p.child)
        evl = JEval(dt)
        cols = {}
        for name, e in p.exprs:
            cols[name] = evl.eval(e)
        return DTable(cols, dt.alive)

    def _exec_limit(self, p: lp.Limit) -> DTable:
        dt = self.compact(self.execute(p.child))
        cap = dt.capacity
        keep = _iota(cap, self.device) < min(p.n, cap)
        return DTable(dt.columns, dt.alive & keep)

    def compact(self, dt: DTable) -> DTable:
        """Gather alive rows to the front (order-preserving); one sync
        point for the new capacity (the length of the nonzero list)."""
        idx = torch.nonzero(dt.alive).squeeze(1)
        cap, n_alive = self._capacity_for(idx.shape[0])
        if n_alive < cap:
            idx = torch.zeros(cap, dtype=idx.dtype, device=self.device)
        alive = _iota(cap, self.device) < n_alive
        return DTable(_gather_cols(dt.columns, idx, alive), alive)

    # -- sort ----------------------------------------------------------------

    def _order_key(self, evl: JEval, c: DCol, asc: bool,
                   nulls_first: Optional[bool]) -> torch.Tensor:
        if nulls_first is None:
            nulls_first = asc
        alive = evl.t.alive
        if c.ctype.kind == "float64":
            data = c.data.to(torch.float64)
            key = data if asc else -data
            key = key.masked_fill(~c.valid, -float("inf") if nulls_first
                                  else float("inf"))
            # dead rows strictly last
            return key.masked_fill(~alive, float("inf"))
        if _narrow_span(c) is not None:
            # int32 order key (dictionary codes already collate — the
            # dictionaries are sorted)
            data = c.data.to(torch.int32)
            key = data if asc else -data
            key = key.masked_fill(~c.valid,
                                  _NULL32 if nulls_first else -_NULL32)
            return key.masked_fill(~alive, _ORD_DEAD32)
        # widen first: the int64 sentinels do not fit an int32 column
        data = c.data.to(torch.int64)
        key = data if asc else -data
        key = key.masked_fill(~c.valid,
                              _NULL_KEY if nulls_first else -_NULL_KEY)
        return key.masked_fill(~alive, _DEAD_KEY)

    def _exec_sort(self, p: lp.Sort) -> DTable:
        dt = self.execute(p.child)
        evl = JEval(dt)
        keys = []
        for entry in p.keys:
            e, asc = entry[0], entry[1]
            nf = entry[2] if len(entry) > 2 else None
            keys.append(self._order_key(evl, evl.eval(e), asc, nf))
        order = _lexsort_order(keys)
        return dt.gather(order, dt.alive[order])

    # -- aggregate -----------------------------------------------------------

    def _exec_aggregate(self, p: lp.Aggregate) -> DTable:
        for _, e in p.aggs:
            self._check_agg_supported(e)
        if p.grouping_sets is not None:
            raise Unsupported("grouping sets are not ported yet",
                              code="NDS214")
        return self._aggregate_once(self.execute(p.child), p)

    def _check_agg_supported(self, e: ex.Expr):
        for node in e.walk():
            if isinstance(node, ex.AggExpr):
                if node.distinct and node.func not in DISTINCT_AGG_FUNCS:
                    raise Unsupported(
                        f"distinct aggregate {node.func} on device",
                        code="NDS207")
                if node.func not in SUPPORTED_AGG_FUNCS:
                    raise Unsupported(f"aggregate {node.func}",
                                      code="NDS207")

    def _aggregate_once(self, dt: DTable, p: lp.Aggregate) -> DTable:
        evl = JEval(dt)
        cap = dt.capacity
        key_cols = [(name, evl.eval(e)) for name, e in p.group_by]
        use_kernel = False
        direct = None
        if key_cols and self.groupby_mode in ("auto", "kernel"):
            direct = self._direct_group_ids(key_cols, dt.alive)
        if direct is not None:
            gid, ngseg, out_alive, out_cols = direct
            use_kernel = self.groupby_mode == "kernel"
        elif key_cols:
            keys = [_key_col(c, dt.alive) for _, c in key_cols]
            gid, order, newgrp = _group_ids(keys)
            ngseg = cap
            # representative (first-in-sorted-order) row per group
            gid_sorted = torch.cumsum(newgrp, 0, dtype=torch.int64) - 1
            first_pos = torch.full((cap,), cap, dtype=torch.int64,
                                   device=self.device)
            first_pos.scatter_reduce_(0, gid_sorted,
                                      _iota(cap, self.device, torch.int64),
                                      "amin")
            rep = order[torch.clamp(first_pos, 0, cap - 1)]
            galive = _segment_sum(dt.alive.to(torch.int32), gid, ngseg) > 0
            # group table alive mask: one slot per distinct gid
            n_groups_mask = torch.zeros(cap, dtype=torch.bool,
                                        device=self.device)
            n_groups_mask[gid] = True
            out_alive = n_groups_mask & galive
            out_cols = _gather_cols(dict(key_cols), rep, out_alive)
        else:
            # keyless (scalar) aggregate: two segments (alive rows 0,
            # dead rows 1)
            gid = torch.where(dt.alive, 0, 1).to(torch.int32)
            ngseg = 2
            out_alive = torch.tensor([True, False], device=self.device)
            out_cols = {}
        for name, e in p.aggs:
            out_cols[name] = self._eval_agg(dt, evl, e, gid, ngseg,
                                            out_alive, use_kernel)
        return DTable(out_cols, out_alive)

    def _direct_group_ids(self, key_cols, alive):
        """Linearized group ids for small host-known key domains.

        When every group key is dictionary-coded or carries static
        bounds, the (keys) tuple maps bijectively to a mixed-radix index
        over ``domain = prod(span_i + 1)`` slots (+1 = a NULL slot per
        key), so dense group ids need NO sort and segment reductions run
        over ``domain`` slots.  Returns None when ineligible; then the
        sort-based path runs.  The mixed-radix gid stays int32 (the
        domain is below 2^31; torch keeps int32 under Python-int
        arithmetic)."""
        parts = []
        domain = 1
        for _name, c in key_cols:
            if c.dictionary is not None and c.ctype.kind == "string":
                lo, span = 0, len(c.dictionary)
            elif c.bounds is not None and c.ctype.kind in (
                    "int32", "int64", "date", "decimal"):
                lo, hi = c.bounds
                span = hi - lo + 1
            else:
                return None
            if span <= 0:
                return None
            domain *= span + 1
            if domain > self._GROUPBY_DOMAIN_CAP or domain >= 2 ** 31 - 1:
                return None
            parts.append((c, lo, span))
        cap = int(alive.shape[0])
        gid = torch.zeros(cap, dtype=torch.int32, device=self.device)
        # bounds-invariant guard: a valid value outside its static bounds
        # means a DCol constructor copied bounds across a value-changing
        # transform — route the row to the trash slot (visibly dropped)
        row_ok = torch.ones(cap, dtype=torch.bool, device=self.device)
        for c, lo, span in parts:
            if -(2 ** 31) < lo and lo + span - 1 < 2 ** 31 and \
                    c.data.dtype == torch.int32:
                raw = c.data - lo
                row_ok = row_ok & (~c.valid | ((raw >= 0) & (raw < span)))
                idx = torch.clamp(raw, 0, span - 1)
            else:
                raw64 = c.data.to(torch.int64) - lo
                row_ok = row_ok & (~c.valid |
                                   ((raw64 >= 0) & (raw64 < span)))
                idx = torch.clamp(raw64, 0, span - 1).to(torch.int32)
            idx = idx.masked_fill(~c.valid, span)     # NULL slot per key
            gid = gid * (span + 1) + idx
        # dead / bounds-violating rows -> trash slot
        bad = alive & ~row_ok
        self.n_syncs += 1
        if bool(torch.any(bad)):
            warnings.warn(
                f"group-by bounds invariant violated: "
                f"{int(torch.sum(bad))} valid rows fell outside static "
                f"key bounds and were dropped (upstream bounds-"
                f"propagation bug)", stacklevel=2)
        gid = gid.masked_fill(~(alive & row_ok), domain)
        ngseg = domain + 1
        counts = _segment_sum(alive.to(torch.int32), gid, ngseg)
        out_alive = counts > 0
        out_alive[domain] = False
        # reconstruct key values from the slot index (bijective mapping)
        rem = _iota(ngseg, self.device, torch.int64)
        idxs = []
        for c, lo, span in reversed(parts):
            idxs.append(rem % (span + 1))
            rem = rem // (span + 1)
        idxs.reverse()
        out_cols: Dict[str, DCol] = {}
        for (name, c), (c2, lo, span), idx in zip(key_cols, parts, idxs):
            vout = (idx != span) & out_alive
            data = (lo + torch.clamp(idx, 0, span - 1)).to(c.data.dtype)
            out_cols[name] = DCol(data, vout, c.ctype, c.dictionary,
                                  (lo, lo + span - 1))
        return gid, ngseg, out_alive, out_cols

    def _eval_agg(self, dt: DTable, evl: JEval, e: ex.Expr, gid, ngseg,
                  out_alive, use_kernel: bool) -> DCol:
        if isinstance(e, ex.AggExpr):
            return self._agg_column(dt, evl, e, gid, ngseg, use_kernel)
        if isinstance(e, (ex.BinOp, ex.Cast, ex.Func, ex.Case, ex.Literal)):
            # expression over aggregates: evaluate leaves then combine on
            # the group-capacity table
            sub_cols: Dict[str, DCol] = {}
            counter = [0]

            def lower(node: ex.Expr) -> ex.Expr:
                if isinstance(node, ex.AggExpr):
                    name = f"__agg{counter[0]}"
                    counter[0] += 1
                    sub_cols[name] = self._agg_column(
                        dt, evl, node, gid, ngseg, use_kernel)
                    return ex.ColumnRef(name)
                if isinstance(node, ex.BinOp):
                    return ex.BinOp(node.op, lower(node.left),
                                    lower(node.right))
                if isinstance(node, ex.Cast):
                    return ex.Cast(lower(node.operand), node.target)
                if isinstance(node, ex.Func):
                    return ex.Func(node.name,
                                   tuple(lower(a) for a in node.args))
                if isinstance(node, ex.Case):
                    return ex.Case(
                        tuple((lower(c), lower(v)) for c, v in node.whens),
                        lower(node.default)
                        if node.default is not None else None)
                return node

            lowered = lower(e)
            gtable = DTable(sub_cols, out_alive) if sub_cols else DTable(
                {"__x": DCol(torch.zeros(ngseg, dtype=torch.int32,
                                         device=self.device),
                             torch.ones(ngseg, dtype=torch.bool,
                                        device=self.device), INT32)},
                out_alive)
            return JEval(gtable).eval(lowered)
        raise Unsupported(f"aggregate output {type(e).__name__}",
                          code="NDS208")

    def _kernel_sum_ok(self, c: DCol, ngseg: int) -> bool:
        """jaxexec._pallas_sum_ok's segment, type and precision gates:
        exact while every |value| < 2^41."""
        if ngseg > self._KERNEL_SEGS_MAX:
            return False
        if c.ctype.kind == "int32":
            return True
        if c.ctype.kind == "decimal":
            return c.ctype.precision <= 12      # |v| < 10^12 < 2^41
        if c.ctype.kind == "int64":
            return c.bounds is not None and \
                max(abs(c.bounds[0]), abs(c.bounds[1])) < (1 << 41)
        return False

    def _agg_column(self, dt: DTable, evl: JEval, a: ex.AggExpr, gid,
                    ngseg, use_kernel: bool) -> DCol:
        func = a.func
        alive = dt.alive
        ones = torch.ones(ngseg, dtype=torch.bool, device=self.device)
        if a.distinct and func in ("count", "sum", "avg") and \
                not isinstance(a.arg, ex.Star):
            raise Unsupported(f"{func}(distinct) is not ported yet",
                              code="NDS207")
        if isinstance(a.arg, ex.Star):
            counts = _segment_sum(alive.to(torch.int32), gid, ngseg)
            return DCol(counts.to(torch.int64), ones, INT64)
        c = evl.eval(a.arg)
        valid = c.valid & alive
        if use_kernel and func in ("sum", "avg") and \
                self._kernel_sum_ok(c, ngseg):
            # exact int64 sums + counts in one pass of the segment-sum
            # kernel (its plain version for CPU tensors)
            sums, cnts = segsum.segment_sum_decimal(
                c.data.to(torch.int64).contiguous(), gid.contiguous(),
                valid.contiguous(), ngseg)
            if func == "sum":
                if c.ctype.kind == "decimal":
                    return DCol(sums, cnts > 0, decimal(38, c.ctype.scale))
                return DCol(sums, cnts > 0, INT64)
            data = sums.to(torch.float64) / torch.clamp(cnts, min=1)
            if c.ctype.kind == "decimal":
                data = data / (10 ** c.ctype.scale)
            return DCol(data, cnts > 0, FLOAT64)
        if func == "count":
            counts = _segment_sum(valid.to(torch.int32), gid, ngseg)
            return DCol(counts.to(torch.int64), ones, INT64)
        exact = c.ctype.kind in ("decimal", "int32", "int64")
        if func in ("sum", "avg") and not exact:
            raise Unsupported(f"{func} over {c.ctype.kind} is not ported "
                              f"yet (compensated float sums)",
                              code="NDS207")
        if func == "sum":
            sums = _segment_sum(_sum_input(c.data, valid), gid, ngseg)
            got = _segment_sum(valid.to(torch.int32), gid, ngseg) > 0
            if c.ctype.kind == "decimal":
                return DCol(sums, got, decimal(38, c.ctype.scale))
            return DCol(sums, got, INT64)
        if func == "avg":
            cnts = _segment_sum(valid.to(torch.int32), gid, ngseg)
            sums = _segment_sum(_sum_input(c.data, valid), gid, ngseg)
            data = sums.to(torch.float64) / torch.clamp(cnts, min=1)
            if c.ctype.kind == "decimal":
                data = data / (10 ** c.ctype.scale)
            return DCol(data, cnts > 0, FLOAT64)
        if func in ("min", "max"):
            got = _segment_sum(valid.to(torch.int32), gid, ngseg) > 0
            reduce = "amin" if func == "min" else "amax"
            if c.ctype.kind == "float64":
                init = float("inf") if func == "min" else -float("inf")
                vals = c.data.masked_fill(~valid, init)
                out = torch.full((ngseg,), init, dtype=vals.dtype,
                                 device=self.device)
                out.scatter_reduce_(0, gid.long(), vals, reduce)
                return DCol(out, got, c.ctype)
            vals = _minmax_vals(c.data, valid, c.ctype.kind, func == "min")
            info = torch.iinfo(vals.dtype)
            out = torch.full((ngseg,), info.max if func == "min"
                             else info.min, dtype=vals.dtype,
                             device=self.device)
            out.scatter_reduce_(0, gid.long(), vals, reduce)
            return DCol(out.to(c.data.dtype), got, c.ctype,
                        c.dictionary, c.bounds)
        raise Unsupported(f"aggregate {func} is not ported yet",
                          code="NDS207")

    # -- join ----------------------------------------------------------------

    @staticmethod
    def _direct_join_spec(lc: DCol, rc: DCol):
        """Static (lo, span, lmult, rmult) when this key pair can be
        encoded directly from values (no rank-pairing sort): int-like
        kinds on both sides with known bounds, scales aligned by exact
        host-side multipliers.  None -> rank-pair fallback."""
        int_kinds = ("int32", "int64", "date", "decimal")
        if lc.ctype.kind not in int_kinds or rc.ctype.kind not in int_kinds:
            return None
        if lc.bounds is None or rc.bounds is None:
            return None
        ls = lc.ctype.scale if lc.ctype.kind == "decimal" else 0
        rs = rc.ctype.scale if rc.ctype.kind == "decimal" else 0
        s = max(ls, rs)
        lmult, rmult = 10 ** (s - ls), 10 ** (s - rs)
        blo = min(lc.bounds[0] * lmult, rc.bounds[0] * rmult)
        bhi = max(lc.bounds[1] * lmult, rc.bounds[1] * rmult)
        span = bhi - blo + 1
        if span >= 2 ** 62:
            return None
        return (blo, span, lmult, rmult)

    @staticmethod
    def _string_join_spec(lc: DCol, rc: DCol):
        """Static (merged_dict_or_None, span) for a string key pair.
        merged is None when both sides share one dictionary (codes used
        as-is)."""
        if lc.ctype.kind != "string" or rc.ctype.kind != "string":
            return None
        if lc.dictionary is not None and rc.dictionary is not None and \
                len(lc.dictionary) == len(rc.dictionary) and \
                np.array_equal(lc.dictionary, rc.dictionary):
            return (None, max(len(lc.dictionary), 1))
        merged = _merged_dict([lc, rc])
        return (merged, max(len(merged), 1))

    def _join_keys(self, lt: DTable, rt: DTable,
                   keys: List[Tuple[ex.Expr, ex.Expr]]):
        """Composite join keys on both sides (mixed-radix).

        Key pairs whose value domain is statically known (int-like with
        bounds, dictionary-coded strings) are encoded DIRECTLY from
        values — no joint dense-rank.  Only unbounded pairs (raw float64,
        computed columns without bounds) pay the rank-pairing sort.  When
        the final composite bound fits int32 the whole key build runs in
        int32."""
        levl, revl = JEval(lt), JEval(rt)
        lcols = [levl.eval(le) for le, _ in keys]
        rcols = [revl.eval(re_) for _, re_ in keys]
        capl, capr = lt.capacity, rt.capacity
        rank_radix = capl + capr + 3
        specs = []
        for lc, rc in zip(lcols, rcols):
            spec = self._direct_join_spec(lc, rc)
            if spec is None and lc.ctype.kind == "string":
                sspec = self._string_join_spec(lc, rc)
                if sspec is not None:
                    spec = ("str",) + sspec
            specs.append(spec)
        # simulate the radix accumulation host-side to pick the key dtype
        bound = 1
        redensified = False
        for spec in specs:
            if spec is None:
                radix = rank_radix
            elif spec[0] == "str":
                radix = spec[2]
            else:
                radix = spec[1]
            if bound * radix >= 2 ** 62:
                redensified = True
                bound = rank_radix
            bound *= radix
        use32 = (not redensified) and bound < 2 ** 31
        kdt = torch.int32 if use32 else torch.int64
        lkey = torch.zeros(capl, dtype=kdt, device=self.device)
        rkey = torch.zeros(capr, dtype=kdt, device=self.device)
        lvalid = torch.ones(capl, dtype=torch.bool, device=self.device)
        rvalid = torch.ones(capr, dtype=torch.bool, device=self.device)
        bound = 1  # exclusive upper bound on current composite key values
        for (lc, rc), spec in zip(zip(lcols, rcols), specs):
            if spec is not None and spec[0] == "str":
                _, merged, span = spec
                la = _translate(lc, merged) if merged is not None \
                    else lc.data
                ra = _translate(rc, merged) if merged is not None \
                    else rc.data
                # invalid codes (<0) clip into range; those rows are
                # overridden by the validity sentinels downstream
                la = torch.clamp(la, 0, span - 1).to(kdt)
                ra = torch.clamp(ra, 0, span - 1).to(kdt)
                radix = span
            elif spec is not None:
                blo, span, lmult, rmult = spec
                radix = span
                # build in int32 only when the aligned value range fits;
                # garbage (dead/invalid) rows may wrap — they are
                # sentinel-overridden downstream
                if use32 and -(2 ** 31) < blo and \
                        blo + span - 1 < 2 ** 31:
                    la = torch.clamp(lc.data.to(torch.int32) * lmult - blo,
                                     0, span - 1)
                    ra = torch.clamp(rc.data.to(torch.int32) * rmult - blo,
                                     0, span - 1)
                else:
                    la = torch.clamp(lc.data.to(torch.int64) * lmult - blo,
                                     0, span - 1).to(kdt)
                    ra = torch.clamp(rc.data.to(torch.int64) * rmult - blo,
                                     0, span - 1).to(kdt)
            else:
                if capl * capr > 2 ** 48:
                    raise Unsupported("join too large for rank pairing")
                la64 = _key_i64(lc, lt.alive, peer=rc)
                ra64 = _key_i64(rc, rt.alive, peer=lc)
                # decimal/int alignment (rank path only; direct path
                # aligns via host multipliers)
                if lc.ctype.kind == "decimal" or rc.ctype.kind == "decimal":
                    ls = lc.ctype.scale if lc.ctype.kind == "decimal" else 0
                    rs = rc.ctype.scale if rc.ctype.kind == "decimal" else 0
                    s = max(ls, rs)
                    la64 = torch.where(torch.abs(la64) < _DEAD_KEY,
                                       la64 * (10 ** (s - ls)), la64)
                    ra64 = torch.where(torch.abs(ra64) < _DEAD_KEY,
                                       ra64 * (10 ** (s - rs)), ra64)
                lr, rr = _dense_rank_pair(la64, ra64)
                la, ra = lr.to(kdt), rr.to(kdt)
                radix = rank_radix
            if bound * radix >= 2 ** 62:
                # re-densify the accumulated composite so mixed-radix
                # never overflows int64, however many join keys there are
                lkey, rkey = _dense_rank_pair(lkey, rkey)
                lkey, rkey = lkey.to(kdt), rkey.to(kdt)
                bound = rank_radix
            lkey = lkey * radix + la
            rkey = rkey * radix + ra
            bound = bound * radix
            lvalid = lvalid & lc.valid
            rvalid = rvalid & rc.valid
        return lkey, rkey, lvalid, rvalid, bound

    def _probe_counts(self, pkey: torch.Tensor, bkey: torch.Tensor,
                      bound: int):
        """Per-probe-row (lo, counts) against the build side, plus the
        build-side stable key order: ``order[lo[i] .. lo[i]+counts[i]-1]``
        are the build rows matching probe row ``i``.

        * ``bound`` small: direct-addressed lookup tables.  Build counts
          via one scatter-add over the key domain, starts via one cumsum,
          probe via two gathers.
        * otherwise: ONE stable sort of concat(build, probe) tagged by
          side; in sorted order, builds-before = prefix count, the run
          start carries lo, and scatters route lo/counts back to probe
          positions and build ranks to `order`.

        Probe rows with key < 0 (sentinels) never match; build rows with
        key < 0 never enter the tables but DO occupy `order` slots (they
        sort first).
        """
        m = int(bkey.shape[0])
        n = int(pkey.shape[0])
        dev = self.device
        if bound is not None and 0 < bound <= min(
                self._JOIN_LUT_CAP, max(8 * (m + n), 1 << 20)):
            span = int(bound)
            bidx = torch.where(bkey >= 0, bkey, span).to(torch.int32)
            cnt_t = torch.zeros(span + 1, dtype=torch.int32, device=dev)
            cnt_t.index_add_(0, bidx, torch.ones(m, dtype=torch.int32,
                                                 device=dev))
            cnt = cnt_t[:span]
            ccnt = torch.cumsum(cnt, 0, dtype=torch.int32)
            # valid build keys sort AFTER the (<0) sentinel rows in the
            # stable key order, so starts are offset by the dead count
            n_dead = torch.sum(bkey < 0, dtype=torch.int32)
            starts = ccnt - cnt + n_dead
            pk = torch.clamp(pkey, 0, span - 1).to(torch.int32)
            hit = pkey >= 0
            counts = torch.where(hit, cnt[pk], 0)
            lo = starts[pk].to(torch.int32)
            okey = torch.where(bkey >= 0, bkey, -1).to(torch.int32)
            order = torch.sort(okey, stable=True)[1]
            return lo, counts, order
        key = torch.cat([bkey, pkey])
        tag = (_iota(m + n, dev) >= m).to(torch.int32)
        sidx = _lexsort_order([key, tag])
        skey, stag = key[sidx], tag[sidx]
        isb = (stag == 0).to(torch.int32)
        builds_le = torch.cumsum(isb, 0, dtype=torch.int32)
        before = builds_le - isb                  # builds strictly before s
        newrun = torch.ones(m + n, dtype=torch.bool, device=dev)
        newrun[1:] = skey[1:] != skey[:-1]
        # `before` is non-decreasing, so cummax propagates each run
        # start's value (builds with key < run key) across the run
        lo_sorted = torch.cummax(torch.where(newrun, before, 0), 0).values
        cnt_sorted = builds_le - lo_sorted        # builds in run up to s
        # build rows -> trash slot n: duplicate destinations there make
        # the scatter non-deterministic, harmless because it is dropped
        dest = torch.where(stag == 1, sidx - m, n)
        lo = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        lo[dest] = lo_sorted
        counts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        counts[dest] = cnt_sorted
        lo, counts = lo[:n], counts[:n]
        counts = torch.where(pkey >= 0, counts, 0)
        bdest = torch.where(isb == 1, builds_le.to(torch.int64) - 1, m)
        order = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        order[bdest] = sidx
        return lo, counts, order[:m]

    @staticmethod
    def _expand_li(counts: torch.Tensor, starts: torch.Tensor,
                   out_cap: int) -> torch.Tensor:
        """Left-row index feeding each expansion output position: scatter
        each emitting row's id at its start position, cummax fills the
        run.  Starts of emitting rows are strictly increasing, so
        destinations are unique."""
        cap = int(counts.shape[0])
        dev = counts.device
        emit = counts > 0
        sdest = torch.where(emit, starts.to(torch.int64), out_cap)
        rid = torch.where(emit, _iota(cap, dev) + 1, 0)
        tmp = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
        tmp.scatter_reduce_(0, sdest, rid, "amax")
        li = torch.cummax(tmp[:out_cap], 0).values - 1
        return torch.clamp(li, 0, cap - 1)

    def _exec_join(self, p: lp.Join) -> DTable:
        if p.kind != "inner" or not p.keys:
            raise Unsupported(f"{p.kind} join is not ported yet "
                              f"(inner equi-joins only)", code="NDS210")
        lt = self.execute(p.left)
        rt = self.execute(p.right)
        return self._equi_join(lt, rt, p.keys, p.extra)

    def _equi_join(self, lt: DTable, rt: DTable, keys,
                   extra) -> DTable:
        lkey, rkey, lvalid, rvalid, bound = self._join_keys(lt, rt, keys)
        # null keys never match; dead rows already sentineled apart
        lkey = lkey.masked_fill(~(lvalid & lt.alive), -1)
        rkey = rkey.masked_fill(~(rvalid & rt.alive), -2)
        lo, counts, order = self._probe_counts(lkey, rkey, bound)
        counts = counts.masked_fill(~lt.alive, 0)
        # inner expansion: one sync point for output capacity
        out_cap, total = self._capacity_for(
            torch.sum(counts, dtype=torch.int64))
        out = self._expand(lt, rt, order, lo, counts, total, out_cap)
        if extra is not None:
            mask = JEval(out).predicate(extra)
            out = DTable(out.columns, out.alive & mask)
        return out

    def _expand(self, lt: DTable, rt: DTable, order, lo, counts,
                total: int, out_cap: int) -> DTable:
        starts = (torch.cumsum(counts, 0, dtype=torch.int64) - counts)
        pos = _iota(out_cap, self.device, torch.int64)
        li = self._expand_li(counts, starts, out_cap)
        within = pos - starts[li]
        rpos = torch.clamp(lo[li] + within, 0, rt.capacity - 1)
        ri = order[rpos]
        alive = pos < total
        lcols = _gather_cols(lt.columns, li, alive)
        rcols = _gather_cols(rt.columns, ri, alive)
        return DTable({**lcols, **rcols}, alive)
