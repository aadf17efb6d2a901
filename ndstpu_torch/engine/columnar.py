"""Columnar data model for the NDS-TPU SQL engine.

Design (TPU-first):

* A ``Column`` is a flat numpy (host) or jax (device) array plus an optional
  validity mask.  All engine kernels see only fixed-dtype numeric arrays —
  the forms XLA can tile:

  - int32 / int64           integers and surrogate keys
  - float64                 doubles (``--floats`` mode)
  - decimal(p,s)            scale-shifted int64 (exact money arithmetic)
  - date                    int32 days since 1970-01-01
  - string                  int32 codes into a per-column *sorted* dictionary
  - bool                    bool

* String dictionaries are sorted, so ``<``, ``>``, ORDER BY and range
  predicates operate directly on codes.  Cross-table string equality
  (joins) goes through a host-side code translation of the two small
  dictionaries (`translate_codes`) — unless both sides carry the SAME
  frozen warehouse-wide dictionary (``Column.gdict``, ndstpu/io/gdict.py),
  in which case codes compare directly with no translation at all.
  Columns loaded from a transcoded warehouse encode against the table's
  global dictionary sidecar, so codes are stable across chunks, shards
  and snapshots.

* NULL is carried as a validity mask (True = present).  String NULLs are
  additionally code ``-1``.

Replaces the reference's reliance on Spark's InternalRow/ColumnarBatch; the
schema layer above is ndstpu.schema (cf. reference nds/nds_schema.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ndstpu_torch.schema import (  # noqa: F401  (re-exported engine type aliases)
    BOOL,
    DATE,
    FLOAT64,
    INT32,
    INT64,
    STRING,
    DType,
    TableSchema,
    decimal,
)


_NUMPY_DTYPES = {
    "int32": np.int32,
    "int64": np.int64,
    "float64": np.float64,
    "decimal": np.int64,
    "date": np.int32,
    "string": np.int32,  # dictionary codes
    "bool": np.bool_,
}


_DATE_RE = None


def parse_date_days(s: str) -> int:
    """Days since 1970-01-01 for a date string; tolerates non-padded
    month/day ('2002-4-01', Spark-compatible) unlike raw np.datetime64."""
    global _DATE_RE
    if _DATE_RE is None:
        import re
        _DATE_RE = re.compile(r"^(\d{4})-(\d{1,2})-(\d{1,2})$")
    s = s.strip()
    m = _DATE_RE.match(s)
    if m:
        y, mo, d = m.groups()
        s = f"{y}-{int(mo):02d}-{int(d):02d}"
    return int((np.datetime64(s, "D") -
                np.datetime64("1970-01-01")).astype(int))


def _host(a):
    """``a`` as a host array (a torch tensor, on any device, copied to
    the host)."""
    return a.cpu().numpy() if hasattr(a, "cpu") else a


def numpy_dtype(ctype: DType):
    return _NUMPY_DTYPES[ctype.kind]


@dataclasses.dataclass
class Column:
    """One column: data array (+ validity mask, + dictionary for strings)."""

    data: np.ndarray
    ctype: DType
    valid: Optional[np.ndarray] = None  # bool mask, None == all valid
    dictionary: Optional[np.ndarray] = None  # object array, sorted, for string
    # frozen warehouse-wide dictionary this column's codes live in
    # (io.gdict.GlobalDict); None for ad-hoc per-call dictionaries
    gdict: Optional[object] = None

    def __post_init__(self):
        if self.ctype.kind == "string" and self.dictionary is None:
            self.dictionary = np.empty(0, dtype=object)

    def __len__(self) -> int:
        return len(self.data)

    @property
    def has_nulls(self) -> bool:
        return self.valid is not None and not bool(self.valid.all())

    def validity(self) -> np.ndarray:
        """Materialized validity mask."""
        if self.valid is None:
            return np.ones(len(self.data), dtype=bool)
        return self.valid

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def from_numpy(data: np.ndarray, ctype: DType,
                   valid: Optional[np.ndarray] = None,
                   dictionary: Optional[np.ndarray] = None) -> "Column":
        return Column(np.asarray(data, dtype=numpy_dtype(ctype)), ctype,
                      valid, dictionary)

    @staticmethod
    def from_strings(values: Sequence[Optional[str]]) -> "Column":
        """Dictionary-encode python strings (sorted dictionary)."""
        arr = np.asarray(values, dtype=object)
        valid = np.array([v is not None for v in arr], dtype=bool)
        present = arr[valid]
        uniq = np.unique(present.astype(str)) if len(present) else \
            np.empty(0, dtype=object)
        codes = np.full(len(arr), -1, dtype=np.int32)
        if len(present):
            codes[valid] = np.searchsorted(uniq, present.astype(str)).astype(
                np.int32)
        return Column(codes, STRING, None if valid.all() else valid,
                      uniq.astype(object))

    # -- value materialization ----------------------------------------------

    def to_pylist(self) -> List:
        """Decode to python values (None for nulls) — used by validation,
        output writing and the result materialization that power-run
        timing wraps (the `collect()` analog), so it is numpy-vectorized:
        the old per-element loop cost 1-2 s on a 100k-row result."""
        v = _host(self.validity())
        k = self.ctype.kind
        data = _host(self.data)
        if k == "string":
            d = self.dictionary
            good = v & (data >= 0)
            if d is None or not len(d):
                obj = np.full(len(data), None, dtype=object)
            else:
                # dictionary entries are python str by construction
                obj = d[np.clip(data, 0, len(d) - 1)].astype(object)
        elif k == "decimal":
            scale = 10 ** self.ctype.scale
            obj = (data.astype(np.float64) / scale).astype(object)
            # f64 can't hold >=2^53 unscaled values exactly; match the
            # exact int/int division semantics for those rare rows
            big = np.abs(data) >= (1 << 53)
            if big.any():
                for i in np.nonzero(big)[0]:
                    obj[i] = int(data[i]) / scale
            good = v
        elif k == "date":
            days = data.astype("timedelta64[D]") + \
                np.datetime64("1970-01-01")
            obj = days.astype("datetime64[D]").astype(str).astype(object)
            good = v
        elif k == "bool":
            obj = data.astype(bool).astype(object)
            good = v
        elif k in ("int32", "int64"):
            obj = data.astype(np.int64).astype(object)
            good = v
        else:
            obj = data.astype(np.float64).astype(object)
            good = v
        if not good.all():
            obj = obj.copy() if obj.base is not None else obj
            obj[~good] = None
        return obj.tolist()

    def gather(self, indices: np.ndarray,
               extra_valid: Optional[np.ndarray] = None) -> "Column":
        """Take rows by index; `extra_valid` marks gathered rows that are
        actually invalid (e.g. failed joins)."""
        data = self.data[indices]
        valid = self.valid[indices] if self.valid is not None else None
        if extra_valid is not None:
            valid = extra_valid if valid is None else (valid & extra_valid)
        return Column(data, self.ctype, valid, self.dictionary, self.gdict)

    def filter(self, mask: np.ndarray) -> "Column":
        valid = self.valid[mask] if self.valid is not None else None
        return Column(self.data[mask], self.ctype, valid, self.dictionary,
                      self.gdict)


def translate_codes(src: Column, dst_dictionary: np.ndarray) -> np.ndarray:
    """Map `src` string codes into another sorted dictionary's code space.
    Codes with no match become -2 (never equal to any valid code)."""
    if len(src.dictionary) == 0:
        return np.full(len(src.data), -2, dtype=np.int32)
    pos = np.searchsorted(dst_dictionary, src.dictionary)
    pos_clipped = np.clip(pos, 0, max(len(dst_dictionary) - 1, 0))
    hit = (
        dst_dictionary[pos_clipped] == src.dictionary
    ) if len(dst_dictionary) else np.zeros(len(src.dictionary), dtype=bool)
    mapping = np.where(hit, pos_clipped, -2).astype(np.int32)
    out = np.full(len(src.data), -2, dtype=np.int32)
    ok = src.data >= 0
    out[ok] = mapping[src.data[ok]]
    return out


def merge_dictionaries(cols: Sequence[Column]) -> np.ndarray:
    """Union of several sorted dictionaries (for UNION/concat of tables)."""
    parts = [c.dictionary for c in cols if c.dictionary is not None
             and len(c.dictionary)]
    if not parts:
        return np.empty(0, dtype=object)
    return np.unique(np.concatenate([p.astype(str) for p in parts])).astype(
        object)


@dataclasses.dataclass
class Table:
    """Ordered set of equal-length named columns."""

    columns: Dict[str, Column]

    def __post_init__(self):
        lens = {len(c) for c in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged table: column lengths {lens}")

    @property
    def num_rows(self) -> int:
        for c in self.columns.values():
            return len(c)
        return 0

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> Column:
        return self.columns[name]

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self.columns.items()})

    def filter(self, mask: np.ndarray) -> "Table":
        return Table({n: c.filter(mask) for n, c in self.columns.items()})

    def gather(self, indices: np.ndarray,
               extra_valid: Optional[np.ndarray] = None) -> "Table":
        return Table({n: c.gather(indices, extra_valid)
                      for n, c in self.columns.items()})

    def head(self, n: int) -> "Table":
        return Table({name: Column(c.data[:n], c.ctype,
                                   None if c.valid is None else c.valid[:n],
                                   c.dictionary, c.gdict)
                      for name, c in self.columns.items()})

    def to_pydict(self) -> Dict[str, List]:
        return {n: c.to_pylist() for n, c in self.columns.items()}

    def to_rows(self) -> List[tuple]:
        cols = [c.to_pylist() for c in self.columns.values()]
        return list(zip(*cols)) if cols else []

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """Vertical concat; re-encodes string columns into a merged
        dictionary."""
        if not tables:
            raise ValueError("concat of zero tables")
        names = tables[0].column_names
        out: Dict[str, Column] = {}
        for n in names:
            cols = [t.column(n) for t in tables]
            ct = cols[0].ctype
            if ct.kind == "string" and len(cols) > 1 and all(
                    len(c.dictionary) == len(cols[0].dictionary)
                    and np.array_equal(c.dictionary, cols[0].dictionary)
                    for c in cols[1:]):
                # shared code space (same frozen global dictionary, or
                # simply identical dictionaries): concat codes directly
                valid = np.concatenate([c.validity() for c in cols])
                out[n] = Column(np.concatenate([c.data for c in cols]), ct,
                                None if valid.all() else valid,
                                cols[0].dictionary,
                                cols[0].gdict if all(
                                    c.gdict is cols[0].gdict
                                    for c in cols) else None)
            elif ct.kind == "string":
                merged = merge_dictionaries(cols)
                datas, valids = [], []
                for c in cols:
                    codes = translate_codes(c, merged)
                    codes[codes == -2] = -1
                    datas.append(codes)
                    valids.append(c.validity())
                data = np.concatenate(datas)
                valid = np.concatenate(valids)
                out[n] = Column(data, ct, None if valid.all() else valid,
                                merged)
            else:
                data = np.concatenate([c.data for c in cols])
                valid = np.concatenate([c.validity() for c in cols])
                out[n] = Column(data, ct,
                                None if valid.all() else valid)
        return Table(out)


# ---------------------------------------------------------------------------
# Arrow interop (loader / writer boundary)
# ---------------------------------------------------------------------------


def _coerce_to_spec(arr, spec_dtype: DType):
    """Cast an arrow array toward the declared schema type, so warehouses in
    lossy formats (csv/json) still load with exact engine types."""
    import pyarrow as pa

    typ = arr.type
    k = spec_dtype.kind
    try:
        if k == "decimal" and not pa.types.is_decimal(typ):
            return arr.cast(pa.decimal128(
                max(spec_dtype.precision, spec_dtype.scale + 1),
                spec_dtype.scale))
        if k == "date" and not pa.types.is_date(typ):
            if pa.types.is_timestamp(typ):
                return arr.cast(pa.date32())
            if pa.types.is_string(typ) or pa.types.is_large_string(typ):
                return arr.cast(pa.timestamp("ms")).cast(pa.date32())
            if pa.types.is_integer(typ) or pa.types.is_floating(typ):
                # numeric dates from lossy formats: epoch-ms vs epoch-days by
                # magnitude (days fit well under 1e7; ms are > 1e10)
                import pyarrow.compute as pc
                vals = arr.cast(pa.int64())
                if len(vals) and pc.max(pc.abs(vals)).as_py() > 10**7:
                    vals = pc.divide(vals, 86_400_000)
                return vals.cast(pa.int32()).cast(pa.date32())
        if k == "float64" and not pa.types.is_floating(typ):
            return arr.cast(pa.float64())
        if k in ("int32", "int64") and typ != (
                pa.int64() if k == "int64" else pa.int32()):
            return arr.cast(pa.int64() if k == "int64" else pa.int32())
    except pa.ArrowInvalid as exc:
        import warnings
        warnings.warn(f"schema coercion to {spec_dtype} failed: {exc}; "
                      "keeping source type", RuntimeWarning)
        return arr
    return arr


def _encode_strings_arrow(arr, global_dict=None) -> Column:
    """Dictionary-encode an arrow string array with a *sorted* dictionary,
    all in arrow/numpy (no per-row python).

    With ``global_dict`` (an io.gdict.GlobalDict), codes are emitted
    against the frozen warehouse-wide dictionary instead of the values
    this call happens to see, so every chunk/shard/snapshot of the table
    shares one code space.  A value absent from the global dictionary
    (stale sidecar) falls back to a local per-call dictionary — callers
    that REQUIRE the shared code space (chunk sources) check
    ``Column.gdict`` after the fact.
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    denc = pc.dictionary_encode(arr)
    if isinstance(denc, pa.ChunkedArray):
        denc = denc.combine_chunks()
    dict_vals = np.asarray(denc.dictionary.to_pylist(), dtype=object)
    codes = np.asarray(denc.indices.to_numpy(zero_copy_only=False))
    null_mask = np.asarray(arr.is_null())
    valid = ~null_mask if null_mask.any() else None
    if len(dict_vals) == 0:
        gdv = None if global_dict is None else global_dict.values
        return Column(np.full(len(codes), -1, np.int32), STRING, valid,
                      np.empty(0, dtype=object) if gdv is None else gdv,
                      global_dict)
    order = np.argsort(dict_vals.astype(str), kind="stable")
    sorted_dict = dict_vals[order]
    remap = np.empty(len(order), dtype=np.int32)
    remap[order] = np.arange(len(order), dtype=np.int32)
    if global_dict is not None:
        # remap local sorted positions into the frozen global code space
        gvals = global_dict.values.astype(str)
        pos = np.searchsorted(gvals, sorted_dict.astype(str))
        posc = np.clip(pos, 0, max(len(gvals) - 1, 0))
        hit = (gvals[posc] == sorted_dict.astype(str)) if len(gvals) else \
            np.zeros(len(sorted_dict), dtype=bool)
        if bool(hit.all()):
            remap = posc.astype(np.int32)[remap]
            sorted_dict = global_dict.values
        else:
            global_dict = None  # value outside the sidecar: local encode
    out = np.full(len(codes), -1, dtype=np.int32)
    ok = ~np.isnan(codes) if codes.dtype.kind == "f" else np.ones(
        len(codes), dtype=bool)
    if valid is not None:
        ok &= valid
    out[ok] = remap[codes[ok].astype(np.int64)]
    return Column(out, STRING, valid, sorted_dict, global_dict)


def from_arrow(at, schema: Optional[TableSchema] = None,
               gdicts: Optional[Dict[str, object]] = None) -> Table:
    """pyarrow.Table -> engine Table.

    Numeric/date columns map directly; decimals become scaled int64 using the
    schema's (p,s) (or the arrow type's scale); strings are dictionary-encoded
    with a sorted dictionary.  When a TableSchema is given, arrow columns are
    first coerced toward the declared types (csv/json round-trips).  When
    ``gdicts`` maps column names to io.gdict.GlobalDict, string columns are
    encoded against those frozen warehouse-wide dictionaries.
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    cols: Dict[str, Column] = {}
    for i, name in enumerate(at.column_names):
        arr = at.column(i)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        spec = schema.column(name) if schema is not None else None
        if spec is not None:
            arr = _coerce_to_spec(arr, spec.dtype)
        typ = arr.type
        if pa.types.is_dictionary(typ) and not pa.types.is_string(
                typ.value_type):
            arr = arr.cast(typ.value_type)
            typ = arr.type
        null_mask = np.asarray(arr.is_null())
        valid = ~null_mask if null_mask.any() else None
        if pa.types.is_decimal(typ):
            scale = typ.scale
            ints = pc.multiply(arr.cast(pa.float64()),
                               float(10 ** scale))
            data = np.nan_to_num(
                np.asarray(ints.to_numpy(zero_copy_only=False))).round()
            ctype = decimal(typ.precision, scale)
            cols[name] = Column(data.astype(np.int64), ctype, valid)
        elif pa.types.is_date(typ):
            data = np.nan_to_num(
                arr.cast(pa.int32()).to_numpy(zero_copy_only=False))
            cols[name] = Column(data.astype(np.int32), DATE, valid)
        elif pa.types.is_floating(typ):
            data = np.nan_to_num(arr.to_numpy(zero_copy_only=False))
            cols[name] = Column(data.astype(np.float64), FLOAT64, valid)
        elif pa.types.is_integer(typ):
            want = INT64 if (spec and spec.dtype.kind == "int64") or \
                pa.types.is_int64(typ) else INT32
            data = arr.to_numpy(zero_copy_only=False)
            data = np.where(null_mask, 0, data) if null_mask.any() else data
            cols[name] = Column(
                np.asarray(data, dtype=numpy_dtype(want)), want, valid)
        elif pa.types.is_boolean(typ):
            data = np.asarray(arr.to_numpy(zero_copy_only=False))
            data = np.where(null_mask, False, data) if null_mask.any() else data
            cols[name] = Column(data.astype(np.bool_), BOOL, valid)
        else:  # strings (incl. dictionary<string>)
            if pa.types.is_dictionary(typ):
                arr = arr.cast(typ.value_type)
            cols[name] = _encode_strings_arrow(
                arr, gdicts.get(name) if gdicts else None)
    return Table(cols)


def to_arrow(t: Table):
    """engine Table -> pyarrow.Table (for Parquet output / validation)."""
    import pyarrow as pa

    arrays, names = [], []
    for name, c in t.columns.items():
        v = c.validity()
        k = c.ctype.kind
        if k == "string":
            d = c.dictionary
            vals = [str(d[code]) if v[i] and code >= 0 else None
                    for i, code in enumerate(c.data)]
            arrays.append(pa.array(vals, type=pa.string()))
        elif k == "decimal":
            import decimal as pydec
            q = pydec.Decimal(1).scaleb(-c.ctype.scale)
            vals = [
                (pydec.Decimal(int(x)).scaleb(-c.ctype.scale)).quantize(q)
                if v[i] else None for i, x in enumerate(c.data)]
            arrays.append(pa.array(
                vals, type=pa.decimal128(max(c.ctype.precision, 1),
                                         c.ctype.scale)))
        elif k == "date":
            vals = [int(x) if v[i] else None for i, x in enumerate(c.data)]
            arrays.append(pa.array(vals, type=pa.date32()))
        else:
            vals = [c.data[i].item() if v[i] else None
                    for i in range(len(c.data))]
            pa_type = {"int32": pa.int32(), "int64": pa.int64(),
                       "float64": pa.float64(), "bool": pa.bool_()}[k]
            arrays.append(pa.array(vals, type=pa_type))
        names.append(name)
    return pa.table(arrays, names=names)
