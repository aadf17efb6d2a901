"""Pipe-delimited CSV ingest with explicit schemas.

A copy of the JAX package's ``ndstpu/io/csvio.py``, with pyarrow imported
when a file is read (the H100's machine has no pyarrow, and every module
of the port imports there).  Reads the native generator's `.dat` chunk
files (dsdgen wire format: '|' separators, trailing '|', empty field ==
NULL) into pyarrow Tables using the ndstpu_torch.schema table specs — the
analog of the reference's schema'd ``spark.read.csv``
(nds_transcode.py:56-58).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

from ndstpu_torch.schema import TableSchema

_TRAILING = "__trailing__"


def arrow_type(dtype):
    """The pyarrow type of a schema type."""
    import pyarrow as pa
    k = dtype.kind
    if k == "int32":
        return pa.int32()
    if k == "int64":
        return pa.int64()
    if k == "float64":
        return pa.float64()
    if k == "decimal":
        return pa.decimal128(max(dtype.precision, dtype.scale + 1),
                             dtype.scale)
    if k == "date":
        return pa.date32()
    if k == "string":
        return pa.string()
    if k == "bool":
        return pa.bool_()
    raise ValueError(f"no arrow type for {dtype}")


def arrow_schema(schema: TableSchema):
    import pyarrow as pa
    return pa.schema([pa.field(c.name, arrow_type(c.dtype), c.nullable)
                      for c in schema.columns])


def read_dat_file(path: str, schema: TableSchema):
    import pyarrow as pa
    import pyarrow.csv as pacsv
    names = [c.name for c in schema.columns] + [_TRAILING]
    types = {c.name: arrow_type(c.dtype) for c in schema.columns}
    types[_TRAILING] = pa.string()
    table = pacsv.read_csv(
        path,
        read_options=pacsv.ReadOptions(column_names=names),
        parse_options=pacsv.ParseOptions(delimiter="|"),
        convert_options=pacsv.ConvertOptions(
            column_types=types, null_values=[""], strings_can_be_null=True),
    )
    return table.drop_columns([_TRAILING])


def read_table_dir(data_dir: str, table: str, schema: TableSchema,
                   pattern: Optional[str] = None):
    """Read all chunk files of one table (directory of `.dat` chunks, or a
    single `{table}_*.dat` next to the dir — both layouts the driver
    produces)."""
    tdir = os.path.join(data_dir, table)
    if os.path.isdir(tdir):
        files = sorted(glob.glob(os.path.join(tdir, pattern or "*.dat")))
    else:
        # flat layout: chunk names are {table}_{child}_{parallel}.dat; the
        # [0-9] requirement keeps e.g. "customer" from matching
        # customer_address_1_1.dat
        files = sorted(glob.glob(os.path.join(data_dir,
                                              f"{table}_[0-9]*.dat")))
    if not files:
        raise FileNotFoundError(f"no .dat files for table {table} under "
                                f"{data_dir}")
    import pyarrow as pa
    parts: List = [read_dat_file(f, schema) for f in files]
    return pa.concat_tables(parts) if len(parts) > 1 else parts[0]
