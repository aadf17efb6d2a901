"""Warehouse loader: a transcoded warehouse's files -> the port's Catalog.

The readers of the JAX package's ``ndstpu/io/loader.py`` (:111-225):
``read_warehouse_table`` for single Parquet files, hive-partitioned
Parquet datasets and ORC, CSV and JSON files, each through the library
that module uses (pyarrow, and pandas for JSON), imported when a table is
read; ``_postprocess_partition_dtypes``; and ``load_catalog``, which
decodes each table with ``columnar.from_arrow`` into host columns and
registers it in :class:`ndstpu_torch.io.catalog.Catalog` (the executor
uploads a table to the device at its first scan).

What waits for later slices of the port, and raises here: the ACID lake
layouts (``ndslake``, ``ndsdelta``), Avro files, and the global string
dictionaries' sidecars (tables decode with per-table sorted
dictionaries, which order and compare strings as the sidecars' do).

Without pyarrow nothing here can read a file, and a read raises naming
the missing package.  The H100's machine has no pyarrow: there the power
run's load phase generates the warehouse on the card instead
(``python -m ndstpu_torch.harness.power ... --generate SF``).
"""

from __future__ import annotations

import glob
import os
import time
from typing import List, Optional

from ndstpu_torch import obs
from ndstpu_torch import schema as nds_schema
from ndstpu_torch.engine import columnar
from ndstpu_torch.io.catalog import Catalog

# the directory markers of the ACID table layouts (ndstpu/io/acid.py,
# ndstpu/io/deltalog.py)
_LAKE_MARKERS = ("_ndslake", "_delta_log")


def _pyarrow():
    """The pyarrow module; raises naming the package when it is absent."""
    try:
        import pyarrow
    except ImportError as e:
        raise ModuleNotFoundError(
            "reading a warehouse's files needs pyarrow, which is not "
            "installed; generate the warehouse instead "
            "(power --generate SF)") from e
    return pyarrow


def read_warehouse_table(warehouse: str, table: str,
                         columns: Optional[List[str]] = None):
    """Read one table of a transcoded warehouse as a ``pyarrow.Table``."""
    pa = _pyarrow()
    root = os.path.join(warehouse, table)
    if any(os.path.isdir(os.path.join(root, m)) for m in _LAKE_MARKERS):
        raise NotImplementedError(
            f"{root} is an ACID lake table; the port does not read the lake "
            f"layouts yet")
    singles = sorted(glob.glob(os.path.join(root, f"{table}*.parquet")))
    if singles:
        import pyarrow.parquet as pq
        parts = [pq.read_table(p, columns=columns) for p in singles]
        return pa.concat_tables(parts) if len(parts) > 1 else parts[0]
    if glob.glob(os.path.join(root, f"{table}*.avro")):
        raise NotImplementedError(
            f"{root} holds Avro files; the port does not read Avro yet")
    for ext in ("orc", "csv", "json"):
        paths = sorted(glob.glob(os.path.join(root, f"{table}*.{ext}")))
        if paths:
            parts = []
            for p in paths:
                if ext == "orc":
                    import pyarrow.orc as paorc
                    parts.append(paorc.read_table(p))
                elif ext == "csv":
                    import pyarrow.csv as pacsv
                    parts.append(pacsv.read_csv(
                        p, convert_options=pacsv.ConvertOptions(
                            strings_can_be_null=True)))
                else:
                    import pandas as pd
                    parts.append(
                        pa.Table.from_pandas(pd.read_json(p, lines=True)))
            t = pa.concat_tables(parts) if len(parts) > 1 else parts[0]
            return t.select(columns) if columns else t
    if os.path.isdir(root):
        # hive-partitioned parquet dataset
        import pyarrow.dataset as pads
        dset = pads.dataset(root, format="parquet", partitioning="hive")
        return dset.to_table(columns=columns)
    raise FileNotFoundError(f"table {table} not found under {warehouse}")


def _postprocess_partition_dtypes(table: str, at):
    """Hive partition keys come back as inferred ints; restore int32 for the
    *_date_sk partition columns so schemas round-trip."""
    pa = _pyarrow()
    part_col = nds_schema.TABLE_PARTITIONING.get(table)
    if part_col and part_col in at.column_names:
        idx = at.column_names.index(part_col)
        col = at.column(idx)
        if not pa.types.is_int32(col.type):
            at = at.set_column(idx, part_col, col.cast(pa.int32()))
    return at


def load_catalog(warehouse: str, tables: Optional[List[str]] = None,
                 max_workers: Optional[int] = None) -> Catalog:
    """Load a transcoded warehouse into a catalog, with the decimal
    schemas.

    Per-table scan (pyarrow file reads) and decode (``from_arrow``
    dictionary encoding / decimal scaling) run on a bounded worker
    pool — both release the GIL, so tables load concurrently.
    ``max_workers`` defaults to ``NDSTPU_IO_WORKERS`` or 4; 1 restores
    the serial path.  Registration order stays the caller's table
    order regardless of completion order.
    """
    _pyarrow()
    if tables is None:
        tables = [t for t in nds_schema.SOURCE_TABLE_NAMES
                  if os.path.isdir(os.path.join(warehouse, t))]
    schemas = {**nds_schema.get_schemas(True),
               **nds_schema.get_maintenance_schemas(True)}

    def load_one(t: str) -> columnar.Table:
        at = read_warehouse_table(warehouse, t)
        at = _postprocess_partition_dtypes(t, at)
        sch = schemas.get(t)
        if sch is not None:
            # restore declared column order (partitioned reads reorder)
            order = [c.name for c in sch.columns
                     if c.name in at.column_names]
            at = at.select(order)
        table = columnar.from_arrow(at, sch)
        # arrow hands out read-only views, which torch warns about (once
        # a process, so inside whichever query first uploads a table)
        for c in table.columns.values():
            if not c.data.flags.writeable:
                c.data = c.data.copy()
        return table

    if max_workers is None:
        max_workers = int(os.environ.get("NDSTPU_IO_WORKERS", "4"))
    cat = Catalog()
    with obs.span("load_catalog", cat="io", n_tables=len(tables),
                  workers=max_workers):
        if max_workers <= 1 or len(tables) <= 1:
            for t in tables:
                cat.register(t, load_one(t))
            return cat
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=min(max_workers, len(tables)),
                thread_name_prefix="ndstpu-io") as pool:
            futs = {t: pool.submit(load_one, t) for t in tables}
            for t in tables:
                t0 = time.monotonic()
                done = futs[t].done()
                table = futs[t].result()
                if not done:
                    obs.inc("io.scan.wait_s", time.monotonic() - t0)
                cat.register(t, table)
    return cat
