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

The streaming scan of the out-of-core executor lives here too, as in the
JAX package: :class:`ChunkSource` and :class:`TableChunkSource` (row
ranges of a table in host memory or on the device), the read-ahead
:class:`ChunkScanPool` and :func:`attach_stream_source`, with the
``io.read`` fault site and the ``io.scan.*`` counters.
``ParquetChunkSource`` and ``LakeChunkSource`` wait for the file slices
(they read through pyarrow).
"""

from __future__ import annotations

import glob
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Streaming out-of-core scan: chunk sources + read-ahead decode pool
# (ndstpu/io/loader.py:228-318, :590-760)
# ---------------------------------------------------------------------------


class StreamUnsupported(RuntimeError):
    """A table/column shape the streaming scan cannot serve (the caller
    falls back to the resident path, never wedges)."""


def _string_stream_reject(table: str, col: str) -> StreamUnsupported:
    """Why a string column cannot stream, naming the knob that changes
    the answer: streaming strings needs one code space for every chunk,
    which the table's one dictionary (or, in a transcoded warehouse, its
    frozen global dictionary) gives."""
    from ndstpu_torch.io import gdict
    if not gdict.enabled():
        why = ("global dictionaries are disabled "
               "(NDSTPU_GLOBAL_DICTS=0)")
    else:
        why = ("the source decodes each chunk with a dictionary of its "
               "own")
    return StreamUnsupported(
        f"string column {col} of {table}: per-chunk dictionaries do not "
        f"share a code space, and {why}")


#: one decoded chunk: column name -> (data, validity or None = all
#: valid), exactly ``count`` rows each, host arrays or tensors
ChunkPayload = Dict[str, Tuple[object, object]]


class ChunkSource:
    """Row-range reads of a table's column subset in the engine's layout.
    Implementations must be thread-safe for concurrent ``read`` calls
    (the scan pool issues them from worker threads)."""

    num_rows: int = 0
    table: str = ""
    columns: Sequence[str] = ()

    def column_meta(self) -> Dict[str, tuple]:
        """name -> (ctype, dtype, dictionary-or-None), the static
        metadata the spine needs without touching row data."""
        raise NotImplementedError

    def read(self, start: int, count: int) -> ChunkPayload:
        raise NotImplementedError


class TableChunkSource(ChunkSource):
    """Scan source over a resident :class:`columnar.Table` (in host
    memory, or on the device) — a read is a slice, with no copy.  The
    default source when no out-of-core stream is registered: the same
    pipeline (scan pool -> staging ring -> device) runs over it, so the
    streaming path has one shape wherever the rows live."""

    def __init__(self, table: columnar.Table, name: str,
                 columns: Sequence[str]):
        self._t = table
        self.table = name
        self._cols = self.columns = list(columns)
        self.num_rows = table.num_rows

    def column_meta(self) -> Dict[str, tuple]:
        return {n: (self._t.column(n).ctype, self._t.column(n).data.dtype,
                    self._t.column(n).dictionary) for n in self._cols}

    def read(self, start: int, count: int) -> ChunkPayload:
        from ndstpu_torch import faults
        faults.check("io.read", key=f"{self.table}@{start}")
        out: ChunkPayload = {}
        nbytes = 0
        for n in self._cols:
            c = self._t.column(n)
            data = c.data[start:start + count]
            valid = None if c.valid is None else \
                c.valid[start:start + count]
            nbytes += _nbytes(data) + (_nbytes(valid) if valid is not None
                                       else 0)
            out[n] = (data, valid)
        obs.inc("io.scan.bytes", nbytes)
        return out


def _nbytes(a) -> int:
    if hasattr(a, "element_size"):
        return int(a.numel() * a.element_size())
    return int(a.nbytes)


class ChunkScanPool:
    """Bounded read-ahead scan/decode pool in front of the executor.

    Workers read the next ``depth`` chunks (in consumption order) while
    the executor computes on the current one; ``get`` blocks only when
    the pipeline is behind, and that block time is ``io.scan.wait_s``.
    A failing worker read degrades the pool to synchronous reads
    (``io.scan.degraded``) instead of wedging the run — the ``io.read``
    fault site fires inside ``ChunkSource.read``.  A per-chunk
    :class:`ndstpu_torch.engine.latch.KeyedLatch` keeps a synchronous
    read and a late worker from reading the same chunk twice.
    """

    def __init__(self, read_fn: Callable[[int], ChunkPayload],
                 starts: Sequence[int], workers: int = 2,
                 depth: int = 2):
        import threading

        from ndstpu_torch.engine.latch import KeyedLatch
        self._read = read_fn
        self._starts = list(starts)
        self._depth = max(int(depth), 0)
        self._workers = max(int(workers), 1)
        self._futs: Dict[int, object] = {}
        self._next = 0          # index into _starts not yet scheduled
        self._pool = None
        self._degraded = False
        self._latch = KeyedLatch()
        # get() is called from the executor and the staging thread, so
        # the scheduling bookkeeping must not race
        self._sched_lock = threading.Lock()

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers,
                thread_name_prefix="ndstpu-scan")
        return self._pool

    def _guarded_read(self, start: int) -> ChunkPayload:
        with self._latch.holding(start):
            return self._read(start)

    def start_ahead(self) -> None:
        """Start the read-ahead window before the first ``get``."""
        self._schedule_ahead(-1)

    def reset(self, next_idx: int = 0) -> None:
        """Rewind the read-ahead window for another pass over the same
        chunk sequence (a cached chunked query run again).  A degraded
        pool stays degraded — the source already failed."""
        with self._sched_lock:
            for fut in self._futs.values():
                fut.cancel()
            self._futs.clear()
            self._next = max(int(next_idx), 0)
        self._schedule_ahead(next_idx - 1)

    def _schedule_ahead(self, upto_idx: int) -> None:
        if self._degraded or self._depth == 0:
            return
        with self._sched_lock:
            limit = min(upto_idx + 1 + self._depth, len(self._starts))
            while self._next < limit:
                s = self._starts[self._next]
                self._futs[s] = self._ensure_pool().submit(
                    self._guarded_read, s)
                self._next += 1

    @staticmethod
    def _wait_counter() -> str:
        """Scan blocking on the staging thread is latency the ring
        absorbs, not executor stall: it counts apart."""
        import threading
        if threading.current_thread().name.startswith("ndstpu-h2d"):
            return "io.scan.wait_bg_s"
        return "io.scan.wait_s"

    def get(self, start: int) -> ChunkPayload:
        try:
            idx = self._starts.index(start)
            with self._sched_lock:
                self._next = max(self._next, idx)
            self._schedule_ahead(idx)
        except ValueError:
            idx = None   # off-schedule read: serve synchronously
        with self._sched_lock:
            fut = self._futs.pop(start, None)
        if fut is not None:
            obs.inc("io.scan.ahead.hit" if fut.done()
                    else "io.scan.ahead.miss")
            t0 = time.monotonic()
            try:
                payload = fut.result()
                obs.inc(self._wait_counter(), time.monotonic() - t0)
                if idx is not None:
                    self._schedule_ahead(idx + 1)
                return payload
            except Exception as e:  # noqa: BLE001 — degrade, don't wedge
                self._degrade(e)
        else:
            obs.inc("io.scan.ahead.miss")
        t0 = time.monotonic()
        try:
            return self._guarded_read(start)
        finally:
            obs.inc(self._wait_counter(), time.monotonic() - t0)

    def _degrade(self, exc: Exception) -> None:
        if not self._degraded:
            self._degraded = True
            obs.inc("io.scan.degraded")
            obs.annotate(io_scan_degraded=f"{type(exc).__name__}: {exc}")
        with self._sched_lock:
            for fut in self._futs.values():
                fut.cancel()
            self._futs.clear()

    def close(self) -> None:
        with self._sched_lock:
            for fut in self._futs.values():
                fut.cancel()
            self._futs.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


def attach_stream_source(catalog: Catalog, name: str,
                         source: ChunkSource) -> None:
    """Register an out-of-core scan source for a catalog table.  The
    chunked executor streams this table's rows from the source; every
    other path keeps using the resident copy."""
    import numpy as np
    if name not in catalog.tables:
        raise KeyError(f"table {name} not in catalog")
    if source.num_rows != catalog.get(name).num_rows:
        raise ValueError(
            f"stream source rows ({source.num_rows}) != resident rows "
            f"({catalog.get(name).num_rows}) for {name}")
    # string chunks must decode into the resident code space: the spine
    # takes the resident dictionary as its column's metadata
    resident = catalog.get(name)
    for col, (ct, _dt, d) in source.column_meta().items():
        if ct.kind != "string" or col not in resident.columns:
            continue
        rd = resident.column(col).dictionary
        if d is None or rd is None or not np.array_equal(
                np.asarray(d, dtype=object), np.asarray(rd, dtype=object)):
            raise ValueError(
                f"stream source dictionary for {name}.{col} does not "
                f"match the resident dictionary — codes would disagree "
                f"across chunks")
    catalog.streams[name] = source
