"""Data maintenance: the LF_* insert and DF_* delete refresh functions.

The port of the JAX package's ``ndstpu/harness/maintenance.py``::

    python -m ndstpu_torch.harness.maintenance <warehouse> <refresh data> \\
        <time log> [--dm_funcs LF_SS,DF_SS] [--json_summary_folder J]

registers the 12 refresh staging tables in the session's catalog, loads
the data-maintenance SQL (``data_maintenance/*.sql``, copies of the JAX
package's), substitutes DATE1/DATE2 from the generated delete-date
tables, runs each function's statements through
``ndstpu_torch.engine.session.Session.sql`` on ``cuda`` (``--device cpu``
for the tests) under a :class:`BenchReport`, and writes the reference's
time log: the header ``application_id,query,time/s``, one row a function
in milliseconds, then ``Data Maintenance Start Time``, ``End Time`` and
``Time`` in seconds.  A function that fails is recorded ``Failed`` and
the run goes on.  LF_CR, LF_SR and LF_WR fail in both packages with
``PlanError: non-equi left join unsupported`` (their ``left join time_dim
on t_time = 43200``), a limit of the reference engine the port keeps.

The inputs.  The warehouse is a directory read by the port's loader
(pyarrow), or ``-`` with ``--generate SF`` (``--generate_seed N``,
default 1), generated on the device as the power run's ``--generate``
does.  The refresh data is a folder of the generator's ``.dat`` files
(``python -m ndstpu.datagen.driver ... --update K``, read with
:mod:`ndstpu_torch.io.csvio`, pyarrow again), or ``-`` with ``--update K``,
refresh set K generated on the device at the warehouse's scale
(:func:`ndstpu_torch.datagen.generate_refresh`; needs ``--generate``).
The H100's machine has no pyarrow, so there both come from the
generators.  After each function the fact tables whose row counts it
changed are printed, and on the card the peak device memory at the end.

Left for later slices, and refused: ``--micro_batch`` (each function a
journaled micro-batch, which needs the ingest slice and a lake
warehouse); the pre-maintenance snapshot journal of ``rollback.py``,
which the JAX package keeps only for lake tables, waits for the lake
slice.
"""

from __future__ import annotations

import argparse
import csv
import os
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ndstpu_torch import obs
from ndstpu_torch import schema as nds_schema
from ndstpu_torch.engine import columnar, dml
from ndstpu_torch.engine.session import Session
from ndstpu_torch.engine.torchexec import resolve_device
from ndstpu_torch.harness.report import BenchReport
from ndstpu_torch.io import atomic

DM_DIR = Path(__file__).resolve().parent / "data_maintenance"

INSERT_FUNCS = ["LF_CR", "LF_CS", "LF_I", "LF_SR", "LF_SS", "LF_WR", "LF_WS"]
DELETE_FUNCS = ["DF_CS", "DF_SS", "DF_WS"]
INVENTORY_DELETE_FUNCS = ["DF_I"]
DM_FUNCS = INSERT_FUNCS + DELETE_FUNCS + INVENTORY_DELETE_FUNCS
# the tables the functions change
FACT_TABLES = ("store_sales", "store_returns", "catalog_sales",
               "catalog_returns", "web_sales", "web_returns", "inventory")


def register_staging_views(sess: Session, refresh_dir: str) -> None:
    """Load the s_* staging tables and the delete tables from a folder of
    ``.dat`` files into the catalog (TempView analog), on the session's
    device."""
    from ndstpu_torch.io import csvio
    schemas = nds_schema.get_maintenance_schemas(True)
    for table, tschema in schemas.items():
        at = csvio.read_table_dir(refresh_dir, table, tschema)
        sess.catalog.register(table, dml.on_device(
            columnar.from_arrow(at, tschema), sess.device))


def register_refresh(sess: Session, tables: Dict[str, columnar.Table]
                     ) -> None:
    """Register generated staging tables (``datagen.generate_refresh``)."""
    for name, table in tables.items():
        sess.catalog.register(name, table)


def get_delete_dates(sess: Session, table: str) -> List[tuple]:
    t = sess.catalog.get(table)
    d = t.to_pydict()
    return list(zip(d["date1"], d["date2"]))


def get_maintenance_queries(sess: Session,
                            funcs: List[str]) -> Dict[str, List[str]]:
    """{function: [statements]} with DATE1/DATE2 substituted per delete-date
    row (reference: nds_maintenance.py:118-144)."""
    out: Dict[str, List[str]] = {}
    for fn in funcs:
        text = (DM_DIR / f"{fn}.sql").read_text()
        if fn in DELETE_FUNCS or fn in INVENTORY_DELETE_FUNCS:
            dates = get_delete_dates(
                sess, "inventory_delete" if fn in INVENTORY_DELETE_FUNCS
                else "delete")
            stmts = []
            for d1, d2 in dates:
                sub = text.replace("DATE1", d1).replace("DATE2", d2)
                stmts += [s.strip() for s in sub.split(";") if s.strip()]
            out[fn] = stmts
        else:
            out[fn] = [s.strip() for s in text.split(";") if s.strip()]
    return out


def run_dm_query(sess: Session, statements: List[str]) -> None:
    for stmt in statements:
        sess.sql(stmt)


def fact_rows(sess: Session) -> Dict[str, int]:
    """Row counts of the fact tables the catalog holds."""
    return {t: sess.catalog.get(t).num_rows for t in FACT_TABLES
            if t in sess.catalog}


def _load(args, device) -> Session:
    """The session over the warehouse, with the staging tables
    registered."""
    if args.generate is None:
        from ndstpu_torch.io import loader
        catalog = loader.load_catalog(args.warehouse_path)
    else:
        from ndstpu_torch import datagen
        catalog = datagen.generate(args.generate, args.generate_seed,
                                   device)
    sess = Session(catalog, device=device)
    if args.update is None:
        register_staging_views(sess, args.refresh_data_path)
    else:
        from ndstpu_torch import datagen
        register_refresh(sess, datagen.generate_refresh(
            args.generate, args.update, args.generate_seed, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return sess


def run_query(args) -> None:
    app_id = f"ndstpu-dm-{uuid.uuid4().hex[:8]}"
    execution_times = []
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sess = _load(args, device)

    queries = get_maintenance_queries(sess, DM_FUNCS)
    if args.dm_funcs:
        keep = args.dm_funcs.split(",")
        missing = [f for f in keep if f not in queries]
        if missing:
            raise ValueError(f"unknown DM functions {missing}")
        queries = {f: queries[f] for f in keep}

    start = time.time()
    for fn, stmts in queries.items():
        print(f"====== Run {fn} ======")
        rpt = BenchReport({"warehouse": args.warehouse_path,
                           "device": str(device)})
        before = fact_rows(sess)
        summary = rpt.report_on(run_dm_query, sess, stmts, query_name=fn)
        print(f"Time taken: {summary['queryTimes']} millis for {fn}")
        after = fact_rows(sess)
        changed = {t: [before[t], after[t]] for t in after
                   if before.get(t) != after[t]}
        print(f"Rows of {fn}: {changed}")
        execution_times.append((app_id, fn, summary["queryTimes"][0]))
        if args.json_summary_folder:
            os.makedirs(args.json_summary_folder, exist_ok=True)
            rpt.write_summary(
                fn, prefix=os.path.join(args.json_summary_folder, ""))
    end = time.time()
    dm_elapse = end - start  # seconds, reference contract
    print(f"====== Data Maintenance Time: {dm_elapse} s ======")
    if device.type == "cuda":
        print(f"====== Peak device memory: "
              f"{torch.cuda.max_memory_allocated(device)} bytes ======")
    execution_times.append((app_id, "Data Maintenance Start Time", start))
    execution_times.append((app_id, "Data Maintenance End Time", end))
    execution_times.append((app_id, "Data Maintenance Time", dm_elapse))

    # header matches the reference (nds_maintenance.py:261); per-function
    # rows carry the report's millisecond values like the reference does
    header = ["application_id", "query", "time/s"]
    with atomic.atomic_writer(args.time_log, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(execution_times)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="NDS data maintenance (the PyTorch/CUDA port)")
    p.add_argument("warehouse_path",
                   help="warehouse directory, or - with --generate")
    p.add_argument("refresh_data_path",
                   help="raw refresh (update) data directory, or - with "
                        "--update")
    p.add_argument("time_log", help="CSV time log output path")
    p.add_argument("--dm_funcs",
                   help="comma-separated subset of DM functions, e.g. "
                        "LF_SS,DF_SS")
    p.add_argument("--micro_batch", action="store_true",
                   help="not ported yet: needs the ingest slice and a "
                        "lake warehouse")
    p.add_argument("--json_summary_folder")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (default cuda; "
                        "cpu for the tests)")
    p.add_argument("--generate", type=float, metavar="SF",
                   help="generate the warehouse on the device at this "
                        "scale factor instead of reading one "
                        "(warehouse_path must be -)")
    p.add_argument("--generate_seed", type=int, default=1, metavar="N",
                   help="the generators' seed (default 1)")
    p.add_argument("--update", type=int, metavar="K",
                   help="generate refresh set K on the device at the "
                        "--generate scale (refresh_data_path must be -)")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.micro_batch:
        p.error("--micro_batch is not ported yet: it waits for the ingest "
                "slice (harness/ingest.py) and a lake warehouse")
    if (args.generate is None) == (args.warehouse_path == "-"):
        p.error("give a warehouse directory, or - with --generate SF")
    if (args.update is None) == (args.refresh_data_path == "-"):
        p.error("give a refresh data directory, or - with --update K")
    if args.update is not None and args.generate is None:
        p.error("--update generates the refresh set at the --generate "
                "scale: give --generate SF")
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    # a run's spans and counters start from nothing
    obs.reset()
    run_query(args)


if __name__ == "__main__":
    main()
