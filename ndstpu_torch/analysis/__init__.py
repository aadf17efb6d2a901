"""Static plan analysis: the port's copy of what it uses of
``ndstpu.analysis`` — plan canonicalization (:mod:`.canon`) and its
diagnostics (:mod:`.diagnostics`), over the schema of
:mod:`ndstpu_torch.schema`.  No data is read and nothing runs on a
device."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ndstpu_torch import schema as nds_schema
from ndstpu_torch.engine import columnar


def schema_tables(use_decimal: bool = True) -> Dict[str, object]:
    """All table schemas (source + maintenance views' bases) by name."""
    tables = dict(nds_schema.get_schemas(use_decimal=use_decimal))
    tables.update(nds_schema.get_maintenance_schemas(
        use_decimal=use_decimal))
    return tables


def schema_catalog(use_decimal: bool = True):
    """Zero-row engine catalog over the full TPC-DS schema — enough for
    ``Session.plan()`` (parse → plan → optimize) without any warehouse."""
    from ndstpu_torch.io.catalog import Catalog

    cat = Catalog()
    for name, ts in schema_tables(use_decimal=use_decimal).items():
        cols = {}
        for spec in ts.columns:
            dt = columnar.numpy_dtype(spec.dtype)
            cols[spec.name] = columnar.Column(
                np.empty(0, dtype=dt), spec.dtype,
                valid=None,
                dictionary=(np.empty(0, dtype=object)
                            if spec.dtype.kind == "string" else None))
        cat.register(name, columnar.Table(cols))
    return cat
