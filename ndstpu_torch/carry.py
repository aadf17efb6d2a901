"""Carry a warehouse across from plain values into the port's tables.

A column is passed as plain values, exactly what a host column holds:
``(data, (kind, precision, scale), valid, dictionary)`` — the numpy data,
the type, the validity mask (None when every row is present) and the
sorted string dictionary (None for non-strings).  Nothing of the JAX
package is needed to call these, so a test can hand the port the same
warehouse the JAX package reads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ndstpu_torch.engine.columnar import Column, Table, numpy_dtype
from ndstpu_torch.io.catalog import Catalog
from ndstpu_torch.schema import DType

ColumnValues = Tuple[np.ndarray, Tuple[str, int, int], Optional[np.ndarray],
                     Optional[np.ndarray]]


def table_from_numpy(columns: Dict[str, ColumnValues]) -> Table:
    """Build the port's host :class:`Table` from per-column plain values
    (see the module note), in the given column order."""
    out = {}
    for name, (data, (kind, precision, scale), valid, dictionary) in \
            columns.items():
        ctype = DType(kind, precision=precision, scale=scale)
        # copies: the port's tables own their arrays
        out[name] = Column(
            np.array(data, dtype=numpy_dtype(ctype)), ctype,
            None if valid is None else np.array(valid, dtype=bool),
            None if dictionary is None else np.asarray(dictionary,
                                                       dtype=object))
    return Table(out)


def catalog_from_numpy(tables: Dict[str, Dict[str, ColumnValues]]
                       ) -> Catalog:
    """A :class:`Catalog` of :func:`table_from_numpy` tables."""
    cat = Catalog()
    for name, columns in tables.items():
        cat.register(name, table_from_numpy(columns))
    return cat
