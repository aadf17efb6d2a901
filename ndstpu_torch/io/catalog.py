"""Table catalog: named engine tables plus per-table key metadata.

Copied from ``ndstpu.io.loader`` (``Catalog``, ``TableMeta`` and the
primary-key convention) without the Parquet/ORC reader, which is a later
slice of the port.  Column data may be host numpy arrays or torch tensors
that already live on the device (``ndstpu_torch.datagen``), so the dense-key
check runs on whichever device holds the key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ndstpu_torch.engine import columnar


@dataclass
class TableMeta:
    name: str
    num_rows: int
    # primary key column with dense values pk_min..pk_min+N-1, if detected
    dense_key: Optional[str] = None
    dense_min: int = 0


@dataclass
class Catalog:
    """Named engine tables + metadata, the engine's table registry."""

    tables: Dict[str, columnar.Table] = field(default_factory=dict)
    meta: Dict[str, TableMeta] = field(default_factory=dict)
    # per-table monotonic version, bumped on every (re)register — the
    # invalidation key for device-resident caches (id() reuse is not sound)
    versions: Dict[str, int] = field(default_factory=dict)

    def register(self, name: str, table: columnar.Table) -> None:
        self.tables[name] = table
        self.meta[name] = TableMeta(name, table.num_rows)
        self.versions[name] = self.versions.get(name, 0) + 1
        key = _primary_key_column(name, table)
        if key is not None:
            col = table.column(key)
            if col.valid is None and len(col.data):
                data = col.data
                lo = int(data.min())
                hi = int(data.max())
                if hi - lo + 1 == len(data) and _is_permutation(data, lo, hi):
                    self.meta[name].dense_key = key
                    self.meta[name].dense_min = lo

    def unregister(self, name: str) -> None:
        self.tables.pop(name, None)
        self.meta.pop(name, None)
        self.versions[name] = self.versions.get(name, 0) + 1

    def get(self, name: str) -> columnar.Table:
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables


def _is_permutation(data, lo: int, hi: int) -> bool:
    data = torch.as_tensor(data)
    seen = torch.zeros(hi - lo + 1, dtype=torch.bool, device=data.device)
    seen[data.long() - lo] = True
    return bool(seen.all())


_PK_OVERRIDES = {
    "date_dim": "d_date_sk",
    "time_dim": "t_time_sk",
}


def _primary_key_column(name: str, table: columnar.Table) -> Optional[str]:
    if name in _PK_OVERRIDES:
        return _PK_OVERRIDES[name]
    # convention: first column ending in _sk is the surrogate PK
    first = table.column_names[0] if table.column_names else None
    if first and first.endswith("_sk"):
        return first
    return None
