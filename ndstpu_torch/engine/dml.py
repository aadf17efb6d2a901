"""Table edits on the device: what INSERT INTO appends and what DELETE
FROM keeps.

The JAX session edits a table with the numpy ``Table.concat`` and
``Table.filter`` (``ndstpu/engine/session.py`` ``_insert``, ``_delete``).
Here the target's columns stay where they are (on the card, a fact table
never crosses to the host): the inserted rows, a query's small result on
the host, are cast to the target's column types with ``JEval.cast``
(Spark's non-ANSI casts: a decimal out of the target's precision becomes
NULL, as the JAX package's ``expr.cast_column`` makes it) and appended on
the device, and a DELETE gathers the rows it keeps.  String columns whose
dictionaries differ are recoded into the union of the two, as
``Table.concat`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ndstpu_torch.engine.columnar import Column, Table, merge_dictionaries
from ndstpu_torch.engine.torchexec import JEval, to_device


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()    # a read-only array from pyarrow
    return torch.as_tensor(a).to(device)


def _recode(codes: torch.Tensor, old: np.ndarray,
            merged: np.ndarray) -> torch.Tensor:
    """String codes into ``merged``'s code space (NULL codes -1)."""
    if not len(old):
        return torch.full_like(codes, -1)
    pos = np.searchsorted(merged.astype(str), old.astype(str))
    mapping = torch.as_tensor(pos.astype(np.int32)).to(codes.device)
    return torch.where(codes >= 0, mapping[codes.clamp(min=0).long()],
                       torch.full_like(codes, -1))


def _same_dictionary(a: np.ndarray, b: np.ndarray) -> bool:
    return len(a) == len(b) and bool(np.array_equal(a, b))


def append(target: Table, rows: Table, device) -> Table:
    """``target`` with ``rows`` after it, each column of ``rows`` (by
    position) cast to the type of ``target``'s, on ``device``."""
    device = torch.device(device)
    n = rows.num_rows
    dt = to_device(rows, device)
    evl = JEval(dt)
    out = {}
    for (name, tcol), rcol in zip(target.columns.items(),
                                  dt.columns.values()):
        c = evl.cast(rcol, tcol.ctype)
        tdata = _tensor(tcol.data, device)
        data = c.data[:n].to(tdata.dtype)
        valid = c.valid[:n]
        dictionary = tcol.dictionary
        if tcol.ctype.kind == "string" and \
                not _same_dictionary(tcol.dictionary, c.dictionary):
            dictionary = merge_dictionaries([tcol, Column(
                data, tcol.ctype, None, c.dictionary)])
            tdata = _recode(tdata, tcol.dictionary, dictionary)
            data = _recode(data, c.dictionary, dictionary)
        tvalid = _tensor(tcol.valid, device)
        if tvalid is None and bool(valid.all()):
            both = None
        else:
            if tvalid is None:
                tvalid = torch.ones(tdata.shape[0], dtype=torch.bool,
                                    device=device)
            both = torch.cat([tvalid, valid])
        out[name] = Column(torch.cat([tdata, data]), tcol.ctype, both,
                           dictionary)
    return Table(out)


def keep(target: Table, mask: torch.Tensor) -> Table:
    """The rows of ``target`` where ``mask`` is true, gathered on the
    mask's device."""
    idx = torch.nonzero(mask).squeeze(1)
    out = {}
    for name, c in target.columns.items():
        valid = _tensor(c.valid, mask.device)
        out[name] = Column(_tensor(c.data, mask.device)[idx], c.ctype,
                           None if valid is None else valid[idx],
                           c.dictionary)
    return Table(out)


def on_device(t: Table, device) -> Table:
    """``t`` with every column on ``device``."""
    return Table({name: Column(_tensor(c.data, device), c.ctype,
                               _tensor(c.valid, device), c.dictionary)
                  for name, c in t.columns.items()})
