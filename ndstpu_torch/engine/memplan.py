"""Spill-aware streaming memory planner (``ndstpu.engine.memplan``).

Sizes the out-of-core scan (``chunk_rows``) and the H2D prefetch depth
from what the hardware actually reports instead of a hand-tuned
constant: the per-device memory budget (``torch.cuda.mem_get_info`` on
a card, ``NDSTPU_HBM_BYTES`` override, a conservative default otherwise)
divided by the plan's scanned row width (the same per-column byte widths the plan-lint schema analysis uses — data
itemsize + one validity byte per column + one alive byte per row).

The working-set model is deliberately simple and explicit::

    per-device bytes  =  chunk_bytes * (COMPUTE_MULT + depth + 1)

``COMPUTE_MULT`` covers the traced spine's intermediates (sort keys,
gather indices, segment buffers — empirically < 6x the resident chunk
for the corpus aggregates), ``depth + 1`` covers the resident chunk
plus the staged prefetch ring.  When even the whole fact fits under the
budget the planner returns ``chunk_rows=None`` (stay whole-fact
resident); otherwise it picks the largest power-of-two chunk that
fits (stable shapes -> stable compile cache keys) and the deepest
prefetch ring that still fits, capped at ``max_depth``.

The port's spine cache (:mod:`ndstpu_torch.engine.spine`) takes its
budget from :func:`device_budget_bytes`; the out-of-core scan that sizes
chunks with :func:`plan_stream` is a later slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

#: fallback per-device budget when the platform reports no memory stats
#: (the CPU) and no NDSTPU_HBM_BYTES override is set
DEFAULT_BUDGET_BYTES = 2 << 30

#: fraction of the reported budget the planner is allowed to commit
SAFETY = 0.5

#: working-set multiplier for traced-spine intermediates over one
#: resident chunk (sort keys, gathers, segment buffers)
COMPUTE_MULT = 6

#: smallest chunk worth compiling a streaming program for
MIN_CHUNK_ROWS = 4096

#: modeled device working set of one admitted serve query when the
#: caller has nothing better (override: NDSTPU_SERVE_QUERY_BYTES) —
#: sized for the tiny-corpus serve tier; real fleets pass the fact's
#: schema_row_bytes * chunk estimate instead
DEFAULT_QUERY_WORKING_SET_BYTES = 64 << 20

#: admission depth clamps: at least one query must always be
#: admittable, and no memory model justifies queueing thousands
ADMISSION_MIN_DEPTH = 1
ADMISSION_MAX_DEPTH = 256

#: deepest staging ring the planner will ask for
DEFAULT_MAX_DEPTH = 2


@dataclass(frozen=True)
class StreamPlan:
    """One planned streaming configuration for a (fact, mesh) pair."""

    chunk_rows: Optional[int]    # None = whole fact fits resident
    prefetch_depth: int
    bytes_per_row: int
    budget_bytes: int
    budget_source: str           # mem_get_info | env | default

    def describe(self) -> str:
        mode = ("resident" if self.chunk_rows is None
                else f"chunk_rows={self.chunk_rows}"
                     f" depth={self.prefetch_depth}")
        return (f"{mode} row_bytes={self.bytes_per_row} "
                f"budget={self.budget_bytes >> 20}MiB"
                f"({self.budget_source})")


def row_bytes(itemsizes: Iterable[int]) -> int:
    """Scanned row width: per-column data itemsize + 1 validity byte
    each, + 1 alive byte per row (the streaming arg layout)."""
    sizes = list(itemsizes)
    return sum(s + 1 for s in sizes) + 1


def schema_row_bytes(schema, columns: Optional[Iterable[str]] = None
                     ) -> int:
    """Row width from a declared :class:`ndstpu_torch.schema.TableSchema`
    (what plan-lint sees before any data is loaded).  String columns
    count their int32 dictionary-code width — the form the device
    streams — not the encoded text."""
    import numpy as np

    from ndstpu_torch.engine import columnar
    want = set(columns) if columns is not None else None
    sizes = [np.dtype(columnar.numpy_dtype(c.dtype)).itemsize
             for c in schema.columns
             if want is None or c.name in want]
    return row_bytes(sizes)


def device_budget_bytes(device=None) -> Tuple[int, str]:
    """Per-device byte budget and where it came from.

    ``NDSTPU_HBM_BYTES`` wins (operator pin / tests); then, on a CUDA
    device (``device``, or the current one when CUDA is available), its
    free memory as ``torch.cuda.mem_get_info`` reports it (the card's
    memory less live allocations); then :data:`DEFAULT_BUDGET_BYTES` (the
    CPU).
    """
    env = os.environ.get("NDSTPU_HBM_BYTES")
    if env:
        return max(int(env), 1), "env"
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return DEFAULT_BUDGET_BYTES, "default"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return DEFAULT_BUDGET_BYTES, "default"
    free = int(torch.cuda.mem_get_info(device)[0])
    if free > 0:
        return free, "mem_get_info"
    return DEFAULT_BUDGET_BYTES, "default"


def admission_budget(bytes_per_query: Optional[int] = None,
                     budget_bytes: Optional[int] = None,
                     budget_source: str = "caller",
                     min_depth: int = ADMISSION_MIN_DEPTH,
                     max_depth: int = ADMISSION_MAX_DEPTH) -> dict:
    """Admission budget query for the serve layer: how many
    concurrently-admitted queries the device-memory model supports.

    The same ``SAFETY``-discounted per-device budget that sizes
    streaming chunks is divided by the modeled per-query working set
    (``bytes_per_query``; default :data:`DEFAULT_QUERY_WORKING_SET_BYTES`
    or the ``NDSTPU_SERVE_QUERY_BYTES`` override) and clamped to
    ``[min_depth, max_depth]``.  A clamped ``NDSTPU_HBM_BYTES`` thus
    shrinks the serve queue directly: a memory-starved replica sheds
    (``Overloaded``) instead of queueing work it cannot hold.
    """
    if budget_bytes is None:
        budget_bytes, budget_source = device_budget_bytes()
    if bytes_per_query is None:
        env = os.environ.get("NDSTPU_SERVE_QUERY_BYTES")
        bytes_per_query = (max(int(env), 1) if env
                           else DEFAULT_QUERY_WORKING_SET_BYTES)
    usable = max(int(budget_bytes * SAFETY), 1)
    depth = usable // max(int(bytes_per_query), 1)
    depth = max(int(min_depth), min(int(depth), int(max_depth)))
    return {"depth": depth,
            "budget_bytes": int(budget_bytes),
            "budget_source": budget_source,
            "bytes_per_query": int(bytes_per_query),
            "usable_bytes": usable}


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def plan_stream(n_rows: int, bytes_per_row: int, n_dev: int,
                budget_bytes: Optional[int] = None,
                budget_source: str = "caller",
                max_depth: int = DEFAULT_MAX_DEPTH,
                dict_bytes: int = 0,
                resident_bytes: int = 0) -> StreamPlan:
    """Size ``chunk_rows`` (total across the mesh) and the prefetch
    depth for streaming ``n_rows`` of ``bytes_per_row`` over ``n_dev``
    devices under the per-device budget.

    ``dict_bytes`` is the resident footprint of the scanned string
    columns' frozen global dictionaries (codes stream per chunk, but
    the dictionary itself is a whole-query constant on every device),
    carved out of the usable budget before chunks are sized.

    ``resident_bytes`` is the predicted whole-query working set pinned
    on every device beyond the streamed chunk itself — today the
    broadcast-join build sides the cost advisor placed resident
    (analysis/cost.py) — carved out the same way, so a query with fat
    replicated builds streams in smaller chunks instead of spilling.
    """
    if budget_bytes is None:
        budget_bytes, budget_source = device_budget_bytes()
    usable = max(int(budget_bytes * SAFETY) - max(int(dict_bytes), 0)
                 - max(int(resident_bytes), 0), 1)
    bytes_per_row = max(bytes_per_row, 1)
    shard_rows = -(-max(n_rows, 1) // max(n_dev, 1))
    if shard_rows * bytes_per_row * COMPUTE_MULT <= usable:
        return StreamPlan(None, 0, bytes_per_row, budget_bytes,
                          budget_source)
    depth = max(int(max_depth), 0)
    while True:
        per_dev_chunk = usable // (COMPUTE_MULT + depth + 1)
        chunk_dev_rows = per_dev_chunk // bytes_per_row
        if chunk_dev_rows * n_dev >= MIN_CHUNK_ROWS or depth == 0:
            break
        depth -= 1   # spill-aware: shallower ring buys bigger chunks
    chunk_rows = _pow2_floor(max(int(chunk_dev_rows), 1) * n_dev)
    chunk_rows = max(min(chunk_rows, int(n_rows)), n_dev)
    return StreamPlan(chunk_rows, depth, bytes_per_row, budget_bytes,
                      budget_source)
