"""PyTorch execution backend — the port of ``ndstpu.engine.jaxexec``.

Executes the optimized logical plans of ``ndstpu_torch.engine.plan`` on
torch tensors that live on one device (``cuda``, or ``cpu`` when the
caller asks for it).  :class:`TorchExecutor` is the eager executor, the
counterpart of ``jaxexec.JaxExecutor``; :class:`CompilingExecutor` is
the counterpart of ``jaxexec.CompilingExecutor``: the first run of a
query key discovers its size plan eagerly, every later run replays it,
on CUDA as one captured ``torch.cuda.CUDAGraph``.

Design, kept from jaxexec:

* **Alive mask.**  A table is a set of columns plus a boolean ``alive``
  vector.  Filters only AND the mask; compaction happens at the few points
  that need it (LIMIT, a window's input, each grouping set's groups), and
  data-dependent output sizes (join fan-out) sync one scalar to the host.
  Eager runs size each such output exactly (at least one row); discovery
  and replay pad it to a capacity class (:func:`size_class`), because a
  captured graph's shapes are static.
* **Three modes** (``TorchExecutor.mode``): ``eager`` runs the plan;
  ``discover`` runs it too, and records every data-dependent decision
  (capacities, branch bools, subquery results) in a *size plan*, and every
  table it builds on the host for the device (dictionary translations, hit
  tables) as a device constant; ``replay`` re-runs the plan from that
  record with no host sync: each recorded decision adds a device guard
  (count <= capacity, branch unchanged), read back once with the result.
* **Sort-based relational operators.**  Group-by = lexicographic stable
  sort → adjacent-difference dense group ids → segment reductions (exact
  int64 for decimals), or linearized ids over a small static key domain.
  Grouping sets aggregate the finest grain once and re-aggregate each set
  from it; windows sort by (partition, order keys) and scan.
  Equi-join = mixed-radix composite key → direct-addressed lookup table
  (or one sort of both sides) → ragged expansion.
* **Strings never touch the device.**  String columns are int32 codes into
  per-column sorted dictionaries; dictionary work is done on the host.
* **Exact decimals.**  decimal(p,s) is scale-shifted int64; grouped sums
  go through the hand-written kernel ``ndstpu_torch.ops.segsum``.

* **Doubles.**  A FLOAT64 column (every money column of the
  ``--floats`` warehouse) sums in float64 (:mod:`ndstpu_torch.engine.fp64`)
  and never reaches the decimal kernel, which still sums the integer
  columns and the decimals that a query's own casts make.

There is no numpy fallback: a plan node or expression without a port
raises :class:`Unsupported`, with the NDS2xx code jaxexec uses where it
has one, so no plan quietly leaves the device.  Nor is there a fallback
from replay to eager: a capture or replay error raises.

Spans and counters are jaxexec's names: ``replay`` (with its attribution,
:class:`CompilingExecutor`), ``engine.fetched_bytes``,
``engine.cache.device.*``, ``engine.dict.*``, ``engine.cache.*`` and the
``engine.spmd.*`` and ``engine.h2d.*`` of out-of-core execution.
``xla.persistent_cache.*`` has no counterpart (there is no XLA compile
cache) and is not emitted.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import os
import pickle
import re
import threading
import time
import uuid
import warnings
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ndstpu_torch import faults, obs
from ndstpu_torch.engine import columnar, expr as ex, fp64, plan as lp
from ndstpu_torch.engine.columnar import (
    BOOL,
    DATE,
    FLOAT64,
    INT32,
    INT64,
    STRING,
    Column,
    DType,
    Table,
    decimal,
)
from ndstpu_torch.io import gdict
from ndstpu_torch.ops import segsum

# Sentinels (int64 key space)
_NULL_KEY = -(2 ** 62)      # NULL group/join key
_DEAD_KEY = 2 ** 62         # filtered-out rows
# int32 key space (narrow keys whose domain fits int32)
_NULL32 = -(2 ** 30)
_DEAD32 = 2 ** 30
_ORD_DEAD32 = 2 ** 30 + 1   # order keys: dead strictly last
_NARROW_LIM = 2 ** 30       # |value| bound for int32 keys
_MIN_CAPACITY = 256

# aggregate registries (ndstpu/analysis/lowering.py SUPPORTED_AGG_FUNCS,
# DISTINCT_AGG_FUNCS), kept as literals: the port imports nothing of ndstpu
SUPPORTED_AGG_FUNCS = frozenset({
    "sum", "count", "avg", "min", "max",
    "stddev_samp", "var_samp", "stddev", "variance",
})
DISTINCT_AGG_FUNCS = frozenset({"sum", "count", "avg", "min", "max"})
# aggregates whose grouping-set partials re-combine into coarser groups in
# one pass (lowering.py GS_COMBINABLE_AGGS); the others run one full pass
# per set
GS_COMBINABLE_AGGS = frozenset({"count", "sum", "avg", "min", "max"})

# group-by strategy: "sort" = lexsort dense ids only; "auto" = linearized
# ids when the key domain is small (no sort); "kernel" = auto + the exact
# segment-sum kernel for int/decimal sum and avg (jaxexec's "pallas")
GROUPBY_MODES = ("sort", "auto", "kernel")
GROUPBY_DEFAULT = "kernel"

_TORCH_DTYPES = {
    "int32": torch.int32,
    "int64": torch.int64,
    "float64": torch.float64,
    "decimal": torch.int64,
    "date": torch.int32,
    "string": torch.int32,
    "bool": torch.bool,
}


def torch_dtype(ct: DType) -> torch.dtype:
    return _TORCH_DTYPES[ct.kind]


def size_class(n: int) -> int:
    """The capacity class of a data-dependent size ``n`` (discovery and
    replay; eager runs size exactly): the least of 256, 320, 384, 448,
    512, 640, ... that holds ``n`` — four classes an octave, each a
    quarter of a power of two apart.  jaxexec rounds up to a power of two;
    at SF 20 that can double a join expansion, and the expansion's
    ``cummax`` and scatter are most of the corpus's device time, so the
    port pads by at most a quarter.  A rendering whose counts stay under
    the recorded classes replays; one that outgrows them fails its guard
    (count <= capacity) and is rediscovered."""
    n = max(int(n), 1)
    if n <= _MIN_CAPACITY:
        return _MIN_CAPACITY
    step = 1 << ((n - 1).bit_length() - 3)
    return -(-n // step) * step


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises when CUDA is asked for (or defaulted to) and
    there is no card — no quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return dev


@dataclasses.dataclass
class _View:
    """Shared row indirection for lazily-gathered columns: ``idx`` maps
    the current capacity into a BASE column's capacity (always one
    level — compositions fold into a single gather), ``mask`` is an
    accumulated validity-kill at the current capacity (or None)."""

    idx: torch.Tensor
    mask: Optional[torch.Tensor] = None


class DCol:
    """Device column: data + validity (meaningful where alive).

    Either materialized (``data``/``valid`` tensors) or a lazy view over a
    base column (``src_data``/``src_valid`` + shared :class:`_View`) that
    materializes on first ``.data``/``.valid`` access with ONE gather from
    the base."""

    __slots__ = ("_data", "_valid", "ctype", "dictionary", "bounds",
                 "src_data", "src_valid", "view")

    def __init__(self, data, valid, ctype: DType,
                 dictionary: Optional[np.ndarray] = None,
                 bounds: Optional[Tuple[int, int]] = None):
        self._data = data
        self._valid = valid
        self.ctype = ctype
        # host-side, sorted dictionary for string columns
        self.dictionary = dictionary
        # host-side static (lo, hi) over the column's valid values, set at
        # upload and preserved by row-subset ops (gather/filter); lets
        # group-by linearize small integer key domains without sorting
        self.bounds = bounds
        self.src_data = None
        self.src_valid = None
        self.view = None

    @classmethod
    def lazy(cls, src_data, src_valid, view: _View, ctype: DType,
             dictionary=None, bounds=None) -> "DCol":
        c = cls(None, None, ctype, dictionary, bounds)
        c.src_data = src_data
        c.src_valid = src_valid
        c.view = view
        return c

    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            self._data = self.src_data[self.view.idx]
        return self._data

    @property
    def valid(self) -> torch.Tensor:
        if self._valid is None:
            v = self.view.mask
            if self.src_valid is not None:
                sv = self.src_valid[self.view.idx]
                v = sv if v is None else (sv & v)
            if v is None:
                v = torch.ones(self.view.idx.shape[0], dtype=torch.bool,
                               device=self.view.idx.device)
            self._valid = v
        return self._valid

    @property
    def capacity(self) -> int:
        if self._data is not None:
            return int(self._data.shape[0])
        return int(self.view.idx.shape[0])


def _gather_cols(cols: Dict[str, DCol], idx: torch.Tensor,
                 extra_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, DCol]:
    """Lazily gather every column by ``idx``: columns sharing a view
    compose index/mask ONCE; materialized sources just wrap.  With
    ``extra_mask`` the gathered validity is additionally ANDed (at the
    output capacity)."""
    ident = _View(idx, extra_mask)
    memo: Dict[int, _View] = {}
    out: Dict[str, DCol] = {}
    for n, c in cols.items():
        if c.view is None:
            out[n] = DCol.lazy(c._data, c._valid, ident, c.ctype,
                               c.dictionary, c.bounds)
            continue
        v2 = memo.get(id(c.view))
        if v2 is None:
            nidx = c.view.idx[idx]
            nmask = c.view.mask[idx] if c.view.mask is not None else None
            if extra_mask is not None:
                nmask = extra_mask if nmask is None else \
                    (nmask & extra_mask)
            v2 = memo[id(c.view)] = _View(nidx, nmask)
        out[n] = DCol.lazy(c.src_data, c.src_valid, v2, c.ctype,
                           c.dictionary, c.bounds)
    return out


def _union_bounds(a: Optional[Tuple[int, int]],
                  b: Optional[Tuple[int, int]]):
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def _select_cols(cols_a: Dict[str, DCol], cols_b: Dict[str, DCol],
                 idx_a: torch.Tensor, idx_b: torch.Tensor,
                 pick_a: torch.Tensor,
                 extra_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, DCol]:
    """Two-source row select: out[n][p] = a[n][idx_a[p]] if pick_a[p]
    else b[n][idx_b[p]].  When both columns resolve to the SAME base
    tensors (a is a lazy view of b's source — the left-join shape), the
    select collapses to ONE combined index and stays lazy; otherwise both
    sides materialize and combine with ``where``."""
    memo: Dict[tuple, _View] = {}
    out: Dict[str, DCol] = {}
    for n in cols_a:
        a, b = cols_a[n], cols_b[n]
        base_a = a.src_data if a.view is not None else a._data
        base_b = b.src_data if b.view is not None else b._data
        sv_a = a.src_valid if a.view is not None else a._valid
        sv_b = b.src_valid if b.view is not None else b._valid
        # collapsing to one lazy view uses side a's src_valid for rows
        # picked from b — only sound when the VALIDITY bases match too
        if base_a is base_b and sv_a is sv_b:
            key = (id(a.view), id(b.view))
            v2 = memo.get(key)
            if v2 is None:
                ia = a.view.idx[idx_a] if a.view is not None else idx_a
                ib = b.view.idx[idx_b] if b.view is not None else idx_b
                nidx = torch.where(pick_a, ia, ib)
                ma = a.view.mask[idx_a] \
                    if a.view is not None and a.view.mask is not None \
                    else None
                mb = b.view.mask[idx_b] \
                    if b.view is not None and b.view.mask is not None \
                    else None
                if ma is None and mb is None:
                    nmask = None
                else:
                    ones = torch.ones_like(pick_a)
                    nmask = torch.where(pick_a,
                                        ma if ma is not None else ones,
                                        mb if mb is not None else ones)
                if extra_mask is not None:
                    nmask = extra_mask if nmask is None else \
                        (nmask & extra_mask)
                v2 = memo[key] = _View(nidx, nmask)
            out[n] = DCol.lazy(base_a, sv_a, v2, a.ctype, a.dictionary,
                               _union_bounds(a.bounds, b.bounds))
        else:
            data = torch.where(pick_a, a.data[idx_a], b.data[idx_b])
            valid = torch.where(pick_a, a.valid[idx_a], b.valid[idx_b])
            if extra_mask is not None:
                valid = valid & extra_mask
            out[n] = DCol(data, valid, a.ctype, a.dictionary,
                          _union_bounds(a.bounds, b.bounds))
    return out


@dataclasses.dataclass
class DTable:
    """Device table: named columns + alive mask, all of one capacity."""

    columns: Dict[str, DCol]
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> DCol:
        return self.columns[name]

    def select(self, names: Sequence[str]) -> "DTable":
        return DTable({n: self.columns[n] for n in names}, self.alive)

    def gather(self, idx: torch.Tensor, alive: torch.Tensor) -> "DTable":
        return DTable(_gather_cols(self.columns, idx), alive)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def to_device(t: Table, device) -> DTable:
    """Host (or already device-resident) table -> DTable on ``device``.
    Column data may be numpy arrays or torch tensors; tensors already on
    ``device`` are used as they are.  An empty table keeps one dead row,
    so every operator can clip indices into ``[0, capacity)``."""
    device = torch.device(device)
    n = t.num_rows
    cap = max(n, 1)
    cols: Dict[str, DCol] = {}
    for name, c in t.columns.items():
        data = torch.as_tensor(c.data).to(device=device,
                                          dtype=torch_dtype(c.ctype))
        if c.valid is None:
            valid = torch.ones(cap, dtype=torch.bool, device=device)
        else:
            valid = torch.as_tensor(c.valid).to(device)
        if n == 0:
            data = torch.zeros(cap, dtype=data.dtype, device=device)
            valid = torch.zeros(cap, dtype=torch.bool, device=device)
        bounds = None
        if c.ctype.kind in ("int32", "int64", "date", "decimal") and n > 0:
            hv = data if c.valid is None else data[valid]
            if hv.numel():
                lo, hi = torch.aminmax(hv)
                bounds = (int(lo), int(hi))
        cols[name] = DCol(data, valid, c.ctype, c.dictionary, bounds)
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return DTable(cols, alive)


def to_host(dt: DTable) -> Table:
    alive = dt.alive
    cols: Dict[str, Column] = {}
    for name, c in dt.columns.items():
        data = c.data[alive].cpu().numpy()
        valid = c.valid[alive].cpu().numpy()
        cols[name] = Column(data, c.ctype,
                            None if valid.all() else valid, c.dictionary)
    return Table(cols)


# ---------------------------------------------------------------------------
# the host-to-device staging ring of out-of-core execution
# ---------------------------------------------------------------------------


class ChunkPrefetcher:
    """Host-to-device staging ring for the out-of-core chunked executor
    (jaxexec.ChunkPrefetcher; ``ndstpu_torch.parallel.dplan``).

    ``get(i)`` returns chunk ``i``'s device tensors: per column its data
    and validity, then the alive mask, each ``rows`` long (a short last
    chunk is padded with dead rows).  While the caller computes on them,
    one staging thread runs ``read_fn`` (the scan pool's read of a chunk:
    per column ``(data, valid or None)`` of ``count`` rows, and
    ``count``) and the copy to the device for chunks ``i+1 .. i+depth``.
    ``depth=0`` is synchronous, which is also the degraded mode when a
    background stage fails (the ``io.prefetch`` fault site fires inside
    it): the stream slows down, it never wedges or drops a chunk.

    On a card, a chunk read from host memory is copied into one of
    ``depth + 1`` sets of pinned staging buffers (a ring), and from there
    to the device with ``non_blocking`` copies on a side stream owned by
    the staging thread.  An event a slot, recorded after its copies, must
    complete before the slot is filled again, and an event a chunk makes
    the compute stream wait for its copies; the chunk's device tensors
    are marked as used by the compute stream (``record_stream``), so the
    caching allocator does not hand their memory to the next chunk while
    a launch still reads it.  Only the ring is pinned, never a whole
    table.  A chunk already on the device (a resident fact) is padded
    there; on the CPU every chunk is.

    Counters (the JAX package's names): ``io.prefetch.hit`` (staged ahead
    and ready at ``get``), ``io.prefetch.miss`` (staged synchronously or
    still in flight), ``engine.h2d.bytes`` (host bytes copied to the
    device), ``engine.h2d.overlap_s`` (wall spent staging in the
    background), ``engine.h2d.wait_s`` (``get`` blocked on a chunk still
    in flight).
    """

    def __init__(self, read_fn, n_chunks: int, rows: int, device,
                 depth: int = 2):
        self._read = read_fn
        self._n = int(n_chunks)
        self._rows = int(rows)
        self.device = torch.device(device)
        self._depth = max(int(depth), 0)
        self._futs: Dict[int, object] = {}
        self._pool = None
        self._degraded = False
        self._slots: List[Optional[list]] = [None] * (self._depth + 1)
        self._slot_events: List[Optional[object]] = \
            [None] * (self._depth + 1)
        self._side = None
        # eager start: stage chunk 0's window now
        self._schedule_ahead(-1)

    def reset(self, next_i: int = 0) -> None:
        """Rewind the ring for another pass over the same chunks (a
        cached chunked query run again), staging ahead from
        ``next_i``."""
        for fut in self._futs.values():
            fut.cancel()
        self._futs.clear()
        if not self._degraded:
            self._schedule_ahead(next_i - 1)

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            # one thread: one writer of the ring, in chunk order
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ndstpu-h2d")
        return self._pool

    def _stage_bg(self, i: int):
        faults.check("io.prefetch", key=str(i))
        t0 = time.monotonic()
        try:
            return self._stage(i)
        finally:
            obs.inc("engine.h2d.overlap_s", time.monotonic() - t0)

    def _stage(self, i: int):
        """Chunk ``i`` on the device: ``(tensors, ready event or
        None)``."""
        cols, count = self._read(i)
        m = self._rows
        host = self.device.type == "cuda" and any(
            not isinstance(d, torch.Tensor) or d.device.type == "cpu"
            for d, _v in cols)
        if not host:
            out = []
            for d, v in cols:
                d = torch.as_tensor(d).to(self.device)
                buf = torch.zeros(m, dtype=d.dtype, device=self.device)
                buf[:count] = d
                vb = torch.zeros(m, dtype=torch.bool, device=self.device)
                if v is None:
                    vb[:count] = True
                else:
                    vb[:count] = torch.as_tensor(v).to(self.device)
                out += [buf, vb]
            alive = torch.zeros(m, dtype=torch.bool, device=self.device)
            alive[:count] = True
            return out + [alive], None
        k = i % (self._depth + 1)
        slot = self._slots[k]
        if slot is None:
            slot = []
            for d, _v in cols:
                slot += [torch.empty(m, dtype=torch.as_tensor(d[:0]).dtype,
                                     pin_memory=True),
                         torch.empty(m, dtype=torch.bool, pin_memory=True)]
            slot.append(torch.empty(m, dtype=torch.bool, pin_memory=True))
            self._slots[k] = slot
            self._slot_events[k] = torch.cuda.Event()
        else:
            # the copies that read this slot last time have finished
            self._slot_events[k].synchronize()
        for j, (d, v) in enumerate(cols):
            pd, pv = slot[2 * j], slot[2 * j + 1]
            pd[:count].copy_(torch.as_tensor(d))
            pd[count:].zero_()
            if v is None:
                pv[:count].fill_(True)
            else:
                pv[:count].copy_(torch.as_tensor(v))
            pv[count:].fill_(False)
        slot[-1][:count].fill_(True)
        slot[-1][count:].fill_(False)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._side):
            out = [p.to(self.device, non_blocking=True) for p in slot]
            self._slot_events[k].record(self._side)
            ready = torch.cuda.Event()
            ready.record(self._side)
        obs.inc("engine.h2d.bytes", sum(p.numel() * p.element_size()
                                        for p in slot))
        return out, ready

    def _schedule_ahead(self, i: int) -> None:
        if self._degraded or self._depth == 0:
            return
        for j in range(i + 1, min(i + 1 + self._depth, self._n)):
            if j not in self._futs:
                self._futs[j] = self._ensure_pool().submit(
                    self._stage_bg, j)

    def get(self, i: int) -> list:
        staged = None
        fut = self._futs.pop(i, None)
        if fut is not None:
            done = fut.done()
            obs.inc("io.prefetch.hit" if done else "io.prefetch.miss")
            t0 = time.monotonic()
            try:
                staged = fut.result()
                if not done:   # ring behind compute: a visible stall
                    obs.inc("engine.h2d.wait_s", time.monotonic() - t0)
                self._schedule_ahead(i)
            except Exception as e:  # noqa: BLE001 — degrade, don't wedge
                self._degrade(e)
        else:
            obs.inc("io.prefetch.miss")
            self._schedule_ahead(i)
        if staged is None:
            staged = self._stage(i)
        out, ready = staged
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            for t in out:
                t.record_stream(cur)
        return out

    def _degrade(self, exc: Exception) -> None:
        if not self._degraded:
            self._degraded = True
            obs.inc("io.prefetch.degraded")
            obs.annotate(
                io_prefetch_degraded=f"{type(exc).__name__}: {exc}")
        for fut in self._futs.values():
            fut.cancel()
        self._futs.clear()

    def close(self) -> None:
        for fut in self._futs.values():
            fut.cancel()
        self._futs.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._side is not None:
            self._side.synchronize()
        self._slots = [None] * (self._depth + 1)


class _Drift(RuntimeError):
    """A replay asked for something other than what its discovery
    recorded: the record does not belong to this plan (a preloaded record
    gone stale), never a data change."""


class _ConstRecord:
    """The host-built device tables of one run, in the order the run asks
    for them (:func:`_const`).  Discovery builds each and keeps it
    (``record``); replay takes the kept tensor at the same position, so a
    captured graph reads tensors that live as long as its compiled plan
    and replay copies nothing from the host."""

    def __init__(self, consts: list, replay: bool):
        self.consts = consts
        self.replay = replay
        self.pos = 0

    def take(self, host: np.ndarray, device) -> torch.Tensor:
        if not self.replay:
            t = torch.as_tensor(host).to(device)
            self.consts.append((host, t))
            return t
        j = self.pos
        self.pos += 1
        if j >= len(self.consts):
            raise _Drift("device-constant drift (more asked than recorded)")
        kept, t = self.consts[j]
        if kept.dtype != host.dtype or kept.shape != host.shape:
            raise _Drift(f"device-constant drift at {j}: recorded "
                         f"{kept.dtype}{kept.shape}, asked "
                         f"{host.dtype}{host.shape}")
        return t


_ACTIVE_CONSTS = threading.local()


@contextlib.contextmanager
def _consts_bound(rec: Optional[_ConstRecord]):
    """Install the device-constant record of a discovery or replay run
    (None: an eager run, or an eager subquery inside one)."""
    prev = getattr(_ACTIVE_CONSTS, "rec", None)
    _ACTIVE_CONSTS.rec = rec
    try:
        yield
    finally:
        _ACTIVE_CONSTS.rec = prev


def _const(host: np.ndarray, device) -> torch.Tensor:
    """A host-built table on ``device``: copied now in an eager run, kept
    by discovery, taken from the record in replay (no host-to-device copy
    inside a capture)."""
    host = np.ascontiguousarray(host)
    rec = getattr(_ACTIVE_CONSTS, "rec", None)
    if rec is None:
        return torch.as_tensor(host).to(device)
    return rec.take(host, device)


def _nonzero_static(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The positions of ``mask``'s true entries in order, padded with 0
    (or cut) to ``size``: ``torch.nonzero`` without its host sync, as a
    cumulative count and a scatter whose destinations are unique, all but
    one trash slot."""
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    dest = torch.where(mask & (pos < size), pos, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=mask.device)
    out[dest] = torch.arange(mask.shape[0], dtype=torch.int64,
                             device=mask.device)
    return out[:size]


def _isin(x: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """``torch.isin(x, test)`` by a sorted search: ``torch.isin`` takes a
    path through ``unique`` (a host sync) for longer lists."""
    if test.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    s = torch.sort(test.reshape(-1)).values
    i = torch.clamp(torch.searchsorted(s, x), max=s.numel() - 1)
    return s[i] == x


def _any_none(xs) -> bool:
    return any(x is None for x in xs)


def _plan_fp(o, out: Optional[list] = None,
             values: Optional[Sequence[object]] = None,
             content: bool = False) -> Optional[str]:
    """Structural fingerprint of a plan/expression tree
    (jaxexec._plan_fp).  Unlike ``repr`` it covers every dataclass field
    (Literal's repr hides its ctype).  Within one plan (aggregate leaves,
    the plan-subtree memo) an inline table is keyed by the identity of its
    table, which lives as long as the plan.  With ``values`` (a binding's
    slot values) a parameter reads as its bound value, as the literal it
    was lifted from would.  With ``content`` the fingerprint is
    jaxexec's, stable across plans and processes (it keys segments shared
    across query parts and persisted records): an inline table by its
    content, and an object with no content-based repr raises TypeError."""
    top = out is None
    if top:
        out = []
    if isinstance(o, lp.InlineTable):
        if content:
            from ndstpu_torch.analysis.canon import _inline_table_fp
            out.append(f"IT{_inline_table_fp(o.table)}")
        else:
            out.append(f"IT{id(o.table)}")
    elif values is not None and isinstance(o, ex.Param) and not o.shape:
        out.append(f"V{o.ctype!r}={values[o.slot]!r}")
    elif values is not None and isinstance(o, ex.InParam):
        out.append(f"VIN{o.negated}={values[o.slot]!r}(")
        _plan_fp(o.operand, out, values)
        out.append(")")
    elif dataclasses.is_dataclass(o) and not isinstance(o, type):
        out.append(type(o).__name__)
        out.append("(")
        for f in dataclasses.fields(o):
            _plan_fp(getattr(o, f.name), out, values, content)
            out.append(",")
        out.append(")")
    elif isinstance(o, (list, tuple)):
        out.append("[")
        for x in o:
            _plan_fp(x, out, values, content)
            out.append(",")
        out.append("]")
    elif isinstance(o, np.ndarray):
        # repr() elides long arrays ("...") — fingerprint the bytes
        out.append(f"ND{o.dtype}{o.shape}{zlib.crc32(o.tobytes())}")
    else:
        r = repr(o)
        # a default repr embeds a process-local address
        if content and _DEFAULT_REPR.search(r):
            raise TypeError(f"_plan_fp: {type(o).__name__} has no "
                            f"content-based repr")
        out.append(r)
    if top:
        return "".join(out)
    return None


_DEFAULT_REPR = re.compile(r"<[^<>]* at 0x[0-9a-fA-F]+>")


# plan nodes that run once a query when the plan holds them more than
# once (jaxexec.JaxExecutor._MEMO_NODES): the planner deep-copies each CTE
# reference, so identical subtrees are found by fingerprint, not identity
_MEMO_NODES = (lp.Join, lp.Aggregate, lp.SetOp, lp.Window, lp.Distinct,
               lp.Sort)


def _memo_key(p: lp.Plan,
              values: Optional[Sequence[object]] = None) -> Optional[str]:
    """The memo key of a memo node, or None (not a memo node, or a leaf
    with no content-based fingerprint: that node is not memoized).
    Under a binding (``values``) two subtrees whose parameters hold equal
    values share a key, as the literal plan's subtrees would: the
    canonicalizer gives every literal occurrence its own slot, so slot
    numbers alone would keep a CTE's copies apart."""
    if not isinstance(p, _MEMO_NODES):
        return None
    try:
        return _plan_fp(p, values=values)
    except TypeError:
        return None


def _memo_walk(p: lp.Plan,
               values: Optional[Sequence[object]] = None) -> List[str]:
    """The memo keys the executor asks for, in its order: the first
    occurrence of a key runs (and is walked into), each later one is a
    memo hit whose subtree never runs, so it is not walked into.
    Subquery plans live in expressions, not children: each is walked on
    its own."""
    keys: List[str] = []
    seen = set()

    def walk(q: lp.Plan):
        key = _memo_key(q, values)
        if key is not None:
            keys.append(key)
            if key in seen:
                return
            seen.add(key)
        for c in q.children():
            walk(c)

    walk(p)
    return keys


def _memo_uses(p: lp.Plan,
               values: Optional[Sequence[object]] = None) -> Dict[str, int]:
    """Memo key -> times the executor will ask for it, for every memo
    subtree of ``p`` asked for at least twice: exactly where the
    reference's memo hits, and nothing else is retained."""
    uses: Dict[str, int] = {}
    for key in _memo_walk(p, values):
        uses[key] = uses.get(key, 0) + 1
    return {k: n for k, n in uses.items() if n > 1}


def _memo_signature(p: lp.Plan,
                    values: Optional[Sequence[object]]) -> Tuple[int, ...]:
    """Which memo asks of ``p`` share a result under a binding: each ask
    numbered by the first ask of its key.  A replay runs the sharing its
    discovery recorded, so a binding whose parameters are equal in other
    places than the discovered one's cannot replay it."""
    first: Dict[str, int] = {}
    return tuple(first.setdefault(k, len(first))
                 for k in _memo_walk(p, values))


class Unsupported(Exception):
    """Raised when an expr/plan node has no port yet.

    ``code`` is the static-analyzer diagnostic (NDS2xx, see
    ndstpu/analysis/diagnostics.py) jaxexec raises at the same place;
    nodes jaxexec runs but the port does not yet stay uncoded.  ``node``
    names the plan node that refused (``"Window"``, ``"Join"``, ...):
    :meth:`TorchExecutor.execute` sets it on the way out when the raise
    site did not."""

    def __init__(self, msg: str, code: Optional[str] = None,
                 node: Optional[str] = None):
        super().__init__(msg)
        self.code = code
        self.node = node


def civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), integer math only
    (jaxexec._civil_from_days: int32 throughout, safe while |days| +
    719468 < 2^31, i.e. any date the engine can represent)."""
    z = days.to(torch.int32) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - doe // 1460 + doe // 36524 - doe // 146096, 365,
                    rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = mp + torch.where(mp < 10, 3, -9).to(torch.int32)
    year = y + (m <= 2).to(torch.int32)
    return year.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


# ---------------------------------------------------------------------------
# dictionary helpers (host work, device gathers)
# ---------------------------------------------------------------------------


def _dict_lookup_bool(c: DCol, fn) -> torch.Tensor:
    """Host predicate per dictionary entry -> device bool gather."""
    hits = np.array([bool(fn(str(x))) for x in c.dictionary], dtype=bool)
    table = _const(np.concatenate([hits, [False]]),
                   c.data.device)                         # -1 -> False
    return table[c.data]


def _dict_remap(c: DCol, fn) -> DCol:
    """Host string->string map per dictionary entry -> new dict + gather."""
    vals = [fn(str(x)) for x in c.dictionary]
    uniq = np.unique(np.asarray(vals, dtype=str)) if vals else \
        np.empty(0, dtype=str)
    remap = (np.searchsorted(uniq, np.asarray(vals, dtype=str))
             .astype(np.int32) if vals else np.empty(0, np.int32))
    table = _const(np.concatenate([remap, [-1]]).astype(np.int32),
                   c.data.device)
    return DCol(table[c.data], c.valid, STRING, uniq.astype(object))


def _translate(c: DCol, merged: np.ndarray) -> torch.Tensor:
    """Device codes of `c` re-expressed in `merged` dictionary order.
    Unmatched/-1 codes become -2 (never equal to a valid code)."""
    dev = c.data.device
    if c.dictionary is None or len(c.dictionary) == 0:
        return torch.full(c.data.shape, -2, dtype=torch.int32, device=dev)
    pos = np.searchsorted(merged, c.dictionary.astype(str))
    posc = np.clip(pos, 0, max(len(merged) - 1, 0))
    hit = merged[posc] == c.dictionary.astype(str) if len(merged) else \
        np.zeros(len(c.dictionary), dtype=bool)
    mapping = np.where(hit, posc, -2).astype(np.int32)
    table = _const(np.concatenate([mapping, [-2]]).astype(np.int32), dev)
    return table[c.data]


def _merged_dict(cols: Sequence[DCol]) -> np.ndarray:
    parts = [c.dictionary.astype(str) for c in cols
             if c.dictionary is not None and len(c.dictionary)]
    if not parts:
        return np.empty(0, dtype=str)
    return np.unique(np.concatenate(parts))


# ---------------------------------------------------------------------------
# bound parameters (canonical plans)
# ---------------------------------------------------------------------------
#
# Canonicalized plans (ndstpu_torch.analysis.canon) carry ex.Param /
# ex.InParam where the SQL text had literals.  Each execution binds them
# through an ex.ParamBinding, so one compiled plan serves every rendering
# of a template.  Scalars reach the device as one value each; a string
# parameter as a hit table over the dictionary it is compared with, and
# an IN-list parameter as a vector.  Those tables are recorded in order
# (the plan's ``param_spec``) during discovery, so that replay rebuilds
# them for any later binding and finds them positionally (jaxexec.py
# :681-875).


_ACTIVE_PARAMS = threading.local()


def _active_params() -> Optional["_ParamCtx"]:
    return getattr(_ACTIVE_PARAMS, "ctx", None)


def _param_scalar_np(value, ctype: DType):
    """Host conversion of one bound scalar to its device representation
    (mirrors JEval._lit dtype choices, minus the point bounds)."""
    if ctype.kind == "bool":
        return np.bool_(value)
    if ctype.kind == "decimal":
        v = value * 10 ** ctype.scale if isinstance(value, int) \
            else round(value * 10 ** ctype.scale)
        return np.int64(v)
    if ctype.kind == "float64":
        return np.float64(value)
    if ctype.kind in ("int32", "date"):
        return np.int32(value)
    if ctype.kind == "int64":
        return np.int64(value)
    raise Unsupported(f"parameter scalar {ctype.kind}", code="NDS201")


_PDICT_OPS = {
    "=": lambda a, b: a == b, "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
}


def _pdict_hits(value, op: str, swapped: bool, dictionary) -> np.ndarray:
    """Hit table over a sorted string dictionary for one bound string
    value (or IN tuple): len(dict)+1 bools, last entry False so the -1
    NULL code gathers False (cf. _dict_lookup_bool).  Host python string
    comparison matches np.unique's lexicographic dictionary order, so
    ordered operators agree with the merged-dict literal path.  An ``=``
    or ``<>`` binding is the bind-time lookup of one value's code, which
    jaxexec makes through its frozen dictionary (``_gcode_np``) while the
    global-dictionary layer is on: it counts ``engine.dict.lookups``, and
    ``engine.dict.misses`` when the value is in no row's dictionary."""
    if op in ("=", "<>") and gdict.enabled():
        obs.inc("engine.dict.lookups")
        v = str(value)
        if not any(str(x) == v for x in dictionary):
            obs.inc("engine.dict.misses")
    if op == "in":
        vals = set(str(v) for v in value)
        hits = [str(x) in vals for x in dictionary]
    else:
        fn = _PDICT_OPS[op]
        v = str(value)
        hits = [fn(v, str(x)) if swapped else fn(str(x), v)
                for x in dictionary]
    return np.asarray(hits + [False], dtype=bool)


def _pvec_np(values, ctype: DType) -> np.ndarray:
    """Coerced device-representation vector for a bound IN-list over a
    numeric/date operand (mirrors JEval._in_list's literal path: decimal
    values arrive scale-shifted from coerce_in_values)."""
    vals, _had_null = ex.coerce_in_values(ctype, values)
    if ctype.kind == "float64":
        return np.array(vals, dtype=np.float64)
    return np.array(vals, dtype=np.int64)


class _ParamCtx:
    """One execution's bound parameters.

    mode ``concrete``: ``values`` holds python literals; hit tables and
    vectors are built on the host directly (and appended to ``spec`` when
    ``record`` is set, i.e. during discovery).  mode ``replay``: scalars,
    tables and vectors are read from ``bufs``, the device buffers that
    :func:`_param_args_np` filled for this binding; non-scalar entries pop
    ``spec`` positionally, exactly like the size-plan record."""

    def __init__(self, values, mode: str, spec: Optional[list] = None,
                 bufs: Optional[dict] = None, record: bool = False):
        self.values = values
        self.mode = mode
        self.spec = spec if spec is not None else []
        self.pos = 0
        self.bufs = bufs if bufs is not None else {}
        self.record = record

    def _pop(self, kind: str) -> int:
        j = self.pos
        self.pos += 1
        if j >= len(self.spec) or self.spec[j][0] != kind:
            raise _Drift(f"param-spec drift (expected {kind})")
        return j

    def scalar(self, slot: int, ctype: DType, cap: int,
               device) -> DCol:
        if self.mode == "replay":
            data = self.bufs[f"s{slot}"].expand(cap)
        else:
            v = _param_scalar_np(self.values[slot], ctype)
            data = torch.full((cap,), v.item(), dtype=torch_dtype(ctype),
                              device=device)
        return DCol(data, torch.ones(cap, dtype=torch.bool, device=device),
                    ctype)

    def str_table(self, slot: int, op: str, swapped: bool, dictionary,
                  device) -> torch.Tensor:
        if self.mode == "replay":
            return self.bufs[f"d{self._pop('pdict')}"]
        if self.record:
            self.spec.append(("pdict", slot, op, swapped,
                              np.asarray(dictionary, dtype=object)))
        return torch.as_tensor(_pdict_hits(self.values[slot], op, swapped,
                                           dictionary)).to(device)

    def num_vec(self, slot: int, ctype: DType, device) -> torch.Tensor:
        if self.mode == "replay":
            return self.bufs[f"v{self._pop('pvec')}"]
        if self.record:
            self.spec.append(("pvec", slot, ctype))
        return torch.as_tensor(_pvec_np(self.values[slot], ctype)).to(device)


@contextlib.contextmanager
def _params_bound(ctx: Optional[_ParamCtx]):
    """Install a parameter context for the evaluator for the dynamic
    extent (None: no parameters, as in an eager subquery)."""
    prev = getattr(_ACTIVE_PARAMS, "ctx", None)
    _ACTIVE_PARAMS.ctx = ctx
    try:
        yield
    finally:
        _ACTIVE_PARAMS.ctx = prev


def _param_args_np(spec, binding: Optional[ex.ParamBinding],
                   slots: Optional[frozenset] = None) -> dict:
    """Host arguments of one compiled plan under one binding: every
    bindable scalar slot (of ``slots``, where given) plus one hit table /
    coerced vector per recorded spec entry.  Replay copies them into the
    plan's device buffers."""
    out = {}
    if binding is None:
        return out
    for slot, ctype in binding.scalars:
        if slots is not None and slot not in slots:
            continue
        out[f"s{slot}"] = np.asarray(
            _param_scalar_np(binding.values[slot], ctype))
    for j, ent in enumerate(spec or ()):
        if ent[0] == "pdict":
            _tag, slot, op, swapped, dic = ent
            out[f"d{j}"] = _pdict_hits(binding.values[slot], op,
                                       swapped, dic)
        else:
            _tag, slot, ctype = ent
            out[f"v{j}"] = _pvec_np(binding.values[slot], ctype)
    return out


class JEval:
    """Evaluates an Expr over a DTable with torch ops (jaxexec.JEval).

    Ported: column refs, literals, casts, comparisons, and/or/not, null
    tests, arithmetic, ``||``, CASE, IN-lists and the scalar functions.
    String functions work on the dictionary: a host-side table of the
    dictionary's values, then a gather of the codes on the device.
    Parameters of canonical plans read the active :class:`_ParamCtx`."""

    _CMP = {"=", "<>", "<", "<=", ">", ">="}
    _ARITH = {"+", "-", "*", "/", "%"}

    def __init__(self, table: DTable):
        self.t = table
        self.cap = table.capacity
        self.device = table.alive.device

    def _full(self, value, dtype) -> torch.Tensor:
        return torch.full((self.cap,), value, dtype=dtype,
                          device=self.device)

    def _ones(self) -> torch.Tensor:
        return torch.ones(self.cap, dtype=torch.bool, device=self.device)

    # -- helpers -------------------------------------------------------------

    def _lit(self, value, ctype: Optional[DType]) -> DCol:
        cap = self.cap
        if value is None:
            ct = ctype or INT32
            return DCol(torch.zeros(cap, dtype=torch_dtype(ct),
                                    device=self.device),
                        torch.zeros(cap, dtype=torch.bool,
                                    device=self.device), ct,
                        np.empty(0, object) if ct.kind == "string" else None)
        valid = self._ones()
        if isinstance(value, bool):
            return DCol(self._full(value, torch.bool), valid, BOOL)
        if isinstance(value, int):
            # point bounds: every valid row is exactly this value
            ct = ctype or (INT64 if abs(value) > 2 ** 31 - 1 else INT32)
            if ct.kind == "decimal":
                v = value * 10 ** ct.scale
                return DCol(self._full(v, torch.int64), valid, ct,
                            bounds=(v, v))
            return DCol(self._full(value, torch_dtype(ct)), valid, ct,
                        bounds=(int(value), int(value)))
        if isinstance(value, float):
            if ctype and ctype.kind == "decimal":
                v = round(value * 10 ** ctype.scale)
                return DCol(self._full(v, torch.int64), valid, ctype,
                            bounds=(v, v))
            return DCol(self._full(value, torch.float64), valid, FLOAT64)
        if isinstance(value, str):
            d = np.array([value], dtype=object)
            return DCol(self._full(0, torch.int32), valid, STRING, d)
        raise Unsupported(f"literal {value!r}", code="NDS201")

    def cast(self, c: DCol, target: DType) -> DCol:
        k, tk = c.ctype.kind, target.kind
        if k == tk and (tk != "decimal" or c.ctype.scale == target.scale):
            if tk != "decimal":
                return c
            if target.precision < c.ctype.precision:
                # Spark non-ANSI overflow: out-of-precision values -> NULL
                limit = 10 ** target.precision
                ok = torch.abs(c.data) < limit
                b = (-(limit - 1), limit - 1)
                if c.bounds is not None:
                    b = (max(b[0], c.bounds[0]), min(b[1], c.bounds[1]))
                return DCol(c.data, c.valid & ok, target, c.dictionary,
                            bounds=b if b[0] <= b[1] else None)
            return DCol(c.data, c.valid, target, c.dictionary,
                        bounds=c.bounds)
        if tk == "float64":
            if k == "decimal":
                data = _true_div(c.data.to(torch.float64),
                                 10 ** c.ctype.scale)
            elif k == "string":
                data, valid = self._string_parse_float(c)
                return DCol(data, valid, FLOAT64)
            else:
                data = c.data.to(torch.float64)
            return DCol(data, c.valid, FLOAT64)
        if tk == "decimal":
            scale = 10 ** target.scale
            bounds = None
            if k == "decimal":
                shift = target.scale - c.ctype.scale
                if shift >= 0:
                    data = c.data * (10 ** shift)
                    if c.bounds is not None:
                        m = 10 ** shift
                        bounds = (c.bounds[0] * m, c.bounds[1] * m)
                else:
                    d = 10 ** (-shift)
                    sign = torch.sign(c.data)
                    data = sign * torch.div(torch.abs(c.data) + d // 2, d,
                                            rounding_mode="floor")
                    if c.bounds is not None:
                        # round-half-away-from-zero is monotonic
                        def _rd(v: int) -> int:
                            s = -1 if v < 0 else 1
                            return s * ((abs(v) + d // 2) // d)
                        bounds = (_rd(c.bounds[0]), _rd(c.bounds[1]))
            elif k == "float64":
                x = c.data * scale
                data = (torch.floor(torch.abs(x) + 0.5) *
                        torch.sign(x)).to(torch.int64)
            elif k == "string":
                f, valid = self._string_parse_float(c)
                x = f * scale
                data = (torch.floor(torch.abs(x) + 0.5) *
                        torch.sign(x)).to(torch.int64)
                return DCol(data, valid, target)
            else:
                data = c.data.to(torch.int64) * scale
                if k in ("int32", "int64") and c.bounds is not None:
                    bounds = (c.bounds[0] * scale, c.bounds[1] * scale)
                elif k == "bool":
                    bounds = (0, scale)
            return DCol(data.to(torch.int64), c.valid, target,
                        bounds=bounds)
        if tk in ("int32", "int64"):
            dt = torch.int64 if tk == "int64" else torch.int32
            bounds = None
            if k == "decimal":
                data = torch.trunc(_true_div(c.data.to(torch.float64),
                                             10 ** c.ctype.scale)).to(dt)
                if c.bounds is not None and \
                        max(abs(c.bounds[0]), abs(c.bounds[1])) < (1 << 53):
                    # the data path divides in float64; below 2^53 the
                    # scaled value is exact and trunc(fl(v/s)) == v//s
                    s = 10 ** c.ctype.scale

                    def _tr(v: int) -> int:
                        return -((-v) // s) if v < 0 else v // s
                    bounds = (_tr(c.bounds[0]), _tr(c.bounds[1]))
            elif k == "string":
                f, valid = self._string_parse_float(c)
                return DCol(f.to(dt), valid, target)
            else:
                data = c.data.to(dt)
                if k in ("int32", "int64") and c.bounds is not None:
                    bounds = c.bounds
                elif k == "bool":
                    bounds = (0, 1)
            if bounds is not None and tk == "int32" and not (
                    -(1 << 31) <= bounds[0] and bounds[1] < (1 << 31)):
                # narrowing may wrap valid values; no safe bounds
                bounds = None
            return DCol(data, c.valid, target, bounds=bounds)
        if tk == "date":
            if k == "string":
                return self._string_parse_date(c)
            return DCol(c.data.to(torch.int32), c.valid, DATE)
        if tk == "bool":
            return DCol(c.data.to(torch.bool), c.valid, BOOL)
        raise Unsupported(f"cast {c.ctype} -> {target}", code="NDS204")

    def _dict_table(self, c: DCol, vals: np.ndarray, ok: np.ndarray):
        data = _const(vals, self.device)[c.data]
        valid = c.valid & _const(ok, self.device)[c.data]
        return data, valid

    def _string_parse_float(self, c: DCol):
        vals = np.zeros(len(c.dictionary) + 1, dtype=np.float64)
        ok = np.zeros(len(c.dictionary) + 1, dtype=bool)
        for i, s in enumerate(c.dictionary):
            try:
                vals[i] = float(str(s))
                ok[i] = True
            except ValueError:
                pass
        return self._dict_table(c, vals, ok)

    def _string_parse_date(self, c: DCol) -> DCol:
        vals = np.zeros(len(c.dictionary) + 1, dtype=np.int32)
        ok = np.zeros(len(c.dictionary) + 1, dtype=bool)
        for i, s in enumerate(c.dictionary):
            try:
                vals[i] = columnar.parse_date_days(str(s))
                ok[i] = True
            except ValueError:
                pass
        data, valid = self._dict_table(c, vals, ok)
        return DCol(data, valid, DATE)

    # -- entry ---------------------------------------------------------------

    def eval(self, e: ex.Expr) -> DCol:
        if isinstance(e, ex.ColumnRef):
            return self.t.column(e.name)
        if isinstance(e, ex.Literal):
            return self._lit(e.value, e.ctype)
        if isinstance(e, ex.Cast):
            return self.cast(self.eval(e.operand), e.target)
        if isinstance(e, ex.BinOp):
            return self._binop(e)
        if isinstance(e, ex.UnaryOp):
            return self._unary(e)
        if isinstance(e, ex.Case):
            return self._case(e)
        if isinstance(e, ex.Func):
            return self._func(e)
        if isinstance(e, ex.InList):
            return self._in_list(e)
        if isinstance(e, ex.Param):
            return self._param(e)
        if isinstance(e, ex.InParam):
            return self._in_param(e)
        raise Unsupported(f"expr {type(e).__name__}", code="NDS201")

    def predicate(self, e: ex.Expr) -> torch.Tensor:
        c = self.eval(e)
        return c.data.to(torch.bool) & c.valid & self.t.alive

    # -- operators -----------------------------------------------------------

    def _binop(self, e: ex.BinOp) -> DCol:
        op = e.op
        if op in ("and", "or"):
            lc, rc = self.eval(e.left), self.eval(e.right)
            lb, rb = lc.data.to(torch.bool), rc.data.to(torch.bool)
            ld = lb & lc.valid
            rd = rb & rc.valid
            if op == "and":
                data = ld & rd
                definite_false = (~lb & lc.valid) | (~rb & rc.valid)
                valid = (lc.valid & rc.valid) | definite_false
            else:
                data = ld | rd
                valid = (lc.valid & rc.valid) | ld | rd
            return DCol(data, valid, BOOL)
        if op in self._CMP:
            pc = self._param_compare(e, op)
            if pc is not None:
                return pc
        lc, rc = self.eval(e.left), self.eval(e.right)
        if op in self._CMP:
            return self._compare(op, lc, rc)
        if op in self._ARITH:
            return self._arith(op, lc, rc)
        if op == "||":
            return self._concat_pair(lc, rc)
        raise Unsupported(f"binop {op}", code="NDS202")

    def _align_compare(self, lc: DCol, rc: DCol):
        lk, rk = lc.ctype.kind, rc.ctype.kind
        if lk == "string" and rk == "string":
            if lc.dictionary is not None and rc.dictionary is not None and \
                    len(lc.dictionary) == len(rc.dictionary) and \
                    np.array_equal(lc.dictionary, rc.dictionary):
                return lc.data, rc.data
            merged = _merged_dict([lc, rc])
            return _translate(lc, merged), _translate(rc, merged)
        if lk == "decimal" or rk == "decimal":
            if "float64" in (lk, rk):
                return (self.cast(lc, FLOAT64).data,
                        self.cast(rc, FLOAT64).data)
            s = max(lc.ctype.scale if lk == "decimal" else 0,
                    rc.ctype.scale if rk == "decimal" else 0)
            tgt = decimal(38, s)
            return self.cast(lc, tgt).data, self.cast(rc, tgt).data
        if lk == "float64" or rk == "float64":
            return (self.cast(lc, FLOAT64).data,
                    self.cast(rc, FLOAT64).data)
        return lc.data, rc.data

    def _compare(self, op: str, lc: DCol, rc: DCol) -> DCol:
        # implicit string->date coercion (Spark semantics), mirroring
        # ex.Evaluator._compare so every backend stays bit-identical
        if lc.ctype.kind == "date" and rc.ctype.kind == "string":
            rc = self._string_to_date(rc)
        elif rc.ctype.kind == "date" and lc.ctype.kind == "string":
            lc = self._string_to_date(lc)
        ld, rd = self._align_compare(lc, rc)
        data = {"=": torch.eq, "<>": torch.ne, "<": torch.lt,
                "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op](ld, rd)
        return DCol(data, lc.valid & rc.valid, BOOL)

    def _string_to_date(self, c: DCol) -> DCol:
        """Parse string codes as dates through a host-parsed dictionary
        table; unparseable entries and negative codes become NULL
        (same table as ex.string_to_date_column)."""
        days, ok = ex.parse_dictionary_days(c.dictionary)
        if not len(days):
            return DCol(torch.zeros(self.cap, dtype=torch.int32,
                                    device=self.device),
                        torch.zeros(self.cap, dtype=torch.bool,
                                    device=self.device), DATE)
        codes_ok = c.data >= 0
        idx = torch.clamp(c.data, 0, len(days) - 1)
        days_t = _const(days, self.device)
        out = torch.where(codes_ok, days_t[idx], torch.zeros_like(days_t[idx]))
        valid = c.valid & codes_ok & _const(ok, self.device)[idx]
        return DCol(out.to(torch.int32), valid, DATE)

    def _arith(self, op: str, lc: DCol, rc: DCol) -> DCol:
        lk, rk = lc.ctype.kind, rc.ctype.kind
        valid = lc.valid & rc.valid
        if lk == "date" and rk in ("int32", "int64"):
            delta = rc.data.to(torch.int32)
            data = lc.data + (delta if op == "+" else -delta)
            return DCol(data, valid, DATE)
        if op == "/":
            ld = self.cast(lc, FLOAT64).data
            rd = self.cast(rc, FLOAT64).data
            safe = torch.where(rd == 0, torch.ones_like(rd), rd)
            return DCol(ld / safe, valid & (rd != 0), FLOAT64)
        if lk == "decimal" or rk == "decimal":
            if "float64" in (lk, rk):
                ld = self.cast(lc, FLOAT64).data
                rd = self.cast(rc, FLOAT64).data
                if op == "%":
                    data = torch.remainder(
                        ld, torch.where(rd == 0, torch.ones_like(rd), rd))
                else:
                    data = {"+": torch.add, "-": torch.sub,
                            "*": torch.mul}[op](ld, rd)
                return DCol(data, valid, FLOAT64)
            ls = lc.ctype.scale if lk == "decimal" else 0
            rs = rc.ctype.scale if rk == "decimal" else 0
            if op == "*":
                data = lc.data.to(torch.int64) * rc.data.to(torch.int64)
                return DCol(data, valid, decimal(38, ls + rs))
            s = max(ls, rs)
            ld = lc.data.to(torch.int64) * (10 ** (s - ls))
            rd = rc.data.to(torch.int64) * (10 ** (s - rs))
            if op == "%":
                safe = torch.where(rd == 0, torch.ones_like(rd), rd)
                return DCol(torch.remainder(ld, safe), valid & (rd != 0),
                            decimal(38, s))
            data = ld + rd if op == "+" else ld - rd
            return DCol(data, valid, decimal(38, s))
        tgt = ex.common_type(lc.ctype, rc.ctype)
        ld = self.cast(lc, tgt).data
        rd = self.cast(rc, tgt).data
        if op == "%":
            safe = torch.where(rd == 0, torch.ones_like(rd), rd)
            return DCol(torch.remainder(ld, safe), valid & (rd != 0), tgt)
        data = {"+": torch.add, "-": torch.sub, "*": torch.mul}[op](ld, rd)
        return DCol(data, valid, tgt)

    def _unary(self, e: ex.UnaryOp) -> DCol:
        c = self.eval(e.operand)
        if e.op == "not":
            return DCol(~c.data.to(torch.bool), c.valid, BOOL)
        if e.op == "neg":
            return DCol(-c.data, c.valid, c.ctype)
        if e.op == "isnull":
            return DCol(~c.valid, self._ones(), BOOL)
        if e.op == "isnotnull":
            return DCol(c.valid, self._ones(), BOOL)
        raise Unsupported(f"unary {e.op}", code="NDS203")

    def _zeros_bool(self) -> torch.Tensor:
        return torch.zeros(self.cap, dtype=torch.bool, device=self.device)

    def _case(self, e: ex.Case) -> DCol:
        conds, vals = [], []
        for cond, val in e.whens:
            cc = self.eval(cond)
            conds.append(cc.data.to(torch.bool) & cc.valid)
            vals.append(self.eval(val))
        default = self.eval(e.default) if e.default is not None else None
        cands = vals + ([default] if default is not None else [])
        tgt = cands[0].ctype
        for c in cands[1:]:
            if ex.is_numeric(c.ctype) and ex.is_numeric(tgt):
                tgt = ex.common_type(tgt, c.ctype)
            elif c.ctype.kind != tgt.kind:
                tgt = c.ctype if tgt.kind == "int32" else tgt
        if tgt.kind == "string":
            # all-branch merged dictionary, then code selection on device
            scols = [self.cast(v, STRING) for v in vals]
            sdef = self.cast(default, STRING) if default is not None \
                else None
            allc = scols + ([sdef] if sdef is not None else [])
            merged = _merged_dict(allc)
            data = self._full(-2, torch.int32)
            valid = self._zeros_bool()
            taken = self._zeros_bool()
            for cond, vc in zip(conds, scols):
                sel = cond & ~taken
                data = torch.where(sel, _translate(vc, merged), data)
                valid = torch.where(sel, vc.valid, valid)
                taken = taken | cond
            if sdef is not None:
                data = torch.where(taken, data, _translate(sdef, merged))
                valid = torch.where(taken, valid, sdef.valid)
            data = torch.where(valid, data, -1).to(torch.int32)
            return DCol(data, valid, STRING, merged.astype(object))
        dt = torch_dtype(tgt)
        data = torch.zeros(self.cap, dtype=dt, device=self.device)
        valid = self._zeros_bool()
        taken = self._zeros_bool()
        branch_bounds = []
        for cond, val in zip(conds, vals):
            vc = self.cast(val, tgt)
            sel = cond & ~taken
            data = torch.where(sel, vc.data.to(dt), data)
            valid = torch.where(sel, vc.valid, valid)
            taken = taken | cond
            branch_bounds.append(vc.bounds)
        if default is not None:
            dc = self.cast(default, tgt)
            data = torch.where(taken, data, dc.data.to(dt))
            valid = torch.where(taken, valid, dc.valid)
            # a NULL-literal default contributes no VALID rows, so it
            # cannot widen the bounds of the output's valid values
            if not (isinstance(e.default, ex.Literal)
                    and e.default.value is None):
                branch_bounds.append(dc.bounds)
        bounds = None
        if tgt.kind in ("int32", "int64", "decimal") and branch_bounds \
                and all(b is not None for b in branch_bounds):
            # every valid output row carries some branch's valid value,
            # so the union of branch bounds bounds the output
            bounds = (min(b[0] for b in branch_bounds),
                      max(b[1] for b in branch_bounds))
        return DCol(data, valid, tgt, bounds=bounds)

    # -- bound parameters (canonical plans) ----------------------------------

    def _param(self, e: ex.Param) -> DCol:
        ctx = _active_params()
        if ctx is None or e.shape:
            raise Unsupported(f"unbound parameter S{e.slot}",
                              code="NDS201")
        if e.ctype.kind == "string":
            # string scalars only bind through the dictionary-compare /
            # IN intercepts; reaching generic eval means the
            # canonicalizer lifted a string the device cannot broadcast
            raise Unsupported("string parameter outside dictionary "
                              "context", code="NDS206")
        return ctx.scalar(e.slot, e.ctype, self.cap, self.device)

    def _param_compare(self, e: ex.BinOp, op: str) -> Optional[DCol]:
        """String-parameter comparison: host hit table over the other
        side's dictionary (the parametric twin of the literal-string
        merged-dict path).  jaxexec compares a frozen global dictionary's
        code for = and <> where it has one; the port's dictionaries are
        per column, so every operator takes the hit table."""
        ctx = _active_params()
        if ctx is None:
            return None
        for par, other, swapped in ((e.right, e.left, False),
                                    (e.left, e.right, True)):
            if isinstance(par, ex.Param) and not par.shape and \
                    par.ctype.kind == "string":
                oc = self.eval(other)
                if oc.ctype.kind != "string" or oc.dictionary is None:
                    raise Unsupported("string parameter vs non-dictionary"
                                      " operand", code="NDS206")
                table = ctx.str_table(par.slot, op, swapped,
                                      oc.dictionary, self.device)
                return DCol(table[oc.data], oc.valid, BOOL)
        return None

    def _in_param(self, e: ex.InParam) -> DCol:
        ctx = _active_params()
        if ctx is None:
            raise Unsupported(f"unbound parameter P{e.slot}",
                              code="NDS201")
        c = self.eval(e.operand)
        if c.ctype.kind == "string":
            if c.dictionary is None:
                raise Unsupported("IN parameter on non-dictionary "
                                  "string", code="NDS206")
            table = ctx.str_table(e.slot, "in", False, c.dictionary,
                                  self.device)
            data = table[c.data]
        else:
            vec = ctx.num_vec(e.slot, c.ctype, self.device)
            dt = torch.promote_types(c.data.dtype, vec.dtype)
            data = _isin(c.data.to(dt), vec.to(dt))
        if e.negated:
            # the canonicalizer only lifts NULL-free IN-lists, so plain
            # complement is exact (no three-valued NOT IN hazard)
            data = ~data
        return DCol(data, c.valid, BOOL)

    def _concat_pair(self, a: DCol, b: DCol) -> DCol:
        """String concatenation on dictionary codes.  One-sided literal:
        host remap of the other side's dictionary.  Dict x dict: host
        cross-product dictionary (guarded against blowup) + device pair
        codes.  NULL || x is NULL (SQL semantics)."""
        if a.ctype.kind != "string" or b.ctype.kind != "string":
            raise Unsupported("|| on non-string operands", code="NDS206")
        da = a.dictionary if a.dictionary is not None else \
            np.empty(0, object)
        db = b.dictionary if b.dictionary is not None else \
            np.empty(0, object)
        na, nb = len(da), len(db)
        valid = a.valid & b.valid & (a.data >= 0) & (b.data >= 0)
        if na == 0 or nb == 0:  # one side all-NULL
            return DCol(self._full(-1, torch.int32), self._zeros_bool(),
                        STRING, np.empty(0, object))

        def encode(vals: np.ndarray):
            uniq, remap = np.unique(vals, return_inverse=True)
            table = _const(np.concatenate(
                [remap.reshape(-1).astype(np.int64), [-1]]).astype(
                    np.int32), self.device)
            return uniq.astype(object), table

        if na == 1 or nb == 1:
            if nb == 1:
                base, vals = a, np.char.add(da.astype(str), str(db[0]))
            else:
                base, vals = b, np.char.add(str(da[0]), db.astype(str))
            uniq, table = encode(vals)
            data = torch.where(valid, table[base.data], -1).to(torch.int32)
            return DCol(data, valid, STRING, uniq)
        if na * nb > (1 << 20):
            raise Unsupported("|| dictionary cross-product too large",
                              code="NDS213")
        uniq, table = encode(np.char.add(np.repeat(da.astype(str), nb),
                                         np.tile(db.astype(str), na)))
        pair = torch.where(valid, a.data.to(torch.int64) * nb + b.data,
                           na * nb)
        return DCol(table[pair], valid, STRING, uniq)

    def _func(self, e: ex.Func) -> DCol:
        name = e.name
        if name == "concat":
            cols = [self.eval(a) for a in e.args]
            out = cols[0]
            for c in cols[1:]:
                out = self._concat_pair(out, c)
            return out
        if name == "coalesce":
            cols = [self.eval(a) for a in e.args]
            tgt = ex.coalesce_common_type(e.args, [c.ctype for c in cols])
            if tgt.kind == "string":
                scols = [self.cast(c, STRING) for c in cols]
                merged = _merged_dict(scols)
                data = self._full(-1, torch.int32)
                valid = self._zeros_bool()
                for c in scols:
                    take = ~valid & c.valid
                    data = torch.where(take, _translate(c, merged), data)
                    valid = valid | c.valid
                return DCol(data, valid, STRING, merged.astype(object))
            dt = torch_dtype(tgt)
            data = torch.zeros(self.cap, dtype=dt, device=self.device)
            valid = self._zeros_bool()
            for c in cols:
                cc = self.cast(c, tgt)
                take = ~valid & cc.valid
                data = torch.where(take, cc.data.to(dt), data)
                valid = valid | cc.valid
            return DCol(data, valid, tgt)
        if name == "like":
            c = self.eval(e.args[0])
            rx = re.compile(_like_to_regex(e.args[1].value), re.S)
            data = _dict_lookup_bool(
                c, lambda s: rx.fullmatch(s) is not None)
            return DCol(data, c.valid, BOOL)
        if name in ("substr", "substring"):
            c = self.eval(e.args[0])
            start = int(e.args[1].value)
            length = int(e.args[2].value) if len(e.args) > 2 else None

            def sub(s: str) -> str:
                i = start - 1 if start > 0 else len(s) + start
                return s[i:i + length] if length is not None else s[i:]
            out = _dict_remap(self.cast(c, STRING)
                              if c.ctype.kind != "string" else c, sub)
            return DCol(out.data, c.valid, STRING, out.dictionary)
        if name in ("upper", "lower", "trim"):
            c = self._as_string(e.args[0])
            fn = {"upper": str.upper, "lower": str.lower,
                  "trim": str.strip}[name]
            out = _dict_remap(c, fn)
            return DCol(out.data, c.valid, STRING, out.dictionary)
        if name == "length":
            c = self._as_string(e.args[0])
            lens = np.array([len(str(x)) for x in c.dictionary] + [0],
                            dtype=np.int32)
            return DCol(_const(lens, self.device)[c.data], c.valid, INT32)
        if name == "abs":
            c = self.eval(e.args[0])
            return DCol(torch.abs(c.data), c.valid, c.ctype)
        if name == "round":
            c = self.eval(e.args[0])
            nd = int(e.args[1].value) if len(e.args) > 1 else 0
            if c.ctype.kind == "decimal":
                if nd >= c.ctype.scale:
                    return c
                return self.cast(c, decimal(c.ctype.precision, nd))
            m = 10.0 ** nd
            x = c.data.to(torch.float64)
            data = _true_div(torch.floor(torch.abs(x) * m + 0.5), m) * \
                torch.sign(x)
            return DCol(data, c.valid, FLOAT64)
        if name in ("floor", "ceil", "sqrt"):
            c = self.cast(self.eval(e.args[0]), FLOAT64)
            fn = {"floor": torch.floor, "ceil": torch.ceil,
                  "sqrt": lambda x: torch.sqrt(torch.clamp(x, min=0))}[name]
            return DCol(fn(c.data), c.valid, FLOAT64)
        if name in ("year", "month", "day"):
            c = self.eval(e.args[0])
            y, m, d = civil_from_days(c.data)
            return DCol({"year": y, "month": m, "day": d}[name],
                        c.valid, INT32)
        if name == "nullif":
            a = self.eval(e.args[0])
            b = self.eval(e.args[1])
            eqc = self._compare("=", a, b)
            eq = eqc.data & eqc.valid
            return DCol(a.data, a.valid & ~eq, a.ctype, a.dictionary)
        raise Unsupported(f"function {name}", code="NDS205")

    def _as_string(self, arg: ex.Expr) -> DCol:
        c = self.eval(arg)
        if c.ctype.kind != "string":
            raise Unsupported("cast-to-string on device", code="NDS206")
        return c

    def _in_list(self, e: ex.InList) -> DCol:
        c = self.eval(e.operand)
        had_null = False
        if c.ctype.kind == "string":
            vals = set(str(v) for v in e.values)
            data = _dict_lookup_bool(c, lambda s: s in vals)
        else:
            vals, had_null = ex.coerce_in_values(c.ctype, e.values)
            if not vals:
                data = torch.zeros(c.capacity, dtype=torch.bool,
                                   device=self.device)
            else:
                arr = np.array(vals, dtype=np.int64) \
                    if c.ctype.kind == "decimal" else np.asarray(vals)
                if arr.dtype == object or arr.dtype.kind in "US":
                    raise Unsupported(f"IN-list literals {arr.dtype} for "
                                      f"{c.ctype.kind} column",
                                      code="NDS212")
                # compare in the promoted type, as jnp.isin does
                test = _const(arr, self.device)
                dt = torch.promote_types(c.data.dtype, test.dtype)
                data = _isin(c.data.to(dt), test.to(dt))
        if e.negated:
            # x NOT IN (..., NULL) is never TRUE (NULL semantics)
            data = torch.zeros_like(data) if had_null else ~data
        return DCol(data, c.valid, BOOL)


# ---------------------------------------------------------------------------
# key helpers
# ---------------------------------------------------------------------------


def _iota(n: int, device, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def _segment_sum(vals: torch.Tensor, gid: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum for in-range ids (every caller's gids are);
    float sums through :mod:`fp64`, in a fixed order on every device."""
    if vals.dtype.is_floating_point:
        return fp64.segment_sum_compensated(vals, gid, num_segments)
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, gid, vals)


def _minmax_vals(data: torch.Tensor, valid: torch.Tensor, kind: str,
                 is_min: bool) -> torch.Tensor:
    """Reduction input for min/max in the data's NATIVE dtype: invalid
    rows filled with the dtype's own extremum (the reduction identity).
    Bool widens to int32."""
    if kind == "bool":
        data = data.to(torch.int32)
    info = torch.iinfo(data.dtype)
    return data.masked_fill(~valid, info.max if is_min else info.min)


def _true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a float64 ``x`` and a Python number ``d``, as an IEEE
    division on every device.  PyTorch multiplies a CUDA tensor by the
    reciprocal of a Python-number divisor, which can differ from the
    quotient in the last bit, and so break a tie or a rank that the
    reference (and the CPU) compute on true quotients."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _sum_input(data: torch.Tensor, valid: torch.Tensor,
               kind: str) -> torch.Tensor:
    """Summation input, 0 where invalid: exact int64 for decimal/int
    kinds, float64 otherwise (jaxexec._sum_input)."""
    if kind in ("decimal", "int32", "int64"):
        return data.to(torch.int64).masked_fill(~valid, 0)
    return data.to(torch.float64).masked_fill(~valid, 0.0)


def _typed_sum(data: torch.Tensor, valid: torch.Tensor, kind: str,
               gid: torch.Tensor, ngseg: int) -> torch.Tensor:
    """Per-segment sums of the valid rows: decimal/int sums stay exact
    int64, float sums are native float64 (:mod:`ndstpu_torch.engine.fp64`,
    jaxexec's compensated f32-pair scan)."""
    if kind in ("decimal", "int32", "int64"):
        return _segment_sum(data.to(torch.int64).masked_fill(~valid, 0),
                            gid, ngseg)
    return fp64.segment_sum_compensated(
        data.to(torch.float64).masked_fill(~valid, 0.0), gid, ngseg)


def _key_i64(c: DCol, alive: torch.Tensor,
             peer: Optional[DCol] = None) -> torch.Tensor:
    """Column -> int64 key with NULL/dead sentinels (grouping/join space).
    For strings, translates into a dictionary merged with `peer` when
    dictionaries differ.  The data is widened BEFORE the sentinels are
    written: they do not fit the int32 columns."""
    if c.ctype.kind == "string":
        if peer is not None and peer.ctype.kind == "string" and not (
                c.dictionary is not None and peer.dictionary is not None and
                len(c.dictionary) == len(peer.dictionary) and
                np.array_equal(c.dictionary, peer.dictionary)):
            merged = _merged_dict([c, peer])
            data = _translate(c, merged).to(torch.int64)
        else:
            data = c.data.to(torch.int64)
    elif c.ctype.kind == "float64":
        # float64 keys stay float64; NaNs fold to DBL_MAX (one NaN group),
        # the sentinel magnitudes (2^62) are exactly representable
        data = c.data.to(torch.float64)
        data = torch.nan_to_num(data, nan=torch.finfo(torch.float64).max,
                                posinf=float("inf"), neginf=float("-inf"))
        data = data.masked_fill(~c.valid, float(_NULL_KEY))
        return data.masked_fill(~alive, float(_DEAD_KEY))
    else:
        data = c.data.to(torch.int64)
    data = data.masked_fill(~c.valid, _NULL_KEY)
    return data.masked_fill(~alive, _DEAD_KEY)


def _lexsort_order(keys: List[torch.Tensor]) -> torch.Tensor:
    """Stable argsort by multiple keys; keys[0] is the primary.

    ``lax.sort(num_keys=k, is_stable=True)`` has no single torch call: the
    port chains stable sorts from the least significant key to the most,
    so ties keep the order of the less significant keys and, at the end,
    the row order (ORDER BY results depend on it)."""
    order = torch.sort(keys[-1], stable=True)[1]
    for k in reversed(keys[:-1]):
        order = order[torch.sort(k[order], stable=True)[1]]
    return order


def _inv_permute(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = vals[i] for a permutation `order` (unique
    destinations, so the scatter is deterministic)."""
    out = torch.empty_like(vals)
    out[order] = vals
    return out


def _group_ids(keys: List[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense group ids by one lexicographic sort: (gid int32, order,
    newgrp)."""
    n = keys[0].shape[0]
    dev = keys[0].device
    order = _lexsort_order(keys)
    change = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    for k in keys:
        ks = k[order]
        change |= ks[1:] != ks[:-1]
    diff = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), change])
    gid_sorted = torch.cumsum(diff, 0, dtype=torch.int32) - 1
    gid = _inv_permute(order, gid_sorted)
    return gid, order, diff


def _dense_rank_pair(a: torch.Tensor, b: torch.Tensor):
    """Joint dense rank of two arrays (values aligned across both).
    Ranks are int32 (row counts are always < 2^31)."""
    both = torch.cat([a, b])
    n = both.shape[0]
    s, order = torch.sort(both, stable=True)
    diff = torch.zeros(n, dtype=torch.int32, device=both.device)
    diff[1:] = (s[1:] != s[:-1]).to(torch.int32)
    rank_sorted = torch.cumsum(diff, 0, dtype=torch.int32)
    ranks = _inv_permute(order, rank_sorted)
    return ranks[:a.shape[0]], ranks[a.shape[0]:]


def _narrow_span(c: DCol) -> Optional[Tuple[int, int]]:
    """(lo, hi) when every valid value of ``c`` fits the int32 key
    space (|v| < 2^30), else None.  Strings qualify via dictionary
    size (codes are 0..len-1); int-like kinds need static bounds."""
    if c.ctype.kind == "string":
        nd = 0 if c.dictionary is None else len(c.dictionary)
        return (0, max(nd - 1, 0)) if nd < _NARROW_LIM else None
    if c.ctype.kind in ("int32", "int64", "date", "decimal") and \
            c.bounds is not None:
        lo, hi = c.bounds
        if -_NARROW_LIM < lo and hi < _NARROW_LIM:
            return (int(lo), int(hi))
    return None


def _key_col(c: DCol, alive: torch.Tensor) -> torch.Tensor:
    """Single-table grouping/sort key in the narrowest dtype: int32
    with int32 sentinels when the value domain fits, else the int64
    (or float64) encoding of :func:`_key_i64`."""
    if c.ctype.kind == "float64":
        return _key_i64(c, alive)
    if _narrow_span(c) is not None:
        data = c.data.to(torch.int32).masked_fill(~c.valid, _NULL32)
        return data.masked_fill(~alive, _DEAD32)
    return _key_i64(c, alive)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class TorchExecutor:
    """Plan executor on torch tensors (jaxexec.JaxExecutor), in one of
    three modes (``eager``, ``discover``, ``replay``: the module note).
    :meth:`execute_to_host` runs a plan eagerly;
    :class:`CompilingExecutor` adds discovery and replay.

    ``n_syncs`` counts the host syncs of the last query: in an eager or
    discovery run each data-dependent capacity (join fan-out,
    compaction), each bounds check, each branch decision and each
    subquery result reads back from the device once; a replay reads back
    once, its guards and its result together.  ``n_memo_hits`` counts the
    memo hits of the last query.

    The plan-subtree memo (jaxexec's ``_tree_cache``) runs each repeated
    Join/Aggregate/SetOp/Window/Distinct/Sort subtree once a query.  It
    keeps a result only when the plan asks for its key again
    (:func:`_memo_uses`), and only until the last of those asks, so a
    fact-sized join output is not held past its consumers.  A subquery
    runs in a memo of its own.  No cached table is written in place; a
    lazy column materializing its view writes the same values."""

    # the segment-sum kernel takes aggregates over at most this many
    # segments (jaxexec._PALLAS_SEGS_MAX, kept so the port routes the same
    # aggregates to its kernel); jaxexec's row limit is lifted, since the
    # CUDA kernel accumulates in int64
    _KERNEL_SEGS_MAX = 32768
    # linearized group ids only below this many key slots (jaxexec's
    # NDSTPU_GROUPBY_DOMAIN default)
    _GROUPBY_DOMAIN_CAP = 1 << 21
    # direct-addressed join tables only below this many key slots
    # (jaxexec's NDSTPU_JOIN_LUT_CAP default)
    _JOIN_LUT_CAP = 1 << 25

    def __init__(self, catalog, device, groupby: str = GROUPBY_DEFAULT):
        if groupby not in GROUPBY_MODES:
            raise ValueError(f"groupby must be one of {GROUPBY_MODES}, "
                             f"got {groupby!r}")
        self.catalog = catalog
        self.device = torch.device(device)
        self.groupby_mode = groupby
        self._device_cache: Dict[str, Tuple[int, DTable]] = {}
        self.n_syncs = 0
        self.n_memo_hits = 0
        # per-query subquery memo: expr ids are only stable within one plan
        self._subq_cache: Dict[int, ex.Expr] = {}
        # per-query plan-subtree memo: key -> result, and key -> the asks
        # for it still to come (the key is dropped after its last)
        self._memo: Dict[str, DTable] = {}
        self._memo_left: Dict[str, int] = {}
        self._memo_values: Optional[Sequence[object]] = None
        # discovery writes the size plan, replay reads it: ("cap", n),
        # ("bool", b) and ("subq", expr) records, in the order the run
        # meets its sync points; replay appends a device guard for each
        self.mode = "eager"
        self._rec: Optional[list] = None
        self._pos = 0
        self._oks: Optional[List[torch.Tensor]] = None

    # -- public --------------------------------------------------------------

    def share_tables(self, other: "TorchExecutor") -> None:
        """Use ``other``'s device copies of the catalog's tables (no
        query writes a cached table), so that a second executor over the
        same catalog uploads none of them again."""
        self._device_cache = dict(other._device_cache)

    def execute_to_host(self, p: lp.Plan) -> Table:
        """Run ``p`` eagerly (exact sizes) and bring its result to the
        host."""
        self._begin(p, "eager")
        try:
            return to_host(self.execute(p))
        finally:
            self._end()

    def _begin(self, p: lp.Plan, mode: str,
               values: Optional[Sequence[object]] = None) -> None:
        """Reset the per-query state for one run of ``p`` in ``mode``
        (under a binding's ``values``, for a parameterized plan)."""
        self.mode = mode
        self.n_syncs = self.n_memo_hits = 0
        self._subq_cache = {}
        self._memo_values = values
        self._memo, self._memo_left = {}, _memo_uses(p, values)

    def _end(self) -> None:
        self.mode = "eager"
        self._memo, self._memo_left = {}, {}

    def execute(self, p: lp.Plan) -> DTable:
        key = _memo_key(p, self._memo_values) if self._memo_left else None
        if key not in self._memo_left:
            return self._execute_node(p)
        self._memo_left[key] -= 1
        out = self._memo.get(key)
        if out is None:
            out = self._memo[key] = self._execute_node(p)
        else:
            self.n_memo_hits += 1
            if self._memo_left[key] == 0:
                del self._memo[key], self._memo_left[key]
        return out

    def _execute_node(self, p: lp.Plan) -> DTable:
        node = type(p).__name__
        m = getattr(self, "_exec_" + node.lower(), None)
        if m is None:
            raise Unsupported(f"plan node {node} is not ported yet",
                              node=node)
        try:
            return m(p)
        except Unsupported as u:
            if u.node is None:
                u.node = node
            raise

    # -- sync points -----------------------------------------------------------

    def _pop(self, tag: str):
        """The next size-plan record of a replay, which must be ``tag``."""
        j = self._pos
        self._pos += 1
        if j >= len(self._rec) or self._rec[j][0] != tag:
            raise _Drift(f"size-plan drift (expected {tag})")
        return self._rec[j][1]

    def _capacity_for(self, count):
        """The capacity of a data-dependent output count, and the count:
        ``(capacity, count)``.  An eager run syncs the count and sizes
        exactly (at least 1); discovery syncs it, pads it to its
        :func:`size_class` and records that; replay takes the recorded
        capacity and guards ``count <= capacity`` on the device, where the
        count stays and still drives the alive masks."""
        if self.mode == "replay":
            cap = self._pop("cap")
            self._oks.append(count <= cap)
            return cap, count
        n = int(count)
        self.n_syncs += 1
        if self.mode == "discover":
            cap = size_class(n)
            self._rec.append(("cap", cap))
            return cap, n
        return max(n, 1), n

    def _branch_bool(self, flag) -> bool:
        """A branch decision: synced (and in discovery recorded), or in
        replay the recorded one, guarded on the device."""
        if self.mode == "replay":
            val = self._pop("bool")
            self._oks.append(flag == val)
            return val
        b = bool(flag)
        self.n_syncs += 1
        if self.mode == "discover":
            self._rec.append(("bool", b))
        return b

    # -- subqueries ----------------------------------------------------------

    def _resolve_subqueries(self, e: ex.Expr) -> ex.Expr:
        """Replace each subquery in ``e`` by its result: a scalar
        subquery by a literal, an IN subquery by an IN-list.  The
        sub-plan runs eagerly, in discovery too (its own sync points stay
        out of the size plan), and its result crosses to the host once
        (one sync); discovery records the result and replay takes it from
        the record without running the sub-plan.  The canonicalizer keeps
        every literal inside a subquery in the cache key (NDS402), and a
        catalog version change rediscovers, so a recorded result holds
        for every replay of its plan."""
        if isinstance(e, ex.SubqueryExpr):
            hit = self._subq_cache.get(id(e))
            if hit is not None:
                return hit
            if self.mode == "replay":
                out = self._subq_cache[id(e)] = self._pop("subq")
                return out
            # a memo of its own (jaxexec isolates it the same way): no
            # main-plan subtree may hit a table cached while a subquery
            # ran, or a compiled replay, which skips subqueries, would
            # fall out of step with its discovery
            outer = (self._memo, self._memo_left, self._memo_values,
                     self.mode)
            self._memo, self._memo_left = {}, _memo_uses(e.plan)
            self._memo_values, self.mode = None, "eager"
            try:
                with _consts_bound(None), _params_bound(None):
                    t = to_host(self.execute(e.plan))
            finally:
                (self._memo, self._memo_left, self._memo_values,
                 self.mode) = outer
            self.n_syncs += 1
            col = t.columns[t.column_names[0]]
            if e.kind == "scalar":
                if t.num_rows == 0:
                    out = ex.Literal(None, col.ctype)
                else:
                    vals = col.to_pylist()
                    if len(vals) > 1:
                        raise RuntimeError("scalar subquery returned >1 row")
                    out = ex.Literal(vals[0], col.ctype)
            elif e.kind == "in":
                pyvals = col.to_pylist()
                has_null = any(v is None for v in pyvals)
                vals = tuple(v for v in pyvals if v is not None)
                if e.negated and has_null:
                    out = ex.Literal(False)
                else:
                    out = ex.InList(self._resolve_subqueries(e.operand),
                                    vals, e.negated)
            else:
                raise Unsupported(f"subquery kind {e.kind}", code="NDS211")
            if self.mode == "discover":
                self._rec.append(("subq", out))
            self._subq_cache[id(e)] = out
            return out
        if isinstance(e, ex.BinOp):
            return ex.BinOp(e.op, self._resolve_subqueries(e.left),
                            self._resolve_subqueries(e.right))
        if isinstance(e, ex.UnaryOp):
            return ex.UnaryOp(e.op, self._resolve_subqueries(e.operand))
        if isinstance(e, ex.Cast):
            return ex.Cast(self._resolve_subqueries(e.operand), e.target)
        if isinstance(e, ex.Func):
            return ex.Func(e.name, tuple(self._resolve_subqueries(a)
                                         for a in e.args))
        if isinstance(e, ex.Case):
            return ex.Case(
                tuple((self._resolve_subqueries(c),
                       self._resolve_subqueries(v)) for c, v in e.whens),
                self._resolve_subqueries(e.default)
                if e.default is not None else None)
        if isinstance(e, ex.InList):
            return ex.InList(self._resolve_subqueries(e.operand), e.values,
                             e.negated)
        if isinstance(e, ex.InParam):
            return ex.InParam(self._resolve_subqueries(e.operand), e.slot,
                              e.n, e.negated)
        return e

    # -- leaves --------------------------------------------------------------

    def _table_device(self, name: str,
                      columns: Optional[Sequence[str]] = None) -> DTable:
        """The device copy of a catalog table, uploaded at its first use.
        A table held in host memory for this device (the out-of-core
        facts, :meth:`Catalog.on_host`) uploads only ``columns``, added
        to its columns already up: its whole width need not fit.  A use
        served by the copy of the catalog's version counts
        ``engine.cache.device.hit``, an upload ``engine.cache.device.miss``
        (jaxexec's counters)."""
        version = self.catalog.versions.get(name)
        cached = self._device_cache.get(name)
        if cached is not None and cached[0] != version:
            cached = None
        on_host = getattr(self.catalog, "on_host", None)
        if columns is None or on_host is None or \
                not on_host(name, self.device):
            if cached is not None and (columns is None or all(
                    c in cached[1].columns for c in columns)):
                obs.inc("engine.cache.device.hit")
                return cached[1]
            obs.inc("engine.cache.device.miss")
            dt = to_device(self.catalog.get(name), self.device)
            self._device_cache[name] = (version, dt)
            return dt
        t = self.catalog.get(name)
        have = cached[1].columns if cached is not None else {}
        need = [c for c in (list(columns) or t.column_names[:1])
                if c not in have]
        if not need:
            obs.inc("engine.cache.device.hit")
            return cached[1]
        obs.inc("engine.cache.device.miss")
        part = to_device(Table({c: t.column(c) for c in need}), self.device)
        dt = DTable({**have, **part.columns}, part.alive)
        self._device_cache[name] = (version, dt)
        return dt

    def _exec_scan(self, p: lp.Scan) -> DTable:
        cols = None
        if p.columns is not None:
            cols = list(p.columns) or \
                self.catalog.get(p.table).column_names[:1]
        dt = self._table_device(p.table, cols)
        if cols is not None:
            dt = dt.select(cols)
        if p.predicate is not None:
            pred = self._resolve_subqueries(p.predicate)
            mask = JEval(dt).predicate(pred)
            dt = DTable(dt.columns, dt.alive & mask)
        return dt

    def _exec_subqueryalias(self, p: lp.SubqueryAlias) -> DTable:
        dt = self.execute(p.child)
        if p.column_aliases:
            dt = DTable(dict(zip(p.column_aliases, dt.columns.values())),
                        dt.alive)
        return dt

    # -- row ops -------------------------------------------------------------

    def _exec_filter(self, p: lp.Filter) -> DTable:
        dt = self.execute(p.child)
        cond = self._resolve_subqueries(p.condition)
        mask = JEval(dt).predicate(cond)
        return DTable(dt.columns, dt.alive & mask)

    def _exec_project(self, p: lp.Project) -> DTable:
        dt = self.execute(p.child)
        evl = JEval(dt)
        cols = {}
        for name, e in p.exprs:
            cols[name] = evl.eval(self._resolve_subqueries(e))
        return DTable(cols, dt.alive)

    def _exec_limit(self, p: lp.Limit) -> DTable:
        dt = self.compact(self.execute(p.child))
        cap = dt.capacity
        keep = _iota(cap, self.device) < min(p.n, cap)
        return DTable(dt.columns, dt.alive & keep)

    def compact(self, dt: DTable) -> DTable:
        """Gather alive rows to the front (order-preserving); one sync
        point for the new capacity."""
        return self._compact_n(dt)[0]

    def _compact_n(self, dt: DTable):
        """:meth:`compact` and the number of alive rows it found (a host
        int, or in replay a device scalar)."""
        cap, n_alive = self._capacity_for(
            torch.sum(dt.alive, dtype=torch.int64))
        idx = _nonzero_static(dt.alive, cap)
        alive = _iota(cap, self.device) < n_alive
        return DTable(_gather_cols(dt.columns, idx, alive), alive), n_alive

    # -- sort ----------------------------------------------------------------

    def _order_key(self, evl: JEval, c: DCol, asc: bool,
                   nulls_first: Optional[bool]) -> torch.Tensor:
        if nulls_first is None:
            nulls_first = asc
        alive = evl.t.alive
        if c.ctype.kind == "float64":
            data = c.data.to(torch.float64)
            key = data if asc else -data
            key = key.masked_fill(~c.valid, -float("inf") if nulls_first
                                  else float("inf"))
            # dead rows strictly last
            return key.masked_fill(~alive, float("inf"))
        if _narrow_span(c) is not None:
            # int32 order key (dictionary codes already collate — the
            # dictionaries are sorted)
            data = c.data.to(torch.int32)
            key = data if asc else -data
            key = key.masked_fill(~c.valid,
                                  _NULL32 if nulls_first else -_NULL32)
            return key.masked_fill(~alive, _ORD_DEAD32)
        # widen first: the int64 sentinels do not fit an int32 column
        data = c.data.to(torch.int64)
        key = data if asc else -data
        key = key.masked_fill(~c.valid,
                              _NULL_KEY if nulls_first else -_NULL_KEY)
        return key.masked_fill(~alive, _DEAD_KEY)

    def _exec_sort(self, p: lp.Sort) -> DTable:
        dt = self.execute(p.child)
        evl = JEval(dt)
        keys = []
        for entry in p.keys:
            e, asc = entry[0], entry[1]
            nf = entry[2] if len(entry) > 2 else None
            keys.append(self._order_key(
                evl, evl.eval(self._resolve_subqueries(e)), asc, nf))
        order = _lexsort_order(keys)
        return dt.gather(order, dt.alive[order])

    # -- aggregate -----------------------------------------------------------

    def _exec_aggregate(self, p: lp.Aggregate) -> DTable:
        for _, e in p.aggs:
            self._check_agg_supported(e)
        dt = self.execute(p.child)
        if p.grouping_sets is None:
            return self._aggregate_once(dt, p, None)
        parts = self._grouping_sets_partials(dt, p)
        if parts is None:
            # aggregates that do not recombine (stddev, ...): one full
            # pass over the child per set
            parts = [self._aggregate_once(dt, p, subset)
                     for subset in p.grouping_sets]
        # each set's groups compacted before the concatenation: a set's
        # table has the capacity of its input, and a rollup of n keys
        # would otherwise stack n + 1 of them
        parts = [self.compact(t) for t in parts]
        cols: Dict[str, DCol] = {}
        for n in parts[0].column_names:
            cs = [t.columns[n] for t in parts]
            bounds = None
            if all(c.bounds is not None for c in cs):
                bounds = (min(c.bounds[0] for c in cs),
                          max(c.bounds[1] for c in cs))
            cols[n] = DCol(torch.cat([c.data for c in cs]),
                           torch.cat([c.valid for c in cs]),
                           cs[0].ctype, cs[0].dictionary, bounds)
        return DTable(cols, torch.cat([t.alive for t in parts]))

    def _grouping_sets_partials(self, dt: DTable,
                                p: lp.Aggregate) -> Optional[list]:
        """Grouping sets via decomposable partials
        (jaxexec._grouping_sets_partials): ONE finest-grain aggregation
        over the child, compacted, then each set re-aggregated from that
        partial table.  Returns None when an aggregate does not recombine
        (distinct, stddev) or an aggregate expression holds a node the
        rewrite cannot walk; the caller then runs one pass per set.

        Leaves are keyed by :func:`_plan_fp`, not ``repr``: two aggregates
        differing only in a literal's type must not share a partial.  The
        two-stage sum reorders float64 summation against the one-pass
        path, within the 1e-5 relative tolerance floats are held to."""
        leaves: Dict[str, ex.AggExpr] = {}
        for _name, e in p.aggs:
            for node in e.walk():
                if isinstance(node, ex.AggExpr):
                    if node.distinct or node.func not in GS_COMBINABLE_AGGS:
                        return None
                    leaves.setdefault(_plan_fp(node), node)
        # finest-grain partials: sum + count for sum/avg, the function
        # itself for count/min/max (counts recombine by sum, min/max by
        # min/max; a sum of sums is NULL iff no row was valid, because a
        # finest partial with no valid row is itself NULL)
        fine_aggs: List[tuple] = []
        combine: Dict[str, ex.Expr] = {}
        for i, (rkey, a) in enumerate(leaves.items()):
            if a.func in ("sum", "avg"):
                sname = f"__gs{i}s"
                fine_aggs.append((sname, ex.AggExpr("sum", a.arg)))
                if a.func == "sum":
                    combine[rkey] = ex.AggExpr("sum", ex.ColumnRef(sname))
                else:
                    cname = f"__gs{i}c"
                    fine_aggs.append((cname, ex.AggExpr("count", a.arg)))
                    # avg = total sum / total count; the cast descales a
                    # decimal exactly as _agg_column's avg does
                    combine[rkey] = ex.BinOp(
                        "/",
                        ex.Cast(ex.AggExpr("sum", ex.ColumnRef(sname)),
                                FLOAT64),
                        ex.Cast(ex.AggExpr("sum", ex.ColumnRef(cname)),
                                FLOAT64))
            elif a.func == "count":
                cname = f"__gs{i}c"
                fine_aggs.append((cname, ex.AggExpr("count", a.arg)))
                combine[rkey] = ex.AggExpr("sum", ex.ColumnRef(cname))
            else:  # min / max
                mname = f"__gs{i}m"
                fine_aggs.append((mname, ex.AggExpr(a.func, a.arg)))
                combine[rkey] = ex.AggExpr(a.func, ex.ColumnRef(mname))

        def rebuild(node: ex.Expr) -> Optional[ex.Expr]:
            """``node`` over the partials' columns; None where the
            rewrite cannot walk it."""
            if isinstance(node, ex.AggExpr):
                return combine[_plan_fp(node)]
            if isinstance(node, (ex.Literal, ex.Param)) or (
                    isinstance(node, ex.Func) and node.name == "grouping"):
                return node     # grouping() is static per set
            if isinstance(node, ex.BinOp):
                kids = [rebuild(node.left), rebuild(node.right)]
                return None if _any_none(kids) else ex.BinOp(node.op, *kids)
            if isinstance(node, ex.Cast):
                kid = rebuild(node.operand)
                return None if kid is None else ex.Cast(kid, node.target)
            if isinstance(node, ex.Func):
                kids = [rebuild(x) for x in node.args]
                return None if _any_none(kids) else ex.Func(node.name,
                                                            tuple(kids))
            if isinstance(node, ex.Case):
                whens = [(rebuild(c), rebuild(v)) for c, v in node.whens]
                default = rebuild(node.default) \
                    if node.default is not None else None
                if _any_none([x for w in whens for x in w]) or (
                        node.default is not None and default is None):
                    return None
                return ex.Case(tuple(whens), default)
            return None

        set_aggs = [(name, rebuild(e)) for name, e in p.aggs]
        if _any_none([e for _, e in set_aggs]):
            return None
        p_fine = lp.Aggregate(p.child, p.group_by, fine_aggs, None)
        ft = self.compact(self._aggregate_once(dt, p_fine, None))
        set_group_by = [(n, ex.ColumnRef(n)) for n, _ in p.group_by]
        p_set = lp.Aggregate(p.child, set_group_by, set_aggs, None)
        return [self._aggregate_once(ft, p_set, subset)
                for subset in p.grouping_sets]

    def _check_agg_supported(self, e: ex.Expr):
        for node in e.walk():
            if isinstance(node, ex.AggExpr):
                if node.distinct and node.func not in DISTINCT_AGG_FUNCS:
                    raise Unsupported(
                        f"distinct aggregate {node.func} on device",
                        code="NDS207")
                if node.func not in SUPPORTED_AGG_FUNCS:
                    raise Unsupported(f"aggregate {node.func}",
                                      code="NDS207")

    def _aggregate_once(self, dt: DTable, p: lp.Aggregate,
                        subset: Optional[List[int]]) -> DTable:
        """One aggregation of ``dt`` by ``p``'s keys; with ``subset``
        (one grouping set) the keys outside it are all NULL."""
        evl = JEval(dt)
        cap = dt.capacity
        key_cols = []
        for i, (name, e) in enumerate(p.group_by):
            c = evl.eval(self._resolve_subqueries(e))
            if subset is not None and i not in subset:
                # rolled up in this set: all NULL, and no bounds, so no
                # stale bound reaches _direct_group_ids
                c = DCol(torch.zeros_like(c.data),
                         torch.zeros(cap, dtype=torch.bool,
                                     device=self.device),
                         c.ctype, c.dictionary)
            key_cols.append((name, c))
        # grouping(key) resolves against this; passed down, not kept on
        # the executor, since a subquery resolved mid-loop runs a nested
        # aggregate of its own
        grouping_ctx = ([n for n, _ in p.group_by], subset)
        use_kernel = False
        direct = None
        if key_cols and self.groupby_mode in ("auto", "kernel"):
            direct = self._direct_group_ids(key_cols, dt.alive)
        if direct is not None:
            gid, ngseg, out_alive, out_cols = direct
            use_kernel = self.groupby_mode == "kernel"
        elif key_cols:
            gid, rep, out_alive = self._sort_groups(
                [c for _, c in key_cols], dt.alive)
            ngseg = cap
            out_cols = _gather_cols(dict(key_cols), rep, out_alive)
        else:
            # keyless (scalar) aggregate: two segments (alive rows 0,
            # dead rows 1)
            gid = torch.where(dt.alive, 0, 1).to(torch.int32)
            ngseg = 2
            out_alive = _iota(2, self.device) == 0
            out_cols = {}
        for name, e in p.aggs:
            out_cols[name] = self._eval_agg(
                dt, evl, self._resolve_subqueries(e), gid, ngseg, out_alive,
                use_kernel, grouping_ctx)
        return DTable(out_cols, out_alive)

    def _sort_groups(self, cols: List[DCol], alive: torch.Tensor):
        """Group ids by one sort over ``cols``: (gid, each group's
        representative row, the first of the group in sorted order, and
        the group table's alive mask, one slot per group that has a live
        row), all at the input's capacity."""
        cap = int(alive.shape[0])
        gid, order, newgrp = _group_ids([_key_col(c, alive) for c in cols])
        gid_sorted = torch.cumsum(newgrp, 0, dtype=torch.int64) - 1
        first_pos = torch.full((cap,), cap, dtype=torch.int64,
                               device=self.device)
        first_pos.scatter_reduce_(0, gid_sorted,
                                  _iota(cap, self.device, torch.int64),
                                  "amin")
        rep = order[torch.clamp(first_pos, 0, cap - 1)]
        galive = _segment_sum(alive.to(torch.int32), gid, cap) > 0
        slot_used = torch.zeros(cap, dtype=torch.bool, device=self.device)
        slot_used.index_fill_(0, gid.long(), True)
        return gid, rep, slot_used & galive

    def _direct_group_ids(self, key_cols, alive):
        """Linearized group ids for small host-known key domains.

        When every group key is dictionary-coded or carries static
        bounds, the (keys) tuple maps bijectively to a mixed-radix index
        over ``domain = prod(span_i + 1)`` slots (+1 = a NULL slot per
        key), so dense group ids need NO sort and segment reductions run
        over ``domain`` slots.  Returns None when ineligible; then the
        sort-based path runs.  The mixed-radix gid stays int32 (the
        domain is below 2^31; torch keeps int32 under Python-int
        arithmetic)."""
        parts = []
        domain = 1
        for _name, c in key_cols:
            if c.dictionary is not None and c.ctype.kind == "string":
                lo, span = 0, len(c.dictionary)
            elif c.bounds is not None and c.ctype.kind in (
                    "int32", "int64", "date", "decimal"):
                lo, hi = c.bounds
                span = hi - lo + 1
            else:
                return None
            if span <= 0:
                return None
            domain *= span + 1
            if domain > self._GROUPBY_DOMAIN_CAP or domain >= 2 ** 31 - 1:
                return None
            parts.append((c, lo, span))
        cap = int(alive.shape[0])
        gid = torch.zeros(cap, dtype=torch.int32, device=self.device)
        # bounds-invariant guard: a valid value outside its static bounds
        # means a DCol constructor copied bounds across a value-changing
        # transform — route the row to the trash slot (visibly dropped)
        row_ok = torch.ones(cap, dtype=torch.bool, device=self.device)
        for c, lo, span in parts:
            if -(2 ** 31) < lo and lo + span - 1 < 2 ** 31 and \
                    c.data.dtype == torch.int32:
                raw = c.data - lo
                row_ok = row_ok & (~c.valid | ((raw >= 0) & (raw < span)))
                idx = torch.clamp(raw, 0, span - 1)
            else:
                raw64 = c.data.to(torch.int64) - lo
                row_ok = row_ok & (~c.valid |
                                   ((raw64 >= 0) & (raw64 < span)))
                idx = torch.clamp(raw64, 0, span - 1).to(torch.int32)
            idx = idx.masked_fill(~c.valid, span)     # NULL slot per key
            gid = gid * (span + 1) + idx
        # dead / bounds-violating rows -> trash slot
        bad = torch.sum(alive & ~row_ok)
        if self._branch_bool(bad > 0):
            n_bad = "some" if self.mode == "replay" else int(bad)
            warnings.warn(
                f"group-by bounds invariant violated: "
                f"{n_bad} valid rows fell outside static "
                f"key bounds and were dropped (upstream bounds-"
                f"propagation bug)", stacklevel=2)
        gid = gid.masked_fill(~(alive & row_ok), domain)
        ngseg = domain + 1
        counts = _segment_sum(alive.to(torch.int32), gid, ngseg)
        out_alive = (counts > 0) & (_iota(ngseg, self.device) != domain)
        # reconstruct key values from the slot index (bijective mapping)
        rem = _iota(ngseg, self.device, torch.int64)
        idxs = []
        for c, lo, span in reversed(parts):
            idxs.append(rem % (span + 1))
            rem = rem // (span + 1)
        idxs.reverse()
        out_cols: Dict[str, DCol] = {}
        for (name, c), (c2, lo, span), idx in zip(key_cols, parts, idxs):
            vout = (idx != span) & out_alive
            data = (lo + torch.clamp(idx, 0, span - 1)).to(c.data.dtype)
            out_cols[name] = DCol(data, vout, c.ctype, c.dictionary,
                                  (lo, lo + span - 1))
        return gid, ngseg, out_alive, out_cols

    def _eval_agg(self, dt: DTable, evl: JEval, e: ex.Expr, gid, ngseg,
                  out_alive, use_kernel: bool, grouping_ctx) -> DCol:
        if isinstance(e, ex.AggExpr):
            return self._agg_column(dt, evl, e, gid, ngseg, use_kernel)
        if isinstance(e, ex.Func) and e.name == "grouping":
            # grouping(key) = 0 when the key takes part in this grouping
            # set, 1 when it is rolled up (Spark semantics)
            names, subset = grouping_ctx
            arg = e.args[0]
            idx = names.index(arg.name) if isinstance(
                arg, ex.ColumnRef) and arg.name in names else -1
            active = subset is None or idx in subset
            return DCol(torch.full((ngseg,), 0 if active else 1,
                                   dtype=torch.int32, device=self.device),
                        torch.ones(ngseg, dtype=torch.bool,
                                   device=self.device), INT32)
        if isinstance(e, (ex.BinOp, ex.Cast, ex.Func, ex.Case, ex.Literal,
                          ex.Param)):
            # expression over aggregates: evaluate leaves then combine on
            # the group-capacity table
            sub_cols: Dict[str, DCol] = {}
            counter = [0]

            def lower(node: ex.Expr) -> ex.Expr:
                if isinstance(node, ex.AggExpr):
                    name = f"__agg{counter[0]}"
                    counter[0] += 1
                    sub_cols[name] = self._agg_column(
                        dt, evl, node, gid, ngseg, use_kernel)
                    return ex.ColumnRef(name)
                if isinstance(node, ex.Func) and node.name == "grouping":
                    name = f"__agg{counter[0]}"
                    counter[0] += 1
                    sub_cols[name] = self._eval_agg(
                        dt, evl, node, gid, ngseg, out_alive, use_kernel,
                        grouping_ctx)
                    return ex.ColumnRef(name)
                if isinstance(node, ex.BinOp):
                    return ex.BinOp(node.op, lower(node.left),
                                    lower(node.right))
                if isinstance(node, ex.Cast):
                    return ex.Cast(lower(node.operand), node.target)
                if isinstance(node, ex.Func):
                    return ex.Func(node.name,
                                   tuple(lower(a) for a in node.args))
                if isinstance(node, ex.Case):
                    return ex.Case(
                        tuple((lower(c), lower(v)) for c, v in node.whens),
                        lower(node.default)
                        if node.default is not None else None)
                return node

            lowered = lower(e)
            gtable = DTable(sub_cols, out_alive) if sub_cols else DTable(
                {"__x": DCol(torch.zeros(ngseg, dtype=torch.int32,
                                         device=self.device),
                             torch.ones(ngseg, dtype=torch.bool,
                                        device=self.device), INT32)},
                out_alive)
            return JEval(gtable).eval(lowered)
        raise Unsupported(f"aggregate output {type(e).__name__}",
                          code="NDS208")

    def _kernel_sum_ok(self, c: DCol, ngseg: int) -> bool:
        """jaxexec._pallas_sum_ok's segment, type and precision gates:
        exact while every |value| < 2^41."""
        if ngseg > self._KERNEL_SEGS_MAX:
            return False
        if c.ctype.kind == "int32":
            return True
        if c.ctype.kind == "decimal":
            return c.ctype.precision <= 12      # |v| < 10^12 < 2^41
        if c.ctype.kind == "int64":
            return c.bounds is not None and \
                max(abs(c.bounds[0]), abs(c.bounds[1])) < (1 << 41)
        return False

    def _agg_column(self, dt: DTable, evl: JEval, a: ex.AggExpr, gid,
                    ngseg, use_kernel: bool) -> DCol:
        func = a.func
        alive = dt.alive
        ones = torch.ones(ngseg, dtype=torch.bool, device=self.device)
        if a.distinct and func in ("count", "sum", "avg") and \
                not isinstance(a.arg, ex.Star):
            # distinct is a no-op for min/max; count/sum/avg count each
            # (group, value) pair once
            return self._agg_distinct(dt, evl, a, gid, ngseg)
        if isinstance(a.arg, ex.Star):
            counts = _segment_sum(alive.to(torch.int32), gid, ngseg)
            return DCol(counts.to(torch.int64), ones, INT64)
        c = evl.eval(a.arg)
        valid = c.valid & alive
        if use_kernel and func in ("sum", "avg") and \
                self._kernel_sum_ok(c, ngseg):
            # exact int64 sums + counts in one pass of the segment-sum
            # kernel (its plain version for CPU tensors)
            sums, cnts = segsum.segment_sum_decimal(
                c.data.to(torch.int64).contiguous(), gid.contiguous(),
                valid.contiguous(), ngseg)
            if func == "sum":
                if c.ctype.kind == "decimal":
                    return DCol(sums, cnts > 0, decimal(38, c.ctype.scale))
                return DCol(sums, cnts > 0, INT64)
            data = sums.to(torch.float64) / torch.clamp(cnts, min=1)
            if c.ctype.kind == "decimal":
                data = _true_div(data, 10 ** c.ctype.scale)
            return DCol(data, cnts > 0, FLOAT64)
        if func == "count":
            counts = _segment_sum(valid.to(torch.int32), gid, ngseg)
            return DCol(counts.to(torch.int64), ones, INT64)
        if func == "sum":
            got = _segment_sum(valid.to(torch.int32), gid, ngseg) > 0
            sums = _typed_sum(c.data, valid, c.ctype.kind, gid, ngseg)
            if c.ctype.kind == "decimal":
                return DCol(sums, got, decimal(38, c.ctype.scale))
            if c.ctype.kind in ("int32", "int64"):
                return DCol(sums, got, INT64)
            return DCol(sums, got, FLOAT64)
        if func == "avg":
            cnts = _segment_sum(valid.to(torch.int32), gid, ngseg)
            sums = _typed_sum(c.data, valid, c.ctype.kind, gid, ngseg)
            data = sums.to(torch.float64) / torch.clamp(cnts, min=1)
            if c.ctype.kind == "decimal":
                data = _true_div(data, 10 ** c.ctype.scale)
            return DCol(data, cnts > 0, FLOAT64)
        if func in ("min", "max"):
            got = _segment_sum(valid.to(torch.int32), gid, ngseg) > 0
            reduce = "amin" if func == "min" else "amax"
            if c.ctype.kind == "float64":
                init = float("inf") if func == "min" else -float("inf")
                vals = c.data.masked_fill(~valid, init)
                out = torch.full((ngseg,), init, dtype=vals.dtype,
                                 device=self.device)
                out.scatter_reduce_(0, gid.long(), vals, reduce)
                return DCol(out, got, c.ctype)
            vals = _minmax_vals(c.data, valid, c.ctype.kind, func == "min")
            info = torch.iinfo(vals.dtype)
            out = torch.full((ngseg,), info.max if func == "min"
                             else info.min, dtype=vals.dtype,
                             device=self.device)
            out.scatter_reduce_(0, gid.long(), vals, reduce)
            return DCol(out.to(c.data.dtype), got, c.ctype,
                        c.dictionary, c.bounds)
        if func in ("stddev_samp", "var_samp", "stddev", "variance"):
            # shifted two-pass moments: center by the group mean so
            # E[x^2]-E[x]^2 cancellation cannot eat the variance when
            # mean >> stddev; the (sum d)^2/n term corrects the mean's own
            # rounding
            x = evl.cast(c, FLOAT64).data
            xv = x.masked_fill(~valid, 0.0)
            cnt = _segment_sum(valid.to(torch.int32), gid, ngseg)
            s1 = fp64.segment_sum_compensated(xv, gid, ngseg)
            mean = s1 / torch.clamp(cnt, min=1)
            d = torch.where(valid, x - mean[gid], 0.0)
            d1, d2 = fp64.segment_sum_compensated2(d, d * d, gid, ngseg)
            ok = cnt > 1
            denom = torch.where(ok, cnt - 1, 1)
            var = torch.clamp(
                d2 - torch.where(cnt > 0, d1 * d1 / torch.clamp(cnt, min=1),
                                 0.0), min=0.0) / denom
            data = var if func in ("var_samp", "variance") else \
                torch.sqrt(var)
            return DCol(data, ok, FLOAT64)
        raise Unsupported(f"aggregate {func}", code="NDS207")

    # presence-bitmap distinct: ngseg x domain slots (jaxexec's
    # _DISTINCT_BITMAP_SLOTS); 1 << 22 int32 slots are 16 MiB, freed with
    # the aggregate
    _DISTINCT_BITMAP_SLOTS = 1 << 22

    def _agg_distinct(self, dt: DTable, evl: JEval, a: ex.AggExpr, gid,
                      ngseg: int) -> DCol:
        """count/sum/avg(DISTINCT x) (jaxexec._agg_distinct).

        An int or decimal column with static bounds whose ``ngseg x
        domain`` slots fit :attr:`_DISTINCT_BITMAP_SLOTS` takes a presence
        bitmap (:meth:`_agg_distinct_bitmap`), no sort.  The choice reads
        only static metadata (kind, bounds, ``ngseg``), so a compiled
        replay makes the same one.  Everything else sorts by (group,
        value), keeps the first row of each distinct pair and sums by
        segment: decimal and int sums exact in int64, float sums in
        float64."""
        func = a.func
        c = evl.eval(a.arg)
        valid = c.valid & dt.alive
        if c.ctype.kind in ("decimal", "int32", "int64") and \
                c.bounds is not None:
            lo, hi = c.bounds
            domain = int(hi - lo + 1)
            if 0 < domain and \
                    ngseg * domain <= self._DISTINCT_BITMAP_SLOTS:
                return self._agg_distinct_bitmap(c, valid, gid, ngseg, lo,
                                                 domain, func)
        vkey = _key_col(c, dt.alive)
        order = _lexsort_order([gid, vkey])
        gid_s, vkey_s = gid[order], vkey[order]
        first = torch.ones(dt.capacity, dtype=torch.bool, device=self.device)
        first[1:] = (gid_s[1:] != gid_s[:-1]) | (vkey_s[1:] != vkey_s[:-1])
        uniq = first & valid[order]
        cnts = _segment_sum(uniq.to(torch.int64), gid_s, ngseg)
        if func == "count":
            return DCol(cnts, torch.ones(ngseg, dtype=torch.bool,
                                         device=self.device), INT64)
        data_s = c.data[order]
        if c.ctype.kind in ("decimal", "int32", "int64"):
            sums = _segment_sum(data_s.to(torch.int64).masked_fill(~uniq, 0),
                                gid_s, ngseg)
        else:
            sums = _segment_sum(
                data_s.to(torch.float64).masked_fill(~uniq, 0.0), gid_s,
                ngseg)
        return self._distinct_result(c, func, sums, cnts)

    def _agg_distinct_bitmap(self, c: DCol, valid, gid, ngseg: int,
                             lo: int, domain: int, func: str) -> DCol:
        """Distinct (group, value) pairs as a presence bitmap of ``ngseg
        x domain`` slots: each row marks slot ``gid * domain + value -
        lo`` (computed in int64), rows that are invalid or outside the
        bounds mark a trash slot; counts and sums are row reductions of
        the bitmap.  Every row writes the same value to a slot, so the
        marks need no atomics and come out the same in any order."""
        raw = c.data.to(torch.int64) - lo
        use = valid & (raw >= 0) & (raw < domain)
        idx = gid.to(torch.int64) * domain + torch.clamp(raw, 0, domain - 1)
        idx = idx.masked_fill(~use, ngseg * domain)     # trash slot
        seen = torch.zeros(ngseg * domain + 1, dtype=torch.int32,
                           device=self.device)
        seen[idx] = use.to(torch.int32)
        seen2 = seen[:-1].view(ngseg, domain)
        cnts = seen2.sum(dim=1, dtype=torch.int64)
        if func == "count":
            return DCol(cnts, torch.ones(ngseg, dtype=torch.bool,
                                         device=self.device), INT64)
        slot_vals = lo + _iota(domain, self.device, torch.int64)
        sums = (seen2.to(torch.int64) * slot_vals[None, :]).sum(dim=1)
        return self._distinct_result(c, func, sums, cnts)

    @staticmethod
    def _distinct_result(c: DCol, func: str, sums: torch.Tensor,
                         cnts: torch.Tensor) -> DCol:
        """sum or avg of the distinct values from their per-segment sums
        (int64 for decimal and int arguments, float64 otherwise) and
        counts, typed as the reference types them."""
        got = cnts > 0
        if func == "sum":
            if c.ctype.kind == "decimal":
                return DCol(sums, got, decimal(38, c.ctype.scale))
            if c.ctype.kind in ("int32", "int64"):
                return DCol(sums, got, INT64)
            return DCol(sums, got, FLOAT64)
        mean = sums.to(torch.float64) / torch.clamp(cnts, min=1)
        if c.ctype.kind == "decimal":
            mean = _true_div(mean, 10 ** c.ctype.scale)
        return DCol(mean, got, FLOAT64)

    # -- window --------------------------------------------------------------

    def _exec_window(self, p: lp.Window) -> DTable:
        # compacted first (one counted sync): the window's sorts, and every
        # operator above it, then see only live rows.  An aggregate's table
        # has the capacity of its input, so a window over an aggregate
        # would otherwise carry the fact table's capacity into a self-join
        # (q47), past the rank pairing's capacity bound
        dt = self.compact(self.execute(p.child))
        out = dict(dt.columns)
        for name, e in p.exprs:
            if not isinstance(e, ex.WindowExpr):
                raise Unsupported("non-window expr in Window node",
                                  code="NDS209")
            out[name] = self._window_column(dt, e)
        return DTable(out, dt.alive)

    def _window_sort(self, pid: torch.Tensor, okeys: List[torch.Tensor]):
        """Rows sorted by (partition, order keys): (order, its inverse,
        sorted positions, the start of each sorted row's partition,
        partition-start flags).  Positions are int64."""
        cap = int(pid.shape[0])
        idx = _iota(cap, self.device, torch.int64)
        order = _lexsort_order([pid] + okeys)
        inv = _inv_permute(order, idx)
        pid_s = pid[order]
        newpart = torch.ones(cap, dtype=torch.bool, device=self.device)
        newpart[1:] = pid_s[1:] != pid_s[:-1]
        pstart = torch.cummax(torch.where(newpart, idx, 0), 0).values
        return order, inv, idx, pstart, newpart

    @staticmethod
    def _ties(order, okeys: List[torch.Tensor], newpart) -> torch.Tensor:
        """Sorted rows equal to the row before on every order key, within
        one partition."""
        t = torch.ones(order.shape[0] - 1, dtype=torch.bool,
                       device=order.device)
        for k in okeys:
            ks = k[order]
            t = t & (ks[1:] == ks[:-1])
        tie = torch.zeros_like(newpart)
        tie[1:] = t & ~newpart[1:]
        return tie

    def _window_column(self, dt: DTable, w: ex.WindowExpr) -> DCol:
        """One window function (jaxexec._window_column): ranks by a sort
        on (partition, order keys); aggregates over the whole partition
        by segment reductions on the partition id, or, with ORDER BY, a
        running frame (:meth:`_running_window`)."""
        cap = dt.capacity
        evl = JEval(dt)
        if w.partition_by:
            pcols = [evl.eval(self._resolve_subqueries(e))
                     for e in w.partition_by]
            pkeys = [_key_col(c, dt.alive) for c in pcols]
        else:
            pkeys = [torch.where(dt.alive, 0, 1).to(torch.int32)]
        pid, _, _ = _group_ids(pkeys)
        okeys = []
        for e, asc in w.order_by:
            c = evl.eval(self._resolve_subqueries(e))
            okeys.append(self._order_key(evl, c, asc, None))
        ones = torch.ones(cap, dtype=torch.bool, device=self.device)
        if w.func in ("row_number", "rank", "dense_rank"):
            order, inv, idx, pstart, newpart = self._window_sort(pid, okeys)
            pos_in_part = idx - pstart
            if w.func == "row_number":
                return DCol((pos_in_part + 1)[inv], ones, INT64)
            tie = self._ties(order, okeys, newpart)
            if w.func == "rank":
                last_nontie = torch.cummax(torch.where(~tie, idx, 0),
                                           0).values
                ranks = pos_in_part[last_nontie] + 1
            else:
                incr = torch.where(newpart, 0, (~tie).to(torch.int64))
                csum = torch.cumsum(incr, 0)
                base = torch.cummax(torch.where(newpart, csum, 0), 0).values
                ranks = csum - base + 1
            return DCol(ranks[inv], ones, INT64)
        # aggregate window: the whole partition without ORDER BY; with
        # ORDER BY an UNBOUNDED PRECEDING..CURRENT ROW frame (Spark's
        # default RANGE: peers share the run's value; ROWS: per row)
        if w.order_by:
            return self._running_window(dt, evl, w, pid, okeys)
        if w.func == "count" and (w.arg is None or
                                  isinstance(w.arg, ex.Star)):
            cnt = _segment_sum(dt.alive.to(torch.int64), pid, cap)
            return DCol(cnt[pid], ones, INT64)
        arg = evl.eval(self._resolve_subqueries(w.arg))
        valid = arg.valid & dt.alive
        cnts = _segment_sum(valid.to(torch.int64), pid, cap)
        got = (cnts > 0)[pid]
        kind = arg.ctype.kind
        if w.func == "count":
            return DCol(cnts[pid], ones, INT64)
        if w.func == "sum":
            tot = _segment_sum(_sum_input(arg.data, valid, kind), pid, cap)
            if kind == "decimal":
                return DCol(tot[pid], got, decimal(38, arg.ctype.scale))
            return DCol(tot[pid], got,
                        INT64 if kind in ("int32", "int64") else FLOAT64)
        if w.func == "avg":
            tot = _segment_sum(_sum_input(arg.data, valid, kind), pid, cap)
            mean = tot.to(torch.float64) / torch.clamp(cnts, min=1)
            if kind == "decimal":
                mean = _true_div(mean, 10 ** arg.ctype.scale)
            return DCol(mean[pid], got, FLOAT64)
        if w.func in ("min", "max"):
            is_min = w.func == "min"
            if kind == "float64":
                init = float("inf") if is_min else -float("inf")
                vals = arg.data.masked_fill(~valid, init)
            else:
                vals = _minmax_vals(arg.data, valid, kind, is_min)
                info = torch.iinfo(vals.dtype)
                init = info.max if is_min else info.min
            out = torch.full((cap,), init, dtype=vals.dtype,
                             device=self.device)
            out.scatter_reduce_(0, pid.long(), vals,
                                "amin" if is_min else "amax")
            return DCol(out[pid].to(arg.data.dtype), got, arg.ctype,
                        arg.dictionary)
        raise Unsupported(f"window {w.func}", code="NDS209")

    def _running_window(self, dt: DTable, evl: JEval, w: ex.WindowExpr,
                        pid: torch.Tensor,
                        okeys: List[torch.Tensor]) -> DCol:
        """UNBOUNDED PRECEDING..CURRENT ROW running aggregate
        (jaxexec._running_window): sort by (partition, order keys), a
        segmented cumulative combine, and under RANGE each row takes the
        value at the end of its tie run."""
        cap = dt.capacity
        order, inv, idx, pstart, newpart = self._window_sort(pid, okeys)
        if w.frame != "rows":
            tie = self._ties(order, okeys, newpart)
            end_marker = torch.ones(cap, dtype=torch.bool,
                                    device=self.device)
            end_marker[:-1] = ~tie[1:]
            # the first run end at or after each row: a reversed cummin
            run_end = torch.flip(torch.cummin(torch.flip(
                torch.where(end_marker, idx, cap), [0]), 0).values, [0])
        else:
            run_end = idx

        def seg_cumsum(x):
            cs = torch.cumsum(x, 0)
            base = torch.where(pstart > 0,
                               cs[torch.clamp(pstart - 1, min=0)], 0)
            return cs - base

        ones = torch.ones(cap, dtype=torch.bool, device=self.device)
        alive_s = dt.alive[order]
        if w.arg is None or isinstance(w.arg, ex.Star):     # count(*)
            run = seg_cumsum(alive_s.to(torch.int64))[run_end]
            return DCol(run[inv], ones, INT64)
        arg = evl.eval(self._resolve_subqueries(w.arg))
        kind = arg.ctype.kind
        valid_s = (arg.valid & dt.alive)[order]
        data_s = arg.data[order]
        rcnt = seg_cumsum(valid_s.to(torch.int64))[run_end]
        got = (rcnt > 0)[inv]
        if w.func == "count":
            return DCol(rcnt[inv], ones, INT64)
        if w.func in ("sum", "avg"):
            run = seg_cumsum(_sum_input(data_s, valid_s, kind))[run_end]
            if w.func == "sum":
                if kind == "decimal":
                    return DCol(run[inv], got, decimal(38, arg.ctype.scale))
                return DCol(run[inv], got,
                            INT64 if kind in ("int32", "int64") else FLOAT64)
            mean = run.to(torch.float64)
            if kind == "decimal":
                mean = _true_div(mean, 10 ** arg.ctype.scale)
            return DCol((mean / torch.clamp(rcnt, min=1))[inv], got, FLOAT64)
        if w.func in ("min", "max"):
            is_min = w.func == "min"
            opfn = torch.minimum if is_min else torch.maximum
            if kind == "float64":
                sent = float("inf") if is_min else -float("inf")
                x = data_s.masked_fill(~valid_s, sent)
            else:
                x = _minmax_vals(data_s, valid_s, kind, is_min)
                info = torch.iinfo(x.dtype)
                sent = info.max if is_min else info.min
            # doubling prefix scan clipped at partition starts: about
            # log2(cap) passes over the column
            out = x
            shift = 1
            while shift < cap:
                cand = torch.cat([torch.full((shift,), sent, dtype=out.dtype,
                                             device=self.device),
                                  out[:-shift]])
                take = (idx - shift) >= pstart
                out = torch.where(take, opfn(out, cand), out)
                shift *= 2
            out = out[run_end][inv]
            if kind != "float64":
                out = out.to(arg.data.dtype)
            return DCol(out, got, arg.ctype, arg.dictionary)
        raise Unsupported(f"running window {w.func}", code="NDS209")

    # -- distinct and set operations ------------------------------------------

    def _exec_distinct(self, p: lp.Distinct) -> DTable:
        return self._distinct_of(self.execute(p.child))

    def _distinct_of(self, dt: DTable) -> DTable:
        """One row per distinct row value (jaxexec._distinct_of): the
        sort group-by over every column, no aggregates.  The result keeps
        its input's capacity and bounds."""
        for c in dt.columns.values():
            if c.ctype.kind not in ("int32", "int64", "decimal", "date",
                                    "string", "bool", "float64"):
                raise Unsupported("distinct column type")
        _, rep, out_alive = self._sort_groups(list(dt.columns.values()),
                                              dt.alive)
        return DTable(_gather_cols(dt.columns, rep, out_alive), out_alive)

    def _exec_setop(self, p: lp.SetOp) -> DTable:
        """UNION [ALL], INTERSECT and EXCEPT (jaxexec._exec_setop) over
        the two sides' vertical concatenation, the right side's columns
        renamed to the left's.  INTERSECT and EXCEPT have distinct
        semantics (Spark): the first left occurrence of each row value
        that is (is not) also on the right."""
        lt = self.execute(p.left)
        rt = self.execute(p.right)
        rt = DTable(dict(zip(lt.column_names, rt.columns.values())),
                    rt.alive)
        both = self._vconcat(lt, rt)
        if p.kind == "union":
            return both if p.all else self._distinct_of(both)
        cap = both.capacity
        keys = [_key_col(c, both.alive) for c in both.columns.values()]
        gid = _group_ids(keys)[0]
        pos = _iota(cap, self.device, torch.int64)
        is_left = pos < lt.capacity
        in_left = _segment_sum((both.alive & is_left).to(torch.int32), gid,
                               cap) > 0
        in_right = _segment_sum((both.alive & ~is_left).to(torch.int32),
                                gid, cap) > 0
        keepg = (in_left & in_right) if p.kind == "intersect" else \
            (in_left & ~in_right)
        lidx = torch.where(both.alive & is_left, pos, cap)
        firstl = torch.full((cap,), cap, dtype=torch.int64,
                            device=self.device)
        firstl.scatter_reduce_(0, gid.to(torch.int64), lidx, "amin")
        keep = (firstl[gid] == pos) & keepg[gid] & both.alive & is_left
        return DTable(both.columns, keep)

    # -- join ----------------------------------------------------------------

    @staticmethod
    def _direct_join_spec(lc: DCol, rc: DCol):
        """Static (lo, span, lmult, rmult) when this key pair can be
        encoded directly from values (no rank-pairing sort): int-like
        kinds on both sides with known bounds, scales aligned by exact
        host-side multipliers.  None -> rank-pair fallback."""
        int_kinds = ("int32", "int64", "date", "decimal")
        if lc.ctype.kind not in int_kinds or rc.ctype.kind not in int_kinds:
            return None
        if lc.bounds is None or rc.bounds is None:
            return None
        ls = lc.ctype.scale if lc.ctype.kind == "decimal" else 0
        rs = rc.ctype.scale if rc.ctype.kind == "decimal" else 0
        s = max(ls, rs)
        lmult, rmult = 10 ** (s - ls), 10 ** (s - rs)
        blo = min(lc.bounds[0] * lmult, rc.bounds[0] * rmult)
        bhi = max(lc.bounds[1] * lmult, rc.bounds[1] * rmult)
        span = bhi - blo + 1
        if span >= 2 ** 62:
            return None
        return (blo, span, lmult, rmult)

    @staticmethod
    def _string_join_spec(lc: DCol, rc: DCol):
        """Static (merged_dict_or_None, span) for a string key pair.
        merged is None when both sides share one dictionary (codes used
        as-is)."""
        if lc.ctype.kind != "string" or rc.ctype.kind != "string":
            return None
        if lc.dictionary is not None and rc.dictionary is not None and \
                len(lc.dictionary) == len(rc.dictionary) and \
                np.array_equal(lc.dictionary, rc.dictionary):
            return (None, max(len(lc.dictionary), 1))
        merged = _merged_dict([lc, rc])
        return (merged, max(len(merged), 1))

    def _join_keys(self, lt: DTable, rt: DTable,
                   keys: List[Tuple[ex.Expr, ex.Expr]]):
        """Composite join keys on both sides (mixed-radix).

        Key pairs whose value domain is statically known (int-like with
        bounds, dictionary-coded strings) are encoded DIRECTLY from
        values — no joint dense-rank.  Only unbounded pairs (raw float64,
        computed columns without bounds) pay the rank-pairing sort.  When
        the final composite bound fits int32 the whole key build runs in
        int32."""
        levl, revl = JEval(lt), JEval(rt)
        lcols = [levl.eval(self._resolve_subqueries(le)) for le, _ in keys]
        rcols = [revl.eval(self._resolve_subqueries(re_))
                 for _, re_ in keys]
        capl, capr = lt.capacity, rt.capacity
        rank_radix = capl + capr + 3
        specs = []
        for lc, rc in zip(lcols, rcols):
            spec = self._direct_join_spec(lc, rc)
            if spec is None and lc.ctype.kind == "string":
                sspec = self._string_join_spec(lc, rc)
                if sspec is not None:
                    spec = ("str",) + sspec
            specs.append(spec)
        # simulate the radix accumulation host-side to pick the key dtype
        bound = 1
        redensified = False
        for spec in specs:
            if spec is None:
                radix = rank_radix
            elif spec[0] == "str":
                radix = spec[2]
            else:
                radix = spec[1]
            if bound * radix >= 2 ** 62:
                redensified = True
                bound = rank_radix
            bound *= radix
        use32 = (not redensified) and bound < 2 ** 31
        kdt = torch.int32 if use32 else torch.int64
        lkey = torch.zeros(capl, dtype=kdt, device=self.device)
        rkey = torch.zeros(capr, dtype=kdt, device=self.device)
        lvalid = torch.ones(capl, dtype=torch.bool, device=self.device)
        rvalid = torch.ones(capr, dtype=torch.bool, device=self.device)
        bound = 1  # exclusive upper bound on current composite key values
        for (lc, rc), spec in zip(zip(lcols, rcols), specs):
            if spec is not None and spec[0] == "str":
                _, merged, span = spec
                la = _translate(lc, merged) if merged is not None \
                    else lc.data
                ra = _translate(rc, merged) if merged is not None \
                    else rc.data
                # invalid codes (<0) clip into range; those rows are
                # overridden by the validity sentinels downstream
                la = torch.clamp(la, 0, span - 1).to(kdt)
                ra = torch.clamp(ra, 0, span - 1).to(kdt)
                radix = span
            elif spec is not None:
                blo, span, lmult, rmult = spec
                radix = span
                # build in int32 only when the aligned value range fits;
                # garbage (dead/invalid) rows may wrap — they are
                # sentinel-overridden downstream
                if use32 and -(2 ** 31) < blo and \
                        blo + span - 1 < 2 ** 31:
                    la = torch.clamp(lc.data.to(torch.int32) * lmult - blo,
                                     0, span - 1)
                    ra = torch.clamp(rc.data.to(torch.int32) * rmult - blo,
                                     0, span - 1)
                else:
                    la = torch.clamp(lc.data.to(torch.int64) * lmult - blo,
                                     0, span - 1).to(kdt)
                    ra = torch.clamp(rc.data.to(torch.int64) * rmult - blo,
                                     0, span - 1).to(kdt)
            else:
                if capl * capr > 2 ** 48:
                    raise Unsupported("join too large for rank pairing")
                la64 = _key_i64(lc, lt.alive, peer=rc)
                ra64 = _key_i64(rc, rt.alive, peer=lc)
                # decimal/int alignment (rank path only; direct path
                # aligns via host multipliers)
                if lc.ctype.kind == "decimal" or rc.ctype.kind == "decimal":
                    ls = lc.ctype.scale if lc.ctype.kind == "decimal" else 0
                    rs = rc.ctype.scale if rc.ctype.kind == "decimal" else 0
                    s = max(ls, rs)
                    la64 = torch.where(torch.abs(la64) < _DEAD_KEY,
                                       la64 * (10 ** (s - ls)), la64)
                    ra64 = torch.where(torch.abs(ra64) < _DEAD_KEY,
                                       ra64 * (10 ** (s - rs)), ra64)
                lr, rr = _dense_rank_pair(la64, ra64)
                la, ra = lr.to(kdt), rr.to(kdt)
                radix = rank_radix
            if bound * radix >= 2 ** 62:
                # re-densify the accumulated composite so mixed-radix
                # never overflows int64, however many join keys there are
                lkey, rkey = _dense_rank_pair(lkey, rkey)
                lkey, rkey = lkey.to(kdt), rkey.to(kdt)
                bound = rank_radix
            lkey = lkey * radix + la
            rkey = rkey * radix + ra
            bound = bound * radix
            lvalid = lvalid & lc.valid
            rvalid = rvalid & rc.valid
        return lkey, rkey, lvalid, rvalid, bound

    def _probe_counts(self, pkey: torch.Tensor, bkey: torch.Tensor,
                      bound: int, need_order: bool = True):
        """Per-probe-row (lo, counts) against the build side, plus the
        build-side stable key order: ``order[lo[i] .. lo[i]+counts[i]-1]``
        are the build rows matching probe row ``i``.

        * ``bound`` small: direct-addressed lookup tables.  Build counts
          via one scatter-add over the key domain, starts via one cumsum,
          probe via two gathers.
        * otherwise: ONE stable sort of concat(build, probe) tagged by
          side; in sorted order, builds-before = prefix count, the run
          start carries lo, and scatters route lo/counts back to probe
          positions and build ranks to `order`.

        Probe rows with key < 0 (sentinels) never match; build rows with
        key < 0 never enter the tables but DO occupy `order` slots (they
        sort first).  Without ``need_order``, ``order`` is None.
        """
        m = int(bkey.shape[0])
        n = int(pkey.shape[0])
        dev = self.device
        if bound is not None and 0 < bound <= min(
                self._JOIN_LUT_CAP, max(8 * (m + n), 1 << 20)):
            span = int(bound)
            bidx = torch.where(bkey >= 0, bkey, span).to(torch.int32)
            cnt_t = torch.zeros(span + 1, dtype=torch.int32, device=dev)
            cnt_t.index_add_(0, bidx, torch.ones(m, dtype=torch.int32,
                                                 device=dev))
            cnt = cnt_t[:span]
            ccnt = torch.cumsum(cnt, 0, dtype=torch.int32)
            # valid build keys sort AFTER the (<0) sentinel rows in the
            # stable key order, so starts are offset by the dead count
            n_dead = torch.sum(bkey < 0, dtype=torch.int32)
            starts = ccnt - cnt + n_dead
            pk = torch.clamp(pkey, 0, span - 1).to(torch.int32)
            hit = pkey >= 0
            counts = torch.where(hit, cnt[pk], 0)
            lo = starts[pk].to(torch.int32)
            order = None
            if need_order:
                okey = torch.where(bkey >= 0, bkey, -1).to(torch.int32)
                order = torch.sort(okey, stable=True)[1]
            return lo, counts, order
        key = torch.cat([bkey, pkey])
        tag = (_iota(m + n, dev) >= m).to(torch.int32)
        sidx = _lexsort_order([key, tag])
        skey, stag = key[sidx], tag[sidx]
        isb = (stag == 0).to(torch.int32)
        builds_le = torch.cumsum(isb, 0, dtype=torch.int32)
        before = builds_le - isb                  # builds strictly before s
        newrun = torch.ones(m + n, dtype=torch.bool, device=dev)
        newrun[1:] = skey[1:] != skey[:-1]
        # `before` is non-decreasing, so cummax propagates each run
        # start's value (builds with key < run key) across the run
        lo_sorted = torch.cummax(torch.where(newrun, before, 0), 0).values
        cnt_sorted = builds_le - lo_sorted        # builds in run up to s
        # build rows -> trash slot n: duplicate destinations there make
        # the scatter non-deterministic, harmless because it is dropped
        dest = torch.where(stag == 1, sidx - m, n)
        lo = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        lo[dest] = lo_sorted
        counts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        counts[dest] = cnt_sorted
        lo, counts = lo[:n], counts[:n]
        counts = torch.where(pkey >= 0, counts, 0)
        if not need_order:
            return lo, counts, None
        bdest = torch.where(isb == 1, builds_le.to(torch.int64) - 1, m)
        order = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        order[bdest] = sidx
        return lo, counts, order[:m]

    @staticmethod
    def _expand_li(counts: torch.Tensor, starts: torch.Tensor,
                   out_cap: int) -> torch.Tensor:
        """Left-row index feeding each expansion output position: scatter
        each emitting row's id at its start position, cummax fills the
        run.  Starts of emitting rows are strictly increasing, so
        destinations are unique.  A start past ``out_cap`` (a replay whose
        binding outgrew the recorded capacity, which its guard reports)
        goes to the trash slot: every index stays in range."""
        cap = int(counts.shape[0])
        dev = counts.device
        starts = starts.to(torch.int64)
        emit = (counts > 0) & (starts < out_cap)
        sdest = torch.where(emit, starts, out_cap)
        rid = torch.where(emit, _iota(cap, dev) + 1, 0)
        tmp = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
        tmp.scatter_reduce_(0, sdest, rid, "amax")
        li = torch.cummax(tmp[:out_cap], 0).values - 1
        return torch.clamp(li, 0, cap - 1)

    def _exec_join(self, p: lp.Join) -> DTable:
        kind = p.kind
        lt = self.execute(p.left)
        rt = self.execute(p.right)
        extra = self._resolve_subqueries(p.extra) \
            if p.extra is not None else None
        if kind == "cross" or not p.keys:
            if kind not in ("cross", "inner"):
                raise Unsupported(f"non-equi {kind} join", code="NDS210")
            return self._cross_join(lt, rt, extra)
        if kind == "right":
            out = self._equi_join(rt, lt, [(r, l) for l, r in p.keys],
                                  "left", extra)
            return out.select(list(lt.columns) + list(rt.columns))
        if kind == "full":
            return self._full_join(lt, rt, p.keys, extra)
        if kind == "mark":
            return self._equi_join(lt, rt, p.keys, kind, extra, mark=p.mark)
        return self._equi_join(lt, rt, p.keys, kind, extra)

    def _cross_join(self, lt: DTable, rt: DTable, extra) -> DTable:
        ltc = self.compact(lt)
        rtc = self.compact(rt)
        nl = torch.sum(ltc.alive, dtype=torch.int64)
        nr = torch.sum(rtc.alive, dtype=torch.int64)
        out_cap, total = self._capacity_for(nl * nr)
        pos = _iota(out_cap, self.device, torch.int64)
        nr_safe = torch.clamp(nr, min=1)
        li = torch.clamp(pos // nr_safe, max=ltc.capacity - 1)
        ri = torch.clamp(pos % nr_safe, max=rtc.capacity - 1)
        alive = pos < total
        lcols = _gather_cols(ltc.columns, li, alive)
        rcols = _gather_cols(rtc.columns, ri, alive)
        out = DTable({**lcols, **rcols}, alive)
        if extra is not None:
            mask = JEval(out).predicate(extra)
            out = DTable(out.columns, out.alive & mask)
        return out

    def _full_join(self, lt: DTable, rt: DTable, keys, extra) -> DTable:
        left_part = self._equi_join(lt, rt, keys, "left", extra)
        # right rows with no key match (residual predicate excluded, as in
        # the reference interpreter's full-join path)
        lkey, rkey, lvalid, rvalid, bound = self._join_keys(lt, rt, keys)
        lkey = lkey.masked_fill(~(lvalid & lt.alive), -1)
        rkey = rkey.masked_fill(~(rvalid & rt.alive), -2)
        _, rcounts, _ = self._probe_counts(rkey, lkey, bound,
                                           need_order=False)
        runmatched = rt.alive & ~(rcounts > 0)
        # bottom block: null left columns + unmatched right rows
        bottom_cols: Dict[str, DCol] = {}
        for n, c in lt.columns.items():
            # null left columns sized to the bottom block's (right)
            # capacity; bounds stay sound (filler rows are all invalid)
            bottom_cols[n] = DCol(
                torch.zeros(rt.capacity, dtype=c.data.dtype,
                            device=self.device),
                torch.zeros(rt.capacity, dtype=torch.bool,
                            device=self.device), c.ctype, c.dictionary,
                c.bounds)
        for n, c in rt.columns.items():
            bottom_cols[n] = DCol(c.data, c.valid & runmatched, c.ctype,
                                  c.dictionary, c.bounds)
        bottom = DTable(bottom_cols, runmatched)
        return self._vconcat(left_part, bottom)

    def _vconcat(self, lt: DTable, rt: DTable) -> DTable:
        """Vertical concat with dictionary merge / numeric unification."""
        cols: Dict[str, DCol] = {}
        for n in lt.column_names:
            lc, rc = lt.column(n), rt.column(n)
            if lc.ctype.kind == "string":
                merged = _merged_dict([lc, rc])
                ld = _translate(lc, merged)
                rd = _translate(rc, merged)
                ld = torch.where(ld == -2, -1, ld)
                rd = torch.where(rd == -2, -1, rd)
                cols[n] = DCol(torch.cat([ld, rd]).to(torch.int32),
                               torch.cat([lc.valid, rc.valid]),
                               STRING, merged.astype(object))
            else:
                tgt = lc.ctype
                if rc.ctype.kind != tgt.kind or \
                        (tgt.kind == "decimal" and
                         rc.ctype.scale != tgt.scale):
                    tgt = ex.common_type(lc.ctype, rc.ctype)
                    lc = JEval(lt).cast(lc, tgt)
                    rc = JEval(rt).cast(rc, tgt)
                dt = torch_dtype(tgt)
                cols[n] = DCol(
                    torch.cat([lc.data.to(dt), rc.data.to(dt)]),
                    torch.cat([lc.valid, rc.valid]), tgt, None,
                    _union_bounds(lc.bounds, rc.bounds))
        alive = torch.cat([lt.alive, rt.alive])
        return DTable(cols, alive)

    def _residual_hits(self, lt: DTable, rt: DTable, order, lo, counts,
                       extra) -> torch.Tensor:
        """Per-left-row mask: does any key match survive the residual
        predicate?  (shared by semi / anti / mark joins)"""
        out_cap, total = self._capacity_for(
            torch.sum(counts, dtype=torch.int64))
        inner = self._expand(lt, rt, order, lo, counts, total, out_cap)
        keep = JEval(inner).predicate(extra)
        starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts
        li_all = self._expand_li(counts, starts, out_cap)
        return _segment_sum(keep.to(torch.int32), li_all,
                            lt.capacity) > 0

    def _equi_join(self, lt: DTable, rt: DTable, keys, kind,
                   extra, mark: Optional[str] = None) -> DTable:
        lkey, rkey, lvalid, rvalid, bound = self._join_keys(lt, rt, keys)

        if kind == "nullaware_anti":
            rt_has_null = self._branch_bool(torch.any(~rvalid & rt.alive))
            rt_nonempty = self._branch_bool(torch.any(rt.alive))
            if rt_has_null:
                return DTable(lt.columns, torch.zeros_like(lt.alive))
            kind = "anti"
            if rt_nonempty:
                lt = DTable(lt.columns, lt.alive & lvalid)

        # null keys never match; dead rows already sentineled apart
        lkey = lkey.masked_fill(~(lvalid & lt.alive), -1)
        rkey = rkey.masked_fill(~(rvalid & rt.alive), -2)

        need_order = kind in ("inner", "left") or extra is not None
        lo, counts, order = self._probe_counts(lkey, rkey, bound,
                                               need_order=need_order)
        counts = counts.masked_fill(~lt.alive, 0)
        matched = counts > 0

        if kind == "mark":
            # EXISTS under OR: left table + boolean mark column
            if extra is not None:
                matched = self._residual_hits(lt, rt, order, lo, counts,
                                              extra)
            cols = dict(lt.columns)
            cols[mark] = DCol(matched & lt.alive, torch.ones_like(lt.alive),
                              BOOL)
            return DTable(cols, lt.alive)

        if kind in ("semi", "anti"):
            if extra is not None:
                hits = self._residual_hits(lt, rt, order, lo, counts,
                                           extra)
                mask = hits if kind == "semi" else ~hits
                return DTable(lt.columns, lt.alive & mask)
            mask = matched if kind == "semi" else (~matched & lt.alive)
            return DTable(lt.columns, lt.alive & mask)

        if kind == "inner":
            # inner expansion: one sync point for output capacity
            out_cap, total = self._capacity_for(
                torch.sum(counts, dtype=torch.int64))
            out = self._expand(lt, rt, order, lo, counts, total, out_cap)
            if extra is not None:
                mask = JEval(out).predicate(extra)
                out = DTable(out.columns, out.alive & mask)
            return out
        if kind == "left":
            return self._left_join(lt, rt, order, lo, counts, extra)
        raise Unsupported(f"join kind {kind}", code="NDS210")

    def _expand(self, lt: DTable, rt: DTable, order, lo, counts,
                total: int, out_cap: int) -> DTable:
        starts = (torch.cumsum(counts, 0, dtype=torch.int64) - counts)
        pos = _iota(out_cap, self.device, torch.int64)
        li = self._expand_li(counts, starts, out_cap)
        within = pos - starts[li]
        rpos = torch.clamp(lo[li] + within, 0, rt.capacity - 1)
        ri = order[rpos]
        alive = pos < total
        lcols = _gather_cols(lt.columns, li, alive)
        rcols = _gather_cols(rt.columns, ri, alive)
        return DTable({**lcols, **rcols}, alive)

    def _left_join(self, lt: DTable, rt: DTable, order, lo, counts,
                   extra) -> DTable:
        matched_cap, total = self._capacity_for(
            torch.sum(counts, dtype=torch.int64))
        inner = self._expand(lt, rt, order, lo, counts, total, matched_cap)
        # left-row index feeding each inner output position
        starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts
        li_all = self._expand_li(counts, starts, matched_cap)
        if extra is not None:
            keep = JEval(inner).predicate(extra)
            inner = DTable(inner.columns, keep)
        # left rows that kept >=1 match after the residual predicate
        hits = _segment_sum(inner.alive.to(torch.int32), li_all,
                            lt.capacity)
        unmatched_mask = lt.alive & (hits == 0)
        inner_c, n_matched = self._compact_n(inner)
        out_cap, n_out = self._capacity_for(
            n_matched + torch.sum(unmatched_mask, dtype=torch.int64))
        # out[pos] = matched[pos] for pos < n_matched,
        #            unmatched-left[pos - n_matched] after (null right side)
        pos = _iota(out_cap, self.device, torch.int64)
        is_m = pos < n_matched
        mi = torch.clamp(pos, 0, inner_c.capacity - 1)
        # the unmatched left rows, in order
        um_idx = _nonzero_static(unmatched_mask, out_cap)
        um_rows = um_idx[torch.clamp(pos - n_matched, 0, out_cap - 1)]
        out_alive = pos < n_out
        cols = _select_cols(
            {n: inner_c.column(n) for n in lt.column_names},
            {n: lt.column(n) for n in lt.column_names},
            mi, um_rows, is_m, out_alive)
        cols.update(_gather_cols(
            {n: inner_c.column(n) for n in rt.column_names},
            mi, is_m & out_alive))
        return DTable(cols, out_alive)


# ---------------------------------------------------------------------------
# compiling executor: discover once, replay (on CUDA, a captured graph)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CompiledPlan:
    """One compiled program (jaxexec._CompiledPlan): a query key's parent
    plan, or one of the segments it reads (:func:`_cut_segments`).  The
    size plan discovery recorded, what replay needs to rebuild its inputs,
    and on CUDA the captured graph with its static buffers."""

    key: str
    plan: lp.Plan
    record: list
    versions: tuple
    # which memo asks share a result (_memo_signature) under the
    # discovered binding: with the key, what the entry is found by
    memo_sig: tuple = ()
    # per-table column subset actually scanned (None = all columns)
    table_cols: Dict[str, Optional[List[str]]] = None
    out_meta: List[tuple] = None         # (name, ctype, dictionary, bounds)
    # parameter materializations recorded during discovery (pdict hit
    # tables, pvec IN vectors, in traversal order): rebuilt for any later
    # binding of the same canonical key
    param_spec: list = None
    # host-built device tables, in the order the plan asks for them:
    # [(host array, device tensor)] (_ConstRecord)
    consts: list = None
    # representative SQL text for persisted records: canonical cache
    # keys are not re-plannable, so save/load round-trips through SQL
    source_sql: Optional[str] = None
    # loaded from disk and not yet replayed: a drifted record is
    # rediscovered at its first run
    preloaded: bool = False
    # discovery's peak device bytes above what was allocated before it
    # (predicts the captured graph's pool) and its memo hits
    peak_bytes: int = 0
    memo_hits: int = 0
    # host seconds of the discovery run and of the last capture
    discover_s: float = 0.0
    capture_s: float = 0.0
    # the capacity of the compacted output: what a segment hands the
    # parents that read it
    out_capacity: int = 0
    # a parent's segments (jaxexec's seg_fps): the fingerprints its
    # DeviceResult leaves name and the segments' compiled plans it was
    # discovered over, in cut order; a segment's: the scalar parameter
    # slots its plan reads (its graph's buffers hold only those)
    seg_fps: Optional[List[str]] = None
    segs: Optional[list] = None
    scalar_slots: Optional[frozenset] = None
    # the segments of a parent's cut whose result another computes under
    # its memo signature (_seg_aliases): fp -> that one's; its plan reads
    # that one's DeviceResult in their place
    seg_alias: Optional[Dict[str, str]] = None
    # the captured graph (CUDA), its static parameter buffers and their
    # pinned host stages, its outputs (out, alive, ok), their pinned host
    # copies, the segment
    # sum kernel's aux words, the kernel calls it holds and its pool
    # bytes; a parent's graph reads its own copies of its segments'
    # outputs, fingerprint -> (out, alive, ok), written before each replay
    graph: object = None
    bufs: Optional[dict] = None
    stage: Optional[dict] = None
    outputs: Optional[tuple] = None
    host_out: Optional[list] = None
    aux: Optional[torch.Tensor] = None
    kernel_calls: int = 0
    pool_bytes: int = 0
    seg_bufs: Optional[dict] = None

    @property
    def slot(self) -> tuple:
        """The compile cache's key of this entry."""
        return self.key, self.memo_sig

    @property
    def programs(self) -> list:
        """The compiled plans one replay of this entry runs: its segments,
        then itself (one graph each on CUDA)."""
        return list(self.segs or ()) + [self]

    def drop_graph(self) -> None:
        """Release the graph and everything it holds; the size plan
        stays, so a later run recaptures with no discovery."""
        self.graph = self.bufs = self.outputs = self.host_out = None
        self.aux = self.seg_bufs = self.stage = None
        self.pool_bytes = 0


def _scan_columns(p: lp.Plan) -> Dict[str, Optional[List[str]]]:
    """Union of scanned columns per table (None = full table)."""
    out: Dict[str, Optional[List[str]]] = {}
    for node in p.walk():
        if isinstance(node, lp.Scan):
            if node.columns is None:
                out[node.table] = None
            elif node.table not in out:
                out[node.table] = list(node.columns)
            elif out[node.table] is not None:
                for c in node.columns:
                    if c not in out[node.table]:
                        out[node.table].append(c)
    return out


def _scalar_slots(o, out: Optional[set] = None) -> set:
    """The slots of the scalar parameters anywhere in a plan tree, its
    expressions and their subquery plans included."""
    if out is None:
        out = set()
    if isinstance(o, ex.Param):
        if not o.shape:
            out.add(o.slot)
    elif isinstance(o, lp.InlineTable):
        pass
    elif dataclasses.is_dataclass(o) and not isinstance(o, type):
        for f in dataclasses.fields(o):
            _scalar_slots(getattr(o, f.name), out)
    elif isinstance(o, (list, tuple)):
        for x in o:
            _scalar_slots(x, out)
    return out


def _reads_table(p: lp.Plan, table) -> bool:
    """Whether ``p`` splices ``table`` (an inline table's, by identity)."""
    return any(isinstance(n, lp.InlineTable) and n.table is table
               for n in p.walk())


def _seg_argname(fp: str) -> str:
    """The key of a segment among the compiled programs and a parent's
    inputs (cannot collide with a query key or a table name: NUL is not
    legal in identifiers)."""
    return "\x00seg:" + fp


# segmented compilation (jaxexec._cut_segments): plans of at least
# _SEG_MIN_TOTAL nodes run each maximal Aggregate, Window or Distinct
# subtree of at least _SEG_MIN_NODES nodes as a program of its own, one
# graph on CUDA, whose result stays on the device and feeds the parent.
# jaxexec cuts because the TPU compiler wedges on large programs; on the
# card a segment is the unit that identical subtrees of several query
# parts share (CTE instantiations), and its own unit of capture and
# eviction.  The thresholds are jaxexec's, so the cut is the same.
_SEG_CUT_TYPES = (lp.Aggregate, lp.Window, lp.Distinct)
_SEG_MIN_NODES = 5       # minimum subtree size worth its own program
_SEG_MIN_TOTAL = 14      # plans smaller than this stay single-program


def _cut_segments(p: lp.Plan):
    """Split a plan for segmented compilation.

    Returns ``(parent_plan, segments)`` where segments is an ordered
    {fingerprint: subplan} of maximal Aggregate/Window/Distinct subtrees
    and parent_plan has each occurrence replaced by lp.DeviceResult.
    Identical subtrees (multi-part CTE instantiation) share one segment.
    Deterministic for a given plan tree — discovery, replay, and record
    reload all cut identically; the fingerprints are jaxexec's."""
    segs: Dict[str, lp.Plan] = {}
    if sum(1 for _ in p.walk()) < _SEG_MIN_TOTAL:
        return p, segs

    def rebuild(node: lp.Plan, is_root: bool) -> lp.Plan:
        if not is_root and isinstance(node, _SEG_CUT_TYPES) and \
                sum(1 for _ in node.walk()) >= _SEG_MIN_NODES:
            try:
                fp = _plan_fp(node, content=True)
            except TypeError:
                fp = None  # un-fingerprintable: keep the subtree inline
            if fp is not None:
                segs.setdefault(fp, node)
                return lp.DeviceResult(fp)
        kids = node.children()
        if not kids:
            return node
        new_kids = [rebuild(k, False) for k in kids]
        if all(nk is k for nk, k in zip(new_kids, kids)):
            return node
        q = copy.copy(node)
        if hasattr(q, "child"):
            q.child = new_kids[0]
        elif hasattr(q, "left"):
            q.left, q.right = new_kids
        else:
            raise RuntimeError(
                f"unknown child layout on {type(node).__name__}")
        return q

    parent = rebuild(p, True)
    return parent, segs


def _seg_aliases(cut: Dict[str, lp.Plan],
                 values: Optional[Sequence[object]]) -> Dict[str, str]:
    """Each segment of ``cut`` whose result another one computes under a
    binding's ``values`` -> that one's fingerprint: the plan-subtree
    memo's sharing (:func:`_memo_key`), which the cut alone does not see,
    since the canonicalizer gives each copy of a CTE its own parameter
    slots (q4's six references to ``year_total`` cut into 18 segments
    and compute 3)."""
    first: Dict[str, str] = {}
    out = {}
    for fp, sub in cut.items():
        key = _memo_key(sub, values)
        rep = fp if key is None else first.setdefault(key, fp)
        if rep != fp:
            out[fp] = rep
    return out


def _rename_results(p: lp.Plan, alias: Dict[str, str]) -> lp.Plan:
    """``p`` with each DeviceResult of ``alias`` naming the segment that
    computes its result, so that the plan-subtree memo shares the
    subtrees over it as it did before the cut (q4's six ``year_total``
    unions, each merging its string dictionaries on the host)."""
    if isinstance(p, lp.DeviceResult):
        return lp.DeviceResult(alias.get(p.key, p.key))
    kids = p.children()
    new = [_rename_results(k, alias) for k in kids]
    if all(n is k for n, k in zip(new, kids)):
        return p
    q = copy.copy(p)
    if hasattr(q, "child"):
        q.child = new[0]
    else:
        q.left, q.right = new
    return q


def _host_rows(t: Table) -> list:
    """A host result's rows as tuples (strings decoded, NULLs None)."""
    cols = []
    for c in t.columns.values():
        valid = c.validity()
        data = c.data
        if c.dictionary is not None:
            data = np.full(len(c.data), None, dtype=object)
            data[valid] = c.dictionary[c.data[valid]]
        cols.append([v if ok else None
                     for v, ok in zip(data.tolist(), valid.tolist())])
    return list(zip(*cols))


def _rows_equal(a: list, b: list, rel: float = 1e-5) -> bool:
    """Exact for ints, decimals, dates and strings, ``rel`` relative for
    floats (the validator's epsilon), row by row."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if x is None or y is None:
                if x is not y:
                    return False
            elif isinstance(x, float) or isinstance(y, float):
                if not (x == y or abs(x - y) <= rel * max(abs(x), abs(y))
                        or (x != x and y != y)):
                    return False
            elif x != y:
                return False
    return True


def results_differ(want: Table, got: Table) -> Optional[str]:
    """None when ``got`` holds ``want``'s rows (floats within 1e-5
    relative), in order or, where float sums added in another order
    reordered ties, as multisets; else what differs."""
    if want.column_names != got.column_names:
        return f"columns {got.column_names} != {want.column_names}"
    a, b = _host_rows(want), _host_rows(got)
    if _rows_equal(a, b):
        return None

    def key(r):
        return tuple((0,) if v is None else (1, v) for v in r)
    if _rows_equal(sorted(a, key=key), sorted(b, key=key)):
        return None
    if len(a) != len(b):
        return f"{len(b)} rows != {len(a)}"
    i = next(j for j, (x, y) in enumerate(zip(a, b))
             if not _rows_equal([x], [y]))
    return f"row {i}: {b[i]!r} != {a[i]!r}"


class CompilingExecutor(TorchExecutor):
    """TorchExecutor + a whole-query compile cache (jaxexec
    .CompilingExecutor) keyed by the canonical key of the plan (or its
    normalized text).

    The first run of a key discovers its size plan eagerly, at padded
    capacities.  A plan is cut into a parent and its segments first
    (:func:`_cut_segments`): each segment is discovered, and compiled, as
    a program of its own, found by its fingerprint and the binding's memo
    signature, so a segment that several keys share (the CTE subtrees of
    q24's and q39's parts, q88's and q96's count) is discovered once and
    its result feeds each parent (a ``DeviceResult`` leaf); the copies of
    a CTE that a binding makes equal share one (:func:`_seg_aliases`).  On CUDA every program is
    then captured as one ``torch.cuda.CUDAGraph`` (the analog of
    jaxexec's jitted programs), replayed once and held against discovery
    (``warm_replay``); every later run, and every rendering with the same
    canonical key, writes its parameters into the graphs' static buffers
    and replays the segments' graphs, then the parent's, with no host
    sync, and reads back the guards and the result once.  A parent's
    graph reads its own copies of its segments' outputs, written between
    the replays, so a segment's graph may be evicted or recaptured
    without touching the parents captured over it.  On the CPU the same
    replay runs the programs' operators at the recorded capacities
    without a capture, which is what the tests hold against the JAX
    engine.  A failed guard (a binding that outgrows a recorded capacity
    or flips a branch, in the parent or in a segment), a segment that was
    rediscovered for another key, or a catalog version change
    rediscovers the key with its segments.  A capture or replay error
    raises: nothing falls back to an eager run.

    An entry is found by the key and the binding's memo signature
    (:func:`_memo_signature`): a replay runs the memo sharing its
    discovery recorded, so a binding whose parameters are equal in other
    places (two copies of a CTE bound apart) has an entry of its own,
    discovered at its first run, and two such bindings never evict each
    other.

    Captured graphs keep their memory pools.  Their bytes, and the bytes
    of the spines a session's spine cache holds on the device
    (``spines``), are held under ``graph_budget``, half the free device
    memory at the first capture: before a capture the least recently used
    graphs are evicted, keeping their size plans, so a later run
    recaptures without rediscovery.  An eager or discovery run that runs
    out of device memory while graphs are held evicts them all and runs
    once more.

    Counters: ``n_discoveries`` (of query keys), ``n_seg_discoveries``,
    ``n_captures`` (jaxexec's ``n_jit_builds``, a graph each),
    ``n_evictions``, ``n_guard_failures`` (rediscoveries),
    ``n_memo_sig_misses`` (discoveries of a key compiled under another
    memo signature), ``n_oom_retries`` (eager or discovery runs rerun
    after evicting every graph) and ``n_replays`` (of query keys);
    ``n_syncs`` is 1 for a replay (its one read-back; the parameter writes
    before it are queued from pinned stages and wait for nothing).

    Attribution (jaxexec's): every replay adds its read-back bytes to the
    ``engine.fetched_bytes`` counter and sets ``host_prep_s`` (entry to
    the first replay: the tables' uploads, the parameter writes of
    ``_ready`` and any capture) and ``fetched_bytes`` on its ``replay``
    span.  With ``NDSTPU_ATTRIB=1`` (``attrib_enabled``) it also records
    ``last_attribution``: those two, ``device_s`` (on a card, CUDA events
    around the graphs' replays; on the CPU the operators' wall time),
    ``fetch_s`` (the read-back copies; about 0 on the CPU), ``n_programs``
    and ``flops``, which is always None: the JAX package's figure is XLA's
    cost analysis, which has no counterpart here.  The events are read
    after the replay's own synchronise, so attribution adds no host sync;
    the split also goes on the span and on the query's summary
    (``attribution``).
    """

    # bump when the pickle layout of save_compile_records changes
    # (3: segments, under "\x00segments", and each parent's segment slots
    # and aliases)
    _REC_FORMAT = 3

    def __init__(self, catalog, device, groupby: str = GROUPBY_DEFAULT):
        super().__init__(catalog, device, groupby=groupby)
        from ndstpu_torch.engine.latch import KeyedLatch
        self.capture = self.device.type == "cuda"
        # the first replay of a capture is checked against its discovery;
        # on the CPU a replay is the next run's own path, so it waits for
        # that run
        self.warm_replay = self.capture
        self.graph_budget: Optional[int] = None     # set at first capture
        # the session's spine cache, whose device bytes share the budget
        self.spines = None
        # (key, memo signature) -> compiled plan
        self._compiled: Dict[tuple, _CompiledPlan] = {}
        # (_seg_argname(fingerprint), memo signature) -> compiled segment
        self._seg_compiled: Dict[tuple, _CompiledPlan] = {}
        # the segment results the DeviceResult leaves of the running
        # plan read: fingerprint -> DTable
        self._seg_inputs: Dict[str, DTable] = {}
        # entries that hold a graph, least recently used first
        self._graphs: "collections.OrderedDict[tuple, _CompiledPlan]" = \
            collections.OrderedDict()
        # execution is serialized (the executor keeps per-query state);
        # the key latch makes the first arrival for a key discover while
        # later arrivals wait, then replay
        self._exec_lock = threading.RLock()
        self._key_latch = KeyedLatch()
        self.n_discoveries = 0
        self.n_seg_discoveries = 0
        self.n_captures = 0
        self.n_evictions = 0
        self.n_guard_failures = 0
        self.n_memo_sig_misses = 0
        self.n_oom_retries = 0
        self.n_replays = 0
        # opt-in replay attribution (NDSTPU_ATTRIB=1, jaxexec's switch):
        # each replay's split into host preparation, device and fetch
        # (``last_attribution``); off by default
        self.attrib_enabled = os.environ.get(
            "NDSTPU_ATTRIB", "0") not in ("", "0")
        self.last_attribution: Optional[dict] = None

    # -- entry points ----------------------------------------------------------

    def execute_to_host(self, p: lp.Plan) -> Table:
        """Run ``p`` eagerly, as :class:`TorchExecutor` does (graphs are
        evicted if it runs out of device memory while they are held)."""
        with self._exec_lock:
            return self._with_memory(
                lambda: TorchExecutor.execute_to_host(self, p))

    def materialize(self, p: lp.Plan) -> Table:
        """Run ``p`` eagerly and keep its result on the device: a table
        whose columns are device tensors (a spine for
        :mod:`ndstpu_torch.engine.spine`), with the device table a plan
        that splices it reads, so that a replay reads it with no host
        copy."""
        def run():
            self._begin(p, "eager")
            try:
                dt = self.compact(self.execute(p))
                n = int(dt.alive.sum())
            finally:
                self._end()
            t = Table({name: Column(c.data[:n], c.ctype, c.valid[:n],
                                    c.dictionary)
                       for name, c in dt.columns.items()})
            t.device_table = to_device(t, self.device)
            return t
        with self._exec_lock:
            return self._with_memory(run)

    def execute_cached(self, p: lp.Plan, key: str,
                       params: Optional[ex.ParamBinding] = None,
                       sql: Optional[str] = None) -> Table:
        """Run ``p`` under ``key``: discovery at the first run of the key
        and the binding's memo signature, replay after.  Under canonical
        keying ``p`` is the parameterized plan and ``params`` this
        rendering's binding."""
        with self._key_latch.holding(key):
            with self._exec_lock:
                return self._execute_cached_locked(p, key, params, sql)

    def compiled(self, p: lp.Plan, key: str,
                 params: Optional[ex.ParamBinding] = None
                 ) -> Optional[_CompiledPlan]:
        """The compiled plan a run of ``p`` under ``key`` and ``params``
        finds (or None)."""
        values = params.values if params is not None else None
        return self._compiled.get((key, _memo_signature(p, values)))

    def _execute_cached_locked(self, p: lp.Plan, key: str,
                               params: Optional[ex.ParamBinding],
                               sql: Optional[str]) -> Table:
        versions = tuple(sorted(self.catalog.versions.items()))
        values = params.values if params is not None else None
        slot = (key, _memo_signature(p, values))
        cp = self._compiled.get(slot)
        if cp is not None and cp.versions != versions:
            self._drop(slot)
            cp = None
        if cp is None:
            faults.check("compile", key=key)
            obs.inc("engine.cache.compiled.miss")
            if any(k == key for k, _sig in self._compiled):
                self.n_memo_sig_misses += 1
            return self._discover_query(p, slot, versions, params, sql)
        obs.inc("engine.cache.compiled.hit")
        try:
            result = self._replay_query(cp, params)
        except _Drift:
            if not any(g.preloaded for g in cp.programs):
                raise
            result = None       # a stale record from disk
        if result is None:
            return self._forget_and_rediscover(p, slot, versions, params,
                                               sql)
        for g in cp.programs:
            g.preloaded = False
        return result

    def where_mask(self, table: str, e: ex.Expr) -> torch.Tensor:
        """Where ``e`` is TRUE over the rows of the catalog's ``table``
        (its device copy), NULL counting as not TRUE: the WHERE of a
        DELETE (the JAX session's ``_delete``), bound over
        ``<table>.<column>`` names.  Its subqueries run eagerly, as an
        eager query's do."""
        def run():
            dt = self._table_device(table)
            n = self.catalog.get(table).num_rows
            named = DTable({f"{table}.{c}": col
                            for c, col in dt.columns.items()}, dt.alive)
            self.mode, self.n_syncs, self._subq_cache = "eager", 0, {}
            try:
                pred = self._resolve_subqueries(e)
                with _consts_bound(None), _params_bound(None):
                    return JEval(named).predicate(pred)[:n]
            finally:
                self._subq_cache = {}
                self._end()
        with self._exec_lock:
            return self._with_memory(run)

    def release_table(self, name: str) -> None:
        """Let go of what holds the replaced or dropped table ``name``:
        its device copy and the graphs of the compiled plans that read
        it (their size plans stay until their next run, which finds the
        catalog version changed and discovers again)."""
        with self._exec_lock:
            self._device_cache.pop(name, None)
            for slot, cp in list(self._graphs.items()):
                if cp.table_cols is None or name in cp.table_cols:
                    del self._graphs[slot]
                    cp.drop_graph()

    def release_spine(self, table) -> None:
        """Let go of every compiled plan, and its graph, that splices the
        spine ``table``: the plan holds the table's tensors and the graph
        their addresses, so only this frees an evicted spine's memory.  A
        parent reading a dropped segment rediscovers at its next run."""
        with self._exec_lock:
            for store in (self._compiled, self._seg_compiled):
                for slot, cp in list(store.items()):
                    if any(_reads_table(g.plan, table)
                           for g in cp.programs):
                        store.pop(slot)
                        if self._graphs.pop(slot, None) is not None:
                            cp.drop_graph()

    def forget(self, key: str) -> None:
        """Drop ``key``'s compiled plans, their segments and their
        graphs: the key's next run discovers again."""
        for slot in [s for s in self._compiled if s[0] == key]:
            self._drop(slot, segments=True)

    def _drop(self, slot: tuple, segments: bool = False) -> None:
        cp = self._compiled.pop(slot, None)
        if cp is None:
            return
        if self._graphs.pop(slot, None) is not None:
            cp.drop_graph()
        if segments:
            # only the segments it holds: one that another key has
            # rediscovered since stays, for this key to share again
            for s in cp.segs or ():
                if self._seg_compiled.get(s.slot) is s:
                    self._drop_segment(s.slot)

    def _drop_segment(self, slot: tuple) -> None:
        scp = self._seg_compiled.pop(slot, None)
        if scp is not None and self._graphs.pop(slot, None) is not None:
            scp.drop_graph()

    def _forget_and_rediscover(self, p, slot, versions, params, sql
                               ) -> Table:
        self.n_guard_failures += 1
        warnings.warn(
            f"compiled plan invalidated (a replay guard failed, a segment "
            f"was rediscovered, or a preloaded record drifted); "
            f"rediscovering {slot[0].split('|', 1)[-1][:80]!r}",
            stacklevel=3)
        # its segments go too (jaxexec): a guard may have failed in one
        self._drop(slot, segments=True)
        return self._discover_query(p, slot, versions, params, sql)

    # -- discovery ---------------------------------------------------------------

    def _discover_query(self, p: lp.Plan, slot: tuple, versions,
                        params: Optional[ex.ParamBinding],
                        sql: Optional[str]) -> Table:
        # the whole first pass (discovery, capture and the checked first
        # replay) is cold-path cost a steady-state run never pays: the
        # harness's per-query split reads it as compile_s
        with obs.span("discover_query", cat="plan-node",
                      bucket="compile_s", n_segments=0) as sp:
            obs.inc("engine.discoveries")
            return self._discover_query_traced(p, slot, versions, params,
                                               sql, sp)

    def _discover_query_traced(self, p: lp.Plan, slot: tuple, versions,
                               params: Optional[ex.ParamBinding],
                               sql: Optional[str], sp) -> Table:
        t0 = time.perf_counter()
        parent, cut = _cut_segments(p)
        alias = _seg_aliases(cut, params.values if params is not None
                             else None)
        sp.set(n_segments=len(cut) - len(alias))
        segs, inputs, syncs = [], {}, 0
        for fp, sub in cut.items():
            if fp in alias:
                continue
            scp, inputs[fp] = self._segment(fp, sub, versions, params)
            segs.append(scp)
            syncs += self.n_syncs
        parent = _rename_results(parent, alias)
        cp, dt = self._with_memory(
            lambda: self._discover(parent, slot, versions, params, inputs))
        syncs += self.n_syncs
        host = to_host(dt)
        del dt, inputs
        self.n_discoveries += 1
        cp.seg_fps = [fp for fp in cut if fp not in alias]
        cp.segs, cp.seg_alias = segs, alias
        cp.discover_s = time.perf_counter() - t0
        cp.source_sql = sql
        self._compiled[slot] = cp
        if self.warm_replay:
            got = self._replay_query(cp, params, bucket="compile_s")
            if got is None:
                raise RuntimeError(
                    f"the first replay of {slot[0]!r} failed its guards "
                    f"on the binding it was discovered with")
            diff = results_differ(host, got)
            if diff is not None:
                raise RuntimeError(f"the first replay of {slot[0]!r} "
                                   f"disagrees with its discovery: {diff}")
            syncs += self.n_syncs
        self.n_syncs = syncs
        return host

    def _segment(self, fp: str, sub: lp.Plan, versions,
                 params: Optional[ex.ParamBinding]):
        """A parent's discovery asks for its segment ``fp``:
        ``(compiled segment, its result as a DTable)``.  A segment
        compiled for another key (or another part) replays for its values
        (jaxexec's ``_replay_one``); a new one, one whose catalog versions
        changed, or one whose guards fail under this binding, discovers."""
        values = params.values if params is not None else None
        sslot = (_seg_argname(fp), _memo_signature(sub, values))
        scp = self._seg_compiled.get(sslot)
        if scp is not None and scp.versions != versions:
            self._drop_segment(sslot)
            scp = None
        if scp is not None:
            obs.inc("engine.cache.seg_compiled.hit")
            try:
                dt = self._with_memory(
                    lambda: self._segment_values(scp, params))
            except _Drift:
                if not scp.preloaded:
                    raise
                dt = None       # a stale record from disk
            if dt is not None:
                scp.preloaded = False
                return scp, dt
            self._drop_segment(sslot)
        else:
            obs.inc("engine.cache.seg_compiled.miss")
        scp, dt = self._with_memory(
            lambda: self._discover(sub, sslot, versions, params))
        scp.scalar_slots = frozenset(_scalar_slots(sub))
        self.n_seg_discoveries += 1
        self._seg_compiled[sslot] = scp
        return scp, dt

    def _segment_values(self, scp: _CompiledPlan,
                        binding: Optional[ex.ParamBinding]
                        ) -> Optional[DTable]:
        """Replay one segment alone (on CUDA its graph) under
        ``binding``: its result, copied out of the graph's buffers, or
        None when one of its guards failed."""
        for name, cols in (scp.table_cols or {}).items():
            self._table_device(name, cols)
        values = binding.values if binding is not None else None
        if not self.capture:
            out, alive, ok = self._replay_run(
                scp, self._host_args(scp, binding), values)
        else:
            if not self._ready([scp], binding, values):
                return None
            scp.graph.replay()
            out, alive, ok = scp.outputs
            out = {n: (d.clone(), v.clone()) for n, (d, v) in out.items()}
            alive = alive.clone()
        self.n_syncs = 1
        if not bool(ok):
            return None
        return self._seg_dtable(scp, out, alive)

    def _discover(self, p: lp.Plan, slot: tuple, versions,
                  params: Optional[ex.ParamBinding],
                  segs: Optional[Dict[str, DTable]] = None):
        """One eager run at padded capacities that records the size plan,
        the parameter tables and the device constants, over the results
        of the segments the plan reads (``segs``): (compiled plan,
        compacted device result)."""
        rec: list = []
        consts: list = []
        pspec: list = []
        values = params.values if params is not None else None
        pctx = _ParamCtx(values, "concrete", spec=pspec,
                         record=True) if params is not None else None
        base = 0
        if self.capture:
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        self._begin(p, "discover", values)
        self._rec = rec
        self._seg_inputs = segs or {}
        try:
            with _params_bound(pctx), \
                    _consts_bound(_ConstRecord(consts, replay=False)):
                # compacted to the result's own class: replay reads back
                # every output column (or hands its parents every column)
                # at this capacity
                dt = self.compact(self.execute(p))
        finally:
            self._end()
            self._rec = None
            self._seg_inputs = {}
        cp = _CompiledPlan(slot[0], p, rec, versions, memo_sig=slot[1],
                           table_cols=_scan_columns(p),
                           out_meta=[(n, c.ctype, c.dictionary, c.bounds)
                                     for n, c in dt.columns.items()],
                           param_spec=pspec, consts=consts,
                           memo_hits=self.n_memo_hits,
                           out_capacity=dt.capacity)
        if self.capture:
            cp.peak_bytes = torch.cuda.max_memory_allocated(self.device) \
                - base
        return cp, dt

    def _with_memory(self, run):
        """``run()``; on CUDA, once more after evicting every graph if it
        ran out of device memory while graphs were held
        (``n_oom_retries``)."""
        try:
            return run()
        except torch.OutOfMemoryError:
            if not (self.capture and self._graphs):
                raise
        self.n_oom_retries += 1
        self._evict(len(self._graphs))
        return run()

    def _exec_deviceresult(self, p: lp.DeviceResult) -> DTable:
        """A segment's result (jaxexec._exec_deviceresult): in discovery
        the segment's eager result, in replay its replayed outputs (on
        CUDA the parent graph's copies of them)."""
        return self._seg_inputs[p.key]

    def _exec_inlinetable(self, p: lp.InlineTable) -> DTable:
        """A spliced table (jaxexec._exec_inlinetable): a spine keeps its
        device table (:meth:`materialize`), which a replay reads as it
        is; another is uploaded, at most once a table."""
        t = p.table
        dt = getattr(t, "device_table", None)
        if dt is None or dt.alive.device.type != self.device.type:
            dt = t.device_table = to_device(t, self.device)
        return dt

    @staticmethod
    def _seg_dtable(scp: _CompiledPlan, out: dict,
                    alive: torch.Tensor) -> DTable:
        """A segment's replayed outputs as the DTable its parents read,
        with exactly the metadata its discovery recorded (the parent's
        discovery saw the same)."""
        return DTable({name: DCol(out[name][0], out[name][1], ctype,
                                  dictionary, bounds)
                       for name, ctype, dictionary, bounds in scp.out_meta},
                      alive)

    # -- replay ------------------------------------------------------------------

    def _replay_run(self, cp: _CompiledPlan, bufs: dict, values,
                    segs: Optional[dict] = None):
        """The plan's operators in replay mode (on CUDA, what a capture
        records) under a binding's ``values``, which only the memo reads,
        over its segments' outputs ``segs`` (fingerprint -> (out, alive,
        ok)): ``(out, alive, ok)``, the output columns' ``(data, valid)``
        by name, the output alive mask and the conjunction of every guard,
        the segments' included, all on the device."""
        pctx = _ParamCtx(None, "replay", spec=cp.param_spec or [],
                         bufs=bufs)
        crec = _ConstRecord(cp.consts, replay=True)
        self._begin(cp.plan, "replay", values)
        self._rec, self._pos, self._oks = cp.record, 0, []
        self._seg_inputs = {
            fp: self._seg_dtable(s, *segs[fp][:2])
            for fp, s in zip(cp.seg_fps or (), cp.segs or ())}
        try:
            with _params_bound(pctx), _consts_bound(crec):
                dt = self.compact(self.execute(cp.plan))
            if (self._pos, pctx.pos, crec.pos) != (
                    len(cp.record), len(pctx.spec), len(cp.consts)):
                raise _Drift("size-plan drift (unconsumed records)")
            # output-type guard: a preloaded record whose engine typing
            # changed without its plan tree changing
            want = [(n, ct) for n, ct, _d, _b in cp.out_meta]
            if [(n, c.ctype) for n, c in dt.columns.items()] != want:
                raise _Drift("size-plan drift (output columns)")
            oks = self._oks + [segs[fp][2] for fp in cp.seg_fps or ()]
            ok = torch.ones((), dtype=torch.bool, device=self.device)
            if oks:
                ok = torch.stack([o.reshape(()) for o in oks]).all()
            out = {n: (c.data, c.valid) for n, c in dt.columns.items()}
            return out, dt.alive, ok
        finally:
            self._end()
            self._rec = self._oks = None
            self._seg_inputs = {}

    def _replay_query(self, cp: _CompiledPlan,
                      binding: Optional[ex.ParamBinding],
                      bucket: str = "execute_s") -> Optional[Table]:
        """Replay ``cp`` under ``binding`` (one of its memo signature): on
        CUDA its segments' graphs and its own (each captured now if it has
        none), on the CPU their operators.  One read-back of the guards
        and the result; None when a guard failed or a segment it was
        discovered over is gone.  The replay's time goes to ``bucket`` of
        the harness's per-query split: ``compile_s`` for discovery's
        checked first replay, ``execute_s`` otherwise."""
        with obs.span("replay", cat="plan-node", bucket=bucket,
                      n_programs=len(cp.programs)) as sp:
            return self._replay_query_traced(cp, binding, sp)

    def _replay_query_traced(self, cp: _CompiledPlan,
                             binding: Optional[ex.ParamBinding],
                             sp) -> Optional[Table]:
        t_start = time.perf_counter()
        for s in cp.segs or ():
            if self._seg_compiled.get(s.slot) is not s:
                obs.inc("engine.cache.seg_compiled.miss")
                return None     # rediscovered for another key, or dropped
        # the plans' tables go to the device first (jaxexec's _build_jit
        # uploads them before it traces): an upload reads the columns'
        # bounds back to the host, which a capture cannot, and a preloaded
        # record's first run captures before any discovery uploaded them
        for g in cp.programs:
            for name, cols in (g.table_cols or {}).items():
                self._table_device(name, cols)
        values = binding.values if binding is not None else None
        attrib = self.attrib_enabled
        if not self.capture:
            args = [(s, self._host_args(s, binding))
                    for s in cp.segs or ()]
            parent_args = self._host_args(cp, binding)
            t_dispatch = time.perf_counter()
            segs = {fp: self._replay_run(s, a, values)
                    for fp, (s, a) in zip(cp.seg_fps or (), args)}
            out, alive, ok = self._replay_run(cp, parent_args, values, segs)
            t_ready = time.perf_counter()
            host = [ok, alive] + [t for n in out for t in out[n]]
            t_fetched = time.perf_counter()
            device_s, fetch_s = t_ready - t_dispatch, t_fetched - t_ready
        else:
            if not self._ready(cp.programs, binding, values):
                return None
            stream = torch.cuda.current_stream(self.device)
            t_dispatch = time.perf_counter()
            if attrib:
                # events on the executor's stream, read after the one
                # synchronise the replay makes anyway: no host sync added
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)]
                marks[0].record(stream)
            for fp, s in zip(cp.seg_fps or (), cp.segs or ()):
                s.graph.replay()
                for dst, src in zip(_flat(cp.seg_bufs[fp]),
                                    _flat(s.outputs)):
                    dst.copy_(src)
            cp.graph.replay()
            if attrib:
                marks[1].record(stream)
            out, alive, ok = cp.outputs
            host = cp.host_out
            for h, t in zip(host, [ok, alive] +
                            [t for n in out for t in out[n]]):
                h.copy_(t, non_blocking=True)
            if attrib:
                marks[2].record(stream)
            stream.synchronize()
            if attrib:
                device_s = marks[0].elapsed_time(marks[1]) / 1e3
                fetch_s = marks[1].elapsed_time(marks[2]) / 1e3
        self.n_replays += 1
        self.n_syncs = 1
        self.n_memo_hits = cp.memo_hits
        fetched = sum(t.numel() * t.element_size() for t in host)
        host_prep_s = round(t_dispatch - t_start, 5)
        obs.inc("engine.fetched_bytes", fetched)
        sp.set(host_prep_s=host_prep_s, fetched_bytes=fetched)
        if attrib:
            self.last_attribution = {
                "host_prep_s": host_prep_s,
                "device_s": round(device_s, 5),
                "fetch_s": round(fetch_s, 5),
                "fetched_bytes": fetched,
                "n_programs": len(cp.programs),
                "flops": None,
            }
            sp.set(device_s=self.last_attribution["device_s"],
                   fetch_s=self.last_attribution["fetch_s"], flops=None)
            obs.annotate(attribution=self.last_attribution)
        if not bool(host[0]):
            return None
        alive_np = host[1].numpy()
        cols = {}
        for i, (name, ctype, dictionary, _b) in enumerate(cp.out_meta):
            data = host[2 + 2 * i].numpy()[alive_np]
            valid = host[3 + 2 * i].numpy()[alive_np]
            cols[name] = Column(data, ctype, None if valid.all() else valid,
                                dictionary)
        return Table(cols)

    @staticmethod
    def _args(cp: _CompiledPlan,
              binding: Optional[ex.ParamBinding]) -> dict:
        """``cp``'s host arguments under ``binding``; a segment's take the
        scalars its own plan reads, whichever parent's binding it is."""
        return _param_args_np(cp.param_spec, binding, cp.scalar_slots)

    def _host_args(self, cp: _CompiledPlan,
                   binding: Optional[ex.ParamBinding]) -> dict:
        return {k: torch.as_tensor(v)
                for k, v in self._args(cp, binding).items()}

    def _ready(self, graphs: list, binding, values) -> bool:
        """Give each of ``graphs`` (one replay's programs, segments
        first) its graph and this binding's parameters, capturing those
        that have none together (:meth:`_capture`); False when a binding
        does not fit a recorded graph's buffers.  None of them is evicted
        to make room for another."""
        missing = []
        for g in graphs:
            if g.graph is None:
                missing.append(g)
            elif not self._write_params(g, self._args(g, binding)):
                return False
        if missing:
            self._capture(missing, binding, values,
                          keep={g.slot for g in graphs})
        for g in graphs:
            self._graphs.move_to_end(g.slot)
        return True

    def _write_params(self, cp: _CompiledPlan, args: dict) -> bool:
        """Copy one binding's host arguments into the graph's buffers;
        False when one has another shape (an IN-list that coerced to
        another length), which the recorded graph cannot take.  Each
        goes through its pinned stage and is queued on the replay's
        stream, so the replay's read-back stays its one host sync (a copy
        from pageable memory waits for the card); the last replay's
        copies are done, since it ended in that sync."""
        for k, v in args.items():
            if tuple(cp.bufs[k].shape) != v.shape:
                return False
        for k, v in args.items():
            cp.stage[k].copy_(torch.as_tensor(v))
            cp.bufs[k].copy_(cp.stage[k], non_blocking=True)
        return True

    def _capture(self, graphs: list, binding, values, keep) -> None:
        """Capture ``graphs`` (the programs of one replay that have no
        graph, in replay order) as CUDA graphs (jaxexec._build_jit), all
        in one memory pool: they replay one after another on one stream,
        and each program's outputs are read (a segment's copied into its
        parent's buffers) before the next replays, so a later capture may
        take an earlier one's freed temporaries and a query's segments
        cost about the memory of its one graph.  Static parameter
        buffers, the kernel's aux words and pinned read-back buffers are
        made outside the captures.  The least recently used graphs (none
        of ``keep``) are evicted first to make room (the largest
        discovery's temporaries predict the pool), and all of them but
        ``keep`` if a capture still runs out of device memory, before one
        retry."""
        # a capture is the port's counterpart of jaxexec's jit build
        obs.inc("engine.jit_builds", len(graphs))
        with obs.span("capture", cat="plan-node", bucket="compile_s",
                      n_programs=len(graphs)):
            segsum.prepare(self.device)
            self._make_room(max(g.peak_bytes for g in graphs), keep)
            try:
                self._capture_pool(graphs, binding, values)
                return
            except torch.OutOfMemoryError:
                for g in graphs:
                    self._graphs.pop(g.slot, None)
                    g.drop_graph()
                if all(s in keep for s in self._graphs):
                    raise
            for s in [s for s in self._graphs if s not in keep]:
                self._evict_slot(s)
            gc.collect()
            torch.cuda.empty_cache()
            self._capture_pool(graphs, binding, values)

    def _capture_pool(self, graphs: list, binding, values) -> None:
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(self.device)
        torch.cuda.synchronize(self.device)
        before = torch.cuda.memory_reserved(self.device)
        # The captures carve their tensors out of one arena: a block a
        # fifth larger than the largest discovery's temporaries, allocated
        # into the pool on its stream and freed at once, so that freed
        # tensors merge back into it.  A capture cannot return memory to
        # the device, and a segment for each new size fragments the pool:
        # q93 at SF 100 on an H100 held 41.6 GB of segments for 18.7 GB of
        # live tensors when it ran out of memory.
        arena = min(max(g.peak_bytes for g in graphs) * 6 // 5,
                    torch.cuda.mem_get_info(self.device)[0] - (2 << 30))
        reserve = torch.cuda.CUDAGraph()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # an empty graph
            with torch.cuda.graph(reserve, pool=pool, stream=stream):
                if arena > 0:
                    torch.empty(arena, dtype=torch.uint8,
                                device=self.device)
        for g in graphs:
            self._capture_once(g, self._args(g, binding), values, pool,
                               stream)
            now = torch.cuda.memory_reserved(self.device)
            g.pool_bytes, before = now - before, now
        del reserve

    def _capture_once(self, cp: _CompiledPlan, args: dict, values, pool,
                      stream) -> None:
        cp.bufs = {k: torch.as_tensor(v).to(self.device)
                   for k, v in args.items()}
        cp.stage = {k: torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                    for k, b in cp.bufs.items()}
        # the parent's own buffers for its segments' outputs
        cp.seg_bufs = {
            fp: _empty_like(s.outputs)
            for fp, s in zip(cp.seg_fps or (), cp.segs or ())}
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with segsum.capturing(self.device) as calls:
            cp.aux = calls.aux
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                cp.outputs = self._replay_run(cp, cp.bufs, values,
                                              cp.seg_bufs)
        cp.capture_s = time.perf_counter() - t0
        cp.graph = graph
        cp.kernel_calls = calls.n
        out, alive, ok = cp.outputs
        cp.host_out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       for t in [ok, alive] +
                       [t for n in out for t in out[n]]]
        self.n_captures += 1
        self._graphs[cp.slot] = cp

    # -- graph memory ------------------------------------------------------------

    def pool_bytes(self) -> int:
        """Device bytes the held graphs' pools take."""
        return sum(cp.pool_bytes for cp in self._graphs.values())

    def spine_bytes(self) -> int:
        """Device bytes the session's spine cache holds."""
        return self.spines.total_bytes if self.spines is not None else 0

    def cache_budget(self) -> int:
        """The bytes graphs and spines may hold together: half the free
        device memory, fixed the first time it is asked for."""
        if self.graph_budget is None:
            self.graph_budget = torch.cuda.mem_get_info(self.device)[0] // 2
            obs.set_gauge("engine.graph_budget_bytes", self.graph_budget)
        return self.graph_budget

    def _make_room(self, need: int, keep=()) -> None:
        """Evict least recently used graphs, none of ``keep``, until the
        held pools and spines plus ``need`` fit the budget and the free
        device memory.  The budget is counted first, and the free memory
        read (the evicted pools returned to the device first) once the
        count fits; an eviction here runs no garbage collection, since a
        graph's pool goes with the graph."""
        budget = self.cache_budget()
        while True:
            victim = next((s for s in self._graphs if s not in keep), None)
            fits = self.pool_bytes() + self.spine_bytes() + need <= budget
            if victim is None or fits:
                torch.cuda.empty_cache()
                if victim is None or torch.cuda.mem_get_info(
                        self.device)[0] >= need + need // 4:
                    return
            self._evict_slot(victim)

    def evict_all(self) -> None:
        """Evict every held graph (their size plans stay)."""
        with self._exec_lock:
            self._evict(len(self._graphs))

    def _evict(self, n: int) -> None:
        """Drop the ``n`` least recently used graphs (their size plans
        stay) and return their pools to the device."""
        for _ in range(n):
            self._evict_slot(next(iter(self._graphs)))
        # a failed run's tensors may sit in reference cycles with its
        # traceback's frames
        gc.collect()
        torch.cuda.empty_cache()

    def _evict_slot(self, slot: tuple) -> None:
        self._graphs.pop(slot).drop_graph()
        self.n_evictions += 1

    # -- persisted size-plan records ---------------------------------------------

    def _table_fingerprint(self, name: str) -> tuple:
        """Cheap content identity for a catalog table: row count + a
        prefix checksum over integer-backed columns + a checksum of the
        columns' types.  Guards persisted size-plan records against a
        *different dataset* — per-process version counters cannot (they
        restart at 1) — and against the same data at other types: a
        decimal warehouse's record preloaded into a session over the
        ``--floats`` warehouse (whose canonical keys are the same) is
        dropped, and its key rediscovers."""
        t = self.catalog.get(name)
        chk = 0
        for cname in t.column_names[:3]:
            data = t.column(cname).data[:4096]
            if isinstance(data, torch.Tensor):
                data = data.cpu().numpy()
            if data.dtype.kind in "iu":
                chk ^= int(np.asarray(data, dtype=np.int64).sum()) & \
                    (2 ** 61 - 1)
        types = zlib.crc32(repr([str(t.column(c).ctype)
                                 for c in t.column_names]).encode())
        return (name, t.num_rows, chk, types)

    def _record(self, cp: _CompiledPlan) -> tuple:
        """What a saved record keeps of one program (KeyError: it reads a
        since-dropped table)."""
        fps = tuple(self._table_fingerprint(t)
                    for t in sorted(cp.table_cols or ()))
        # discovery's peak sizes a preloaded record's capture (its arena,
        # and the room made for its pool)
        return (cp.record, fps, cp.table_cols, cp.out_meta, cp.param_spec,
                [h for h, _t in cp.consts], cp.memo_sig, cp.peak_bytes,
                cp.out_capacity)

    def save_compile_records(self, path: str) -> int:
        """Persist discovery's size-plan records (never a graph) so that
        a fresh process skips discovery: each parent's record keyed by its
        representative SQL, with the slots of its segments, and each
        segment's record once under ``"\\x00segments"``, merged with what
        ``path`` already holds (if it has this format) and published
        atomically.  A plan that splices a spine is not saved: its SQL
        plans to the unspliced plan.  Returns the parent record count."""
        with self._exec_lock:
            segstore: dict = {}
            data = {"\x00fmt": self._REC_FORMAT, "\x00segments": segstore}
            for cp in self._compiled.values():
                if any(isinstance(n, lp.InlineTable)
                       for g in cp.programs for n in g.plan.walk()):
                    continue
                try:
                    ent = self._record(cp)
                    segs = {s.slot: self._record(s) + (s.scalar_slots,)
                            for s in cp.segs or ()}
                except KeyError:
                    continue  # references a since-dropped table
                for k, v in segs.items():
                    segstore.setdefault(k, v)
                data[cp.source_sql or cp.key] = ent + (
                    [s.slot for s in cp.segs or ()], cp.seg_alias or {})
            try:
                with open(path, "rb") as f:
                    prev = pickle.load(f)
                if isinstance(prev, dict) and \
                        prev.get("\x00fmt") == self._REC_FORMAT:
                    for k, v in prev.items():
                        if k == "\x00segments":
                            for sk, sv in v.items():
                                segstore.setdefault(sk, sv)
                        else:
                            data.setdefault(k, v)
            except (OSError, pickle.UnpicklingError, EOFError):
                pass        # absent or unreadable earlier file
            tmp = f"{path}.tmp.{uuid.uuid4().hex}"
            with open(tmp, "wb") as f:
                pickle.dump(data, f)
            os.replace(tmp, path)
            return len(data) - 2

    def _preloaded(self, key: str, plan: lp.Plan, ent: tuple, versions,
                   **extra) -> Optional[_CompiledPlan]:
        """A compiled plan from a saved record, or None when its table
        fingerprints no longer match the catalog."""
        (record, fps, table_cols, out_meta, pspec, hosts, memo_sig,
         peak_bytes, out_capacity) = ent[:9]
        try:
            if any(self._table_fingerprint(fp[0]) != fp for fp in fps):
                return None
        except KeyError:
            return None
        return _CompiledPlan(
            key, plan, record, versions, table_cols=table_cols,
            out_meta=out_meta, param_spec=pspec, memo_sig=memo_sig,
            consts=[(h, torch.as_tensor(h).to(self.device)) for h in hosts],
            preloaded=True, peak_bytes=peak_bytes,
            out_capacity=out_capacity, **extra)

    def load_compile_records(self, path: str, plan_for_key) -> int:
        """Preload records saved by :meth:`save_compile_records`.
        ``plan_for_key(sql)`` returns the plan to run for the SQL text and
        its cache key, ``(plan, key)``, or None to skip it.  A record of
        another format (format 2 had no segments) is not read: its keys
        discover again, and the next save writes this format.  Records
        whose table fingerprints no longer match the catalog, or whose
        plan no longer cuts into the segments they name, are dropped; a
        preloaded record is captured at its first run with no discovery,
        and rediscovered if it drifted.  A segment already compiled here
        is kept.  Returns the count loaded."""
        with open(path, "rb") as f:
            data = pickle.load(f)
        if not isinstance(data, dict) or \
                data.get("\x00fmt") != self._REC_FORMAT:
            return 0
        segstore = data.get("\x00segments", {})
        with self._exec_lock:
            versions = tuple(sorted(self.catalog.versions.items()))
            n = 0
            for sql, ent in data.items():
                if sql.startswith("\x00"):
                    continue
                res = plan_for_key(sql)
                if res is None:
                    continue
                plan, key = res
                parent, cut = _cut_segments(plan)
                seg_slots, alias = ent[9], ent[10]
                fps = [fp for fp in cut if fp not in alias]
                if [_seg_argname(fp) for fp in fps] != \
                        [s[0] for s in seg_slots] or \
                        not set(alias.values()) <= set(fps):
                    continue    # the cut or the plan changed: rediscover
                segs = []
                for fp, sslot in zip(fps, seg_slots):
                    scp = self._seg_compiled.get(sslot)
                    if scp is None or scp.versions != versions:
                        sent = segstore.get(sslot)
                        scp = None if sent is None else self._preloaded(
                            sslot[0], cut[fp], sent, versions,
                            scalar_slots=sent[9])
                        if scp is None:
                            break
                        self._drop_segment(sslot)
                        self._seg_compiled[sslot] = scp
                    segs.append(scp)
                if len(segs) != len(fps):
                    continue
                cp = self._preloaded(key, _rename_results(parent, alias),
                                     ent, versions, source_sql=sql,
                                     seg_fps=fps, segs=segs, seg_alias=alias)
                if cp is None:
                    continue
                self._drop(cp.slot)
                self._compiled[cp.slot] = cp
                n += 1
            return n


def _flat(outputs: tuple) -> list:
    """A program's ``(out, alive, ok)`` as a list of tensors."""
    out, alive, ok = outputs
    return [t for n in out for t in out[n]] + [alive, ok]


def _empty_like(outputs: tuple) -> tuple:
    """Buffers of ``outputs``' shapes and types, ``(out, alive, ok)``."""
    out, alive, ok = outputs
    return ({n: (torch.empty_like(d), torch.empty_like(v))
             for n, (d, v) in out.items()},
            torch.empty_like(alive), torch.empty_like(ok))
