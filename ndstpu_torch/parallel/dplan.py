"""Distributed plan executor over a one-rank mesh: out-of-core execution
on one card (the port of ``ndstpu.parallel.dplan``).

The JAX package runs a plan's **spine** — the operator chain over its
single largest table — as one ``jit(shard_map)`` program over the device
mesh.  With ``Session(spmd_chunk_rows=...)`` on one device that is its
out-of-core path: the fact streams through the program chunk by chunk,
and each chunk's partial aggregates (or rows) are combined on the host.
The port keeps the executor's structure and its decisions, and runs at
world size 1 (:mod:`ndstpu_torch.parallel.mesh`):

* The **spine** runs as torch operations over one chunk at a time,
  eagerly, with the chunk's first global row id as its offset.  Filters
  and projections are local; a dimension join is a **broadcast join**
  (the build side resolved on the driver, a ``searchsorted`` probe); a
  join whose build side exceeds the broadcast limit is a **shuffle
  join** (build side hash-partitioned with the JAX package's splitmix64
  into one partition a rank, probed locally); aggregation emits
  sort-grouped partials a chunk.  On one rank no row moves between
  ranks, so where the JAX package runs an exchange (a shuffle's probe
  rows, a DISTINCT's groups, a window's partitions) the port reads the
  rows in place: the exchange there would only copy the live rows, in
  their order, into a larger table (the collectives come with the
  multi-rank path).  Grouped sums are torch segment
  sums, as the JAX package's are ``jax.ops.segment_sum`` (not its Pallas
  kernel); float sums go through :mod:`ndstpu_torch.engine.fp64`.
* **Existence-join build sides containing a fact** reduce to their
  distinct key tuples through a child executor (:meth:`_reduce_build`).
* **Window functions** run with the original row id as the ranking
  tiebreak; a window spine, like a
  DISTINCT aggregate, needs all its rows in one launch and runs the fact
  resident, as in the JAX package.
* A **Sort+Limit** (or bare Limit) over a row spine finalizes on the
  device (:meth:`_device_tail`): a top-k a chunk by (order keys, row id).
* **Build sides and the plan tail** run on the driver: the JAX package's
  host numpy interpreter, here :class:`_HostExec`, the port's eager
  executor on the session's device, whose results come back to the host.
  The combines and finalizers of partials are the JAX package's numpy
  code.
* A plan without a table of the shard threshold's size, or with an
  operator outside the distributed subset, raises
  :class:`DistUnsupported` (with the JAX package's NDS3xx code where it
  has one); the session falls back to the compiling executor.

**Streaming.**  A fact larger than ``chunk_rows`` (or, on a card, any
fact the catalog holds in host memory) streams: the scan pool
(:class:`ndstpu_torch.io.loader.ChunkScanPool`) reads row ranges of the
table, and the staging ring (:class:`ndstpu_torch.engine.torchexec.
ChunkPrefetcher`) copies them through pinned buffers to the card on a
side stream while the previous chunk computes.  ``chunk_rows="auto"``
sizes chunks with :func:`ndstpu_torch.engine.memplan.plan_stream`.

**Who owns the card's memory.**  The stream owns what is free when a
spine starts: ``"auto"`` empties the allocator's cache and reads the free
memory then, so graphs the compiling executor holds are already counted
as used, and ``memplan`` commits half of what is left.  The compiling
executor's graph budget (half the free memory at its first capture)
binds only the parts that fall through; graphs evicted on an
out-of-memory retry give memory back to either.  A spine's device state
(its chunks, the shuffle builds' partitions, broadcast builds, a resident
fact's columns) is released when the spine returns: a cached executor
re-stages it from the host, so no query holds the card between runs.

Row order: the JAX package restores a chunked row spine's order with a
stable argsort on ``__rowid__``, and its tails sort by (keys, row id);
the port does the same with stable ``torch.sort``/``numpy`` sorts, so a
row spine's rows come back in exactly the JAX order.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ndstpu_torch import obs
from ndstpu_torch.analysis import lowering as lowreg
from ndstpu_torch.engine import columnar, expr as ex, plan as lp
from ndstpu_torch.engine.columnar import BOOL, FLOAT64, INT64, Column, Table
from ndstpu_torch.engine.torchexec import (
    DCol,
    DTable,
    JEval,
    _gather_cols,
    TorchExecutor,
    Unsupported,
    _DEAD_KEY,
    _NULL32,
    _NULL_KEY,
    _ORD_DEAD32,
    _group_ids,
    _key_col,
    _key_i64,
    _lexsort_order,
    _minmax_vals,
    _narrow_span,
    _segment_sum,
    _sum_input,
    to_device,
    to_host,
    torch_dtype,
)
from ndstpu_torch.parallel import exchange
from ndstpu_torch.parallel.exchange import DistUnsupported  # noqa: F401


def _has_params(plan: lp.Plan) -> bool:
    """True when any expression in the plan carries a parameter slot.
    A parameterized (canonical) plan takes the distributed path when the
    caller supplies the binding: :meth:`execute_plan` substitutes the
    bound values back into literals (:func:`bind_plan_params`)."""
    for node in plan.walk():
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            items = v if isinstance(v, (list, tuple)) else (v,)
            for it in items:
                if isinstance(it, tuple):  # sort keys: (expr, asc[, nf])
                    it = it[0] if it else None
                if isinstance(it, ex.Expr) and any(
                        isinstance(x, (ex.Param, ex.InParam))
                        for x in it.walk()):
                    return True
    return False


def _subst_params(e: ex.Expr, values) -> ex.Expr:
    """Rebuild `e` with every Param/InParam replaced by the bound
    literal / IN-list (slot-indexed into the canonicalizer's values)."""
    if isinstance(e, ex.Param):
        return ex.Literal(values[e.slot])
    if isinstance(e, ex.InParam):
        return ex.InList(_subst_params(e.operand, values),
                         list(values[e.slot]), e.negated)
    changed = False
    kw = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ex.Expr):
            nv = _subst_params(v, values)
        elif isinstance(v, (list, tuple)):
            nv = type(v)(
                _subst_params(it, values) if isinstance(it, ex.Expr)
                else (tuple(_subst_params(x, values)
                            if isinstance(x, ex.Expr) else x for x in it)
                      if isinstance(it, tuple) else it)
                for it in v)
            if nv == v:
                nv = v
        else:
            nv = v
        kw[f.name] = nv
        changed = changed or nv is not v
    return dataclasses.replace(e, **kw) if changed else e


def bind_plan_params(plan: lp.Plan, binding) -> lp.Plan:
    """Concrete copy of a canonical exec_plan: every Param/InParam slot
    replaced by its bound value from ``binding``."""
    values = binding.values if hasattr(binding, "values") else binding
    plan = copy.deepcopy(plan)
    for node in plan.walk():
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, ex.Expr):
                setattr(node, f.name, _subst_params(v, values))
            elif isinstance(v, (list, tuple)):
                out = []
                for it in v:
                    if isinstance(it, ex.Expr):
                        out.append(_subst_params(it, values))
                    elif isinstance(it, tuple):
                        out.append(tuple(
                            _subst_params(x, values)
                            if isinstance(x, ex.Expr) else x for x in it))
                    else:
                        out.append(it)
                setattr(node, f.name, type(v)(out))
    return plan


def _itemsize(a) -> int:
    dt = a.dtype
    return int(dt.itemsize)


def _table_bytes(t: Table) -> int:
    """Replicated footprint of a host build table through memplan's
    row-width model (the same width the static analyzer estimates)."""
    from ndstpu_torch.engine import memplan
    return memplan.row_bytes(
        [_itemsize(t.column(nm).data) for nm in t.column_names]) \
        * int(t.num_rows)


def scalar_subquery_literal(t: Table,
                            too_many: type = RuntimeError) -> "ex.Expr":
    """First column of a (<=1)-row table as a Literal — the inlining
    step of an uncorrelated scalar subquery (physical.py's)."""
    col = t.columns[t.column_names[0]]
    if t.num_rows == 0:
        return ex.Literal(None, col.ctype)
    vals = col.to_pylist()
    if len(vals) > 1:
        raise too_many("scalar subquery returned >1 row")
    return ex.Literal(vals[0], col.ctype)


def _factorize(cols: List[Column]) -> Tuple[np.ndarray, np.ndarray]:
    """Composite group ids + representative first-row index per group
    (the host interpreter's ``_factorize``)."""
    n = len(cols[0].data) if cols else 0
    gid = np.zeros(n, dtype=np.int64)
    for c in cols:
        data = c.data.astype(np.int64)
        data = np.where(c.validity(), data, np.int64(-(2**62)))
        uniq, inv = np.unique(data, return_inverse=True)
        gid = gid * (len(uniq) + 1) + inv
        if len(uniq) + 1 > 2**31:
            uniq2, gid = np.unique(gid, return_inverse=True)
    uniq, first, inv = np.unique(gid, return_index=True,
                                 return_inverse=True)
    return inv.astype(np.int64), first


class _HostExec(TorchExecutor):
    """The driver side of a spine (the JAX package's host numpy
    interpreter, ``physical.Executor``): build sides, scalar subqueries
    and the plan tail over the spine's result run eagerly on the
    session's device, and their results come back as host tables.

    It reads the compiling executor's device copies of the catalog's
    tables (``shared``: the same dictionary, so a dimension is on the
    card once).  A table held in host memory uploads only the columns a
    scan asks for, into a cache of this executor's own that
    :meth:`release` empties when the spine returns."""

    def __init__(self, catalog, device, shared: Optional[dict] = None):
        super().__init__(catalog, device)
        if shared is not None:
            self._device_cache = shared
        self._host_cache: Dict[str, tuple] = {}

    def _table_device(self, name, columns=None):
        on_host = getattr(self.catalog, "on_host", None)
        if on_host is None or not on_host(name, self.device):
            return super()._table_device(name, columns)
        shared = self._device_cache
        self._device_cache = self._host_cache
        try:
            return super()._table_device(name, columns)
        finally:
            self._device_cache = shared

    def release(self) -> None:
        self._host_cache = {}

    def run(self, p: lp.Plan) -> Table:
        """Run ``p`` eagerly and return its result on the host; resolved
        subqueries stay cached across runs (``_subq_cache``)."""
        keep = self._subq_cache
        self._begin(p, "eager")
        self._subq_cache = keep
        try:
            return to_host(self.execute(p))
        finally:
            self._end()

    def _exec_inlinetable(self, p: lp.InlineTable) -> DTable:
        return to_device(p.table, self.device)


_SPINE_NODES = (lp.Scan, lp.Filter, lp.Project, lp.Join, lp.SubqueryAlias)
# the fewest chunk rows an out-of-memory halving goes down to
MIN_OOM_CHUNK_ROWS = 1 << 16
# shardable key kinds and decomposable aggregates come from the shared
# supported-op registry so the static analyzer (NDS3xx) cannot drift
_KEY_KINDS = tuple(sorted(lowreg.SPMD_KEY_KINDS))
_AGG_FUNCS = tuple(sorted(lowreg.SPMD_AGG_FUNCS))


@dataclasses.dataclass
class _BroadcastJoin:
    """Host-resolved build side of a spine join (driver-side broadcast)."""
    kind: str
    mark: Optional[str]
    extra: Optional[ex.Expr]
    probe_key_exprs: List[ex.Expr]
    radices: List[Tuple[int, int]]   # (lo, span) per key part
    sorted_keys: np.ndarray          # valid build keys, sorted
    row_of: np.ndarray               # sorted position -> build row index
    build: Table                     # host build table (post plan)
    spine_left: bool                 # spine side is the join's left child
    build_has_null: bool = False     # any build row with a NULL key part
    build_empty: bool = False
    # per key part: the build dictionary for string keys (None = numeric)
    key_dicts: Optional[List[Optional[np.ndarray]]] = None
    # >0: duplicate build key runs — inner joins EXPAND the probe side
    # by this factor; semi/anti/mark residuals probe every duplicate
    dup_max: int = 0
    # the join takes key runs the JAX package refuses (_ragged_join)
    ragged: bool = False
    # device copies for one run: sorted keys, row_of, build columns
    dev: Optional[dict] = None


@dataclasses.dataclass
class _ShuffleJoin:
    """Partitioned equi-join for build sides too large to broadcast —
    the fact-fact join path (e.g. store_sales ⋈ store_returns on
    item_sk+ticket_number).  The build side is hash-partitioned by key on
    the host (each rank's partition sorted by key); the probe rows
    repartition by the same splitmix64 bucket hash (on one rank, none
    moves), then join locally with a searchsorted
    probe."""
    kind: str
    mark: Optional[str]
    extra: Optional[ex.Expr]
    probe_key_exprs: List[ex.Expr]
    radices: List[Tuple[int, int]]
    spine_left: bool
    build_has_null: bool
    build_empty: bool
    part_cap: int                    # rows per rank partition (padded)
    # host-staged [n_dev * part_cap] arrays: partition-local keys sorted
    # ascending, _DEAD_KEY padding
    keys_flat: np.ndarray
    # build columns gathered into partition order: name -> (data, valid,
    # ctype, dictionary)
    cols_flat: Dict[str, tuple]
    # per key part: the build dictionary for string keys (None = numeric)
    key_dicts: Optional[List[Optional[np.ndarray]]] = None
    # >0: semi/anti/mark residual probes every duplicate in a key run
    dup_max: int = 0
    # the join takes key runs the JAX package refuses (_ragged_join)
    ragged: bool = False
    # device copies for one run: [keys, data0, valid0, ...]
    dev: Optional[list] = None


class DistributedPlanExecutor:
    """Runs one logical plan over the mesh (one object a plan; a cached
    one runs again through :meth:`execute_again`)."""

    def __init__(self, catalog, mesh, shard_threshold_rows: int = 65536,
                 broadcast_limit_rows: int = lowreg.SPMD_BROADCAST_LIMIT_ROWS,
                 dev_cache: Optional[dict] = None,
                 chunk_rows=None,
                 prefetch_depth: Optional[int] = None,
                 cost_advisor="auto", device="cpu",
                 host_exec: Optional[_HostExec] = None):
        self.catalog = catalog
        self.mesh = mesh
        self.n_dev = int(mesh.n_dev)
        if self.n_dev != 1:
            raise DistUnsupported(
                f"a mesh of {self.n_dev} ranks: the multi-rank executor is "
                f"not ported (world size 1 only)", code="NDS301")
        self.device = torch.device(device)
        self.threshold = shard_threshold_rows
        self.broadcast_limit = broadcast_limit_rows
        # exchange-placement advisor (analysis/cost.py): "auto" resolves
        # to the cost model over the device budget when NDSTPU_COST is
        # on; None restores the fixed rows-only rule
        if cost_advisor == "auto":
            from ndstpu_torch.analysis import cost as _cost
            cost_advisor = _cost.default_advisor(broadcast_limit_rows) \
                if _cost.enabled() else None
        self.cost_advisor = cost_advisor
        self.cost_decisions: List[dict] = []
        self._order_safe = False
        # out-of-core: facts above this row count stream through the
        # device in chunks; None = whole-fact resident; "auto" = the
        # spill-aware planner (engine/memplan.py) sizes chunk_rows and the
        # prefetch depth per fact from the device's free memory
        self.chunk_rows = chunk_rows
        # staging ring depth (chunks staged ahead of compute); None =
        # planner default, 0 = synchronous
        self.prefetch_depth = prefetch_depth
        # the compiling executor's device copies of the catalog's tables
        # (session: share_tables), which the driver side reads too
        self.dev_cache = dev_cache if dev_cache is not None else {}
        self.np_exec = host_exec if host_exec is not None else \
            _HostExec(catalog, self.device, self.dev_cache)
        self.joins: Dict[int, object] = {}   # _BroadcastJoin | _ShuffleJoin
        self.fact: Optional[lp.Scan] = None
        self._prepared = False
        # collect_partials mode: _post_spine returns raw finest-group
        # partials instead of a finalized Table (union-agg branches)
        self._emit_partials = False
        self._union_ctx = None
        self._scalar_ctx = None
        self._chunk_info = (False, 1, 0, 0)
        self._row_meta: Optional[List[tuple]] = None
        self._key_meta: Optional[List[tuple]] = None
        self._leaf_meta: Optional[List[tuple]] = None
        # NDS3xx codes hit while probing candidates / child executors —
        # kept even on success
        self.attempt_codes: List[str] = []
        # (join kind, reduced build rows) per _reduce_build success
        self.build_reduced: List[tuple] = []
        # on-device row-spine tail: (sort keys or None, LIMIT n)
        self._tail: Optional[tuple] = None
        # the spine absorbs Window nodes (rowid threading needed)
        self._has_win = False
        # which executor paths answered, and each spine's fact: (table,
        # rows, chunk rows, launches, why it ran resident or None when it
        # streamed), children's included
        self.paths: List[str] = []
        self.streams: List[tuple] = []
        # chunk rows after an out-of-memory halving (None: as planned)
        self._chunk_cap: Optional[int] = None

    def _child(self) -> "DistributedPlanExecutor":
        return DistributedPlanExecutor(
            self.catalog, self.mesh,
            shard_threshold_rows=self.threshold,
            broadcast_limit_rows=self.broadcast_limit,
            dev_cache=self.dev_cache, chunk_rows=self.chunk_rows,
            prefetch_depth=self.prefetch_depth,
            cost_advisor=self.cost_advisor, device=self.device,
            host_exec=self.np_exec)

    # -- public --------------------------------------------------------------

    def execute_plan(self, plan: lp.Plan, params=None) -> Table:
        """Try candidate fact tables largest-first (at tiny scale factors
        a fixed-size dimension like date_dim can out-size the fact, and
        some spines fail preparation, e.g. non-unique build keys)."""
        if _has_params(plan):
            if params is None:
                raise DistUnsupported(
                    "parameterized (canonical) plan on spmd path without "
                    "a binding", code="NDS301")
            plan = bind_plan_params(plan, params)
        try:
            union = self._try_union_agg(plan)
            if union is not None:
                self.paths.append("union-aggregate")
                self._annotate_decisions()
                return union
            offload = self._try_subquery_offload(plan)
            if offload is not None:
                self.paths.append("subquery offload")
                self._annotate_decisions()
                return offload
            scans = [n for n in plan.walk() if isinstance(n, lp.Scan)]
            if not scans:
                raise DistUnsupported("no base-table scan in plan",
                                      code="NDS301")
            sized = sorted(((self.catalog.get(n.table).num_rows, i, n)
                            for i, n in enumerate(scans)),
                           key=lambda t: (-t[0], t[1]))
            last: Optional[DistUnsupported] = None
            for rows, _, target in sized:
                if rows < self.threshold:
                    break
                self._reset_candidate(target)
                try:
                    spine, top = self._split(plan)
                    result = self._run_spine_retrying(spine)
                except DistUnsupported as e:
                    if e.code:
                        self.attempt_codes.append(e.code)
                    last = e
                    continue
                self._spine, self._top = spine, top
                self._annotate_decisions()
                self._note_paths()
                return self._finish(result)
            raise last or DistUnsupported("no sharded-size table in plan",
                                          code="NDS301")
        finally:
            self._release()

    def _adopt(self, child: "DistributedPlanExecutor") -> None:
        """Count a child executor's paths and streams as this one's."""
        self.paths += child.paths
        self.streams += child.streams

    def _reset_candidate(self, target) -> None:
        self._release()
        self.joins = {}
        self.fact = None
        self.fact_target = target
        self._prepared = False
        self._tail = None
        self._has_win = False
        self._chunk_cap = None
        self.cost_decisions = []

    def _note_paths(self) -> None:
        """Name the executor paths this spine took."""
        for j in self.joins.values():
            self.paths.append("shuffle join" if isinstance(j, _ShuffleJoin)
                              else "broadcast join")
        if self._has_win:
            self.paths.append("window")
        agg = self._agg_ctx[0]
        if agg is None:
            self.paths.append("row spine with device tail"
                              if self._tail is not None else "row spine")
        elif agg.grouping_sets is not None:
            self.paths.append("grouping sets")
        else:
            self.paths.append("aggregate")

    def _annotate_decisions(self) -> None:
        """Compact advisor trail on the query span: one ``kind:strategy``
        token per spine join, ``*`` marking a cost override of the
        structural rule."""
        if not self.cost_decisions:
            return
        obs.annotate(cost_decisions=" ".join(
            f"{d['kind']}:{d['strategy']}"
            + ("*" if d["overrode"] else "")
            for d in self.cost_decisions))

    def _try_subquery_offload(self, plan: lp.Plan) -> Optional[Table]:
        """q9 shape: the outer plan scans only sub-threshold tables while
        uncorrelated SCALAR subqueries in its expressions aggregate a
        sharded-size fact.  Execute each such subquery body distributed
        (one child executor per body), inline the scalars, and run the
        tiny outer plan on the driver."""
        for n in plan.walk():
            if isinstance(n, lp.Scan) and n.table in self.catalog and \
                    self.catalog.get(n.table).num_rows >= self.threshold:
                return None     # normal spine path handles it
        from ndstpu_torch.engine.optimizer import _plan_exprs

        subs: List[ex.SubqueryExpr] = []

        def collect(p: lp.Plan) -> None:
            for e in _plan_exprs(p):
                for x in e.walk():
                    if isinstance(x, ex.SubqueryExpr) and \
                            x.plan is not None and x.kind == "scalar" and \
                            not x.correlated_predicates:
                        subs.append(x)
            for c in p.children():
                collect(c)

        collect(plan)
        targets = [
            s for s in subs
            if any(isinstance(n, lp.Scan) and n.table in self.catalog and
                   self.catalog.get(n.table).num_rows >= self.threshold
                   for n in s.plan.walk())]
        if not targets:
            return None
        children: List[Tuple[ex.SubqueryExpr,
                             "DistributedPlanExecutor"]] = []
        firsts: List[Table] = []
        for s in targets:
            child = self._child()
            firsts.append(child.execute_plan(s.plan))  # DistUnsupported
            self.attempt_codes += child.attempt_codes  # propagates
            self.cost_decisions += child.cost_decisions
            self._adopt(child)
            children.append((s, child))
        self._scalar_ctx = (plan, children)
        return self._scalar_finish(firsts)

    @staticmethod
    def _scalar_literal(t: Table) -> ex.Expr:
        return scalar_subquery_literal(t, too_many=DistUnsupported)

    def _scalar_finish(self, results: Optional[List[Table]]) -> Table:
        """Inline distributed subquery results as literals (pre-seeding
        the driver's subquery cache) and run the tiny outer plan;
        `results=None` re-runs the children's spines."""
        plan, children = self._scalar_ctx
        self.np_exec._subq_cache = {}
        for i, (s, child) in enumerate(children):
            out = results[i] if results is not None else \
                child.execute_again()
            self.np_exec._subq_cache[id(s)] = self._scalar_literal(out)
        return self.np_exec.run(plan)

    def collect_partials(self, plan: lp.Aggregate):
        """Run an Aggregate-rooted plan over the mesh and return the raw
        finest-group (key_cols, leaf_parts) instead of finalizing — one
        branch of a union-all aggregate."""
        self._emit_partials = True
        scans = [n for n in plan.walk() if isinstance(n, lp.Scan)]
        if not scans:
            raise DistUnsupported("no base-table scan in branch",
                                  code="NDS301")
        sized = sorted(((self.catalog.get(n.table).num_rows, i, n)
                        for i, n in enumerate(scans)),
                       key=lambda t: (-t[0], t[1]))
        last: Optional[DistUnsupported] = None
        try:
            for rows, _, target in sized:
                if rows < self.threshold:
                    break
                self._reset_candidate(target)
                try:
                    spine, top = self._split(plan)
                    if spine is not plan:
                        raise DistUnsupported(
                            "branch spine is not the union aggregate")
                    out = self._run_spine_retrying(spine)
                except DistUnsupported as e:
                    if e.code:
                        self.attempt_codes.append(e.code)
                    last = e
                    continue
                self._spine, self._top = spine, top
                self._note_paths()
                return out
            raise last or DistUnsupported(
                "no sharded-size table in branch", code="NDS301")
        finally:
            self._release()

    def _run_spine_retrying(self, spine: lp.Plan):
        """Run the spine; a chunked pass that runs the card out of memory
        (an expansion the planner's row width does not see) runs again at
        half the chunk rows, down to ``MIN_OOM_CHUNK_ROWS``
        (``engine.stream.oom_halvings``).  The JAX package's loop also
        doubles a shuffle's receive-bucket slack when a bucket dropped
        rows; on one rank a bucket holds every row and none drops."""
        while True:
            try:
                result = self._run_spine(spine)
            except torch.OutOfMemoryError:
                if not (self._chunk_info[0]
                        and self._fact_m // 2 >= MIN_OOM_CHUNK_ROWS):
                    raise
                halve = True
            else:
                halve = False
            if halve:
                # out of the handler: its frames hold the failed chunk
                self._release()
                self._chunk_cap = self._fact_m // 2
                obs.inc("engine.stream.oom_halvings")
                gc.collect()
                torch.cuda.empty_cache()
                continue
            return result

    def _finish(self, result: Table) -> Table:
        if self._top is None:
            return result
        grafted = _graft(self._top, self._spine,
                         lp.InlineTable(result, "__dist__"))
        return self.np_exec.run(grafted)

    def execute_again(self):
        """Run the prepared spine again (the caller checked that the
        catalog versions are unchanged) and redo the host finalize and
        plan tail — the repeat path of a cached query (no preparation,
        no host build)."""
        obs.inc("engine.spmd.reexecs")
        try:
            if self._union_ctx is not None:
                return self._union_again()
            if self._scalar_ctx is not None:
                return self._scalar_finish(None)
            out = self._run_chunks() if self._chunk_info[0] \
                else self._post_spine(self._launch(self._fact_args(0), 0))
            if self._emit_partials:
                return out
            return self._finish(out)
        finally:
            self._release()

    def _release(self) -> None:
        """Let go of this spine's device state (its build copies, the
        staging ring, the driver's uploads of host tables); a run again
        stages it anew from the host."""
        for j in self.joins.values():
            j.dev = None
        pf = getattr(self, "_prefetch", None)
        if pf is not None:
            pf.close()
            self._prefetch = None
        pool = getattr(self, "_stream_pool", None)
        if pool is not None:
            pool.close()
            self._stream_pool = None
        self.np_exec.release()

    # -- union-all aggregates ------------------------------------------------

    def _try_union_agg(self, plan: lp.Plan) -> Optional[Table]:
        """Distribute an Aggregate over a UNION ALL of channel subplans
        (q2/q5/q33/q56/q60/q66/q71/q76... shape): run each branch as its
        own spine, collect finest-group partials, and combine the
        decomposable partials across branches on the host.  The plan
        remainder recurses into a fresh executor so every union site
        distributes.  Returns None when no site matches or no branch
        distributes."""
        found = self._find_union_site(plan)
        if found is None:
            return None
        agg, setop = found
        try:
            self._check_agg(agg)
        except DistUnsupported:
            return None
        return self._run_union_site(plan, agg, setop)

    def _find_union_site(self, plan: lp.Plan):
        """Deepest Aggregate that directly dominates (no intervening
        aggregate) a union-all SetOp; among its unions, the one holding
        the largest base table."""

        def walk_depth(p, d=0):
            yield p, d
            for c in p.children():
                yield from walk_depth(c, d + 1)

        def union_size(s: lp.SetOp) -> int:
            rows = [self.catalog.get(n.table).num_rows
                    for n in s.walk() if isinstance(n, lp.Scan)]
            return max(rows, default=0)

        best = None
        for node, depth in walk_depth(plan):
            if not isinstance(node, lp.Aggregate):
                continue
            direct = [s for s in node.child.walk()
                      if isinstance(s, lp.SetOp) and s.kind == "union"
                      and s.all and _distributive_path(node.child, s)
                      and union_size(s) >= self.threshold]
            if not direct:
                continue
            # outermost first among sharded-size sites: nested unions
            # inside a branch are flattened by _expand_branches
            s = min(direct,
                    key=lambda s: (len(_path_to(node.child, s) or ()),
                                   -union_size(s)))
            if best is None or depth > best[0]:
                best = (depth, node, s)
        return (best[1], best[2]) if best is not None else None

    def _run_union_site(self, plan: lp.Plan, agg: lp.Aggregate,
                        setop: lp.SetOp) -> Optional[Table]:
        leaves = self._agg_leaves(agg)
        if any(a.distinct for a in leaves):
            return None    # cross-branch dedup not supported
        branches: List[lp.Plan] = []

        def flat(s: lp.SetOp) -> None:
            for side in (s.left, s.right):
                if isinstance(side, lp.SetOp) and side.kind == "union" \
                        and side.all:
                    flat(side)
                else:
                    branches.append(side)

        flat(setop)
        branches = self._expand_branches(branches)
        left_names = _output_names(branches[0], self.catalog)
        if left_names is None:
            return None
        sub_execs: List[Optional[DistributedPlanExecutor]] = []
        parts: List[tuple] = []   # (key_cols, leaf_parts, leaf_meta)
        any_dist = False
        for i, b in enumerate(branches):
            nb = b
            if i > 0:
                bn = _output_names(b, self.catalog)
                if bn is None or len(bn) != len(left_names):
                    return None
                # SetOp semantics are positional: align this branch's
                # output names with the left branch's
                nb = lp.Project(b, [(ln, ex.ColumnRef(n))
                                    for ln, n in zip(left_names, bn)])
            child = _graft(agg.child, setop, nb)
            bplan = lp.Aggregate(child, list(agg.group_by),
                                 list(agg.aggs), None)
            exe = self._child()
            try:
                kc, lps = exe.collect_partials(bplan)
                self.attempt_codes += exe.attempt_codes
                self.cost_decisions += exe.cost_decisions
                self._adopt(exe)
                parts.append((kc, lps, list(exe._leaf_meta)))
                sub_execs.append(exe)
                any_dist = True
            except DistUnsupported as du:
                if du.code:
                    self.attempt_codes.append(du.code)
                self.attempt_codes += exe.attempt_codes
                try:
                    kc, lps, meta = self._host_partials(bplan)
                except Exception:  # noqa: BLE001 — any planner/eval gap
                    return None    # falls back to the non-union paths
                parts.append((kc, lps, meta))
                sub_execs.append(None)
        if not any_dist:
            return None
        result = self._finalize_union(agg, leaves, parts)
        self._union_ctx = (plan, agg, sub_execs, parts, leaves)
        if agg is plan:
            self._union_rest = None
            self._union_next = None
            return result
        # recurse on the remainder so further union sites (other
        # channels, a CTE's second instantiation) distribute too; the
        # recursion bottoms out in the single-spine path or the driver
        rest = _graft(plan, agg, lp.InlineTable(result, "__dist_union__"))
        self._union_rest = rest
        nxt = self._child()
        try:
            out = nxt.execute_plan(rest)
            self.attempt_codes += nxt.attempt_codes
            self.cost_decisions += nxt.cost_decisions
            self._adopt(nxt)
            self._union_next = nxt
            return out
        except DistUnsupported:
            self.attempt_codes += nxt.attempt_codes
            self._union_next = None
            return self.np_exec.run(rest)

    def _expand_branches(self, branches: List[lp.Plan],
                         cap: int = 16) -> List[lp.Plan]:
        """Flatten unions NESTED inside branches into extra top-level
        branches while the path to them distributes over UNION ALL
        (q5 shape).  Branches beyond `cap` stay unexpanded (driver
        path).  Union semantics are positional, so every nested side is
        aligned to its union's left-side names before grafting."""
        work = list(branches)
        out: List[lp.Plan] = []
        while work:
            b = work.pop(0)
            inner = next(
                (s for s in b.walk()
                 if isinstance(s, lp.SetOp) and s.kind == "union"
                 and s.all and _distributive_path(b, s)), None)
            if inner is None:
                out.append(b)
                continue
            sides: List[lp.Plan] = []

            def flat(s: lp.SetOp) -> None:
                for side in (s.left, s.right):
                    if isinstance(side, lp.SetOp) and \
                            side.kind == "union" and side.all:
                        flat(side)
                    else:
                        sides.append(side)

            flat(inner)
            left_names = _output_names(sides[0], self.catalog)
            aligned: Optional[List[lp.Plan]] = []
            for i, s in enumerate(sides):
                if i == 0:
                    aligned.append(s)
                    continue
                sn = _output_names(s, self.catalog)
                if left_names is None or sn is None or \
                        len(sn) != len(left_names):
                    aligned = None
                    break
                aligned.append(lp.Project(
                    s, [(ln, ex.ColumnRef(n))
                        for ln, n in zip(left_names, sn)]))
            if aligned is None or \
                    len(out) + len(work) + len(aligned) > cap:
                out.append(b)   # unexpandable: keep whole (driver path)
                continue
            work = [_graft(b, inner, s) for s in aligned] + work
        return out

    def _union_again(self) -> Table:
        plan, agg, sub_execs, first_parts, leaves = self._union_ctx
        parts = []
        for exe, cached in zip(sub_execs, first_parts):
            if exe is not None:
                kc, lps = exe.execute_again()
                parts.append((kc, lps, list(exe._leaf_meta)))
            else:
                # driver-side branch: the caller reuses this executor
                # only while catalog versions are unchanged, so the first
                # run's partials are still valid
                parts.append(cached)
        result = self._finalize_union(agg, leaves, parts)
        if agg is plan:
            return result
        # versions unchanged => identical union result; the remainder
        # staged at first execution (with that result inlined) is still
        # valid, so run it again
        if self._union_next is not None:
            return self._union_next.execute_again()
        return self.np_exec.run(self._union_rest)

    def _host_partials(self, bplan: lp.Aggregate):
        """Driver-side finest-group partials for one union branch that
        can't be distributed (sub-threshold fact or unsupported shape)."""
        rows = self.np_exec.run(bplan.child)
        ev = ex.Evaluator(rows)
        key_cols: Dict[str, Column] = {}
        for name, e in bplan.group_by:
            key_cols[name] = ev.eval(
                self.np_exec._resolve_subqueries(e))
        n = rows.num_rows
        if bplan.group_by:
            gids, first = _factorize(list(key_cols.values()))
            ng = len(first)
            key_cols = {name: c.gather(first)
                        for name, c in key_cols.items()}
        else:
            gids = np.zeros(n, np.int64)
            ng = 1 if n else 0
        leaves = self._agg_leaves(bplan)
        leaf_parts, metas = [], []
        for a in leaves:
            p, meta = self._host_leaf_partial(rows, ev, a, gids, ng)
            leaf_parts.append(p)
            metas.append(meta)
        return key_cols, leaf_parts, metas

    def _host_leaf_partial(self, rows: Table, ev: ex.Evaluator,
                           a: ex.AggExpr, gids, ng):
        """Numpy mirror of :meth:`_leaf_partial`."""
        if isinstance(a.arg, ex.Star) or a.arg is None:
            cnt = np.bincount(gids, minlength=ng).astype(np.int64) \
                if len(gids) else np.zeros(ng, np.int64)
            return [cnt], (a.func, None, None)
        c = ev.eval(self.np_exec._resolve_subqueries(a.arg))
        meta = (a.func, c.ctype, c.dictionary)
        valid = c.validity()
        cnt = np.zeros(ng, np.int64)
        np.add.at(cnt, gids[valid], 1)
        if a.func == "count":
            return [cnt], meta
        if a.func in ("sum", "avg"):
            if c.ctype.kind in ("decimal", "int32", "int64"):
                s = np.zeros(ng, np.int64)
                np.add.at(s, gids[valid], c.data[valid].astype(np.int64))
            else:
                s = np.zeros(ng, np.float64)
                np.add.at(s, gids[valid],
                          c.data[valid].astype(np.float64))
            return [s, cnt], meta
        if a.func in ("min", "max"):
            if c.ctype.kind == "float64":
                init = np.inf if a.func == "min" else -np.inf
                acc = np.full(ng, init, np.float64)
                vals = c.data[valid].astype(np.float64)
            else:
                init = np.int64(_DEAD_KEY if a.func == "min"
                                else -_DEAD_KEY)
                acc = np.full(ng, init, np.int64)
                vals = c.data[valid].astype(np.int64)
            fold = np.minimum if a.func == "min" else np.maximum
            fold.at(acc, gids[valid], vals)
            return [acc, cnt], meta
        # stddev family: partials are [s1, m2, cnt] with m2 the CENTERED
        # second moment (shifted two-pass); combines use Chan's formula
        x = c.data[valid].astype(np.float64)
        if c.ctype.kind == "decimal":
            x = x / (10 ** c.ctype.scale)
        s1 = np.zeros(ng, np.float64)
        np.add.at(s1, gids[valid], x)
        mean = s1 / np.maximum(cnt, 1)
        d = x - mean[gids[valid]]
        d1 = np.zeros(ng, np.float64)
        m2 = np.zeros(ng, np.float64)
        np.add.at(d1, gids[valid], d)
        np.add.at(m2, gids[valid], d * d)
        m2 -= np.where(cnt > 0, d1 * d1 / np.maximum(cnt, 1), 0.0)
        return [s1, m2, cnt], meta

    def _finalize_union(self, agg: lp.Aggregate, leaves,
                        parts: List[tuple]) -> Table:
        """Concatenate per-branch (or per-chunk) finest groups and
        re-combine through the grouping-sets machinery (a plain GROUP BY
        is the single all-keys grouping set)."""
        names = [n for n, _ in agg.group_by]
        # merge group-key columns (Table.concat merges dictionaries)
        if names:
            merged = Table.concat([Table(kc) for kc, _, _ in parts])
            key_cols = dict(merged.columns)
        else:
            key_cols = {}
        leaf_parts: List[List[np.ndarray]] = []
        metas: List[tuple] = []
        for li, a in enumerate(leaves):
            bmetas = [m[li] for _, _, m in parts]
            func, ct0, _ = bmetas[0]

            def compatible(ct2) -> bool:
                # partials combine on kind + decimal scale; precision
                # widening (e.g. `0 - x`) doesn't change the encoding
                if ct0 is None or ct2 is None:
                    return ct0 is ct2
                ints = ("int32", "int64")
                if ct2.kind != ct0.kind and not (
                        ct2.kind in ints and ct0.kind in ints):
                    return False
                return ct0.kind != "decimal" or ct2.scale == ct0.scale

            for f2, ct2, _ in bmetas[1:]:
                if f2 != func or not compatible(ct2):
                    raise DistUnsupported(
                        "union branches disagree on aggregate type",
                        code="NDS302")
            dicts = [m[li][2] for _, _, m in parts]
            has_dict = any(d is not None for d in dicts)
            merged_dict = None
            branch_parts = [lp_[li] for _, lp_, _ in parts]
            if has_dict and func in ("min", "max"):
                # per-branch dictionary codes are not comparable across
                # branches: translate into the union dictionary
                arrs = [d for d in dicts if d is not None]
                merged_dict = arrs[0]
                for d in arrs[1:]:
                    merged_dict = np.union1d(merged_dict, d)
                init = np.int64(_DEAD_KEY if func == "min"
                                else -_DEAD_KEY)
                for bi, (bp, d) in enumerate(zip(branch_parts, dicts)):
                    if d is None:
                        continue
                    codes = bp[0]
                    cnt = bp[1]
                    safe = np.clip(codes, 0, len(d) - 1).astype(np.int64)
                    remap = np.searchsorted(
                        merged_dict, d[safe]).astype(np.int64)
                    branch_parts[bi] = [np.where(cnt > 0, remap, init)] \
                        + list(bp[1:])
            cat = [np.concatenate([bp[pi] for bp in branch_parts])
                   for pi in range(len(branch_parts[0]))]
            leaf_parts.append(cat)
            metas.append((func, ct0, merged_dict if merged_dict
                          is not None else dicts[0]))
        self._leaf_meta = metas
        sets = agg.grouping_sets if agg.grouping_sets is not None \
            else [list(range(len(names)))]
        shim = lp.Aggregate(agg.child, list(agg.group_by),
                            list(agg.aggs), sets)
        return self._grouping_sets_result(shim, leaves, key_cols,
                                          leaf_parts)

    # -- plan analysis -------------------------------------------------------

    def _split(self, plan: lp.Plan) -> Tuple[lp.Plan, Optional[lp.Plan]]:
        """Find the spine: the chain from the single big Scan up to the
        first Aggregate above it (or the highest supported node).  Returns
        (spine_head, top_plan); top_plan runs on the driver over the
        spine's result (None = the spine is the whole plan)."""
        target = self.fact_target

        chain: List[lp.Plan] = []

        def descend(node) -> bool:
            chain.append(node)
            if node is target:
                return True
            for c in node.children():
                if descend(c):
                    return True
            chain.pop()
            return False

        descend(plan)

        def spine_ok(node) -> bool:
            if isinstance(node, lp.Join):
                return node.kind in ("inner", "left", "semi", "anti",
                                     "nullaware_anti", "mark")
            if isinstance(node, lp.Window):
                # ranking / whole-partition aggregate windows run after a
                # partition-colocating exchange (shared legality check
                # with the NDS310 audit)
                return lowreg.spmd_window_ok(node)
            return isinstance(node, _SPINE_NODES)

        # longest spine-ok suffix of the chain ending at the fact scan;
        # if the node directly above it is a supported Aggregate, take it
        # as the spine top (the DEEPEST aggregate)
        ok_from = len(chain) - 1
        for i in range(len(chain) - 1, -1, -1):
            if spine_ok(chain[i]):
                ok_from = i
            else:
                break
        self._has_win = any(isinstance(nd, lp.Window)
                            for nd in chain[ok_from:])
        if ok_from > 0 and isinstance(chain[ok_from - 1], lp.Aggregate):
            self._check_agg(chain[ok_from - 1])
            spine = chain[ok_from - 1]
        else:
            spine = chain[ok_from]
        self._tail = None
        if not isinstance(spine, lp.Aggregate):
            # on-device row-spine tail: a Sort+Limit (or bare Limit)
            # directly above the spine becomes a top-k by (order keys,
            # original row id); the driver re-applies the tiny Sort/Limit
            # over exactly those rows
            i = ok_from - 1
            sort_keys = None
            if i >= 0 and isinstance(chain[i], lp.Sort):
                sort_keys = list(chain[i].keys)
                i -= 1
            if i >= 0 and isinstance(chain[i], lp.Limit) and \
                    chain[i].n and int(chain[i].n) > 0:
                self._tail = (sort_keys, int(chain[i].n))
        if not isinstance(spine, lp.Aggregate) and \
                self._tail is None and not self._has_win and not any(
                isinstance(nd, (lp.Join, lp.Filter)) or
                (isinstance(nd, lp.Scan) and nd.predicate is not None)
                for nd in spine.walk()):
            # a pass-through row spine (bare scan/project) would stream
            # the fact only to ship every row straight back
            raise DistUnsupported("row spine does no distributed work",
                                  code="NDS306")
        top = plan if spine is not plan else None
        return spine, top

    def _check_agg(self, node: lp.Aggregate) -> None:
        for _, e in node.aggs:
            for sub in e.walk():
                if isinstance(sub, ex.AggExpr):
                    if sub.func not in _AGG_FUNCS:
                        raise DistUnsupported(f"agg {sub.func} on spine",
                                              code="NDS302")
                    if sub.distinct and (isinstance(sub.arg, ex.Star)
                                         or sub.arg is None):
                        raise DistUnsupported("distinct star agg",
                                              code="NDS302")
                    if sub.distinct and node.grouping_sets is not None:
                        # a distinct count at the finest grouping cannot
                        # be re-combined into coarser rollup groups
                        raise DistUnsupported(
                            "distinct agg under grouping sets",
                            code="NDS302")
                if isinstance(sub, ex.WindowExpr):
                    raise DistUnsupported("window inside aggregate",
                                          code="NDS302")

    # -- spine preparation ---------------------------------------------------

    def _resolve_all(self, p: lp.Plan) -> None:
        for node in p.walk():
            if isinstance(node, lp.Scan) and node.predicate is not None:
                node.predicate = self.np_exec._resolve_subqueries(
                    node.predicate)
            elif isinstance(node, lp.Filter):
                node.condition = self.np_exec._resolve_subqueries(
                    node.condition)
            elif isinstance(node, lp.Project):
                node.exprs = [(n, self.np_exec._resolve_subqueries(e))
                              for n, e in node.exprs]

    def _prepare(self, p: lp.Plan) -> bool:
        """True when `p` contains the sharded scan; resolves join build
        sides on the driver as it walks."""
        if isinstance(p, lp.Scan):
            if p is self.fact_target:
                self.fact = p
                return True
            return False
        if isinstance(p, lp.Join):
            on_left = self._prepare(p.left)
            on_right = False if on_left else self._prepare(p.right)
            if not (on_left or on_right):
                return False
            kind = p.kind
            if kind not in lowreg.SPMD_SPINE_JOIN_KINDS:
                raise DistUnsupported(f"{kind} join on spine", code="NDS303")
            keys = list(p.keys)
            if not keys:
                raise DistUnsupported("non-equi join on spine", code="NDS304")
            if not on_left:
                if kind in lowreg.SPMD_REDUCIBLE_BUILD_JOIN_KINDS:
                    # this candidate can't continue (the join's output is
                    # the build side), but the probe-side anchor will take
                    # the join with a distributed reduced build
                    raise DistUnsupported(
                        f"sharded table on the build side of {kind} join",
                        code="NDS308")
                if kind != "inner":
                    raise DistUnsupported(
                        f"sharded table on the build side of {kind} join",
                        code="NDS303")
                keys = [(r, l) for l, r in keys]
            build_plan = p.right if on_left else p.left
            build = None
            if kind in lowreg.SPMD_REDUCIBLE_BUILD_JOIN_KINDS and not (
                    kind == "nullaware_anti" and p.extra is not None):
                reduced = self._reduce_build(p, keys, build_plan)
                if reduced is not None:
                    build, keys = reduced
            if build is None:
                build = self.np_exec.run(build_plan)
            probe_exprs = [l for l, _ in keys]
            bvalid = np.ones(build.num_rows, dtype=bool)
            key_parts = []
            key_dicts: List[Optional[np.ndarray]] = []
            fixed_spans: List[Optional[Tuple[int, int]]] = []
            for _, be in keys:
                c = ex.Evaluator(build).eval(be)
                if c.ctype.kind == "string":
                    # string keys join in the BUILD dictionary's code
                    # space; the probe translates its own codes through a
                    # host-built mapping (or uses them directly when both
                    # sides carry the same dictionary)
                    if c.dictionary is None:
                        raise DistUnsupported(
                            "string join key without dictionary",
                            code="NDS307")
                    key_parts.append(c.data.astype(np.int64))
                    key_dicts.append(c.dictionary)
                    fixed_spans.append((0, len(c.dictionary) + 1))
                elif c.ctype.kind in _KEY_KINDS:
                    key_parts.append(c.data.astype(np.int64))
                    key_dicts.append(None)
                    fixed_spans.append(None)
                else:
                    raise DistUnsupported(
                        f"{c.ctype.kind} join key on spine",
                        code="NDS307")
                bvalid &= c.validity()
            bkeys = np.zeros(build.num_rows, dtype=np.int64)
            radices: List[Tuple[int, int]] = []
            bound = 1
            for part, fixed in zip(key_parts, fixed_spans):
                if fixed is not None:
                    lo, span = fixed
                else:
                    lo = int(part.min()) if len(part) else 0
                    hi = int(part.max()) if len(part) else 0
                    span = hi - lo + 2
                bound *= span
                if bound >= 2 ** 62:
                    raise DistUnsupported("composite key domain overflow")
                radices.append((lo, span))
                bkeys = bkeys * span + np.clip(part - lo, 0, span - 1) + 1
            bkeys = np.where(bvalid, bkeys, np.int64(-1))
            order = self._stable_argsort(bkeys)
            skeys = bkeys[order]
            first_valid = int(np.searchsorted(skeys, 0))
            skeys = skeys[first_valid:]
            row_of = order[first_valid:]
            # the key runs of the sorted keys (np.unique's counts)
            counts = np.diff(np.concatenate(
                [[0], np.flatnonzero(skeys[1:] != skeys[:-1]) + 1,
                 [len(skeys)]]))
            unique = not len(counts) or int(counts.max()) == 1
            if not unique and kind == "inner" and self._dup_insensitive \
                    and not (set(build.column_names)
                             & self._refs_above_join(p, build_plan)):
                # an expanding inner join none of whose build columns
                # survive past the join, feeding a duplicate-insensitive
                # aggregate: probe existence suffices — a semi join
                # (q37/q82 inventory-expansion shape)
                kind = "semi"
            dup_max = 0
            # the JAX package's program has static shapes, so it tiles an
            # expanding join at most 8 copies a probe row and probes a
            # residual's run at most 32 deep, and refuses longer runs, a
            # left join's duplicates and an expansion on a shuffle build
            # side (_refuse_ragged); the port's spine runs eagerly, so
            # out of core it joins those by the runs' own lengths
            # (_ragged_join), and as the JAX package does everywhere else
            ragged = False
            if not unique:
                if kind == "left":
                    ragged = True
                    dup_max = int(counts.max())
                elif kind == "inner":
                    # bounded duplicate EXPANSION: the probe side tiles d
                    # copies per row, copy k matching the k-th duplicate
                    # in the build key run (q72's week_seq join)
                    dup_max = int(counts.max()) if len(counts) else 0
                    ragged = dup_max > 8
                elif p.extra is not None:
                    # semi/anti/mark with a residual: probe every
                    # duplicate in the key run (q16/q94 shape)
                    if kind == "nullaware_anti":
                        raise DistUnsupported(
                            "residual on nullaware anti join")
                    dup_max = int(counts.max()) if len(counts) else 0
                    ragged = dup_max > 32
            if ragged:
                self._refuse_ragged(kind, dup_max, p.extra)
            # exchange placement: the structural rule is rows-only; the
            # cost advisor may demote a byte-heavy under-row-limit build
            # to the shuffle path, only on order-insensitive (aggregate)
            # spines, so results stay identical to NDSTPU_COST=0
            strategy = "shuffle" if build.num_rows > self.broadcast_limit \
                else "broadcast"
            if self.cost_advisor is not None:
                d = self.cost_advisor.decide_join(
                    build_rows=build.num_rows,
                    build_bytes=_table_bytes(build), kind=kind,
                    dup_max=dup_max, order_safe=self._order_safe)
                obs.inc("engine.cost.decisions")
                if d.overrode:
                    obs.inc("engine.cost.overrides")
                self.cost_decisions.append({
                    "kind": kind, "strategy": d.strategy,
                    "structural": d.structural,
                    "build_rows": int(build.num_rows),
                    "build_bytes": _table_bytes(build),
                    "overrode": d.overrode, "reason": d.reason})
                strategy = d.strategy
            if strategy == "shuffle":
                if dup_max and kind == "inner" and not ragged:
                    self._refuse_ragged(kind, dup_max, "shuffle")
                    ragged = True
                sj = self._stage_shuffle_join(
                    p, kind, probe_exprs, radices, skeys, row_of, build,
                    on_left, bool((~bvalid).any()))
                sj.key_dicts = key_dicts
                sj.dup_max = dup_max
                sj.ragged = ragged
                self.joins[id(p)] = sj
            else:
                self.joins[id(p)] = _BroadcastJoin(
                    kind, p.mark, p.extra, probe_exprs, radices, skeys,
                    row_of, build, on_left,
                    build_has_null=bool((~bvalid).any()),
                    build_empty=build.num_rows == 0,
                    key_dicts=key_dicts, dup_max=dup_max, ragged=ragged)
            return True
        spine = False
        for c in p.children():
            spine = self._prepare(c) or spine
        return spine

    def _refuse_ragged(self, kind: str, dup_max: int, why) -> None:
        """Raise the JAX package's refusal of a join by whole key runs,
        unless the spine streams a fact held in host memory: out of core,
        falling through to the resident path cannot hold the fact, so the
        spine joins by whole key runs (``_ragged_join``) instead."""
        on_host = getattr(self.catalog, "on_host", None)
        if on_host is not None and on_host(self.fact_target.table,
                                           self.device):
            return
        if why == "shuffle":
            raise DistUnsupported(
                "expanding inner join on a shuffle build side")
        if kind == "left":
            raise DistUnsupported("non-unique build keys for left join")
        if kind == "inner":
            raise DistUnsupported(f"expanding inner join: build key runs "
                                  f"too long ({dup_max})")
        raise DistUnsupported(f"build key runs too long ({dup_max})")

    def _stable_argsort(self, keys: np.ndarray) -> np.ndarray:
        """``np.argsort(keys, kind="stable")``, on the session's device
        (a fact-sized build sorts in milliseconds on a card, seconds on
        the host)."""
        t = torch.as_tensor(keys).to(self.device)
        return torch.sort(t, stable=True)[1].cpu().numpy()

    def _refs_above_join(self, p: lp.Join, build_plan: lp.Plan) -> set:
        """Column names referenced anywhere on the spine OUTSIDE the
        given join's build subtree — the columns that must survive past
        the join.  The join's own keys and residual are excluded."""
        skip = {id(n) for n in build_plan.walk()}
        refs = set(self._agg_refs)

        def collect(e: ex.Expr) -> None:
            refs.update(nd.name for nd in e.walk()
                        if isinstance(nd, ex.ColumnRef))

        for nd in self._row_head.walk():
            if id(nd) in skip:
                continue
            if isinstance(nd, lp.Scan) and nd.predicate is not None:
                collect(nd.predicate)
            elif isinstance(nd, lp.Filter):
                collect(nd.condition)
            elif isinstance(nd, lp.Project):
                for _, e in nd.exprs:
                    collect(e)
            elif isinstance(nd, lp.Join):
                if nd is p:
                    continue   # own keys/extra are consumed here
                for le, re in nd.keys:
                    collect(le)
                    collect(re)
                if nd.extra is not None:
                    collect(nd.extra)
        return refs

    def _reduce_build(self, p: lp.Join, keys, build_plan: lp.Plan):
        """Distributed reduction of an existence-join build side that
        contains a sharded-size fact (q10/q35/q69 shape): semi/anti/
        nullaware_anti/mark joins ignore build-side row multiplicity, so
        a CHILD spine groups the build by the join keys (plus any
        residual-referenced build columns) and only the distinct tuples
        come back.  Returns (reduced build, rewritten keys) or None to
        keep the driver path — a child failure degrades, never errors."""
        if not any(isinstance(n, lp.Scan) and n.table in self.catalog and
                   self.catalog.get(n.table).num_rows >= self.threshold
                   for n in build_plan.walk()):
            return None
        group = [(f"__bk{i}", be) for i, (_pe, be) in enumerate(keys)]
        if p.extra is not None:
            names = _output_names(build_plan, self.catalog)
            if names is None:
                return None
            used = {nd.name for nd in p.extra.walk()
                    if isinstance(nd, ex.ColumnRef)}
            group += [(c, ex.ColumnRef(c)) for c in sorted(used
                                                           & set(names))]
        bplan = lp.Aggregate(build_plan, group, [], None)
        child = self._child()
        try:
            reduced = child.execute_plan(bplan)
        except (DistUnsupported, Unsupported) as e:
            code = getattr(e, "code", None)
            if code:
                self.attempt_codes.append(code)
            self.attempt_codes += child.attempt_codes
            return None
        self.attempt_codes += child.attempt_codes
        self.cost_decisions += child.cost_decisions
        self._adopt(child)
        self.build_reduced.append((p.kind, reduced.num_rows))
        obs.inc("engine.spmd.build_reduce")
        if self.cost_advisor is not None:
            obs.inc("engine.cost.decisions")
            self.cost_decisions.append({
                "kind": p.kind, "strategy": "build-reduce",
                "structural": "build-reduce",
                "build_rows": int(reduced.num_rows),
                "build_bytes": _table_bytes(reduced),
                "overrode": False,
                "reason": "existence build reduced to distinct key "
                          "tuples distributed"})
        new_keys = [(pe, ex.ColumnRef(f"__bk{i}"))
                    for i, (pe, _be) in enumerate(keys)]
        return reduced, new_keys

    def _stage_shuffle_join(self, p: lp.Join, kind: str, probe_exprs,
                            radices, skeys: np.ndarray, row_of: np.ndarray,
                            build: Table, on_left: bool,
                            build_has_null: bool) -> _ShuffleJoin:
        """Hash-partition the (too-large-to-broadcast) build side by the
        same splitmix64 bucket hash the probe shuffle uses; each
        partition is sorted by key for a local searchsorted probe, and
        build columns are gathered into partition order so the probe
        position indexes them directly."""
        nd = self.n_dev
        dest = (exchange.mix64_np(skeys.astype(np.uint64))
                % np.uint64(nd)).astype(np.int64)
        # one rank: every key's destination is 0 and the keys are sorted,
        # so the partition order is the keys' own
        order = np.lexsort((skeys, dest)) if nd > 1 else \
            np.arange(len(skeys))
        counts = np.bincount(dest, minlength=nd)
        part_cap = max(int(counts.max()) if len(skeys) else 0, 1)
        offs = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(len(skeys)) - offs[dest[order]]
        slot = dest[order] * part_cap + within
        keys_flat = np.full(nd * part_cap, _DEAD_KEY, np.int64)
        keys_flat[slot] = skeys[order]
        rowsel = row_of[order]
        cols_flat: Dict[str, tuple] = {}
        for name in build.column_names:
            c = build.column(name)
            data = np.zeros(nd * part_cap, c.data.dtype)
            valid = np.zeros(nd * part_cap, bool)
            data[slot] = c.data[rowsel]
            valid[slot] = c.validity()[rowsel]
            cols_flat[name] = (data, valid, c.ctype, c.dictionary)
        return _ShuffleJoin(
            kind, p.mark, p.extra, probe_exprs, radices, on_left,
            build_has_null, build.num_rows == 0, part_cap, keys_flat,
            cols_flat)

    # -- spine execution -----------------------------------------------------

    def _run_spine(self, spine: lp.Plan):
        agg = spine if isinstance(spine, lp.Aggregate) else None
        row_head = agg.child if agg is not None else spine
        if not self._prepared:
            # driver-side join staging runs ONCE per plan: skew retries
            # re-enter only to run again with a larger bucket slack
            with obs.span("spine_stage", cat="plan-node"):
                self._run_spine_stage(row_head, agg)
        return self._run_spine_exec(spine, agg, row_head)

    def _run_spine_stage(self, row_head, agg) -> None:
        self._resolve_all(row_head)
        if agg is not None:
            for _, e in agg.aggs + agg.group_by:
                for sub in e.walk():
                    if isinstance(sub, ex.SubqueryExpr):
                        raise DistUnsupported("subquery above row spine")
        # duplicate row multiplicity is invisible to the spine's
        # aggregate when every leaf is min/max or DISTINCT (or the
        # aggregate is a pure GROUP BY dedup) — _prepare may then demote
        # expanding inner joins to semi joins
        self._dup_insensitive = agg is not None and all(
            a.func in ("min", "max") or a.distinct
            for a in self._agg_leaves(agg))
        # an aggregate spine combines partials key-wise, so exchange
        # placement cannot change the observable result; a row spine
        # emits rows in placement order
        self._order_safe = agg is not None
        self._row_head = row_head
        self._agg_refs = set()
        if agg is not None:
            for _, e in agg.aggs + agg.group_by:
                self._agg_refs |= {
                    nd.name for nd in e.walk()
                    if isinstance(nd, ex.ColumnRef)}
        self._prepare(row_head)
        if (self._tail is not None or self._has_win) and any(
                (j.dup_max and j.kind == "inner") or j.ragged
                for j in self.joins.values()):
            # row ids number the pre-expansion fact rows; an expanding
            # inner join duplicates them, breaking the tiebreak
            raise DistUnsupported(
                "expanding inner join under a row-id tail/window")
        self._prepared = True

    def _run_spine_exec(self, spine: lp.Plan, agg, row_head):
        if self.fact is None:
            raise DistUnsupported("no sharded scan on spine")
        fact_table = self.catalog.get(self.fact.table)
        cols = self.fact.columns
        names = list(cols) if cols is not None else \
            list(fact_table.column_names)
        if not names:
            names = fact_table.column_names[:1]
        n = fact_table.num_rows
        agg_leaves = self._agg_leaves(agg) if agg is not None else []
        has_distinct = any(a.distinct for a in agg_leaves)
        # out-of-core: stream the fact through the device chunk by chunk
        # (partials combined on the host exactly like union branches).
        # DISTINCT needs every row of a group in one launch and a window
        # every row of a partition, so both keep the resident path;
        # device tails chunk fine (per-chunk top-k supersets).  A fact
        # the catalog holds in host memory always streams on a card,
        # in one chunk when the planner finds it fits
        chunk_rows, depth = self._resolve_stream(fact_table, names, n)
        on_host = getattr(self.catalog, "on_host", None)
        host_fact = on_host is not None and on_host(self.fact.table,
                                                    self.device)
        if chunk_rows is None and host_fact and self.chunk_rows is not None:
            chunk_rows = max(n, 1)
        if chunk_rows is not None and self._chunk_cap:
            chunk_rows = min(int(chunk_rows), self._chunk_cap)
        chunked = (chunk_rows is not None
                   and (n > chunk_rows or host_fact)
                   and not has_distinct and not self._has_win)
        shard_rows = max(n, 1)
        m = min(max(int(chunk_rows), 1), shard_rows) if chunked \
            else shard_rows
        n_launches = -(-shard_rows // m) if chunked else 1
        self._fact_metas = [(name, fact_table.column(name).ctype,
                             fact_table.column(name).dictionary)
                            for name in names]
        self._fact_names = names
        self._fact_n = n
        self._fact_m = m
        # chunked row-mode launches need the global id to restore the
        # single-launch row order on the host
        self._need_rowid = self._tail is not None or self._has_win \
            or (chunked and agg is None)
        self._emit_rowid = chunked
        self._agg_ctx = (agg, agg_leaves)
        self._has_distinct = has_distinct
        self._chunk_info = (chunked, n_launches, m, depth)
        why = None if chunked else (
            "distinct" if has_distinct else "window" if self._has_win
            else "fits")
        self.streams.append((self.fact.table, n, m, n_launches, why))
        obs.inc("engine.spmd.traces")
        if not chunked:
            with obs.span("spine_exec", cat="plan-node"):
                return self._post_spine(self._launch(self._fact_args(0), 0))
        self._build_stream(fact_table, names, n, m, n_launches, depth)
        with obs.span("spine_exec", cat="plan-node", chunked=True):
            return self._run_chunks()

    def _fact_args(self, ci: int) -> list:
        """The whole fact's columns on the device (the unchunked path):
        the compiling executor's device copy where it has one, which
        keeps its columns' static bounds."""
        dt = self.np_exec._table_device(self.fact.table, self._fact_names)
        n = self._fact_n
        args = []
        for name in self._fact_names:
            c = dt.columns[name]
            args += [c.data, c.valid]
        args.append(dt.alive if n else torch.zeros(
            1, dtype=torch.bool, device=self.device))
        self._fact_bounds = [dt.columns[nm].bounds
                             for nm in self._fact_names]
        return args

    def _resolve_stream(self, fact_table, names, n):
        """Resolve the session's chunk_rows / prefetch_depth setting to
        concrete values for this fact.  ``"auto"`` defers to the
        spill-aware planner (engine/memplan.py): chunk size and staging
        depth come from the device's free memory and this fact's scanned
        row width."""
        if self.chunk_rows == "auto":
            from ndstpu_torch.engine import memplan
            from ndstpu_torch.io import gdict
            # the port's planner also sees what the spine's joins make of
            # a chunk row (the JAX package's sizes the scanned row alone):
            # a tiled join's copies, and for a join by whole key runs
            # twice the rows, a guess that an out-of-memory halving
            # corrects (_run_spine_retrying)
            growth = 1
            for j in self.joins.values():
                if j.ragged:
                    growth *= 2
                elif j.dup_max and j.kind == "inner":
                    growth *= j.dup_max
            bpr = memplan.row_bytes(
                [_itemsize(fact_table.column(nm).data) for nm in names]) \
                * growth
            # string codes stream per chunk, but their dictionaries ride
            # the device whole-query — carve their bytes out
            dict_bytes = sum(
                gdict.dictionary_nbytes(fact_table.column(nm).dictionary)
                for nm in names
                if fact_table.column(nm).ctype.kind == "string")
            max_depth = self.prefetch_depth \
                if self.prefetch_depth is not None \
                else memplan.DEFAULT_MAX_DEPTH
            # broadcast builds ride the device whole-query — carve their
            # bytes out so fat builds buy smaller chunks, not spills
            resident = 0
            if self.cost_advisor is not None:
                resident = sum(
                    _table_bytes(j.build) for j in self.joins.values()
                    if isinstance(j, _BroadcastJoin))
            if self.device.type == "cuda":
                # the allocator's cached blocks count as free for the
                # stream: it owns the memory free when the spine starts
                torch.cuda.empty_cache()
            budget, source = memplan.device_budget_bytes(self.device)
            plan = memplan.plan_stream(n, bpr, self.n_dev,
                                       budget_bytes=budget,
                                       budget_source=source,
                                       max_depth=max_depth,
                                       dict_bytes=dict_bytes,
                                       resident_bytes=resident)
            obs.annotate(stream_plan=plan.describe())
            obs.set_gauge("engine.stream.chunk_rows",
                          plan.chunk_rows or 0)
            obs.set_gauge("engine.stream.prefetch_depth",
                          plan.prefetch_depth)
            return plan.chunk_rows, plan.prefetch_depth
        depth = self.prefetch_depth if self.prefetch_depth is not None \
            else 2
        return self.chunk_rows, max(int(depth), 0)

    def _build_stream(self, fact_table, names, n, m, n_launches,
                      depth) -> None:
        """Wire the streaming pipeline for a chunked fact: a
        :class:`~ndstpu_torch.io.loader.ChunkScanPool` reads chunks ahead
        on worker threads (from the catalog's registered
        :class:`~ndstpu_torch.io.loader.ChunkSource` when one exists, else
        a ``TableChunkSource`` over the table), and a
        :class:`~ndstpu_torch.engine.torchexec.ChunkPrefetcher` stages
        them onto the device while the current chunk computes.
        ``depth == 0`` makes both synchronous."""
        from ndstpu_torch.engine.torchexec import ChunkPrefetcher
        from ndstpu_torch.io import loader as io_loader
        source = self.catalog.streams.get(self.fact.table) \
            if hasattr(self.catalog, "streams") else None
        if source is not None and (
                source.num_rows != n
                or not set(names) <= set(getattr(source, "columns", []))):
            source = None   # stale or partial source: resident scan
        if source is None:
            source = io_loader.TableChunkSource(
                fact_table, self.fact.table, names)

        def host_chunk(ci: int):
            """Read launch ci: per column (data, valid or None), and the
            row count."""
            off = ci * m
            cnt = max(min(m, n - off), 0)
            payload = source.read(off, cnt)
            return [payload[nm] for nm in names], cnt

        self._release()
        # the scan runs one chunk further ahead than staging so staging
        # never waits on a cold read
        pool = io_loader.ChunkScanPool(
            host_chunk, list(range(n_launches)),
            workers=min(max(depth + 1, 1), 4),
            depth=depth + 1 if depth else 0)
        pool.start_ahead()
        self._stream_pool = pool
        self._prefetch = ChunkPrefetcher(pool.get, n_launches, m,
                                         self.device, depth=depth)

    def _ensure_stream(self) -> None:
        """A cached chunked executor run again: the ring and the pool
        were released after the last run; wire them anew."""
        if getattr(self, "_prefetch", None) is None:
            _chunked, n_launches, m, depth = self._chunk_info
            fact_table = self.catalog.get(self.fact.table)
            self._build_stream(fact_table, self._fact_names, self._fact_n,
                               m, n_launches, depth)

    def _run_chunks(self):
        """Out-of-core execution: stream fact chunks through the spine;
        combine per-chunk outputs on the host (aggregate partials
        re-group like union branches, row-mode chunks concatenate)."""
        self._ensure_stream()
        _chunked, n_launches, m, _depth = self._chunk_info
        agg, leaves = self._agg_ctx
        outs = []
        t_wall = time.monotonic()
        obs.inc("engine.stream.passes")
        for ci in range(n_launches):
            args = self._prefetch.get(ci)
            outs.append(self._launch(args, ci * m))
            del args
            obs.inc("engine.stream.chunks")
        obs.inc("engine.stream.execute_s", time.monotonic() - t_wall)
        self._release()
        for out in outs:
            self._note_host_gather(out)
        if agg is None:
            tables = [self._row_table(out) for out in outs]
            result = Table.concat(tables)
            rid = result.columns.get("__rowid__")
            if rid is not None:
                # launches come back in chunk order; the threaded global
                # row id restores the single-launch row order exactly
                # (stable: duplicates from expanding joins keep their
                # in-launch expansion order)
                result = result.gather(
                    np.argsort(rid.data, kind="stable"))
                result.columns.pop("__rowid__", None)
            return result
        parts = [(*self._unpack_agg(out), list(self._leaf_meta))
                 for out in outs]
        if self._emit_partials:
            # one "branch" worth of partials: chunks simply concatenate
            # (the union combiner re-groups duplicate keys anyway)
            kcs = [p[0] for p in parts]
            merged = Table.concat([Table(kc) for kc in kcs]) \
                if agg.group_by else Table({})
            key_cols = dict(merged.columns)
            leaf_parts = [
                [np.concatenate([p[1][li][pi] for p in parts])
                 for pi in range(len(parts[0][1][li]))]
                for li in range(len(leaves))]
            return key_cols, leaf_parts
        return self._finalize_union(agg, leaves, parts)

    def _post_spine(self, out):
        self._note_host_gather(out)
        agg, agg_leaves = self._agg_ctx
        if agg is not None:
            key_cols, leaf_parts = self._unpack_agg(out)
            if self._emit_partials:
                return key_cols, leaf_parts
            return self._finalize_from(agg, agg_leaves, key_cols,
                                       leaf_parts)
        return self._row_table(out)

    def _row_table(self, out) -> Table:
        """A row launch's output (device arrays: data, valid per column,
        then the alive mask) as a host table of its live rows."""
        flat, alive = out[:-1], out[-1]
        res = {}
        for i, (name, ctype, dictionary) in enumerate(self._row_meta):
            data = flat[2 * i][alive].cpu().numpy()
            valid = flat[2 * i + 1][alive].cpu().numpy()
            res[name] = Column(data, ctype,
                               None if valid.all() else valid, dictionary)
        return Table(res)

    # -- the spine body -------------------------------------------------------

    def _launch(self, args: list, off: int):
        """One launch of the spine over a chunk (``args``: data, valid
        per fact column, then the alive mask) whose first row is global
        row ``off``: its outputs."""
        metas = self._fact_metas
        nf = len(metas)
        col_args, alive_arg = args[:2 * nf], args[2 * nf]
        bounds = getattr(self, "_fact_bounds", None) \
            if not self._chunk_info[0] else None
        dcols = {}
        for i, (name, ctype, dictionary) in enumerate(metas):
            dcols[name] = DCol(col_args[2 * i], col_args[2 * i + 1],
                               ctype, dictionary,
                               bounds[i] if bounds else None)
        cap = int(alive_arg.shape[0])
        if self._need_rowid:
            # global pre-join row position: the deterministic tiebreak
            # that makes the device tail / window identical to the
            # single-launch stable sort
            base = torch.arange(off, off + cap, dtype=torch.int64,
                                device=self.device)
            dcols["__rowid__"] = DCol(
                base, torch.ones(cap, dtype=torch.bool,
                                 device=self.device), INT64)
        agg, agg_leaves = self._agg_ctx
        dt = self._exec(self._row_head, DTable(dcols, alive_arg))
        # DISTINCT needs every row of a group on one rank, as a window
        # every row of a partition: the JAX package exchanges rows by key
        # hash first; on the one rank they are all here already
        if agg is None:
            if self._tail is not None:
                return self._device_tail(dt)
            out_names = [nm for nm in dt.column_names if nm != "__rowid__"]
            if self._emit_rowid:
                # carried through so _run_chunks can restore the global
                # row order after the chunk concat (dropped host-side)
                out_names.append("__rowid__")
            self._row_meta = [(nm, dt.columns[nm].ctype,
                               dt.columns[nm].dictionary)
                              for nm in out_names]
            flat = []
            for nm in out_names:
                flat += [dt.columns[nm].data, dt.columns[nm].valid]
            return tuple(flat) + (dt.alive,)
        return self._agg_partials(agg, agg_leaves, dt)

    def _exec(self, p: lp.Plan, dt: DTable) -> DTable:
        if isinstance(p, lp.Scan):
            if p.predicate is not None:
                mask = JEval(dt).predicate(p.predicate)
                dt = DTable(dt.columns, dt.alive & mask)
            return dt
        if isinstance(p, lp.SubqueryAlias):
            dt = self._exec(p.child, dt)
            if p.column_aliases:
                cols = dict(dt.columns)
                rid = cols.pop("__rowid__", None)
                cols = dict(zip(p.column_aliases, cols.values()))
                if rid is not None:
                    cols["__rowid__"] = rid
                dt = DTable(cols, dt.alive)
            return dt
        if isinstance(p, lp.Filter):
            dt = self._exec(p.child, dt)
            mask = JEval(dt).predicate(p.condition)
            return DTable(dt.columns, dt.alive & mask)
        if isinstance(p, lp.Project):
            dt = self._exec(p.child, dt)
            evl = JEval(dt)
            out = {n: evl.eval(e) for n, e in p.exprs}
            rid = dt.columns.get("__rowid__")
            if rid is not None and "__rowid__" not in out:
                out["__rowid__"] = rid
            return DTable(out, dt.alive)
        if isinstance(p, lp.Window):
            dt = self._exec(p.child, dt)
            return self._exec_window_dist(p, dt)
        if isinstance(p, lp.Join):
            bj = self.joins.get(id(p))
            if bj is None:
                raise DistUnsupported("unprepared join on spine")
            dt = self._exec(p.left if bj.spine_left else p.right, dt)
            if isinstance(bj, _ShuffleJoin):
                return self._shuffle_join(bj, dt)
            return self._broadcast_join(bj, dt)
        raise DistUnsupported(f"{type(p).__name__} in spine")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def _probe_keys(self, evl: JEval, key_exprs, radices, cap,
                    key_dicts=None):
        """Radix-encode the probe-side key parts into one int64 plus
        NULL/out-of-domain masks (shared by broadcast + shuffle joins).
        String parts translate probe dictionary codes into the build
        dictionary's code space through a host-built mapping."""
        dev = self.device
        pkey = torch.zeros(cap, dtype=torch.int64, device=dev)
        pnull = torch.zeros(cap, dtype=torch.bool, device=dev)
        in_dom = torch.ones(cap, dtype=torch.bool, device=dev)
        dicts = key_dicts or [None] * len(radices)
        for e, (lo, span), kd in zip(key_exprs, radices, dicts):
            c = evl.eval(e)
            if kd is not None:
                if c.ctype.kind != "string" or c.dictionary is None:
                    raise DistUnsupported(
                        f"string key against {c.ctype.kind} probe",
                        code="NDS307")
                np_dict = c.dictionary
                from ndstpu_torch.io import gdict as _gdict
                codes = torch.clamp(c.data.to(torch.int64), 0,
                                    max(len(np_dict) - 1, 0))
                if _gdict.enabled() and len(kd) == len(np_dict) and \
                        np.array_equal(kd, np_dict):
                    # both sides carry the same code space: codes ARE
                    # the key parts, no translation table
                    obs.inc("engine.dict.identity_joins")
                    part = torch.where(
                        c.data >= 0, c.data.to(torch.int64),
                        torch.full_like(codes, len(kd)))
                elif len(np_dict) and len(kd):
                    pos = np.searchsorted(kd, np_dict)
                    posc = np.clip(pos, 0, len(kd) - 1)
                    ok = kd[posc] == np_dict
                    mapping = np.where(ok, posc,
                                       np.int64(len(kd))).astype(np.int64)
                    part = self._tensor(mapping)[codes]
                else:
                    mapping = np.full(max(len(np_dict), 1), len(kd),
                                      np.int64)
                    part = self._tensor(mapping)[codes]
            elif c.ctype.kind not in _KEY_KINDS:
                raise DistUnsupported(f"{c.ctype.kind} probe key",
                                      code="NDS307")
            else:
                part = c.data.to(torch.int64)
            pnull |= ~c.valid
            in_dom &= (part >= lo) & (part < lo + span - 1)
            pkey = pkey * span + torch.clamp(part - lo, 0, span - 1) + 1
        return pkey, pnull, in_dom

    def _shuffle_dev(self, sj: _ShuffleJoin) -> list:
        """The shuffle build's partitions on the device for this run:
        [keys, data0, valid0, ...]."""
        if sj.dev is None:
            sj.dev = [self._tensor(sj.keys_flat)] + [
                self._tensor(a) for (d, v, _, _) in sj.cols_flat.values()
                for a in (d, v)]
        return sj.dev

    def _shuffle_join(self, sj: _ShuffleJoin, dt: DTable) -> DTable:
        """Repartition the live spine rows to the rank owning their key
        bucket, then probe this rank's sorted build partition."""
        cap = dt.capacity
        dev = self.device
        pkey, pnull, in_dom = self._probe_keys(
            JEval(dt), sj.probe_key_exprs, sj.radices, cap, sj.key_dicts)
        pok = ~pnull & in_dom & dt.alive
        # one rank (the executor refuses more): every row's key bucket is
        # this rank's, and the JAX package's receive bucket of slack x
        # capacity slots drops none, so its exchange would only copy the
        # live rows, in their order, to the front of a table twice the
        # size; the probe reads them in place
        dcols, alive, ncap = dict(dt.columns), dt.alive, cap
        sl = self._shuffle_dev(sj)
        lkeys = sl[0]
        npart = lkeys.shape[0]
        if sj.ragged:
            bcols = {name: (sl[1 + 2 * i], sl[2 + 2 * i], ct, dic)
                     for i, (name, (_d, _v, ct, dic))
                     in enumerate(sj.cols_flat.items())}
            return self._ragged_join(DTable(dcols, alive), pkey, pok, lkeys,
                                     None, bcols, sj)
        if sj.dup_max and sj.extra is not None:
            # duplicate keys + residual (semi/anti/mark): probe the
            # whole key run; runs are contiguous inside a partition
            # because staging sorts each partition by key
            start = torch.searchsorted(lkeys, pkey)
            found = torch.zeros(ncap, dtype=torch.bool, device=dev)
            for k in range(sj.dup_max):
                posk = torch.clamp(start + k, 0, npart - 1)
                cand = (start + k < npart) & (lkeys[posk] == pkey) & pok
                bc = {}
                for i, (name, (_d, _v, ct, dic)) in enumerate(
                        sj.cols_flat.items()):
                    bc[name] = DCol(sl[1 + 2 * i][posk],
                                    sl[2 + 2 * i][posk] & cand, ct, dic)
                res = JEval(DTable({**dcols, **bc},
                                   alive)).predicate(sj.extra)
                found = found | (cand & res)
            combined = DTable(dcols, alive)
        else:
            pos = torch.searchsorted(lkeys, pkey)
            posc = torch.clamp(pos, 0, npart - 1)
            found = (lkeys[posc] == pkey) & pok
            bcols: Dict[str, DCol] = {}
            for i, (name, (_d, _v, ct, dic)) in enumerate(
                    sj.cols_flat.items()):
                bcols[name] = DCol(sl[1 + 2 * i][posc],
                                   sl[2 + 2 * i][posc] & found, ct, dic)
            combined = DTable({**dcols, **bcols}, alive)
            if sj.extra is not None:
                found = found & JEval(combined).predicate(sj.extra)
                bcols = {n: DCol(c.data, c.valid & found, c.ctype,
                                 c.dictionary) for n, c in bcols.items()}
                combined = DTable({**dcols, **bcols}, alive)
        if sj.kind == "inner":
            return DTable(combined.columns, alive & found)
        if sj.kind == "left":
            return combined
        if sj.kind == "semi":
            return DTable(dcols, alive & found)
        if sj.kind == "anti":
            return DTable(dcols, alive & ~found)
        if sj.kind == "nullaware_anti":
            if sj.extra is not None:
                raise DistUnsupported("residual on nullaware anti join")
            if sj.build_has_null:   # NOT IN (... NULL ...): never TRUE
                return DTable(dcols, torch.zeros(ncap, dtype=torch.bool,
                                                 device=dev))
            if sj.build_empty:      # NOT IN (empty): keep everything
                return DTable(dcols, alive)
            return DTable(dcols, alive & ~found & ~pnull)
        # mark
        out = dict(dcols)
        out[sj.mark] = DCol(found, torch.ones(ncap, dtype=torch.bool,
                                              device=dev), BOOL)
        return DTable(out, alive)

    def _broadcast_dev(self, bj: _BroadcastJoin) -> dict:
        """The broadcast build on the device for this run."""
        if bj.dev is None:
            bj.dev = {
                "skeys": self._tensor(bj.sorted_keys),
                "rowof": self._tensor(bj.row_of.astype(np.int64)),
                "cols": {name: (
                    self._tensor(bj.build.column(name).data).to(
                        torch_dtype(bj.build.column(name).ctype)),
                    self._tensor(bj.build.column(name).validity()))
                    for name in bj.build.column_names}}
        return bj.dev

    def _broadcast_join(self, bj: _BroadcastJoin, dt: DTable) -> DTable:
        cap = dt.capacity
        dev = self.device
        pkey, pnull, in_dom = self._probe_keys(
            JEval(dt), bj.probe_key_exprs, bj.radices, cap, bj.key_dicts)
        pvalid = ~pnull & in_dom & dt.alive
        bcols: Dict[str, DCol] = {}
        if bj.ragged and len(bj.sorted_keys):
            b = self._broadcast_dev(bj)
            cols = {name: (*b["cols"][name],
                           bj.build.column(name).ctype,
                           bj.build.column(name).dictionary)
                    for name in bj.build.column_names}
            return self._ragged_join(dt, pkey, pvalid, b["skeys"],
                                     b["rowof"], cols, bj)
        if len(bj.sorted_keys) == 0:
            # empty build side (a filter left no rows): no matches, and
            # there is nothing to gather from — emit typed NULL columns
            found = torch.zeros(cap, dtype=torch.bool, device=dev)
            for name in bj.build.column_names:
                c = bj.build.column(name)
                data = torch.zeros(cap, dtype=torch_dtype(c.ctype),
                                   device=dev)
                bcols[name] = DCol(data, torch.zeros(
                    cap, dtype=torch.bool, device=dev), c.ctype,
                    c.dictionary)
            combined = DTable({**dt.columns, **bcols}, dt.alive)
        elif bj.dup_max and bj.kind == "inner":
            # EXPANDING inner join: tile the probe side d times
            # (copy-major: expanded row k*cap+i is probe row i matched
            # against the k-th duplicate in its build key run)
            b = self._broadcast_dev(bj)
            d = bj.dup_max
            skeys, rowof = b["skeys"], b["rowof"]
            nb = len(bj.sorted_keys)
            start = torch.searchsorted(skeys, pkey)

            def tile(a):
                return torch.cat([a] * d)

            pos = tile(start) + torch.repeat_interleave(
                torch.arange(d, device=dev), cap)
            posc = torch.clamp(pos, 0, nb - 1)
            cand = (pos < nb) & (skeys[posc] == tile(pkey)) & tile(pvalid)
            bidx = rowof[posc]
            pcols = {n: DCol(tile(c.data), tile(c.valid), c.ctype,
                             c.dictionary)
                     for n, c in dt.columns.items()}
            for name in bj.build.column_names:
                c = bj.build.column(name)
                data, valid = b["cols"][name]
                bcols[name] = DCol(data[bidx], valid[bidx] & cand,
                                   c.ctype, c.dictionary)
            combined = DTable({**pcols, **bcols}, cand)
            if bj.extra is not None:
                cand = cand & JEval(combined).predicate(bj.extra)
                combined = DTable(combined.columns, cand)
            return combined
        elif bj.dup_max and bj.extra is not None:
            # duplicate build keys + residual (semi/anti/mark): probe
            # every candidate in the key run (q16/q94 shape)
            b = self._broadcast_dev(bj)
            skeys, rowof = b["skeys"], b["rowof"]
            nb = len(bj.sorted_keys)
            start = torch.searchsorted(skeys, pkey)
            found = torch.zeros(cap, dtype=torch.bool, device=dev)
            for k in range(bj.dup_max):
                posk = torch.clamp(start + k, 0, nb - 1)
                cand = (start + k < nb) & (skeys[posk] == pkey) & pvalid
                bidx_k = rowof[posk]
                bc = {}
                for name in bj.build.column_names:
                    c = bj.build.column(name)
                    data, valid = b["cols"][name]
                    bc[name] = DCol(data[bidx_k], valid[bidx_k] & cand,
                                    c.ctype, c.dictionary)
                res = JEval(DTable({**dt.columns, **bc},
                                   dt.alive)).predicate(bj.extra)
                found = found | (cand & res)
            combined = DTable(dt.columns, dt.alive)
        else:
            b = self._broadcast_dev(bj)
            skeys = b["skeys"]
            pos = torch.searchsorted(skeys, pkey)
            posc = torch.clamp(pos, 0, len(bj.sorted_keys) - 1)
            found = (skeys[posc] == pkey) & pvalid
            bidx = b["rowof"][posc]
            for name in bj.build.column_names:
                c = bj.build.column(name)
                data, valid = b["cols"][name]
                bcols[name] = DCol(data[bidx], valid[bidx] & found,
                                   c.ctype, c.dictionary)
            combined = DTable({**dt.columns, **bcols}, dt.alive)
            if bj.extra is not None:
                found = found & JEval(combined).predicate(bj.extra)
                bcols = {n: DCol(c.data, c.valid & found, c.ctype,
                                 c.dictionary) for n, c in bcols.items()}
                combined = DTable({**dt.columns, **bcols}, dt.alive)
        if bj.kind == "inner":
            return DTable(combined.columns, dt.alive & found)
        if bj.kind == "left":
            return combined
        if bj.kind == "semi":
            return DTable(dt.columns, dt.alive & found)
        if bj.kind == "anti":
            return DTable(dt.columns, dt.alive & ~found)
        if bj.kind == "nullaware_anti":
            if bj.extra is not None:
                raise DistUnsupported("residual on nullaware anti join")
            if bj.build_has_null:   # NOT IN (... NULL ...): never TRUE
                return DTable(dt.columns, torch.zeros(
                    cap, dtype=torch.bool, device=dev))
            if bj.build_empty:      # NOT IN (empty): keep everything
                return DTable(dt.columns, dt.alive)
            return DTable(dt.columns, dt.alive & ~found & ~pnull)
        # mark
        cols = dict(dt.columns)
        cols[bj.mark] = DCol(found, torch.ones(cap, dtype=torch.bool,
                                               device=dev), BOOL)
        return DTable(cols, dt.alive)

    def _ragged_join(self, dt: DTable, pkey, pvalid, keys, rowof, bcols,
                     j) -> DTable:
        """A join by whole key runs of any length, where the JAX package
        refuses one (a run longer than its static tiling, a left join's
        duplicates, an expansion on a shuffle build side).  ``keys`` are
        the sorted build keys, ``rowof`` maps a sorted position to its
        build row (None: the same), ``bcols`` name -> (data, valid,
        ctype, dictionary) by build row.  Each live keyed probe row
        (``pvalid``) meets every build row of its key's run, in run
        order: inner joins emit one row a match; a left join also emits
        a NULL-extended row for a live probe row no match (that passes
        the residual) joins; semi, anti and mark joins keep one row a
        probe row, found when a match passes the residual.  The output's
        size comes from the counts, read back once."""
        dev = self.device
        cap = dt.capacity
        nb = int(keys.shape[0])
        lo = torch.searchsorted(keys, pkey)
        cnt = torch.where(pvalid, torch.searchsorted(keys, pkey, right=True)
                          - lo, 0)
        left = j.kind == "left"
        emit = torch.where(dt.alive, torch.clamp(cnt, min=1), 0) if left \
            else cnt
        total = int(emit.sum())
        row = torch.repeat_interleave(
            torch.arange(cap, device=dev), emit, output_size=total)
        k = torch.arange(total, device=dev) - (
            torch.cumsum(emit, 0) - emit)[row]
        matched = k < cnt[row]
        pos = torch.clamp(lo[row] + k, 0, max(nb - 1, 0))
        bidx = pos if rowof is None else rowof[pos]
        if total == 0:
            # no output row: one dead row, as every table keeps
            row = torch.zeros(1, dtype=torch.int64, device=dev)
            bidx = torch.zeros(1, dtype=torch.int64, device=dev)
            matched = torch.zeros(1, dtype=torch.bool, device=dev)
            k = torch.ones(1, dtype=torch.int64, device=dev)
        probe = _gather_cols(dt.columns, row)
        built = {name: DCol(data[bidx], valid[bidx] & matched, ct, dic)
                 for name, (data, valid, ct, dic) in bcols.items()}
        passing = matched
        if j.extra is not None:
            passing = matched & JEval(DTable({**probe, **built},
                                             matched)).predicate(j.extra)
        if j.kind == "inner":
            return DTable({**probe, **built}, passing)
        if left:
            if j.extra is not None:
                built = {n: DCol(c.data, c.valid & passing, c.ctype,
                                 c.dictionary) for n, c in built.items()}
            hit = torch.zeros(cap, dtype=torch.int64, device=dev)
            hit.index_add_(0, row, passing.to(torch.int64))
            alive = passing | ((k == 0) & (hit[row] == 0)
                               & dt.alive[row])
            return DTable({**probe, **built}, alive)
        hit = torch.zeros(cap, dtype=torch.int64, device=dev)
        hit.index_add_(0, row, passing.to(torch.int64))
        found = hit > 0
        if j.kind == "semi":
            return DTable(dt.columns, dt.alive & found)
        if j.kind == "anti":
            return DTable(dt.columns, dt.alive & ~found)
        if j.kind == "mark":
            cols = dict(dt.columns)
            cols[j.mark] = DCol(found, torch.ones(cap, dtype=torch.bool,
                                                  device=dev), BOOL)
            return DTable(cols, dt.alive)
        raise DistUnsupported(f"{j.kind} join by whole key runs")

    # -- windows + device tail -------------------------------------------------

    def _exec_window_dist(self, p: lp.Window, dt: DTable) -> DTable:
        """Window functions, grouped by PARTITION BY list (the JAX
        package exchanges rows by partition-key hash for each list
        first), with the original row id as the deterministic ranking
        tiebreak."""
        groups: Dict[str, list] = {}
        gorder: List[str] = []
        for name, e in p.exprs:
            if not isinstance(e, ex.WindowExpr):
                raise DistUnsupported("non-window expr in Window node")
            gk = repr(tuple(e.partition_by))
            if gk not in groups:
                groups[gk] = []
                gorder.append(gk)
            groups[gk].append((name, e))
        for gk in gorder:
            exprs = groups[gk]
            cols = dict(dt.columns)
            for name, w in exprs:
                cols[name] = self._window_column_dist(dt, w)
            dt = DTable(cols, dt.alive)
        return dt

    def _window_column_dist(self, dt: DTable, w: ex.WindowExpr) -> DCol:
        """The window of ``w``: every row of a partition is on this
        rank, so local segment ops are exact.  Ranking sorts append __rowid__ as the last sort key;
        rank/dense_rank tie detection looks at the ORDER BY keys only.
        Running frames and subquery-bearing exprs never reach here
        (lowering.spmd_window_ok)."""
        cap = dt.capacity
        dev = self.device
        evl = JEval(dt)
        if w.partition_by:
            pcols = [evl.eval(e) for e in w.partition_by]
            pkeys = [_key_col(c, dt.alive) for c in pcols]
        else:
            pkeys = [torch.where(dt.alive, 0, 1).to(torch.int32)]
        pid, _, _ = _group_ids(pkeys)
        pid = pid.to(torch.int64)
        okeys = []
        for e, asc in w.order_by:
            c = evl.eval(e)
            okeys.append(self._dev_order_key(evl, c, asc, None))
        if w.func in ("row_number", "rank", "dense_rank"):
            ridk = dt.columns["__rowid__"].data.masked_fill(~dt.alive,
                                                            _DEAD_KEY)
            order = _lexsort_order([pid] + okeys + [ridk])
            idx = torch.arange(cap, dtype=torch.int64, device=dev)
            pid_s = pid[order]
            newpart = torch.ones(cap, dtype=torch.bool, device=dev)
            if cap > 1:
                newpart[1:] = pid_s[1:] != pid_s[:-1]
            part_start = torch.cummax(
                torch.where(newpart, idx, 0), 0).values
            pos_in_part = idx - part_start
            inv = torch.zeros(cap, dtype=torch.int64, device=dev)
            inv[order] = idx
            if w.func == "row_number":
                return DCol((pos_in_part + 1)[inv],
                            torch.ones(cap, dtype=torch.bool, device=dev),
                            INT64)
            tie = torch.zeros(cap, dtype=torch.bool, device=dev)
            if cap > 1:
                t = torch.ones(cap - 1, dtype=torch.bool, device=dev)
                for k in okeys:
                    ks = k[order]
                    t = t & (ks[1:] == ks[:-1])
                tie[1:] = t & ~newpart[1:]
            if w.func == "rank":
                last_nontie = torch.cummax(
                    torch.where(~tie, idx, 0), 0).values
                ranks = pos_in_part[last_nontie] + 1
            else:
                incr = torch.where(newpart, 0, (~tie).to(torch.int64))
                csum = torch.cumsum(incr, 0)
                base = torch.cummax(torch.where(newpart, csum, 0),
                                    0).values
                ranks = csum - base + 1
            return DCol(ranks[inv],
                        torch.ones(cap, dtype=torch.bool, device=dev),
                        INT64)
        if w.order_by:
            raise DistUnsupported("running window frame on spine")
        gid = pid
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        if w.func == "count" and (w.arg is None or
                                  isinstance(w.arg, ex.Star)):
            cnt = _segment_sum(dt.alive.to(torch.int64), gid, cap)
            return DCol(cnt[gid], ones, INT64)
        arg = evl.eval(w.arg)
        valid = arg.valid & dt.alive
        cnts = _segment_sum(valid.to(torch.int64), gid, cap)
        got = (cnts > 0)[gid]
        if w.func == "count":
            return DCol(cnts[gid], ones, INT64)
        if w.func == "sum":
            tot = self._seg_sum(
                _sum_input(arg.data, valid, arg.ctype.kind), gid, cap)
            if arg.ctype.kind == "decimal":
                return DCol(tot[gid], got,
                            columnar.decimal(38, arg.ctype.scale))
            if arg.ctype.kind in ("int32", "int64"):
                return DCol(tot[gid], got, INT64)
            return DCol(tot[gid], got, FLOAT64)
        if w.func == "avg":
            tot = self._seg_sum(
                _sum_input(arg.data, valid, arg.ctype.kind), gid, cap)
            mean = tot.to(torch.float64) / torch.clamp(cnts, min=1)
            if arg.ctype.kind == "decimal":
                mean = mean / (10 ** arg.ctype.scale)
            return DCol(mean[gid], got, FLOAT64)
        if w.func in ("min", "max"):
            is_min = w.func == "min"
            if arg.ctype.kind == "float64":
                init = float("inf") if is_min else -float("inf")
                vals = arg.data.masked_fill(~valid, init)
                return DCol(self._seg_minmax(vals, gid, cap, is_min)[gid],
                            got, arg.ctype)
            vals = _minmax_vals(arg.data, valid, arg.ctype.kind, is_min)
            out = self._seg_minmax(vals, gid, cap, is_min)[gid]
            return DCol(out.to(arg.data.dtype), got, arg.ctype,
                        arg.dictionary)
        raise DistUnsupported(f"window {w.func} on spine")

    @staticmethod
    def _seg_sum(vals: torch.Tensor, gid: torch.Tensor,
                 n: int) -> torch.Tensor:
        """Grouped sums: exact int64 for integers, float64 through
        :mod:`ndstpu_torch.engine.fp64` (jaxexec's compensated scan)."""
        if vals.dtype == torch.float64:
            from ndstpu_torch.engine import fp64
            return fp64.segment_sum_compensated(vals, gid, n)
        return _segment_sum(vals, gid, n)

    @staticmethod
    def _seg_minmax(vals: torch.Tensor, gid: torch.Tensor, n: int,
                    is_min: bool) -> torch.Tensor:
        """``jax.ops.segment_min``/``segment_max``: an empty segment
        holds the reduction's identity (the dtype's extremum)."""
        if vals.dtype.is_floating_point:
            init = float("inf") if is_min else -float("inf")
        else:
            info = torch.iinfo(vals.dtype)
            init = info.max if is_min else info.min
        out = torch.full((n,), init, dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, gid.to(torch.int64), vals,
                                   reduce="amin" if is_min else "amax",
                                   include_self=True)

    def _dev_order_key(self, evl: JEval, c: DCol, asc: bool,
                       nulls_first) -> torch.Tensor:
        """Order key of a spine sort key (torchexec's ``_order_key``):
        floats order via +/-inf, narrow ints in int32, else int64; NULLs
        follow nulls_first defaulting to the ascending side; dead rows
        strictly last."""
        if nulls_first is None:
            nulls_first = asc
        alive = evl.t.alive
        if c.ctype.kind == "float64":
            data = c.data.to(torch.float64)
            key = data if asc else -data
            key = key.masked_fill(~c.valid, -float("inf") if nulls_first
                                  else float("inf"))
            return key.masked_fill(~alive, float("inf"))
        if _narrow_span(c) is not None:
            data = c.data.to(torch.int32)
            key = data if asc else -data
            key = key.masked_fill(~c.valid,
                                  _NULL32 if nulls_first else -_NULL32)
            return key.masked_fill(~alive, _ORD_DEAD32)
        data = c.data.to(torch.int64)
        key = data if asc else -data
        key = key.masked_fill(~c.valid,
                              _NULL_KEY if nulls_first else -_NULL_KEY)
        return key.masked_fill(~alive, _DEAD_KEY)

    def _device_tail(self, dt: DTable):
        """On-device top-k tail: the top `limit` rows by (ORDER BY keys,
        original row id); the host fetches k rows instead of the whole
        relation and replays the suffix Sort/Limit over them.  The
        host's stable sort keeps exactly the (okeys, rowid)-least rows,
        the set selected here; a bare LIMIT degenerates to rowid order =
        original row order."""
        sort_keys, limit = self._tail
        cap = dt.capacity
        evl = JEval(dt)
        okeys = []
        for entry in (sort_keys or []):
            e, asc = entry[0], entry[1]
            nf = entry[2] if len(entry) > 2 else None
            try:
                c = evl.eval(e)
            except Unsupported as u:
                raise DistUnsupported(f"tail sort key: {u}", code=u.code)
            okeys.append(self._dev_order_key(evl, c, asc, nf))
        rid = dt.columns["__rowid__"].data
        ridk = rid.masked_fill(~dt.alive, _DEAD_KEY)
        k = min(limit, cap)
        order = _lexsort_order(okeys + [ridk])[:k]
        obs.inc("exchange.collective.calls")
        obs.inc("exchange.all_gather.calls")
        names = [nm for nm in dt.column_names if nm != "__rowid__"]
        if self._emit_rowid:
            # chunked tails: per-launch top-k supersets, so the host
            # combine needs the global row id to restore original order
            # before _finish replays Sort/Limit
            names.append("__rowid__")
        self._row_meta = [(nm, dt.columns[nm].ctype,
                           dt.columns[nm].dictionary) for nm in names]
        flat = []
        for nm in names:
            c = dt.columns[nm]
            flat += [c.data[order], c.valid[order]]
        return tuple(flat) + (dt.alive[order],)

    def _note_host_gather(self, out) -> None:
        """Bytes fetched device->host per spine launch: the live slots
        of agg partials (the first array of ``out`` is their alive mask)
        or of a row output (the last), which the device selects."""
        alive = out[0] if self._agg_ctx[0] is not None else out[-1]
        n = int(alive.sum())
        total = sum(n * a.element_size() for a in out)
        obs.inc("engine.spmd.host_gather_bytes", total)

    @staticmethod
    def _agg_leaves(agg: lp.Aggregate) -> List[ex.AggExpr]:
        leaves, seen = [], set()
        for _, e in agg.aggs:
            for sub in e.walk():
                if isinstance(sub, ex.AggExpr) and id(sub) not in seen:
                    seen.add(id(sub))
                    leaves.append(sub)
        return leaves

    def _agg_partials(self, agg: lp.Aggregate, leaves, dt: DTable):
        """Local sort-grouped partials, one slot a group in sorted key
        order.  At world size 1 the JAX package's all_gather and its
        replicated re-group over the gathered slots leave the slots as
        they are (each key tuple is already one slot, in the same sorted
        order), so they are not run.  Returns a flat tuple of device
        arrays: the slot alive mask, then (data, valid) per key column,
        then each leaf's partials."""
        evl = JEval(dt)
        dev = self.device
        key_cols = [(n, evl.eval(e)) for n, e in agg.group_by]
        self._key_meta = [(n, c.ctype, c.dictionary) for n, c in key_cols]
        if key_cols:
            keys = [_key_i64(c, dt.alive) for _, c in key_cols]
        else:
            keys = [torch.zeros(dt.capacity, dtype=torch.int64,
                                device=dev).masked_fill(~dt.alive,
                                                        _DEAD_KEY)]
        gid, order, newgrp = _group_ids(keys)
        gid = gid.to(torch.int64)
        starts = torch.nonzero(newgrp).flatten()
        ng = int(starts.shape[0])
        rep = order[starts]
        out_alive = _segment_sum(dt.alive.to(torch.int64), gid, ng) > 0
        flat = [out_alive]
        for _, c in key_cols:
            flat += [c.data[rep], c.valid[rep] & out_alive]
        self._leaf_meta = []
        for a in leaves:
            parts, meta = self._leaf_partial(dt, evl, a, gid, ng)
            self._leaf_meta.append(meta)
            flat += parts
        return tuple(flat)

    def _leaf_partial(self, dt: DTable, evl: JEval, a: ex.AggExpr, gid,
                      ng):
        """Per-slot partial arrays + static meta for one leaf
        aggregate."""
        alive = dt.alive
        if isinstance(a.arg, ex.Star) or a.arg is None:
            cnt = _segment_sum(alive.to(torch.int64), gid, ng)
            return [cnt], (a.func, None, None)
        c = evl.eval(a.arg)
        meta = (a.func, c.ctype, c.dictionary)
        valid = c.valid & alive
        if a.distinct:
            # rows were colocated by group key: keep only the first
            # (gid, value) occurrence — globally unique
            g2 = gid.masked_fill(~valid, ng)
            xkey = _key_i64(c, valid)
            dorder = _lexsort_order([g2, xkey])
            gs, xs = g2[dorder], xkey[dorder]
            first = torch.ones(gs.shape[0], dtype=torch.bool,
                               device=self.device)
            first[1:] = (gs[1:] != gs[:-1]) | (xs[1:] != xs[:-1])
            keep = torch.zeros_like(first)
            keep[dorder] = first & (gs < ng)
            valid = valid & keep
        cnt = _segment_sum(valid.to(torch.int64), gid, ng)
        if a.func == "count":
            return [cnt], meta
        if a.func in ("sum", "avg"):
            si = _sum_input(c.data, valid, c.ctype.kind)
            return [self._seg_sum(si, gid, ng), cnt], meta
        if a.func in ("min", "max"):
            is_min = a.func == "min"
            if c.ctype.kind == "float64":
                init = float("inf") if is_min else -float("inf")
                vals = c.data.to(torch.float64).masked_fill(~valid, init)
            else:
                init = _DEAD_KEY if is_min else -_DEAD_KEY
                vals = c.data.to(torch.int64).masked_fill(~valid, init)
            return [self._seg_minmax(vals, gid, ng, is_min), cnt], meta
        # stddev family: [s1, m2(centered), cnt] — see _host_leaf_partial
        x = c.data.to(torch.float64).masked_fill(~valid, 0.0)
        if c.ctype.kind == "decimal":
            x = x / (10 ** c.ctype.scale)
        s1 = self._seg_sum(x, gid, ng)
        mean = s1 / torch.clamp(cnt, min=1)
        d = (x - mean[gid]).masked_fill(~valid, 0.0)
        d1 = self._seg_sum(d, gid, ng)
        m2 = self._seg_sum(d * d, gid, ng) - torch.where(
            cnt > 0, d1 * d1 / torch.clamp(cnt, min=1), 0.0)
        return [s1, m2, cnt], meta

    # -- host finalize -------------------------------------------------------

    _PARTS_PER_FUNC = {"count": 1, "sum": 2, "avg": 2, "min": 2, "max": 2,
                       "stddev_samp": 3, "var_samp": 3, "stddev": 3,
                       "variance": 3}

    def _unpack_agg(self, out):
        """Flat spine output -> per-finest-group key Columns and raw leaf
        partial arrays, on the host."""
        final_alive = out[0]
        flat = [a[final_alive].cpu().numpy() for a in out[1:]]
        pos = 0
        key_cols: Dict[str, Column] = {}
        for name, ctype, dictionary in self._key_meta:
            data, valid = flat[pos], flat[pos + 1]
            pos += 2
            key_cols[name] = Column(
                data, ctype, None if valid.all() else valid, dictionary)
        leaf_parts: List[List[np.ndarray]] = []
        for a, meta in zip(self._agg_ctx[1], self._leaf_meta):
            func, _ctype, _dictionary = meta
            nparts = self._PARTS_PER_FUNC[func] if not (
                isinstance(a.arg, ex.Star) or a.arg is None) else 1
            leaf_parts.append([flat[pos + k] for k in range(nparts)])
            pos += nparts
        return key_cols, leaf_parts

    def _finalize_from(self, agg: lp.Aggregate, leaves, key_cols,
                       leaf_parts) -> Table:
        if agg.grouping_sets is not None:
            return self._grouping_sets_result(agg, leaves, key_cols,
                                              leaf_parts)
        leaf_final = {li: self._finalize_leaf(a, meta, parts)
                      for li, (a, meta, parts) in enumerate(
                          zip(leaves, self._leaf_meta, leaf_parts))}
        n_fine = len(next(iter(key_cols.values())).data) if key_cols \
            else (len(leaf_parts[0][0]) if leaf_parts else 0)

        if not agg.group_by and n_fine == 0:
            # SQL global aggregate over zero rows: one row, count 0 / NULL
            for li, (a, meta) in enumerate(zip(leaves, self._leaf_meta)):
                c = leaf_final[li]
                if a.func == "count":
                    leaf_final[li] = Column(
                        np.zeros(1, np.int64), INT64)
                else:
                    leaf_final[li] = Column(
                        np.zeros(1, c.data.dtype), c.ctype,
                        np.zeros(1, bool), c.dictionary)

        sub_cols = {f"__agg{li}": c for li, c in leaf_final.items()}
        gtable = Table({**key_cols, **sub_cols})
        out_cols: Dict[str, Column] = {}
        for name, _ in agg.group_by:
            out_cols[name] = key_cols[name]
        for name, e in agg.aggs:
            out_cols[name] = ex.Evaluator(gtable).eval(
                self._lower_expr(e, leaves))
        return Table(out_cols)

    def _grouping_sets_result(self, agg: lp.Aggregate, leaves,
                              key_cols: Dict[str, Column],
                              leaf_parts) -> Table:
        """ROLLUP/grouping sets: the spine aggregated at the FINEST
        grouping (all keys); each set re-combines those decomposable
        partials on the host — never re-touching the fact rows — then
        finalizes and evaluates the output expressions with
        ``grouping()`` resolved per set."""
        names = [n for n, _ in agg.group_by]
        n_fine = len(key_cols[names[0]].data) if names else (
            len(leaf_parts[0][0]) if leaf_parts else 0)
        outs: List[Table] = []
        for subset in agg.grouping_sets:
            sub_keys: List[Tuple[str, Column]] = []
            for i, name in enumerate(names):
                c = key_cols[name]
                if i in subset:
                    sub_keys.append((name, c))
                else:
                    sub_keys.append((name, Column(
                        np.zeros_like(c.data), c.ctype,
                        np.zeros(n_fine, bool), c.dictionary)))
            if names:
                gids, first = _factorize([c for _, c in sub_keys])
                ng = len(first)
            else:
                # global aggregate: one output row even over no groups
                gids = np.zeros(n_fine, np.int64)
                first = np.zeros(1, np.int64)
                ng = 1
            out_cols: Dict[str, Column] = {}
            for name, c in sub_keys:
                out_cols[name] = c.gather(first) if n_fine else Column(
                    np.zeros(0, c.data.dtype), c.ctype,
                    np.zeros(0, bool), c.dictionary)
            leaf_final: Dict[int, Column] = {}
            for li, (a, meta, parts) in enumerate(
                    zip(leaves, self._leaf_meta, leaf_parts)):
                combined = self._combine_host(a, meta, parts, gids, ng)
                leaf_final[li] = self._finalize_leaf(a, meta, combined)
            gtable = Table({**out_cols,
                            **{f"__agg{li}": c
                               for li, c in leaf_final.items()}})
            for name, e in agg.aggs:
                out_cols[name] = ex.Evaluator(gtable).eval(
                    self._lower_expr(e, leaves, gctx=(names, subset)))
            outs.append(Table(out_cols))
        return Table.concat(outs)

    def _combine_host(self, a: ex.AggExpr, meta, parts, gids, ng):
        """Numpy re-combine of finest-group partials into one grouping
        set's groups."""
        func = meta[0]
        has_arg = not (isinstance(a.arg, ex.Star) or a.arg is None)
        cnt = parts[-1] if has_arg and func != "count" else parts[0]
        if func in ("stddev_samp", "var_samp", "stddev", "variance") \
                and has_arg and len(parts) == 3:
            # Chan combine: M2 = sum m2_i + sum n_i (mean_i - mean)^2
            s1, m2, n_i = parts
            S1 = np.zeros(ng, np.float64)
            CNT = np.zeros(ng, np.int64)
            np.add.at(S1, gids, s1)
            np.add.at(CNT, gids, n_i)
            mean_tot = S1 / np.maximum(CNT, 1)
            mean_i = s1 / np.maximum(n_i, 1)
            dm = mean_i - mean_tot[gids]
            corr = np.zeros(ng, np.float64)
            np.add.at(corr, gids, np.where(n_i > 0, n_i * dm * dm, 0.0))
            M2 = np.zeros(ng, np.float64)
            np.add.at(M2, gids, m2)
            return [S1, M2 + corr, CNT]
        out = []
        for pi, part in enumerate(parts):
            if func in ("min", "max") and pi == 0 and has_arg:
                if part.dtype == np.float64:
                    init = np.inf if func == "min" else -np.inf
                else:
                    init = np.int64(_DEAD_KEY if func == "min"
                                    else -_DEAD_KEY)
                acc = np.full(ng, init, part.dtype)
                fold = np.minimum if func == "min" else np.maximum
                vals = np.where(cnt > 0, part, init)
                fold.at(acc, gids, vals)
                out.append(acc)
            else:
                acc = np.zeros(ng, part.dtype)
                np.add.at(acc, gids, part)
                out.append(acc)
        return out

    def _lower_expr(self, e: ex.Expr, leaves,
                    gctx: Optional[tuple] = None) -> ex.Expr:
        for li, a in enumerate(leaves):
            if a is e:
                return ex.ColumnRef(f"__agg{li}")
        if isinstance(e, ex.BinOp):
            return ex.BinOp(e.op, self._lower_expr(e.left, leaves, gctx),
                            self._lower_expr(e.right, leaves, gctx))
        if isinstance(e, ex.UnaryOp):
            return ex.UnaryOp(e.op,
                              self._lower_expr(e.operand, leaves, gctx))
        if isinstance(e, ex.Cast):
            return ex.Cast(self._lower_expr(e.operand, leaves, gctx),
                           e.target)
        if isinstance(e, ex.Func):
            if e.name == "grouping":
                # grouping(key) = 0 when the key participates in this
                # grouping set, 1 when rolled up (Spark semantics)
                if gctx is None:
                    return ex.Literal(0)
                names, subset = gctx
                arg = e.args[0]
                idx = names.index(arg.name) if isinstance(
                    arg, ex.ColumnRef) and arg.name in names else -1
                active = subset is None or idx in subset
                return ex.Literal(0 if active else 1)
            return ex.Func(e.name, tuple(self._lower_expr(a, leaves, gctx)
                                         for a in e.args))
        if isinstance(e, ex.Case):
            return ex.Case(
                tuple((self._lower_expr(c, leaves, gctx),
                       self._lower_expr(v, leaves, gctx))
                      for c, v in e.whens),
                self._lower_expr(e.default, leaves, gctx)
                if e.default is not None else None)
        if isinstance(e, ex.InList):
            return ex.InList(self._lower_expr(e.operand, leaves, gctx),
                             e.values, e.negated)
        if isinstance(e, ex.AggExpr):
            # an aggregate leaf the collection pass missed — bail to the
            # single-chip path rather than crash at finalize
            raise DistUnsupported("unlowered aggregate in output expr",
                                  code="NDS302")
        return e

    def _finalize_leaf(self, a: ex.AggExpr, meta, parts) -> Column:
        func, ctype, dictionary = meta
        if isinstance(a.arg, ex.Star) or a.arg is None or func == "count":
            return Column(parts[0].astype(np.int64), INT64)
        if func == "sum":
            s, cnt = parts
            got = cnt > 0
            vopt = None if got.all() else got
            if ctype.kind == "decimal":
                return Column(s.astype(np.int64),
                              columnar.decimal(38, ctype.scale), vopt)
            if ctype.kind in ("int32", "int64"):
                return Column(s.astype(np.int64), INT64, vopt)
            return Column(s.astype(np.float64), FLOAT64, vopt)
        if func == "avg":
            s, cnt = parts
            got = cnt > 0
            mean = s.astype(np.float64) / np.maximum(cnt, 1)
            if ctype.kind == "decimal":
                mean = mean / (10 ** ctype.scale)
            return Column(mean, FLOAT64, None if got.all() else got)
        if func in ("min", "max"):
            v, cnt = parts
            got = cnt > 0
            vopt = None if got.all() else got
            if ctype.kind == "float64":
                return Column(v.astype(np.float64), ctype, vopt)
            dtype = columnar.numpy_dtype(ctype)
            return Column(v.astype(dtype), ctype, vopt, dictionary)
        # stddev family: parts[1] is already the centered M2
        _s1, m2, cnt = parts
        ok = cnt > 1
        denom = np.where(ok, cnt - 1, 1)
        var = np.maximum(m2, 0.0) / denom
        data = var if func in ("var_samp", "variance") else np.sqrt(var)
        return Column(data, FLOAT64, None if ok.all() else ok)


# the union-distribution walk is shared with the static analyzer
# (lowering._audit_spine models the same split the executor performs)
_path_to = lowreg.plan_path_to
_distributive_path = lowreg.union_distributive_path


def _output_names(p: lp.Plan, catalog) -> Optional[List[str]]:
    """Static output column names of a plan (as the executors name each
    node's output), or None when unknown."""
    if isinstance(p, lp.Scan):
        if p.columns is not None:
            return list(p.columns) or \
                [catalog.get(p.table).column_names[0]]
        return list(catalog.get(p.table).column_names)
    if isinstance(p, lp.InlineTable):
        return list(p.table.column_names)
    if isinstance(p, lp.Project):
        return [n for n, _ in p.exprs]
    if isinstance(p, lp.Aggregate):
        return [n for n, _ in p.group_by] + [n for n, _ in p.aggs]
    if isinstance(p, lp.Window):
        base = _output_names(p.child, catalog)
        if base is None:
            return None
        return base + [n for n, _ in p.exprs if n not in base]
    if isinstance(p, (lp.Filter, lp.Sort, lp.Limit, lp.Distinct)):
        return _output_names(p.child, catalog)
    if isinstance(p, lp.SubqueryAlias):
        if p.column_aliases:
            return list(p.column_aliases)
        return _output_names(p.child, catalog)
    if isinstance(p, lp.SetOp):
        return _output_names(p.left, catalog)
    if isinstance(p, lp.Join):
        left = _output_names(p.left, catalog)
        if p.kind in ("semi", "anti", "nullaware_anti"):
            return left
        if p.mark is not None:
            return None if left is None else left + [p.mark]
        right = _output_names(p.right, catalog)
        if left is None or right is None:
            return None
        return left + right
    return None


def _graft(top: lp.Plan, old: lp.Plan, new: lp.Plan) -> lp.Plan:
    """Copy of `top` with the subtree `old` replaced by `new`."""
    if top is old:
        return new
    n = copy.copy(top)
    for attr in ("child", "left", "right"):
        c = getattr(n, attr, None)
        if c is not None:
            setattr(n, attr, _graft(c, old, new))
    return n

