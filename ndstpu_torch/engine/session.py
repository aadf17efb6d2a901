"""Engine session: SQL text in, result table out (ndstpu.engine.session).

``Session.sql`` runs the JAX package's main path: it keys each query by
its normalized text, plans it once through the text-keyed plan cache
(Planner + optimize, over the session's views), parameter-lifts the plan
(:func:`ndstpu_torch.analysis.canon.canonicalize`) and runs the
parameterized plan through :class:`CompilingExecutor.execute_cached`
under its canonical key, prefixed with the views epoch as the JAX
session prefixes it (a redefined view never replays the old graph), with
this rendering's literals as the binding: the key's first run discovers,
every later run — and every rendering of the template that shares the
key — replays (on CUDA, one captured graph).

The statements beyond queries are the JAX session's ``_run_ddl``: CREATE
[OR REPLACE] [TEMP] VIEW, CREATE TABLE AS, INSERT INTO, DELETE FROM and
DROP VIEW/TABLE.  Their queries (an INSERT's SELECT, a CTAS's, a
DELETE's subqueries) run keyless and eager, as the JAX session runs them,
with no discovery and no graph; the table edits stay on the device
(:mod:`ndstpu_torch.engine.dml`).

With a spine cache installed (:meth:`Session.install_spine_cache`, which
the in-process throughput scheduler calls), a query's shared spines —
the subtrees :mod:`ndstpu_torch.analysis.spines` flags as recurring
across the streams — are spliced out of its plan before it runs
(``_splice_spines``, the JAX session's): the first query to reach one
materializes it on the device, later queries read the cached device
table in its place, and the spliced plan re-canonicalizes to a key of its
own.

A query may run against a snapshot pin (:meth:`Session.pin_snapshot`, the
JAX session's): the catalog and views as they were when the pin was
taken.  A pin still at the live epoch runs the compiled path as any
query does, sharing the live plan-cache entry; a pin that a later DDL or
DML left behind plans against the pinned catalog and runs eagerly on the
session's device over the pinned tables, with no discovery and no graph
(the JAX session runs it on its host engine, which the port does not
have).

Out-of-core execution (the JAX session's ``backend="tpu"`` with
``spmd_chunk_rows``): with ``spmd_chunk_rows`` set (rows, or ``"auto"``)
every query first goes to the distributed plan executor over a one-rank
mesh (:mod:`ndstpu_torch.parallel.dplan`), which streams a fact larger
than a chunk — or, on a card, one the catalog holds in host memory —
through the device chunk by chunk.  Its executors are cached by the
views epoch, the canonical key and the binding's value hash, and run
again while the catalog versions hold (``engine.cache.spmd.{hit,miss}``).
A plan shape or expression outside the distributed subset
(``DistUnsupported``, ``Unsupported``) falls through to the compiling
executor, counted as ``engine.spmd.unsupported_fallbacks`` and
``engine.spmd.fallback.<code>`` and annotated on the query span; any
other failure is a defect, counted, warned and reported as a task
failure (``NDSTPU_SPMD_STRICT`` raises it), never silent.  The multi-rank
``tpu-spmd`` backend is a later slice.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ndstpu_torch import faults, obs
from ndstpu_torch.engine import columnar, dml, expr as ex, plan as lp
from ndstpu_torch.engine import spine as spine_mod
from ndstpu_torch.engine import planner as pl
from ndstpu_torch.engine.latch import KeyedLatch
from ndstpu_torch.engine.optimizer import optimize
from ndstpu_torch.engine.sql import (ast, normalize_sql_key, parse_statement,
                                     parse_statements)
from ndstpu_torch.engine.torchexec import (
    GROUPBY_DEFAULT,
    CompilingExecutor,
    TorchExecutor,
    Unsupported,
    resolve_device,
)
from ndstpu_torch.io.catalog import Catalog


@dataclass
class SnapshotPin:
    """An immutable catalog epoch captured at query admission (the JAX
    session's).  Catalog entries are replaced, never mutated, by DML, so
    shallow-copied dicts are a frozen, consistent view: a query planned
    and run against this pin sees the snapshot that existed when the pin
    was taken, whatever commits meanwhile.  The pin holds the pinned
    tables (and on a card their device tensors) for as long as it
    lives."""

    catalog: object
    views: Dict[str, lp.Plan]
    views_epoch: int
    versions: tuple  # sorted (table, version) catalog-version vector
    epoch: Optional[str] = None

    @property
    def state(self):
        """Cache-state tuple, the shape the live plan cache keys on."""
        return (self.views_epoch, self.versions)


class Session:
    """Holds the catalog and runs queries on one device:
    ``cuda`` unless ``device`` names another (``"cpu"`` for the tests).
    ``groupby`` picks the group-by strategy (torchexec.GROUPBY_MODES).

    Threads may share a session: the plan cache plans each text once
    (a per-key latch), and execution is serialized (the executor keeps
    per-query state; one device runs one graph at a time)."""

    def __init__(self, catalog, device=None,
                 groupby: str = GROUPBY_DEFAULT,
                 spmd_threshold: Optional[int] = None,
                 spmd_chunk_rows=None,
                 spmd_prefetch_depth: Optional[int] = None):
        if spmd_chunk_rows is not None and not (
                spmd_chunk_rows == "auto"
                or (isinstance(spmd_chunk_rows, int)
                    and not isinstance(spmd_chunk_rows, bool)
                    and spmd_chunk_rows > 0)):
            raise ValueError(
                f"spmd_chunk_rows must be a positive int, 'auto', or "
                f"None, got {spmd_chunk_rows!r}")
        if spmd_prefetch_depth is not None and (
                not isinstance(spmd_prefetch_depth, int)
                or isinstance(spmd_prefetch_depth, bool)
                or spmd_prefetch_depth < 0):
            raise ValueError(
                f"spmd_prefetch_depth must be a non-negative int or "
                f"None, got {spmd_prefetch_depth!r}")
        # out-of-core streaming: minimum table rows to take the
        # distributed path (None = dplan's default), the chunk rows (an
        # int, "auto" = memplan sizes chunks from the device's free
        # memory, None = off) and the staging ring's depth (0 =
        # synchronous, None = the planner's default)
        self.spmd_threshold = spmd_threshold
        self.spmd_chunk_rows = spmd_chunk_rows
        self.spmd_prefetch_depth = spmd_prefetch_depth
        # views epoch | canonical key | value hash -> (versions, executor)
        self._spmd_cache: Dict[str, tuple] = {}
        self._spmd_used = False
        self._spmd_errors: List[str] = []
        # the distributed executor of the last query (None: it fell
        # through or streaming is off)
        self.last_spmd = None
        self.catalog = catalog
        self.device = resolve_device(device)
        # the executor accessor (jaxexec's Session._jax_executor): one per
        # session, keeping the device tables and the compiled plans
        self.executor = CompilingExecutor(catalog, self.device,
                                          groupby=groupby)
        self._cache_lock = threading.RLock()
        self._exec_lock = threading.RLock()
        self._plan_latch = KeyedLatch()
        # normalized text -> ((views epoch, catalog versions), plan,
        # display names, CanonResult or None)
        self._plan_cache: Dict[str, tuple] = {}
        # temp views, and their epoch, bumped on every create and drop: it
        # prefixes the executor's keys and is part of the plan cache's state
        self.views: Dict[str, lp.Plan] = {}
        self._views_epoch = 0
        # cross-query spine sharing (install_spine_cache): the cache, each
        # text's eligible sites (with the identity of the plan they point
        # into), the spliced plans, and the spines made so far
        self.spine_cache: Optional[spine_mod.SpineCache] = None
        self._spine_sites_cache: Dict[str, tuple] = {}
        self._spine_splice_memo: Dict[tuple, tuple] = {}
        self._spines_made = 0
        # with a spine cache: normalized text -> (plan, key, binding) of
        # its last run, which may have spliced spines
        self._ran: Dict[str, tuple] = {}

    def fresh(self) -> "Session":
        """A new session over the same catalog and device that shares
        this one's device tables (the executor never writes them) and
        none of its plans, compiled plans or graphs: the power run's
        watchdog continues on one while an abandoned query still runs on
        this one."""
        new = Session(self.catalog, device=self.device,
                      groupby=self.executor.groupby_mode,
                      spmd_threshold=self.spmd_threshold,
                      spmd_chunk_rows=self.spmd_chunk_rows,
                      spmd_prefetch_depth=self.spmd_prefetch_depth)
        new.views, new._views_epoch = dict(self.views), self._views_epoch
        new.executor.share_tables(self.executor)
        return new

    def sql(self, text: str, pin: Optional[SnapshotPin] = None
            ) -> Optional[columnar.Table]:
        """Execute one statement; returns a query's result table on the
        host, None for DDL and DML.  With ``pin`` (from
        :meth:`pin_snapshot`) a query runs against that frozen catalog
        epoch whatever commits meanwhile; DDL or DML under a pin is an
        error."""
        return self._run(parse_statement(text), normalize_sql_key(text),
                         pin)

    def pin_snapshot(self) -> SnapshotPin:
        """Freeze the current catalog epoch for a query's lifetime.  Taken
        under the execution lock, which every DDL and DML statement holds,
        so a pin never sees half a statement."""
        with self._exec_lock:
            cat = Catalog(tables=dict(self.catalog.tables),
                          meta=dict(self.catalog.meta),
                          versions=dict(self.catalog.versions))
            pin = SnapshotPin(
                catalog=cat, views=dict(self.views),
                views_epoch=self._views_epoch,
                versions=tuple(sorted(cat.versions.items())),
                epoch=self.snapshot_epoch())
        obs.inc("engine.snapshot.pinned")
        return pin

    def _pin_matches_live(self, pin: SnapshotPin) -> bool:
        versions = tuple(sorted(self.catalog.versions.items()))
        return pin.views_epoch == self._views_epoch \
            and pin.versions == versions

    def sql_script(self, text: str) -> List[Optional[columnar.Table]]:
        """Execute each statement of a script, its queries keyless."""
        return [self._run(s) for s in parse_statements(text)]

    def _run(self, stmt: ast.Node, norm: Optional[str] = None,
             pin: Optional[SnapshotPin] = None
             ) -> Optional[columnar.Table]:
        # the whole statement is execute_s; the cold-path work nested in
        # it (discovery, capture) carries its own compile_s bucket, which
        # the tracer's self-time accounting subtracts
        with obs.span("statement", cat="plan-node", bucket="execute_s",
                      kind=type(stmt).__name__, device=str(self.device)):
            if not isinstance(stmt, ast.Query):
                if pin is not None:
                    raise ValueError(
                        "DDL/DML cannot run against a snapshot pin — pins "
                        "are read-only views of a committed epoch")
                with self._exec_lock:
                    return self._run_ddl(stmt)
            if norm is None:
                # keyless (a DML statement's query, a script's): planned
                # fresh and run eagerly, no discovery, no graph
                plan, _cols, disp = self._plan_fresh(stmt)
                with self._exec_lock:
                    faults.check("execute", key=None)
                    out = self._run_spmd(plan, None, None)
                    if out is None:
                        out = self.executor.execute_to_host(plan)
            else:
                plan, disp, canon = self._plan_cached(stmt, norm, pin)
                with self._exec_lock:
                    if pin is not None and not self._pin_matches_live(pin):
                        faults.check("execute", key=norm)
                        out = self._run_pinned(plan, pin)
                        return columnar.Table(
                            dict(zip(disp, out.columns.values())))
                    if self.spine_cache is not None:
                        plan, canon = self._splice_spines(plan, canon, norm)
                    run = self._exec_args(plan, canon, norm)
                    if self.spine_cache is not None:
                        self._ran[norm] = run
                    faults.check("execute", key=norm)
                    out = self._run_spmd(plan, norm, canon)
                    if out is None:
                        out = self.executor.execute_cached(*run, sql=norm)
            return columnar.Table(dict(zip(disp, out.columns.values())))

    # -- out-of-core execution (the JAX session's _execute :514-598) ---------

    def _run_spmd(self, plan: lp.Plan, key: Optional[str], canon
                  ) -> Optional[columnar.Table]:
        """Run a query through the distributed plan executor when
        out-of-core streaming is on; None when it is off or the plan
        falls through to the compiling executor."""
        if self.spmd_chunk_rows is None:
            return None
        from ndstpu_torch.parallel import dplan
        versions = tuple(sorted(self.catalog.versions.items()))
        cache = self._spmd_cache
        # shape-keyed cache: a canonical plan with an empty shape
        # residual is keyed on fingerprint + bound-value hash (the values
        # go back into literals before the spine runs, so distinct
        # bindings are distinct executors)
        spmd_plan, spmd_params = plan, None
        if canon is not None and not canon.residual:
            vh = hashlib.sha256(
                repr(canon.binding.values).encode()).hexdigest()[:16]
            ck = f"{self._views_epoch}|{canon.cache_key}|v{vh}"
            spmd_plan, spmd_params = canon.exec_plan, canon.binding
        else:
            ck = f"{self._views_epoch}|{key}" if key is not None else None
        ent = cache.get(ck) if ck else None
        if ent is not None and ent[0] != versions:
            # data changed: drop the stale executor and rebuild below
            del cache[ck]
            ent = None
        obs.inc("engine.cache.spmd.hit" if ent is not None
                else "engine.cache.spmd.miss")
        if ent is not None:
            try:
                out = self.executor._with_memory(ent[1].execute_again)
                self._spmd_used = True
                return out
            except Exception as e:  # noqa: BLE001
                # degrade a cached re-execution defect as a first-run
                # one: drop the executor, fall back
                del cache[ck]
                self._record_spmd_error(e)
                return None
        try:
            kw = {"dev_cache": self.executor._device_cache,
                  "device": self.device,
                  "chunk_rows": self.spmd_chunk_rows,
                  "cost_advisor": self._cost_advisor()}
            if self.spmd_threshold is not None:
                kw["shard_threshold_rows"] = self.spmd_threshold
            if self.spmd_prefetch_depth is not None:
                kw["prefetch_depth"] = self.spmd_prefetch_depth
            made = []

            def run():
                # a fresh executor for a rerun after out of memory
                made.append(dplan.DistributedPlanExecutor(
                    self.catalog, self._mesh(), **kw))
                return made[-1].execute_plan(spmd_plan, params=spmd_params)

            out = self.executor._with_memory(run)
            exe = made[-1]
            if ck:
                cache[ck] = (versions, exe)
            self._spmd_used = True
            self.last_spmd = exe
            return out
        except (dplan.DistUnsupported, Unsupported) as u:
            # a plan shape or expression outside the distributed subset:
            # the compiling executor runs it
            obs.inc("engine.spmd.unsupported_fallbacks")
            code = getattr(u, "code", None)
            obs.annotate(spmd_fallback=f"{code or 'uncoded'}: {u}")
            if code:
                obs.inc(f"engine.spmd.fallback.{code}")
            self.last_spmd = None
            self._note_chunk_fallthrough(u)
        except Exception as e:  # noqa: BLE001
            # a distributed-executor defect degrades to the compiling
            # executor, never silently (see _record_spmd_error)
            self.last_spmd = None
            self._record_spmd_error(e)
        return None

    def _note_chunk_fallthrough(self, u: Exception) -> None:
        """NDS311: chunked streaming was configured on a multi-rank mesh
        but this plan fell back to the single-device whole-fact path.  On
        the one-rank mesh the port runs, a fall-through is the JAX
        session's ``backend="tpu"`` case, counted above and not an
        NDS311."""
        if self._mesh().n_dev <= 1:
            return
        code = getattr(u, "code", None)
        msg = (f"NDS311: chunked streaming configured "
               f"(spmd_chunk_rows={self.spmd_chunk_rows!r}) but this plan "
               f"fell back to the single-device whole-fact path "
               f"({code or 'uncoded'}: {u})")
        obs.inc("engine.spmd.fallback.NDS311")
        obs.annotate(chunk_fallthrough=f"{code or 'uncoded'}")
        if os.environ.get("NDSTPU_SPMD_STRICT"):
            raise RuntimeError(msg) from u
        warnings.warn(msg, stacklevel=3)

    def _record_spmd_error(self, e: Exception) -> None:
        """A failure of the distributed executor other than
        DistUnsupported/Unsupported is a defect, not a capability gap:
        NDSTPU_SPMD_STRICT re-raises it, and otherwise it is counted
        (``engine.spmd.error_fallbacks``), the first one printed on
        stderr, and each one warned, which the power run reports as
        ``CompletedWithTaskFailures``."""
        obs.inc("engine.spmd.error_fallbacks")
        if os.environ.get("NDSTPU_SPMD_STRICT"):
            raise e
        if not self._spmd_errors:
            print(f"WARNING: distributed executor failed "
                  f"({type(e).__name__}: {e}); falling back to the "
                  f"compiling executor (further fallbacks collected in "
                  f"Session._spmd_errors)", file=sys.stderr)
        warnings.warn(f"distributed executor fell back to the compiling "
                      f"executor: {type(e).__name__}: {e}", stacklevel=2)
        self._spmd_errors.append(repr(e))

    def _mesh(self):
        m = getattr(self, "_mesh_cache", None)
        if m is None:
            from ndstpu_torch.parallel import mesh as pmesh
            m = self._mesh_cache = pmesh.make_mesh(1)
        return m

    def _cost_advisor(self):
        """Session-cached exchange-placement advisor (analysis/cost.py);
        re-checks the NDSTPU_COST kill switch a query."""
        from ndstpu_torch.analysis import cost
        if not cost.enabled():
            return None
        adv = getattr(self, "_cost_advisor_cache", None)
        if adv is None:
            from ndstpu_torch.analysis import lowering as lowreg
            adv = cost.default_advisor(lowreg.SPMD_BROADCAST_LIMIT_ROWS)
            self._cost_advisor_cache = adv
        return adv

    def _run_pinned(self, plan: lp.Plan, pin: SnapshotPin) -> columnar.Table:
        """A query whose pin a later DDL or DML left behind: its plan (made
        against the pinned catalog) run eagerly on this session's device
        over the pinned tables.  The live executor's device copies serve
        where the pin holds the same table version; a table replaced since
        the pin is read from the pin's own table.  The compiled plans and
        graphs are keyed to the live catalog, so none is used or made."""
        exe = TorchExecutor(pin.catalog, self.device,
                            groupby=self.executor.groupby_mode)
        with self.executor._exec_lock:
            exe.share_tables(self.executor)
            # out of memory with graphs held: evict them, run once more
            return self.executor._with_memory(
                lambda: exe.execute_to_host(plan))

    def _run_args(self, stmt: "ast.Query", norm: str):
        """What ``sql`` hands the executor for a query, spines not
        spliced: ``(plan, key, binding, display names)``."""
        plan, disp, canon = self._plan_cached(stmt, norm)
        return self._exec_args(plan, canon, norm) + (disp,)

    def _exec_args(self, plan, canon, norm: str) -> tuple:
        """``(plan, key, binding)`` of a planned query.  Under
        canonicalization (the shape-keyed compile cache) every rendering
        of a template shares one key, its literals bound; otherwise the
        plan runs under its normalized text with no binding.  The key
        carries the views epoch's prefix."""
        if canon is not None:
            return (canon.exec_plan, self._exec_key(canon.cache_key),
                    canon.binding)
        return plan, self._exec_key(norm), None

    def _exec_key(self, key: str) -> str:
        """The executor's key of a canonical key or normalized text."""
        return f"{self._views_epoch}|{key}"

    def snapshot_epoch(self) -> str:
        """An identity of this session's data: a tag over the views
        epoch and the catalog-version vector (the JAX session's
        in-memory tag; the lake epoch waits for the lake slice)."""
        versions = tuple(sorted(self.catalog.versions.items()))
        blob = repr((self._views_epoch, versions)).encode()
        return "mem" + hashlib.sha256(blob).hexdigest()[:12]

    def plan(self, text: str):
        """The optimized plan of one query and its output columns."""
        stmt = parse_statement(text)
        if not isinstance(stmt, ast.Query):
            raise ValueError("plan() expects a query")
        plan, cols, _disp = self._plan_fresh(stmt)
        return plan, cols

    def _plan_cached(self, stmt: "ast.Query", key: str,
                     pin: Optional[SnapshotPin] = None):
        """Plan + optimize + canonicalize through the text-keyed plan
        cache: ``(plan, display names, CanonResult or None)``.  One slot
        a text, replaced when the catalog versions change; concurrent
        threads plan a text once (later arrivals wait on its latch).

        A pinned query plans against the pin's catalog and views and keys
        the slot on the pin's state: a pin at the live epoch shares the
        live entry, and a pin that fell behind replaces it (and the next
        live run replaces it back)."""
        faults.check("plan", key=key)
        with self._plan_latch.holding(key):
            if pin is not None:
                state = pin.state
            else:
                state = (self._views_epoch,
                         tuple(sorted(self.catalog.versions.items())))
            with self._cache_lock:
                ent = self._plan_cache.get(key)
            if ent is not None and ent[0] != state:
                ent = None
            obs.inc("engine.cache.plan.hit" if ent is not None
                    else "engine.cache.plan.miss")
            if ent is not None:
                return ent[1:]
            with obs.span("plan", cat="plan-node"):
                plan, _cols, disp = self._plan_fresh(stmt, pin)
            canon = self._canonicalize(plan, key)
            with self._cache_lock:
                self._plan_cache[key] = (state, plan, disp, canon)
            return plan, disp, canon

    # -- cross-query spine sharing (engine/spine.py + analysis/spines.py) ----

    def install_spine_cache(self, cache: Optional[spine_mod.SpineCache]
                            ) -> None:
        """Share spines across the queries of this session through
        ``cache`` (None: stop).  The executor counts the cache's device
        bytes against its graph budget, and a table that leaves the cache
        takes the compiled plans that splice it with it."""
        with self._exec_lock:
            if self.spine_cache is not None:
                self.spine_cache.clear()
            self._ran.clear()
            if cache is not None:
                cache.on_evict = self._release_spine
            self.spine_cache = self.executor.spines = cache

    def _release_spine(self, table) -> None:
        """A spine left the cache: drop the spliced plans and compiled
        plans that hold it, so that its device memory is free."""
        for mk in [mk for mk in self._spine_splice_memo
                   if id(table) in mk[3]]:
            del self._spine_splice_memo[mk]
        self.executor.release_spine(table)

    def _spine_sites_for(self, plan: lp.Plan, key: str):
        """Eligible spine sites for one cached plan: the outermost
        non-overlapping shareable subtrees the analyzer flags
        (analysis/spines.py — shared rule set with the MQO audit).
        Memoized per query text; invalidated with the plan cache's
        state so site node references always point into the plan
        object `_plan_cached` currently serves."""
        from ndstpu_torch.analysis import spines as sp
        memo = self._spine_sites_cache
        ent = memo.get(key)
        if ent is not None and ent[0] is plan:
            return ent[1]
        sites = sp.eligible_sites(sp.subtree_sites(plan, query=key))
        with self._cache_lock:
            memo[key] = (plan, sites)
        return sites

    def spine_candidate_keys(self, text: str) -> set:
        """Value keys of the eligible spine sites in one query text —
        what the scheduler counts across streams to decide which spines
        are worth publishing (>= 2 occurrences)."""
        try:
            stmt = parse_statement(text)
            if not isinstance(stmt, ast.Query):
                return set()
            key = normalize_sql_key(text)
            plan, _disp, canon = self._plan_cached(stmt, key)
            if canon is None:
                return set()   # canonicalization off/failed: no splicing
            return {s.value_key for s in self._spine_sites_for(plan, key)}
        except Exception:  # noqa: BLE001 — unplannable text
            return set()

    def _splice_spines(self, plan: lp.Plan, canon, key: str):
        """Replace this plan's flagged spine subtrees with their
        materialized device tables (InlineTable), publishing on first use
        (the JAX session's ``_splice_spines``).

        Requires a successful canonicalization: the spliced plan
        re-canonicalizes before execution, and each spine's identity
        (``content_fp``, made when it is materialized) folds into that
        fingerprint, so the spliced and unspliced plans get distinct
        compile-cache entries by construction.  Runs under `_exec_lock`.
        A materialization failure propagates like any query failure;
        an analysis failure skips splicing and counts
        ``engine.spine.errors``.  A spine larger than the whole cache
        budget is not spliced: the query runs its subtree itself."""
        cache = self.spine_cache
        if not spine_mod.enabled() or cache is None or canon is None:
            return plan, canon
        try:
            sites = [s for s in self._spine_sites_for(plan, key)
                     if cache.eligible(s.value_key)]
        except Exception:  # noqa: BLE001 — analyzer defect: run unspliced
            obs.inc("engine.spine.errors")
            return plan, canon
        if not sites:
            return plan, canon
        state = (self._views_epoch,
                 tuple(sorted(self.catalog.versions.items())))
        hits = 0
        saved = 0
        replacements = {}
        spliced_keys = []
        for site in sites:
            vk = site.value_key
            with cache.holding(vk):
                t = cache.get(vk, state)
                if t is None:
                    obs.inc("engine.spine.miss")
                    cache.misses += 1
                    # materialize the subtree standalone, on the device;
                    # exceptions propagate as this query's failure
                    t = self.executor.materialize(site.node)
                    self._spines_made += 1
                    t.content_fp = f"T(spine:{vk}:{self._spines_made})"
                    if not cache.put(vk, state, t):
                        continue
                else:
                    hits += 1
                    cache.hits += 1
                    nbytes = spine_mod.table_bytes(t)
                    saved += nbytes
                    obs.inc("engine.spine.hit")
                    obs.inc("engine.spine.bytes", nbytes)
            replacements[id(site.node)] = lp.InlineTable(
                t, name=f"spine:{vk[:16]}")
            spliced_keys.append(vk)
        if hits:
            obs.annotate(spine_hits=hits, spine_bytes_saved=saved)
        if not replacements:
            return plan, canon
        # memo the spliced plan + its canon: same text + same spine
        # tables + same state = same splice (an evicted table's entries
        # go with it, _release_spine)
        mk = (key, tuple(spliced_keys), state,
              tuple(id(r.table) for r in replacements.values()))
        memo = self._spine_splice_memo
        ent = memo.get(mk)
        if ent is not None:
            return ent
        new_plan = spine_mod.replace_nodes(plan, replacements)
        canon2 = self._canonicalize(new_plan, key)
        if canon2 is None:
            # without a canonical key the spliced plan would collide
            # with the unspliced program under the text key — run
            # unspliced instead (correct, just unshared)
            return plan, canon
        if len(memo) >= 256:
            memo.pop(next(iter(memo)))
        memo[mk] = (new_plan, canon2)
        return new_plan, canon2

    @staticmethod
    def _canonicalize(plan, key: str):
        """Parameter-lift an optimized plan for shape-keyed compile
        caching; None (→ text keying) when canonicalization fails, as in
        the JAX session: a wrong analyzer costs compiles, never
        answers."""
        from ndstpu_torch.analysis import canon
        try:
            return canon.canonicalize(plan, query=key)
        except Exception:  # noqa: BLE001 — the analyzer, never the data
            return None

    def _plan_fresh(self, stmt: "ast.Query",
                    pin: Optional[SnapshotPin] = None):
        cat = self.catalog if pin is None else pin.catalog
        views = self.views if pin is None else pin.views
        planner = pl.Planner(cat, dict(views))
        plan, cols = planner.plan_query(stmt)
        # display names: strip alias qualifiers
        disp = self._dedupe(planner._display_names(cols))
        return optimize(plan, cat), cols, disp

    # -- DDL and DML (the JAX session's _run_ddl, _insert, _delete) ----------

    def _run_ddl(self, stmt: ast.Node) -> None:
        if isinstance(stmt, ast.CreateView):
            planner = pl.Planner(self.catalog, dict(self.views))
            plan, cols = planner.plan_query(stmt.query)
            disp = planner._display_names(cols)
            self.views[stmt.name] = lp.Project(
                plan, [(d, ex.ColumnRef(c)) for d, c in zip(
                    self._dedupe(disp), cols)])
            self._views_epoch += 1
            return None
        if isinstance(stmt, ast.CreateTableAs):
            t = self._run(stmt.query)
            self._replace(stmt.name, dml.on_device(t, self.device))
            return None
        if isinstance(stmt, ast.InsertInto):
            return self._insert(stmt)
        if isinstance(stmt, ast.DeleteFrom):
            return self._delete(stmt)
        if isinstance(stmt, ast.DropRel):
            self.views.pop(stmt.name, None)
            self._views_epoch += 1
            if stmt.kind == "table":
                self.catalog.unregister(stmt.name)
                self.executor.release_table(stmt.name)
            return None
        raise NotImplementedError(f"statement {type(stmt).__name__}")

    def _replace(self, name: str, table: columnar.Table) -> None:
        """Register ``table`` as ``name`` (its catalog version bumps) and
        let go of the old table's device copy and graphs."""
        self.catalog.register(name, table)
        self.executor.release_table(name)

    def _insert(self, stmt: ast.InsertInto) -> None:
        rows = self._run(stmt.query)
        target = self.catalog.get(stmt.table)
        if len(rows.column_names) != len(target.column_names):
            raise ValueError(
                f"INSERT INTO {stmt.table}: {len(rows.column_names)} values "
                f"for {len(target.column_names)} columns")
        # positional mapping, cast to the target's exact column types
        self._replace(stmt.table, dml.append(target, rows, self.device))
        return None

    def _delete(self, stmt: ast.DeleteFrom) -> None:
        target = self.catalog.get(stmt.table)
        if stmt.where is None:
            hit = torch.ones(target.num_rows, dtype=torch.bool,
                             device=self.device)
        else:
            planner = pl.Planner(self.catalog, dict(self.views))
            scope = pl.Scope()
            scope.add(pl.Source(stmt.table, target.column_names))
            bound = planner._bind(stmt.where, scope)
            hit = self.executor.where_mask(stmt.table, bound)
        # rows whose WHERE is FALSE or NULL stay
        self._replace(stmt.table, dml.keep(target, ~hit))
        return None

    @staticmethod
    def _dedupe(names: List[str]) -> List[str]:
        seen: Dict[str, int] = {}
        out = []
        for n in names:
            if n in seen:
                seen[n] += 1
                out.append(f"{n}_{seen[n]}")
            else:
                seen[n] = 0
                out.append(n)
        return out

    # -- compile-cache introspection and persistence -------------------------

    def canonical_key(self, text: str) -> str:
        """The key a query text runs under: its canonical plan key when
        canonicalization succeeds, its normalized text otherwise.  Two
        renderings of a template that differ only in bindable literals
        share it."""
        norm = normalize_sql_key(text)
        try:
            stmt = parse_statement(text)
            if not isinstance(stmt, ast.Query):
                return norm
            _plan, _disp, canon = self._plan_cached(stmt, norm)
        except Exception:  # noqa: BLE001 — unparseable/unplannable text
            return norm
        return canon.cache_key if canon is not None else norm

    def compiled_plan(self, text: str):
        """The compiled plan a query text runs (or None): its canonical
        key's, under its binding's memo signature (with spines spliced,
        the key its last run ran under)."""
        norm = normalize_sql_key(text)
        run = self._ran.get(norm)
        if run is None:
            run = self._run_args(parse_statement(text), norm)[:3]
        return self.executor.compiled(*run)

    def forget(self, text: str) -> None:
        """Drop the compiled plans a query text runs under, so that its
        next run starts cold."""
        run = self._ran.pop(normalize_sql_key(text), None)
        if run is not None:
            self.executor.forget(run[1])
        self.executor.forget(self._exec_key(self.canonical_key(text)))

    def compiled_count(self) -> int:
        """Number of compiled plans this session holds."""
        return len(self.executor._compiled)

    def save_compiled(self, path: str) -> int:
        """Persist the compiled plans' size-plan records."""
        return self.executor.save_compile_records(path)

    def preload_compiled(self, path: str) -> int:
        """Preload size-plan records: a later ``sql`` of one of their
        texts skips discovery and captures (or on the CPU replays) at
        once.  Records re-plan their SQL and re-canonicalize, so they
        register under the key a fresh rendering probes."""
        def plan_for_sql(sql):
            try:
                stmt = parse_statement(sql)
                if not isinstance(stmt, ast.Query):
                    return None
                key = normalize_sql_key(sql)
                plan, _disp, canon = self._plan_cached(stmt, key)
            except Exception:  # noqa: BLE001
                return None
            if canon is not None:
                return canon.exec_plan, self._exec_key(canon.cache_key)
            return plan, self._exec_key(key)

        if not os.path.exists(path):
            return 0
        return self.executor.load_compile_records(path, plan_for_sql)
