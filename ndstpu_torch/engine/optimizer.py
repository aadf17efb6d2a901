"""Logical plan optimizer.

Round-1 rule set (the ones that dominate NDS star-join performance):

1. predicate pushdown — through rename-Projects, split across Join sides,
   finally merged into Scan.predicate (evaluated on the raw table before
   anything else touches it; the TPU path also uses it for partition
   pruning on date_sk).
2. projection pruning — each operator keeps only columns its ancestors
   need; Scans record the narrowed column list (Scan.columns).

Both operate on the planner's invariant that all non-generated column names
are globally unique ("alias.col"), which makes substitution trivial.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ndstpu_torch.engine import expr as ex, plan as lp


# -- helpers -----------------------------------------------------------------


def _conjuncts(e: Optional[ex.Expr]) -> List[ex.Expr]:
    if e is None:
        return []
    if isinstance(e, ex.BinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _conjoin(parts) -> Optional[ex.Expr]:
    out = None
    for p in parts:
        out = p if out is None else ex.BinOp("and", out, p)
    return out


def _refs(e: ex.Expr) -> Set[str]:
    return {n.name for n in e.walk() if isinstance(n, ex.ColumnRef)}


def _substitute(e: ex.Expr, mapping: Dict[str, ex.Expr]) -> ex.Expr:
    if isinstance(e, ex.ColumnRef):
        return mapping.get(e.name, e)
    if isinstance(e, ex.BinOp):
        return ex.BinOp(e.op, _substitute(e.left, mapping),
                        _substitute(e.right, mapping))
    if isinstance(e, ex.UnaryOp):
        return ex.UnaryOp(e.op, _substitute(e.operand, mapping))
    if isinstance(e, ex.Cast):
        return ex.Cast(_substitute(e.operand, mapping), e.target)
    if isinstance(e, ex.Func):
        return ex.Func(e.name, tuple(_substitute(a, mapping) for a in e.args))
    if isinstance(e, ex.InList):
        return ex.InList(_substitute(e.operand, mapping), e.values, e.negated)
    if isinstance(e, ex.Case):
        return ex.Case(tuple((_substitute(c, mapping), _substitute(v, mapping))
                             for c, v in e.whens),
                       _substitute(e.default, mapping)
                       if e.default is not None else None)
    if isinstance(e, ex.AggExpr):
        if isinstance(e.arg, ex.Star):
            return e
        return ex.AggExpr(e.func, _substitute(e.arg, mapping), e.distinct)
    if isinstance(e, ex.WindowExpr):
        return ex.WindowExpr(
            e.func,
            None if e.arg is None or isinstance(e.arg, ex.Star)
            else _substitute(e.arg, mapping),
            tuple(_substitute(p, mapping) for p in e.partition_by),
            tuple((_substitute(o, mapping), a) for o, a in e.order_by),
            e.frame)
    return e


def _output_names(p: lp.Plan) -> List[str]:
    if isinstance(p, lp.Project):
        return [n for n, _ in p.exprs]
    if isinstance(p, lp.Aggregate):
        return [n for n, _ in p.group_by] + [n for n, _ in p.aggs]
    if isinstance(p, (lp.Filter, lp.Sort, lp.Limit, lp.Distinct)):
        return _output_names(p.child)
    if isinstance(p, lp.SetOp):
        return _output_names(p.left)
    if isinstance(p, lp.InlineTable):
        return list(p.table.column_names)
    if isinstance(p, lp.Window):
        return _output_names(p.child) + [n for n, _ in p.exprs]
    if isinstance(p, lp.Join):
        if p.kind == "mark":
            return _output_names(p.left) + [p.mark]
        if p.kind in ("semi", "anti", "nullaware_anti"):
            return _output_names(p.left)
        return _output_names(p.left) + _output_names(p.right)
    if isinstance(p, lp.Scan):
        raise RuntimeError("bare Scan in optimizer (planner wraps in Project)")
    if isinstance(p, lp.SubqueryAlias):
        return _output_names(p.child)
    raise RuntimeError(f"output names of {type(p).__name__}")


# -- predicate pushdown ------------------------------------------------------


def _factor_common(e: ex.Expr) -> ex.Expr:
    """Factor conjuncts common to every branch of a disjunction:
    (E and A) or (E and B)  ->  E and (A or B).

    The TPC-DS demographic-OR pattern (q13/q48/q85) repeats the join
    equalities inside each OR branch; factoring them out lets the join
    extraction below find the equi keys instead of cross-joining."""
    if isinstance(e, ex.BinOp) and e.op == "and":
        return ex.BinOp("and", _factor_common(e.left),
                        _factor_common(e.right))
    if not (isinstance(e, ex.BinOp) and e.op == "or"):
        return e
    branches: List[ex.Expr] = []

    def disjuncts(x: ex.Expr):
        if isinstance(x, ex.BinOp) and x.op == "or":
            disjuncts(x.left)
            disjuncts(x.right)
        else:
            branches.append(x)

    disjuncts(e)
    branch_conjs = [_conjuncts(b) for b in branches]
    common_repr = set(repr(c) for c in branch_conjs[0])
    for bc in branch_conjs[1:]:
        common_repr &= {repr(c) for c in bc}
    if not common_repr:
        return e
    common = [c for c in branch_conjs[0] if repr(c) in common_repr]
    residuals = []
    for bc in branch_conjs:
        rest = [c for c in bc if repr(c) not in common_repr]
        residuals.append(_conjoin(rest))
    if any(r is None for r in residuals):
        return _conjoin(common)  # some branch is exactly the common part
    disj = residuals[0]
    for r in residuals[1:]:
        disj = ex.BinOp("or", disj, r)
    return _conjoin(common + [disj])


def push_filters(p: lp.Plan) -> lp.Plan:
    if isinstance(p, lp.Filter):
        child = push_filters(p.child)
        conjs = _conjuncts(_factor_common(p.condition))
        return _push_conjuncts(child, conjs)
    for attr in ("child", "left", "right"):
        if hasattr(p, attr):
            setattr(p, attr, push_filters(getattr(p, attr)))
    return p


def _push_conjuncts(p: lp.Plan, conjs: List[ex.Expr]) -> lp.Plan:
    if not conjs:
        return p
    if isinstance(p, lp.Project):
        # only push through pure-rename/deterministic projections
        mapping = {n: e for n, e in p.exprs}
        pushable, stay = [], []
        for c in conjs:
            if all(r in mapping and not isinstance(
                    mapping[r], (ex.AggExpr, ex.WindowExpr))
                   for r in _refs(c)) and not _has_subquery(c):
                pushable.append(_substitute(c, mapping))
            else:
                stay.append(c)
        if pushable:
            p.child = _push_conjuncts(p.child, pushable)
        return lp.Filter(p, _conjoin(stay)) if stay else p
    if isinstance(p, lp.Join):
        lcols = set(_output_names(p.left))
        rcols = set(_output_names(p.right))
        lpush, rpush, stay = [], [], []
        for c in conjs:
            refs = _refs(c)
            # turn cross/inner joins + cross-side equality into equi-joins —
            # this is what makes comma-join star queries feasible
            if p.kind in ("cross", "inner") and \
                    isinstance(c, ex.BinOp) and c.op == "=":
                lr = _refs(c.left)
                rr = _refs(c.right)
                if lr and rr:
                    if lr <= lcols and rr <= rcols:
                        p.keys.append((c.left, c.right))
                        p.kind = "inner"
                        continue
                    if lr <= rcols and rr <= lcols:
                        p.keys.append((c.right, c.left))
                        p.kind = "inner"
                        continue
            if refs <= lcols and p.kind in ("inner", "left", "semi", "anti",
                                            "nullaware_anti", "cross",
                                            "mark"):
                lpush.append(c)
            elif refs <= rcols and p.kind in ("inner", "cross"):
                rpush.append(c)
            else:
                stay.append(c)
        if lpush:
            p.left = _push_conjuncts(p.left, lpush)
        if rpush:
            p.right = _push_conjuncts(p.right, rpush)
        return lp.Filter(p, _conjoin(stay)) if stay else p
    if isinstance(p, lp.Filter):
        return _push_conjuncts(p.child, conjs + _conjuncts(p.condition))
    if isinstance(p, lp.Scan):
        existing = _conjuncts(p.predicate)
        p.predicate = _conjoin(existing + conjs)
        return p
    if isinstance(p, (lp.Sort, lp.Limit)):
        # pushing past Limit changes semantics; past Sort is fine
        if isinstance(p, lp.Sort):
            p.child = _push_conjuncts(p.child, conjs)
            return p
        return lp.Filter(p, _conjoin(conjs))
    if isinstance(p, lp.Distinct):
        p.child = _push_conjuncts(p.child, conjs)
        return p
    return lp.Filter(p, _conjoin(conjs))


def _has_subquery(e: ex.Expr) -> bool:
    return any(isinstance(x, ex.SubqueryExpr) for x in e.walk())


# -- projection pruning ------------------------------------------------------


def prune(p: lp.Plan, needed: Optional[Set[str]] = None) -> lp.Plan:
    """Drop unused columns; `needed` = columns the parent requires
    (None = keep all outputs)."""
    if isinstance(p, lp.Project):
        if needed is not None:
            kept = [(n, e) for n, e in p.exprs if n in needed]
            if not kept and p.exprs:
                # keep one column as the row-count carrier (count(*) case)
                kept = [p.exprs[0]]
            p.exprs = kept
        child_needed: Set[str] = set()
        for _n, e in p.exprs:
            child_needed |= _refs(e)
        p.child = prune(p.child, child_needed)
        return p
    if isinstance(p, lp.Scan):
        if needed is not None:
            cols = set(needed)
            if p.predicate is not None:
                cols |= _refs(p.predicate)
            p.columns = sorted(cols)
        return p
    if isinstance(p, lp.Filter):
        child_needed = None if needed is None else \
            set(needed) | _refs(p.condition)
        p.child = prune(p.child, child_needed)
        return p
    if isinstance(p, lp.Join):
        if needed is None:
            p.left = prune(p.left, None)
            p.right = prune(p.right, None)
            return p
        child_needed = set(needed)
        for le, re_ in p.keys:
            child_needed |= _refs(le) | _refs(re_)
        if p.extra is not None:
            child_needed |= _refs(p.extra)
        lcols = set(_output_names(p.left))
        rcols = set(_output_names(p.right))
        p.left = prune(p.left, child_needed & lcols)
        p.right = prune(p.right, child_needed & rcols)
        return p
    if isinstance(p, lp.Aggregate):
        child_needed = set()
        for _n, e in p.group_by:
            child_needed |= _refs(e)
        for _n, e in p.aggs:
            child_needed |= _refs(e)
        p.child = prune(p.child, child_needed)
        return p
    if isinstance(p, lp.Window):
        child_needed = None if needed is None else set(needed)
        if child_needed is not None:
            for _n, e in p.exprs:
                child_needed |= _refs(e)
            child_needed &= set(_output_names(p.child))
        p.child = prune(p.child, child_needed)
        return p
    if isinstance(p, lp.Sort):
        child_needed = None if needed is None else set(needed)
        if child_needed is not None:
            for entry in p.keys:
                child_needed |= _refs(entry[0])
        p.child = prune(p.child, child_needed)
        return p
    if isinstance(p, (lp.Limit, lp.Distinct)):
        p.child = prune(p.child, needed if not isinstance(p, lp.Distinct)
                        else None)
        return p
    if isinstance(p, lp.SetOp):
        # set ops compare whole rows: keep all columns
        p.left = prune(p.left, None)
        p.right = prune(p.right, None)
        return p
    if isinstance(p, lp.SubqueryAlias):
        p.child = prune(p.child, needed)
        return p
    return p


# -- join reordering ---------------------------------------------------------


def _estimate_rows(p: lp.Plan, catalog, filtered: bool = True) -> float:
    """Crude cardinality estimate for join ordering (no stats yet):
    base table rows, decimated by pushed predicates (not where
    ``filtered`` is false: the rows before any filter).  An inner join
    keeps its larger side's rows, thinned by the smaller side's filters
    (a key join under independence), so a subquery that joins a fact to
    filtered dimensions is estimated as small as it is."""
    def est(q, f=filtered):
        return _estimate_rows(q, catalog, f)
    if isinstance(p, lp.Scan):
        n = float(catalog.get(p.table).num_rows) if catalog is not None \
            and p.table in catalog else 1e6
        return max(n / 20.0, 1.0) if p.predicate is not None and filtered \
            else n
    if isinstance(p, lp.Project):
        return est(p.child)
    if isinstance(p, lp.Filter):
        return max(est(p.child) / 20.0, 1.0) if filtered else est(p.child)
    if isinstance(p, (lp.Sort, lp.Distinct, lp.Window)):
        return est(p.child)
    if isinstance(p, lp.Limit):
        return min(float(p.n), est(p.child))
    if isinstance(p, lp.Aggregate):
        return max(est(p.child) / 100.0, 1.0)
    if isinstance(p, lp.Join):
        l, r = est(p.left), est(p.right)
        if p.kind in ("semi", "anti", "nullaware_anti", "mark"):
            return l
        if p.kind != "inner" or not p.keys or not filtered:
            return max(l, r)
        bl, br = est(p.left, False), est(p.right, False)
        big, small, small_base = (l, r, br) if bl >= br else (r, l, bl)
        return max(big * small / max(small_base, 1.0), 1.0)
    if isinstance(p, lp.InlineTable):
        return float(p.table.num_rows)
    if isinstance(p, lp.SetOp):
        return est(p.left) + est(p.right)
    return 1e6


def reorder_joins(p: lp.Plan, catalog) -> lp.Plan:
    """Flatten chains of inner/cross joins and rebuild greedily: start from
    the largest relation (the fact table), then repeatedly join the smallest
    key-connected relation — TPC-DS star/snowflake shapes resolve to
    fact-with-filtered-dims pipelines with no accidental cross joins."""
    for attr in ("child", "left", "right"):
        if hasattr(p, attr):
            setattr(p, attr, reorder_joins(getattr(p, attr), catalog))
    if not (isinstance(p, lp.Join) and p.kind in ("inner", "cross")):
        return p

    leaves: List[lp.Plan] = []
    keys: List[Tuple[ex.Expr, ex.Expr]] = []
    extras: List[ex.Expr] = []

    def flatten(n: lp.Plan):
        if isinstance(n, lp.Join) and n.kind in ("inner", "cross"):
            flatten(n.left)
            flatten(n.right)
            keys.extend(n.keys)
            if n.extra is not None:
                extras.append(n.extra)
        elif isinstance(n, lp.Filter) and isinstance(n.child, lp.Join) \
                and n.child.kind in ("inner", "cross"):
            # filters commute with inner joins: lift a mid-tree residual
            # (e.g. q72's inv_quantity_on_hand < cs_quantity, pushed onto
            # the syntactic cs x inventory join) so it cannot glue a
            # catastrophic join pair together; it is re-applied as soon
            # as its refs are joined below.
            extras.extend(_conjuncts(n.condition))
            flatten(n.child)
        else:
            leaves.append(n)

    flatten(p)
    if len(leaves) <= 2:
        return p

    cols: List[Set[str]] = [set(_output_names(l)) for l in leaves]
    sizes = [_estimate_rows(l, catalog) for l in leaves]

    def leaf_of(refs: Set[str]) -> Optional[int]:
        for i, cs in enumerate(cols):
            if refs <= cs:
                return i
        return None

    # key edges between leaves
    edges = []  # (li, ri, left_expr, right_expr) with li side expr first
    residual_keys = []
    for le, re_ in keys:
        li = leaf_of(_refs(le))
        ri = leaf_of(_refs(re_))
        if li is None or ri is None or li == ri:
            residual_keys.append((le, re_))
            continue
        edges.append((li, ri, le, re_))

    start = max(range(len(leaves)), key=lambda i: sizes[i])
    joined = {start}
    current: lp.Plan = leaves[start]
    remaining = set(range(len(leaves))) - joined
    used = [False] * len(edges)

    # residual-key equalities + lifted filters, applied as soon as every
    # referenced column is available (early filtering keeps expanding
    # joins like q72's inventory chain from materializing unfiltered)
    pending = [ex.BinOp("=", le, re_) for le, re_ in residual_keys] + extras
    avail = set(cols[start])

    def apply_ready(cur: lp.Plan) -> lp.Plan:
        nonlocal pending
        ready = [c for c in pending if _refs(c) <= avail]
        if ready:
            pending = [c for c in pending if not (_refs(c) <= avail)]
            cur = lp.Filter(cur, _conjoin(ready))
        return cur

    current = apply_ready(current)
    while remaining:
        # candidates connected to the joined set
        cand: Dict[int, List[int]] = {}
        for k, (li, ri, _le, _re) in enumerate(edges):
            if used[k]:
                continue
            if li in joined and ri in remaining:
                cand.setdefault(ri, []).append(k)
            elif ri in joined and li in remaining:
                cand.setdefault(li, []).append(k)
        if cand:
            nxt = min(cand, key=lambda i: sizes[i])
            pair_keys = []
            for k in cand[nxt]:
                li, ri, le, re_ = edges[k]
                used[k] = True
                if li in joined:
                    pair_keys.append((le, re_))
                else:
                    pair_keys.append((re_, le))
            current = lp.Join(current, leaves[nxt], "inner", pair_keys)
        else:
            nxt = min(remaining, key=lambda i: sizes[i])
            current = lp.Join(current, leaves[nxt], "cross", [])
        joined.add(nxt)
        remaining.discard(nxt)
        avail |= set(cols[nxt])
        current = apply_ready(current)

    cond = _conjoin(pending)
    return lp.Filter(current, cond) if cond is not None else current


def _plan_exprs(p: lp.Plan) -> List[ex.Expr]:
    if isinstance(p, lp.Scan):
        return [p.predicate] if p.predicate is not None else []
    if isinstance(p, lp.Filter):
        return [p.condition]
    if isinstance(p, lp.Project):
        return [e for _n, e in p.exprs]
    if isinstance(p, lp.Join):
        out = [e for pair in p.keys for e in pair]
        if p.extra is not None:
            out.append(p.extra)
        return out
    if isinstance(p, lp.Aggregate):
        return [e for _n, e in p.group_by] + [e for _n, e in p.aggs]
    if isinstance(p, lp.Window):
        return [e for _n, e in p.exprs]
    if isinstance(p, lp.Sort):
        return [entry[0] for entry in p.keys]
    return []


def _pivot_sum_case(e: ex.Expr):
    """Match ``sum(CASE WHEN scrut = lit THEN value END)`` (the TPC-DS
    day-of-week / channel pivot idiom); -> (scrut, lit, value) or None."""
    if not isinstance(e, ex.AggExpr) or e.func != "sum" or e.distinct:
        return None
    c = e.arg
    if not isinstance(c, ex.Case) or len(c.whens) != 1:
        return None
    if c.default is not None and not (
            isinstance(c.default, ex.Literal) and c.default.value is None):
        return None
    cond, val = c.whens[0]
    if not (isinstance(cond, ex.BinOp) and cond.op == "="):
        return None
    if isinstance(cond.right, ex.Literal) and \
            not isinstance(cond.left, ex.Literal):
        return cond.left, cond.right, val
    if isinstance(cond.left, ex.Literal) and \
            not isinstance(cond.right, ex.Literal):
        return cond.right, cond.left, val
    return None


def _try_pivot(p: lp.Aggregate) -> Optional[lp.Plan]:
    if p.grouping_sets is not None or not p.aggs:
        return None
    pivots: Dict[int, tuple] = {}
    plains: Dict[int, ex.AggExpr] = {}
    for i, (_name, e) in enumerate(p.aggs):
        pat = _pivot_sum_case(e)
        if pat is not None:
            pivots[i] = pat
        elif isinstance(e, ex.AggExpr) and not e.distinct and \
                e.func in ("sum", "count", "min", "max"):
            plains[i] = e
        else:
            return None
    if len(pivots) < 3:
        return None
    scrut = None
    for s, _lit, _v in pivots.values():
        if scrut is None:
            scrut = s
        elif s != scrut:  # frozen expr dataclasses: structural equality
            return None
    vals: List[ex.Expr] = []
    for _s, _lit, v in pivots.values():
        if all(v != u for u in vals):
            vals.append(v)

    l1_aggs: List[tuple] = [
        (f"__pv_v{j}", ex.AggExpr("sum", v)) for j, v in enumerate(vals)]
    for i, e in plains.items():
        l1_aggs.append((f"__pv_p{i}", ex.AggExpr(e.func, e.arg)))
    l1 = lp.Aggregate(p.child, list(p.group_by) + [("__pv_s", scrut)],
                      l1_aggs, None)

    l2_groups = [(n, ex.ColumnRef(n)) for n, _e in p.group_by]
    l2_aggs: List[tuple] = []
    for i, (name, e) in enumerate(p.aggs):
        if i in pivots:
            _s, lit, v = pivots[i]
            j = next(j for j, u in enumerate(vals) if u == v)
            cond = ex.BinOp("=", ex.ColumnRef("__pv_s"), lit)
            l2_aggs.append((name, ex.AggExpr(
                "sum", ex.Case(((cond, ex.ColumnRef(f"__pv_v{j}")),),
                               ex.Literal(None, None)))))
        else:
            e = plains[i]
            # counts recombine by SUM; min/max by min/max.  Partial
            # counts are never NULL, but a KEYLESS rewrite over empty
            # input has zero partial rows and sum-over-nothing is NULL
            # where count must be 0 — coalesce restores the contract
            # (grouped aggregates can't hit this: empty groups don't
            # exist on either side).
            func = "sum" if e.func in ("sum", "count") else e.func
            recombined: ex.Expr = ex.AggExpr(
                func, ex.ColumnRef(f"__pv_p{i}"))
            if e.func == "count" and not p.group_by:
                recombined = ex.Func(
                    "coalesce", (recombined, ex.Literal(0, None)))
            l2_aggs.append((name, recombined))
    return lp.Aggregate(l1, l2_groups, l2_aggs, None)


def _refs_counter(p: lp.Plan, out) -> None:
    for e in _plan_exprs(p):
        for n in e.walk():
            if isinstance(n, ex.ColumnRef):
                out[n.name] += 1
    for c in p.children():
        _refs_counter(c, out)


def null_filter_to_anti(p: lp.Plan) -> lp.Plan:
    """``Filter(right_key IS NULL, LEFT JOIN)`` -> ANTI JOIN.

    The q78-family refresh-exclusion idiom (``left join store_returns
    on sr_ticket_number = ss_ticket_number ... where sr_ticket_number
    is null``) materializes the full joined width with duplicate-key
    run expansion, then throws the matches away; an anti join is a
    mask over the probe side.  Sound because equality keys never match
    NULLs: a surviving row's right columns are all NULL, so the
    conversion wraps the anti join in a Project restoring each right
    KEY column as a NULL literal (prune drops the unreferenced ones).
    A reference to any NON-key right column — from the remaining
    conjuncts OR any ancestor node (the select list may legally emit
    an all-NULL right column) — blocks the rewrite: that name would no
    longer resolve.  Ancestor references are detected by ref-count
    difference against the whole tree (planner invariant: column names
    are globally unique)."""
    import collections
    while True:
        total = collections.Counter()
        _refs_counter(p, total)
        p, changed = _null_filter_to_anti(p, total)
        if not changed:
            return p


def _null_filter_to_anti(p: lp.Plan, total):
    """One rewrite per call (the ref-count snapshot goes stale once the
    tree changes); returns (plan, changed)."""
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, lp.Plan):
            nv, changed = _null_filter_to_anti(v, total)
            if changed:
                setattr(p, f.name, nv)
                return p, True
    if not (isinstance(p, lp.Filter) and isinstance(p.child, lp.Join)
            and p.child.kind == "left" and p.child.keys
            and p.child.extra is None):
        return p, False
    j = p.child
    try:
        right_names = set(_output_names(j.right))
        left_names = _output_names(j.left)
    except RuntimeError:
        return p, False
    right_keys = {e.name for _l, e in j.keys
                  if isinstance(e, ex.ColumnRef)}
    if len(right_keys) != len(j.keys):
        return p, False  # a computed right key: cannot restore as NULL
    rest = []
    fired = False
    for c in _conjuncts(p.condition):
        if not fired and isinstance(c, ex.UnaryOp) and \
                c.op == "isnull" and \
                isinstance(c.operand, ex.ColumnRef) and \
                c.operand.name in right_keys:
            fired = True
            continue
        rest.append(c)
    if not fired or any(_refs(c) & (right_names - right_keys)
                        for c in rest):
        return p, False
    # ancestor-reference guard: every reference to a non-key right
    # column must live inside THIS subtree (conjuncts already checked
    # reference none, so any count surplus is an ancestor's)
    import collections
    inside = collections.Counter()
    _refs_counter(p, inside)
    for name in right_names - right_keys:
        if total[name] > inside[name]:
            return p, False
    j.kind = "anti"
    out: lp.Plan = lp.Project(
        j, [(n, ex.ColumnRef(n)) for n in left_names] +
           [(n, ex.Literal(None, None)) for n in sorted(right_keys)])
    remaining = _conjoin(rest)
    if remaining is not None:
        out = lp.Filter(out, remaining)
    return out, True


def pivot_case_aggregates(p: lp.Plan) -> lp.Plan:
    """Rewrite N-way masked-sum pivots into ONE composite-key
    aggregation plus a tiny re-aggregation.

    q2/q59-class aggregates compute 7 ``sum(case when d_day_name='X'
    then price end)`` columns: each is a full-capacity masked segment
    sum over the fact spine, and exact decimals make every sum an
    int64-emulated scatter (54 scatter ops, ~3.7 s device time on q2 at
    SF1).  Grouping by (keys..., scrutinee) instead computes ONE sum
    over the spine; the second-level re-aggregation runs over the
    compacted (keys x scrutinee-domain) partial table (~10k rows).
    Decimal sums recombine exactly (sum of int64-scaled sums); NULL
    semantics are preserved: a (g, s) partial is NULL iff it saw no
    valid value, and absent combinations contribute no rows, so the
    outer sum is NULL exactly when the direct masked sum would be.
    Float-mode sums change association order; the differential
    harness's epsilon (1e-5 relative) covers that drift."""
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, lp.Plan):
            setattr(p, f.name, pivot_case_aggregates(v))
    if isinstance(p, lp.Aggregate):
        out = _try_pivot(p)
        if out is not None:
            return out
    return p


def _unwrap_renames(p: lp.Plan):
    """Peel pure-rename Projects; return (inner plan, outer->inner name
    map composed across the chain, or None if no Project was peeled —
    the caller treats None as identity)."""
    mapping: Optional[Dict[str, str]] = None
    while isinstance(p, lp.Project) and \
            all(isinstance(e, ex.ColumnRef) for _n, e in p.exprs):
        layer = {n: e.name for n, e in p.exprs}
        if mapping is None:
            mapping = layer
        else:
            mapping = {n: layer[v] for n, v in mapping.items()
                       if v in layer}
        p = p.child
    return p, mapping


@dataclasses.dataclass
class _ScalarAggLeaf:
    table: str
    alias: str
    columns: Optional[List[str]]
    conjs: List[ex.Expr]            # scan-native names
    # visible output name -> (func, distinct, native arg column)
    outputs: List[Tuple[str, str, bool, str]]


def _match_scalar_agg_leaf(leaf: lp.Plan) -> Optional[_ScalarAggLeaf]:
    agg, out_map = _unwrap_renames(leaf)
    if not (isinstance(agg, lp.Aggregate) and not agg.group_by
            and agg.grouping_sets is None and agg.aggs):
        return None
    src, in_map = _unwrap_renames(agg.child)
    if not isinstance(src, lp.Scan):
        return None
    agg_names = {n for n, _e in agg.aggs}
    if out_map is None:
        # declaration order, NOT set order — outputs feed the content
        # hash that names the fused columns, which must be a pure
        # function of the plan (set iteration varies per process)
        out_map = {n: n for n, _e in agg.aggs}
    if in_map is None:
        in_map = {}
        for _n, e in agg.aggs:
            if isinstance(e, ex.AggExpr) and \
                    isinstance(e.arg, ex.ColumnRef):
                in_map[e.arg.name] = e.arg.name
    if set(out_map.values()) != agg_names or \
            len(out_map) != len(agg_names):
        return None  # rename chain must be a bijection onto the aggs
    by_name = dict(agg.aggs)
    outputs: List[Tuple[str, str, bool, str]] = []
    for vis, internal in out_map.items():
        e = by_name[internal]
        if not (isinstance(e, ex.AggExpr) and
                e.func in ("sum", "count", "min", "max", "avg")):
            return None
        if e.distinct and e.func in ("min", "max"):
            return None
        if isinstance(e.arg, ex.Star):
            if e.func != "count" or e.distinct:
                return None
            native = "*"
        elif isinstance(e.arg, ex.ColumnRef):
            native = in_map.get(e.arg.name)
            if native is None:
                return None
        else:
            return None
        outputs.append((vis, e.func, e.distinct, native))
    return _ScalarAggLeaf(src.table, src.alias, src.columns,
                          _conjuncts(src.predicate), outputs)


def _interval_of(conjs: List[ex.Expr]):
    """Parse conjuncts as one closed interval on one column; returns
    (column name, lo, hi) or None.  Only >=/<=/= against numeric
    literals — the disjointness proof needs exact endpoint arithmetic."""
    col, lo, hi = None, None, None
    for c in conjs:
        if not (isinstance(c, ex.BinOp) and
                isinstance(c.left, ex.ColumnRef) and
                isinstance(c.right, ex.Literal) and
                isinstance(c.right.value, (int, float)) and
                not isinstance(c.right.value, bool) and
                c.op in (">=", "<=", "=")):
            return None
        if col is None:
            col = c.left.name
        elif col != c.left.name:
            return None
        v = c.right.value
        if c.op in (">=", "="):
            lo = v if lo is None else max(lo, v)
        if c.op in ("<=", "="):
            hi = v if hi is None else min(hi, v)
    if col is None or lo is None or hi is None or lo > hi:
        return None
    return col, lo, hi


def fuse_sibling_scalar_aggregates(
        p: lp.Plan, _used: Optional[Set[str]] = None) -> lp.Plan:
    """Fuse N cross-joined keyless aggregates over the SAME table whose
    filters differ only by pairwise-disjoint intervals on one column
    into ONE grouped aggregation.

    The q28 idiom: six scalar-subquery scans of store_sales, each
    keeping a disjoint ``ss_quantity`` bucket plus a shared OR filter,
    each computing avg/count/count-distinct over the full fact spine —
    six passes (and six presence-bitmap distinct reductions) where one
    suffices.  Rewrite: one scan filtered to the union of buckets, a
    CASE bucket id, ONE Aggregate grouped by bucket (count-distinct
    rides the grouped presence-bitmap path), then a keyless extraction
    aggregate pulling each branch's scalars out of its bucket row.

    Soundness: the intervals are proven pairwise disjoint on literal
    endpoints, so every row lands in at most one bucket — each bucket
    group sees exactly the rows its original branch scanned.  A branch
    with no surviving rows has no bucket row: the extraction
    ``max(case when bucket=i ...)`` over zero matches is NULL, matching
    the scalar aggregate's NULL (counts coalesce to 0, matching
    count-over-nothing).  Mirrors the reference's q28 single-pass GPU
    plan shape (rapids combines the branches into one kernel sweep)."""
    if _used is None:
        _used = set()

    def is_cross(n: lp.Plan) -> bool:
        return isinstance(n, lp.Join) and n.kind == "cross" and \
            not n.keys and n.extra is None and n.mark is None

    if not is_cross(p):
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            if isinstance(v, lp.Plan):
                setattr(p, f.name,
                        fuse_sibling_scalar_aggregates(v, _used))
        return p

    # flatten the WHOLE cross-join spine before matching — recursing
    # join-child-first would fuse the innermost pair and hide the rest
    # of the siblings from the 6-way q28 match
    leaves: List[lp.Plan] = []

    def flatten(n: lp.Plan):
        if is_cross(n):
            flatten(n.left)
            flatten(n.right)
        else:
            leaves.append(n)

    flatten(p)
    leaves = [fuse_sibling_scalar_aggregates(l, _used) for l in leaves]

    def rebuild(parts: List[lp.Plan]) -> lp.Plan:
        out = parts[0]
        for nxt in parts[1:]:
            out = lp.Join(out, nxt, "cross", [])
        return out
    matched = [(i, m) for i, leaf in enumerate(leaves)
               if (m := _match_scalar_agg_leaf(leaf)) is not None]
    # fuse EVERY qualifying table group (groups are over disjoint leaf
    # sets, so the rewrites compose)
    by_table: Dict[str, List[Tuple[int, _ScalarAggLeaf]]] = {}
    for i, m in matched:
        by_table.setdefault(m.table, []).append((i, m))
    fused_nodes: List[lp.Plan] = []
    fused_idx: Set[int] = set()
    for group in by_table.values():
        if len(group) < 2:
            continue
        # shared conjuncts: structurally present in EVERY branch
        shared = [c for c in group[0][1].conjs
                  if all(any(c == d for d in m.conjs)
                         for _i, m in group[1:])]
        ivals = []
        ok = True
        for _i, m in group:
            spec = [c for c in m.conjs if all(c != s for s in shared)]
            iv = _interval_of(spec)
            if iv is None:
                ok = False
                break
            ivals.append((iv, spec))
        if not ok or len({iv[0] for iv, _s in ivals}) != 1:
            continue
        spans = sorted((lo, hi) for (_c, lo, hi), _s in ivals)
        if any(a[1] >= b[0] for a, b in zip(spans, spans[1:])):
            continue  # overlapping buckets: rows could belong to two
        fused_nodes.append(_build_fused(group, shared, ivals, _used))
        fused_idx |= {i for i, _m in group}
    if not fused_nodes:
        return rebuild(leaves)
    rest = [leaf for i, leaf in enumerate(leaves) if i not in fused_idx]
    return rebuild(fused_nodes + rest)


def _build_fused(group, shared, ivals, used: Set[str]) -> lp.Plan:
    """Materialize one fused subtree for a qualifying sibling group."""
    # generated names must be a pure function of the plan: persisted
    # compile records and the XLA persistent cache key on plan
    # fingerprints, so a process-varying counter here would make every
    # replan recompile.  Content-hash the fused group; uniquify
    # deterministically (traversal order is a function of the plan too).
    import hashlib
    m0 = group[0][1]
    desc = repr((m0.table,
                 [[repr(c) for c in m.conjs] for _i, m in group],
                 [m.outputs for _i, m in group]))
    tag = "__ssa" + hashlib.md5(desc.encode()).hexdigest()[:8]
    while tag in used:
        tag += "x"
    used.add(tag)
    bucket = f"{tag}_b"
    cols = None if any(m.columns is None for _i, m in group) else \
        sorted({c for _i, m in group for c in m.columns})
    branch_conds = [_conjoin(spec) for _iv, spec in ivals]
    union = branch_conds[0]
    for c in branch_conds[1:]:
        union = ex.BinOp("or", union, c)
    scan = lp.Scan(m0.table, m0.alias, cols,
                   _conjoin(list(shared) + [union]))
    # one level-1 agg per distinct (func, distinct, native arg)
    l1_key: Dict[Tuple[str, bool, str], str] = {}
    l1_aggs: List[Tuple[str, ex.Expr]] = []
    need_cols = set()
    for _i, m in group:
        for _vis, func, dist, native in m.outputs:
            k = (func, dist, native)
            if k not in l1_key:
                l1_key[k] = f"{tag}_a{len(l1_key)}"
                arg = ex.Star() if native == "*" else \
                    ex.ColumnRef(native)
                l1_aggs.append(
                    (l1_key[k], ex.AggExpr(func, arg, dist)))
            if native != "*":
                need_cols.add(native)
    proj = lp.Project(scan, [(bucket, ex.Case(
        tuple((cond, ex.Literal(j, None))
              for j, cond in enumerate(branch_conds)),
        ex.Literal(None, None)))] +
        [(c, ex.ColumnRef(c)) for c in sorted(need_cols)])
    l1 = lp.Aggregate(proj, [(bucket, ex.ColumnRef(bucket))],
                      l1_aggs, None)
    l2_aggs: List[Tuple[str, ex.Expr]] = []
    for j, (_i, m) in enumerate(group):
        for vis, func, dist, native in m.outputs:
            pick = ex.AggExpr("max", ex.Case(
                ((ex.BinOp("=", ex.ColumnRef(bucket),
                           ex.Literal(j, None)),
                  ex.ColumnRef(l1_key[(func, dist, native)])),),
                ex.Literal(None, None)))
            if func == "count":
                pick = ex.Func("coalesce", (pick, ex.Literal(0, None)))
            l2_aggs.append((vis, pick))
    return lp.Aggregate(l1, [], l2_aggs, None)


def _optimize_embedded(p: lp.Plan, catalog) -> None:
    """Optimize plans embedded in SubqueryExpr leaves (uncorrelated scalar /
    IN subqueries survive planning as expressions — without this their join
    trees stay cross joins, q24's HAVING subquery)."""
    for e in _plan_exprs(p):
        for x in e.walk():
            if isinstance(x, ex.SubqueryExpr) and x.plan is not None:
                object.__setattr__(x, "plan", optimize(x.plan, catalog))
    for c in p.children():
        _optimize_embedded(c, catalog)


def optimize(p: lp.Plan, catalog=None) -> lp.Plan:
    p = push_filters(p)
    p = reorder_joins(p, catalog)
    p = pivot_case_aggregates(p)
    p = fuse_sibling_scalar_aggregates(p)
    p = null_filter_to_anti(p)
    p = prune(p, None)
    _optimize_embedded(p, catalog)
    return p
