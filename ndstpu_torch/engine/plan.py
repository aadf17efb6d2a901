"""Logical plan nodes.

Produced by the planner from SQL ASTs, rewritten by the optimizer, executed
by ndstpu.engine.physical (numpy interpreter) or compiled by
ndstpu.engine.kernels (jax/TPU path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ndstpu_torch.engine.expr import Expr


class Plan:
    def children(self) -> Sequence["Plan"]:
        return ()

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()


@dataclasses.dataclass
class Scan(Plan):
    table: str
    alias: str
    # column projection filled by the optimizer (None = all)
    columns: Optional[List[str]] = None
    # pushed-down predicate (in terms of output names)
    predicate: Optional[Expr] = None

    def __repr__(self):
        return f"Scan({self.table} as {self.alias})"


@dataclasses.dataclass
class InlineTable(Plan):
    """Literal rows (VALUES) or a pre-materialized engine table."""
    table: object  # columnar.Table
    name: str = "values"


@dataclasses.dataclass
class Filter(Plan):
    child: Plan
    condition: Expr

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Project(Plan):
    child: Plan
    exprs: List[Tuple[str, Expr]]  # (output name, expr)

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Join(Plan):
    left: Plan
    right: Plan
    kind: str  # inner, left, right, full, semi, anti, cross, mark
    # equi-join key pairs (left expr, right expr); non-equi residual in extra
    keys: List[Tuple[Expr, Expr]]
    extra: Optional[Expr] = None
    # "mark" joins: output = left columns + a boolean column named `mark`
    # that is True where the row has a match (EXISTS under OR/CASE)
    mark: Optional[str] = None

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass
class Aggregate(Plan):
    child: Plan
    group_by: List[Tuple[str, Expr]]  # output name, key expr
    aggs: List[Tuple[str, Expr]]      # output name, AggExpr (or expr of aggs)
    # None = plain group-by; otherwise list of index-subsets of group_by
    # (grouping sets / rollup). Each set produces rows with the excluded
    # keys NULL, Spark ROLLUP semantics.
    grouping_sets: Optional[List[List[int]]] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Window(Plan):
    child: Plan
    exprs: List[Tuple[str, Expr]]  # output name, WindowExpr

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Sort(Plan):
    child: Plan
    keys: List[Tuple[Expr, bool]]  # (expr, ascending)

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Limit(Plan):
    child: Plan
    n: int

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Distinct(Plan):
    child: Plan

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class SetOp(Plan):
    kind: str  # union, intersect, except
    left: Plan
    right: Plan
    all: bool = False

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass
class DeviceResult(Plan):
    """Leaf standing in for a separately-compiled plan segment whose
    result is already resident on the device (jaxexec segmented
    compilation: one whole-query program per SQL text wedges the TPU
    compiler past ~5k ops, so big aggregate subtrees compile as their
    own programs and feed the parent as arguments)."""
    key: str  # segment fingerprint (jaxexec._plan_fp of the subtree)


@dataclasses.dataclass
class SubqueryAlias(Plan):
    """Named derived table / CTE reference."""
    child: Plan
    alias: str
    column_aliases: Optional[List[str]] = None

    def children(self):
        return (self.child,)


def copy_plan(p: Plan) -> Plan:
    """Deep-copy the plan tree (expressions are immutable and shared).

    Required wherever one stored plan (view/CTE) is instantiated more than
    once: the optimizer mutates nodes in place (Scan.predicate/columns,
    Project.exprs, Aggregate lists), so each reference needs its own nodes."""
    if isinstance(p, Scan):
        return Scan(p.table, p.alias,
                    None if p.columns is None else list(p.columns),
                    p.predicate)
    if isinstance(p, InlineTable):
        return InlineTable(p.table, p.name)
    if isinstance(p, Filter):
        return Filter(copy_plan(p.child), p.condition)
    if isinstance(p, Project):
        return Project(copy_plan(p.child), list(p.exprs))
    if isinstance(p, Join):
        return Join(copy_plan(p.left), copy_plan(p.right), p.kind,
                    list(p.keys), p.extra, p.mark)
    if isinstance(p, Aggregate):
        return Aggregate(copy_plan(p.child), list(p.group_by), list(p.aggs),
                         None if p.grouping_sets is None
                         else [list(s) for s in p.grouping_sets])
    if isinstance(p, Window):
        return Window(copy_plan(p.child), list(p.exprs))
    if isinstance(p, Sort):
        return Sort(copy_plan(p.child), list(p.keys))
    if isinstance(p, Limit):
        return Limit(copy_plan(p.child), p.n)
    if isinstance(p, Distinct):
        return Distinct(copy_plan(p.child))
    if isinstance(p, SetOp):
        return SetOp(p.kind, copy_plan(p.left), copy_plan(p.right), p.all)
    if isinstance(p, SubqueryAlias):
        return SubqueryAlias(copy_plan(p.child), p.alias,
                             None if p.column_aliases is None
                             else list(p.column_aliases))
    raise TypeError(f"copy_plan: {type(p).__name__}")


def fixes_order(p: Plan) -> bool:
    """Does the plan end in a sort (under projections and a limit), so
    that its rows come in a fixed order?"""
    while isinstance(p, (Limit, Project, SubqueryAlias)):
        p = p.child
    return isinstance(p, Sort)


def plan_string(p: Plan, indent: int = 0) -> str:
    pad = "  " * indent
    label = type(p).__name__
    detail = ""
    if isinstance(p, Scan):
        detail = f" {p.table} as {p.alias}" + (
            f" pred={p.predicate}" if p.predicate is not None else "")
    elif isinstance(p, Filter):
        detail = f" {p.condition}"
    elif isinstance(p, Join):
        detail = f" {p.kind} on {p.keys}" + (
            f" extra={p.extra}" if p.extra is not None else "")
    elif isinstance(p, Aggregate):
        detail = f" by {[n for n, _ in p.group_by]}"
        if p.grouping_sets is not None:
            detail += f" sets={p.grouping_sets}"
    elif isinstance(p, Project):
        detail = f" {[n for n, _ in p.exprs]}"
    elif isinstance(p, Sort):
        detail = f" {[(str(k[0]), k[1]) for k in p.keys]}"
    elif isinstance(p, Limit):
        detail = f" {p.n}"
    elif isinstance(p, SetOp):
        detail = f" {p.kind}{' all' if p.all else ''}"
    elif isinstance(p, SubqueryAlias):
        detail = f" {p.alias}"
    lines = [f"{pad}{label}{detail}"]
    for c in p.children():
        lines.append(plan_string(c, indent + 1))
    return "\n".join(lines)
