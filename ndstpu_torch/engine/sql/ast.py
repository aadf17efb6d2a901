"""SQL AST nodes (parser output, planner input)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class Node:
    pass


# -- expressions -------------------------------------------------------------


@dataclasses.dataclass
class Col(Node):
    table: Optional[str]
    name: str

    def __repr__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclasses.dataclass
class Lit(Node):
    value: object  # int/float/str/bool/None

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass
class DateLit(Node):
    value: str  # 'YYYY-MM-DD'


@dataclasses.dataclass
class Interval(Node):
    n: int
    unit: str  # days, months, years


@dataclasses.dataclass
class Bin(Node):
    op: str
    left: Node
    right: Node


@dataclasses.dataclass
class Un(Node):
    op: str  # not, neg
    operand: Node


@dataclasses.dataclass
class IsNull(Node):
    operand: Node
    negated: bool


@dataclasses.dataclass
class Between(Node):
    operand: Node
    lo: Node
    hi: Node
    negated: bool


@dataclasses.dataclass
class InVals(Node):
    operand: Node
    values: List[Node]
    negated: bool


@dataclasses.dataclass
class InQuery(Node):
    operand: Node
    query: "Query"
    negated: bool


@dataclasses.dataclass
class Exists(Node):
    query: "Query"
    negated: bool


@dataclasses.dataclass
class ScalarQuery(Node):
    query: "Query"


@dataclasses.dataclass
class MarkRef(Node):
    """Planner-internal: reference to a mark-join boolean column (the
    residue of an EXISTS planned as a mark join).  Never produced by the
    parser."""
    name: str


@dataclasses.dataclass
class LikeOp(Node):
    operand: Node
    pattern: str
    negated: bool


@dataclasses.dataclass
class FuncCall(Node):
    name: str
    args: List[Node]
    distinct: bool = False
    star: bool = False  # count(*)


@dataclasses.dataclass
class WindowCall(Node):
    func: FuncCall
    partition_by: List[Node]
    order_by: List[Tuple[Node, bool]]  # (expr, asc)
    # explicit frame: "rows" | "range" (UNBOUNDED PRECEDING..CURRENT ROW);
    # None = default (running RANGE frame when order_by present, Spark)
    frame: "str | None" = None


@dataclasses.dataclass
class CaseExpr(Node):
    operand: Optional[Node]  # CASE x WHEN v ... (simple form)
    whens: List[Tuple[Node, Node]]
    default: Optional[Node]


@dataclasses.dataclass
class CastExpr(Node):
    operand: Node
    type_name: str  # e.g. "integer", "decimal(7,2)", "date", "char(10)"


@dataclasses.dataclass
class StarExpr(Node):
    table: Optional[str] = None  # t.* or *


# -- relations ---------------------------------------------------------------


@dataclasses.dataclass
class TableRef(Node):
    name: str
    alias: Optional[str]


@dataclasses.dataclass
class SubqueryRef(Node):
    query: "Query"
    alias: str
    column_aliases: Optional[List[str]] = None


@dataclasses.dataclass
class JoinRef(Node):
    left: Node
    right: Node
    kind: str  # inner, left, right, full, cross
    condition: Optional[Node]  # ON expr


# -- query -------------------------------------------------------------------


@dataclasses.dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str]


@dataclasses.dataclass
class GroupSpec(Node):
    exprs: List[Node]
    kind: str = "plain"  # plain, rollup, cube, sets
    sets: Optional[List[List[Node]]] = None  # for grouping sets


@dataclasses.dataclass
class Select(Node):
    items: List[SelectItem]
    from_: Optional[Node]  # TableRef/SubqueryRef/JoinRef (comma joins folded)
    where: Optional[Node]
    group: Optional[GroupSpec]
    having: Optional[Node]
    distinct: bool = False


@dataclasses.dataclass
class Query(Node):
    """select_core (set ops)* with optional CTEs, ORDER BY, LIMIT."""
    ctes: List[Tuple[str, Optional[List[str]], "Query"]]
    body: Node  # Select or SetExpr
    order_by: List[Tuple[Node, bool, Optional[bool]]]  # expr, asc, nulls_first
    limit: Optional[int]


@dataclasses.dataclass
class SetExpr(Node):
    kind: str  # union, intersect, except
    left: Node  # Select/SetExpr
    right: Node
    all: bool


# -- statements (DM / DDL) ---------------------------------------------------


@dataclasses.dataclass
class CreateView(Node):
    name: str
    query: Query
    temp: bool = True
    or_replace: bool = True


@dataclasses.dataclass
class CreateTableAs(Node):
    name: str
    query: Query


@dataclasses.dataclass
class InsertInto(Node):
    table: str
    query: Query


@dataclasses.dataclass
class DeleteFrom(Node):
    table: str
    where: Optional[Node]


@dataclasses.dataclass
class DropRel(Node):
    name: str
    kind: str  # view, table
    if_exists: bool = False
