"""Recursive-descent SQL parser (Spark SQL dialect subset).

Covers the constructs exercised by the NDS/TPC-DS query corpus and the
data-maintenance SQL: CTEs, set operations, derived tables, explicit and
comma joins, ROLLUP/CUBE/GROUPING SETS, window functions, CASE, CAST,
(NOT) IN / BETWEEN / LIKE / EXISTS, scalar subqueries, interval and date
literals, ORDER BY with NULLS FIRST/LAST and positional refs, LIMIT, and
the DM statements CREATE TEMP VIEW / CREATE TABLE AS / INSERT INTO /
DELETE FROM / DROP.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ndstpu_torch.engine.sql import ast
from ndstpu_torch.engine.sql.lexer import Token, tokenize


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers -------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KW" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SyntaxError(f"expected {kw.upper()}, got {self.peek()}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SyntaxError(f"expected {op!r}, got {self.peek()}")

    def expect_ident(self) -> str:
        t = self.next()
        if t.kind not in ("IDENT", "KW"):
            raise SyntaxError(f"expected identifier, got {t}")
        return t.value

    # -- statements ----------------------------------------------------------

    def parse_statement(self) -> ast.Node:
        if self.at_kw("create"):
            return self._create()
        if self.at_kw("insert"):
            return self._insert()
        if self.at_kw("delete"):
            return self._delete()
        if self.at_kw("drop"):
            return self._drop()
        return self.parse_query()

    def _create(self) -> ast.Node:
        self.expect_kw("create")
        or_replace = False
        if self.accept_kw("or"):
            self.expect_kw("replace")
            or_replace = True
        temp = self.accept_kw("temp") or self.accept_kw("temporary")
        if self.accept_kw("view"):
            name = self.expect_ident()
            self.expect_kw("as")
            return ast.CreateView(name, self.parse_query(), temp, or_replace)
        if self.accept_kw("table"):
            name = self.expect_ident()
            self.expect_kw("as")
            return ast.CreateTableAs(name, self.parse_query())
        raise SyntaxError(f"CREATE: expected VIEW or TABLE at {self.peek()}")

    def _insert(self) -> ast.Node:
        self.expect_kw("insert")
        self.expect_kw("into")
        if self.accept_kw("table"):
            pass  # Spark allows INSERT INTO TABLE t
        name = self.expect_ident()
        return ast.InsertInto(name, self.parse_query())

    def _delete(self) -> ast.Node:
        self.expect_kw("delete")
        self.expect_kw("from")
        name = self.expect_ident()
        where = None
        if self.accept_kw("where"):
            where = self.expr()
        return ast.DeleteFrom(name, where)

    def _drop(self) -> ast.Node:
        self.expect_kw("drop")
        kind = "view" if self.accept_kw("view") else (
            "table" if self.accept_kw("table") else None)
        if kind is None:
            raise SyntaxError("DROP: expected VIEW or TABLE")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ast.DropRel(self.expect_ident(), kind, if_exists)

    # -- query ---------------------------------------------------------------

    def parse_query(self) -> ast.Query:
        ctes: List[Tuple[str, Optional[List[str]], ast.Query]] = []
        if self.accept_kw("with"):
            while True:
                name = self.expect_ident()
                col_aliases = None
                if self.at_op("("):
                    self.next()
                    col_aliases = [self.expect_ident()]
                    while self.accept_op(","):
                        col_aliases.append(self.expect_ident())
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                ctes.append((name, col_aliases, q))
                if not self.accept_op(","):
                    break
        body = self._set_expr()
        order_by = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by = self._order_list()
        limit = None
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind != "NUMBER":
                raise SyntaxError(f"LIMIT expects number, got {t}")
            limit = int(t.value)
        return ast.Query(ctes, body, order_by, limit)

    def _order_list(self):
        out = []
        while True:
            e = self.expr()
            asc = True
            if self.accept_kw("asc"):
                asc = True
            elif self.accept_kw("desc"):
                asc = False
            nulls_first = None
            if self.accept_kw("nulls"):
                if self.accept_kw("first"):
                    nulls_first = True
                else:
                    self.expect_kw("last")
                    nulls_first = False
            out.append((e, asc, nulls_first))
            if not self.accept_op(","):
                break
        return out

    def _set_expr(self) -> ast.Node:
        left = self._select_core()
        while self.at_kw("union", "intersect", "except"):
            kind = self.next().value
            allf = self.accept_kw("all")
            if not allf:
                self.accept_kw("distinct")
            right = self._select_core()
            left = ast.SetExpr(kind, left, right, allf)
        return left

    def _select_core(self) -> ast.Node:
        if self.at_op("("):
            # parenthesized query body
            self.next()
            q = self.parse_query()
            self.expect_op(")")
            # a bare parenthesized query at set-op level: unwrap if trivial
            if not q.ctes and not q.order_by and q.limit is None:
                return q.body
            return ast.SubqueryRef(q, alias="__paren__")
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        elif self.accept_kw("all"):
            pass
        if self.accept_kw("top"):
            # non-standard; tolerate TOP n as LIMIT
            t = self.next()
            _ = int(t.value)
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self._from_clause()
        where = None
        if self.accept_kw("where"):
            where = self.expr()
        group = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group = self._group_spec()
        having = None
        if self.accept_kw("having"):
            having = self.expr()
        return ast.Select(items, from_, where, group, having, distinct)

    def _select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.StarExpr(), None)
        # t.* ?
        if self.peek().kind in ("IDENT",) and self.peek(1).kind == "OP" and \
                self.peek(1).value == "." and self.peek(2).kind == "OP" and \
                self.peek(2).value == "*":
            t = self.next().value
            self.next()
            self.next()
            return ast.SelectItem(ast.StarExpr(t), None)
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind == "IDENT":
            alias = self.next().value
        return ast.SelectItem(e, alias)

    def _group_spec(self) -> ast.GroupSpec:
        if self.accept_kw("rollup"):
            self.expect_op("(")
            exprs = [self.expr()]
            while self.accept_op(","):
                exprs.append(self.expr())
            self.expect_op(")")
            return ast.GroupSpec(exprs, "rollup")
        if self.accept_kw("cube"):
            self.expect_op("(")
            exprs = [self.expr()]
            while self.accept_op(","):
                exprs.append(self.expr())
            self.expect_op(")")
            return ast.GroupSpec(exprs, "cube")
        if self.accept_kw("grouping"):
            self.expect_kw("sets")
            return self._grouping_sets([])
        exprs = [self.expr()]
        while self.accept_op(","):
            exprs.append(self.expr())
        if self.accept_kw("grouping"):
            self.expect_kw("sets")
            return self._grouping_sets(exprs)
        if self.accept_kw("with"):
            self.expect_kw("rollup")
            return ast.GroupSpec(exprs, "rollup")
        return ast.GroupSpec(exprs, "plain")

    def _grouping_sets(self, base: List[ast.Node]) -> ast.GroupSpec:
        self.expect_op("(")
        sets: List[List[ast.Node]] = []
        while True:
            if self.accept_op("("):
                one: List[ast.Node] = []
                if not self.at_op(")"):
                    one.append(self.expr())
                    while self.accept_op(","):
                        one.append(self.expr())
                self.expect_op(")")
                sets.append(one)
            else:
                sets.append([self.expr()])
            if not self.accept_op(","):
                break
        self.expect_op(")")
        # collect the union of grouping exprs as the key list
        exprs = list(base)
        for s in sets:
            for e in s:
                if not any(repr(e) == repr(x) for x in exprs):
                    exprs.append(e)
        return ast.GroupSpec(exprs, "sets", sets)

    # -- FROM ----------------------------------------------------------------

    def _from_clause(self) -> ast.Node:
        left = self._join_chain()
        while self.accept_op(","):
            right = self._join_chain()
            left = ast.JoinRef(left, right, "cross", None)
        return left

    def _join_chain(self) -> ast.Node:
        left = self._table_primary()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self._table_primary()
                left = ast.JoinRef(left, right, "cross", None)
                continue
            kind = None
            if self.at_kw("join", "inner"):
                self.accept_kw("inner")
                self.expect_kw("join")
                kind = "inner"
            elif self.at_kw("left"):
                self.next()
                self.accept_kw("semi") and (kind := "semi")
                self.accept_kw("anti") and (kind := "anti")
                if kind is None:
                    self.accept_kw("outer")
                    kind = "left"
                self.expect_kw("join")
            elif self.at_kw("right"):
                self.next()
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "right"
            elif self.at_kw("full"):
                self.next()
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "full"
            else:
                break
            right = self._table_primary()
            cond = None
            if self.accept_kw("on"):
                cond = self.expr()
            left = ast.JoinRef(left, right, kind, cond)
        return left

    def _table_primary(self) -> ast.Node:
        if self.at_op("("):
            self.next()
            q = self.parse_query()
            self.expect_op(")")
            self.accept_kw("as")
            alias = self.expect_ident()
            col_aliases = None
            if self.at_op("("):
                self.next()
                col_aliases = [self.expect_ident()]
                while self.accept_op(","):
                    col_aliases.append(self.expect_ident())
                self.expect_op(")")
            return ast.SubqueryRef(q, alias, col_aliases)
        name = self.expect_ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind == "IDENT":
            alias = self.next().value
        return ast.TableRef(name, alias)

    # -- expressions ---------------------------------------------------------

    def expr(self) -> ast.Node:
        return self._or()

    def _or(self) -> ast.Node:
        left = self._and()
        while self.accept_kw("or"):
            left = ast.Bin("or", left, self._and())
        return left

    def _and(self) -> ast.Node:
        left = self._not()
        while self.accept_kw("and"):
            left = ast.Bin("and", left, self._not())
        return left

    def _not(self) -> ast.Node:
        if self.accept_kw("not"):
            return ast.Un("not", self._not())
        return self._predicate()

    def _predicate(self) -> ast.Node:
        left = self._additive()
        while True:
            negated = False
            if self.at_kw("not") and self.peek(1).kind == "KW" and \
                    self.peek(1).value in ("in", "between", "like", "exists"):
                self.next()
                negated = True
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                left = ast.IsNull(left, neg)
                continue
            if self.accept_kw("between"):
                lo = self._additive()
                self.expect_kw("and")
                hi = self._additive()
                left = ast.Between(left, lo, hi, negated)
                continue
            if self.accept_kw("like"):
                t = self.next()
                if t.kind != "STRING":
                    raise SyntaxError(f"LIKE expects string, got {t}")
                left = ast.LikeOp(left, t.value, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    left = ast.InQuery(left, q, negated)
                else:
                    vals = [self._additive()]
                    while self.accept_op(","):
                        vals.append(self._additive())
                    self.expect_op(")")
                    left = ast.InVals(left, vals, negated)
                continue
            if self.at_op("=", "<>", "<", "<=", ">", ">="):
                op = self.next().value
                # ANY/SOME/ALL subquery comparison
                if self.at_kw("any", "some", "all"):
                    quant = self.next().value
                    self.expect_op("(")
                    q = self.parse_query()
                    self.expect_op(")")
                    left = ast.Bin(f"{op}_{quant}", left, ast.ScalarQuery(q))
                else:
                    left = ast.Bin(op, left, self._additive())
                continue
            break
        return left

    def _additive(self) -> ast.Node:
        left = self._multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().value
                left = ast.Bin(op, left, self._multiplicative())
            elif self.at_op("||"):
                self.next()
                left = ast.Bin("||", left, self._multiplicative())
            else:
                break
        return left

    def _multiplicative(self) -> ast.Node:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = ast.Bin(op, left, self._unary())
        return left

    def _unary(self) -> ast.Node:
        if self.accept_op("-"):
            return ast.Un("neg", self._unary())
        if self.accept_op("+"):
            return self._unary()
        return self._primary()

    def _primary(self) -> ast.Node:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                return ast.Lit(float(t.value))
            return ast.Lit(int(t.value))
        if t.kind == "STRING":
            self.next()
            return ast.Lit(t.value)
        if self.accept_kw("null"):
            return ast.Lit(None)
        if self.accept_kw("date"):
            s = self.next()
            if s.kind != "STRING":
                raise SyntaxError("DATE expects a string literal")
            return ast.DateLit(s.value)
        if self.accept_kw("interval"):
            v = self.next()
            if v.kind == "STRING":
                n = int(v.value)
            elif v.kind == "NUMBER":
                n = int(v.value)
            else:
                raise SyntaxError(f"INTERVAL expects number, got {v}")
            unit_tok = self.next()
            unit = unit_tok.value.lower().rstrip("s") + "s"
            if unit not in ("days", "months", "years"):
                raise SyntaxError(f"unsupported interval unit {unit_tok.value}")
            return ast.Interval(n, unit)
        if self.accept_kw("case"):
            return self._case()
        if self.accept_kw("cast"):
            self.expect_op("(")
            e = self.expr()
            self.expect_kw("as")
            type_name = self._type_name()
            self.expect_op(")")
            return ast.CastExpr(e, type_name)
        if self.accept_kw("exists"):
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return ast.Exists(q, False)
        if self.at_op("("):
            self.next()
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return ast.ScalarQuery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind in ("IDENT", "KW"):
            # grouping(col) is a KW; allow KW-named functions
            name = self.next().value
            if self.at_op("("):
                return self._func_call(name)
            if self.accept_op("."):
                col = self.expect_ident()
                return ast.Col(name, col)
            lowered = name.lower()
            if lowered == "true":
                return ast.Lit(True)
            if lowered == "false":
                return ast.Lit(False)
            return ast.Col(None, name)
        raise SyntaxError(f"unexpected token {t}")

    def _type_name(self) -> str:
        base = self.expect_ident().lower()
        if self.at_op("("):
            self.next()
            args = [self.next().value]
            while self.accept_op(","):
                args.append(self.next().value)
            self.expect_op(")")
            return f"{base}({','.join(args)})"
        return base

    def _case(self) -> ast.Node:
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            c = self.expr()
            self.expect_kw("then")
            v = self.expr()
            whens.append((c, v))
        default = None
        if self.accept_kw("else"):
            default = self.expr()
        self.expect_kw("end")
        return ast.CaseExpr(operand, whens, default)

    def _func_call(self, name: str) -> ast.Node:
        self.expect_op("(")
        distinct = False
        star = False
        args: List[ast.Node] = []
        if self.at_op("*"):
            self.next()
            star = True
        elif not self.at_op(")"):
            distinct = self.accept_kw("distinct")
            args.append(self.expr())
            while self.accept_op(","):
                args.append(self.expr())
        self.expect_op(")")
        fc = ast.FuncCall(name.lower(), args, distinct, star)
        if self.accept_kw("over"):
            self.expect_op("(")
            partition_by: List[ast.Node] = []
            order_by: List[Tuple[ast.Node, bool]] = []
            if self.accept_kw("partition"):
                self.expect_kw("by")
                partition_by.append(self.expr())
                while self.accept_op(","):
                    partition_by.append(self.expr())
            if self.accept_kw("order"):
                self.expect_kw("by")
                for e, asc, _nf in self._order_list():
                    order_by.append((e, asc))
            frame = None
            if self.at_kw("rows") or self.at_kw("range"):
                frame = self.peek().value.lower()
                self.next()
                # only the running frame the TPC-DS corpus uses (q51):
                #   BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW
                self.expect_kw("between")
                self.expect_kw("unbounded")
                self.expect_kw("preceding")
                self.expect_kw("and")
                self.expect_kw("current")
                self.expect_kw("row")
            self.expect_op(")")
            return ast.WindowCall(fc, partition_by, order_by, frame)
        return fc


def parse_statement(sql: str) -> ast.Node:
    p = Parser(sql)
    stmt = p.parse_statement()
    p.accept_op(";")
    if p.peek().kind != "EOF":
        raise SyntaxError(f"trailing tokens: {p.peek()}")
    return stmt


def parse_statements(sql: str) -> List[ast.Node]:
    """Split on top-level ';' and parse each statement."""
    p = Parser(sql)
    out: List[ast.Node] = []
    while p.peek().kind != "EOF":
        if p.accept_op(";"):
            continue
        out.append(p.parse_statement())
    return out
