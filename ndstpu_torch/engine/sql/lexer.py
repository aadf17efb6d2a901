"""SQL lexer: case-insensitive keywords, quoted identifiers, comments."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Token:
    kind: str  # KW, IDENT, NUMBER, STRING, OP, EOF
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "join", "inner", "left",
    "right", "full", "outer", "cross", "on", "union", "intersect", "except",
    "all", "distinct", "exists", "with", "rollup", "cube", "grouping",
    "sets", "asc", "desc", "interval", "date", "over", "partition",
    "rows", "preceding", "following", "unbounded", "current", "row",
    "create", "table", "view", "temp", "temporary", "insert", "into",
    "delete", "drop", "values", "top", "any", "some", "semi", "anti",
    "nulls", "first", "last", "using", "replace", "if",
}

MULTI_OPS = ["<>", "<=", ">=", "!=", "||"]
SINGLE_OPS = "+-*/%(),.=<>;"


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SyntaxError("unterminated block comment")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise SyntaxError(f"unterminated string at {i}")
            toks.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":
            close = c
            j = sql.find(close, i + 1)
            if j < 0:
                raise SyntaxError(f"unterminated quoted identifier at {i}")
            toks.append(Token("IDENT", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    # ".." would be an error; a lone trailing dot ends number
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j + 1 < n and (
                        sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_e = True
                    j += 2
                else:
                    break
            toks.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            if word.lower() in KEYWORDS:
                toks.append(Token("KW", word.lower(), i))
            else:
                toks.append(Token("IDENT", word, i))
            i = j
            continue
        two = sql[i:i + 2]
        if two in MULTI_OPS:
            toks.append(Token("OP", "<>" if two == "!=" else two, i))
            i += 2
            continue
        if c in SINGLE_OPS:
            toks.append(Token("OP", c, i))
            i += 1
            continue
        raise SyntaxError(f"unexpected character {c!r} at {i}")
    toks.append(Token("EOF", "", n))
    return toks
