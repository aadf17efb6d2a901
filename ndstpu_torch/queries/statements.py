"""Split a query block into its SQL statements.

A copy of the JAX package's power runner's splitter
(``ndstpu/harness/power.py::_sql_statements``): the renderer names a
template's parts by it, so the two must agree.
"""

from __future__ import annotations

from typing import List


def _sql_statements(block: str) -> List[str]:
    """Non-empty SQL statements in a query block, split on semicolons
    that are real statement terminators — a ``;`` inside a quoted
    literal or a ``--`` line comment does not split.  Fragments with no
    code outside comments (e.g. the trailing ``-- end query`` marker
    after the final semicolon) are not statements."""
    frags: List[str] = []
    cur: List[str] = []
    has_code = False
    in_str = in_comment = False
    for i, ch in enumerate(block):
        if in_comment:
            in_comment = ch != "\n"
        elif in_str:
            in_str = ch != "'"
        elif ch == "'":
            in_str = True
            has_code = True
        elif ch == "-" and block[i + 1:i + 2] == "-":
            in_comment = True
        elif ch == ";":
            if has_code:
                frags.append("".join(cur))
            cur, has_code = [], False
            continue
        elif not ch.isspace():
            has_code = True
        cur.append(ch)
    if has_code:
        frags.append("".join(cur))
    return frags
