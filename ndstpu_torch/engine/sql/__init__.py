"""SQL frontend: lexer, AST, recursive-descent parser (Spark SQL dialect
subset covering the NDS query corpus and data-maintenance statements)."""

from ndstpu_torch.engine.sql.parser import parse_statement, parse_statements  # noqa: F401


def normalize_sql_key(text: str) -> str:
    """Canonical cache-key form of a SQL statement: strip boundary
    comment lines (the stream files' ``-- start/end query`` markers)
    and the trailing semicolon.  The SAME query must key identically
    whether it arrived via direct template rendering (bench, warm) or
    a parsed stream file (power CLI) — a cosmetic difference silently
    missed every persisted compile record and re-ran eager discovery
    per query on the device."""
    lines = text.strip().splitlines()
    while lines and (lines[0].lstrip().startswith("--")
                     or not lines[0].strip()):
        lines.pop(0)
    while lines and (lines[-1].lstrip().startswith("--")
                     or not lines[-1].strip()):
        lines.pop()
    s = "\n".join(lines).strip()
    while s.endswith(";"):
        s = s[:-1].rstrip()
    return s
