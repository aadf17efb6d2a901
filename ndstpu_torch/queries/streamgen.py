"""Query rendering: the NDS templates with their parameters drawn.

A copy of the JAX package's ``queries/streamgen.py`` (the rendering,
``list_templates``, ``render_template_parts``, ``render_power_corpus``,
``BENCH_RNGSEED``, the stream-file writers and the command line), its
imports changed only: it reads this package's copy of the templates and
the port's ``datagen/dists.json``, the file the port's generator draws its
value pools from.  So

    python -m ndstpu_torch.queries.streamgen --output_dir D \
        --rngseed 07291122510 --streams N

writes the same ``query_N.sql`` files as the JAX package's command.

Templates declare parameters in a header line per parameter:
    --@ define NAME = uniform(lo, hi)      integer uniform inclusive
    --@ define NAME = choice(v1, v2, ...)  pick one literal
    --@ define NAME = dist(dname)          weighted pick from a named
                                           distribution (dsqgen
                                           `distmember` analog)
    --@ define NAME = distlist(dname, k)   k INDEPENDENT weighted picks
                                           (with replacement), substituted
                                           as [NAME.1] .. [NAME.k]
    --@ define NAME = distlistu(dname, k)  k DISTINCT weighted picks
``[NAME]`` occurrences in the body are substituted.  Arithmetic like
``[NAME] + 10`` stays in SQL.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

TEMPLATE_DIR = Path(__file__).resolve().parent / "templates"

_DEFINE_RE = re.compile(
    r"^--@\s*define\s+(\w+)\s*=\s*(uniform|choice|dist|distlistu|distlist)"
    r"\((.*)\)\s*$")

# Named weighted value distributions — the dsqgen distribution-table
# analog (the TPC toolkit ships these as .dst files; dsqgen's
# `distmember(fips_county, [N], 2)` picks weighted county names).
# Loaded from ndstpu_torch/datagen/dists.json, the SAME file the port's
# generator draws its column-value pools from: data generation and
# query-parameter generation share one source of truth, so rendered
# predicates always land on domains the data actually has, with the
# same non-uniform selectivity the generator produced.


def _load_distributions() -> Dict[str, List[Tuple[str, int]]]:
    import json
    path = Path(__file__).resolve().parent.parent / "datagen" / "dists.json"
    with open(path) as f:
        raw = json.load(f)
    return {name: list(zip(d["values"], d["weights"]))
            for name, d in raw.items() if not name.startswith("_")}


_DISTRIBUTIONS = _load_distributions()


def _dist_pick(rng: random.Random, dname: str, k: int = 1,
               distinct: bool = False) -> List[str]:
    """k weighted picks from a named distribution.  Default is WITH
    replacement (dsqgen distmember over independent draws — duplicates
    are intentional and concentrate selectivity on hot values);
    ``distinct=True`` removes each pick from the pool (ulist)."""
    pool = list(_DISTRIBUTIONS[dname])
    out = []
    for _ in range(min(k, len(pool)) if distinct else k):
        total = sum(w for _, w in pool)
        x = rng.randrange(total)
        for i, (v, w) in enumerate(pool):
            x -= w
            if x < 0:
                out.append(v)
                if distinct:
                    del pool[i]
                break
    return out


def list_templates(template_dir: Optional[str] = None) -> List[str]:
    d = Path(template_dir) if template_dir else TEMPLATE_DIR
    return sorted((p.name for p in d.glob("query*.tpl")),
                  key=lambda n: int(re.findall(r"\d+", n)[0]))


#: the stream-0 seed every benchmark script renders with; keeping it in
#: one place means warm caches, CPU baselines, and TPU passes can only
#: ever compare timings of IDENTICAL rendered SQL
BENCH_RNGSEED = "07291122510"


def render_power_corpus(rngseed: str = BENCH_RNGSEED,
                        stream: int = 0) -> List[Tuple[str, str]]:
    """The canonical (query_name, sql) power-run corpus: every template,
    split into executable parts, rendered with ``rngseed``.  Shared by
    bench.py, warm_corpus, sf10_bench — per-script render loops drifted
    once (different seed -> same names, different literals -> silently
    wrong speedups)."""
    queries: List[Tuple[str, str]] = []
    for tpl in list_templates():
        queries.extend(render_template_parts(
            str(TEMPLATE_DIR / tpl), rngseed, stream))
    return queries


def _parse_template(text: str) -> Tuple[Dict[str, tuple], str]:
    params: Dict[str, tuple] = {}
    body_lines = []
    for line in text.splitlines():
        m = _DEFINE_RE.match(line.strip())
        if m:
            name, kind, args = m.groups()
            vals = [a.strip() for a in args.split(",")]
            params[name] = (kind, vals)
        else:
            body_lines.append(line)
    return params, "\n".join(body_lines).strip()


def _stable_seed(rngseed: str, stream: int, template: str) -> int:
    h = hashlib.sha256(f"{rngseed}|{stream}|{template}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def _draw_params(params: Dict[str, tuple], tpl_name: str, rngseed: str,
                 stream: int) -> Dict[str, object]:
    """One rng pass over the parsed defines — {name: value} for scalar
    params, {name: [values]} for distlist params.  Deterministic in
    (rngseed, stream, template name)."""
    rng = random.Random(_stable_seed(rngseed, stream, tpl_name))
    out: Dict[str, object] = {}
    for name, (kind, vals) in params.items():
        if kind == "uniform":
            out[name] = str(rng.randint(int(vals[0]), int(vals[1])))
        elif kind == "dist":
            out[name] = _dist_pick(rng, vals[0])[0]
        elif kind in ("distlist", "distlistu"):
            out[name] = _dist_pick(rng, vals[0], int(vals[1]),
                                   distinct=(kind == "distlistu"))
        else:  # choice
            v = rng.choice(vals).strip()
            if v.startswith("'") and v.endswith("'"):
                v = v[1:-1]
            out[name] = v
    return out


def render_template(template_path: str, rngseed: str, stream: int) -> str:
    params, body = _parse_template(Path(template_path).read_text())
    drawn = _draw_params(params, Path(template_path).name, rngseed, stream)
    for name, v in drawn.items():
        if isinstance(v, list):
            for i, p in enumerate(v, 1):
                body = body.replace(f"[{name}.{i}]", p)
        else:
            body = body.replace(f"[{name}]", v)
    leftover = re.findall(r"\[([A-Z][A-Z0-9_.]*)\]", body)
    if leftover:
        raise ValueError(
            f"{template_path}: unsubstituted parameters {sorted(set(leftover))}")
    return body


def render_template_parts(template_path: str, rngseed: str,
                          stream: int) -> List[Tuple[str, str]]:
    """Render a template and split multi-statement bodies into the
    reference's `_part1`/`_part2` naming (nds_gen_query_stream.py:91-103):
    single-statement -> [("queryN", sql)]; two-part -> two entries."""
    name = Path(template_path).name
    base = name[:-4] if name.endswith(".tpl") else name
    sql = render_template(template_path, rngseed, stream)
    # the SAME statement splitter the power runner parses streams with —
    # the two sides must agree on part naming
    from ndstpu_torch.queries.statements import _sql_statements
    stmts = [s.strip() for s in _sql_statements(sql)]
    if len(stmts) <= 1:
        return [(base, sql)]
    return [(f"{base}_part{k}", stmt + ";")
            for k, stmt in enumerate(stmts, 1)]


def _query_order(templates: List[str], rngseed: str,
                 stream: int) -> List[str]:
    """Stream 0 = canonical order (the Power Run); streams >= 1 get a
    deterministic permutation (TPC-DS per-stream ordering)."""
    if stream == 0:
        return list(templates)
    rng = random.Random(_stable_seed(rngseed, stream, "__order__"))
    out = list(templates)
    rng.shuffle(out)
    return out


def generate_query_streams(template_dir: Optional[str], rngseed: str,
                           output_dir: str, streams: int) -> List[str]:
    """Write query_{stream}.sql for streams 0..N-1; returns file paths."""
    os.makedirs(output_dir, exist_ok=True)
    d = Path(template_dir) if template_dir else TEMPLATE_DIR
    templates = list_templates(template_dir)
    if not templates:
        raise FileNotFoundError(f"no query*.tpl under {d}")
    paths = []
    for stream in range(streams):
        parts = []
        order = _query_order(templates, rngseed, stream)
        for i, tpl in enumerate(order):
            sql = render_template(str(d / tpl), rngseed, stream)
            if not sql.rstrip().endswith(";"):
                sql = sql.rstrip() + "\n;"
            parts.append(
                f"-- start query {i + 1} in stream {stream} "
                f"using template {tpl}\n{sql}\n"
                f"-- end query {i + 1} in stream {stream} "
                f"using template {tpl}\n")
        path = os.path.join(output_dir, f"query_{stream}.sql")
        with open(path, "w") as f:
            f.write("\n".join(parts))
        paths.append(path)
    return paths


def generate_single_template(template: str, template_dir: Optional[str],
                             rngseed: str, output_dir: str) -> List[str]:
    """Render one template (test mode) as a one-query stream file
    `query_0.sql` WITH start/end markers — dsqgen emits the spark.tpl
    markers in single-template mode too, and the power runner's parser
    requires them (reference nds_gen_query_stream.py:57-89,
    nds_power.py:49-76).  Multi-statement templates additionally produce
    split _part1/_part2 files (nds_gen_query_stream.py:91-103)."""
    os.makedirs(output_dir, exist_ok=True)
    d = Path(template_dir) if template_dir else TEMPLATE_DIR
    name = template if template.endswith(".tpl") else template + ".tpl"
    sql = render_template(str(d / name), rngseed, 0)
    if not sql.rstrip().endswith(";"):
        sql = sql.rstrip() + "\n;"
    stream_path = os.path.join(output_dir, "query_0.sql")
    with open(stream_path, "w") as f:
        f.write(f"-- start query 1 in stream 0 using template {name}\n"
                f"{sql}\n"
                f"-- end query 1 in stream 0 using template {name}\n")
    out_paths = [stream_path]
    parts = render_template_parts(str(d / name), rngseed, 0)
    if len(parts) > 1:
        for part_name, stmt in parts:
            p = os.path.join(output_dir, f"{part_name}.sql")
            with open(p, "w") as f:
                f.write(stmt.rstrip(";").rstrip() + ";\n")
            out_paths.append(p)
    return out_paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="NDS query stream generator")
    p.add_argument("--template_dir",
                   help="directory of query templates "
                        "(default: builtin corpus)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--rngseed", default="0",
                   help="RNG seed (chained from the load test end timestamp "
                        "per TPC-DS spec 4.3.1)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--template",
                   help="render one template (test mode)")
    g.add_argument("--streams", type=int,
                   help="generate N permuted full streams")
    return p


if __name__ == "__main__":
    args = build_parser().parse_args()
    if args.template:
        out = generate_single_template(args.template, args.template_dir,
                                       args.rngseed, args.output_dir)
    else:
        out = generate_query_streams(args.template_dir, args.rngseed,
                                     args.output_dir, args.streams)
    for p in out:
        print(p)
