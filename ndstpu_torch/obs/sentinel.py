"""Regression sentinel: classify every query of a run vs the ledger.

A copy of the JAX package's ``ndstpu/obs/sentinel.py``, its imports
changed.

After any power run, each measured query gets one verdict against its
best-known-warm ledger prior (ndstpu_torch/obs/ledger.py):

* ``cold-compile`` — the tracer's compile/execute split says compile
  work happened (discovery / jit build / first XLA compile).  A first
  compile is **never** a regression, whatever the wall clock says;
  the verdict carries the ``execute_s`` split as the warm-path proxy
  so the run still contributes a baseline.
* ``new`` — no warm baseline exists for this (engine, scale-factor)
  scope; the run seeds one.
* ``data-changed`` — warm baselines exist for this scope but only
  under OTHER snapshot epochs (``extra.snapshot_epoch``, stamped from
  io/lake.warehouse_epoch): the warehouse's data-version vector moved
  (ingest/maintenance committed), so comparing walls would blame the
  engine for the data.  Never ``regressed``; the run seeds this
  epoch's baseline.  Entries with no stamp (legacy ledgers) stay
  comparable everywhere.
* ``regressed`` / ``improved`` — warm wall beyond both the relative
  tolerance and the absolute floor (both guards: a 0.1 s query
  jittering to 0.14 s is noise, not a regression).
* ``flat`` — within tolerance.
* ``failed`` — the query errored; excluded from baselines.  When the
  failure carries a taxonomy class (ndstpu_torch/faults/taxonomy.py, stamped
  on the span by the retry layer as ``error_taxonomy``), the verdict is
  ``failed-transient`` or ``failed-permanent``; a failure that never
  went through the retry layer keeps the bare ``failed``.

A query that was served cached spine tables (``attrs.spine_hits``,
engine/spine.py) additionally carries ``warmth: "spine-warm"`` +
``spine_hits``/``spine_bytes_saved`` on its verdict: its wall against
the plain-warm baseline is the measured value of the spine cache, and
the matching ledger entries land under the ``spine-warm`` fingerprint
so they never become warm baselines themselves.

Only ``regressed`` verdicts are exit-code-worthy: the CLI wrapper
(scripts/regression_check.py) exits nonzero on genuine warm-path
regressions so CI and the bench driver both see them, and writes
``REGRESSIONS.json`` + a markdown table for the artifact trail.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from ndstpu_torch.obs import ledger as ledger_mod

REL_TOL = 0.25      # regressed/improved only beyond +-25% ...
ABS_FLOOR_S = 0.25  # ... AND more than 0.25s absolute movement

VERDICTS = ("improved", "flat", "regressed", "cold-compile", "new",
            "data-changed", "failed", "failed-transient",
            "failed-permanent")


def classify_query(query: str, wall_s: float, compile_s: float,
                   execute_s: float, baseline_warm_s: Optional[float],
                   rel_tol: float = REL_TOL,
                   abs_floor_s: float = ABS_FLOOR_S) -> dict:
    """One verdict.  Cold-compile is decided FIRST, from the measured
    compile/execute split, so a first compile can never be flagged as
    a regression regardless of how slow the wall was."""
    out = {
        "query": query,
        "wall_s": round(wall_s, 6),
        "compile_s": round(compile_s, 6),
        "execute_s": round(execute_s, 6),
        "baseline_warm_s": None if baseline_warm_s is None
        else round(baseline_warm_s, 6),
    }
    if ledger_mod.derive_warmth(wall_s, compile_s) == "cold":
        out["verdict"] = "cold-compile"
        out["reason"] = (
            f"compile_s={compile_s:.3f}s of wall={wall_s:.3f}s is "
            f"first-compile work, not a warm-path cost; warm proxy "
            f"execute_s={execute_s:.3f}s"
            + (f" vs baseline {baseline_warm_s:.3f}s"
               if baseline_warm_s is not None else " (no baseline yet)"))
        return out
    if baseline_warm_s is None:
        out["verdict"] = "new"
        out["reason"] = "no warm baseline in ledger scope; seeding one"
        return out
    delta = wall_s - baseline_warm_s
    out["delta_s"] = round(delta, 6)
    out["ratio"] = round(wall_s / baseline_warm_s, 4) \
        if baseline_warm_s > 0 else None
    if delta > abs_floor_s and wall_s > baseline_warm_s * (1 + rel_tol):
        out["verdict"] = "regressed"
        out["reason"] = (f"warm wall {wall_s:.3f}s vs best-known-warm "
                         f"{baseline_warm_s:.3f}s (+{delta:.3f}s, "
                         f"x{out['ratio']})")
    elif -delta > abs_floor_s and \
            wall_s < baseline_warm_s * (1 - rel_tol):
        out["verdict"] = "improved"
        out["reason"] = (f"warm wall {wall_s:.3f}s vs best-known-warm "
                         f"{baseline_warm_s:.3f}s ({delta:.3f}s, "
                         f"x{out['ratio']})")
    else:
        out["verdict"] = "flat"
        out["reason"] = (f"within tolerance of best-known-warm "
                         f"{baseline_warm_s:.3f}s")
    return out


def classify_run(queries: Iterable[dict], led: "ledger_mod.Ledger",
                 engine: Optional[str] = None, scale_factor=None,
                 rel_tol: float = REL_TOL,
                 abs_floor_s: float = ABS_FLOOR_S,
                 snapshot_epoch: Optional[str] = None) -> dict:
    """Classify a run's per-query summaries (the power sidecar /
    ``query_summaries()`` shape: query, wall_s, compile_s, execute_s,
    optional attrs.error).  Baselines are scoped strictly to
    (engine, scale_factor) — cross-engine comparisons are meaningless —
    and, when ``snapshot_epoch`` is given, to entries of the same data
    epoch (or unstamped legacy entries); a query whose only warm
    baselines live under other epochs verdicts ``data-changed``."""
    verdicts: List[dict] = []
    for q in queries:
        name = q["query"]
        if (q.get("attrs") or {}).get("error"):
            attrs = q["attrs"]
            verdict = "failed"
            if attrs.get("error_taxonomy") in ("transient", "permanent"):
                verdict = f"failed-{attrs['error_taxonomy']}"
            v = {
                "query": name, "wall_s": round(q.get("wall_s", 0.0), 6),
                "verdict": verdict,
                "reason": f"query errored: {attrs['error']}",
            }
            if attrs.get("error_attempts"):
                v["attempts"] = attrs["error_attempts"]
            verdicts.append(v)
            continue
        base = led.best_warm(name, engine=engine,
                             scale_factor=scale_factor,
                             snapshot_epoch=snapshot_epoch)
        v = classify_query(
            name, q.get("wall_s", 0.0), q.get("compile_s", 0.0),
            q.get("execute_s", 0.0), base, rel_tol=rel_tol,
            abs_floor_s=abs_floor_s)
        if v["verdict"] == "new" and snapshot_epoch is not None:
            # no same-epoch baseline: distinguish genuinely-new from
            # data-changed (baselines exist, but under other epochs)
            others = led.warm_epochs(name, engine=engine,
                                     scale_factor=scale_factor)
            others.discard(snapshot_epoch)
            if others:
                v["verdict"] = "data-changed"
                v["reason"] = (
                    f"warm baselines exist only under other snapshot "
                    f"epoch(s) {sorted(others)} — the data changed "
                    f"under this query, not the engine; seeding epoch "
                    f"{snapshot_epoch}")
        # spine-warm is its own warmth class (ndstpu_torch/obs/ledger.py):
        # a query served cached spine tables (engine/spine.py) skipped
        # its spine's scan/filter/join work, so its wall is measured
        # hit VALUE against the plain-warm baseline, never a new
        # baseline itself.  The stamp keeps that measurable per query
        # without widening the fixed VERDICTS set.
        attrs = q.get("attrs") or {}
        if attrs.get("spine_hits"):
            v["warmth"] = "cold" if v["verdict"] == "cold-compile" \
                else "spine-warm"
            v["spine_hits"] = attrs["spine_hits"]
            if attrs.get("spine_bytes_saved"):
                v["spine_bytes_saved"] = attrs["spine_bytes_saved"]
            v["reason"] += (f" [spine-warm: {attrs['spine_hits']} "
                            f"cached-spine hit(s)]")
        verdicts.append(v)
    counts: dict = {}
    for v in verdicts:
        counts[v["verdict"]] = counts.get(v["verdict"], 0) + 1
    return {
        "format": "ndstpu-regressions-v1",
        "engine": engine,
        "scale_factor": None if scale_factor is None
        else str(scale_factor),
        "rel_tol": rel_tol,
        "abs_floor_s": abs_floor_s,
        "counts": counts,
        "regressions": [v["query"] for v in verdicts
                        if v["verdict"] == "regressed"],
        "verdicts": verdicts,
    }


def markdown_table(result: dict) -> str:
    """REGRESSIONS.md body: one row per query, regressions first."""
    order = {"regressed": 0, "improved": 1, "new": 2,
             "data-changed": 3, "flat": 4, "cold-compile": 5,
             "failed": 6, "failed-transient": 7,
             "failed-permanent": 8}
    rows = sorted(result["verdicts"],
                  key=lambda v: (order.get(v["verdict"], 9), v["query"]))
    lines = [
        "# Regression sentinel",
        "",
        f"engine={result.get('engine')} "
        f"sf={result.get('scale_factor')} "
        f"counts={result.get('counts')}",
        "",
        "| query | wall_s | baseline_warm_s | delta_s | ratio | "
        "verdict |",
        "|---|---|---|---|---|---|",
    ]
    for v in rows:
        lines.append(
            "| {q} | {w} | {b} | {d} | {r} | {v} |".format(
                q=v["query"], w=v.get("wall_s", ""),
                b=v.get("baseline_warm_s", ""),
                d=v.get("delta_s", ""), r=v.get("ratio", ""),
                v=v["verdict"]))
    return "\n".join(lines) + "\n"


def write_reports(result: dict, json_path: Optional[str] = None,
                  md_path: Optional[str] = None) -> dict:
    from ndstpu_torch.io import atomic
    paths = {}
    if json_path:
        atomic.atomic_write_json(json_path, result)
        paths["json"] = json_path
    if md_path:
        atomic.atomic_write_text(md_path, markdown_table(result))
        paths["md"] = md_path
    return paths
