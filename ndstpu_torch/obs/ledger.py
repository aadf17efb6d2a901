"""Append-only per-query run ledger (JSONL) with fingerprint keying.

A copy of the JAX package's ``ndstpu/obs/ledger.py``.  The port's rows
carry the engine ``torch-<device type>`` (``torch-cuda``, ``torch-cpu``), so
a ledger shared with the JAX package never serves one engine's priors to
the other.

Every measured query execution lands here as one JSON line keyed by a
*fingerprint* — ``engine|sf<scale>|seed:<seed>|<warmth>`` — where
warmth is **measured, not asserted**: the tracer's ``compile_s`` /
``execute_s`` split (ndstpu_torch/obs/trace.py) decides cold vs warm with
the same rule the BenchReport metrics block uses.  Round 5's headline
regressed from 2.56x to 0.60x because a cold re-baseline silently
burned the driver's budget; the ledger is the durable memory that
makes such a run *say so*: it serves two priors per query,

* **best-known-warm** — the fastest warm wall ever recorded.  Cold
  runs contribute their ``execute_s`` (a cold run's post-compile
  execution is the best available warm proxy), so a first-ever cold
  pass still seeds a baseline the next run can be judged against.
* **expected-cold** — the median cold wall (first-compile cost), the
  honest ETA when no warm artifacts exist.

Consumers: the harness heartbeat / cheapest-first budget degradation
(ndstpu_torch/harness/progress.py) and the regression sentinel
(ndstpu_torch/obs/sentinel.py).

The file format is one self-describing dict per line (``v: 1``);
unreadable lines are counted and skipped, never fatal — an interrupted
append must not poison the history.  ``ingest_file`` understands the
legacy artifact shapes already in the tree (``BENCH_r0*.json`` driver
records, ``docs/WARM_R5_SF1.json`` discover/steady walls, and
``*.metrics.json`` power-run sidecars) so the pre-ledger history
serves priors from day one.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Iterable, List, Optional

LEDGER_ENV = "NDSTPU_LEDGER"
DEFAULT_RELPATH = os.path.join(".bench_cache", "ledger.jsonl")

# same threshold as the BenchReport metrics block / query_summaries():
# cold = compile work happened beyond clock noise
_COLD_FRAC = 0.05
_COLD_ABS_S = 1e-4


def default_path(root: str = ".") -> str:
    """Ledger location: $NDSTPU_LEDGER, else .bench_cache/ledger.jsonl."""
    return os.environ.get(LEDGER_ENV) or os.path.join(root, DEFAULT_RELPATH)


def derive_warmth(wall_s: float, compile_s: float) -> str:
    return "cold" if compile_s > max(_COLD_FRAC * wall_s, _COLD_ABS_S) \
        else "warm"


def fingerprint(engine: str, scale_factor, seed, warmth: str) -> str:
    return f"{engine}|sf{scale_factor}|seed:{seed}|{warmth}"


def make_entry(query: str, wall_s: float, compile_s: float = 0.0,
               execute_s: float = 0.0, engine: str = "unknown",
               scale_factor="unknown", seed="unknown",
               warmth: Optional[str] = None, source: str = "",
               ts: Optional[float] = None,
               extra: Optional[dict] = None) -> dict:
    """One ledger line.  ``warmth`` defaults to the measured
    compile/execute-split classification; pass it explicitly only for
    legacy artifacts that recorded the phase out of band (e.g. the
    warm-corpus discover/steady passes).

    A warm execution that was served cached spine tables
    (``extra.spine_hits`` > 0, engine/spine.py) is its own warmth
    class — ``spine-warm`` — because its wall is not comparable to a
    plain warm replay: it skipped the spine's scan/filter/join work
    entirely.  Keeping it out of the ``warm`` fingerprint means spine
    hits can never deflate ``best_warm`` baselines (and the sentinel
    can price the hit value explicitly)."""
    w = warmth or derive_warmth(wall_s, compile_s)
    if warmth is None and w == "warm" and extra and \
            extra.get("spine_hits"):
        w = "spine-warm"
    e = {
        "v": 1,
        "ts": round(time.time() if ts is None else ts, 3),
        "query": query,
        "engine": engine,
        "scale_factor": str(scale_factor),
        "seed": str(seed),
        "warmth": w,
        "wall_s": round(float(wall_s), 6),
        "compile_s": round(float(compile_s), 6),
        "execute_s": round(float(execute_s), 6),
        "fingerprint": fingerprint(engine, scale_factor, seed, w),
        "source": source,
    }
    if extra:
        e["extra"] = extra
    return e


def _dedupe_key(e: dict):
    return (e.get("source"), e.get("query"), e.get("warmth"),
            round(float(e.get("wall_s", 0.0)), 4))


class Ledger:
    """JSONL-backed run history.  ``path=None`` keeps it in memory only
    (selftest / read-only classification)."""

    def __init__(self, path: Optional[str] = None, load: bool = True):
        self.path = path
        self.entries: List[dict] = []
        self.corrupt_lines = 0
        self._seen = set()
        if path and load and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        e = json.loads(line)
                    except ValueError:
                        self.corrupt_lines += 1
                        continue
                    if isinstance(e, dict) and "query" in e:
                        self.entries.append(e)
                        self._seen.add(_dedupe_key(e))
                    else:
                        self.corrupt_lines += 1

    def __len__(self) -> int:
        return len(self.entries)

    # -- write ---------------------------------------------------------------

    def append(self, entries, dedupe: bool = False) -> int:
        """Append entry dict(s) to memory and (when backed) the file.
        ``dedupe=True`` skips entries already present under the
        (source, query, warmth, wall) key — re-ingesting the same
        artifact is then a no-op."""
        if isinstance(entries, dict):
            entries = [entries]
        added = []
        for e in entries:
            k = _dedupe_key(e)
            if dedupe and k in self._seen:
                continue
            self._seen.add(k)
            self.entries.append(e)
            added.append(e)
        if added and self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # durable append (flush+fsync): a kill right after a query
            # completes must not lose its ledger entry, or resume would
            # re-run it
            with open(self.path, "a") as f:
                for e in added:
                    f.write(json.dumps(e, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return len(added)

    def record_query(self, query: str, wall_s: float, compile_s: float,
                     execute_s: float, **ctx) -> dict:
        e = make_entry(query, wall_s, compile_s, execute_s, **ctx)
        self.append(e)
        return e

    # -- priors --------------------------------------------------------------

    def _match(self, query: Optional[str] = None,
               engine: Optional[str] = None,
               scale_factor=None,
               warmth: Optional[str] = None) -> List[dict]:
        out = []
        for e in self.entries:
            if query is not None and e.get("query") != query:
                continue
            if engine is not None and e.get("engine") != engine:
                continue
            if scale_factor is not None and \
                    e.get("scale_factor") != str(scale_factor):
                continue
            if warmth is not None and e.get("warmth") != warmth:
                continue
            out.append(e)
        return out

    def best_warm(self, query: str, engine: Optional[str] = None,
                  scale_factor=None,
                  snapshot_epoch: Optional[str] = None
                  ) -> Optional[float]:
        """Fastest known warm wall.  Cold entries contribute their
        execute_s split — the post-compile execution is the warm proxy
        that lets a second run be judged against a first-ever cold one.

        With ``snapshot_epoch``, entries stamped with a DIFFERENT
        ``extra.snapshot_epoch`` (io/lake.warehouse_epoch) are excluded
        — a warm wall measured over other data is not a baseline for
        this data.  Unstamped (pre-epoch) entries still qualify, so
        legacy ledgers keep comparing until re-stamped."""
        def epoch_ok(e: dict) -> bool:
            if snapshot_epoch is None:
                return True
            ep = (e.get("extra") or {}).get("snapshot_epoch")
            return ep is None or ep == snapshot_epoch

        vals = [e["wall_s"] for e in self._match(query, engine,
                                                 scale_factor, "warm")
                if epoch_ok(e)]
        vals += [e["execute_s"] for e in self._match(query, engine,
                                                     scale_factor, "cold")
                 if e.get("execute_s", 0.0) > 1e-6 and epoch_ok(e)]
        return min(vals) if vals else None

    def warm_epochs(self, query: str, engine: Optional[str] = None,
                    scale_factor=None) -> set:
        """Distinct stamped snapshot epochs among this scope's
        baseline-eligible entries (warm walls + cold execute proxies)
        — the sentinel's data-changed detector."""
        out = set()
        for warmth in ("warm", "cold"):
            for e in self._match(query, engine, scale_factor, warmth):
                if warmth == "cold" and \
                        e.get("execute_s", 0.0) <= 1e-6:
                    continue
                ep = (e.get("extra") or {}).get("snapshot_epoch")
                if ep:
                    out.add(ep)
        return out

    def expected_cold(self, query: str, engine: Optional[str] = None,
                      scale_factor=None) -> Optional[float]:
        """Median cold wall — the first-compile cost prior."""
        vals = sorted(e["wall_s"] for e in self._match(query, engine,
                                                       scale_factor, "cold"))
        if not vals:
            return None
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2

    def estimate(self, query: str, engine: Optional[str] = None,
                 scale_factor=None, warmth: str = "warm",
                 default: Optional[float] = None) -> Optional[float]:
        """ETA prior for the heartbeat.  Unlike the sentinel baselines
        (strict scope), an estimate relaxes its scope — any history
        beats no history when projecting a deadline: exact
        (engine, sf) -> same engine any sf -> any engine."""
        for eng, sf in ((engine, scale_factor), (engine, None),
                        (None, None)):
            if warmth == "cold":
                v = self.expected_cold(query, eng, sf) or \
                    self.best_warm(query, eng, sf)
            else:
                v = self.best_warm(query, eng, sf) or \
                    self.expected_cold(query, eng, sf)
            if v is not None:
                return v
        return default

    def queries(self) -> set:
        return {e["query"] for e in self.entries}

    # -- legacy-artifact ingest ----------------------------------------------

    def ingest_file(self, path: str, engine: Optional[str] = None,
                    scale_factor=None, seed=None) -> int:
        """Sniff one artifact's shape and ingest it (deduped):

        * power-run sidecar (``run_metrics`` output): ``queries: [...]``
          with per-query wall/compile/execute + mode;
        * warm-corpus artifact (docs/WARM_R5_SF1.json): ``discover`` /
          ``steady`` name->seconds maps (cold / warm passes);
        * driver record (BENCH_r0*.json): ``cmd``/``rc`` + ``parsed``
          headline — kept as one run-level ``__bench__`` entry;
        * an existing ledger (JSONL) — merged line by line.
        """
        src = os.path.basename(path)
        with open(path) as f:
            text = f.read()
        try:
            obj = json.loads(text)
        except ValueError:
            obj = None
        entries: List[dict] = []
        if isinstance(obj, dict) and isinstance(obj.get("queries"), list):
            eng = engine or obj.get("engine", "unknown")
            for q in obj["queries"]:
                if not isinstance(q, dict) or "query" not in q:
                    continue
                entries.append(make_entry(
                    q["query"], q.get("wall_s", 0.0),
                    q.get("compile_s", 0.0), q.get("execute_s", 0.0),
                    engine=eng, scale_factor=scale_factor or "unknown",
                    seed=seed or "unknown",
                    warmth=q.get("mode"), source=src))
        elif isinstance(obj, dict) and ("discover" in obj or
                                        "steady" in obj):
            eng = engine or "tpu"
            sf = scale_factor or "unknown"
            sd = seed or "unknown"
            for q, wall in (obj.get("discover") or {}).items():
                entries.append(make_entry(
                    q, wall, compile_s=wall, engine=eng, scale_factor=sf,
                    seed=sd, warmth="cold", source=src))
            for q, wall in (obj.get("steady") or {}).items():
                entries.append(make_entry(
                    q, wall, execute_s=wall, engine=eng, scale_factor=sf,
                    seed=sd, warmth="warm", source=src))
        elif isinstance(obj, dict) and "cmd" in obj and "rc" in obj:
            parsed = obj.get("parsed") or {}
            entries.append(make_entry(
                "__bench__", parsed.get("elapsed_s", 0.0) or 0.0,
                engine=engine or "unknown",
                scale_factor=scale_factor or "unknown",
                seed=seed or "unknown", warmth="unknown", source=src,
                extra={k: parsed[k] for k in
                       ("metric", "value", "vs_baseline",
                        "geomean_speedup", "partial", "phase_reached")
                       if k in parsed} or None))
        elif obj is None:
            # maybe JSONL (another ledger): merge parseable lines
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if isinstance(e, dict) and "query" in e:
                    entries.append(e)
        return self.append(entries, dedupe=True)

    def ingest_history(self, root: str = ".") -> Dict[str, int]:
        """Ingest the repo's committed history: BENCH_r0*.json driver
        records, the warm-corpus walls, and any power-run sidecars at
        the root / under docs.  Returns {path: entries added}."""
        counts: Dict[str, int] = {}
        for p in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
            counts[p] = self.ingest_file(p)
        warm = os.path.join(root, "docs", "WARM_R5_SF1.json")
        if os.path.exists(warm):
            counts[warm] = self.ingest_file(
                warm, engine="tpu", scale_factor="1", seed="bench")
        for pat in ("*.metrics.json", os.path.join("docs",
                                                   "*.metrics.json")):
            for p in sorted(glob.glob(os.path.join(root, pat))):
                counts[p] = self.ingest_file(p)
        return counts
