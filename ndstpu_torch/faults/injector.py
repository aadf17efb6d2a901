"""Deterministic, seed-driven fault injection at named sites.

A copy of the JAX package's ``ndstpu/faults/injector.py``, its imports changed.

The engine/harness layers carry ``faults.check(site)`` probes at the
places real production failures happen:

=====================  ====================================================
site                   probe location
=====================  ====================================================
``plan``               Session planning (parse/plan/optimize path)
``compile``            whole-query discovery/compile (jaxexec)
``execute``            statement execution (all backends)
``io.write``           artifact/table writes (atomic helper, transcode)
``io.read``            streaming scan chunk reads (loader ChunkSource)
``io.prefetch``        H2D staging ring background stage (jaxexec)
``exchange.collective``SPMD shuffle/broadcast/psum trace sites
``stream.worker``      in-process throughput stream worker entry
``phase.subprocess``   bench driver phase subprocess launch
``ingest.commit``      lake CAS commit publish (io/acid, io/deltalog)
``ingest.apply``       micro-batch ingest apply (harness/ingest)
``serve.accept``       query-server connection accept loop (serve/server)
``serve.dispatch``     query-server request dispatch, pre-retry — faults
                       here are client-visible and exercise client retry
``serve.replica.crash``whole-replica process death mid-dispatch
                       (os._exit) — the fleet supervisor restarts it,
                       clients fail over to a sibling (serve/fleet)
``fleet.probe``        fleet supervisor health probe — exercises the
                       consecutive-failure threshold before a restart
=====================  ====================================================

A spec is a comma-separated rule list::

    NDSTPU_FAULTS="execute:transient:0.2:seed7,io.write:permanent:0.05"

Each rule is ``site:kind:prob[:seedN][:key=value...]`` where kind is
``transient`` | ``permanent`` | ``hang``.  Optional extras: ``times=N``
(stop firing after N injections at this site) and ``hang=S`` (seconds a
``hang`` fault sleeps; default 3600 — long enough for any watchdog).

Determinism: the fire/no-fire decision for the *n*-th probe hit at a
site is a pure function of ``(seed, site, n)`` — independent of wall
clock, PID, and thread interleaving of *other* sites — so a chaos run
with the same seed and the same per-site call sequence injects the
same faults.  Every injection ticks ``faults.injected.<site>.<kind>``
(+ ``faults.injected.total``) and prints one greppable ``[faults]``
line.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

from ndstpu_torch import obs

SITES = ("plan", "compile", "execute", "io.write", "io.read",
         "io.prefetch", "exchange.collective", "stream.worker",
         "phase.subprocess", "ingest.commit", "ingest.apply",
         "serve.accept", "serve.dispatch", "serve.replica.crash",
         "fleet.probe")

KINDS = ("transient", "permanent", "hang")

ENV_VAR = "NDSTPU_FAULTS"

DEFAULT_HANG_S = 3600.0


class FaultSpecError(ValueError):
    """A malformed NDSTPU_FAULTS spec / YAML faults block."""


class InjectedFault(RuntimeError):
    """Base class for synthetic faults (site + kind carried along)."""

    def __init__(self, message: str, site: str, kind: str):
        super().__init__(message)
        self.site = site
        self.kind = kind


class InjectedTransient(InjectedFault):
    """Synthetic transient fault — the taxonomy retries these."""

    def __init__(self, message: str, site: str):
        super().__init__(message, site, "transient")


class InjectedPermanent(InjectedFault):
    """Synthetic permanent fault — never retried, always classified."""

    def __init__(self, message: str, site: str):
        super().__init__(message, site, "permanent")


class FaultRule:
    """One parsed rule: fire ``kind`` at ``site`` with ``prob``."""

    def __init__(self, site: str, kind: str, prob: float,
                 seed: str = "0", times: Optional[int] = None,
                 hang_s: float = DEFAULT_HANG_S):
        if site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} (sites: {', '.join(SITES)})")
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} (kinds: {', '.join(KINDS)})")
        if not (0.0 <= prob <= 1.0):
            raise FaultSpecError(f"fault prob must be in [0,1]: {prob}")
        self.site = site
        self.kind = kind
        self.prob = prob
        self.seed = str(seed)
        self.times = times
        self.hang_s = hang_s
        self.fired = 0

    def should_fire(self, call_index: int) -> bool:
        """Pure function of (seed, site, call_index): python's Mersenne
        seeding from a string is stable across runs and platforms."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.prob <= 0.0:
            return False
        if self.prob >= 1.0:
            return True
        r = random.Random(f"{self.seed}|{self.site}|{call_index}")
        return r.random() < self.prob

    def describe(self) -> str:
        d = f"{self.site}:{self.kind}:{self.prob:g}:seed{self.seed}"
        if self.times is not None:
            d += f":times={self.times}"
        if self.kind == "hang" and self.hang_s != DEFAULT_HANG_S:
            d += f":hang={self.hang_s:g}"
        return d


def _parse_rule(text: str) -> FaultRule:
    parts = [p.strip() for p in text.strip().split(":") if p.strip()]
    if len(parts) < 3:
        raise FaultSpecError(
            f"fault rule needs site:kind:prob (got {text!r})")
    site, kind = parts[0], parts[1]
    try:
        prob = float(parts[2])
    except ValueError:
        raise FaultSpecError(f"bad fault prob in {text!r}: {parts[2]!r}")
    seed = "0"
    times: Optional[int] = None
    hang_s = DEFAULT_HANG_S
    for extra in parts[3:]:
        if extra.startswith("seed"):
            seed = extra[len("seed"):] or "0"
        elif extra.startswith("times="):
            times = int(extra[len("times="):])
        elif extra.startswith("hang="):
            hang_s = float(extra[len("hang="):])
        else:
            raise FaultSpecError(
                f"unknown fault rule extra {extra!r} in {text!r} "
                f"(know: seedN, times=N, hang=S)")
    return FaultRule(site, kind, prob, seed=seed, times=times,
                     hang_s=hang_s)


def parse_spec(spec) -> List[FaultRule]:
    """Parse the env-string grammar or a YAML ``faults:`` block.

    Accepted shapes::

        "execute:transient:0.2:seed7,plan:permanent:0.1"      # env string
        [{"site": "execute", "kind": "transient", "prob": 0.2,
          "seed": 7, "times": 3, "hang_s": 2.0}, ...]          # YAML list
    """
    if spec is None:
        return []
    if isinstance(spec, str):
        return [_parse_rule(r) for r in spec.split(",") if r.strip()]
    if isinstance(spec, dict):  # single-rule mapping
        spec = [spec]
    rules = []
    for item in spec:
        if isinstance(item, str):
            rules.append(_parse_rule(item))
            continue
        if not isinstance(item, dict) or "site" not in item:
            raise FaultSpecError(f"bad fault rule entry: {item!r}")
        rules.append(FaultRule(
            item["site"], item.get("kind", "transient"),
            float(item.get("prob", 1.0)),
            seed=str(item.get("seed", "0")),
            times=item.get("times"),
            hang_s=float(item.get("hang_s", DEFAULT_HANG_S))))
    return rules


class Injector:
    """Holds the active rules + per-site deterministic call counters."""

    def __init__(self, rules: List[FaultRule],
                 sleep=time.sleep, out=print):
        self._lock = threading.Lock()
        self.rules = list(rules)
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self._by_site: Dict[str, List[FaultRule]] = {}
        for r in self.rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._sleep = sleep
        self._out = out

    def check(self, site: str, key: Optional[str] = None) -> None:
        rules = self._by_site.get(site)
        if not rules:
            return
        with self._lock:
            n = self.calls.get(site, 0)
            self.calls[site] = n + 1
            fire = None
            for r in rules:
                if r.should_fire(n):
                    fire = r
                    r.fired += 1
                    self.injected[site] = self.injected.get(site, 0) + 1
                    break
        if fire is None:
            return
        what = f"{fire.kind} fault at {site}" + \
            (f" ({key})" if key else "") + f" [call {n}, {fire.describe()}]"
        obs.inc(f"faults.injected.{site}.{fire.kind}")
        obs.inc("faults.injected.total")
        self._out(f"[faults] injected {what}")
        if fire.kind == "hang":
            # simulated wedge: the probe just stops returning — real
            # protection (watchdogs, abandonment) must kick in
            self._sleep(fire.hang_s)
            return
        if fire.kind == "transient":
            raise InjectedTransient(f"injected {what}", site)
        raise InjectedPermanent(f"injected {what}", site)


# -- module-level active injector (zero-cost no-op when unset) ---------

_ACTIVE: Optional[Injector] = None


def active() -> Optional[Injector]:
    return _ACTIVE


def install(spec) -> Optional[Injector]:
    """Install an injector from a spec (string / YAML block / rule
    list); ``None`` or an empty spec uninstalls.  Returns the active
    injector (or None)."""
    global _ACTIVE
    rules = spec if isinstance(spec, list) and spec and \
        isinstance(spec[0], FaultRule) else parse_spec(spec)
    _ACTIVE = Injector(rules) if rules else None
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def install_from_env() -> Optional[Injector]:
    return install(os.environ.get(ENV_VAR) or None)


def check(site: str, key: Optional[str] = None) -> None:
    """The probe: no-op unless a spec is installed."""
    if _ACTIVE is None:
        return
    _ACTIVE.check(site, key=key)


# subprocesses inherit NDSTPU_FAULTS; configure on first import so every
# probe in every process of a chaos run sees the same spec
install_from_env()
