"""Budget-aware progress heartbeat + deadline degradation.

A copy of the JAX package's ``ndstpu/harness/progress.py``, its imports
changed.

Round 5's driver silently burned a 1740 s budget on a cold
re-baseline; nothing printed "you will not finish".  This module is
the visible layer: each harness phase gets a deadline budget (from the
bench YAML / ``--budget_s``), the runner emits heartbeat lines + span
events (query i/N, elapsed, ETA from ledger priors, remaining budget),
and when the projection exceeds the budget the run degrades
*explicitly* instead of just dying at the deadline:

* remaining queries are reordered **cheapest-first** by ledger prior,
  so a deadline cut maximizes coverage;
* queries that cannot fit are skipped with a per-query
  ``partial_reason`` recorded into the report — never a bare
  ``partial: true``.

Heartbeat line grammar (greppable, one per query start plus phase
boundaries)::

    [heartbeat] power 7/103 query48 elapsed=34.2s eta=512.3s \
budget=1740s remaining=1705.8s
    [budget] power: projected 812.3s exceeds remaining 400.0s of \
1740s budget - reordering 57 remaining queries cheapest-first
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ndstpu_torch import obs

DEFAULT_COST_S = 5.0  # prior for never-seen queries (mid-pack warm-ish)


class Heartbeat:
    """One progress line + tracer event per beat."""

    def __init__(self, phase: str, total: int,
                 budget_s: Optional[float] = None,
                 out: Callable[[str], None] = print):
        self.phase = phase
        self.total = total
        self.budget_s = budget_s
        self.out = out

    def beat(self, i: int, name: str, elapsed_s: float,
             eta_s: Optional[float] = None) -> None:
        line = (f"[heartbeat] {self.phase} {i}/{self.total} {name} "
                f"elapsed={elapsed_s:.1f}s")
        attrs = {"phase": self.phase, "i": i, "total": self.total,
                 "query": name, "elapsed_s": round(elapsed_s, 3)}
        if eta_s is not None:
            line += f" eta={eta_s:.1f}s"
            attrs["eta_s"] = round(eta_s, 3)
        if self.budget_s:
            left = self.budget_s - elapsed_s
            line += f" budget={self.budget_s:g}s remaining={left:.1f}s"
            attrs["budget_s"] = self.budget_s
            attrs["budget_remaining_s"] = round(left, 3)
        self.out(line)
        obs.record("heartbeat", "heartbeat", time.time(), 0.0, **attrs)


class BudgetedQueue:
    """Deadline-budgeted work queue over query names.

    ``next(elapsed_s)`` pops the next name to run, or ``None`` when
    done/cut.  On the first overrun projection the remaining names are
    reordered cheapest-first (by the supplied ledger-prior estimator);
    names that cannot fit land in ``skipped`` with one human-readable
    reason each.  Without a budget it degenerates to plain FIFO.
    """

    def __init__(self, names, budget_s: Optional[float],
                 estimate: Optional[Callable[[str], Optional[float]]],
                 phase: str = "run",
                 default_cost_s: float = DEFAULT_COST_S,
                 on_event: Callable[[str], None] = print):
        self._names: List[str] = list(names)
        self.budget_s = budget_s if budget_s and budget_s > 0 else None
        self._estimate = estimate
        self.default_cost_s = default_cost_s
        self.phase = phase
        self.reordered = False
        self.skipped: Dict[str, str] = {}
        self._on_event = on_event

    def cost(self, name: str) -> float:
        c = self._estimate(name) if self._estimate else None
        return float(c) if c and c > 0 else self.default_cost_s

    def projected_s(self) -> float:
        return sum(self.cost(n) for n in self._names)

    @property
    def remaining(self) -> List[str]:
        return list(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def _skip_all(self, reason_for: Callable[[str], str]) -> None:
        for n in self._names:
            self.skipped[n] = reason_for(n)
        if self._names:
            self._on_event(
                f"[budget] {self.phase}: cutting {len(self._names)} "
                f"queries ({', '.join(self._names[:8])}"
                + ("..." if len(self._names) > 8 else "")
                + ") - per-query partial_reason recorded in the report")
        self._names = []

    def next(self, elapsed_s: float) -> Optional[str]:
        if not self._names:
            return None
        if self.budget_s is None:
            return self._names.pop(0)
        left = self.budget_s - elapsed_s
        projected = self.projected_s()
        if projected > left and not self.reordered:
            self._names.sort(key=self.cost)
            self.reordered = True
            self._on_event(
                f"[budget] {self.phase}: projected {projected:.1f}s "
                f"exceeds remaining {left:.1f}s of {self.budget_s:g}s "
                f"budget - reordering {len(self._names)} remaining "
                f"queries cheapest-first (ledger priors)")
            obs.inc("harness.budget.reordered")
        if left <= 0:
            self._skip_all(lambda n: (
                f"budget exhausted: {elapsed_s:.1f}s elapsed >= "
                f"{self.budget_s:g}s {self.phase} budget"))
            return None
        # cheapest-first means: if the cheapest remaining query does
        # not fit, nothing costlier will either
        if self.reordered and self.cost(self._names[0]) > left:
            self._skip_all(lambda n: (
                f"budget: prior {self.cost(n):.2f}s exceeds remaining "
                f"{left:.1f}s of {self.budget_s:g}s "
                f"{self.phase} budget"))
            return None
        return self._names.pop(0)


def ledger_estimator(led, engine: Optional[str] = None,
                     scale_factor=None, warmth: str = "warm"):
    """Estimator closure over ledger priors for BudgetedQueue /
    Heartbeat ETA.  ``led`` may be None (no priors -> default cost)."""
    if led is None:
        return lambda name: None
    return lambda name: led.estimate(name, engine=engine,
                                     scale_factor=scale_factor,
                                     warmth=warmth)
