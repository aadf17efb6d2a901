"""Stable diagnostic codes: the port's copy of what it uses of
``ndstpu.analysis.diagnostics``.

:class:`Diagnostic` is the finding :mod:`ndstpu_torch.analysis.canon`
emits (``NDS4xx``, plan canonicalization and parameter lifting),
:mod:`.typecheck` (``NDS1xx``, schema inference) and :mod:`.spines`
(``NDS5xx``, cross-query common spines); the
``NDS2xx`` codes are the device-lowering refusals that
:class:`ndstpu_torch.engine.torchexec.Unsupported` carries.  Severity
model: ``error`` the part cannot run on the device path, ``warning`` it
runs but something is fragile, ``info`` advisory only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

SEVERITIES = ("error", "warning", "info")

CODES: Dict[str, Tuple[str, str]] = {
    # -- NDS1xx typing ----------------------------------------------------
    "NDS101": ("warning", "join key dtype mismatch"),
    "NDS102": ("warning", "lossy implicit or explicit cast"),
    "NDS103": ("info", "int32 aggregate overflow risk at scale factor"),
    "NDS104": ("warning", "SetOp arity or column type mismatch"),
    "NDS105": ("info", "under-specified sort keys (nondeterministic ties)"),
    # -- NDS2xx device lowering ------------------------------------------
    "NDS201": ("error", "expression node not lowerable on device"),
    "NDS202": ("error", "binary operator not lowerable on device"),
    "NDS203": ("error", "unary operator not lowerable on device"),
    "NDS204": ("error", "cast not lowerable on device"),
    "NDS205": ("error", "function not lowerable on device"),
    "NDS206": ("error", "string operation on non-string operand"),
    "NDS207": ("error", "aggregate (or distinct aggregate) not lowerable"),
    "NDS208": ("error", "aggregate output expression not lowerable"),
    "NDS209": ("error", "window function not lowerable on device"),
    "NDS210": ("error", "join shape not lowerable on device"),
    "NDS211": ("error", "subquery kind not lowerable on device"),
    "NDS212": ("error", "IN-list incompatible with operand column"),
    "NDS213": ("info", "data-dependent device capacity guard"),
    "NDS214": ("info", "grouping sets need per-set passes (not combinable)"),
    # -- NDS4xx canonicalization / parameter lifting ----------------------
    "NDS401": ("info", "shape-affecting literal: value feeds static shape "
                       "or capacity planning (LIMIT, interval width, "
                       "bounded CASE value, group key)"),
    "NDS402": ("info", "literal inside a pre-resolved subquery is baked "
                       "into the recorded size plan"),
    "NDS403": ("info", "literal in a host-static context cannot bind at "
                       "runtime (function argument, non-predicate string, "
                       "unclean IN-list)"),
    "NDS404": ("warning", "corpus part does not collapse to one canonical "
                          "fingerprint across probed streams/seeds"),
    # -- NDS5xx cross-query common-spine sharing --------------------------
    "NDS501": ("info", "shared-spine candidate: canonical subtree recurs "
                       "across corpus parts and is runtime-spliceable"),
    "NDS502": ("info", "param-divergent spine: subtrees share a canonical "
                       "shape but bind different literal values, so the "
                       "value-keyed materialization cache cannot serve "
                       "one result to all of them"),
    "NDS503": ("info", "nondeterministic/row-order-sensitive subtree "
                       "(sort/window/limit inside): excluded from spine "
                       "materialization"),
    "NDS504": ("info", "estimated spine bytes exceed the memory-planner "
                       "budget (memplan row-width model): materialization "
                       "would not be admitted"),
    # -- NDS6xx static cost model -----------------------------------------
    "NDS601": ("warning", "broadcast build side over the replication "
                          "byte budget (cost model demotes it to the "
                          "shuffle path)"),
    "NDS602": ("warning", "spill-risk working set: predicted per-device "
                          "bytes exceed the device budget (fact must "
                          "stream out-of-core)"),
    "NDS603": ("info", "exchange-heavy plan: predicted collective "
                       "(all_to_all) bytes over the heavy-traffic "
                       "threshold"),
    "NDS604": ("info", "misestimate: static cardinality estimate vs "
                       "ledger-observed output beyond the calibration "
                       "threshold"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding, anchored to a plan path.

    ``path`` is a ``/``-joined chain of plan node names from the root,
    each ``NodeName[i]`` where ``i`` is the child ordinal — stable across
    runs because plans are built deterministically from the template.
    """

    code: str
    message: str
    path: str
    query: str = ""
    severity: str = ""     # defaults to the code's registered severity

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code}")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][0])
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity}")

    def key(self) -> Tuple[str, str, str]:
        """Identity: query + code + plan path (message text may
        legitimately drift as inference sharpens)."""
        return (self.query, self.code, self.path)

    def as_dict(self) -> Dict[str, str]:
        return {"query": self.query, "code": self.code,
                "severity": self.severity, "path": self.path,
                "message": self.message}
