"""The NDS queries the port runs, rendered by its own copy of the JAX
package's renderer (:mod:`ndstpu_torch.queries.streamgen`; rngseed
07291122510, stream 0).

:func:`corpus` is the power corpus, all 103 parts of the 99 templates.
The named sets are the reports of the earlier card paths: the q3
family's star joins (``QUERIES``), the store-channel reports
(``STORE_QUERIES``), the store-channel rollup and window reports
(``WINDOW_QUERIES``) and the set-operation and distinct reports
(``SETOP_QUERIES``).  ``chip_smoke.py`` and :mod:`ndstpu_torch.profile`
run them.
"""

from __future__ import annotations

from typing import List, Tuple


def corpus() -> List[Tuple[str, str]]:
    """The power corpus: (part name, SQL) for every part of every
    template, in template order."""
    from ndstpu_torch.queries.streamgen import (BENCH_RNGSEED,
                                                render_power_corpus)
    return render_power_corpus(BENCH_RNGSEED, 0)


def rendered(q: str) -> str:
    """The text of one single-statement template, ``q`` as in "q3"."""
    from ndstpu_torch.queries.streamgen import (BENCH_RNGSEED, TEMPLATE_DIR,
                                                render_template_parts)
    ((_name, sql),) = render_template_parts(
        str(TEMPLATE_DIR / f"query{q[1:]}.tpl"), BENCH_RNGSEED, 0)
    return sql


_NAMED = {"QUERIES": ("q3", "q42", "q52", "q55"),
          "STORE_QUERIES": ("q9", "q43", "q88", "q93"),
          "WINDOW_QUERIES": ("q36", "q47", "q67", "q89", "q98"),
          "SETOP_QUERIES": ("q2", "q28", "q41", "q76")}


def __getattr__(name: str) -> dict:
    # the named sets render when first asked for, so that importing the
    # package does not import ``streamgen``, which ``python -m
    # ndstpu_torch.queries.streamgen`` runs as its main module
    if name not in _NAMED:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    named = globals()[name] = {q: rendered(q) for q in _NAMED[name]}
    return named

# q9's five ss_quantity buckets as rendered: (low, high, count threshold)
Q9_BUCKETS = ((1, 20, 50330), (21, 40, 16645), (41, 60, 40372),
              (61, 80, 5743), (81, 100, 20142))
