"""What the port uses of ``ndstpu.io.gdict``, the warehouse-wide frozen
string dictionaries: the kill switch and a dictionary's byte size.

The sidecar files themselves wait for the transcoded-warehouse slice
(they are read through pyarrow).  The port's generated and loaded
warehouses carry one sorted dictionary a column, which the out-of-core
scan streams as it is: every chunk of a host table holds codes of the
table's one dictionary.
"""

from __future__ import annotations

import os


def enabled() -> bool:
    """NDSTPU_GLOBAL_DICTS=0 kills the global-dictionary layer."""
    return os.environ.get("NDSTPU_GLOBAL_DICTS", "1") not in ("", "0")


def dictionary_nbytes(values) -> int:
    """Actual encoded byte size of a dictionary's text (UTF-8): what the
    strings really cost, not an 8 B a entry pointer estimate."""
    if values is None:
        return 0
    return int(sum(len(str(v).encode("utf-8")) for v in values))
