"""Shuffle-exchange helpers (``ndstpu.parallel.exchange``).

The JAX package moves rows between devices with three collectives inside
``shard_map``: a hash repartition (``all_to_all``), a broadcast of a
join's build side (``all_gather``) and a partial-aggregate combine
(``psum``).  On one rank no row moves, so the port's distributed
executor reads its rows in place and calls none of them; the collectives
come with the multi-rank path over NCCL.  What the one-rank path needs
is here: the refusal it raises and the host-side splitmix64 that assigns
a shuffle join's build rows to partitions, bit-identical to the JAX
package's, so that rows land on the same shard in both packages.
"""

from __future__ import annotations

import numpy as np


class DistUnsupported(Exception):
    """Plan shape outside the distributed subset — fall back single-chip.

    ``code`` is the static analyzer's NDS3xx diagnostic for raise sites
    it models (ndstpu_torch/analysis/diagnostics.py); data-dependent
    guards (dup runs, key-domain overflow, shuffle drops) stay uncoded."""

    def __init__(self, msg: str, code=None):
        super().__init__(msg)
        self.code = code


def mix64_np(x):
    """Host-side splitmix64 finalizer (numpy), bit-identical to the JAX
    package's ``_mix64``.  Used to pre-partition a join build side with
    the same bucket assignment the probe shuffle computes."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))
