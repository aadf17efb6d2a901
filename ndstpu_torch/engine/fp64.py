"""Float aggregation on native fp64: the port of ``ndstpu.engine.df64``.

The TPU has no float64 ALU, so the JAX package carries each float sum as
an unevaluated pair of float32s through a segmented scan over rows sorted
by segment.  Hopper (and the CPU) add float64 natively, so each sum here
is one float64 ``index_add_``, which needs no sort order and no scan (and
so none of df64's ``order`` and ``levels`` inputs).
"""

from __future__ import annotations

from typing import Tuple

import torch


def segment_sum_compensated(x: torch.Tensor, gid: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """Per-segment float64 sums of ``x`` (``gid`` in range)."""
    out = torch.zeros(num_segments, dtype=torch.float64, device=x.device)
    return out.index_add_(0, gid, x.to(torch.float64))


def segment_sum_compensated2(x1: torch.Tensor, x2: torch.Tensor,
                             gid: torch.Tensor, num_segments: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two per-segment float64 sums over the same segmentation (stddev's
    centred moments)."""
    return (segment_sum_compensated(x1, gid, num_segments),
            segment_sum_compensated(x2, gid, num_segments))
