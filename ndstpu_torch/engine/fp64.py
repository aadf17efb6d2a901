"""Float aggregation on native fp64: the port of ``ndstpu.engine.df64``.

The TPU has no float64 ALU, so the JAX package carries each float sum as
an unevaluated pair of float32s through a segmented scan over rows sorted
by segment.  Hopper (and the CPU) add float64 natively, so no pair is
carried.  What the sorted scan also gives is a fixed order of additions,
so that a sum comes out the same in every run, and that is kept: a
float64 ``index_add_`` on a card adds with atomics in no fixed order, so
two runs of one plan (a discovery and its checked first replay) could
round a sum differently in the last bit and rank or order tied rows
differently.  On a card, up to ``FEW_SEGMENTS`` segments (a keyless
aggregate has two: its alive and its dead rows) are one masked
``torch.sum`` each, a tree reduction of fixed shape that needs no sort.
More are sorted by segment (a stable radix sort) and reduced in two
fixed-order levels of ``torch.segment_reduce`` (one block a segment):
first pieces of at most ``PIECE_ROWS`` rows, none straddling a segment,
then each segment's pieces, so that a few long segments still spread
over the whole card.  The segment and piece lengths come from the sorted
ids by binary search, with no atomics; no step reads anything back to
the host, so every path captures into a CUDA graph.  On the CPU each sum
is one ``index_add_``, which adds each segment's rows in row order.
"""

from __future__ import annotations

from typing import Tuple

import torch

# segment counts summed one masked reduction a segment
FEW_SEGMENTS = 4
# the most rows one block of the sorted path's first level adds
PIECE_ROWS = 4096


def _few(x: torch.Tensor, gid: torch.Tensor,
         num_segments: int) -> torch.Tensor:
    return torch.stack([torch.where(gid == s, x, 0.0).sum()
                        for s in range(num_segments)])


def _fixed_order(gid: torch.Tensor, num_segments: int):
    """The row order that sorts ``gid`` (stable), the lengths of the
    pieces the sorted rows are cut into, and each segment's piece count
    with one last spill segment over the unused pieces, on the device."""
    n, dev = gid.shape[0], gid.device
    keys, order = torch.sort(gid.to(torch.int32), stable=True)
    row_ends = torch.searchsorted(
        keys, torch.arange(num_segments, dtype=torch.int32, device=dev),
        right=True)
    lengths = torch.diff(row_ends, prepend=row_ends.new_zeros(1))
    pieces = (lengths + PIECE_ROWS - 1) // PIECE_ROWS
    ends = torch.cumsum(pieces, 0)
    # a bound on the pieces that needs no read-back; those past the last
    # segment's are empty
    m = n // PIECE_ROWS + num_segments + 1
    j = torch.arange(m, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(ends, j, right=True)
    s = seg.clamp(max=num_segments - 1)
    k = j - (ends[s] - pieces[s])           # the piece's rank in its segment
    piece_len = torch.where(
        seg < num_segments,
        (lengths[s] - k * PIECE_ROWS).clamp(0, PIECE_ROWS), 0)
    return order, piece_len, torch.cat([pieces, m - ends[-1:]])


def _reduce(x: torch.Tensor, order, piece_len, seg_pieces) -> torch.Tensor:
    partial = torch.segment_reduce(x.to(torch.float64)[order], "sum",
                                   lengths=piece_len, unsafe=True,
                                   initial=0.0)
    return torch.segment_reduce(partial, "sum", lengths=seg_pieces,
                                unsafe=True, initial=0.0)[:-1]


def segment_sum_compensated(x: torch.Tensor, gid: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """Per-segment float64 sums of ``x`` (``gid`` in range), each added
    in the same order in every run."""
    x = x.to(torch.float64)
    if x.device.type != "cuda" or num_segments == 0:
        out = torch.zeros(num_segments, dtype=torch.float64, device=x.device)
        return out.index_add_(0, gid, x)
    if num_segments <= FEW_SEGMENTS:
        return _few(x, gid, num_segments)
    return _reduce(x, *_fixed_order(gid, num_segments))


def segment_sum_compensated2(x1: torch.Tensor, x2: torch.Tensor,
                             gid: torch.Tensor, num_segments: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two per-segment float64 sums over the same segmentation (stddev's
    centred moments)."""
    if x1.device.type != "cuda" or num_segments <= FEW_SEGMENTS:
        return (segment_sum_compensated(x1, gid, num_segments),
                segment_sum_compensated(x2, gid, num_segments))
    order = _fixed_order(gid, num_segments)
    return _reduce(x1, *order), _reduce(x2, *order)
