"""The card's fixed-order float64 grouped sums (``engine/fp64.py``), timed
and checked at the corpus's row count.

    python scripts/torch_fp64_sums.py [ROWS]

For 1, 2, 8, 24,443 and 1,048,576 segments over ``ROWS`` rows
(57,600,550 by default, store_sales at SF 20), with the values a money
column's doubles (cents over 100) and the segment ids uniform (up to 8
segments) or Zipf-skewed: the device time of ``fp64.segment_sum_compensated``
called eagerly and replayed from a captured CUDA graph, of one sort and
one ``torch.segment_reduce`` level (the design before the pieces and
the masked sums), and of a float64 ``index_add_`` (atomics, no fixed
order); whether five runs of each give the same bits, whether the graph's
replay equals the eager call, the largest relative difference from
``index_add_``'s sums, and the bound: the bytes read and written (values
and ids read once, the sums written once) over the card's memory rate.
Prints one JSON line a shape (``"phase": "fp64 sums"``).  Needs one
CUDA card.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ndstpu_torch.engine import fp64  # noqa: E402

SEGMENTS = (1, 2, 8, 24_443, 1 << 20)
RUNS = 5


def one_level(x, gid, segs):
    """The sort and a single ``segment_reduce`` level: one block adds a
    whole segment."""
    keys, order = torch.sort(gid.to(torch.int32), stable=True)
    lengths = torch.diff(torch.searchsorted(
        keys, torch.arange(segs, dtype=torch.int32, device=x.device),
        right=True), prepend=keys.new_zeros(1, dtype=torch.int64))
    return torch.segment_reduce(x[order], "sum", lengths=lengths,
                                unsafe=True, initial=0.0)


def differing(fn) -> int:
    outs = [fn() for _ in range(RUNS)]
    return sum(int((o != outs[0]).sum()) for o in outs[1:])


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 57_600_550
    card = cs.card_line()
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    x = torch.randint(-10**7, 10**7, (n,), device="cuda",
                      generator=g).to(torch.float64) / 100.0
    for segs in SEGMENTS:
        gid = (torch.randint(0, segs, (n,), device="cuda", generator=g)
               if segs <= 8 else cs.zipf_gid(n, segs, g)).to(torch.int64)

        def atomic():
            return torch.zeros(segs, dtype=torch.float64,
                               device="cuda").index_add_(0, gid, x)

        def fixed():
            return fp64.segment_sum_compensated(x, gid, segs)

        want = atomic()
        got = fixed()
        rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fixed()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = fixed()
        graph.replay()
        torch.cuda.synchronize()
        bound_ms = (16 * n + 8 * segs) / cs.HBM_BYTES_PER_S * 1e3
        cs.say("fp64 sums", rows=n, segments=segs,
               path=("masked sums" if segs <= fp64.FEW_SEGMENTS
                     else "sort, pieces, segments"),
               fixed_ms=cs.cuda_ms(fixed, 10),
               graph_ms=cs.cuda_ms(graph.replay, 10),
               one_level_ms=cs.cuda_ms(lambda: one_level(x, gid, segs), 10),
               index_add_ms=cs.cuda_ms(atomic, 10), bound_ms=bound_ms,
               fixed_runs_differing_values=differing(fixed),
               index_add_runs_differing_values=differing(atomic),
               replay_equals_eager=bool(torch.equal(captured, got)),
               max_rel_vs_index_add=rel, card=card)
        del graph, captured, gid
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
