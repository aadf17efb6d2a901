"""Segment-sum micro-bench: the port's kernels against one-call PyTorch.

The counterpart of ``scripts/pallas_bench.py``.  It times four things at
the grouped-aggregation hot op's shape (default 4,000,000 rows over 1,024
segments, seed 0, the JAX script's value, gid and mask distributions):

* ``library_f32``: ``torch.where`` then ``index_add_`` on float32;
* ``kernel_f32``: :func:`ndstpu_torch.ops.segsum.segment_sum_f32`;
* ``library_i64``: ``torch.where`` then ``index_add_`` on int64;
* ``kernel_i64``: :func:`ndstpu_torch.ops.segsum.segment_sum_decimal`.

It checks the kernels as the JAX script does (f32 within rtol 3e-4, atol
1.0 of the library call; int64 exact) and prints one JSON line of the four
times in milliseconds.

    python -m ndstpu_torch.ops.bench [rows] [segments] [--device cpu]

On the card it times with CUDA events; on the CPU, only when asked, with
the host clock, and the kernels' plain versions stand in for the kernels.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ndstpu_torch.engine.torchexec import resolve_device
from ndstpu_torch.ops import segsum

REPS = 20  # timed calls per variant, as in scripts/pallas_bench.py


def _time_ms(fn: Callable[[], object], device: torch.device) -> float:
    """Mean milliseconds of one call of ``fn`` over ``REPS`` calls, after
    one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / REPS
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / REPS


def inputs(rows: int, segs: int, device) -> Dict[str, torch.Tensor]:
    """The bench's inputs, drawn as ``scripts/pallas_bench.py`` draws
    them (numpy ``RandomState(0)``)."""
    rng = np.random.RandomState(0)
    vals_f = rng.uniform(-100, 100, rows).astype(np.float32)
    vals_d = rng.randint(-10 ** 9, 10 ** 9, rows).astype(np.int64)
    gid = rng.randint(0, segs, rows).astype(np.int32)
    mask = rng.rand(rows) < 0.8
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("vals_f", vals_f), ("vals_d", vals_d), ("gid", gid),
             ("mask", mask))}


def library_f32(vals, gid, mask, segs: int) -> torch.Tensor:
    out = torch.zeros(segs, dtype=torch.float32, device=vals.device)
    return out.index_add_(0, gid, torch.where(mask, vals, 0.0))


def library_i64(vals, gid, mask, segs: int) -> torch.Tensor:
    out = torch.zeros(segs, dtype=torch.int64, device=vals.device)
    return out.index_add_(0, gid, torch.where(mask, vals, 0))


def run(rows: int = 4_000_000, segs: int = 1024,
        device=None) -> Dict[str, object]:
    """Check and time the four variants; returns the JSON record."""
    dev = resolve_device(device)
    x = inputs(rows, segs, dev)
    v, vd, g, m = x["vals_f"], x["vals_d"], x["gid"], x["mask"]
    want_f = library_f32(v, g, m, segs)
    got_f = segsum.segment_sum_f32(v, g, m, segs)
    np.testing.assert_allclose(got_f.cpu().numpy(), want_f.cpu().numpy(),
                               rtol=3e-4, atol=1.0)
    want_d = library_i64(vd, g, m, segs)
    got_d = segsum.segment_sum_decimal(vd, g, m, segs)[0]
    np.testing.assert_array_equal(got_d.cpu().numpy(), want_d.cpu().numpy())
    times = {
        "library_f32_ms": _time_ms(lambda: library_f32(v, g, m, segs), dev),
        "kernel_f32_ms": _time_ms(
            lambda: segsum.segment_sum_f32(v, g, m, segs), dev),
        "library_i64_ms": _time_ms(lambda: library_i64(vd, g, m, segs), dev),
        "kernel_i64_ms": _time_ms(
            lambda: segsum.segment_sum_decimal(vd, g, m, segs), dev),
    }
    return {"rows": rows, "segs": segs, "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "timer": "cuda events" if dev.type == "cuda" else "host clock",
            **times}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="?", type=int, default=4_000_000)
    ap.add_argument("segments", nargs="?", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    rec = run(a.rows, a.segments, a.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
