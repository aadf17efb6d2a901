"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale SF] [--seed N]

Runs from the root of a checkout, needs one CUDA card, and drives only
``ndstpu_torch`` (it imports nothing of JAX or of the ``ndstpu`` package).
Phases, each printed on its own line; any failure raises and exits
non-zero:

1. environment: Python, torch and CUDA versions, the card's name and
   power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port from ``ndstpu_torch/ops/csrc``,
   one ``nvcc`` per source, all started together;
3. data: the store-channel warehouse generated on the card at
   ``--scale``;
4. kernels: each kernel against its plain PyTorch version on the card:
   ``segsum_decimal`` bit-exact (tolerance 0: exact int64) at the main
   path's own inputs (captured from a q42 run), at 8,000,000 Zipf-skewed
   rows over 24,443 segments, at the bench shape (4,000,000 rows x 1,024
   segments) and at the edges; ``segsum_f32`` within rtol 3e-4, atol 1.0
   at the bench shape and at 8,000,000 Zipf-skewed rows over 1,024
   segments, and rtol 2e-5, atol 1e-2 at the edges (float atomics add in
   no fixed order), each case checked 20 times and reported on its own.
   At each shape: the wrapper's time a call (CUDA events around 50
   calls), the kernel's device time a call (``torch.profiler``), the
   least time the card could take (its bound: the bytes of the rows the
   mask keeps, and every mask byte), the plain version's and a
   one-call PyTorch yardstick's time, and every regime the kernel's
   launch planner can choose, forced, checked and timed; then a sweep of
   rows a segment across the regimes;
5. slice: q3, q42, q52 and q55 through ``Session(device="cuda").sql`` —
   cold and warm times, rows, peak device memory and host syncs — each
   held against a plain numpy reference written here, independent of
   the engine;
6. bench: ``ndstpu_torch.ops.bench``'s main at its defaults, the path
   that runs ``segsum_f32``;
7. store slice: q9, q43, q88 and q93 through the same session, recorded
   and held against the numpy reference as in phase 5 (decimals exact,
   q9's averages within 1e-5 relative); then q88 once more with the name
   of a generated store for the template's 'ese', which names none, so
   that its four counts are not 0;
8. store window and rollup reports: q36, q47, q67, q89 and q98 (rollups
   with ``grouping()``, ranks, windowed aggregates over aggregates, a
   self-join on rank) through the same session, recorded and held
   against the numpy reference as in phase 5 (decimals exact, floats
   within 1e-5 relative, in the query's order); q36's rollup must reach
   ``segsum_decimal``.  Before the path runs, each of q36's finest-grain
   ``segsum_decimal`` calls is captured and checked and timed at its own
   inputs as in phase 4 (bit-exact against the plain version);
9. set operations and distinct: q28 (six ``count(distinct)`` branches
   over store_sales), q41 (DISTINCT with a correlated count), q76 (UNION
   ALL of the three channels' NULL-key rows; once more without its
   LIMIT, so that every group of the union is held) and q2 (UNION ALL of
   the web and catalog channels under a CTE the plan holds twice, which
   the executor's memo runs once) through the same session, recorded
   and held against the numpy reference as in phase 5.  Before the path
   runs, every ``segsum_decimal`` call of one run of each of the four is
   held bit-exact against the plain version at its own inputs, and each
   query's first is checked and timed as a kernel shape as in phase 4
   (q28's banded average is the path's one call).

Phases 5, 6, 7, 8 and 9 are the main paths: the kernel launch counts are
set to 0 just before each and read just after, and every kernel each path
runs must have launched.  Then one JSON line of kernels, and last the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ndstpu_torch.queries import (Q9_BUCKETS, QUERIES, SETOP_QUERIES,
                                  STORE_QUERIES, WINDOW_QUERIES)

# H100 SXM HBM3 rate (NVIDIA data sheet): the bound of a byte-bound kernel
HBM_BYTES_PER_S = 3.35e12
LIMIT = 100
SEGMENTS_Q42 = 24443
BENCH_ROWS, BENCH_SEGMENTS = 4_000_000, 1024

# the reference's reading of each query: dimension filters, group key,
# output columns and ORDER BY (column, descending)
REFERENCE = {
    "q3": dict(date={"d_moy": 11}, item={"i_manufact_id": 162},
               key=("d_year", "i_brand_id", "i_brand"),
               out=("d_year", "i_brand_id", "i_brand", "sum"),
               order=(("d_year", False), ("sum", True), ("i_brand_id", False))),
    "q42": dict(date={"d_moy": 12, "d_year": 2000}, item={"i_manager_id": 1},
                key=("d_year", "i_category_id", "i_category"),
                out=("d_year", "i_category_id", "i_category", "sum"),
                order=(("sum", True), ("d_year", False),
                       ("i_category_id", False), ("i_category", False))),
    "q52": dict(date={"d_moy": 11, "d_year": 1999}, item={"i_manager_id": 1},
                key=("d_year", "i_brand", "i_brand_id"),
                out=("d_year", "i_brand_id", "i_brand", "sum"),
                order=(("d_year", False), ("sum", True),
                       ("i_brand_id", False))),
    "q55": dict(date={"d_moy": 11, "d_year": 1999}, item={"i_manager_id": 7},
                key=("i_brand", "i_brand_id"),
                out=("i_brand_id", "i_brand", "sum"),
                order=(("sum", True), ("i_brand_id", False))),
}


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sass_atomics(build, name: str):
    """Counts of the atomic opcodes compiled into kernel library ``name``
    (``cuobjdump -sass``): whether an atomic add is native or a
    compare-and-swap loop (``ATOMS.CAST.SPIN``).  None without the tool."""
    tool = build.Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(build._target(name))],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for op in sass.split():
        if op.startswith(("ATOM", "RED")):
            counts[op] = counts.get(op, 0) + 1
    return counts


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def masked_bound_ms(mask, s: int, row_bytes: int,
                    seg_bytes: int) -> float:
    """The least time the card could take for a masked segment sum: every
    mask byte read, the value and group id (``row_bytes``) of each row the
    mask keeps read once, each segment's outputs (``seg_bytes``) written
    once, at the HBM rate.  A row the mask drops need not be read, so the
    bound counts this input's kept rows (q28's average keeps 6%)."""
    kept = int(mask.sum())
    return (mask.shape[0] + row_bytes * kept + seg_bytes * s) / \
        HBM_BYTES_PER_S * 1e3


def profiled_ms(fn, reps: int):
    """Device time a call of ``fn`` from ``torch.profiler``'s device
    events over ``reps`` calls after a warm-up: (the segment-sum kernels'
    own, every device event's, memsets and fills included)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler recorded no device events")
    own = sum(e.time_range.elapsed_us() for e in dev if "segsum" in e.name)
    every = sum(e.time_range.elapsed_us() for e in dev)
    return own / 1e3 / reps, every / 1e3 / reps


QUEUE_REPS = 20


def queued_ms(fn) -> float:
    """Device time a call of ``fn``, launch gaps included: CUDA events
    around ``QUEUE_REPS`` calls enqueued behind a sleeping kernel, so the
    host's enqueue time is hidden.  Fails if the host took longer to
    enqueue than the sleep lasted."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event()
    torch.cuda._sleep(50_000_000)           # about 25 ms at 2 GHz
    slept.record()
    start.record()
    for _ in range(QUEUE_REPS):
        fn()
    end.record()
    if slept.query():
        raise AssertionError("the card drained the queue before the host "
                             "had enqueued every call")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / QUEUE_REPS


def zipf_gid(n: int, s: int, gen) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    rank = torch.clamp(torch.exp(u * np.log(s + 1.0)).long(), 1, s)
    return ((rank - 1) * 1000003 % s).to(torch.int32)


ROUNDS = 5  # turns of the call timings


def timings(kernel, plain, library, bound_ms: float, n: int) -> dict:
    """call, device, plain and library times of one shape.  The call times
    come first, before any profiler session, in ROUNDS turns (kernel, then
    library), each turn 50 back-to-back calls; the median turn is
    reported, and every turn beside it."""
    reps = 50
    slow_reps = 50 if n < (1 << 22) else 10
    turns = {"call_ms": [], "library_ms": []}
    for _ in range(ROUNDS):
        turns["call_ms"].append(cuda_ms(kernel, reps))
        turns["library_ms"].append(cuda_ms(library, slow_reps))
    rec = {k: statistics.median(v) for k, v in turns.items()}
    rec["turns"] = turns
    rec.update(plain_ms=cuda_ms(plain, slow_reps), bound_ms=bound_ms)
    rec["device_ms"], rec["device_all_ms"] = profiled_ms(kernel, reps)
    return rec


def host_us(fn, reps: int = 500) -> float:
    """Host time a call of ``fn`` in microseconds: the host clock around
    ``reps`` calls that only enqueue work (no synchronise inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def check_segsum(segsum, vals, gid, mask, s) -> int:
    """Kernel against plain on one input; returns the max abs error."""
    ks, kc = segsum.segment_sum_decimal(vals, gid, mask, s)
    ps, pc = segsum.segment_sum_decimal_plain(vals, gid, mask, s)
    torch.cuda.synchronize()
    err = max(int((ks - ps).abs().max()), int((kc - pc).abs().max()))
    if err != 0 or not (torch.equal(ks, ps) and torch.equal(kc, pc)):
        raise AssertionError(f"segsum_decimal disagrees with its plain "
                             f"version at n={vals.shape[0]} s={s}: {err}")
    return err


def decimal_regimes(segsum, vals, gid, mask, s) -> dict:
    """Each regime of the decimal kernel that fits ``s``, forced, on one
    input: bit-exact against plain, and its queued device ms."""
    n = vals.shape[0]
    sms = segsum._sms(vals.device)
    ps, pc = segsum.segment_sum_decimal_plain(vals, gid, mask, s)
    out = {}
    fits = {segsum.DEC_GLOBAL: True,
            segsum.DEC_SMEM: 12 * s <= segsum.SMEM_DYN_MAX,
            segsum.DEC_CLUSTER: 1 < s and 12 * -(-s // 2) <=
            segsum.SMEM_DYN_MAX}
    names = {segsum.DEC_GLOBAL: "global", segsum.DEC_SMEM: "smem",
             segsum.DEC_CLUSTER: "cluster"}
    for regime, ok in fits.items():
        if not ok:
            continue
        plan = segsum._decimal_plan(regime, n, s, sms)
        ks, kc = segsum._decimal(vals, gid, mask, s, plan)
        if not (torch.equal(ks, ps) and torch.equal(kc, pc)):
            raise AssertionError(f"segsum_decimal {plan} disagrees with its "
                                 f"plain version at n={n} s={s}")
        out[names[regime]] = queued_ms(
            lambda: segsum._decimal(vals, gid, mask, s, plan))
    return out


def decimal_shape(segsum, name, vals, gid, mask, s) -> dict:
    """Check, time and sweep the regimes of the decimal kernel at one
    shape; prints its line."""
    n = vals.shape[0]
    err = check_segsum(segsum, vals, gid, mask, s)
    # yardstick: one int64 index_add_ over pre-masked inputs (the mask and
    # range folding is left out of its time)
    take = mask & (gid >= 0) & (gid < s)
    g = torch.where(take, gid, 0).long()
    v = torch.where(take, vals, 0)
    out = torch.zeros(s, dtype=torch.int64, device=vals.device)
    rec = dict(shape=name, n=n, segments=s, max_abs_err=err,
               plan=list(segsum._plan_decimal(n, s, segsum._sms(
                   vals.device))))
    if n < (1 << 20):
        # where a call's host time goes (the card waits for the host here)
        plan = segsum._plan_decimal(n, s, segsum._sms(vals.device))
        rec["host_us_a_call"] = dict(
            wrapper=host_us(lambda: segsum.segment_sum_decimal(vals, gid,
                                                               mask, s)),
            checks=host_us(lambda: segsum._to_kernel(
                "", vals, gid, mask, s, torch.int64)),
            plan=host_us(lambda: segsum._plan_decimal(
                n, s, segsum._sms(vals.device))),
            launch=host_us(lambda: segsum._decimal(vals, gid, mask, s,
                                                   plan)),
            library=host_us(lambda: out.index_add_(0, g, v)))
    rec.update(timings(
        lambda: segsum.segment_sum_decimal(vals, gid, mask, s),
        lambda: segsum.segment_sum_decimal_plain(vals, gid, mask, s),
        lambda: out.index_add_(0, g, v),
        masked_bound_ms(mask, s, 12, 16), n))
    rec["regimes_queued_ms"] = decimal_regimes(segsum, vals, gid, mask, s)
    say("kernel", name="segsum_decimal", **rec)
    return rec


def kernel_phase(segsum, q42_inputs, seed: int) -> dict:
    """segsum_decimal, bit-exact (tolerance 0) against its plain version:
    timed at the main path's own inputs (captured from a q42 run), at
    8,000,000 Zipf-skewed rows over 24,443 segments and at the bench shape;
    then the edges and a sweep of rows a segment across the regimes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    vals, gid, mask, s = q42_inputs
    shapes = [decimal_shape(segsum, "q42 main path", vals, gid, mask, s)]
    n = 8_000_000
    lv = torch.randint(-10**9, 10**9, (n,), generator=gen, device="cuda")
    lg = zipf_gid(n, SEGMENTS_Q42, gen)
    lm = torch.rand(n, generator=gen, device="cuda") < 0.9
    shapes.append(decimal_shape(segsum, "8M x 24443 zipf", lv, lg, lm,
                                SEGMENTS_Q42))
    from ndstpu_torch.ops import bench
    x = bench.inputs(BENCH_ROWS, BENCH_SEGMENTS, "cuda")
    shapes.append(decimal_shape(segsum, "bench 4M x 1024", x["vals_d"],
                                x["gid"], x["mask"], BENCH_SEGMENTS))
    del x
    err = max(r["max_abs_err"] for r in shapes)
    # edges: empty mask, gid out of range, out-of-range value (with its gid
    # in range and out of it), n = 1, views at odd storage offsets, a
    # ragged tail, the engine's 32,768-segment gate, all rows in one
    # segment
    m = 4096
    ev = torch.randint(-10**12, 10**12, (m + 3,), generator=gen,
                       device="cuda")
    eg = torch.randint(0, 37, (m + 3,), generator=gen, device="cuda",
                       dtype=torch.int32)
    em = torch.rand(m + 3, generator=gen, device="cuda") < 0.9
    at7 = torch.arange(m, device="cuda") == 7
    pv = torch.where(at7, 1 << 41, ev[:m])
    edges = {
        "empty mask": (ev[:m], eg[:m], torch.zeros_like(em[:m]), 37),
        "gid out of range": (ev[:m], eg[:m] - 5, em[:m], 30),
        "poison": (pv, eg[:m], em[:m] | at7, 37),
        "poison, gid out of range": (pv, torch.where(at7, -3, eg[:m]),
                                     em[:m] | at7, 37),
        "n = 1": (ev[:1], eg[:1] * 0, em[:1] | True, 1),
        "views at offset 1": (ev[1:m + 1], eg[1:m + 1], em[1:m + 1], 37),
        "views at offsets 1, 2, 3": (ev[1:m], eg[2:m + 1], em[3:m + 2], 37),
        "ragged tail": (ev[:m - 1], eg[:m - 1], em[:m - 1], 37),
        "8M x 32768 zipf": (lv, zipf_gid(n, 32768, gen), lm, 32768),
        "32768 segments, few rows": (ev[:m], zipf_gid(m, 32768, gen), em[:m],
                                     32768),
        "8M in one segment": (lv, torch.zeros_like(lg), lm, 1),
    }
    for name, (v, g, mk, s2) in edges.items():
        err = max(err, check_segsum(segsum, v, g, mk, s2))
        if name.startswith("poison"):
            sums, _ = segsum.segment_sum_decimal(v, g, mk, s2)
            if not bool((sums == -(2 ** 62)).all()):
                raise AssertionError(f"{name}: not every sum poisoned")
    one = edges["8M in one segment"]
    say("kernel", name="segsum_decimal", edges=list(edges), max_abs_err=err,
        one_segment_regimes_queued_ms=decimal_regimes(segsum, *one))
    # where histograms start to pay: rows a segment across the regimes
    sweep = []
    for segs in (4096, SEGMENTS_Q42):
        for per in (4, 8, 16, 32, 64, 128, 256):
            rows = per * segs
            g = zipf_gid(rows, segs, gen)
            sweep.append(dict(segments=segs, rows=rows, **decimal_regimes(
                segsum, lv[:rows], g, lm[:rows], segs)))
    say("kernel sweep", name="segsum_decimal", rows_per_segment=sweep)
    return dict(shapes[0], max_abs_err=err, shapes=shapes)


def check_segsum_f32(segsum, vals, gid, mask, s, rtol, atol,
                     against_f64: bool = False) -> dict:
    """f32 kernel against plain within (rtol, atol) (or, with
    ``against_f64``, against the float64 sum, where plain's own float32
    order is the larger error).  Returns the max abs error, the largest
    share of its allowed error (atol + rtol * |reference|) that any sum
    used (above 1 fails), and the max abs error of kernel and of plain
    each against the float64 sum, which tells whose atomic order the
    difference comes from."""
    k = segsum.segment_sum_f32(vals, gid, mask, s)
    p = segsum.segment_sum_f32_plain(vals, gid, mask, s)
    take = mask & (gid >= 0) & (gid < s)
    exact = torch.zeros(s, dtype=torch.float64, device=vals.device).index_add_(
        0, torch.where(take, gid, 0).long(),
        torch.where(take, vals.double(), 0.0))
    torch.cuda.synchronize()
    ref = exact if against_f64 else p.double()
    diff = (k.double() - ref).abs()
    share = float((diff / (atol + rtol * ref.abs())).max())
    # NaN fails: it is not <= 1
    if k.dtype != torch.float32 or k.shape != p.shape or not share <= 1:
        what = "float64 sum" if against_f64 else "plain version"
        raise AssertionError(f"segsum_f32 disagrees with its {what}"
                             f" at n={vals.shape[0]} s={s}: "
                             f"{float(diff.max())} ({share} of allowed)")
    return dict(max_abs_err=float(diff.max()), allowed_share=share,
                kernel_vs_f64=float((k.double() - exact).abs().max()),
                plain_vs_f64=float((p.double() - exact).abs().max()))


def _worst(checks) -> dict:
    return {f: max(c[f] for c in checks) for f in checks[0]}


F32_DRAWS = 20  # checks of each case, each with its own atomic order


def f32_regimes(segsum, vals, gid, mask, s, rtol, atol) -> dict:
    """Each regime of the f32 kernel that fits ``s``, forced, on one input:
    within (rtol, atol) of plain, and its queued device ms."""
    n = vals.shape[0]
    sms = segsum._sms(vals.device)
    ref = segsum.segment_sum_f32_plain(vals, gid, mask, s).double()
    plans = {"global": segsum._f32_plan(segsum.F32_GLOBAL, n, s, sms)}
    if 4 * s <= segsum.SMEM_DYN_MAX:
        plans["smem"] = segsum._f32_plan(segsum.F32_SMEM, n, s, sms)
    out = {}
    for name, plan in plans.items():
        k = segsum._f32(vals, gid, mask, s, plan).double()
        if not bool(((k - ref).abs() <= atol + rtol * ref.abs()).all()):
            raise AssertionError(f"segsum_f32 {plan} disagrees with its "
                                 f"plain version at n={n} s={s}")
        out[name] = queued_ms(lambda: segsum._f32(vals, gid, mask, s, plan))
    return out


def f32_shape(segsum, name, vals, gid, mask, s) -> dict:
    """Check (20 draws, rtol 3e-4, atol 1.0), time and sweep the regimes
    of the f32 kernel at one shape; prints its line."""
    from ndstpu_torch.ops import bench
    n = vals.shape[0]
    worst = _worst([check_segsum_f32(segsum, vals, gid, mask, s, 3e-4, 1.0)
                    for _ in range(F32_DRAWS)])
    rec = dict(shape=name, n=n, segments=s, rtol=3e-4, atol=1.0,
               draws=F32_DRAWS, **worst,
               plan=list(segsum._plan_f32(n, s, segsum._sms(vals.device))))
    # a float32 and an int32 a kept row, a float32 a segment
    rec.update(timings(
        lambda: segsum.segment_sum_f32(vals, gid, mask, s),
        lambda: segsum.segment_sum_f32_plain(vals, gid, mask, s),
        lambda: bench.library_f32(vals, gid, mask, s),
        masked_bound_ms(mask, s, 8, 4), n))
    rec["regimes_queued_ms"] = f32_regimes(segsum, vals, gid, mask, s,
                                           3e-4, 1.0)
    say("kernel", name="segsum_f32", **rec)
    return rec


def kernel_phase_f32(segsum, seed: int) -> dict:
    """segsum_f32 at the bench shape (the inputs of its main path, the
    segment-sum bench), at 8,000,000 Zipf-skewed rows over 1,024 segments
    and at the edges, each case checked F32_DRAWS times and reported on
    its own (the edges with fresh data each draw)."""
    from ndstpu_torch.ops import bench
    x = bench.inputs(BENCH_ROWS, BENCH_SEGMENTS, "cuda")
    shapes = [f32_shape(segsum, "bench 4M x 1024", x["vals_f"],
                        x["gid"], x["mask"], BENCH_SEGMENTS)]
    del x
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = 8_000_000
    zv = torch.rand(n, generator=gen, device="cuda") * 200 - 100
    zm = torch.rand(n, generator=gen, device="cuda") < 0.8
    shapes.append(f32_shape(segsum, "8M x 1024 zipf", zv,
                            zipf_gid(n, BENCH_SEGMENTS, gen), zm,
                            BENCH_SEGMENTS))
    e = 4096
    edges = {
        "all masked": lambda v, g, m: (v, g, torch.zeros_like(m), 37),
        "gid out of range": lambda v, g, m: (v, g - 5, m, 30),
        "one segment": lambda v, g, m: (v, g * 0, m, 1),
        "segments above rows": lambda v, g, m: (v[:100], g[:100], m[:100],
                                                20000),
        "views at offset 1": lambda v, g, m: (v[1:], g[1:], m[1:], 37),
        "views at offsets 1, 2, 3": lambda v, g, m: (v[1:e - 2], g[2:e - 1],
                                                     m[3:], 37),
        "ragged tail": lambda v, g, m: (v[:e - 1], g[:e - 1], m[:e - 1], 37),
        "32768 segments": lambda v, g, m: (
            v, zipf_gid(v.shape[0], 32768, gen), m, 32768),
    }
    err = max(r["max_abs_err"] for r in shapes)
    share = max(r["allowed_share"] for r in shapes)
    for name, case in edges.items():
        checks = []
        for _ in range(F32_DRAWS):
            ev = torch.rand(e, generator=gen, device="cuda") * 200 - 100
            eg = torch.randint(0, 37, (e,), generator=gen, device="cuda",
                               dtype=torch.int32)
            em = torch.rand(e, generator=gen, device="cuda") < 0.8
            ev2, eg2, em2, s2 = case(ev, eg, em)
            checks.append(check_segsum_f32(segsum, ev2, eg2, em2, s2, 2e-5,
                                           1e-2))
            if name == "all masked" and bool(
                    segsum.segment_sum_f32(ev2, eg2, em2, s2).any()):
                raise AssertionError("segsum_f32: all-masked sums are not 0")
        w = _worst(checks)
        say("kernel", name="segsum_f32", edge=name, rtol=2e-5, atol=1e-2,
            draws=F32_DRAWS, **w)
        err, share = max(err, w["max_abs_err"]), max(share, w["allowed_share"])
    # all 8M rows in one segment: plain's single-address float32 order
    # errs by some 10 at this size, so the kernel is held against the
    # float64 sum, within the edges' tolerance
    zero = torch.zeros(n, dtype=torch.int32, device="cuda")
    w = _worst([check_segsum_f32(segsum, zv, zero, zm, 1, 2e-5, 1e-2,
                                 against_f64=True)
                for _ in range(F32_DRAWS)])
    say("kernel", name="segsum_f32", edge="8M in one segment",
        reference="float64 sum", rtol=2e-5, atol=1e-2, draws=F32_DRAWS, **w)
    err, share = max(err, w["max_abs_err"]), max(share, w["allowed_share"])
    sweep = []
    for per in (1, 2, 4, 8, 16, 32):
        rows = per * SEGMENTS_Q42
        sweep.append(dict(segments=SEGMENTS_Q42, rows=rows, **f32_regimes(
            segsum, zv[:rows], zipf_gid(rows, SEGMENTS_Q42, gen), zm[:rows],
            SEGMENTS_Q42, 3e-4, 1.0)))
    say("kernel sweep", name="segsum_f32", rows_per_segment=sweep)
    return dict(shapes[0], max_abs_err=err, allowed_share=share,
                shapes=shapes)


# ---------------------------------------------------------------------------
# plain numpy reference of the queries
# ---------------------------------------------------------------------------


class Reference:
    """The queries answered from host copies of the generated tables with
    numpy alone: filter the dimensions, join through dense key arrays,
    group with exact int64 sums, order as the query orders."""

    def __init__(self, cat):
        def host(table, col):
            c = cat.get(table).column(col)
            data = c.data.cpu().numpy()
            if c.dictionary is not None:
                data = c.dictionary[data]
            return data

        self.date = {c: host("date_dim", c)
                     for c in ("d_date_sk", "d_year", "d_moy")}
        self.item = {c: host("item", c)
                     for c in ("i_item_sk", "i_brand_id", "i_brand",
                               "i_category_id", "i_category",
                               "i_manufact_id", "i_manager_id")}
        ss = cat.get("store_sales")
        date_ok = ss.column("ss_sold_date_sk").valid.cpu().numpy()
        date_sk = ss.column("ss_sold_date_sk").data.cpu().numpy()
        self.ss_item = ss.column("ss_item_sk").data.cpu().numpy()
        self.ss_price = ss.column("ss_ext_sales_price").data.cpu().numpy()
        # dense date index; NULL dates point past the table and never join
        d0 = int(self.date["d_date_sk"][0])
        assert (np.diff(self.date["d_date_sk"]) == 1).all()
        assert (np.diff(self.item["i_item_sk"]) == 1).all()
        self.didx = np.where(date_ok, date_sk - d0,
                             len(self.date["d_date_sk"])).astype(np.int64)
        self.iidx = (self.ss_item - int(self.item["i_item_sk"][0])).astype(
            np.int64)

    def answer(self, spec) -> list:
        dsel = np.ones(len(self.date["d_date_sk"]) + 1, bool)
        dsel[-1] = False
        for col, v in spec["date"].items():
            dsel[:-1] &= self.date[col] == v
        isel = np.ones(len(self.item["i_item_sk"]), bool)
        for col, v in spec["item"].items():
            isel &= self.item[col] == v
        rows = np.nonzero(dsel[self.didx] & isel[self.iidx])[0]
        d, i = self.didx[rows], self.iidx[rows]
        cols = {"d_year": self.date["d_year"][d]}
        for c in ("i_brand_id", "i_brand", "i_category_id", "i_category"):
            cols[c] = self.item[c][i]
        groups = {}
        for k, p in zip(zip(*(cols[c].tolist() for c in spec["key"])),
                        self.ss_price[rows].tolist()):
            groups[k] = groups.get(k, 0) + p
        out = []
        for k, total in groups.items():
            r = dict(zip(spec["key"], k), sum=total)
            out.append(tuple(r[c] for c in spec["out"]))
        return sort_rows(out, spec)


def _host(cat, table, col):
    """(data, valid or None) of one generated column, on the host; string
    columns decoded through their dictionary."""
    c = cat.get(table).column(col)
    data = c.data.cpu().numpy()
    if c.dictionary is not None:
        data = c.dictionary[data]
    return data, None if c.valid is None else c.valid.cpu().numpy()


def _dense_index(dim_keys: np.ndarray, keys: np.ndarray, valid) -> np.ndarray:
    """Row of the (dense, ascending) dimension key each fact key joins,
    or -1 for a NULL key."""
    assert (np.diff(dim_keys) == 1).all()
    idx = keys.astype(np.int64) - int(dim_keys[0])
    assert ((idx >= 0) & (idx < len(dim_keys)))[
        valid if valid is not None else slice(None)].all()
    return idx if valid is None else np.where(valid, idx, -1)


def _exact_sums(groups: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Per-group int64 sums through a float64 bincount, which is exact
    while every partial sum stays below 2^53 (checked)."""
    bound = np.bincount(groups, weights=np.abs(vals), minlength=n)
    assert bound.max(initial=0) < 2 ** 53
    return np.bincount(groups, weights=vals, minlength=n).astype(np.int64)


def _runs(sorted_keys: np.ndarray) -> np.ndarray:
    """Start of each run of equal values in a sorted array."""
    return np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])


def _first_rows(rows: np.ndarray, *keys) -> np.ndarray:
    """``rows`` sorted by ``keys`` (the first the primary), cut after the
    LIMIT-th and the rows that tie with it on every key."""
    order = rows[np.lexsort(tuple(k[rows] for k in reversed(keys)))]
    if len(order) <= LIMIT:
        return order
    last = order[LIMIT - 1]
    n = LIMIT
    while n < len(order) and all(k[order[n]] == k[last] for k in keys):
        n += 1
    return order[:n]


def _null_first(row) -> tuple:
    """Ascending sort key with NULL (None) before every value."""
    return tuple((0, 0) if x is None else (1, x) for x in row)


DAYS = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
        "Saturday")
# each window report's ORDER BY over its result row, as a sort key
WINDOW_ORDER = {
    # lochierarchy desc, case when lochierarchy = 0 then i_category end,
    # rank_within_parent
    "q36": lambda r: (-r[3],) + _null_first(
        (r[1] if r[3] == 0 else None, r[4])),
    # sum_sales - avg_monthly_sales (the engine's float64 difference),
    # s_store_name
    "q47": lambda r: (r[7] / 100 - r[6], r[2]),
    # all ten columns, ascending
    "q67": _null_first,
    "q89": lambda r: (r[6] / 100 - r[7], r[3]),
    "q98": lambda r: (r[2], r[3], r[0], r[1], r[6]),
}


class StoreReference:
    """q9, q43, q88, q93 and the window and rollup reports q36, q47, q67,
    q89 and q98 answered from host copies of the generated tables with
    numpy alone, written from the SQL and independent of the engine; each
    method returns the result rows in the query's order (decimals as
    scaled int64, averages and ratios as floats, computed with the
    engine's float64 operations in the same order, so that ranks and ties
    come out the same)."""

    def __init__(self, cat):
        self.cat = cat
        self.memo = {}
        self.sizes = {}     # intermediate sizes the reports reach

    def col(self, table, col):
        return _host(self.cat, table, col)[0]

    def codes(self, table, col):
        """(codes, dictionary) of a string column on the host."""
        c = self.cat.get(table).column(col)
        return c.data.cpu().numpy(), c.dictionary

    def fact(self, col):
        """store_sales column on the host (memoized)."""
        if col not in self.memo:
            self.memo[col] = _host(self.cat, "store_sales", col)
        return self.memo[col]

    def dim_rows(self, fk, table, key):
        """Row of ``table`` each store_sales row joins through ``fk``, or
        -1 for a NULL key (memoized)."""
        if (fk, table) not in self.memo:
            keys, ok = self.fact(fk)
            self.memo[(fk, table)] = _dense_index(self.col(table, key), keys,
                                                  ok)
        return self.memo[(fk, table)]

    def star(self, date_ok, item_ok=None, store_ok=None):
        """store_sales rows (as indices) that join date_dim, item and
        store and pass each dimension's mask, with their dimension rows."""
        d = self.dim_rows("ss_sold_date_sk", "date_dim", "d_date_sk")
        i = self.dim_rows("ss_item_sk", "item", "i_item_sk")
        st = self.dim_rows("ss_store_sk", "store", "s_store_sk")
        sel = (d >= 0) & np.append(date_ok, False)[d]
        if item_ok is not None:
            sel &= np.append(item_ok, False)[i]
        if store_ok is not None:
            sel &= (st >= 0) & np.append(store_ok, False)[st]
        rows = np.flatnonzero(sel)
        return rows, d[rows], i[rows], st[rows]

    def q36(self) -> list:
        """Gross margin by the rollup of (i_category, i_class) over 1998
        sales in eight states, ranked by margin within each parent."""
        states = ("AL", "GA", "CA", "CO", "FL", "ID", "IL", "IN")
        rows, _, i, _ = self.star(
            self.col("date_dim", "d_year") == 1998,
            store_ok=np.isin(self.col("store", "s_state"), states))
        cat, cat_dict = self.codes("item", "i_category")
        cls, cls_dict = self.codes("item", "i_class")
        ncls = len(cls_dict)
        g = cat[i].astype(np.int64) * ncls + cls[i]
        nb = len(cat_dict) * ncls
        profit = _exact_sums(g, self.fact("ss_net_profit")[0][rows], nb)
        sales = _exact_sums(g, self.fact("ss_ext_sales_price")[0][rows], nb)
        present = np.bincount(g, minlength=nb) > 0
        # one entry per group of each rollup level: (keys, profit, sales)
        levels = {0: [((str(cat_dict[b // ncls]), str(cls_dict[b % ncls])),
                       profit[b], sales[b]) for b in np.flatnonzero(present)]}
        by_cat = {}
        for (c, _), pr, sa in levels[0]:
            t = by_cat.setdefault(c, [0, 0])
            t[0] += pr
            t[1] += sa
        levels[1] = [((c, None), pr, sa) for c, (pr, sa) in by_cat.items()]
        levels[2] = [((None, None), int(profit.sum()), int(sales.sum()))]
        out = []
        for lvl, groups in levels.items():
            # margin as the engine divides decimals: each sum / 100 in
            # float64, then the quotient
            gm = [(float(pr) / 100) / (float(sa) / 100) for _, pr, sa in groups]
            for (keys, _, _), m in zip(groups, gm):
                peers = [x for (k2, _, _), x in zip(groups, gm)
                         if lvl != 0 or k2[0] == keys[0]]
                rank = 1 + sum(x < m for x in peers)
                out.append((m, keys[0], keys[1], lvl, rank))
        return sorted(out, key=WINDOW_ORDER["q36"])

    def _monthly(self, date_ok, item_ok, keys):
        """sum(ss_sales_price) by the item and store string attributes
        ``keys`` and the sale's (d_year, d_moy), for the sales that pass
        the masks: (each group's key codes by column, with d_year and
        d_moy as values; the dictionaries; the sums), groups in the order
        of (keys, d_year, d_moy)."""
        rows, d, i, st = self.star(date_ok, item_ok, np.ones(
            len(self.col("store", "s_store_sk")), bool))
        parts, dicts = [], {}
        for table, col in keys:
            code, dicts[col] = self.codes(table, col)
            parts.append(code[i if table == "item" else st].astype(np.int64))
        parts.append(self.col("date_dim", "d_year")[d].astype(np.int64))
        parts.append(self.col("date_dim", "d_moy")[d].astype(np.int64))
        radix = [len(dicts[c]) for _, c in keys] + [3000, 13]
        comp = np.zeros(len(rows), np.int64)
        for p, r in zip(parts, radix):
            comp = comp * r + p
        uniq, inv = np.unique(comp, return_inverse=True)
        sums = _exact_sums(inv.reshape(-1), self.fact("ss_sales_price")[0][
            rows], len(uniq))
        vals = []
        for r in reversed(radix):
            vals.append(uniq % r)
            uniq = uniq // r
        vals.reverse()
        names = [c for _, c in keys] + ["d_year", "d_moy"]
        return dict(zip(names, vals)), dicts, sums

    @staticmethod
    def _partition_avg(part_keys, sums):
        """avg of ``sums`` over each partition of equal ``part_keys`` rows,
        as the engine's windowed avg of a decimal computes it: the exact
        int64 total in float64, over the count, over 10^scale."""
        comp = np.zeros(len(sums), np.int64)
        for p in part_keys:
            comp = comp * (int(p.max(initial=0)) + 1) + p
        inv = np.unique(comp, return_inverse=True)[1].reshape(-1)
        tot = _exact_sums(inv, sums, inv.max() + 1)
        cnt = np.bincount(inv)
        return (tot.astype(np.float64) / cnt / 100)[inv]

    def q89(self) -> list:
        """Monthly 1998 sales by item class, brand and store, against
        their partition's average, for six (category, class) pairs."""
        cat = self.col("item", "i_category")
        cls = self.col("item", "i_class")
        item_ok = (np.isin(cat, ("Books", "Electronics", "Sports")) &
                   np.isin(cls, ("computers", "stereo", "football"))) | \
            (np.isin(cat, ("Men", "Jewelry", "Women")) &
             np.isin(cls, ("shirts", "birdal", "dresses")))
        keys = (("item", "i_category"), ("item", "i_class"),
                ("item", "i_brand"), ("store", "s_store_name"),
                ("store", "s_company_name"))
        g, dicts, sums = self._monthly(
            self.col("date_dim", "d_year") == 1998, item_ok, keys)
        avg = self._partition_avg(
            [g[k] for k in ("i_category", "i_brand", "s_store_name",
                            "s_company_name")], sums)
        # the engine's float64 operations, in its order
        dev = sums.astype(np.float64) / 100 - avg
        with np.errstate(divide="ignore", invalid="ignore"):
            keep = (avg != 0) & (np.abs(dev) / avg > 0.1)
        out = [tuple(str(dicts[c][g[c][j]]) for _, c in keys) +
               (int(g["d_moy"][j]), int(sums[j]), float(avg[j]))
               for j in _first_rows(np.flatnonzero(keep), dev,
                                    g["s_store_name"])]
        return sorted(out, key=WINDOW_ORDER["q89"])

    def q47(self) -> list:
        """Monthly 2001 sales by brand and store against the year's
        average, with the months before and after in the store's own
        sequence of months."""
        year = self.col("date_dim", "d_year")
        moy = self.col("date_dim", "d_moy")
        date_ok = (year == 2001) | ((year == 2000) & (moy == 12)) | \
            ((year == 2002) & (moy == 1))
        keys = (("item", "i_category"), ("item", "i_brand"),
                ("store", "s_store_name"), ("store", "s_company_name"))
        g, dicts, sums = self._monthly(date_ok, None, keys)
        self.sizes["q47 monthly groups"] = len(sums)
        part = [g[k] for _, k in keys]
        avg = self._partition_avg(part + [g["d_year"]], sums)
        # the groups come sorted by (keys, year, month): rank within the
        # four keys is the position in that order
        pid = np.zeros(len(sums), np.int64)
        for p in part:
            pid = pid * (p.max(initial=0) + 1) + p
        same_prev = np.r_[False, pid[1:] == pid[:-1]]
        same_next = np.r_[pid[:-1] == pid[1:], False]
        dev = sums.astype(np.float64) / 100 - avg
        with np.errstate(divide="ignore", invalid="ignore"):
            keep = same_prev & same_next & (g["d_year"] == 2001) & \
                (avg > 0) & (np.abs(dev) / avg > 0.1)
        out = [tuple(str(dicts[c][g[c][j]]) for _, c in keys) +
               (2001, int(g["d_moy"][j]), float(avg[j]), int(sums[j]),
                int(sums[j - 1]), int(sums[j + 1]))
               for j in _first_rows(np.flatnonzero(keep), dev,
                                    g["s_store_name"])]
        return sorted(out, key=WINDOW_ORDER["q47"])

    def q98(self) -> list:
        """Each item's revenue over 31 days of 1999 in three categories,
        and its share of its class's revenue."""
        day0 = int((np.datetime64("1999-02-22") -
                    np.datetime64("1970-01-01")).astype(np.int64))
        date = self.col("date_dim", "d_date").astype(np.int64)
        cat, cat_dict = self.codes("item", "i_category")
        item_ok = np.isin(cat_dict[cat], ("Men", "Women", "Jewelry"))
        rows, _, i, _ = self.star((date >= day0) & (date <= day0 + 30),
                                  item_ok)
        n_item = len(cat)
        item_id = self.col("item", "i_item_id")
        # i_item_id is unique (checked), so its groups are the items
        assert len(set(item_id.tolist())) == n_item
        rev = _exact_sums(i, self.fact("ss_ext_sales_price")[0][rows],
                          n_item)
        sold = np.flatnonzero(np.bincount(i, minlength=n_item) > 0)
        cls, cls_dict = self.codes("item", "i_class")
        class_rev = _exact_sums(cls[sold], rev[sold], len(cls_dict))
        desc = self.col("item", "i_item_desc")
        price = self.col("item", "i_current_price")
        out = []
        for j in sold.tolist():
            # sum * 100 (scale 2) over the class sum, as the engine divides
            # decimals: each operand / 100 in float64, then the quotient
            ratio = (float(rev[j] * 100) / 100) / \
                (float(class_rev[cls[j]]) / 100)
            out.append((str(item_id[j]), str(desc[j]), str(cat_dict[cat[j]]),
                        str(cls_dict[cls[j]]), int(price[j]), int(rev[j]),
                        ratio))
        return sorted(out, key=WINDOW_ORDER["q98"])

    def q67(self) -> list:
        """The 8-level rollup of sales by item, month and store over twelve
        months, ranked by sales within each category; the rows ranked 100
        or better, in the query's order."""
        seq = self.col("date_dim", "d_month_seq")
        months = np.arange(1193, 1193 + 12)
        n_store = len(self.col("store", "s_store_sk"))
        rows, d, i, st = self.star(np.isin(seq, months),
                                   store_ok=np.ones(n_store, bool))
        sales = self.fact("ss_sales_price")[0][rows] * \
            self.fact("ss_quantity")[0][rows]
        # each month's (year, quarter, month), and its (year, quarter) and
        # year as indices that grow with the month
        first = np.array([np.flatnonzero(seq == m)[0] for m in months])
        m_year, m_qoy, m_moy = (self.col("date_dim", c)[first]
                                for c in ("d_year", "d_qoy", "d_moy"))
        m_yq = np.unique(m_year * 4 + m_qoy, return_inverse=True)[1]
        m_y = np.unique(m_year, return_inverse=True)[1]
        # finest level (item, month, store): sorted item-major, so each
        # coarser level down to the item sums runs of the finest groups
        fine, inv = np.unique((i.astype(np.int64) * 12 + seq[d] - 1193) *
                              n_store + st, return_inverse=True)
        fsum = _exact_sums(inv.reshape(-1), sales, len(fine))
        f_item = fine // (12 * n_store)
        f_month = (fine // n_store) % 12
        cat, cat_dict = self.codes("item", "i_category")
        cls, cls_dict = self.codes("item", "i_class")
        brand, brand_dict = self.codes("item", "i_brand")
        pname = self.col("item", "i_product_name")
        store_id = self.col("store", "s_store_id")
        # product names and store ids are unique (checked), so grouping by
        # item and store is grouping by the rollup's keys
        assert len(set(pname.tolist())) == len(pname)
        assert len(set(store_id.tolist())) == n_store

        def keys(j, n):
            """The 8 rollup keys of finest group j, the last 8 - n NULL."""
            it, m = f_item[j], f_month[j]
            full = (str(cat_dict[cat[it]]), str(cls_dict[cls[it]]),
                    str(brand_dict[brand[it]]), str(pname[it]),
                    int(m_year[m]), int(m_qoy[m]), int(m_moy[m]),
                    str(store_id[fine[j] % n_store]))
            return full[:n] + (None,) * (8 - n)

        # per level: (finest group standing for each group, category code
        # of each group, sums); the category of the grand total is -1
        levels = {8: (np.arange(len(fine)), cat[f_item], fsum)}
        for n, key in ((7, fine // n_store), (6, f_item * 12 + m_yq[f_month]),
                       (5, f_item * 12 + m_y[f_month]), (4, f_item)):
            starts = _runs(key)
            levels[n] = (starts, cat[f_item[starts]],
                         np.add.reduceat(fsum, starts))
        it_rep, it_sum = levels[4][0], levels[4][2]
        attrs = (cat[f_item[it_rep]], cls[f_item[it_rep]],
                 brand[f_item[it_rep]])
        radix = (len(cat_dict), len(cls_dict), len(brand_dict))
        for n in (3, 2, 1):
            comp = np.zeros(len(it_rep), np.int64)
            for a, r in zip(attrs[:n], radix):
                comp = comp * r + a
            _, first_of, inv2 = np.unique(comp, return_index=True,
                                          return_inverse=True)
            inv2 = inv2.reshape(-1)
            rep = it_rep[first_of]
            levels[n] = (rep, cat[f_item[rep]],
                         _exact_sums(inv2, it_sum, len(first_of)))
        levels[0] = (np.zeros(1, np.int64), np.array([-1]),
                     np.array([int(fsum.sum())]))
        self.sizes.update({"q67 joined rows": len(rows),
                           "q67 finest groups": len(fine),
                           "q67 rollup groups": sum(
                               len(lv[2]) for lv in levels.values())})
        # rank within each category (the grand total alone in the NULL
        # category's partition): rank <= 100 iff the sum is at least the
        # partition's 100th largest
        out = []
        for c in range(-1, len(cat_dict)):
            vals = np.concatenate([tot[cats == c]
                                   for _, cats, tot in levels.values()])
            if not len(vals):
                continue
            cut = np.partition(vals, max(len(vals) - 100, 0))[
                max(len(vals) - 100, 0)]
            top = np.sort(vals[vals >= cut])
            for n, (rep, cats, tot) in levels.items():
                for j in np.flatnonzero((cats == c) & (tot >= cut)):
                    rank = 1 + len(top) - int(np.searchsorted(
                        top, tot[j], side="right"))
                    out.append(keys(rep[j], n) + (int(tot[j]), rank))
        return sorted(out, key=WINDOW_ORDER["q67"])

    def q9(self) -> list:
        if not (self.col("reason", "r_reason_sk") == 1).any():
            return []
        q = self.col("store_sales", "ss_quantity")
        row = []
        for lo, hi, t in Q9_BUCKETS:
            sel = (q >= lo) & (q <= hi)
            n = int(sel.sum())
            vals = self.col("store_sales", "ss_ext_discount_amt"
                            if n > t else "ss_net_paid")
            row.append(int(vals[sel].sum()) / n / 100 if n else None)
        return [tuple(row)]

    def q43(self) -> list:
        date_sk, date_ok = _host(self.cat, "store_sales", "ss_sold_date_sk")
        store_sk, store_ok = _host(self.cat, "store_sales", "ss_store_sk")
        price = self.col("store_sales", "ss_sales_price")
        didx = _dense_index(self.col("date_dim", "d_date_sk"), date_sk,
                            date_ok)
        sidx = _dense_index(self.col("store", "s_store_sk"), store_sk,
                            store_ok)
        day = np.array([DAYS.index(d) for d in
                        self.col("date_dim", "d_day_name")] + [0])
        year_ok = np.append(self.col("date_dim", "d_year") == 1999, False)
        gmt_ok = np.append(self.col("store", "s_gmt_offset") == -600, False)
        sel = year_ok[didx] & gmt_ok[sidx]
        n_store = len(gmt_ok) - 1
        grp = sidx[sel] * 7 + day[didx[sel]]
        # integer sums below 2^53 are exact in float64
        sums = np.bincount(grp, weights=price[sel], minlength=n_store * 7)
        cnts = np.bincount(grp, minlength=n_store * 7)
        assert sums.max(initial=0) < 2 ** 53
        names = self.col("store", "s_store_name")
        ids = self.col("store", "s_store_id")
        assert len(set(ids.tolist())) == n_store
        out = []
        for st in range(n_store):
            c = cnts[st * 7:(st + 1) * 7]
            if c.sum() == 0:
                continue
            out.append((names[st], ids[st]) + tuple(
                int(v) if k else None
                for v, k in zip(sums[st * 7:(st + 1) * 7], c)))
        return sorted(out, key=lambda r: (r[0], r[1]))[:LIMIT]

    def q88(self, store_name: str = "ese") -> list:
        time_sk, _ = _host(self.cat, "store_sales", "ss_sold_time_sk")
        hdemo, _ = _host(self.cat, "store_sales", "ss_hdemo_sk")
        store_sk, store_ok = _host(self.cat, "store_sales", "ss_store_sk")
        tidx = _dense_index(self.col("time_dim", "t_time_sk"), time_sk, None)
        hidx = _dense_index(self.col("household_demographics", "hd_demo_sk"),
                            hdemo, None)
        sidx = _dense_index(self.col("store", "s_store_sk"), store_sk,
                            store_ok)
        named = np.append(self.col("store", "s_store_name") == store_name,
                          False)
        base = (self.col("household_demographics", "hd_dep_count")[hidx]
                == 3) & named[sidx]
        hour = self.col("time_dim", "t_hour")[tidx]
        minute = self.col("time_dim", "t_minute")[tidx]
        row = []
        for h, late in ((8, True), (9, False), (9, True), (10, False)):
            part = (minute >= 30) if late else (minute < 30)
            row.append(int((base & (hour == h) & part).sum()))
        return [tuple(row)]

    def q93(self) -> list:
        # the reasons named 'reason 35'
        rsk = self.col("reason", "r_reason_sk")
        wanted = rsk[self.col("reason", "r_reason_desc") == "reason 35"]
        sr_reason, sr_reason_ok = _host(self.cat, "store_returns",
                                        "sr_reason_sk")
        keep = np.isin(sr_reason, wanted)
        if sr_reason_ok is not None:
            keep &= sr_reason_ok
        # the left join's NULL-extended rows fail sr_reason_sk = r_reason_sk,
        # so the result is the matched pairs: per (item, ticket) key of the
        # kept returns, their number and their summed return quantity
        item_mul = int(self.col("store_sales", "ss_item_sk").max()) + 1
        rkey = (self.col("store_returns", "sr_ticket_number")[keep] *
                item_mul + self.col("store_returns", "sr_item_sk")[keep])
        ukey, inv = np.unique(rkey, return_inverse=True)
        rcnt = np.bincount(inv, minlength=len(ukey))
        rqty = np.zeros(len(ukey), np.int64)
        np.add.at(rqty, inv, self.col("store_returns",
                                      "sr_return_quantity")[keep])
        skey = (self.col("store_sales", "ss_ticket_number") * item_mul +
                self.col("store_sales", "ss_item_sk"))
        pos = np.clip(np.searchsorted(ukey, skey), 0, max(len(ukey) - 1, 0))
        hit = np.nonzero(ukey[pos] == skey)[0] if len(ukey) else \
            np.zeros(0, np.int64)
        p = pos[hit]
        price = self.col("store_sales", "ss_sales_price")[hit]
        act = (rcnt[p] * self.col("store_sales", "ss_quantity")[hit] -
               rqty[p]) * price
        cust, cust_ok = _host(self.cat, "store_sales", "ss_customer_sk")
        c = np.where(cust_ok[hit], cust[hit], -1).astype(np.int64)
        uc, cinv = np.unique(c, return_inverse=True)
        tot = np.zeros(len(uc), np.int64)
        np.add.at(tot, cinv, act)
        rows = [(None if k < 0 else int(k), int(v)) for k, v in zip(uc, tot)]
        rows.sort(key=lambda r: (r[1], r[0] is not None, r[0] or 0))
        return rows[:LIMIT]


# q41's eight (category, colors, units, sizes) branches, each ANDed with
# the outer item's manufacturer
Q41_BRANCHES = (
    ("Women", ("powder", "khaki"), ("Ounce", "Oz"), ("medium", "extra large")),
    ("Women", ("brown", "honeydew"), ("Bunch", "Ton"), ("N/A", "small")),
    ("Men", ("floral", "deep"), ("N/A", "Dozen"), ("petite",)),
    ("Men", ("light", "cornflower"), ("Box", "Pound"),
     ("medium", "extra large")),
    ("Women", ("midnight", "snow"), ("Pallet", "Gross"),
     ("medium", "extra large")),
    ("Women", ("cyan", "papaya"), ("Cup", "Dram"), ("N/A", "small")),
    ("Men", ("orange", "frosted"), ("Each", "Tbl"), ("petite",)),
    ("Men", ("forest", "ghost"), ("Lb", "Bundle"), ("medium", "extra large")),
)
# q76's branches: (channel, the NULL-key column, its table, the table's
# sold-date, item and price columns)
Q76_BRANCHES = (
    ("store", "ss_store_sk", "store_sales", "ss_sold_date_sk", "ss_item_sk",
     "ss_ext_sales_price"),
    ("web", "ws_ship_customer_sk", "web_sales", "ws_sold_date_sk",
     "ws_item_sk", "ws_ext_sales_price"),
    ("catalog", "cs_ship_addr_sk", "catalog_sales", "cs_sold_date_sk",
     "cs_item_sk", "cs_ext_sales_price"),
)
class SetopReference:
    """q2, q28, q41 and q76 answered from host copies of the generated
    tables with numpy alone, written from the SQL and independent of the
    engine; each method returns every result row in the query's order
    (decimals as scaled int64, averages and ratios as floats computed
    with the engine's float64 operations in the same order) and asserts
    that there is one."""

    def __init__(self, cat):
        self.cat = cat
        self.sizes = {}     # intermediate sizes the reports reach

    def col(self, table, col):
        return _host(self.cat, table, col)[0]

    def q28(self) -> list:
        """avg, count and count(distinct) of ss_list_price over six
        quantity bands of the sales with a list price, coupon or
        wholesale cost in range."""
        q = self.col("store_sales", "ss_quantity")
        price = self.col("store_sales", "ss_list_price")
        coupon = self.col("store_sales", "ss_coupon_amt")
        cost = self.col("store_sales", "ss_wholesale_cost")
        # cents: list 180..190, coupon 3109..4109, wholesale 62..82
        cond = ((price >= 18000) & (price <= 19000)) | \
            ((coupon >= 310900) & (coupon <= 410900)) | \
            ((cost >= 6200) & (cost <= 8200))
        row = []
        for lo, hi in ((0, 5), (6, 10), (11, 15), (16, 20), (21, 25),
                       (26, 30)):
            vals = price[cond & (q >= lo) & (q <= hi)]
            n = len(vals)
            assert n > 0, f"q28: band {lo}..{hi} is empty"
            self.sizes[f"q28 band {lo}..{hi} rows"] = n
            # the engine's avg: the exact sum in float64, over the count,
            # over 10^scale
            row += [float(int(vals.sum())) / n / 100, n,
                    int((np.bincount(vals) > 0).sum())]
        return [tuple(row)]

    def q41(self) -> list:
        """The distinct product names of the items of manufacturers 684
        to 724 whose manufacturer makes an item of one of eight
        (category, color, units, size) kinds."""
        cat, color, units, size, manu, manu_id, name = (
            self.col("item", c) for c in (
                "i_category", "i_color", "i_units", "i_size", "i_manufact",
                "i_manufact_id", "i_product_name"))
        kind = np.zeros(len(cat), bool)
        for c, colors, unit, sizes in Q41_BRANCHES:
            kind |= (cat == c) & np.isin(color, colors) & \
                np.isin(units, unit) & np.isin(size, sizes)
        makers = np.unique(manu[kind])
        sel = (manu_id >= 684) & (manu_id <= 724) & np.isin(manu, makers)
        self.sizes.update({"q41 items of a kind": int(kind.sum()),
                           "q41 items selected": int(sel.sum())})
        out = [(str(n),) for n in sorted(set(name[sel].tolist()))]
        assert out, "q41: no item qualifies"
        return out

    def q76(self) -> list:
        """Count and sum of the extended price of each channel's sales
        with a NULL key, by year, quarter and category.  The catalog
        branch's key is never NULL in the model: its groups must be
        absent, which the data, not the reference, decides."""
        year = self.col("date_dim", "d_year")
        qoy = self.col("date_dim", "d_qoy")
        cat = self.col("item", "i_category")
        out = []
        for channel, key, table, date, item, price in Q76_BRANCHES:
            _, kvalid = _host(self.cat, table, key)
            dsk, dvalid = _host(self.cat, table, date)
            d = _dense_index(self.col("date_dim", "d_date_sk"), dsk, dvalid)
            rows = np.flatnonzero((d >= 0) & (
                ~kvalid if kvalid is not None else False))
            self.sizes[f"q76 {channel} rows"] = len(rows)
            if channel == "catalog":
                assert len(rows) == 0, "q76: catalog rows with a NULL key"
            if not len(rows):
                continue
            d = d[rows]
            i = _dense_index(self.col("item", "i_item_sk"),
                             self.col(table, item)[rows], None)
            # groups of (year, quarter, category), year and quarter
            # ascending; categories as strings, sorted below
            cat_codes, cat_of = np.unique(cat[i], return_inverse=True)
            comp = (year[d].astype(np.int64) * 5 + qoy[d]) * \
                len(cat_codes) + cat_of.reshape(-1)
            uniq, inv = np.unique(comp, return_inverse=True)
            inv = inv.reshape(-1)
            sums = _exact_sums(inv, self.col(table, price)[rows], len(uniq))
            cnts = np.bincount(inv, minlength=len(uniq))
            for u, c, t in zip(uniq.tolist(), cnts.tolist(), sums.tolist()):
                yq, k = divmod(u, len(cat_codes))
                out.append((channel, key, yq // 5, yq % 5,
                            str(cat_codes[k]), c, t))
        assert out, "q76: no sales with a NULL key"
        return sorted(out, key=lambda r: r[:5])

    def q2(self) -> list:
        """Week-over-year ratios of web and catalog sales by day of week:
        each week of 2001 against the week 53 weeks later, once for each
        pair of its days in 2001 and the other week's days in 2002 (the
        joins to date_dim repeat each week by its days in the year)."""
        week = self.col("date_dim", "d_week_seq").astype(np.int64)
        year = self.col("date_dim", "d_year")
        dow = np.array([DAYS.index(x)
                        for x in self.col("date_dim", "d_day_name")])
        n_slot = (int(week.max()) + 1) * 7
        keys, prices = [], []
        for table, date, price in (
                ("web_sales", "ws_sold_date_sk", "ws_ext_sales_price"),
                ("catalog_sales", "cs_sold_date_sk", "cs_ext_sales_price")):
            dsk, dvalid = _host(self.cat, table, date)
            d = _dense_index(self.col("date_dim", "d_date_sk"), dsk, dvalid)
            rows = np.flatnonzero(d >= 0)
            keys.append(week[d[rows]] * 7 + dow[d[rows]])
            prices.append(self.col(table, price)[rows])
        key = np.concatenate(keys)
        self.sizes["q2 joined rows"] = len(key)
        sums = _exact_sums(key, np.concatenate(prices), n_slot).reshape(-1, 7)
        had = (np.bincount(key, minlength=n_slot) > 0).reshape(-1, 7)
        days_in = {y: np.bincount(week[year == y], minlength=len(sums))
                   for y in (2001, 2002)}
        out = []
        for w in np.flatnonzero(days_in[2001] > 0).tolist():
            w2 = w + 53
            if w2 >= len(sums) or not had[w].any() or not had[w2].any() \
                    or days_in[2002][w2] == 0:
                continue
            row = [w]
            for k in range(7):
                if not (had[w, k] and had[w2, k]) or sums[w2, k] == 0:
                    row.append(None)
                    continue
                # the engine's division of two decimals and its round
                x = (np.float64(sums[w, k]) / 100.0) / \
                    (np.float64(sums[w2, k]) / 100.0)
                row.append(float(np.floor(np.abs(x) * 100.0 + 0.5) / 100.0
                                 * np.sign(x)))
            out += [tuple(row)] * int(days_in[2001][w] * days_in[2002][w2])
        assert out, "q2: no week pairs"
        return out


def rows_match(want: list, got: list, rel: float = 1e-5) -> bool:
    """Exact for ints and strings, ``rel`` relative for floats."""
    if len(want) != len(got):
        return False
    for a, b in zip(want, got):
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if x is None or y is None:
                if x is not y:
                    return False
            elif isinstance(x, float) or isinstance(y, float):
                if abs(x - y) > rel * max(abs(x), abs(y)) + 1e-12:
                    return False
            elif x != y:
                return False
    return True


def order_key(row, spec):
    pos = {c: j for j, c in enumerate(spec["out"])}
    return tuple(-row[pos[c]] if desc else row[pos[c]]
                 for c, desc in spec["order"])


def sort_rows(rows, spec):
    return sorted(rows, key=lambda r: order_key(r, spec))


def engine_rows(table, nulls: bool = False) -> list:
    """Result table -> tuples of python ints/strings/floats (decimals
    stay scaled int64, so the comparison is exact).  NULLs become None
    where ``nulls`` allows them."""
    cols = []
    for c in table.columns.values():
        valid = np.ones(len(c.data), bool) if c.valid is None else c.valid
        if not nulls and not valid.all():
            raise AssertionError("unexpected NULL in a result column")
        data = c.dictionary[c.data] if c.dictionary is not None else c.data
        cols.append([v if ok else None
                     for v, ok in zip(data.tolist(), valid.tolist())])
    return list(zip(*cols))


def compare(want_all: list, got: list, key, limit=LIMIT) -> None:
    """``got`` against the reference's rows ``want_all`` (all of them, in
    the query's order, which ``key`` gives), cut at ``limit`` (None: no
    LIMIT): rows in order; tied rows of one ORDER BY key as a set, the
    last group a subset of all the ties (the cut may split them).  Values
    within ``rows_match``'s tolerance."""
    want = want_all[:limit] if limit is not None else want_all
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference {len(want)}")
    i = 0
    while i < len(want):
        k = key(want[i])
        j = i
        while j < len(want) and key(want[j]) == k:
            j += 1
        part = got[i:j]
        if not all(rows_match([k], [key(r)]) for r in part):
            raise AssertionError(f"row {i}: order keys differ: "
                                 f"{part[:3]} vs {want[i:j][:3]}")
        if j == len(want) and j < len(want_all):
            ties = [r for r in want_all if key(r) == k]
            ok = len(set(part)) == len(part) and all(
                any(rows_match([t], [r]) for t in ties) for r in part)
        else:
            ok = rows_match(sorted(want[i:j], key=_null_first),
                            sorted(part, key=_null_first))
        if not ok:
            raise AssertionError(f"rows {i}..{j}: {part[:3]} vs "
                                 f"{want[i:j][:3]}")
        i = j


def segsum_calls(segsum, sess, sql, keep=None) -> tuple:
    """One run of ``sql`` with every ``segment_sum_decimal`` call it makes
    held bit-exact against the plain version at the call's own inputs:
    (copies of the inputs of the first ``keep`` calls, all of them by
    default, as [(vals, gid, mask, segments), ...]; the number of calls;
    their largest error)."""
    captured, errs = [], []
    wrapper = segsum.segment_sum_decimal

    def capture(vals, gid, mask, s):
        segsum.segment_sum_decimal = wrapper
        errs.append(check_segsum(segsum, vals, gid, mask, s))
        segsum.segment_sum_decimal = capture
        if keep is None or len(captured) < keep:
            captured.append((vals.clone(), gid.clone(), mask.clone(), s))
        return wrapper(vals, gid, mask, s)

    segsum.segment_sum_decimal = capture
    try:
        sess.sql(sql)
    finally:
        segsum.segment_sum_decimal = wrapper
    return captured, len(errs), max(errs, default=0)


def descale_check(seed: int, n: int = 1 << 22) -> None:
    """The engine's decimal(12, 2) -> float64 cast on the card against
    numpy's IEEE quotient, bit for bit."""
    from ndstpu_torch.engine import torchexec
    from ndstpu_torch.engine.columnar import FLOAT64, decimal
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cents = torch.randint(-10**11, 10**11, (n,), generator=gen,
                          device="cuda")
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    c = torchexec.DCol(cents, ones, decimal(12, 2))
    got = torchexec.JEval(torchexec.DTable({"x": c}, ones)).cast(
        c, FLOAT64).data.cpu().numpy()
    want = cents.cpu().numpy().astype(np.float64) / 100
    wrong = int((got != want).sum())
    say("descale", n=n, mismatches=wrong)
    if wrong:
        raise AssertionError(f"decimal descale: {wrong} of {n} quotients "
                             f"differ from the IEEE quotient")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ndstpu_torch import datagen
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.ops import build, segsum

    card = card_line()
    say("environment", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda, card=card,
        device=torch.cuda.get_device_name(0))

    t0 = time.time()
    logs = build.build_all()
    say("build", seconds=time.time() - t0, ptxas=logs,
        sass_atomics={p.stem: sass_atomics(build, p.stem)
                      for p in sorted(build.CSRC.glob("*.cu"))})

    t0 = time.time()
    cat = datagen.generate(args.scale, args.seed, "cuda")
    torch.cuda.synchronize()
    say("data", scale=args.scale, seconds=time.time() - t0,
        rows={t: cat.get(t).num_rows for t in cat.tables},
        device_bytes=torch.cuda.memory_allocated())
    sess = Session(cat, device="cuda")

    # capture the kernel's inputs on the main path (a q42 run)
    captured = segsum_calls(segsum, sess, QUERIES["q42"])[0]
    if len(captured) != 1 or captured[0][3] != SEGMENTS_Q42:
        raise AssertionError(f"q42 made {len(captured)} segment-sum calls "
                             f"({[c[3] for c in captured]} segments)")
    k = kernel_phase(segsum, captured[0], args.seed)
    del captured

    kf = kernel_phase_f32(segsum, args.seed)

    t0 = time.time()
    ref = Reference(cat)
    say("reference", seconds=time.time() - t0)

    # the engine's routing decision for each grouped sum: a query whose
    # sums pass the kernel's gates must launch the kernel
    routed = []
    gate = sess.executor._kernel_sum_ok

    def spy_gate(c, ngseg):
        ok = gate(c, ngseg)
        routed.append(ok)
        return ok

    sess.executor._kernel_sum_ok = spy_gate

    def run_query(q, sql, nulls=False):
        """Cold and warm runs of one query; (rows, record)."""
        before = (segsum.LAUNCHES, segsum.LAUNCHES_F32)
        routed.clear()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = sess.sql(sql)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t1) * 1e3
        warm = []
        for _ in range(3):
            t1 = time.perf_counter()
            again = sess.sql(sql)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t1) * 1e3)
        got = engine_rows(out, nulls)
        if engine_rows(again, nulls) != got:
            raise AssertionError(f"{q}: warm run differs from cold run")
        launched = segsum.LAUNCHES - before[0]
        if any(routed) and launched == 0:
            raise AssertionError(f"{q} routes sums to segsum_decimal but "
                                 f"launched it no time")
        return got, dict(
            query=q, cold_ms=cold, warm_median_ms=statistics.median(warm),
            rows=len(got), peak_bytes=torch.cuda.max_memory_allocated(),
            host_syncs=sess.executor.n_syncs,
            memo_hits=sess.executor.n_memo_hits, routes_to_kernel=any(routed),
            kernel_launches=launched,
            f32_kernel_launches=segsum.LAUNCHES_F32 - before[1], card=card)

    # main path 1: the q3 family
    segsum.LAUNCHES = segsum.LAUNCHES_F32 = 0
    for q, sql in QUERIES.items():
        got, rec = run_query(q, sql)
        compare(ref.answer(REFERENCE[q]), got,
                lambda r, spec=REFERENCE[q]: order_key(r, spec))
        say("slice", **rec)
        if q == "q42" and not rec["routes_to_kernel"]:
            raise AssertionError("q42 does not route to segsum_decimal")
    family_launches = segsum.LAUNCHES
    if family_launches == 0:
        raise AssertionError("the slice launched no segsum_decimal")
    del ref

    # main path 2: the segment-sum bench
    from ndstpu_torch.ops import bench
    segsum.LAUNCHES = segsum.LAUNCHES_F32 = 0
    rec = bench.main([])
    bench_launches = (segsum.LAUNCHES, segsum.LAUNCHES_F32)
    say("bench", launches_decimal=bench_launches[0],
        launches_f32=bench_launches[1], card=card)
    if bench_launches[1] == 0 or bench_launches[0] == 0:
        raise AssertionError(f"the bench did not launch both kernels: "
                             f"{bench_launches}")

    # main path 3: the store-channel reports
    t0 = time.time()
    sref = StoreReference(cat)
    want = {q: getattr(sref, q)() for q in STORE_QUERIES}
    say("store reference", seconds=time.time() - t0)
    segsum.LAUNCHES = segsum.LAUNCHES_F32 = 0
    for q, sql in STORE_QUERIES.items():
        got, rec = run_query(q, sql, nulls=True)
        if not rows_match(want[q], got):
            raise AssertionError(f"{q}: {got[:3]} vs reference "
                                 f"{want[q][:3]} ({len(got)} vs "
                                 f"{len(want[q])} rows)")
        say("store slice", **rec)
    # q88 on a store that exists: the cross join over non-zero counts
    name = next(str(n) for n in sref.col("store", "s_store_name")
                if "'" not in n)
    sql = STORE_QUERIES["q88"].replace("'ese'", f"'{name}'")
    want88 = sref.q88(name)
    got, rec = run_query("q88 named", sql, nulls=True)
    if not rows_match(want88, got) or min(want88[0]) == 0:
        raise AssertionError(f"q88 on store {name!r}: {got} vs reference "
                             f"{want88}")
    say("store slice", store_name=name, counts=list(got[0]), **rec)
    store_launches = segsum.LAUNCHES

    # main path 4: the store window and rollup reports.  Their ratios and
    # averages descale decimals to float64, and the reference ranks and
    # ties the true quotients: the engine's must be the same on the card
    descale_check(args.seed)
    t0 = time.time()
    want = {q: getattr(sref, q)() for q in WINDOW_QUERIES}
    say("window reference", seconds=time.time() - t0,
        rows={q: len(w) for q, w in want.items()}, sizes=sref.sizes)
    del sref
    # the path's kernel at the path's own shape: q36's finest-grain sums,
    # each bit-exact against the plain version on its captured inputs
    captured = segsum_calls(segsum, sess, WINDOW_QUERIES["q36"])[0]
    if not captured:
        raise AssertionError("q36 made no segment-sum call")
    for i, (vals, gid, mask, s) in enumerate(captured):
        rec = decimal_shape(segsum, f"q36 main path, sum {i + 1}", vals,
                            gid, mask, s)
        k["shapes"].append(rec)
        k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
    del captured, vals, gid, mask
    segsum.LAUNCHES = segsum.LAUNCHES_F32 = 0
    for q, sql in WINDOW_QUERIES.items():
        got, rec = run_query(q, sql, nulls=True)
        compare(want[q], got, WINDOW_ORDER[q],
                limit=None if q == "q98" else LIMIT)
        say("window slice", **rec)
        if q == "q36" and rec["kernel_launches"] == 0:
            raise AssertionError("q36's rollup launched no segsum_decimal")
    window_launches = segsum.LAUNCHES

    # main path 5: set operations, DISTINCT and distinct aggregates
    t0 = time.time()
    xref = SetopReference(cat)
    want = {q: getattr(xref, q)() for q in SETOP_QUERIES}
    say("setop reference", seconds=time.time() - t0,
        rows={q: len(w) for q, w in want.items()}, sizes=xref.sizes)
    del xref
    # the path's kernel at its own inputs: every segment sum of one run of
    # each query bit-exact, the first of each query timed as a shape
    routed_calls = {}
    for q, sql in SETOP_QUERIES.items():
        captured, n_calls, err = segsum_calls(segsum, sess, sql, keep=1)
        routed_calls[q] = n_calls
        k["max_abs_err"] = max(k["max_abs_err"], err)
        for vals, gid, mask, s in captured:
            k["shapes"].append(decimal_shape(
                segsum, f"{q} main path, sum 1 of {n_calls}", vals, gid,
                mask, s))
        del captured
    say("setop segment sums", calls=routed_calls)
    segsum.LAUNCHES = segsum.LAUNCHES_F32 = 0
    setop_orders = {"q28": None, "q41": lambda r: r[:1],
                    "q76": lambda r: r[:5], "q2": lambda r: r[:1]}
    for q, sql in SETOP_QUERIES.items():
        got, rec = run_query(q, sql, nulls=True)
        if setop_orders[q] is None:
            if not rows_match(want[q], got):
                raise AssertionError(f"{q}: {got} vs reference {want[q]}")
        else:
            compare(want[q], got, setop_orders[q],
                    limit=None if q == "q2" else LIMIT)
        say("setop slice", **rec)
    # q76 without its LIMIT: every group of the union, the web branch's
    # included (the store branch's groups fill the first 100 rows)
    got, rec = run_query("q76 whole", SETOP_QUERIES["q76"].replace(
        "limit 100", ""), nulls=True)
    compare(want["q76"], got, setop_orders["q76"], limit=None)
    say("setop slice", channels=sorted({r[0] for r in got}), **rec)
    setop_launches = segsum.LAUNCHES
    if any(routed_calls.values()) and not setop_launches:
        raise AssertionError("the path routes sums to segsum_decimal but "
                             "launched it no time")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "segsum_decimal", "route": "cuda",
        "source": "ndstpu_torch/ops/csrc/segsum_decimal.cu",
        "replaces": "ndstpu/ops/segsum.py:141",
        "tpu_kernel": "ndstpu/ops/segsum.py::_limb_kernel",
        "launches": family_launches + bench_launches[0] + store_launches +
        window_launches + setop_launches,
        "launches_by_path": {"q3 family": family_launches,
                             "bench": bench_launches[0],
                             "store slice": store_launches,
                             "store window reports": window_launches,
                             "set operations and distinct": setop_launches},
        "max_abs_err": k["max_abs_err"],
        "ms": k["call_ms"], "kernel_ms": k["call_ms"],
        "device_ms": k["device_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": k["library_ms"],
        "shapes": k["shapes"]}, {
        "name": "segsum_f32", "route": "cuda",
        "source": "ndstpu_torch/ops/csrc/segsum_f32.cu",
        "replaces": "ndstpu/ops/segsum.py:59",
        "tpu_kernel": "ndstpu/ops/segsum.py::_f32_kernel",
        "launches": bench_launches[1],
        "launches_by_path": {"bench": bench_launches[1]},
        "max_abs_err": kf["max_abs_err"],
        "max_allowed_share": kf["allowed_share"],
        "ms": kf["call_ms"], "kernel_ms": kf["call_ms"],
        "device_ms": kf["device_ms"],
        "plain_ms": kf["plain_ms"], "bound_ms": kf["bound_ms"],
        "bound_by": "bytes", "library_ms": kf["library_ms"],
        "shapes": kf["shapes"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
