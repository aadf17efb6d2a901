"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale SF] [--seed N] [--check-scale SF]
                          [--corpus-scale SF]

Runs from the root of a checkout, needs one CUDA card, and drives only
``ndstpu_torch`` (it imports nothing of JAX or of the ``ndstpu`` package).
Phases, each printed on its own line; any failure raises and exits
non-zero:

1. environment: Python, torch and CUDA versions, the card's name and
   power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port from ``ndstpu_torch/ops/csrc``,
   one ``nvcc`` per source, all started together;
3. data: the store-channel columns (``datagen.COLUMNS``) generated on
   the card at ``--scale`` (``STORE_SCALE``, SF 100);
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
5. slice: q3, q42, q52 and q55 through ``Session(device="cuda").sql``,
   the compiled path: the cold run discovers the size plan, captures the
   query as a CUDA graph and replays it once; each warm run is a replay,
   and one more replay runs under ``torch.profiler``, which counts its
   ``segsum_decimal`` launches.  Cold and warm times, rows, peak device
   memory, host syncs (the cold run's, and a replay's), discoveries and
   captures — each held against a plain numpy reference written here,
   independent of the engine;
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

10. corpus check: the store channel freed, the whole warehouse (25
    tables, 429 columns) generated on the card at ``CHECK_SCALE`` and
    copied to the host; every part of the power corpus (103
    parts, rngseed 07291122510, stream 0) run twice through ``Session(
    device="cuda")`` (discovery, capture and first replay; then a
    replay) and twice through ``Session(device="cpu")`` (discovery; then
    a replay at the recorded capacities) over the same tables, the four
    results held together (ints, decimals, dates and strings exact,
    floats within 1e-5 relative, in order where the plan ends in a
    sort), with every ``segsum_decimal`` call of the card's discovery
    held bit-exact against the plain version at its own inputs, and every
    call captured into a graph at the inputs its replay gave it, against
    the outputs the replay wrote; the largest of those calls is checked
    and timed as a kernel shape as in phase 4.  Then the stream-1
    rendering of every part on the card: where its canonical key is
    stream 0's it must replay with no discovery, fail a guard and
    rediscover, or (its binding sharing memo results otherwise) discover
    an entry of its own, and it must equal an eager run of its own text.
    One line per part and rendering, and a summary;
11. corpus: the check's warehouse freed, the whole warehouse generated
    at ``CORPUS_SCALE``.  First, on a session of its own, the
    ``segsum_decimal`` calls of the parts that called it in phase 10 held
    bit-exact as there (discovery's and the replayed graph's), the call
    with the most rows checked and timed as a kernel shape as in phase 4;
    then every part run cold (discovery, capture, first replay), three
    times warm (replays) and once more under ``torch.profiler`` (the
    ``segsum_decimal`` launches of one replay, counted from the device
    events): one line per part (cold, capture and replay ms, rows, peak
    device and graph pool bytes, host syncs of the cold run and of a
    replay, discoveries, captures, evictions, memo hits,
    ``segsum_decimal`` launches).  Every replay equals its discovery run
    (floats within 1e-5 relative), and a part that calls the kernel here
    but did not in phase 10 fails the script.  Then, with every graph
    evicted, each part's plan run eagerly three times: one line per part
    (the median, and the runs that ran out of memory and ran again).

Phases 5, 6, 7, 8, 9 and 11 are the main paths: the kernel launch counts
(``segsum.LAUNCHES``, the wrapper's own, and ``segsum.REPLAY_LAUNCHES``,
those of graph replays, counted by ``torch.profiler`` from the card's
kernel events in the replays it profiles) are set to 0 just before each
and read just after, and every kernel each path runs must have launched.
Then one JSON line of kernels, and last the result line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
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
# the corpus phases' scales.  The check's CPU run of all 103 parts took
# 50 s at SF 1 and 321 s at SF 5 on the 8-core host of an H100, and the
# whole script 1,001 s with SF 5.  The check now runs each part twice on
# the CPU (discovery, then a replay at padded capacities) and its
# stream-1 renderings on the card, and the corpus times three eager runs
# of each part beside its replays: with the check at SF 1 (121 s of it)
# the whole script took 997 s on an H100, and the check grows about
# linearly with the scale, so SF 2 or 3 would leave too little of the
# 1,200 s.  At SF 30 on an 80 GB H100, q72 runs out of memory and q17
# peaks at 80.8 GB, so the corpus runs at SF 20
CHECK_SCALE = 1.0
CORPUS_SCALE = 20.0
STORE_SCALE = 100.0
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


T0 = time.time()


def say(phase: str, **fields) -> None:
    """One phase line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.time() - T0}), flush=True)


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
        data = c.data
        if c.dictionary is not None:     # NULL codes may index nothing
            data = np.full(len(c.data), None, dtype=object)
            data[valid] = c.dictionary[c.data[valid]]
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


def decimal_launches(segsum) -> int:
    """``segsum_decimal``'s launches: the wrapper's, and those of the
    graph replays the profiler counted."""
    return segsum.LAUNCHES + segsum.REPLAY_LAUNCHES


def profiled_replay(segsum, sess, sql, cp, name) -> int:
    """One more replay of ``sql``'s graph under ``torch.profiler``; its
    ``segsum_decimal`` launches, counted from the card's kernel events
    (``segsum.counting_replays``), must be the calls the capture
    recorded."""
    with segsum.counting_replays() as seen:
        sess.sql(sql)
    if seen["launches"] != cp.kernel_calls:
        raise AssertionError(
            f"{name}: the profiler saw {seen['launches']} segsum_decimal "
            f"launches in a replay of a graph holding {cp.kernel_calls}")
    return seen["launches"]


def segsum_calls(segsum, sess, sql, keep=None, largest=False) -> tuple:
    """The compiled path's first run of ``sql`` (discovery, capture, first
    replay; with the warm replay off, a second run captures and replays)
    with every ``segment_sum_decimal`` call held bit-exact against the
    plain version: discovery's at the inputs it makes them with, each
    call captured into the graph at the inputs the replay gave it,
    against the sums and counts the replay wrote (the capture keeps
    those tensors, so the graph's pool does not reuse them).  Returns
    (copies of the replayed calls' inputs: the first ``keep``, all of
    them by default, or with ``largest`` the one with the most rows, as
    [(vals, gid, mask, segments), ...]; the number of replayed calls;
    the largest error of every check; the first run's result)."""
    errs, graph = [], []
    wrapper = segsum.segment_sum_decimal

    def spy(vals, gid, mask, s):
        if torch.cuda.is_current_stream_capturing():
            out = wrapper(vals, gid, mask, s)
            graph.append((vals, gid, mask, s) + tuple(out))
            return out
        segsum.segment_sum_decimal = wrapper
        errs.append(check_segsum(segsum, vals, gid, mask, s))
        segsum.segment_sum_decimal = spy
        return wrapper(vals, gid, mask, s)

    segsum.segment_sum_decimal = spy
    try:
        out = sess.sql(sql)
        if errs and not graph:
            sess.sql(sql)
    finally:
        segsum.segment_sum_decimal = wrapper
    captured = []
    for vals, gid, mask, s, sums, counts in graph:
        ps, pc = segsum.segment_sum_decimal_plain(vals, gid, mask, s)
        err = max(int((sums - ps).abs().max()), int((counts - pc).abs().max()))
        if err != 0:
            raise AssertionError(f"segsum_decimal in a replayed graph "
                                 f"disagrees with its plain version at "
                                 f"n={vals.shape[0]} s={s}: {err}")
        errs.append(err)
        if largest:
            if not captured or vals.numel() > captured[0][0].numel():
                captured[:] = [(vals.clone(), gid.clone(), mask.clone(), s)]
        elif keep is None or len(captured) < keep:
            captured.append((vals.clone(), gid.clone(), mask.clone(), s))
    n_graph = len(graph)
    del graph
    return captured, n_graph, max(errs, default=0), out


def forget(sess, sql) -> None:
    """Drop ``sql``'s compiled plan, so that its next run starts cold."""
    sess.executor.forget(sess.canonical_key(sql))


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


def first_difference(want: list, got: list, ordered: bool):
    """None when ``got`` equals ``want`` under ``rows_match`` (in order
    where ``ordered``, else as multisets); else the first differing row
    of each, with its index."""
    if not ordered:
        want, got = (sorted(r, key=_null_first) for r in (want, got))
    if rows_match(want, got):
        return None
    if len(want) != len(got):
        return {"rows": len(got), "reference_rows": len(want)}
    i = next(j for j, (a, b) in enumerate(zip(want, got))
             if not rows_match([a], [b]))
    return {"row": i, "card": repr(got[i]), "cpu": repr(want[i])}


def corpus_check(segsum, scale: float, seed: int, card: str) -> dict:
    """Every part of the power corpus on the card and on the CPU over the
    same generated warehouse (the card's tables copied to the host), each
    run twice on each (the compiled path's discovery, then its replay),
    the four results held together: ints, decimals, dates and strings
    exact, floats within 1e-5 relative, in order where the plan ends in a
    sort.  Every ``segment_sum_decimal`` call of the card's first runs is
    held bit-exact against the plain version (``segsum_calls``).  Then
    each part's stream-1 rendering on the card: sharing stream 0's
    canonical key, it must replay with no discovery unless a guard
    failed; it must equal an eager run of its own text.  Returns the
    largest error, the number of calls and the inputs of the call with
    the most rows, and the parts whose card runs called the kernel."""
    from ndstpu_torch import datagen
    from ndstpu_torch.engine.plan import fixes_order
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.queries import corpus, streamgen
    t0 = time.time()
    cat = datagen.generate(scale, seed, "cuda")
    torch.cuda.synchronize()
    host = datagen.move(cat, "cpu")
    say("corpus check data", scale=scale, seconds=time.time() - t0,
        rows={t: cat.get(t).num_rows for t in cat.tables},
        device_bytes=torch.cuda.memory_allocated())
    on_card, on_cpu = Session(cat, device="cuda"), Session(host, device="cpu")
    exe = on_card.executor
    empty, wrong = [], []
    out = {"max_abs_err": 0, "calls": 0, "largest": None,
           "kernel_parts": set()}
    cpu_s = 0.0
    parts = corpus()
    for name, sql in parts:
        captured, n_calls, err, first = segsum_calls(segsum, on_card, sql,
                                                     largest=True)
        keep_largest(out, captured, n_calls, err)
        if n_calls or err:
            out["kernel_parts"].add(name)
        cold_syncs = exe.n_syncs
        second = on_card.sql(sql)
        replay_syncs, memo = exe.n_syncs, exe.n_memo_hits
        t1 = time.time()
        want = engine_rows(on_cpu.sql(sql), nulls=True)
        cpu_again = on_cpu.sql(sql)
        cpu_s += time.time() - t1
        ordered = fixes_order(on_card.plan(sql)[0])
        diffs = {run: first_difference(want, engine_rows(t, nulls=True),
                                       ordered)
                 for run, t in (("card first", first),
                                ("card second", second),
                                ("cpu second", cpu_again))}
        diffs = {run: d for run, d in diffs.items() if d is not None}
        if first.num_rows == 0:
            empty.append(name)
        if diffs:
            wrong.append(name)
        say("corpus check", part=name, rows=first.num_rows,
            host_syncs=cold_syncs, replay_host_syncs=replay_syncs,
            memo_hits=memo, graph_kernel_calls=n_calls,
            equal=not diffs, **({"differences": diffs} if diffs else {}))
    say("corpus check summary", scale=scale, parts=len(parts),
        non_empty=len(parts) - len(empty), empty=empty,
        differ=wrong, cpu_seconds=cpu_s, seconds=time.time() - t0,
        discoveries=exe.n_discoveries, captures=exe.n_captures,
        segsum_calls=out["calls"], max_abs_err=out["max_abs_err"],
        card=card)
    if wrong:
        raise AssertionError(f"the card differs from the CPU on {wrong}")
    # stream 1: another rendering of every template
    t1 = time.time()
    bad, shared_n, replayed_n = [], 0, 0
    for (name, sql), (_n, sql0) in zip(
            streamgen.render_power_corpus(streamgen.BENCH_RNGSEED, 1),
            parts):
        shared = on_card.canonical_key(sql) == on_card.canonical_key(sql0)
        d0, g0, m0 = (exe.n_discoveries, exe.n_guard_failures,
                      exe.n_memo_sig_misses)
        got = on_card.sql(sql)
        discovered = exe.n_discoveries - d0
        guard_failed = exe.n_guard_failures - g0
        memo_missed = exe.n_memo_sig_misses - m0
        eager = exe.execute_to_host(on_card.plan(sql)[0])
        diff = first_difference(engine_rows(eager, nulls=True),
                                engine_rows(got, nulls=True),
                                fixes_order(on_card.plan(sql)[0]))
        shared_n += shared
        replayed_n += shared and not discovered
        if diff is not None or (shared and discovered and
                                not (guard_failed or memo_missed)):
            bad.append(name)
        say("corpus check stream 1", part=name, rows=got.num_rows,
            shared_key=shared, discoveries=discovered,
            guard_failures=guard_failed, memo_signature_misses=memo_missed,
            equal=diff is None,
            **({} if diff is None else {"difference": diff}))
    say("corpus check stream 1 summary", parts=len(parts),
        shared_keys=shared_n, replayed=replayed_n,
        guard_failures=exe.n_guard_failures,
        memo_signature_misses=exe.n_memo_sig_misses,
        seconds=time.time() - t1, card=card)
    if bad:
        raise AssertionError(f"stream 1 renderings wrong, or discovered "
                             f"under a shared key with neither a guard "
                             f"failure nor another memo signature: {bad}")
    return out


def keep_largest(out: dict, captured: list, n_calls: int, err: int) -> None:
    """Fold one run's ``segsum_calls(..., largest=True)`` into ``out``:
    the largest error, the number of calls and the call with the most
    rows."""
    out["max_abs_err"] = max(out["max_abs_err"], err)
    out["calls"] += n_calls
    for c in captured:
        if out["largest"] is None or c[0].numel() > out["largest"][0].numel():
            out["largest"] = c


def corpus_run(segsum, scale: float, seed: int, card: str,
               kernel_parts) -> tuple:
    """Every part of the power corpus on the card over the whole
    warehouse at ``scale``, through the compiled path.  First, on a
    session of its own, every ``segsum_decimal`` call of the parts in
    ``kernel_parts`` held bit-exact as in ``corpus_check``, and the
    replayed call with the most rows checked and timed as a kernel shape
    as in phase 4.  (Those are the parts that called the kernel at the
    check's smaller scale: a grouped sum goes to the kernel when its key
    domain is small, and domains grow with the scale.  A part that calls
    it here and did not there fails the phase.)  Then, with the launch
    counts zeroed, each part cold (discovery, capture, first replay),
    three times warm (replays, each held against the cold run) and once
    more under ``torch.profiler`` (its ``segsum_decimal`` launches
    counted from the replay's device events).  Last, with every graph
    evicted, each part's plan three times eagerly, the yardstick of the
    replays.  Returns the path's launches (the wrapper's, the profiled
    replays') and that shape's record."""
    from ndstpu_torch import datagen
    from ndstpu_torch.engine import torchexec
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.queries import corpus
    t0 = time.time()
    cat = datagen.generate(scale, seed, "cuda")
    torch.cuda.synchronize()
    say("corpus data", scale=scale, seconds=time.time() - t0,
        rows={t: cat.get(t).num_rows for t in cat.tables},
        device_bytes=torch.cuda.memory_allocated(), card=card)
    parts = corpus()
    t1 = time.time()
    sess = Session(cat, device="cuda")
    calls = {"max_abs_err": 0, "calls": 0, "largest": None}
    for name, sql in parts:
        if name in kernel_parts:
            keep_largest(calls, *segsum_calls(segsum, sess, sql,
                                              largest=True)[:3])
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    say("corpus segment sums", scale=scale, parts=sorted(kernel_parts),
        calls=calls["calls"], max_abs_err=calls["max_abs_err"],
        seconds=time.time() - t1)
    if calls["largest"] is None:
        raise AssertionError("the corpus made no segment-sum call")
    shape = decimal_shape(
        segsum, f"corpus main path at SF {scale:g}, largest of "
        f"{calls['calls']} replayed sums", *calls["largest"])
    shape["max_abs_err"] = max(shape["max_abs_err"], calls["max_abs_err"])
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    sess = Session(cat, device="cuda")
    exe = sess.executor
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
    sums = {"cold_ms": 0.0, "replay_warm_ms": 0.0}
    for name, sql in parts:
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = (decimal_launches(segsum), exe.n_discoveries,
                  exe.n_captures, exe.n_evictions, exe.n_oom_retries)
        t1 = time.perf_counter()
        table = sess.sql(sql)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t1) * 1e3
        cold_syncs = exe.n_syncs
        peak = torch.cuda.max_memory_allocated()
        cp = sess.compiled_plan(sql)
        warm = []
        for _ in range(3):
            t1 = time.perf_counter()
            again = sess.sql(sql)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t1) * 1e3)
            diff = torchexec.results_differ(table, again)
            if diff is not None:
                raise AssertionError(f"{name}: a replay differs from its "
                                     f"discovery run: {diff}")
        replay_syncs, memo = exe.n_syncs, exe.n_memo_hits
        profiled = profiled_replay(segsum, sess, sql, cp, name)
        launched = decimal_launches(segsum) - before[0]
        if launched and name not in kernel_parts:
            raise AssertionError(
                f"{name} launched segsum_decimal at SF {scale:g} but not at "
                f"the check's scale: its calls were not held bit-exact")
        warm_ms = statistics.median(warm)
        sums["cold_ms"] += cold
        sums["replay_warm_ms"] += warm_ms
        say("corpus", part=name, rows=table.num_rows, cold_ms=cold,
            discover_ms=cp.discover_s * 1e3, capture_ms=cp.capture_s * 1e3,
            replay_warm_ms=warm_ms,
            replay_ms=warm, peak_bytes=peak, pool_bytes=cp.pool_bytes,
            discovery_peak_bytes=cp.peak_bytes, allocated_before=allocated,
            held_pool_bytes=exe.pool_bytes(), host_syncs=cold_syncs,
            replay_host_syncs=replay_syncs, memo_hits=memo,
            discoveries=exe.n_discoveries - before[1],
            captures=exe.n_captures - before[2],
            evictions=exe.n_evictions - before[3],
            oom_retries=exe.n_oom_retries - before[4],
            graph_kernel_calls=cp.kernel_calls,
            replay_segsum_launches_profiled=profiled,
            kernel_launches=launched, card=card)
    launches = (segsum.LAUNCHES, segsum.REPLAY_LAUNCHES)
    counts = dict(discoveries=exe.n_discoveries, captures=exe.n_captures,
                  evictions=exe.n_evictions,
                  guard_failures=exe.n_guard_failures,
                  memo_signature_misses=exe.n_memo_sig_misses,
                  oom_retries=exe.n_oom_retries)
    # the yardstick: each plan eagerly, with no graph held
    exe.evict_all()
    sums["eager_warm_ms"] = 0.0
    for name, sql in parts:
        plan = sess.plan(sql)[0]
        retries = exe.n_oom_retries
        runs = []
        for _ in range(3):
            t1 = time.perf_counter()
            exe.execute_to_host(plan)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t1) * 1e3)
        sums["eager_warm_ms"] += statistics.median(runs)
        say("corpus eager", part=name, eager_warm_ms=statistics.median(runs),
            eager_ms=runs, host_syncs=exe.n_syncs,
            held_pool_bytes=exe.pool_bytes(),
            oom_retries=exe.n_oom_retries - retries, card=card)
    say("corpus summary", scale=scale, parts=len(parts),
        seconds=time.time() - t0, kernel_launches=launches[0],
        replay_kernel_launches_profiled=launches[1], **counts,
        graph_budget_bytes=exe.graph_budget, **sums, card=card)
    return launches, shape


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=STORE_SCALE)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--check-scale", type=float, default=CHECK_SCALE)
    ap.add_argument("--corpus-scale", type=float, default=CORPUS_SCALE)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ndstpu_torch import datagen
    from ndstpu_torch.engine import torchexec
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
    cat = datagen.generate(args.scale, args.seed, "cuda",
                           columns=datagen.COLUMNS)
    torch.cuda.synchronize()
    say("data", scale=args.scale, seconds=time.time() - t0,
        rows={t: cat.get(t).num_rows for t in cat.tables},
        device_bytes=torch.cuda.memory_allocated())
    sess = Session(cat, device="cuda")

    # capture the kernel's inputs on the main path (a q42 replay); its
    # compiled plan is dropped after, so that the slice's run is cold
    captured = segsum_calls(segsum, sess, QUERIES["q42"])[0]
    forget(sess, QUERIES["q42"])
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

    exe = sess.executor

    def run_query(q, sql, nulls=False):
        """Cold (discovery, capture, first replay) and warm (replay) runs
        of one query through the compiled path; (rows, record)."""
        before = (decimal_launches(segsum), segsum.LAUNCHES_F32,
                  exe.n_discoveries, exe.n_captures, exe.n_oom_retries)
        routed.clear()
        allocated = torch.cuda.memory_allocated()
        held = exe.pool_bytes()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = sess.sql(sql)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t1) * 1e3
        cold_syncs = exe.n_syncs
        peak = torch.cuda.max_memory_allocated()
        warm = []
        for _ in range(3):
            t1 = time.perf_counter()
            again = sess.sql(sql)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t1) * 1e3)
            diff = torchexec.results_differ(out, again)
            if diff is not None:
                raise AssertionError(f"{q}: a replay differs from its "
                                     f"discovery run: {diff}")
        cp = sess.compiled_plan(sql)
        profiled = profiled_replay(segsum, sess, sql, cp, q)
        got = engine_rows(out, nulls)
        launched = decimal_launches(segsum) - before[0]
        if any(routed) and launched == 0:
            raise AssertionError(f"{q} routes sums to segsum_decimal but "
                                 f"launched it no time")
        return got, dict(
            query=q, cold_ms=cold, warm_median_ms=statistics.median(warm),
            rows=len(got), peak_bytes=peak, pool_bytes=cp.pool_bytes,
            discovery_peak_bytes=cp.peak_bytes, allocated_before=allocated,
            held_pool_bytes_before=held,
            host_syncs=cold_syncs, replay_host_syncs=exe.n_syncs,
            discoveries=exe.n_discoveries - before[2],
            captures=exe.n_captures - before[3],
            oom_retries=exe.n_oom_retries - before[4],
            memo_hits=exe.n_memo_hits, routes_to_kernel=any(routed),
            kernel_launches=launched, graph_kernel_calls=cp.kernel_calls,
            replay_segsum_launches_profiled=profiled,
            f32_kernel_launches=segsum.LAUNCHES_F32 - before[1], card=card)

    # main path 1: the q3 family
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
    for q, sql in QUERIES.items():
        got, rec = run_query(q, sql)
        compare(ref.answer(REFERENCE[q]), got,
                lambda r, spec=REFERENCE[q]: order_key(r, spec))
        say("slice", **rec)
        if q == "q42" and not rec["routes_to_kernel"]:
            raise AssertionError("q42 does not route to segsum_decimal")
    family_launches = (segsum.LAUNCHES, segsum.REPLAY_LAUNCHES)
    if sum(family_launches) == 0:
        raise AssertionError("the slice launched no segsum_decimal")
    del ref

    # main path 2: the segment-sum bench
    from ndstpu_torch.ops import bench
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
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
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
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
    store_launches = (segsum.LAUNCHES, segsum.REPLAY_LAUNCHES)

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
    forget(sess, WINDOW_QUERIES["q36"])
    if not captured:
        raise AssertionError("q36 made no segment-sum call")
    for i, (vals, gid, mask, s) in enumerate(captured):
        rec = decimal_shape(segsum, f"q36 main path, sum {i + 1}", vals,
                            gid, mask, s)
        k["shapes"].append(rec)
        k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
    del captured, vals, gid, mask
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
    for q, sql in WINDOW_QUERIES.items():
        got, rec = run_query(q, sql, nulls=True)
        compare(want[q], got, WINDOW_ORDER[q],
                limit=None if q == "q98" else LIMIT)
        say("window slice", **rec)
        if q == "q36" and rec["kernel_launches"] == 0:
            raise AssertionError("q36's rollup launched no segsum_decimal")
    window_launches = (segsum.LAUNCHES, segsum.REPLAY_LAUNCHES)

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
        captured, n_calls, err, _ = segsum_calls(segsum, sess, sql, keep=1)
        forget(sess, sql)
        routed_calls[q] = n_calls
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["shapes"].extend(decimal_shape(
            segsum, f"{q} main path, sum 1 of {n_calls}", *c)
            for c in captured)
        del captured
    say("setop segment sums", calls=routed_calls)
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
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
    setop_launches = (segsum.LAUNCHES, segsum.REPLAY_LAUNCHES)
    if any(routed_calls.values()) and not sum(setop_launches):
        raise AssertionError("the path routes sums to segsum_decimal but "
                             "launched it no time")

    # the whole warehouse: free the store channel's first
    del cat, sess, exe, gate, spy_gate, run_query, got, want
    gc.collect()
    torch.cuda.empty_cache()
    say("freed", device_bytes=torch.cuda.memory_allocated())

    # the corpus, checked against the port's CPU run at the check scale;
    # the check's call with the most rows checked and timed as a shape
    check = corpus_check(segsum, args.check_scale, args.seed, card)
    kernel_parts = check["kernel_parts"]
    k["max_abs_err"] = max(k["max_abs_err"], check["max_abs_err"])
    if check["largest"] is not None:
        k["shapes"].append(decimal_shape(
            segsum, f"corpus check at SF {args.check_scale:g}, largest of "
            f"{check['calls']} sums", *check["largest"]))
    del check
    gc.collect()
    torch.cuda.empty_cache()

    # main path 6: the whole corpus at the run scale, its kernel checked
    # and timed at the path's own inputs first
    corpus_launches, shape = corpus_run(segsum, args.corpus_scale,
                                        args.seed, card, kernel_parts)
    k["shapes"].append(shape)
    k["max_abs_err"] = max(k["max_abs_err"], shape["max_abs_err"])
    if sum(corpus_launches) == 0:
        raise AssertionError("the corpus launched no segsum_decimal")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "segsum_decimal", "route": "cuda",
        "source": "ndstpu_torch/ops/csrc/segsum_decimal.cu",
        "replaces": "ndstpu/ops/segsum.py:141",
        "tpu_kernel": "ndstpu/ops/segsum.py::_limb_kernel",
        "launches": sum(family_launches) + bench_launches[0] +
        sum(store_launches) + sum(window_launches) + sum(setop_launches) +
        sum(corpus_launches),
        "launches_by_path": {"q3 family": sum(family_launches),
                             "bench": bench_launches[0],
                             "store slice": sum(store_launches),
                             "store window reports": sum(window_launches),
                             "set operations and distinct":
                             sum(setop_launches),
                             "corpus": sum(corpus_launches)},
        "replay_launches_by_path": {
            "q3 family": family_launches[1], "bench": 0,
            "store slice": store_launches[1],
            "store window reports": window_launches[1],
            "set operations and distinct": setop_launches[1],
            "corpus": corpus_launches[1]},
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
