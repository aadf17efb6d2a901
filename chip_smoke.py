"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale SF] [--seed N] [--check-scale SF]
                          [--corpus-scale SF] [--ooc-scale SF]

Runs from the root of a checkout, needs one CUDA card, and drives only
``ndstpu_torch`` (it imports nothing of JAX or of the ``ndstpu`` package).
Phases, each printed on its own line; any failure raises and exits
non-zero:

1. environment: Python, torch and CUDA versions, the card's name and
   power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port from ``ndstpu_torch/ops/csrc``,
   one ``nvcc`` per source, all started together;
3. data: the store-channel columns (``datagen.COLUMNS``) generated on
   the card at ``--scale`` (``STORE_SCALE``, SF 20);
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
   Then (5b) the same four over phase 3's columns converted on
   the card to doubles (``datagen.as_doubles``: every DECIMAL column
   FLOAT64, the ``--floats`` warehouse's values), cold and warm, held
   against the reference summing the prices as float64 (within 1e-5
   relative, tied sums as a set); their sums are float sums, so
   ``segsum_decimal`` must not launch;
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
    replay) and once through ``Session(device="cpu")`` (discovery) over
    the same tables, the three results held together (ints, decimals,
    dates and strings exact,
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
    One line per part and rendering, and a summary.  Then every part
    again through the out-of-core executor (``Session(spmd_chunk_rows=N,
    spmd_threshold=500)``) over the same tables with the seven fact
    tables in host memory: N half the part's largest table of 500 rows
    or more, or, where a fact it streams then fits one chunk, half the
    smallest such fact, so that every streamed fact runs in two chunks or
    more; each answer must equal the CPU's, and none may fall through.
    Then (10b) the ``--floats`` warehouse at ``FLOATS_SCALE``: all
    25 tables generated on the card with every DECIMAL column FLOAT64
    (``datagen.generate(..., use_decimal=False)``) and copied to the
    host, every converted column held bit-exact against the host's
    ``unscaled / 10.0**scale`` of the decimal tables generated alike;
    every part
    twice on the card and once on the CPU, the three held together, in
    order where the plan sorts, except inside a run of rows whose sort
    keys tie within 1e-5 relative, held as a multiset (the ordering rule
    of ``tests/test_torch_floats_common.py``; the parts that needed it
    are printed; q67 under the reference validator's floats carve-out
    where the rule cannot hold it, said on its line); each part's
    stream-1 rendering on the card, replaying stream 0's key unless a
    guard fails or its memo signature differs, against an eager run of
    its own text; the ``segsum_decimal`` launches counted (integer sums
    and DECIMAL casts only);
11. corpus: the check's warehouse freed, the whole warehouse generated
    at ``CORPUS_SCALE``.  First, on a session of its own, the
    ``segsum_decimal`` calls of the parts that called it in phase 10 held
    bit-exact as there (discovery's and the replayed graph's), the call
    with the most rows checked and timed as a kernel shape as in phase 4;
    then every part run cold (discovery, capture, first replay), once
    warm (a replay) and, where its graph recorded ``segsum_decimal``
    calls, once more under ``torch.profiler`` (the launches of one
    replay, counted from the device events, which must be those calls):
    one line per part (cold, capture and replay ms, rows, peak
    device and graph pool bytes, host syncs of the cold run and of a
    replay, discoveries, captures, evictions, memo hits,
    ``segsum_decimal`` launches).  Every replay equals its discovery run
    (floats within 1e-5 relative), and a part that calls the kernel here
    but did not in phase 10 fails the script.  The warm replays of the
    ten parts of ``ATTRIB_PARTS`` (the largest) run with
    ``NDSTPU_ATTRIB=1``, each followed by one replay with it off and
    one with it on under ``torch.profiler`` (host calls too; its kernel
    count stands for the part's profiled replay): one ``attribution``
    line a part (``host_prep_s``, ``device_s``, ``fetch_s``, fetched
    bytes, programs, the device's idle share, both warm times, the host
    syncs traced), which fails the script unless the three times fit
    the wall time, ``device_s`` is at least 0.9 times the profiled
    device time (its device-to-host copies aside), the fetched bytes are
    the read-back buffers' and the profiled replay's trace holds one
    host call that waits for the card (``HOST_SYNC_CALLS``);
12. power: with this process holding no table or graph, streams 0, 1
    and 2 written by ``python -m ndstpu_torch.queries.streamgen`` (stream
    0's parts must be the corpus's renderings) and stream 0, cut to the
    17 parts of ``power_parts()`` (to pay for phases 16, 5b, 10b and
    12b; phase 11 runs all 103 at the same scale), run once by
    ``python -m ndstpu_torch.harness.power``, generating the warehouse at
    ``CORPUS_SCALE`` on the card and keeping the run ledger ``LEDGER``,
    new each script run: cold, saving compile records (no second run
    preloads them, a depth cut below; phase 13 preloads them).
    One line: its time log (``Power Test Time``,
    ``Total Time``, the load and preload rows, each part's ms), every
    part's status (each must be ``Completed``) and rows (each must equal
    phase 11's), the metrics sidecar's discoveries, compiled-plan hits
    and misses, captures and ``segsum_decimal`` launches, its ledger rows
    and sentinel verdicts, the wall seconds.  Then (12b) the same
    parts once more with ``--floats --static_check`` at ``FLOATS_SCALE``:
    the static check must pass (its line printed) and every part be
    ``Completed``;
13. throughput: (a) streams 1 and 2, cut to 17 parts (the seven whose
    spines splice across the streams and ``SERVE_PARTS``; to pay
    for phase 16), as two threads over one
    shared session in this process (``scheduler.run_streams_inproc``,
    what ``python -m ndstpu_torch.harness.throughput --mode inproc
    --concurrent 2`` runs), the warehouse generated once at
    ``CORPUS_SCALE``, phase 12's compile records preloaded and its ledger
    giving the priors.  One line: the throughput elapsed, each stream's
    ``Power Test Time`` and part ms, every part's status (each
    ``Completed``, or ``CompletedWithTaskFailures`` for a failed guard's
    rediscovery notice alone, one for each guard that failed), the
    overlap report (both streams at once), the sidecar's and the
    executor's counters (one plan miss for each distinct text planned,
    the streams' and the preloaded records'), the ledger rows, peak
    bytes, the wall seconds.  Then on this thread,
    every part whose compiled entry recorded ``segsum_decimal`` calls
    replayed once under ``torch.profiler`` (its launches must be those
    calls) and held against an eager run of its plan.  (b) The same
    streams cut to ``PROCESS_PARTS`` through ``python -m
    ndstpu_torch.harness.throughput --concurrent 1``, a power process a
    stream, each generating the warehouse at ``CHECK_SCALE``: it must
    exit 0 with every part ``Completed``, ``segsum_decimal`` launched in
    each process, and one admission slot;
14. serve: (a) ``python -m ndstpu_torch.harness.serve server`` in a
    process of its own, generating the warehouse at ``CORPUS_SCALE`` on
    the card and preloading a copy of phase 12's compile records; streams
    1 and 2 cut to ``SERVE_PARTS`` (the process mode's parts and six whose
    graphs call ``segsum_decimal`` at that scale) through ``python -m
    ndstpu_torch.harness.throughput 1,2 --mode serve``, one connection a
    stream: every query executed, then each rendering asked again must
    answer phase 13's rows for it (ints, decimals, dates and strings
    exact, floats within 1e-5 relative).  One line: the phase's seconds,
    each stream's wall, the server's ``stats`` (discoveries, captures,
    evictions, pins, sheds, retries, failovers), the SLO percentiles, its
    peak device memory and its ``segsum_decimal`` launches.  (b) At
    ``CHECK_SCALE``, the four fates of ``scripts/serve_smoke.py``, each
    server a process: clean, three streams of ``PROCESS_PARTS`` at once;
    ``serve.dispatch`` transient faults the client retries through;
    SIGTERM with a query in flight (it is answered, the server exits 0
    and journals its clean shutdown); SIGKILL with a query in flight and
    a warm restart (the retried query answered, a seen key with no
    discovery).  Then a 2-replica fleet (``python -m
    ndstpu_torch.harness.serve fleet``) with the replica a client uses
    SIGKILLed under it: the client fails over and the supervisor restarts
    the replica.  Every answer of (b) equals phase 10's compiled run of
    the same rendering, each held against an eager run there;
15. maintenance: (a) at ``CHECK_SCALE`` the whole warehouse and refresh
    set 1 generated on the card and copied to the host; q3, q5 and q80
    run on the card (captured); the 11 data-maintenance functions
    (``ndstpu_torch.harness.maintenance``'s helpers, each under a
    ``BenchReport``) on the card and on the CPU; each of the seven fact
    tables must then hold the same rows on both (exactly, as
    multisets), LF_CR, LF_SR and LF_WR must have failed on both (as in
    the JAX package) and the rest completed, and q3, q5 and q80 must
    rediscover on the card (their tables changed) and equal the CPU's
    results, each profiled replay's ``segsum_decimal`` launches its
    graph's calls; then on a session of its own every call of the three,
    discovery's and the replayed graph's, held bit-exact against the
    plain version.  (b) At ``CORPUS_SCALE``, ``python -m
    ndstpu_torch.harness.maintenance - - <log> --generate SF --update 1``
    in a process of its own: its time log must have the 11 function rows
    and ``Data Maintenance Time``, its summaries the same three
    ``Failed``; one line with each function's ms and status, the rows
    each changed and the peak device memory.  Then
    ``maintenance_counts`` at ``CHECK_SCALE`` (once SF 20) in
    another process: before each DELETE a
    ``count(*)`` of its WHERE, before each INSERT one of its SELECT, each
    equal to the rows the statement removed or added, and at the end the
    device bytes held beyond the live tables (under 1 GiB: no replaced
    table outlives its last user);
16. out-of-core: the warehouse generated on the card at ``ooc_scale()``
    (SF 100 where half the host's memory holds its facts, else the
    largest multiple of 10 that fits, at least SF 30: past the SF 20 the
    whole warehouse fits the card at), the seven fact tables copied into
    host memory chunk by chunk, the dimensions on the card; the process
    capped at 80e9 device bytes.  Each of ``OOC_QUERIES`` (q17 and q72,
    which do not run resident at SF 30, and a part or query for each path
    of the distributed executor: broadcast and shuffle joins,
    union-aggregate, subquery offload, a row spine's device tail, a
    window, grouping sets) through ``Session(spmd_chunk_rows="auto")``
    and again at half the chunk rows ``"auto"`` chose for its largest
    streamed fact, with ``NDSTPU_SPMD_STRICT=1``: none may fall through,
    the two answers must be equal (floats within 1e-5 relative), and the
    parts together must take every path.  One line a run: ms, chunks, the
    streams (table, rows, chunk rows, launches), depth, prefetch hits and
    misses, ``engine.h2d.bytes``, ``wait_s`` and ``overlap_s``, peak
    device bytes, the host bytes of the facts and the process's resident
    bytes.

Phases 5, 6, 7, 8, 9, 11, 12, 13, 14, 15 (a) and 16 are the main paths: the
kernel launch counts (``segsum.LAUNCHES``, the wrapper's own, and
``segsum.REPLAY_LAUNCHES``, those of graph replays, counted by
``torch.profiler`` from the card's kernel events in the replays it
profiles) are set to 0 just before each and read just after, and every
kernel each path runs must have launched.  The runs of phases 12, 13 (b)
and 14 are processes of their own: their launches are the wrapper's,
which each run's metrics sidecar carries
(``kernel.segsum_decimal.launches``), as does each query server's
``stats`` answer (a graph's replays launch the kernel inside the graph;
the wrapper counts the calls it makes itself, discovery's).
Then one JSON line of kernels, and last the result line ``{"ok": true,
"device": {...}}``.

Depth, cut to keep the script inside its time limit (the throughput phase
took 314-345 s on an H100; the whole script 1,181 s with the first two
cuts, 1,120 s with the first five): the corpus phase no longer runs each
plan eagerly after its replays (a median of 3 at first, then one run:
about 160 s in all; ``python -m ndstpu_torch.profile --corpus --eager``
times eager runs); the corpus check runs at SF 0.5, not 1 (27 s); the
corpus phase replays each part once warm, not three times (about 73 s),
and profiles only the replays of the parts whose graphs call the kernel;
the check runs each part once on the CPU, not twice (about 28 s: the tests
run the CPU replay of every part); phases 5-9 replay each query once
warm, not three times; and, to pay for the maintenance phase (about 100 s
on an H100), the power phase runs stream 0 once, cold, not a second time
preloading the first run's records (about 100 s; phase 13 preloads
them); and, to pay for the out-of-core phase and the check's chunked
runs (about 180-210 s on an H100), the throughput phase's streams run
17 of their parts, the seven whose spines splice and the serve phase's
(about 180 s); the power phase runs 28 parts of stream 0, every eighth
and those the throughput and serve phases preload (about 90 s; then 17,
those the two phases preload: about 15 s more); the
maintenance statements' counts run at ``CHECK_SCALE``, not SF 20
(about 25 s); and the out-of-core phase does not rerun at half the
chunk rows a part whose "auto" run streamed no chunk (its window spine
runs resident: the same run again, about 1.4 s); and, to pay for the
floats phases and the attribution (about 140 s on an H100), the
attribution rides on the corpus phase's own warm replays, and its
profiled replay stands for the one that counts the part's kernel
launches, the power phase runs the 17 parts above, and the floats
phases run at ``FLOATS_SCALE``, SF 0.2 (the check's SF 0.5 would take
about 30 s more).  The widths, the
scales of the corpus, power, throughput and maintenance phases and the
streams are whole.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

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
# peaks at 80.8 GB, so the corpus runs at SF 20.  The two power runs at
# SF 20 take about 250 s, which the store-channel paths pay for: they took
# 385 s at SF 100 and 232 s at SF 50, and with them at SF 50 the whole
# script took 1,170 s on an H100, so they run at SF 20 (q41's reference
# needs SF 10 or more: at SF 1 no item qualifies).  The throughput phase
# took 314 s on an H100; the depth cuts in the docstring pay for it, the
# check at SF 0.5 (where it has run before) among them
CHECK_SCALE = 0.5
CORPUS_SCALE = 20.0
# the floats phases' scale: smaller than the check's, to pay for
# them within the script's time
FLOATS_SCALE = 0.2
STORE_SCALE = 20.0
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

    def answer(self, spec, doubles: bool = False) -> list:
        """The query's rows: exact scaled int64 sums, or with
        ``doubles`` float64 sums of the prices as doubles (the
        ``--floats`` warehouse's values)."""
        prices = self.ss_price / 100.0 if doubles else self.ss_price
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
                        prices[rows].tolist()):
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


def graph_calls(cp) -> int:
    """The ``segsum_decimal`` calls the graphs of one replay of ``cp``
    hold: its segments' and its own."""
    return sum(g.kernel_calls for g in cp.programs)


def graph_pool_bytes(cp) -> int:
    """The pool bytes of the graphs one replay of ``cp`` runs."""
    return sum(g.pool_bytes for g in cp.programs)


def profiled_replay(segsum, sess, sql, cp, name, label=None) -> dict:
    """One more replay of ``sql``'s graphs (its segments' and its own)
    under ``torch.profiler``; its ``segsum_decimal`` launches, counted from
    the card's kernel events (``segsum.counting_replays``), must be the
    calls the captures recorded.  With ``label`` the host's calls are
    recorded too, and the query runs in a ``record_function(label)``
    range.  Returns ``{"launches", "events"}`` (the profiler's).  A
    count short of the captures' is taken once more, on a ``profiler
    recount`` line, and taken out of ``REPLAY_LAUNCHES``: after many
    profiler sessions a replay's count has come up short of kernels the
    graph launched (q80's 4 of 6, after the attribution's sessions, in two
    of six full runs on an H100; never alone).  The second count must be
    the captures'."""
    for attempt in (1, 2):
        with segsum.counting_replays(host=label is not None) as seen:
            with record_function(label) if label else \
                    contextlib.nullcontext():
                sess.sql(sql)
        if attempt == 2 or seen["launches"] >= graph_calls(cp):
            break
        say("profiler recount", part=name, launches=seen["launches"],
            graph_kernel_calls=graph_calls(cp))
        segsum.REPLAY_LAUNCHES -= seen["launches"]
    if seen["launches"] != graph_calls(cp):
        raise AssertionError(
            f"{name}: the profiler saw {seen['launches']} segsum_decimal "
            f"launches in a replay of graphs holding {graph_calls(cp)}")
    return seen


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
    sess.forget(sql)


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
    same generated warehouse (the card's tables copied to the host), run
    twice on the card (the compiled path's discovery, then its replay)
    and once on the CPU, the three results held together: ints, decimals,
    dates and strings exact, floats within 1e-5 relative, in order where
    the plan ends in a sort.  Every ``segment_sum_decimal`` call of the
    card's first runs is held bit-exact against the plain version
    (``segsum_calls``).  Then each part's stream-1 rendering on the card:
    sharing stream 0's canonical key, it must replay with no discovery
    unless a guard failed; it must equal an eager run of its own text.
    Then the parts of streams 1 and 2 that splice a shared spine, spliced
    on the card against the CPU (``spine_check``).  Last, the serve
    phase's references: streams 0, 1 and 2 of ``PROCESS_PARTS``, each
    held against an eager run.  Returns the largest error, the number of
    calls and the inputs of the call with the most rows, the parts whose
    card runs called the kernel, and those references."""
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
    wants = {}
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
        cpu_s += time.time() - t1
        ordered = fixes_order(on_card.plan(sql)[0])
        wants[name] = (want, ordered)
        diffs = {run: first_difference(want, engine_rows(t, nulls=True),
                                       ordered)
                 for run, t in (("card first", first),
                                ("card second", second))}
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
    # every part again through the out-of-core executor, its facts in
    # host memory
    chunked_check(cat, host, wants, card)
    del wants
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
    spine_check(on_card, on_cpu, card)
    # the serve phase's references at this scale: streams 0, 1 and 2 of
    # the process mode's parts, each held against an eager run
    t1 = time.time()
    out["serve_refs"] = {}
    for sid in ("0", "1", "2"):
        texts = dict(streamgen.render_power_corpus(streamgen.BENCH_RNGSEED,
                                                   int(sid)))
        out["serve_refs"].update(serve_references(
            on_card, {n: texts[n] for n in PROCESS_PARTS}, eager=True))
    say("corpus check serve references", parts=len(out["serve_refs"]),
        seconds=time.time() - t1, card=card)
    return out


# -- the decimals-as-doubles warehouse (--floats) ----------------------------

def sorted_with_keys(host_cat, plan):
    """The rows of ``plan`` run eagerly over ``host_cat`` on the CPU
    without its LIMIT, and for each row the values of the plan's top sort
    keys, read from the sorted table as the sort returns it (a row keeps
    its position through the projections above the sort)."""
    import dataclasses
    from ndstpu_torch.engine import plan as lp
    from ndstpu_torch.engine.torchexec import JEval, TorchExecutor
    chain, node = [], plan
    while isinstance(node, (lp.Limit, lp.Project, lp.SubqueryAlias)):
        chain.append(node)
        node = node.child
    sort, top = node, node
    for above in reversed(chain):
        if not isinstance(above, lp.Limit):
            top = dataclasses.replace(above, child=top)
    exe = TorchExecutor(host_cat, torch.device("cpu"))
    keys = []
    run_sort = exe._exec_sort

    def hooked(p):
        dt = run_sort(p)
        if p is sort:
            evl = JEval(dt)
            cols = [evl.eval(exe._resolve_subqueries(k[0])) for k in p.keys]
            alive = dt.alive.nonzero().flatten()
            keys.extend(zip(*[
                [v if ok else None for v, ok in zip(
                    c.data[alive].tolist(), c.valid[alive].tolist())]
                for c in cols]))
        return dt

    exe._exec_sort = hooked
    rows = engine_rows(exe.execute_to_host(top), nulls=True)
    if len(rows) != len(keys):
        raise AssertionError(f"{len(rows)} rows, {len(keys)} sort keys")
    return rows, keys


def tie_runs(keys) -> list:
    """(start, end) of each run of rows whose sort keys equal its first
    row's within 1e-5 relative (NULL equal to NULL only)."""
    runs, i = [], 0
    while i < len(keys):
        j = i + 1
        while j < len(keys) and rows_match([keys[i]], [keys[j]]):
            j += 1
        runs.append((i, j))
        i = j
    return runs


def held_under_ties(whole, runs, got) -> bool:
    """``got`` against ``whole`` (the rows with no LIMIT) under the
    ordering rule: each run within ``len(got)`` rows a multiset of the
    same rows (within tolerance), a run cut by it a choice of distinct
    rows of the whole run."""
    if len(got) > len(whole):
        return False
    for i, j in runs:
        if i >= len(got):
            break
        pool = list(whole[i:j])
        for row in got[i:min(j, len(got))]:
            k = next((n for n, w in enumerate(pool)
                      if rows_match([w], [row])), None)
            if k is None:
                return False
            pool.pop(k)
    return True


def tie_rule(host_cat, plan, results) -> bool:
    """The ordering rule of ``tests/test_torch_floats_common.py``: each of
    ``results`` (row lists of an ordered part) held in order, except
    inside a run of rows whose sort keys are equal within 1e-5 relative,
    held as a multiset; the runs from the CPU's eager rows without the
    LIMIT.  True when every result holds."""
    whole, keys = sorted_with_keys(host_cat, plan)
    runs = tie_runs(keys)
    return all(held_under_ties(whole, runs, r) for r in results)


# the validator's carve-out under floats (ndstpu/harness/validate.py:14):
# q67 ranks float sums, and a last-bit difference between two tied sums
# moves a rank, so its rows are not held where the rule cannot hold them
FLOATS_CARVE_OUT = ("query67",)


def floats_check(segsum, scale: float, seed: int, card: str) -> int:
    """The ``--floats`` warehouse: all 25 tables generated on the card
    at ``scale`` with every DECIMAL column as FLOAT64
    (``datagen.generate(..., use_decimal=False)``) and copied to the
    host; every converted column held bit-exact against the host's
    ``unscaled / 10.0**scale`` of the decimal warehouse generated on the
    card from the same seed at the same scale.  Every corpus part run
    twice on the card (discovery, capture and first replay; then a
    replay) and once on the CPU over the same tables, the three held
    together: ints, dates and strings exact, floats within 1e-5
    relative, in order where the plan ends in a sort, and where that
    fails under the ordering rule (:func:`tie_rule`; q67 under the
    validator's carve-out where the rule cannot hold it).  Then each
    part's stream-1 rendering on the card: sharing stream 0's canonical
    key, it must replay unless a guard failed or its memo signature
    differs, and equal an eager run of its own text (under the same
    rule).  Returns the ``segsum_decimal`` launches (the wrapper's:
    discovery's; a replay launches inside its graph)."""
    from ndstpu_torch import datagen
    from ndstpu_torch.engine.plan import fixes_order
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.queries import corpus, streamgen
    t0 = time.time()
    dec_host = datagen.move(datagen.generate(scale, seed, "cuda"), "cpu")
    cat = datagen.generate(scale, seed, "cuda", use_decimal=False)
    torch.cuda.synchronize()
    host = datagen.move(cat, "cpu")
    gen_s = time.time() - t0
    n_cols = n_values = 0
    wrong_cols = []
    for tname, table in dec_host.tables.items():
        for cname, col in table.columns.items():
            if col.ctype.kind != "decimal":
                continue
            got = host.get(tname).column(cname)
            u = col.data.numpy()
            want = u.astype(np.float64) / 10.0 ** col.ctype.scale
            same_valid = (got.valid is None and col.valid is None) or (
                got.valid is not None and col.valid is not None and
                torch.equal(got.valid, col.valid))
            if got.ctype.kind != "float64" or not same_valid or \
                    not np.array_equal(want.view(np.int64),
                                       got.data.numpy().view(np.int64)):
                wrong_cols.append(f"{tname}.{cname}")
            n_cols += 1
            n_values += len(u)
    del dec_host
    say("floats data", scale=scale, seconds=gen_s, tables=len(cat.tables),
        converted_columns=n_cols, converted_values=n_values,
        bit_exact=not wrong_cols, device_bytes=torch.cuda.memory_allocated(),
        card=card)
    if wrong_cols or n_cols == 0:
        raise AssertionError(f"conversions not bit-exact: {wrong_cols}")
    on_card, on_cpu = Session(cat, device="cuda"), Session(host, device="cpu")
    exe = on_card.executor
    launched0 = segsum.LAUNCHES
    wrong, tied, carved, kernel_parts = [], [], [], {}
    graph_kernel_calls = 0
    t1 = time.time()
    parts = corpus()
    for name, sql in parts:
        l0 = segsum.LAUNCHES
        first = on_card.sql(sql)
        second = on_card.sql(sql)
        cp = on_card.compiled_plan(sql)
        want = engine_rows(on_cpu.sql(sql), nulls=True)
        plan = on_card.plan(sql)[0]
        ordered = fixes_order(plan)
        got = [engine_rows(t, nulls=True) for t in (first, second)]
        diffs = [first_difference(want, g, ordered) for g in got]
        rule = None
        if any(d is not None for d in diffs) and ordered:
            rule = tie_rule(host, plan, [want] + got)
            if rule:
                tied.append(name)
            elif name in FLOATS_CARVE_OUT:
                carved.append(name)
        equal = all(d is None for d in diffs) or bool(rule)
        if not equal and name not in carved:
            wrong.append(name)
        calls = graph_calls(cp) if cp is not None else 0
        graph_kernel_calls += calls
        if segsum.LAUNCHES - l0 or calls:
            kernel_parts[name] = (segsum.LAUNCHES - l0, calls)
        say("floats check", part=name, rows=first.num_rows,
            replay_host_syncs=exe.n_syncs, equal=equal,
            **({"ordering_rule": True} if rule else {}),
            **({"carve_out": "q67 skipped under floats, as the reference "
                "validator skips it"} if name in carved else {}),
            **({} if equal else {"differences": diffs}),
            kernel_launches=segsum.LAUNCHES - l0, graph_kernel_calls=calls)
    bad, shared_n, replayed_n = [], 0, 0
    for (name, sql), (_n, sql0) in zip(
            streamgen.render_power_corpus(streamgen.BENCH_RNGSEED, 1),
            parts):
        shared = on_card.canonical_key(sql) == on_card.canonical_key(sql0)
        d0, g0, m0 = (exe.n_discoveries, exe.n_guard_failures,
                      exe.n_memo_sig_misses)
        got = on_card.sql(sql)
        discovered = exe.n_discoveries - d0
        excused = exe.n_guard_failures - g0 or exe.n_memo_sig_misses - m0
        plan = on_card.plan(sql)[0]
        eager = engine_rows(exe.execute_to_host(plan), nulls=True)
        rows = engine_rows(got, nulls=True)
        ordered = fixes_order(plan)
        diff = first_difference(eager, rows, ordered)
        if diff is not None and ordered and \
                tie_rule(host, plan, [eager, rows]):
            diff = None
            tied.append(f"{name} stream 1")
        shared_n += shared
        replayed_n += shared and not discovered
        if (diff is not None and name not in FLOATS_CARVE_OUT) or (
                shared and discovered and not excused):
            bad.append(name)
    launched = segsum.LAUNCHES - launched0
    say("floats check summary", scale=scale, parts=len(parts),
        differ=wrong, ordering_rule=tied, carve_out=carved,
        stream1_shared_keys=shared_n, stream1_replayed=replayed_n,
        stream1_wrong=bad, kernel_launches=launched,
        graph_kernel_calls=graph_kernel_calls, kernel_parts=kernel_parts,
        discoveries=exe.n_discoveries, captures=exe.n_captures,
        seconds=time.time() - t1, card=card)
    if wrong or bad:
        raise AssertionError(f"floats: the card differs from the CPU on "
                             f"{wrong}; stream 1 wrong on {bad}")
    return launched


def floats_store(segsum, cat, ref, card: str) -> int:
    """The store channel as doubles: phase 3's columns at ``STORE_SCALE``
    converted on the card (``datagen.as_doubles``, every DECIMAL column
    to FLOAT64), q3, q42, q52 and q55 through ``Session(device="cuda")``,
    cold and warm, held against phase 5's numpy reference summing the
    prices as float64 (within 1e-5 relative, tied sums as a set).
    Returns the ``segsum_decimal`` launches (the wrapper's, and a profiled
    replay's)."""
    from ndstpu_torch import datagen
    from ndstpu_torch.engine.columnar import Table
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.io.catalog import Catalog
    t0 = time.time()
    doubles = Catalog()
    for name, table in cat.tables.items():
        doubles.register(name, Table({
            c: datagen.as_doubles(col, f"{name}.{c}")
            for c, col in table.columns.items()}))
    torch.cuda.synchronize()
    say("floats store data", seconds=time.time() - t0,
        device_bytes=torch.cuda.memory_allocated(), card=card)
    sess = Session(doubles, device="cuda")
    exe = sess.executor
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = 0
    for q, sql in QUERIES.items():
        spec = REFERENCE[q]
        t1 = time.perf_counter()
        out = sess.sql(sql)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        again = sess.sql(sql)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t1) * 1e3
        cp = sess.compiled_plan(sql)
        profiled = profiled_replay(segsum, sess, sql, cp, q)["launches"]
        want = ref.answer(spec, doubles=True)
        for got in (engine_rows(out), engine_rows(again)):
            compare(want, got, lambda r, spec=spec: order_key(r, spec))
        say("floats store", query=q, cold_ms=cold, warm_ms=warm,
            rows=out.num_rows, sum_type=str(list(
                out.columns.values())[-1].ctype),
            replay_host_syncs=exe.n_syncs, graph_kernel_calls=graph_calls(cp),
            replay_segsum_launches_profiled=profiled, card=card)
    return decimal_launches(segsum)


def floats_power(scale: float, seed: int, card: str) -> int:
    """``python -m ndstpu_torch.harness.power`` on the power phase's
    parts of stream 0 (``power_parts()``) with ``--generate SF --floats
    --static_check``, in a process of its own: the static check must pass
    (its line printed), and every part be ``Completed``.  Returns the
    run's ``segsum_decimal`` launches (the sidecar's)."""
    out = POWER_DIR / "floats"
    out.mkdir(parents=True)
    parts = power_parts()
    cmd = [sys.executable, "-m", "ndstpu_torch.harness.power",
           str(POWER_DIR / "query_0.sql"), "-", str(out / "time.csv"),
           "--generate", f"{scale:g}", "--generate_seed", str(seed),
           "--floats", "--static_check", "--json_summary_folder",
           str(out / "summaries"), "--ledger", "none",
           "--sub_queries", ",".join(parts)]
    t0 = time.time()
    with open(out / "power.log", "w") as log:
        proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                              timeout=600)
    text = (out / "power.log").read_text()
    if proc.returncode != 0:
        raise AssertionError(f"floats power run exited {proc.returncode}:"
                             f"\n{text[-4000:]}")
    passed = [ln for ln in text.splitlines()
              if ln.startswith("static check passed")]
    ms = _time_log(out / "time.csv")
    status = {n: st for n, (st, _f) in _statuses(out / "summaries").items()}
    side = json.loads((out / "time.csv.metrics.json").read_text())
    launches = side["counters"].get("kernel.segsum_decimal.launches", 0)
    engine_conf = {json.loads(p.read_text())["env"]["engineConf"].get(
        "floats") for p in (out / "summaries").glob("*.json")}
    say("floats power", scale=scale, parts=len(status),
        power_test_ms=ms["Power Test Time"], status=status,
        static_check=passed, engine_conf_floats=sorted(engine_conf),
        segsum_launches=launches, wall_s=time.time() - t0, card=card)
    if len(passed) != 1 or set(status) != set(parts) or \
            set(status.values()) != {"Completed"} or engine_conf != {"true"}:
        raise AssertionError(f"floats power run: static check {passed}, "
                             f"statuses {status}")
    return launches


# the ten parts with the largest warm replays at CORPUS_SCALE on an H100,
# the largest first
ATTRIB_PARTS = ("query72", "query14_part2", "query17", "query23_part2",
                "query78", "query39_part2", "query39_part1",
                "query14_part1", "query4", "query59")
# the profiler's range around an attributed replay, and the host calls
# that wait for the card
ATTRIB_RANGE = "attributed replay"
HOST_SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


def host_syncs(events, label: str) -> int:
    """The calls of ``HOST_SYNC_CALLS`` the profiler recorded on the host
    inside the one ``record_function(label)`` range of ``events``."""
    ranges = [e.time_range for e in events
              if e.name == label and e.device_type == DeviceType.CPU]
    if len(ranges) != 1:
        raise AssertionError(f"the profiler recorded {len(ranges)} "
                             f"{label!r} ranges on the host")
    r = ranges[0]
    return sum(1 for e in events if e.name in HOST_SYNC_CALLS and
               r.start <= e.time_range.start and e.time_range.end <= r.end)


def attribution_line(segsum, sess, cp, name: str, sql: str,
                     wall_on: float, a, card: str) -> tuple:
    """One part's replay attribution (``NDSTPU_ATTRIB=1`` around the
    corpus phase's warm replay of it, ``a`` its ``last_attribution``,
    ``wall_on`` its wall seconds), beside one more replay with
    attribution off, timed alike, and one with it on under
    ``torch.profiler`` (``profiled_replay``, whose kernel count stands
    for the corpus phase's).  Holds when ``host_prep_s + device_s +
    fetch_s`` is within the wall time, ``device_s`` is at least 0.9 times
    the profiled replay's device time (its events but the device-to-host
    copies, which ``fetch_s`` times), ``fetched_bytes`` is the read-back
    buffers' bytes, and the profiled replay made one host call that waits
    for the card (``HOST_SYNC_CALLS`` in its range of the trace).
    Returns (held, the profiled replay's ``segsum_decimal`` launches)."""
    exe = sess.executor
    t1 = time.perf_counter()
    sess.sql(sql)
    torch.cuda.synchronize()
    wall_off = time.perf_counter() - t1
    fetched = sum(h.numel() * h.element_size() for h in cp.host_out)
    exe.attrib_enabled = True
    try:
        seen = profiled_replay(segsum, sess, sql, cp, name,
                               label=ATTRIB_RANGE)
    finally:
        exe.attrib_enabled = False
    events = seen["events"]
    kernel_s = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == DeviceType.CUDA and
                   "DtoH" not in e.name and e.name != ATTRIB_RANGE) / 1e6
    syncs = host_syncs(events, ATTRIB_RANGE)
    held = a is not None and \
        a["host_prep_s"] + a["device_s"] + a["fetch_s"] <= wall_on and \
        a["device_s"] >= 0.9 * kernel_s and \
        a["fetched_bytes"] == fetched and syncs == 1
    say("attribution", part=name, wall_s=wall_on, **(a or {}),
        profiled_device_s=kernel_s, read_back_bytes=fetched,
        host_syncs_traced=syncs, device_idle_share=(
            1 - a["device_s"] / wall_on if a else None),
        warm_ms_attrib_on=wall_on * 1e3, warm_ms_attrib_off=wall_off * 1e3,
        held=held, card=card)
    return held, seen["launches"]


def spine_check(on_card, on_cpu, card: str) -> None:
    """Streams 1 and 2 with the spine cache the throughput phase installs
    (``scheduler._install_spine_cache``): every part of either stream
    with a spine flagged across the two runs on the card, its spines
    spliced (the first stream to reach one materializes it), and must
    equal the port's CPU run of its text."""
    from ndstpu_torch.engine import plan as lp
    from ndstpu_torch.engine.plan import fixes_order
    from ndstpu_torch.harness import scheduler
    from ndstpu_torch.queries import streamgen
    t0 = time.time()
    streams = {sid: dict(streamgen.render_power_corpus(
        streamgen.BENCH_RNGSEED, int(sid))) for sid in ("1", "2")}
    scheduler._install_spine_cache(on_card, streams)
    cache = on_card.spine_cache
    if cache is None:
        raise AssertionError("no spine recurs across streams 1 and 2")
    bad, parts = [], 0
    for sid, texts in streams.items():
        for name, sql in texts.items():
            if not on_card.spine_candidate_keys(sql) & cache.flagged:
                continue
            parts += 1
            got = on_card.sql(sql)
            spliced = any(isinstance(n, lp.InlineTable)
                          for g in on_card.compiled_plan(sql).programs
                          for n in g.plan.walk())
            diff = first_difference(
                engine_rows(on_cpu.sql(sql), nulls=True),
                engine_rows(got, nulls=True),
                fixes_order(on_card.plan(sql)[0]))
            say("corpus check spines", stream=sid, part=name,
                rows=got.num_rows, spliced=spliced, equal=diff is None,
                **({} if diff is None else {"difference": diff}))
            if diff is not None or not spliced:
                bad.append(f"{sid}:{name}")
    say("corpus check spines summary", parts=parts,
        flagged=len(cache.flagged), hits=cache.hits, misses=cache.misses,
        bytes=cache.total_bytes, evictions=cache.evictions,
        seconds=time.time() - t0, card=card)
    on_card.install_spine_cache(None)
    if bad or not cache.hits:
        raise AssertionError(f"spliced parts differ from the CPU's, or did "
                             f"not splice: {bad}; {cache.hits} hits")


def keep_largest(out: dict, captured: list, n_calls: int, err: int) -> None:
    """Fold one run's ``segsum_calls(..., largest=True)`` into ``out``:
    the largest error, the number of calls and the call with the most
    rows."""
    out["max_abs_err"] = max(out["max_abs_err"], err)
    out["calls"] += n_calls
    for c in captured:
        if out["largest"] is None or c[0].numel() > out["largest"][0].numel():
            out["largest"] = c


# the corpus phase at SF 20 when each part ran as one graph, before the
# executor cut segments (this script's run on an NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's sums
ONE_GRAPH_CORPUS = {"cold_ms": 155319.02411900018,
               "replay_warm_ms": 36813.31084299996, "graphs": 103,
               "captures": 102, "evictions": 92}


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
    once warm (a replay, held against the cold run) and, where its graph
    recorded ``segsum_decimal`` calls, once more under ``torch.profiler``
    (its launches counted from the replay's device events).  Each part's
    line gives its graphs (the parent and its segments), the segments it
    shares with earlier parts and their pools' bytes; the summary gives
    their sums beside those of one graph a part.  Returns the path's
    launches (the wrapper's, the profiled replays'), that shape's record,
    each part's rows and the parts whose graphs call the kernel."""
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
    sums = {"cold_ms": 0.0, "replay_warm_ms": 0.0, "graphs": 0,
            "shared_segments": 0, "pool_bytes": 0}
    rows, unattributed = {}, []
    segments = set()
    called = set()
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
        # the ATTRIB_PARTS' warm replays run with attribution on (it adds
        # no host sync)
        attrib = name in ATTRIB_PARTS
        exe.attrib_enabled = attrib
        exe.last_attribution = None
        if attrib:
            os.environ["NDSTPU_ATTRIB"] = "1"
        t1 = time.perf_counter()
        again = sess.sql(sql)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t1) * 1e3
        replay_syncs, memo = exe.n_syncs, exe.n_memo_hits
        if attrib:
            del os.environ["NDSTPU_ATTRIB"]
            exe.attrib_enabled = False
            held, profiled = attribution_line(
                segsum, sess, cp, name, sql, warm_ms / 1e3,
                exe.last_attribution, card)
            if not held:
                unattributed.append(name)
        else:
            # a graph that recorded no segsum_decimal call launches none
            profiled = profiled_replay(
                segsum, sess, sql, cp, name)["launches"] \
                if graph_calls(cp) else 0
        diff = torchexec.results_differ(table, again)
        if diff is not None:
            raise AssertionError(f"{name}: a replay differs from its "
                                 f"discovery run: {diff}")
        launched = decimal_launches(segsum) - before[0]
        if (launched or graph_calls(cp)) and name not in kernel_parts:
            raise AssertionError(
                f"{name} launched segsum_decimal at SF {scale:g} but not at "
                f"the check's scale: its calls were not held bit-exact")
        rows[name] = table.num_rows
        if graph_calls(cp):
            called.add(name)
        shared = sum(1 for g in cp.segs if g.slot in segments)
        segments.update(g.slot for g in cp.segs)
        sums["cold_ms"] += cold
        sums["replay_warm_ms"] += warm_ms
        sums["graphs"] += len(cp.programs)
        sums["shared_segments"] += shared
        sums["pool_bytes"] += graph_pool_bytes(cp)
        say("corpus", part=name, rows=table.num_rows, cold_ms=cold,
            discover_ms=cp.discover_s * 1e3, capture_ms=sum(
                g.capture_s for g in cp.programs) * 1e3,
            replay_warm_ms=warm_ms, graphs=len(cp.programs),
            segments=len(cp.segs), shared_segments=shared,
            peak_bytes=peak, pool_bytes=graph_pool_bytes(cp),
            discovery_peak_bytes=cp.peak_bytes, allocated_before=allocated,
            held_pool_bytes=exe.pool_bytes(), host_syncs=cold_syncs,
            replay_host_syncs=replay_syncs, memo_hits=memo,
            discoveries=exe.n_discoveries - before[1],
            captures=exe.n_captures - before[2],
            evictions=exe.n_evictions - before[3],
            oom_retries=exe.n_oom_retries - before[4],
            graph_kernel_calls=graph_calls(cp),
            replay_segsum_launches_profiled=profiled,
            kernel_launches=launched, card=card)
    launches = (segsum.LAUNCHES, segsum.REPLAY_LAUNCHES)
    counts = dict(discoveries=exe.n_discoveries,
                  segment_discoveries=exe.n_seg_discoveries,
                  captures=exe.n_captures, evictions=exe.n_evictions,
                  guard_failures=exe.n_guard_failures,
                  memo_signature_misses=exe.n_memo_sig_misses,
                  oom_retries=exe.n_oom_retries)
    say("corpus summary", scale=scale, parts=len(parts),
        seconds=time.time() - t0, kernel_launches=launches[0],
        replay_kernel_launches_profiled=launches[1], **counts,
        graph_budget_bytes=exe.graph_budget, **sums,
        distinct_segments=len(segments), one_graph_a_part=ONE_GRAPH_CORPUS,
        card=card)
    if unattributed:
        raise AssertionError(f"attribution does not hold on {unattributed}")
    return launches, shape, rows, called


POWER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_power"
# the run ledger of the power and throughput phases, made anew each run
LEDGER = POWER_DIR / "ledger.jsonl"


def _plain_sql(text: str) -> str:
    """A part's SQL without its comment lines and final semicolon."""
    lines = [ln for ln in text.splitlines()
             if not ln.lstrip().startswith("--")]
    return "\n".join(lines).strip().rstrip(";").strip()


def _time_log(path: Path) -> dict:
    """A time log's rows, {query: milliseconds}."""
    import csv
    with open(path) as f:
        return {r["query"]: int(r["time/milliseconds"])
                for r in csv.DictReader(f)}


def _statuses(folder: Path) -> dict:
    """Each summary's query: (last status, task failures)."""
    out = {}
    for p in folder.glob("*.json"):
        s = json.loads(p.read_text())
        out[s["query"]] = (s["queryStatus"][-1], s["taskFailures"])
    return out


def power_runs(scale: float, seed: int, card: str, corpus_rows: dict
               ) -> int:
    """The power run, through its command line: streams 0, 1 and 2
    rendered by ``python -m ndstpu_torch.queries.streamgen`` (stream 0's
    parts must be the corpus's renderings; the throughput phase runs 1
    and 2), then ``python -m ndstpu_torch.harness.power`` on stream 0
    once, generating the warehouse at ``scale`` on the card: cold,
    writing compile records, with the run ledger ``LEDGER``, new in this
    script run (the run appends cold rows; the throughput phase preloads
    the records and takes the rows as priors).  One ``power`` line:
    its time log's rows, every part's status (each must be ``Completed``)
    and rows (each must equal the corpus phase's at the same scale), the
    sidecar's counters, ledger rows and sentinel verdicts, the wall
    seconds.  Returns the run's ``segsum_decimal`` launches (the
    sidecar's counter: the wrapper's own, in discovery)."""
    import shutil
    from ndstpu_torch.harness.power import gen_sql_from_stream
    from ndstpu_torch.queries import corpus
    shutil.rmtree(POWER_DIR, ignore_errors=True)
    POWER_DIR.mkdir(parents=True)
    subprocess.run([sys.executable, "-m", "ndstpu_torch.queries.streamgen",
                    "--output_dir", str(POWER_DIR), "--rngseed",
                    "07291122510", "--streams", "3"], check=True,
                   stdout=subprocess.DEVNULL, timeout=120)
    stream = POWER_DIR / "query_0.sql"
    whole = gen_sql_from_stream(str(stream))
    want = {n: _plain_sql(s) for n, s in corpus()}
    if {n: _plain_sql(s) for n, s in whole.items()} != want:
        raise AssertionError("stream 0's parts are not the corpus's "
                             "renderings")
    parts = power_parts()
    records = POWER_DIR / "compile_records.pkl"
    launches = 0
    for run in (1,):
        out = POWER_DIR / f"run{run}"
        cmd = [sys.executable, "-m", "ndstpu_torch.harness.power",
               str(stream), "-", str(out / "time.csv"), "--generate",
               f"{scale:g}", "--generate_seed", str(seed),
               "--json_summary_folder", str(out / "summaries"),
               "--compile_records", str(records), "--ledger", str(LEDGER),
               "--sub_queries", ",".join(parts)]
        out.mkdir()
        t0 = time.time()
        with open(out / "power.log", "w") as log:
            proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                  timeout=900)
        wall = time.time() - t0
        if proc.returncode != 0:
            tail = (out / "power.log").read_text()[-4000:]
            raise AssertionError(f"power run {run} exited "
                                 f"{proc.returncode}:\n{tail}")
        ms = _time_log(out / "time.csv")
        status = {n: st for n, (st, _f) in
                  _statuses(out / "summaries").items()}
        side = json.loads((out / "time.csv.metrics.json").read_text())
        counters = side["counters"]
        rows = {q["query"]: q["attrs"].get("result_rows")
                for q in side["queries"]}
        run_launches = counters.get("kernel.segsum_decimal.launches", 0)
        launches += run_launches
        say("power", run=run, card=card, scale=scale, parts=len(status),
            power_test_ms=ms["Power Test Time"], total_ms=ms["Total Time"],
            load_ms=ms["CreateTempView all tables"],
            preload_ms=ms["Preload compile records"],
            part_ms={n: ms[n] for n in parts if n in ms},
            status=status,
            preloaded=counters.get("harness.compile_records.preloaded", 0),
            discoveries=counters.get("engine.discoveries", 0),
            compiled_hit=counters.get("engine.cache.compiled.hit", 0),
            compiled_miss=counters.get("engine.cache.compiled.miss", 0),
            captures=counters.get("engine.jit_builds", 0),
            segsum_launches=run_launches, result_rows=rows,
            cold_parts=side["totals"]["cold_queries"],
            ledger=side["ledger"], sentinel=side["sentinel"]["counts"],
            parent_reserved_bytes=torch.cuda.memory_reserved(),
            wall_s=wall)
        if set(status) != set(parts) or \
                set(status.values()) != {"Completed"}:
            raise AssertionError(f"power run {run}: statuses {status}")
        differ = sorted(n for n in parts if rows.get(n) != corpus_rows[n])
        if differ:
            raise AssertionError(f"power run {run}: rows differ from the "
                                 f"corpus phase's on {differ}")
    return launches


def power_parts() -> list:
    """The parts of stream 0 the power phase runs (to pay for the
    out-of-core, floats and attribution phases): those the throughput and
    serve phases run, whose compile records they preload.  The corpus
    phase runs all 103 at the same scale."""
    return sorted(set(THROUGHPUT_SPINE_PARTS) | set(SERVE_PARTS))


# a replay whose guards fail rediscovers, and the executor says so with a
# warning, which a report records as a task failure (the JAX engine's too)
REDISCOVERY = "compiled plan invalidated"


# the parts of streams 1 and 2 whose flagged spines splice at SF 20 (the
# corpus check's spines lines): the throughput phase keeps them
THROUGHPUT_SPINE_PARTS = ("query2", "query5", "query9", "query14_part1",
                          "query15", "query21", "query76")


def throughput_run(segsum, scale: float, seed: int, card: str) -> tuple:
    """The first throughput test, at full size but over 17 of the 103
    parts (those whose spines splice across the streams and the serve
    phase's, ``--sub_queries``; to pay for the out-of-core
    phase): streams 1 and 2 as two
    threads over one shared session in this process
    (``scheduler.run_streams_inproc``, what ``python -m
    ndstpu_torch.harness.throughput --mode inproc --concurrent 2`` runs),
    the warehouse generated once at ``scale`` on the card, the power
    phase's first compile records preloaded and its ledger giving the
    priors.  One ``throughput`` line: the throughput elapsed (the latest
    ``Power End Time`` less the earliest ``Power Start Time``), each
    stream's ``Power Test Time`` and part ms, every part's status (each
    must be ``Completed``, or ``CompletedWithTaskFailures`` for its
    rediscovery notice alone, as many as the guards that failed), the
    overlap report (both streams must have run at once), the sidecar's
    and the executor's counters (one plan miss for each text the session
    planned, every text of the streams among them: no text planned
    twice), the spine cache's hits, misses, bytes and evictions (at least
    one hit, and no analysis failure that skipped splicing), the ledger
    rows, peak bytes and the wall seconds.  Then, on
    the run's session and on this thread (the streams' captured theirs),
    every part whose compiled entry recorded ``segsum_decimal`` calls:
    one replay under ``torch.profiler``, whose launches must be those
    calls, held against an eager run of its plan (ints, decimals, dates
    and strings exact, floats within 1e-5 relative, in order where the
    plan ends in a sort).  Then the serve phase's references: each
    rendering of ``SERVE_PARTS`` in both streams through the run's
    session.  Returns the path's launches (the wrapper's in the run, the
    profiled replays') and those references."""
    from ndstpu_torch import obs
    from ndstpu_torch.engine.plan import fixes_order
    from ndstpu_torch.engine.sql import normalize_sql_key
    from ndstpu_torch.harness import scheduler
    from ndstpu_torch.harness.power import gen_sql_from_stream
    out = POWER_DIR / "throughput"
    out.mkdir()
    streams = ("1", "2")
    whole = {sid: gen_sql_from_stream(str(POWER_DIR / f"query_{sid}.sql"))
             for sid in streams}
    keep = sorted(set(THROUGHPUT_SPINE_PARTS) | set(SERVE_PARTS))
    texts = {sid: {n: t for n, t in qd.items() if n in keep}
             for sid, qd in whole.items()}
    cmd = ["python", "-m", "ndstpu_torch.harness.power",
           str(POWER_DIR / "query_{}.sql"), "-", str(out / "time_{}.csv"),
           "--generate", f"{scale:g}", "--generate_seed", str(seed),
           "--json_summary_folder", str(out / "summaries_{}"),
           "--compile_records", str(POWER_DIR / "compile_records.pkl"),
           "--ledger", str(LEDGER), "--sub_queries", ",".join(keep)]
    obs.reset()
    torch.cuda.reset_peak_memory_stats()
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
    t0 = time.time()
    run = scheduler.run_streams_inproc(
        list(streams), cmd, concurrent=2,
        overlap_report=str(out / "overlap.json"))
    wall = time.time() - t0
    wrapper = segsum.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    exe = run.session.executor
    logs = {sid: _time_log(out / f"time_{sid}.csv") for sid in streams}
    status = {sid: _statuses(out / f"summaries_{sid}") for sid in streams}
    side = json.loads((out / "overlap.json.metrics.json").read_text())
    counters = side["counters"]
    elapsed = max(lg["Power End Time"] for lg in logs.values()) - \
        min(lg["Power Start Time"] for lg in logs.values())
    distinct = {normalize_sql_key(sql) for qd in texts.values()
                for sql in qd.values()}
    # the texts planned: the streams', and the preloaded records' (stream
    # 0's renderings)
    planned = set(run.session._plan_cache)
    noticed = sum(st == "CompletedWithTaskFailures" for s in status.values()
                  for st, _f in s.values())
    cache = run.session.spine_cache
    spines = {} if cache is None else dict(
        flagged=len(cache.flagged), hits=cache.hits, misses=cache.misses,
        held=len(cache), bytes=cache.total_bytes,
        bytes_served=counters.get("engine.spine.bytes", 0),
        evictions=cache.evictions, budget_bytes=cache.budget_bytes,
        errors=counters.get("engine.spine.errors", 0))
    say("throughput", card=card, scale=scale, mode="inproc", streams=2,
        throughput_elapsed_s=elapsed,
        power_test_ms={sid: lg["Power Test Time"] for sid, lg in logs.items()},
        load_ms=logs["1"]["CreateTempView all tables (shared)"],
        part_ms={sid: {n: logs[sid][n] for n in texts[sid] if n in logs[sid]}
                 for sid in streams},
        status={sid: {n: st for n, (st, _f) in s.items()}
                for sid, s in status.items()},
        rediscovery_notices=noticed,
        overlap={k: run.overlap[k] for k in (
            "max_concurrent", "stream_max_concurrent",
            "total_pairwise_overlap_s", "device_timeline")},
        errors=run.errors,
        preloaded=counters.get("harness.compile_records.preloaded", 0),
        discoveries=counters.get("engine.discoveries", 0),
        compiled_hit=counters.get("engine.cache.compiled.hit", 0),
        compiled_miss=counters.get("engine.cache.compiled.miss", 0),
        captures=counters.get("engine.jit_builds", 0),
        plan_miss=counters.get("engine.cache.plan.miss", 0),
        plan_hit=counters.get("engine.cache.plan.hit", 0),
        distinct_texts=len(distinct), planned_texts=len(planned),
        segment_discoveries=exe.n_seg_discoveries,
        guard_failures=exe.n_guard_failures, rediscoveries=exe.n_guard_failures,
        evictions=exe.n_evictions, spines=spines,
        memo_signature_misses=exe.n_memo_sig_misses,
        oom_retries=exe.n_oom_retries, graph_budget_bytes=exe.graph_budget,
        held_pool_bytes=exe.pool_bytes(), segsum_launches=wrapper,
        ledger=side["ledger"], sentinel=side["sentinel"]["counts"],
        compile_s=side["totals"]["compile_s"],
        cold_parts=side["totals"]["cold_queries"], peak_bytes=peak,
        wall_s=wall)
    if run.rc or run.errors:
        raise AssertionError(f"throughput: stream errors {run.errors}")
    if not spines or spines["hits"] == 0 or spines["errors"]:
        raise AssertionError(f"throughput: no spine served, or an analysis "
                             f"failure skipped splicing: {spines}")
    for sid in streams:
        if set(status[sid]) != set(texts[sid]):
            raise AssertionError(f"throughput stream {sid}: summaries for "
                                 f"{sorted(status[sid])}")
        bad = {n: (st, f) for n, (st, f) in status[sid].items()
               if not (st == "Completed" or (
                   st == "CompletedWithTaskFailures" and f and
                   all(REDISCOVERY in m for m in f)))}
        if bad:
            raise AssertionError(f"throughput stream {sid}: {bad}")
    if noticed != exe.n_guard_failures:
        raise AssertionError(f"throughput: {noticed} rediscovery notices "
                             f"for {exe.n_guard_failures} guard failures")
    if run.overlap["stream_max_concurrent"] != 2:
        raise AssertionError("throughput: the two streams never ran at once")
    if counters.get("engine.cache.plan.miss", 0) != len(planned) or \
            not distinct <= planned:
        raise AssertionError(
            f"throughput: {counters.get('engine.cache.plan.miss')} plan "
            f"misses for {len(planned)} texts planned, of which "
            f"{len(distinct & planned)} of the streams' {len(distinct)}")

    # the kernel's parts, replayed on this thread
    t1 = time.time()
    sess, checked, wrong, refs = run.session, {}, [], {}
    for sid in streams:
        for name, sql in texts[sid].items():
            cp = sess.compiled_plan(sql)
            if cp is None or not graph_calls(cp):
                continue
            # a replay (or the capture of an evicted graph, or the
            # rediscovery of the other stream's binding), so that the
            # profiled run replays
            sess.sql(sql)
            cp = sess.compiled_plan(sql)
            with segsum.counting_replays() as seen:
                got = sess.sql(sql)
            if seen["launches"] != graph_calls(cp):
                raise AssertionError(
                    f"throughput {sid}:{name}: the profiler saw "
                    f"{seen['launches']} segsum_decimal launches in a replay "
                    f"of graphs holding {graph_calls(cp)}")
            plan = sess.plan(sql)[0]
            diff = first_difference(
                engine_rows(exe.execute_to_host(plan), nulls=True),
                engine_rows(got, nulls=True), fixes_order(plan))
            checked[f"{sid}:{name}"] = seen["launches"]
            if diff is not None:
                wrong.append({"part": f"{sid}:{name}", **diff})
            if name in SERVE_PARTS:
                refs[_plain_sql(sql)] = serve_reference(sess, sql, got)
    say("throughput kernel parts", parts=checked, differ=wrong,
        replay_launches_profiled=segsum.REPLAY_LAUNCHES,
        seconds=time.time() - t1, card=card)
    if not checked:
        raise AssertionError("throughput: no compiled entry holds a "
                             "segsum_decimal call")
    if wrong:
        raise AssertionError(f"throughput: replays differ from eager runs: "
                             f"{wrong}")
    # the serve phase's references: the rest of its parts of both streams
    t1 = time.time()
    refs.update(serve_references(
        sess, {f"{sid}:{n}": whole[sid][n] for sid in streams
               for n in SERVE_PARTS
               if _plain_sql(whole[sid][n]) not in refs}, eager=False))
    say("throughput serve references", parts=len(refs),
        seconds=time.time() - t1, card=card)
    return wrapper, segsum.REPLAY_LAUNCHES, refs


# the process mode's parts: two that call segsum_decimal at the check
# scale (q5, q80) beside four that do not need to
PROCESS_PARTS = ("query3", "query5", "query14_part1", "query42", "query80",
                 "query98")


def throughput_processes(scale: float, seed: int, card: str) -> int:
    """The throughput test in the spec's shape: ``python -m
    ndstpu_torch.harness.throughput 1,2 --concurrent 1`` as a subprocess,
    one power process a stream, each generating the warehouse at
    ``scale`` on the card and running ``PROCESS_PARTS``; the file lock
    lets one stream at a time run a query.  It must exit 0 with both time
    logs, every part ``Completed``, ``segsum_decimal`` launched in each
    stream's process (its sidecar's counter) and an overlap report of one
    admission slot and two streams that exited 0.  One ``throughput
    processes`` line, with the graph budget each process set.  Returns
    the launches."""
    out = POWER_DIR / "throughput_process"
    out.mkdir()
    cmd = [sys.executable, "-m", "ndstpu_torch.harness.throughput", "1,2",
           "--concurrent", "1", "--overlap_report", str(out / "overlap.json"),
           "--", sys.executable, "-m", "ndstpu_torch.harness.power",
           str(POWER_DIR / "query_{}.sql"), "-", str(out / "time_{}.csv"),
           "--generate", f"{scale:g}", "--generate_seed", str(seed),
           "--json_summary_folder", str(out / "summaries_{}"),
           "--sub_queries", ",".join(PROCESS_PARTS), "--ledger", "none"]
    t0 = time.time()
    with open(out / "throughput.log", "w") as log:
        proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                              timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        tail = (out / "throughput.log").read_text()[-4000:]
        raise AssertionError(f"throughput processes exited "
                             f"{proc.returncode}:\n{tail}")
    streams = ("1", "2")
    logs = {sid: _time_log(out / f"time_{sid}.csv") for sid in streams}
    status = {sid: {n: st for n, (st, _f) in
                    _statuses(out / f"summaries_{sid}").items()}
              for sid in streams}
    sides = {sid: json.loads((out / f"time_{sid}.csv.metrics.json")
                             .read_text()) for sid in streams}
    launches = {sid: sides[sid]["counters"].get(
        "kernel.segsum_decimal.launches", 0) for sid in streams}
    overlap = json.loads((out / "overlap.json").read_text())
    say("throughput processes", card=card, scale=scale, mode="process",
        streams=2, parts=list(PROCESS_PARTS),
        throughput_elapsed_s=max(lg["Power End Time"] for lg in logs.values())
        - min(lg["Power Start Time"] for lg in logs.values()),
        power_test_ms={sid: lg["Power Test Time"] for sid, lg in logs.items()},
        part_ms={sid: {n: logs[sid][n] for n in PROCESS_PARTS}
                 for sid in streams},
        status=status, segsum_launches=launches,
        graph_budget_bytes={sid: sides[sid]["gauges"].get(
            "engine.graph_budget_bytes") for sid in streams},
        admission_slots=overlap["admission_slots"],
        returncodes={r["stream"]: r["returncode"]
                     for r in overlap["streams"]},
        stream_max_concurrent=overlap["stream_max_concurrent"], wall_s=wall)
    for sid in streams:
        if status[sid] != {n: "Completed" for n in PROCESS_PARTS}:
            raise AssertionError(f"throughput process {sid}: {status[sid]}")
        if not launches[sid]:
            raise AssertionError(f"throughput process {sid} launched no "
                                 f"segsum_decimal")
    if overlap["admission_slots"] != 1 or \
            sorted(r["returncode"] for r in overlap["streams"]) != [0, 0]:
        raise AssertionError(f"throughput processes: overlap {overlap}")
    return sum(launches.values())


# ---------------------------------------------------------------------------


# the serve phase's parts: every part of the process mode's, and six whose
# graphs call segsum_decimal at the corpus scale (grouped decimal sums over
# key domains that do not grow with the scale: channels, reasons, states,
# categories, warehouses and ship modes)
SERVE_PARTS = PROCESS_PARTS + ("query28", "query36", "query62", "query70",
                               "query77", "query86")
SERVE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_serve"
# an answer's rows, every one (a request returns at most this many)
SERVE_MAX_ROWS = 1_000_000


def wire_rows(table) -> list:
    """A result's rows as the query server's answer carries them: JSON
    with ``default=str`` (decimals as floats, dates as strings)."""
    return json.loads(json.dumps([list(r) for r in table.to_rows()],
                                 default=str))


def serve_reference(sess, sql: str, table) -> dict:
    """What an answer to ``sql`` must hold: ``table``'s rows as the wire
    carries them, which of its columns are floats (held within 1e-5
    relative; the rest exact), and whether its plan fixes their order."""
    from ndstpu_torch.engine.plan import fixes_order
    return {"rows": wire_rows(table),
            "floats": [c.ctype.kind == "float64"
                       for c in table.columns.values()],
            "ordered": fixes_order(sess.plan(sql)[0])}


def serve_references(sess, texts: dict, eager: bool) -> dict:
    """{plain text: reference} of each of ``texts`` ({name: sql}) through
    ``sess.sql`` (the compiled path), each held against an eager run of
    its plan first where ``eager``."""
    from ndstpu_torch.engine.plan import fixes_order
    out = {}
    for name, sql in texts.items():
        got = sess.sql(sql)
        if eager:
            plan = sess.plan(sql)[0]
            diff = first_difference(
                engine_rows(sess.executor.execute_to_host(plan), nulls=True),
                engine_rows(got, nulls=True), fixes_order(plan))
            if diff is not None:
                raise AssertionError(f"serve reference {name}: the compiled "
                                     f"run differs from an eager run: {diff}")
        out[_plain_sql(sql)] = serve_reference(sess, sql, got)
    return out


def _wire_key(row) -> tuple:
    return tuple((v is None, "" if v is None else type(v).__name__, v)
                 for v in row)


def answer_difference(ref: dict, resp: dict):
    """None when the server's answer ``resp`` holds ``ref``'s rows (ints,
    decimals, dates and strings exact, float columns within 1e-5
    relative; in order where the plan fixes it, else as multisets);
    else what differs."""
    if resp.get("status") != "ok":
        return {"status": resp.get("status"), "error": resp.get("error")}
    want, got = ref["rows"], resp["data"]
    if resp["rows"] != len(want) or len(got) != len(want) or \
            resp.get("truncated"):
        return {"rows": resp["rows"], "reference_rows": len(want)}
    if not ref["ordered"]:
        want, got = sorted(want, key=_wire_key), sorted(got, key=_wire_key)
    for i, (a, b) in enumerate(zip(want, got)):
        ok = len(a) == len(b) == len(ref["floats"])
        for x, y, is_float in zip(a, b, ref["floats"]):
            if is_float and x is not None and y is not None:
                ok = ok and abs(x - y) <= 1e-5 * max(abs(x), abs(y)) + 1e-12
            else:
                ok = ok and type(x) is type(y) and x == y
        if not ok:
            return {"row": i, "served": repr(b), "reference": repr(a)}
    return None


def _serve_cmd(sock: str, scale: float, seed: int, state: Path, *extra):
    return [sys.executable, "-m", "ndstpu_torch.harness.serve", "server",
            "--socket", sock, "--input_prefix", "-", "--generate",
            f"{scale:g}", "--generate_seed", str(seed), "--state_dir",
            str(state), "--ledger", "none", *extra]


def _fleet_cmd(run_dir: Path, scale: float, seed: int):
    return [sys.executable, "-m", "ndstpu_torch.harness.serve", "fleet",
            "--replicas", "2", "--run_dir", str(run_dir), "--input_prefix",
            "-", "--generate", f"{scale:g}", "--generate_seed", str(seed),
            "--probe_interval_s", "0.5", "--restart_backoff_s", "0.25"]


class ServerProcs:
    """The query server processes the serve phase starts, each logging to
    a file of its own; ``stop_all`` kills whichever still runs (a failed
    check must not leave a server holding the card)."""

    def __init__(self):
        self.procs = []

    def start(self, cmd, log: Path, faults=None) -> subprocess.Popen:
        env = dict(os.environ)
        env.pop("NDSTPU_FAULTS", None)
        if faults:
            env["NDSTPU_FAULTS"] = faults
        with open(log, "a") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    env=env)
        self.procs.append(proc)
        return proc

    def stop_all(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


def _client(sock: str, **kw):
    from ndstpu_torch.serve.client import ServeClient
    kw.setdefault("connect_timeout_s", 60.0)
    return ServeClient(sock, **kw)


def _ready(sock: str, timeout_s: float, proc=None) -> None:
    cli = _client(sock, retries=0)
    try:
        t0 = time.time()
        while time.time() - t0 < timeout_s:
            if proc is not None and proc.poll() is not None:
                raise AssertionError(f"the server on {sock} exited "
                                     f"{proc.returncode} before it was ready")
            if cli.wait_ready(5.0):
                return
        raise AssertionError(f"the server on {sock} was not ready within "
                             f"{timeout_s:g} s")
    finally:
        cli.close()


def _stats(sock: str) -> dict:
    cli = _client(sock, retries=2)
    try:
        return cli.stats()
    finally:
        cli.close()


def _stop(proc, timeout_s: float = 120.0) -> int:
    """SIGTERM (the graceful drain) and the exit code."""
    import signal
    proc.send_signal(signal.SIGTERM)
    return proc.wait(timeout=timeout_s)


def _journal(path: Path) -> list:
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line).get("event"))
        except ValueError:
            pass        # a torn tail from a SIGKILL
    return out


def _launches(stats: dict) -> int:
    return int(stats["counters"].get("kernel.segsum_decimal.launches", 0))


def _served_stats(stats: dict) -> dict:
    """The serve line's view of a server's ``stats`` answer."""
    c = stats["counters"]
    return dict(
        engine=stats["engine"],
        pins=c.get("engine.snapshot.pinned", 0),
        requests=c.get("serve.requests", 0), ok=c.get("serve.ok", 0),
        errors=c.get("serve.errors", 0),
        sheds=c.get("serve.overloaded", 0) + c.get("serve.rejected", 0),
        discoveries_counter=c.get("engine.discoveries", 0),
        captures_counter=c.get("engine.jit_builds", 0),
        compiled_hit=c.get("engine.cache.compiled.hit", 0),
        compiled_miss=c.get("engine.cache.compiled.miss", 0),
        preloaded=c.get("serve.restart.preloaded_records", 0),
        segsum_launches=_launches(stats),
        slo={t: {k: v[k] for k in ("count", "ok", "p50_ms", "p95_ms",
                                    "p99_ms")}
             for t, v in stats["slo"]["tenants"].items()})


def _serve_texts(streams, parts) -> dict:
    """{stream: {part: sql}} of the power phase's stream files."""
    from ndstpu_torch.harness.power import gen_sql_from_stream
    out = {}
    for sid in streams:
        qd = gen_sql_from_stream(str(POWER_DIR / f"query_{sid}.sql"))
        out[sid] = {n: qd[n] for n in parts}
    return out


def _ask_all(sock: str, texts: dict, refs: dict, tenant: str) -> list:
    """Each text of ``texts`` ({stream: {part: sql}}) asked once more and
    held against its reference; the parts that differ."""
    cli = _client(sock, tenant=tenant, retries=8)
    wrong = []
    try:
        for sid, qd in texts.items():
            for name, sql in qd.items():
                ref = refs.get(_plain_sql(sql))
                if ref is None:
                    raise AssertionError(f"serve: no reference for "
                                         f"{sid}:{name}")
                diff = answer_difference(
                    ref, cli.sql(sql, max_rows=SERVE_MAX_ROWS))
                if diff is not None:
                    wrong.append({"part": f"{sid}:{name}", **diff})
    finally:
        cli.close()
    return wrong


def serve_run(scale: float, seed: int, card: str, refs: dict,
              kernel_parts: set) -> int:
    """The query server at full size: ``python -m ndstpu_torch.harness.serve
    server`` in a process of its own, generating the warehouse at
    ``scale`` on the card and preloading the power phase's compile records
    (a copy: the server saves its own as it goes), then streams 1 and 2
    cut to ``SERVE_PARTS`` through ``python -m
    ndstpu_torch.harness.throughput 1,2 --mode serve``, one connection a
    stream.  It must exit 0 with every query executed; then each
    rendering asked once more must answer the throughput phase's rows for
    it (``refs``).  One ``serve`` line: the phase's seconds, the
    server's start, each stream's wall, the server's ``stats`` (its
    executor's discoveries, captures, evictions, its pins, sheds, the
    clients' retries and failovers, the SLO percentiles, peak device
    memory, its ``segsum_decimal`` launches).  Returns those launches."""
    import shutil
    t0 = time.time()
    out = SERVE_DIR / "full"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    kernel_served = sorted(set(SERVE_PARTS) & kernel_parts)
    if len(kernel_served) < 6:
        raise AssertionError(f"serve: only {kernel_served} of SERVE_PARTS "
                             f"call segsum_decimal at SF {scale:g}")
    records = out / "compile_records.pkl"
    shutil.copy(POWER_DIR / "compile_records.pkl", records)
    sock = f"unix:{out / 'serve.sock'}"
    procs = ServerProcs()
    try:
        proc = procs.start(_serve_cmd(sock, scale, seed, out / "state",
                                      "--compile_records", str(records)),
                           out / "server.log")
        _ready(sock, 600.0, proc)
        boot_s = time.time() - t0
        cmd = [sys.executable, "-m", "ndstpu_torch.harness.throughput",
               "1,2", "--mode", "serve", "--serve_socket", sock,
               "--overlap_report", str(out / "overlap.json"), "--",
               sys.executable, "-m", "ndstpu_torch.harness.power",
               str(POWER_DIR / "query_{}.sql"), "-",
               str(out / "time_{}.csv"), "--generate", f"{scale:g}",
               "--sub_queries", ",".join(SERVE_PARTS)]
        t1 = time.time()
        with open(out / "throughput.log", "w") as log:
            run = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 timeout=900)
        streams_s = time.time() - t1
        if run.returncode != 0:
            tail = (out / "throughput.log").read_text()[-4000:]
            raise AssertionError(f"serve: throughput --mode serve exited "
                                 f"{run.returncode}:\n{tail}")
        overlap = json.loads((out / "overlap.json").read_text())
        wrong = _ask_all(sock, _serve_texts(("1", "2"), SERVE_PARTS), refs,
                         "check")
        stats = _stats(sock)
        rc = _stop(proc)
    finally:
        procs.stop_all()
    records_ = {r["stream"]: r for r in overlap["streams"]}
    say("serve", card=card, scale=scale, streams=2, parts=list(SERVE_PARTS),
        kernel_parts=kernel_served, seconds=time.time() - t0,
        server_start_s=boot_s, streams_s=streams_s,
        stream_wall_s={s: r["wall_s"] for s, r in records_.items()},
        executed={s: r["executed"] for s, r in records_.items()},
        failures={s: r["failures"] for s, r in records_.items()},
        client_retries=sum(r["client_retries"] for r in records_.values()),
        failovers=overlap.get("failovers_total", 0),
        stream_max_concurrent=overlap["stream_max_concurrent"],
        admitted_peak=overlap["max_concurrent"], differ=wrong,
        exit_code=rc, **_served_stats(stats))
    for sid in ("1", "2"):
        r = records_.get(sid)
        if r is None or r["returncode"] or r["failures"] or \
                r["executed"] != len(SERVE_PARTS):
            raise AssertionError(f"serve stream {sid}: {r}")
    if wrong:
        raise AssertionError(f"serve: answers differ from the throughput "
                             f"phase's: {wrong}")
    if rc != 0:
        raise AssertionError(f"serve: the server's drain exited {rc}")
    return _launches(stats)


def serve_fates(scale: float, seed: int, card: str, refs: dict) -> int:
    """The query server's four fates (``scripts/serve_smoke.py``) on the
    card at ``scale``, each server a process generating the warehouse
    (the four started together), every answer held against ``refs`` (the
    corpus check's compiled runs of streams 0, 1 and 2, each held against
    an eager run): (1) clean: streams 0, 1 and 2 cut to
    ``PROCESS_PARTS`` through ``throughput --mode serve`` at once, then
    each asked again; (2) ``serve.dispatch`` transient faults: the client
    retries to the same answers; (3) SIGTERM with a query in flight (an
    injected ``execute`` hang holds it): it is answered, the next request
    gets ``draining`` (or a closed socket), the server exits 0 and
    journals the clean-shutdown marker; (4) SIGKILL with a query in
    flight, a restart on the same state: the retried query is answered,
    and a key the killed server saw runs with no discovery
    (``engine.discoveries``).  Then a 2-replica fleet (``python -m
    ndstpu_torch.harness.serve fleet``): a client sends stream 1's parts
    over both endpoints while the replica it uses is SIGKILLed; it fails
    over, every answer equal, and the supervisor restarts the replica.
    One ``serve fates`` line each.  Returns the servers' ``segsum_decimal``
    launches."""
    import shutil
    import signal
    import threading
    from ndstpu_torch.serve import fleet
    from ndstpu_torch.serve.client import ServerDraining
    t0 = time.time()
    out = SERVE_DIR / "fates"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    texts = _serve_texts(("0", "1", "2"), PROCESS_PARTS)
    socks = {leg: f"unix:{out / (leg + '.sock')}"
             for leg in ("clean", "faults", "term", "kill")}
    faults = {"clean": None,
              "faults": f"serve.dispatch:transient:1:seed{seed}:times=3",
              "term": "execute:hang:1:times=1:hang=4",
              # seed 0 fires the probe's second call, not its first
              "kill": "execute:hang:0.5:seed0:times=1:hang=10"}
    procs = ServerProcs()
    launches = 0
    try:
        proc = {leg: procs.start(
            _serve_cmd(socks[leg], scale, seed, out / f"state_{leg}"),
            out / f"{leg}.log", faults[leg]) for leg in socks}
        for leg in socks:
            _ready(socks[leg], 300.0, proc[leg])
        say("serve fates start", seconds=time.time() - t0, card=card)

        # (1) clean: three streams at once, then each part asked again
        t1 = time.time()
        cmd = [sys.executable, "-m", "ndstpu_torch.harness.throughput",
               "0,1,2", "--mode", "serve", "--serve_socket", socks["clean"],
               "--overlap_report", str(out / "overlap.json"), "--",
               sys.executable, "-m", "ndstpu_torch.harness.power",
               str(POWER_DIR / "query_{}.sql"), "-",
               str(out / "time_{}.csv"), "--generate", f"{scale:g}",
               "--sub_queries", ",".join(PROCESS_PARTS)]
        with open(out / "throughput.log", "w") as log:
            run = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 timeout=600)
        overlap = json.loads((out / "overlap.json").read_text()) \
            if run.returncode == 0 else {"streams": []}
        wrong = _ask_all(socks["clean"], texts, refs, "check")
        stats = _stats(socks["clean"])
        launches += _launches(stats)
        rc = _stop(proc["clean"])
        say("serve fates", fate="clean", streams=3, rc=run.returncode,
            executed={r["stream"]: r["executed"] for r in overlap["streams"]},
            failures={r["stream"]: r["failures"] for r in overlap["streams"]},
            stream_max_concurrent=overlap.get("stream_max_concurrent"),
            differ=wrong, exit_code=rc, seconds=time.time() - t1,
            **_served_stats(stats))
        if run.returncode != 0 or wrong or rc != 0 or any(
                r["failures"] or r["executed"] != len(PROCESS_PARTS)
                for r in overlap["streams"]) or len(overlap["streams"]) != 3:
            raise AssertionError("serve fates: the clean run failed")

        # (2) dispatch faults: the client retries to the same answers
        t1 = time.time()
        cli = _client(socks["faults"], tenant="faults", retries=8)
        try:
            wrong = [n for n, sql in texts["1"].items() if answer_difference(
                refs[_plain_sql(sql)], cli.sql(sql, max_rows=SERVE_MAX_ROWS))
                is not None]
            retried = cli.retried
        finally:
            cli.close()
        stats = _stats(socks["faults"])
        launches += _launches(stats)
        rc = _stop(proc["faults"])
        injected = (out / "faults.log").read_text().count(
            "[faults] injected")
        say("serve fates", fate="dispatch faults", client_retries=retried,
            injected=injected, differ=wrong, exit_code=rc,
            seconds=time.time() - t1, **_served_stats(stats))
        if wrong or retried < 1 or not injected or rc != 0:
            raise AssertionError("serve fates: the dispatch-fault run failed")

        # (3) SIGTERM with a query in flight
        t1 = time.time()
        cli = _client(socks["term"], tenant="term", retries=2)
        sql = texts["0"]["query5"]
        got = {}
        th = threading.Thread(target=lambda: got.update(
            resp=cli.sql(sql, max_rows=SERVE_MAX_ROWS)), daemon=True)
        th.start()
        time.sleep(1.0)
        proc["term"].send_signal(signal.SIGTERM)
        th.join(120.0)
        try:
            cli.sql(texts["0"]["query3"])
            after = "answered"
        except (ServerDraining, OSError, ConnectionError) as e:
            after = type(e).__name__
        cli.close()
        rc = proc["term"].wait(timeout=120)
        events = _journal(out / "state_term" / "serve_journal.jsonl")
        diff = answer_difference(refs[_plain_sql(sql)], got["resp"]) \
            if "resp" in got else "no answer"
        say("serve fates", fate="SIGTERM drain", in_flight="query5",
            difference=diff, after_drain=after, exit_code=rc,
            journal_last=events[-1:], seconds=time.time() - t1)
        if diff is not None or after == "answered" or rc != 0 or \
                events[-1:] != ["clean-shutdown"]:
            raise AssertionError("serve fates: the SIGTERM drain failed")

        # (4) SIGKILL with a query in flight, then a warm restart
        t1 = time.time()
        seen, other = texts["0"]["query80"], texts["0"]["query42"]
        cli = _client(socks["kill"], tenant="kill")
        first = cli.sql(seen, max_rows=SERVE_MAX_ROWS)
        cli.close()
        killed = {}
        kill_cli = _client(socks["kill"], tenant="kill", retries=30,
                           connect_timeout_s=300.0)
        th = threading.Thread(target=lambda: killed.update(
            resp=kill_cli.sql(other, max_rows=SERVE_MAX_ROWS)), daemon=True)
        th.start()
        time.sleep(1.0)
        proc["kill"].kill()
        proc["kill"].wait(timeout=60)
        restarted = procs.start(
            _serve_cmd(socks["kill"], scale, seed, out / "state_kill"),
            out / "kill.log")
        th.join(300.0)
        retried = kill_cli.retried
        kill_cli.close()
        _ready(socks["kill"], 300.0, restarted)
        cli = _client(socks["kill"], tenant="kill")
        try:
            before = cli.stats()
            again = cli.sql(seen, max_rows=SERVE_MAX_ROWS)
            stats = cli.stats()
        finally:
            cli.close()
        launches += _launches(stats)
        rc = _stop(restarted)
        events = _journal(out / "state_kill" / "serve_journal.jsonl")
        new = stats["counters"].get("engine.discoveries", 0) - \
            before["counters"].get("engine.discoveries", 0)
        diffs = {k: answer_difference(refs[_plain_sql(s)], r)
                 for k, s, r in (("first", seen, first),
                                 ("through the kill", other,
                                  killed.get("resp", {})),
                                 ("after the restart", seen, again))}
        say("serve fates", fate="SIGKILL and warm restart",
            client_retries=retried, new_discoveries=new,
            differences=diffs, journal=events, exit_code=rc,
            seconds=time.time() - t1, **_served_stats(stats))
        if any(d is not None for d in diffs.values()) or retried < 1 or \
                new != 0 or events.count("server-start") != 2 or \
                "clean-shutdown" != events[-1]:
            raise AssertionError("serve fates: the warm restart failed")

        # a 2-replica fleet, one replica SIGKILLed under a client
        t1 = time.time()
        run_dir = out / "fleet"
        eps = fleet.default_endpoints(str(run_dir), 2)
        sup = procs.start(_fleet_cmd(run_dir, scale, seed),
                          out / "fleet.log")
        health_path = run_dir / fleet.FLEET_HEALTH_BASENAME

        def health() -> dict:
            try:
                return json.loads(health_path.read_text())
            except (OSError, ValueError):
                return {}

        def wait_health(pred, what: str, timeout_s: float = 300.0) -> dict:
            t = time.time()
            while time.time() - t < timeout_s:
                if sup.poll() is not None:
                    raise AssertionError(f"fleet: the supervisor exited "
                                         f"{sup.returncode}")
                doc = health()
                if doc and pred(doc):
                    return doc
                time.sleep(0.5)
            raise AssertionError(f"fleet: {what} within {timeout_s:g} s")

        wait_health(lambda d: all(r["ready"] for r in d["replicas"]),
                    "replicas not ready")
        cli = _client(",".join(eps), tenant="fleet", retries=24)
        answers = {}
        names = list(texts["1"])
        answers[names[0]] = cli.sql(texts["1"][names[0]],
                                    max_rows=SERVE_MAX_ROWS)
        victim = next(r for r in health()["replicas"]
                      if r["endpoint"] == cli.endpoint.path)

        def rest():
            for n in names[1:]:
                answers[n] = cli.sql(texts["1"][n], max_rows=SERVE_MAX_ROWS)

        th = threading.Thread(target=rest, daemon=True)
        th.start()
        time.sleep(0.2)
        os.kill(victim["pid"], signal.SIGKILL)
        th.join(300.0)
        failovers, retried = cli.failovers, cli.retried
        cli.close()
        doc = wait_health(
            lambda d: all(r["ready"] for r in d["replicas"]) and any(
                r["replica_id"] == victim["replica_id"] and r["restarts"]
                for r in d["replicas"]), "the killed replica not restarted")
        for ep in eps:
            launches += _launches(_stats(ep))
        rc = _stop(sup, 180.0)
        wrong = [n for n in names if n not in answers or answer_difference(
            refs[_plain_sql(texts["1"][n])], answers[n]) is not None]
        say("serve fates", fate="fleet, a replica SIGKILLed",
            replicas=[{k: r[k] for k in ("replica_id", "pid", "restarts",
                                         "ready")} for r in doc["replicas"]],
            killed=victim["replica_id"], failovers=failovers,
            client_retries=retried, answered=len(answers), differ=wrong,
            fleet_counters=doc["counters"], exit_code=rc,
            seconds=time.time() - t1)
        if wrong or failovers < 1 or rc != 0:
            raise AssertionError("serve fates: the fleet run failed")
    finally:
        procs.stop_all()
    say("serve fates summary", scale=scale, seconds=time.time() - t0,
        segsum_launches=launches, card=card)
    return launches


# ---------------------------------------------------------------------------


# the queries held before and after maintenance: q5 and q80 reach
# segsum_decimal
DM_PARTS = ("query3", "query5", "query80")
DM_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dm"
# the functions that fail in the JAX package (planner.py:257, their
# left join time_dim on t_time = 43200) and in the port alike
DM_FAILING = ("LF_CR", "LF_SR", "LF_WR")


def sorted_columns(table) -> list:
    """A table's columns as host arrays (each value, its validity) in
    one order of its rows, the lexicographic one: two tables hold the
    same multiset of rows exactly when these are equal.  String codes
    become their values' ranks, so that dictionaries may differ."""
    keys = []
    for c in table.columns.values():
        data = c.data.cpu().numpy() if isinstance(c.data, torch.Tensor) \
            else np.asarray(c.data)
        valid = np.ones(len(data), bool) if c.valid is None else (
            c.valid.cpu().numpy() if isinstance(c.valid, torch.Tensor)
            else np.asarray(c.valid))
        if c.dictionary is not None:
            d = c.dictionary.astype(str)
            ranks = np.argsort(np.argsort(d, kind="stable"), kind="stable")
            data = np.where(valid & (data >= 0),
                            ranks[np.clip(data, 0, max(len(d) - 1, 0))]
                            if len(d) else 0, -1)
        keys += [np.where(valid, data, 0), valid]
    if not keys or not len(keys[0]):
        return keys
    order = np.lexsort(keys[::-1])
    return [k[order] for k in keys]


def maintenance_check(segsum, scale: float, seed: int, card: str) -> tuple:
    """Data maintenance at ``scale`` on the card against the CPU: the
    warehouse and refresh set 1 generated on the card and copied to the
    host; q3, q5 and q80 run on the card before maintenance, so that
    their graphs are captured; the 11 functions through the maintenance
    module's helpers on each device (statuses as ``BenchReport`` records
    them); then each of the seven fact tables must hold the same rows on
    both (as multisets, exactly), the same three functions must have
    failed, and the three queries must run again on the card through a
    rediscovery (the catalog versions changed: never a replay of the
    stale graph) and equal the CPU's results.  The launch counts are zeroed
    just before the card's maintenance and read after the queries' second
    runs (with one profiled replay each, whose launches must be its
    graph's calls); then on a session of their own every
    ``segsum_decimal`` call of the three, discovery's and the replayed
    graph's, is held bit-exact against the plain version.  Returns the
    (wrapper, replay) launches and the largest error."""
    from ndstpu_torch import datagen
    from ndstpu_torch.engine.plan import fixes_order
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.harness import maintenance as dm
    from ndstpu_torch.harness.report import BenchReport
    from ndstpu_torch.queries import corpus
    t0 = time.time()
    cat = datagen.generate(scale, seed, "cuda")
    for name, t in datagen.generate_refresh(scale, 1, seed, "cuda").items():
        cat.register(name, t)
    torch.cuda.synchronize()
    host = datagen.move(cat, "cpu")
    say("maintenance check data", scale=scale, seconds=time.time() - t0,
        device_bytes=torch.cuda.memory_allocated())
    sql = dict(corpus())
    on_card, on_cpu = Session(cat, device="cuda"), Session(host, device="cpu")
    exe = on_card.executor
    for q in DM_PARTS:
        on_card.sql(sql[q])
        on_card.sql(sql[q])
    held = len(exe._graphs)

    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = segsum.LAUNCHES_F32 = 0
    status, seconds = {}, {}
    for dev, sess in (("card", on_card), ("cpu", on_cpu)):
        t1 = time.time()
        funcs = dm.get_maintenance_queries(sess, dm.DM_FUNCS)
        status[dev] = {fn: BenchReport().report_on(
            dm.run_dm_query, sess, stmts, query_name=fn)["queryStatus"][-1]
            for fn, stmts in funcs.items()}
        seconds[dev] = time.time() - t1
    rows = {dev: dm.fact_rows(s) for dev, s in (("card", on_card),
                                                 ("cpu", on_cpu))}
    differ = []
    for table in dm.FACT_TABLES:
        a = sorted_columns(on_card.catalog.get(table))
        b = sorted_columns(on_cpu.catalog.get(table))
        if len(a) != len(b) or any(not np.array_equal(x, y)
                                   for x, y in zip(a, b)):
            differ.append(table)
    failed = {dev: sorted(fn for fn, st in s.items() if st == "Failed")
              for dev, s in status.items()}
    say("maintenance check", scale=scale, status=status["card"],
        cpu_status=status["cpu"], rows=rows["card"], cpu_rows=rows["cpu"],
        differ=differ, graphs_before=held, graphs_after=len(exe._graphs),
        card_seconds=seconds["card"], cpu_seconds=seconds["cpu"], card=card)
    if differ:
        raise AssertionError(f"maintenance: the card's {differ} differ "
                             f"from the CPU's")
    if failed["card"] != failed["cpu"] or \
            failed["card"] != sorted(DM_FAILING):
        raise AssertionError(f"maintenance: failed functions {failed}")

    wrong = []
    for q in DM_PARTS:
        d0, r0 = exe.n_discoveries, exe.n_replays
        first = on_card.sql(sql[q])
        rediscovered = exe.n_discoveries - d0
        second = on_card.sql(sql[q])
        cp = on_card.compiled_plan(sql[q])
        profiled = profiled_replay(
            segsum, on_card, sql[q], cp, q)["launches"] \
            if graph_calls(cp) else 0
        want = engine_rows(on_cpu.sql(sql[q]), nulls=True)
        ordered = fixes_order(on_card.plan(sql[q])[0])
        diffs = {run: first_difference(want, engine_rows(t, nulls=True),
                                       ordered)
                 for run, t in (("rediscovery", first), ("replay", second))}
        diffs = {run: d for run, d in diffs.items() if d is not None}
        say("maintenance check query", part=q, rows=first.num_rows,
            discoveries=rediscovered, replays=exe.n_replays - r0,
            graph_kernel_calls=graph_calls(cp),
            replay_segsum_launches_profiled=profiled, equal=not diffs,
            **({"differences": diffs} if diffs else {}))
        if diffs or rediscovered != 1:
            wrong.append(q)
    launches = (segsum.LAUNCHES, segsum.REPLAY_LAUNCHES)
    if wrong:
        raise AssertionError(f"maintenance: {wrong} did not rediscover "
                             f"after maintenance, or differ from the CPU")
    if not sum(launches):
        raise AssertionError("maintenance: q5 and q80 launched no "
                             "segsum_decimal")
    checker = Session(cat, device="cuda")
    err, calls = 0, 0
    for q in DM_PARTS:
        _c, n_calls, e, _out = segsum_calls(segsum, checker, sql[q],
                                            keep=0)
        err, calls = max(err, e), calls + n_calls
    say("maintenance check kernels", segsum_launches=launches[0],
        replay_segsum_launches_profiled=launches[1],
        checked_graph_calls=calls, max_abs_err=err,
        seconds=time.time() - t0, card=card)
    return launches, err


def _dm_log(path: Path) -> dict:
    """A maintenance time log's rows, {query: value}."""
    import csv
    with open(path) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["application_id", "query", "time/s"]:
        raise AssertionError(f"maintenance time log header {rows[0]}")
    return {r[1]: float(r[2]) for r in rows[1:]}


def maintenance_counts(scale: float, seed: int) -> int:
    """The maintenance functions at ``scale`` on the card, each statement
    held against an independent count: before each DELETE, a
    ``count(*)`` of its WHERE over its table, which must be the rows it
    removes; before each INSERT, a ``count(*)`` of its SELECT, which must
    be the rows it adds (both eager, through ``Session.sql_script``).  One
    line a statement; then the device bytes held at the end against the
    bytes of the tables the catalog and the executor hold, so that no
    replaced table outlives its last user.  Run in a process of its own
    (``maintenance_runs``)."""
    import re
    from ndstpu_torch import datagen
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.harness import maintenance as dm
    sess = Session(datagen.generate(scale, seed, "cuda"), device="cuda")
    dm.register_refresh(sess, datagen.generate_refresh(scale, 1, seed,
                                                       "cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    delete = re.compile(r"^delete\s+from\s+(\w+)\s+where\s+(.*)$",
                        re.I | re.S)
    insert = re.compile(r"^insert\s+into\s+(\w+)\s+(select\s.*)$",
                        re.I | re.S)
    bad = []
    for fn, stmts in dm.get_maintenance_queries(sess, dm.DM_FUNCS).items():
        for i, text in enumerate(stmts):
            m_del, m_ins = delete.match(text), insert.match(text)
            want = table = None
            t1 = time.time()
            if m_del:
                table = m_del.group(1)
                want = sess.sql_script(
                    f"select count(*) c from {table} where "
                    f"{m_del.group(2)}")[0].to_rows()[0][0]
            elif m_ins:
                table = m_ins.group(1)
                want = sess.sql_script(
                    f"select count(*) c from ({m_ins.group(2)}) q"
                )[0].to_rows()[0][0]
            count_s = time.time() - t1
            before = sess.catalog.get(table).num_rows if table else None
            t1 = time.time()
            try:
                sess.sql(text)
            except Exception as e:  # noqa: BLE001 — recorded, as a report
                say("maintenance statement", function=fn, statement=i,
                    error=f"{type(e).__name__}: {e}")
                break       # a function stops at its first failure
            torch.cuda.synchronize()
            run_s = time.time() - t1
            if table is None:
                say("maintenance statement", function=fn, statement=i,
                    kind=text.split()[0].lower(), seconds=run_s)
                continue
            after = sess.catalog.get(table).num_rows
            got = before - after if m_del else after - before
            say("maintenance statement", function=fn, statement=i,
                kind="delete" if m_del else "insert", table=table,
                rows=got, count=want, rows_before=before,
                rows_after=after, seconds=run_s, count_seconds=count_s)
            if got != want:
                bad.append((fn, i))
    gc.collect()
    live = set()
    live_bytes = 0

    def hold(t):
        nonlocal live_bytes
        if isinstance(t, torch.Tensor) and t.is_cuda and \
                t.untyped_storage().data_ptr() not in live:
            live.add(t.untyped_storage().data_ptr())
            live_bytes += t.untyped_storage().nbytes()
    for table in sess.catalog.tables.values():
        for c in table.columns.values():
            hold(c.data)
            hold(c.valid)
    for _v, dt in sess.executor._device_cache.values():
        hold(dt.alive)
        for c in dt.columns.values():
            hold(c._data)
            hold(c._valid)
    allocated = torch.cuda.memory_allocated()
    say("maintenance memory", allocated_bytes=allocated,
        live_table_bytes=live_bytes, unheld_bytes=allocated - live_bytes,
        peak_bytes=torch.cuda.max_memory_allocated(),
        rows=dm.fact_rows(sess))
    if bad:
        raise AssertionError(f"maintenance: rows changed differ from the "
                             f"counts at {bad}")
    if allocated - live_bytes > 1 << 30:
        raise AssertionError(f"maintenance: {allocated - live_bytes} device "
                             f"bytes held beyond the live tables")
    return 0


def maintenance_runs(scale: float, seed: int, card: str,
                     counts_scale: float) -> None:
    """The maintenance command line at ``scale``, in a process of its
    own: ``python -m ndstpu_torch.harness.maintenance - - <log> --generate
    SF --update 1``.  Its time log must have the 11 function rows and
    ``Data Maintenance Time``, its summaries LF_CR, LF_SR and LF_WR
    ``Failed`` and the rest ``Completed``; one line with each function's
    ms and status, the rows each changed and the peak device memory.
    Then ``maintenance_counts`` at ``counts_scale`` in another process:
    every statement's rows against its independent count."""
    import shutil
    from ndstpu_torch.harness import maintenance as dm
    shutil.rmtree(DM_DIR, ignore_errors=True)
    DM_DIR.mkdir(parents=True)
    log = DM_DIR / "time.csv"
    cmd = [sys.executable, "-m", "ndstpu_torch.harness.maintenance", "-",
           "-", str(log), "--generate", f"{scale:g}", "--update", "1",
           "--generate_seed", str(seed), "--json_summary_folder",
           str(DM_DIR / "summaries")]
    t0 = time.time()
    with open(DM_DIR / "maintenance.log", "w") as out:
        proc = subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT,
                              timeout=600)
    wall = time.time() - t0
    text = (DM_DIR / "maintenance.log").read_text()
    if proc.returncode != 0:
        raise AssertionError(f"maintenance exited {proc.returncode}:\n"
                             f"{text[-4000:]}")
    times = _dm_log(log)
    status = {n: st for n, (st, _f) in _statuses(DM_DIR / "summaries").items()}
    changed = {}
    for line in text.splitlines():
        if line.startswith("Rows of "):
            fn, rows = line[len("Rows of "):].split(": ", 1)
            changed[fn] = json.loads(rows.replace("'", '"'))
    peak = [int(ln.split()[4]) for ln in text.splitlines()
            if ln.startswith("====== Peak device memory:")]
    say("maintenance run", scale=scale,
        function_ms={fn: times.get(fn) for fn in dm.DM_FUNCS},
        status=status, rows=changed,
        data_maintenance_time_s=times.get("Data Maintenance Time"),
        peak_device_bytes=peak[0] if peak else None, wall_s=wall, card=card)
    if [n for n in times if n in dm.DM_FUNCS] != dm.DM_FUNCS or \
            "Data Maintenance Time" not in times:
        raise AssertionError(f"maintenance time log rows {list(times)}")
    if status != {fn: "Failed" if fn in DM_FAILING else "Completed"
                  for fn in dm.DM_FUNCS}:
        raise AssertionError(f"maintenance statuses {status}")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
         f"chip_smoke.maintenance_counts({counts_scale!r}, {seed!r}))"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=600)
    (DM_DIR / "counts.log").write_text(proc.stdout + proc.stderr)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    mem = [ln for ln in lines if ln["phase"] == "maintenance memory"]
    say("maintenance counts", scale=counts_scale, statements=sum(
        ln["phase"] == "maintenance statement" for ln in lines),
        checked=[(ln["function"], ln["statement"], ln["rows"], ln["count"])
                 for ln in lines if "count" in ln],
        errors=[(ln["function"], ln["error"]) for ln in lines
                if "error" in ln],
        memory=mem[0] if mem else None, wall_s=time.time() - t0,
        card=card)
    if proc.returncode != 0:
        raise AssertionError(f"maintenance counts exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")



# -- out-of-core execution (phase 16 and the check's chunked runs) ----------

# one stream-0 part a path of the distributed executor, q17 and q72 first
# (neither runs resident at SF 30, PR 7); no corpus part puts a window or
# a Sort+Limit directly over a fact's rows, so those two paths run the
# ad-hoc queries of tests/test_torch_dplan.py's kind
OOC_QUERIES = {
    "query17": None, "query72": None, "query3": None, "query9": None,
    "query71": None, "query86": None,
    "tail": ("select ss_item_sk, ss_ticket_number, ss_net_paid from "
             "store_sales where ss_quantity > 50 order by ss_net_paid "
             "desc, ss_item_sk limit 25"),
    "window": ("select ss_item_sk, ss_ticket_number, rank() over "
               "(partition by ss_store_sk order by ss_net_paid) as r "
               "from store_sales where ss_quantity > 95 "
               "and ss_net_paid > 19000"),
}
OOC_PATHS = ("broadcast join", "shuffle join", "union-aggregate",
             "subquery offload", "row spine with device tail", "window",
             "grouping sets")
# the share of the host's memory the seven fact tables may take, and the
# device bytes the out-of-core phase may allocate (the card's nominal
# 80 GB; an H100 80GB reports 79.18 GiB)
OOC_HOST_SHARE = 0.5
OOC_DEVICE_CAP = 80e9


def _scans(plan):
    """A plan's scans, those of its subqueries' plans included."""
    from ndstpu_torch.engine import expr as ex, plan as lp
    from ndstpu_torch.engine.optimizer import _plan_exprs
    for node in plan.walk():
        if isinstance(node, lp.Scan):
            yield node
        for e in _plan_exprs(node):
            for x in e.walk():
                if isinstance(x, ex.SubqueryExpr) and x.plan is not None:
                    yield from _scans(x.plan)


def facts_host_bytes(scale: float) -> int:
    """The host bytes of the seven fact tables at ``scale``: each
    column's width, and a validity byte where the column has NULLs."""
    from ndstpu_torch import datagen
    from ndstpu_torch.engine.columnar import numpy_dtype
    from ndstpu_torch.schema import get_schemas
    n = datagen.sizes(scale)
    schemas = get_schemas()
    return sum(n[t] * sum(np.dtype(numpy_dtype(c.dtype)).itemsize + 1
                          for c in schemas[t].columns)
               for t in datagen.FACTS)


def ooc_scale() -> float:
    """SF 100 where half the host's memory holds its facts, else the
    largest multiple of 10 that fits, and never under 30: past the SF 20
    the whole warehouse fits the card at (PR 7)."""
    total = int(open("/proc/meminfo").read().split("MemTotal:")[1]
                .split()[0]) * 1024
    room = total * OOC_HOST_SHARE
    if facts_host_bytes(100) <= room:
        return 100.0
    sf = 30.0
    while sf < 100 and facts_host_bytes(sf + 10) <= room:
        sf += 10
    return sf


def _rss() -> int:
    status = open("/proc/self/status").read()
    return int(status.split("VmRSS:")[1].split()[0]) * 1024


def chunked_run(cat, sql: str, chunk_rows, threshold=None):
    """One run of ``sql`` through a fresh chunked session on the card:
    (result, executor or None when it fell through, counter moves, ms,
    peak device bytes)."""
    from ndstpu_torch import obs
    from ndstpu_torch.engine.session import Session
    sess = Session(cat, device="cuda", spmd_chunk_rows=chunk_rows,
                   spmd_threshold=threshold)
    before = obs.counters_snapshot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = sess.sql(sql)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, sess.last_spmd, obs.counter_delta(before), ms,
            torch.cuda.max_memory_allocated())


def _fell(moved: dict) -> list:
    return sorted(k for k in moved if k.startswith("engine.spmd.fallback")
                  or k in ("engine.spmd.unsupported_fallbacks",
                           "engine.spmd.error_fallbacks"))


def chunked_check(cat, host, wants: dict, card: str) -> None:
    """Every part of the corpus through the chunked session on the card,
    over the check's warehouse with its seven fact tables in host memory
    (``host``'s copies) and its dimensions on the card: the chunk rows
    half the part's largest table of the distributed executor's
    threshold, and where a fact it streams then fits one chunk, half the
    smallest such fact, so that every streamed fact runs in two chunks or
    more (a DISTINCT or window spine runs resident, as in the JAX
    package).  The distributed executor takes tables of 500 rows or more
    (the CPU tests' threshold), so that no part falls through for want
    of one.  Each answer must equal the CPU's (``wants``), and no part
    may fall through."""
    from ndstpu_torch import datagen, obs
    from ndstpu_torch.engine.plan import fixes_order
    from ndstpu_torch.engine.session import Session
    from ndstpu_torch.io.catalog import Catalog
    from ndstpu_torch.queries import corpus
    t0 = time.time()
    ooc = Catalog()
    for name, table in cat.tables.items():
        ooc.register(name, host.get(name) if name in datagen.FACTS
                     else table)
    planner = Session(ooc, device="cuda")
    threshold = 500
    obs.reset(enabled=True)
    wrong, fell, chunks = [], [], 0
    for name, sql in corpus():
        plan = planner.plan(sql)[0]
        largest = max((ooc.get(s.table).num_rows for s in _scans(plan)
                       if ooc.get(s.table).num_rows >= threshold),
                      default=1)
        got, exe, moved, ms, peak = chunked_run(ooc, sql, -(-largest // 2),
                                                threshold)
        fits = [n for _t, n, _m, _l, why in (exe.streams if exe else ())
                if why == "fits"]
        if fits:
            got, exe, moved, ms, peak = chunked_run(
                ooc, sql, max(-(-min(fits) // 2), 1), threshold)
        want, ordered = wants[name]
        diff = first_difference(want, engine_rows(got, nulls=True),
                                ordered)
        if diff is not None:
            wrong.append(name)
        if exe is None:
            fell.append(name)
        chunks += moved.get("engine.stream.chunks", 0)
        say("corpus check chunked", part=name, rows=got.num_rows, ms=ms,
            chunks=moved.get("engine.stream.chunks", 0),
            streams=exe.streams if exe else None,
            paths=sorted(set(exe.paths)) if exe else None,
            fell_through=_fell(moved), peak_bytes=peak, equal=diff is None,
            **({} if diff is None else {"difference": diff}))
    say("corpus check chunked summary", parts=len(wants), differ=wrong,
        fell_through=fell, chunks=chunks, seconds=time.time() - t0,
        card=card)
    obs.reset()
    if wrong or fell:
        raise AssertionError(f"chunked parts differ from the CPU: {wrong}; "
                             f"fell through: {fell}")


def ooc_phase(segsum, scale: float, seed: int, card: str) -> int:
    """The out-of-core path at ``scale``: the warehouse generated on the
    card with its seven fact tables copied into host memory chunk by
    chunk (``datagen.generate(..., host_facts=True)``), the dimensions on
    the card; each of ``OOC_QUERIES`` through ``Session(spmd_chunk_rows=
    "auto")`` and again at half the chunk rows the planner chose for its
    largest streamed fact: both must go through the distributed executor
    (no fall-through, ``NDSTPU_SPMD_STRICT`` on) and give the same
    answer, and the parts together must take every path of
    ``OOC_PATHS``.  Returns the ``segsum_decimal`` launches (the
    driver's eager tails)."""
    from ndstpu_torch import datagen, obs
    from ndstpu_torch.engine.torchexec import results_differ
    from ndstpu_torch.queries import corpus
    t0 = time.time()
    cat = datagen.generate(scale, seed, "cuda", host_facts=True)
    torch.cuda.synchronize()
    host_bytes = sum(
        c.data.numel() * c.data.element_size() + (
            0 if c.valid is None else c.valid.numel())
        for t in datagen.FACTS for c in cat.get(t).columns.values())
    say("out-of-core data", scale=scale, seconds=time.time() - t0,
        fact_rows={t: cat.get(t).num_rows for t in datagen.FACTS},
        host_fact_bytes=host_bytes, rss_bytes=_rss(),
        device_bytes=torch.cuda.memory_allocated(),
        host_memory_bytes=int(open("/proc/meminfo").read().split(
            "MemTotal:")[1].split()[0]) * 1024, card=card)
    sql_of = dict(corpus())
    # the card's nominal 80 GB as the process's cap: an out-of-memory
    # halving of the chunk rows keeps every part under it
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(min(1.0, OOC_DEVICE_CAP /
                                                   total))
    obs.reset(enabled=True)
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = 0
    paths, bad = set(), []
    for name, text in OOC_QUERIES.items():
        sql = text or sql_of[name]
        runs = {}
        for label in ("auto", "half"):
            if label == "auto":
                chunk = "auto"
            elif not auto_chunks:
                # the auto run streamed no chunk (a window's spine runs
                # resident): half the chunk rows would run it alike
                break
            else:
                # half the chunk rows the auto run used for its largest
                # streamed fact: its last pass over each (after any
                # out-of-memory halving; a fact that fit one chunk: half
                # its rows)
                done = runs["auto"][1]
                used = {t: m for t, _n, m, _l, _w in
                        (done.streams if done else ())}
                chunk = max(max(used.values(), default=2) // 2, 1)
            got, exe, moved, ms, peak = chunked_run(cat, sql, chunk)
            runs[label] = (got, exe)
            auto_chunks = moved.get("engine.stream.chunks", 0)
            fell = _fell(moved)
            if exe is None or fell:
                bad.append(f"{name} ({label}) fell through: {fell}")
            else:
                paths |= set(exe.paths)
            say("out-of-core", part=name, chunk_rows=chunk, ms=ms,
                rows=got.num_rows,
                chunks=moved.get("engine.stream.chunks", 0),
                streams=exe.streams if exe else None,
                depth=exe._chunk_info[3] if exe else None,
                paths=sorted(set(exe.paths)) if exe else None,
                prefetch_hit=moved.get("io.prefetch.hit", 0),
                prefetch_miss=moved.get("io.prefetch.miss", 0),
                h2d_bytes=moved.get("engine.h2d.bytes", 0),
                h2d_wait_s=moved.get("engine.h2d.wait_s", 0),
                h2d_overlap_s=moved.get("engine.h2d.overlap_s", 0),
                scan_wait_s=moved.get("io.scan.wait_s", 0),
                peak_device_bytes=peak, host_fact_bytes=host_bytes,
                rss_bytes=_rss(), fell_through=fell, card=card)
            del exe
        diff = "half" in runs and results_differ(runs["auto"][0],
                                                 runs["half"][0])
        if diff:
            bad.append(f"{name}: half the chunk rows differ: {diff}")
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1.0)
    launches = segsum.LAUNCHES
    missing = [p for p in OOC_PATHS if p not in paths]
    say("out-of-core summary", scale=scale, parts=len(OOC_QUERIES),
        device_cap_bytes=OOC_DEVICE_CAP,
        paths=sorted(paths), missing_paths=missing,
        segsum_launches=launches, seconds=time.time() - t0, problems=bad,
        card=card)
    obs.reset()
    del cat
    gc.collect()
    torch.cuda.empty_cache()
    if bad or missing:
        raise AssertionError(f"out-of-core: {bad}; paths not taken: "
                             f"{missing}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=STORE_SCALE)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--check-scale", type=float, default=CHECK_SCALE)
    ap.add_argument("--corpus-scale", type=float, default=CORPUS_SCALE)
    ap.add_argument("--ooc-scale", type=float, default=None,
                    help="the out-of-core phase's scale (default: "
                         "ooc_scale(), from the host's memory)")
    args = ap.parse_args()
    # a crash of the process prints the threads' stacks
    faulthandler.enable()
    # a defect of the out-of-core executor fails the run, never falls back
    os.environ["NDSTPU_SPMD_STRICT"] = "1"

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
        t1 = time.perf_counter()
        again = sess.sql(sql)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t1) * 1e3
        diff = torchexec.results_differ(out, again)
        if diff is not None:
            raise AssertionError(f"{q}: a replay differs from its "
                                 f"discovery run: {diff}")
        cp = sess.compiled_plan(sql)
        profiled = profiled_replay(segsum, sess, sql, cp, q)["launches"]
        got = engine_rows(out, nulls)
        launched = decimal_launches(segsum) - before[0]
        if any(routed) and launched == 0:
            raise AssertionError(f"{q} routes sums to segsum_decimal but "
                                 f"launched it no time")
        return got, dict(
            query=q, cold_ms=cold, warm_ms=warm,
            rows=len(got), peak_bytes=peak, pool_bytes=graph_pool_bytes(cp),
            discovery_peak_bytes=cp.peak_bytes, allocated_before=allocated,
            held_pool_bytes_before=held,
            host_syncs=cold_syncs, replay_host_syncs=exe.n_syncs,
            discoveries=exe.n_discoveries - before[2],
            captures=exe.n_captures - before[3],
            oom_retries=exe.n_oom_retries - before[4],
            memo_hits=exe.n_memo_hits, routes_to_kernel=any(routed),
            kernel_launches=launched, graph_kernel_calls=graph_calls(cp),
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

    # main path 1b: the same four over the store channel as doubles
    # (--floats), phase 3's columns converted on the card
    floats_store_launches = floats_store(segsum, cat, ref, card)
    del ref
    gc.collect()
    torch.cuda.empty_cache()

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
    check_refs = check["serve_refs"]
    # main path 10b: the --floats warehouse
    segsum.LAUNCHES = segsum.REPLAY_LAUNCHES = 0
    floats_launches = floats_check(segsum, FLOATS_SCALE, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
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
    corpus_launches, shape, corpus_rows, corpus_kernel_parts = corpus_run(
        segsum, args.corpus_scale, args.seed, card, kernel_parts)
    k["shapes"].append(shape)
    k["max_abs_err"] = max(k["max_abs_err"], shape["max_abs_err"])
    if sum(corpus_launches) == 0:
        raise AssertionError("the corpus launched no segsum_decimal")

    # main path 7: the power run's command line, in processes of its own;
    # this one holds no table or graph meanwhile
    gc.collect()
    torch.cuda.empty_cache()
    power_launches = power_runs(args.corpus_scale, args.seed, card,
                                corpus_rows)
    if power_launches == 0:
        raise AssertionError("the power runs launched no segsum_decimal")
    # main path 7b: the same parts with --floats --static_check
    floats_power_launches = floats_power(FLOATS_SCALE, args.seed, card)

    # main path 8: the throughput test, two streams over one session in
    # this process at the corpus scale; then its process mode, a power
    # process a stream, at the check scale (two warehouses and their
    # graphs at the corpus scale would not fit one card)
    *throughput_launches, serve_refs = throughput_run(
        segsum, args.corpus_scale, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    if sum(throughput_launches) == 0:
        raise AssertionError("the throughput run launched no segsum_decimal")
    process_launches = throughput_processes(args.check_scale, args.seed,
                                            card)

    # main path 9: the query server, in processes of its own: at the
    # corpus scale against the throughput phase's answers, then its fates
    # and a fleet at the check scale against the check's
    serve_launches = serve_run(args.corpus_scale, args.seed, card,
                               serve_refs, corpus_kernel_parts)
    del serve_refs
    serve_launches += serve_fates(args.check_scale, args.seed, card,
                                  check_refs)
    del check_refs
    if serve_launches == 0:
        raise AssertionError("the query servers launched no segsum_decimal")

    # main path 10: data maintenance, checked against the CPU at the check
    # scale, then its command line at the corpus scale
    gc.collect()
    torch.cuda.empty_cache()
    dm_launches, dm_err = maintenance_check(segsum, args.check_scale,
                                            args.seed, card)
    k["max_abs_err"] = max(k["max_abs_err"], dm_err)
    gc.collect()
    torch.cuda.empty_cache()
    maintenance_runs(args.corpus_scale, args.seed, card, args.check_scale)

    # main path 11: out-of-core execution past the scale the warehouse
    # fits the card at, its facts streamed from host memory
    gc.collect()
    torch.cuda.empty_cache()
    ooc_launches = ooc_phase(segsum, args.ooc_scale or ooc_scale(),
                             args.seed, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "segsum_decimal", "route": "cuda",
        "source": "ndstpu_torch/ops/csrc/segsum_decimal.cu",
        "replaces": "ndstpu/ops/segsum.py:141",
        "tpu_kernel": "ndstpu/ops/segsum.py::_limb_kernel",
        "launches": sum(family_launches) + bench_launches[0] +
        sum(store_launches) + sum(window_launches) + sum(setop_launches) +
        sum(corpus_launches) + power_launches + sum(throughput_launches) +
        process_launches + serve_launches + sum(dm_launches) + ooc_launches
        + floats_store_launches + floats_launches + floats_power_launches,
        "launches_by_path": {"q3 family": sum(family_launches),
                             "bench": bench_launches[0],
                             "store slice": sum(store_launches),
                             "store window reports": sum(window_launches),
                             "set operations and distinct":
                             sum(setop_launches),
                             "corpus": sum(corpus_launches),
                             "power run": power_launches,
                             "throughput": sum(throughput_launches),
                             "throughput processes": process_launches,
                             "serve": serve_launches,
                             "maintenance check": sum(dm_launches),
                             "out-of-core": ooc_launches,
                             "floats store channel": floats_store_launches,
                             "floats check": floats_launches,
                             "floats power run": floats_power_launches},
        "replay_launches_by_path": {
            "q3 family": family_launches[1], "bench": 0,
            "store slice": store_launches[1],
            "store window reports": window_launches[1],
            "set operations and distinct": setop_launches[1],
            "corpus": corpus_launches[1],
            "throughput": throughput_launches[1],
            "maintenance check": dm_launches[1]},
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
