"""Where the time of the port's queries goes, on one CUDA card.

    python -m ndstpu_torch.profile [--corpus] [--eager | --attrib]
                                   [--scale SF] [--seed N]
                                   [--queries q1,q2,...] [--device D]
                                   [--out DIR]

Generates the warehouse on the card (as ``chip_smoke.py`` does): the
store-channel columns at SF 100 for the seventeen queries of the earlier
card paths, or with ``--corpus`` the whole warehouse at SF 20 for every
part of the power corpus.  Runs each query once through the compiled
path to warm up (discovery, capture, first replay), then once more under
``torch.profiler`` (CPU and CUDA activities): a replay of its captured
graph, whose kernels no CPU-side operator launched, so its top operators
are empty; with ``--eager`` the profiled run is an eager run of the plan
instead, which attributes device time to operators.  Prints one JSON line
per query: wall ms, summed device ms, the device's idle share of the wall
time, host syncs, memo hits, and the top operators and kernels by device
time; writes one Chrome trace per query into ``--out``.

``--attrib`` reads the replay attribution instead (``NDSTPU_ATTRIB=1``,
``CompilingExecutor.last_attribution``; the counterpart of the JAX
package's ``scripts/attrib_corpus.py``): after the warm-up, one more
replay of each query, timed on the host around ``Session.sql``, and one
line for it: wall, ``host_prep_s``, ``device_s``, ``fetch_s``, fetched
bytes, programs, and the share that dominates (:func:`classify`).  The
dispatch floor it classifies against is measured first: the replay and
synchronise of a captured graph of one one-element kernel.  No profiler
runs, no trace is written and no file is made.  ``--device cpu`` runs it
on the CPU (the tests do, over a small ``--scale``), where the floor is 0
and ``device_s`` is the operators' wall time.  ``--queries`` takes a
subset.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ndstpu_torch import datagen
from ndstpu_torch.engine.session import Session
from ndstpu_torch.queries import (QUERIES, SETOP_QUERIES, STORE_QUERIES,
                                  WINDOW_QUERIES, corpus)

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def breakdown(prof, top: int) -> dict:
    """Device time from the trace: the sum over device events (kernels,
    memcpy, memset; one stream, so no overlap), the top CPU-side ops by
    the device time of the kernels they launched themselves, and the top
    device events by name."""
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    kern = {}
    for e in dev:
        k = kern.setdefault(e.name[:120], [0.0, 0])
        k[0] += e.time_range.elapsed_us() / 1e3
        k[1] += 1
    kern = sorted(kern.items(), key=lambda kv: kv[1][0], reverse=True)
    return {
        "device_ms": device_ms,
        "top_ops": [{"op": e.key, "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in ops[:top]],
        "top_kernels": [{"kernel": n, "device_ms": ms, "calls": c}
                        for n, (ms, c) in kern[:top]]}


def classify(wall: float, a: dict, floor: float) -> str:
    """The share that dominates a replay of ``wall`` seconds with
    attribution ``a`` (``scripts/attrib_corpus.py``'s ``classify``, less
    its tunnel latencies and its peak): ``dispatch-floor`` when device,
    fetch and host time are each within two dispatch floors and under
    2 MB came back, else the largest of ``host`` (preparation and the
    wall time no span covers), ``compute`` (``device_s``) and
    ``transfer`` (``fetch_s``)."""
    host = a["host_prep_s"] + max(
        0.0, wall - a["host_prep_s"] - a["device_s"] - a["fetch_s"])
    spans = {"host": host, "compute": a["device_s"],
             "transfer": a["fetch_s"]}
    if max(spans.values()) <= 2 * floor and a["fetched_bytes"] < 2e6:
        return "dispatch-floor"
    return max(spans, key=spans.get)


def dispatch_floor(device: torch.device, reps: int = 20) -> float:
    """Median seconds of a replay and synchronise of a captured graph of
    one one-element kernel on ``device``; 0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    x = torch.zeros(1, device=device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.add_(1)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def attribution(sess, queries, scale: float, card: str,
                floor: float) -> None:
    """One line for each of ``queries``: a warm replay's wall time and
    attribution, and its dominant share."""
    exe = sess.executor
    exe.attrib_enabled = True
    sync = (torch.cuda.synchronize if exe.device.type == "cuda"
            else (lambda: None))
    for q, sql in queries:
        sess.sql(sql)
        sync()
        exe.last_attribution = None
        t0 = time.perf_counter()
        sess.sql(sql)
        sync()
        wall = time.perf_counter() - t0
        a = exe.last_attribution
        if a is None:
            raise RuntimeError(f"{q}: its warm run did not replay")
        print(json.dumps({
            "query": q, "scale": scale, "card": card, "run": "replay",
            "wall_s": wall, **a, "host_syncs": exe.n_syncs,
            "dispatch_floor_s": floor,
            "bound": classify(wall, a, floor)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", action="store_true",
                    help="every part of the power corpus, whole warehouse")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--eager", action="store_true",
                      help="profile an eager run, not a replay")
    mode.add_argument("--attrib", action="store_true",
                      help="each warm replay's attribution (host "
                           "preparation, device, fetch), no profiler")
    ap.add_argument("--queries", help="comma-separated subset")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests, "
                         "with --attrib only)")
    ap.add_argument("--scale", type=float, default=None,
                    help="SF (default 100, or 20 with --corpus)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=str(_ROOT / "build" / "profile"))
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ndstpu_torch.profile: no CUDA device", file=sys.stderr)
        return 2
    if device.type != "cuda" and not args.attrib:
        ap.error("the profiler's breakdown needs a card; --device cpu "
                 "runs --attrib only")
    card = "cpu" if device.type != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.corpus:
        scale = 20.0 if args.scale is None else args.scale
        cat = datagen.generate(scale, args.seed, device)
        queries = corpus()
    else:
        scale = 100.0 if args.scale is None else args.scale
        cat = datagen.generate(scale, args.seed, device,
                               columns=datagen.COLUMNS)
        queries = list({**QUERIES, **STORE_QUERIES, **WINDOW_QUERIES,
                        **SETOP_QUERIES}.items())
    if args.queries:
        want = args.queries.split(",")
        queries = [(q, sql) for q, sql in queries if q in want]
        if len(queries) != len(want):
            ap.error(f"unknown queries among {want}")
    sess = Session(cat, device=device)
    if args.attrib:
        attribution(sess, queries, scale, card, dispatch_floor(device))
        return 0
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for q, sql in queries:
        sess.sql(sql)
        torch.cuda.synchronize()
        if args.eager:
            plan = sess.plan(sql)[0]
            run = lambda: sess.executor.execute_to_host(plan)  # noqa: E731
        else:
            run = lambda: sess.sql(sql)  # noqa: E731
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(out / f"{q}.json"))
        b = breakdown(prof, args.top)
        print(json.dumps({
            "query": q, "scale": scale, "card": card,
            "run": "eager" if args.eager else "replay",
            "wall_ms": wall_ms, "device_ms": b["device_ms"],
            "device_idle_share": max(0.0, 1 - b["device_ms"] / wall_ms),
            "host_syncs": sess.executor.n_syncs,
            "memo_hits": sess.executor.n_memo_hits, **{
                k: v for k, v in b.items() if k != "device_ms"}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
