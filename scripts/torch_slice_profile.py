"""Where the time of the port's q3-family slice goes, on one CUDA card.

    python3 scripts/torch_slice_profile.py [--scale SF] [--seed N] [--out DIR]

Generates the warehouse on the card (as ``chip_smoke.py`` does), runs each
of q3, q42, q52 and q55 once to warm up, then once under
``torch.profiler`` (CPU and CUDA activities).  Prints one JSON line per
query: wall ms, summed device kernel ms, the device's idle share of the
wall time, host syncs, and the top operators by device time; writes one
Chrome trace per query into ``--out``.  Imports nothing of JAX or of the
``ndstpu`` package.
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

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import QUERIES  # noqa: E402
from ndstpu_torch import datagen  # noqa: E402
from ndstpu_torch.engine.session import Session  # noqa: E402


def _breakdown(prof, top: int) -> dict:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 2
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cat = datagen.generate(args.scale, args.seed, "cuda")
    sess = Session(cat, device="cuda")
    for q, sql in QUERIES.items():
        sess.sql(sql)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.sql(sql)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(out / f"{q}.json"))
        b = _breakdown(prof, args.top)
        print(json.dumps({
            "query": q, "scale": args.scale, "card": card,
            "wall_ms": wall_ms, "device_ms": b["device_ms"],
            "device_idle_share": max(0.0, 1 - b["device_ms"] / wall_ms),
            "host_syncs": sess.executor.n_syncs, **{
                k: v for k, v in b.items() if k != "device_ms"}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
