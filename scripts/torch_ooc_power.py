"""The port's power command line, stream 0, at the out-of-core scale with
the fact tables in host memory, and what it did.

    python scripts/torch_ooc_power.py [SF] [--out DIR]

Builds the port's kernels, writes stream 0 with ``python -m
ndstpu_torch.queries.streamgen`` and runs ``python -m
ndstpu_torch.harness.power ... --generate SF --property
spmd.chunk_rows=auto`` (SF defaults to ``chip_smoke.ooc_scale()``).
While it runs, the card's memory in use (``nvidia-smi``) and the power
process's resident memory are sampled every 0.5 s.  Prints one JSON line
(``"phase": "ooc power run"``): ``Power Test Time``, each part's status,
the parts that fell through and their codes, the chunks, staged bytes and
out-of-memory halvings summed from the run's JSON summaries (their
engine counters), and the peaks.  Writes each part's figures to
``DIR/parts.json`` and the time log to ``DIR/time.csv`` (``DIR``:
``build/ooc_power``).  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _summed_counters(summary: dict) -> dict:
    total = {}
    for m in summary.get("metrics", []):
        for k, v in m.get("counters", {}).items():
            total[k] = total.get(k, 0) + v
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", type=float, nargs="?", default=None)
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ooc_power")
    args = ap.parse_args()
    scale = args.scale or cs.ooc_scale()
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    from ndstpu_torch.ops import build
    build.build_all()
    env = dict(os.environ, NDSTPU_LEDGER="none")
    subprocess.run([sys.executable, "-m", "ndstpu_torch.queries.streamgen",
                    "--output_dir", str(out), "--rngseed", "07291122510",
                    "--streams", "1"], check=True, env=env, cwd=REPO)
    peak = {"mib": 0, "rss": 0}
    stop = threading.Event()
    pid = {"p": None}

    def poll():
        while not stop.is_set():
            if pid["p"]:
                try:
                    st = open(f"/proc/{pid['p']}/status").read()
                    peak["rss"] = max(peak["rss"], int(
                        st.split("VmRSS:")[1].split()[0]) * 1024)
                except (OSError, IndexError, ValueError):
                    pass
            r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True)
            try:
                peak["mib"] = max(peak["mib"], int(r.stdout.split()[0]))
            except (ValueError, IndexError):
                pass
            stop.wait(0.5)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    t0 = time.time()
    summ = out / "summaries"
    proc = subprocess.Popen(
        [sys.executable, "-m", "ndstpu_torch.harness.power",
         str(out / "query_0.sql"), "-", str(out / "time.csv"),
         "--generate", f"{scale:g}", "--property", "spmd.chunk_rows=auto",
         "--json_summary_folder", str(summ), "--ledger", "none"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    pid["p"] = proc.pid
    stdout, stderr = proc.communicate()
    stop.set()
    th.join()
    wall = time.time() - t0
    print(stdout[-3000:])
    print(stderr[-3000:], file=sys.stderr)
    times = cs._time_log(out / "time.csv") \
        if (out / "time.csv").exists() else {}
    parts, fell = {}, {}
    for p in sorted(summ.glob("*.json")):
        s = json.loads(p.read_text())
        c = _summed_counters(s)
        codes = sorted(k[len("engine.spmd.fallback."):] for k in c
                       if k.startswith("engine.spmd.fallback."))
        parts[s["query"]] = {
            "status": s["queryStatus"][-1], "ms": times.get(s["query"]),
            "counters_read": bool(c),
            "chunks": c.get("engine.stream.chunks", 0),
            "h2d_bytes": c.get("engine.h2d.bytes", 0),
            "fell": c.get("engine.spmd.unsupported_fallbacks", 0)
            + c.get("engine.spmd.error_fallbacks", 0),
            "codes": codes,
            "oom_halvings": c.get("engine.stream.oom_halvings", 0),
            "failures": s.get("taskFailures")}
        if parts[s["query"]]["fell"]:
            fell[s["query"]] = codes or ["uncoded"]
    cs.say("ooc power run", scale=scale, exit=proc.returncode, wall_s=wall,
           power_test_time=times.get("Power Test Time"),
           total_time=times.get("Total Time"),
           load_ms=times.get("CreateTempView all tables"),
           statuses={k: v["status"] for k, v in parts.items()},
           not_completed={k: v for k, v in parts.items()
                          if v["status"] != "Completed"},
           parts_with_counters=sum(v["counters_read"]
                                   for v in parts.values()),
           fell_through=fell, chunks=sum(v["chunks"] for v in parts.values()),
           h2d_bytes=sum(v["h2d_bytes"] for v in parts.values()),
           oom_halvings=sum(v["oom_halvings"] for v in parts.values()),
           peak_memory_used_mib=peak["mib"], peak_rss_bytes=peak["rss"],
           card=card)
    (out / "parts.json").write_text(json.dumps(parts, indent=1))
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
