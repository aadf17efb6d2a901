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
3. data: the q3-family warehouse generated on the card at ``--scale``;
4. kernels: each kernel against its plain PyTorch version on the card,
   bit-exact (tolerance 0: exact int64), at the main path's own inputs
   (captured from a q42 run), at a large Zipf-skewed shape and at the
   edges; with its time, its plain version's time, a one-call PyTorch
   yardstick's time and the least time the card could take (its bound);
5. slice: q3, q42, q52 and q55 through ``Session(device="cuda").sql`` —
   cold and warm times, rows, peak device memory and host syncs — each
   held against a plain numpy reference written here, independent of
   the engine; the kernel launch counts are set to 0 just before and read
   just after, and every kernel of the path must have launched.

Then one JSON line of kernels, and last the result line
``{"ok": true, "device": {...}}``.
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

# H100 SXM HBM3 rate (NVIDIA data sheet): the bound of a byte-bound kernel
HBM_BYTES_PER_S = 3.35e12
LIMIT = 100
SEGMENTS_Q42 = 24443

# the four templates rendered as ndstpu/queries/streamgen.py renders them
# (rngseed 07291122510, stream 0)
QUERIES = {
    "q3": """select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manufact_id = 162
  and dt.d_moy = 11
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, sum_agg desc, brand_id
limit 100""",
    "q42": """select dt.d_year, item.i_category_id, item.i_category,
       sum(ss_ext_sales_price) total
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 12
  and dt.d_year = 2000
group by dt.d_year, item.i_category_id, item.i_category
order by total desc, dt.d_year, item.i_category_id, item.i_category
limit 100""",
    "q52": """select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11
  and dt.d_year = 1999
group by dt.d_year, item.i_brand, item.i_brand_id
order by dt.d_year, ext_price desc, brand_id
limit 100""",
    "q55": """select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 7
  and d_moy = 11
  and d_year = 1999
group by i_brand, i_brand_id
order by ext_price desc, brand_id
limit 100""",
}

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


def time_segsum(segsum, vals, gid, mask, s) -> dict:
    n = vals.shape[0]
    reps = 50 if n < (1 << 22) else 10
    kernel_ms = cuda_ms(lambda: segsum.segment_sum_decimal(vals, gid, mask,
                                                           s), reps)
    plain_ms = cuda_ms(lambda: segsum.segment_sum_decimal_plain(
        vals, gid, mask, s), reps)
    # yardstick: one int64 index_add_ over pre-masked inputs (the mask and
    # range folding is left out of its time)
    take = mask & (gid >= 0) & (gid < s)
    g = torch.where(take, gid, 0).long()
    v = torch.where(take, vals, 0)
    out = torch.zeros(s, dtype=torch.int64, device=vals.device)
    library_ms = cuda_ms(lambda: out.index_add_(0, g, v), reps)
    bound_ms = (13 * n + 16 * s) / HBM_BYTES_PER_S * 1e3
    return dict(n=n, segments=s, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms)


def zipf_gid(n: int, s: int, gen) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    rank = torch.clamp(torch.exp(u * np.log(s + 1.0)).long(), 1, s)
    return ((rank - 1) * 1000003 % s).to(torch.int32)


def kernel_phase(segsum, q42_inputs, seed: int) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = 0
    # the main path's own inputs, captured from a q42 run
    vals, gid, mask, s = q42_inputs
    err = max(err, check_segsum(segsum, vals, gid, mask, s))
    main = time_segsum(segsum, vals, gid, mask, s)
    say("kernel", name="segsum_decimal", shape="q42 main path", **main)
    # large: 8M rows x 24,443 Zipf-skewed segments
    n = 8_000_000
    lv = torch.randint(-10**9, 10**9, (n,), generator=gen, device="cuda")
    lg = zipf_gid(n, SEGMENTS_Q42, gen)
    lm = torch.rand(n, generator=gen, device="cuda") < 0.9
    err = max(err, check_segsum(segsum, lv, lg, lm, SEGMENTS_Q42))
    say("kernel", name="segsum_decimal", shape="8M x 24443 zipf",
        **time_segsum(segsum, lv, lg, lm, SEGMENTS_Q42))
    # edges: empty mask, gid out of range, out-of-range value, n = 1
    m = 4096
    ev = torch.randint(-10**12, 10**12, (m,), generator=gen, device="cuda")
    eg = torch.randint(0, 37, (m,), generator=gen, device="cuda",
                       dtype=torch.int32)
    em = torch.rand(m, generator=gen, device="cuda") < 0.9
    edges = {
        "empty mask": (ev, eg, torch.zeros_like(em), 37),
        "gid out of range": (ev, eg - 5, em, 30),
        "poison": (torch.where(torch.arange(m, device="cuda") == 7,
                               1 << 41, ev), eg, em | (torch.arange(
                                   m, device="cuda") == 7), 37),
        "n = 1": (ev[:1], eg[:1] * 0, em[:1] | True, 1),
    }
    for name, (v, g, mk, s2) in edges.items():
        err = max(err, check_segsum(segsum, v.contiguous(), g.contiguous(),
                                    mk.contiguous(), s2))
    poison_sums, _ = segsum.segment_sum_decimal(*edges["poison"])
    if not bool((poison_sums == -(2 ** 62)).all()):
        raise AssertionError("poison case did not poison every sum")
    say("kernel", name="segsum_decimal", edges=list(edges), max_abs_err=err)
    return dict(main, max_abs_err=err)


# ---------------------------------------------------------------------------
# plain numpy reference of the four queries
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


def order_key(row, spec):
    pos = {c: j for j, c in enumerate(spec["out"])}
    return tuple(-row[pos[c]] if desc else row[pos[c]]
                 for c, desc in spec["order"])


def sort_rows(rows, spec):
    return sorted(rows, key=lambda r: order_key(r, spec))


def engine_rows(table) -> list:
    """Result table -> tuples of python ints/strings (decimals stay
    scaled int64, so the comparison is exact)."""
    cols = []
    for c in table.columns.values():
        if c.valid is not None and not c.valid.all():
            raise AssertionError("unexpected NULL in a result column")
        data = c.dictionary[c.data] if c.dictionary is not None else c.data
        cols.append(data.tolist())
    return list(zip(*cols))


def compare(want_all: list, got: list, spec) -> None:
    """Rows above a tie that crosses the LIMIT cut in order; tied rows of
    one ORDER BY key as a set (the last group: a subset of the ties)."""
    want = want_all[:LIMIT]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference {len(want)}")
    i = 0
    while i < len(want):
        k = order_key(want[i], spec)
        j = i
        while j < len(want) and order_key(want[j], spec) == k:
            j += 1
        part = got[i:j]
        if any(order_key(r, spec) != k for r in part):
            raise AssertionError(f"row {i}: order keys differ: "
                                 f"{part[:3]} vs {want[i:j][:3]}")
        if j == len(want):
            ties = {r for r in want_all if order_key(r, spec) == k}
            ok = set(part) <= ties and len(set(part)) == len(part)
        else:
            ok = sorted(part) == sorted(want[i:j])
        if not ok:
            raise AssertionError(f"rows {i}..{j}: {part[:3]} vs "
                                 f"{want[i:j][:3]}")
        i = j


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
    say("build", seconds=time.time() - t0, ptxas=logs)

    t0 = time.time()
    cat = datagen.generate(args.scale, args.seed, "cuda")
    torch.cuda.synchronize()
    say("data", scale=args.scale, seconds=time.time() - t0,
        rows={t: cat.get(t).num_rows for t in cat.tables},
        device_bytes=torch.cuda.memory_allocated())
    sess = Session(cat, device="cuda")

    # capture the kernel's inputs on the main path (a q42 run)
    captured = []
    wrapper = segsum.segment_sum_decimal

    def capture(vals, gid, mask, s):
        captured.append((vals.clone(), gid.clone(), mask.clone(), s))
        return wrapper(vals, gid, mask, s)

    segsum.segment_sum_decimal = capture
    try:
        sess.sql(QUERIES["q42"])
    finally:
        segsum.segment_sum_decimal = wrapper
    if len(captured) != 1 or captured[0][3] != SEGMENTS_Q42:
        raise AssertionError(f"q42 made {len(captured)} segment-sum calls "
                             f"({[c[3] for c in captured]} segments)")
    k = kernel_phase(segsum, captured[0], args.seed)
    del captured

    t0 = time.time()
    ref = Reference(cat)
    say("reference", seconds=time.time() - t0)

    segsum.LAUNCHES = 0
    for q, sql in QUERIES.items():
        before = segsum.LAUNCHES
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
        got = engine_rows(out)
        if engine_rows(again) != got:
            raise AssertionError(f"{q}: warm run differs from cold run")
        compare(ref.answer(REFERENCE[q]), got, REFERENCE[q])
        say("slice", query=q, cold_ms=cold, warm_median_ms=statistics.median(
            warm), rows=len(got), peak_bytes=torch.cuda.max_memory_allocated(),
            host_syncs=sess.executor.n_syncs,
            kernel_launches=segsum.LAUNCHES - before, card=card)
        if q == "q42" and segsum.LAUNCHES == before:
            raise AssertionError("q42 did not launch segsum_decimal")
    launches = segsum.LAUNCHES
    if launches == 0:
        raise AssertionError("the slice launched no segsum_decimal")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "segsum_decimal", "route": "cuda",
        "source": "ndstpu_torch/ops/csrc/segsum_decimal.cu",
        "replaces": "ndstpu/ops/segsum.py:141",
        "tpu_kernel": "ndstpu/ops/segsum.py::_limb_kernel",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": k["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
