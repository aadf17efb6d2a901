"""The port's streaming pipeline for out-of-core execution: the scan pool
and chunk sources (``ndstpu_torch.io.loader``), the staging ring
(``torchexec.ChunkPrefetcher``), the chunked executor over them, and the
session's ``spmd_*`` settings — the counterparts of
``tests/test_stream.py``'s cases, on the CPU (where the ring copies no
pinned buffers: a card's path is ``chip_smoke.py``'s)."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import time

import numpy as np
import pytest
import torch

from ndstpu_torch import datagen, faults, obs
from ndstpu_torch.engine.session import Session
from ndstpu_torch.engine.torchexec import ChunkPrefetcher
from ndstpu_torch.harness import power
from ndstpu_torch.io import loader
from ndstpu_torch.parallel import dplan, mesh as pmesh

Q_AGG = ("select d_year, i_brand_id, sum(ss_ext_sales_price) as s, "
         "count(*) as n from store_sales, date_dim, item "
         "where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk "
         "group by d_year, i_brand_id")
Q_ROWS = ("select ss_item_sk, ss_quantity from store_sales "
          "where ss_quantity > 90")


@pytest.fixture(scope="module")
def catalog():
    return datagen.generate(0.002, seed=1, device="cpu",
                            tables=["store_sales", "date_dim", "item"])


@pytest.fixture(autouse=True)
def counting():
    obs.reset(enabled=True)
    yield
    obs.reset()


def _chunked_rows(catalog, sql, depth, chunk_rows=1000):
    """Plan once on a resident session, run the plan through the chunked
    executor; (exact row list, executor)."""
    plan, _ = Session(catalog, device="cpu").plan(sql)
    exe = dplan.DistributedPlanExecutor(
        catalog, pmesh.make_mesh(1), shard_threshold_rows=500,
        broadcast_limit_rows=50, chunk_rows=chunk_rows,
        prefetch_depth=depth, device="cpu")
    got = exe.execute_plan(plan)
    return list(map(str, got.to_rows())), exe


def _oracle_rows(catalog, sql):
    return list(map(str, Session(catalog, device="cpu").sql(sql).to_rows()))


# -- chunk sources and the scan pool ------------------------------------------


def test_table_chunk_source_windows_match_resident(catalog):
    cols = ["ss_item_sk", "ss_quantity", "ss_sold_date_sk"]
    table = catalog.get("store_sales")
    src = loader.TableChunkSource(table, "store_sales", cols)
    n = src.num_rows
    assert n == table.num_rows
    for start, count in [(0, 100), (n - 57, 57), (n // 3, 1000), (0, n),
                         (n, 10)]:
        got = src.read(start, count)
        for c in cols:
            data, valid = got[c]
            ref = table.column(c)
            assert torch.equal(data, ref.data[start:start + count])
            if ref.valid is None:
                assert valid is None
            else:
                assert torch.equal(valid, ref.valid[start:start + count])
    assert set(src.column_meta()) == set(cols)


def _payload(s, n=4):
    return {"x": (np.full(n, s, dtype=np.int64), np.ones(n, bool))}


def test_scan_pool_reads_ahead():
    reads = []

    def read_fn(s):
        reads.append(s)
        return _payload(s)

    before = obs.counters_snapshot()
    pool = loader.ChunkScanPool(read_fn, range(5), workers=2, depth=2)
    try:
        for s in range(5):
            got = pool.get(s)
            np.testing.assert_array_equal(got["x"][0],
                                          np.full(4, s, dtype=np.int64))
            time.sleep(0.05)     # let the ahead workers land
    finally:
        pool.close()
    assert sorted(reads) == [0, 1, 2, 3, 4]   # KeyedLatch: no re-read
    d = obs.counter_delta(before)
    assert d.get("io.scan.ahead.hit", 0) >= 3
    assert "io.scan.wait_s" in d


def test_scan_pool_reset_rewinds_and_depth_zero_is_synchronous():
    reads = []

    def read_fn(s):
        reads.append(s)
        return _payload(s)

    pool = loader.ChunkScanPool(read_fn, range(4), workers=2, depth=2)
    try:
        for s in range(4):
            pool.get(s)
        pool.reset(next_idx=1)
        time.sleep(0.1)
        for s in range(1, 4):
            np.testing.assert_array_equal(pool.get(s)["x"][0],
                                          np.full(4, s, dtype=np.int64))
    finally:
        pool.close()
    assert sorted(reads) == [0, 1, 1, 2, 2, 3, 3]
    before = obs.counters_snapshot()
    sync = loader.ChunkScanPool(read_fn, range(3), workers=2, depth=0)
    for s in range(3):
        sync.get(s)
    sync.close()
    d = obs.counter_delta(before)
    assert d.get("io.scan.ahead.miss", 0) == 3
    assert d.get("io.scan.ahead.hit", 0) == 0


def test_scan_pool_degrades_to_synchronous_on_failure():
    calls = {0: 0}

    def read_fn(s):
        if s == 0:
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("disk went away")
        return _payload(s)

    before = obs.counters_snapshot()
    pool = loader.ChunkScanPool(read_fn, range(3), workers=2, depth=2)
    try:
        for s in range(3):
            np.testing.assert_array_equal(pool.get(s)["x"][0],
                                          np.full(4, s, dtype=np.int64))
    finally:
        pool.close()
    d = obs.counter_delta(before)
    assert d.get("io.scan.degraded") == 1
    assert calls[0] == 2       # failed worker read + sync retry


def test_attach_stream_source_validates(catalog):
    src = loader.TableChunkSource(catalog.get("store_sales"), "store_sales",
                                  ["ss_item_sk", "ss_quantity"])
    with pytest.raises(KeyError):
        loader.attach_stream_source(catalog, "nope", src)
    with pytest.raises(ValueError, match="rows"):
        loader.attach_stream_source(catalog, "item", src)


# -- the staging ring -----------------------------------------------------------


def _chunk_reader(n=10, m=4):
    reads = []

    def read(i):
        reads.append(i)
        lo, hi = i * m, min(i * m + m, n)
        data = torch.arange(lo, hi, dtype=torch.int64)
        return [(data, data % 3 != 0), (data.to(torch.int32), None)], hi - lo
    return read, reads


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_ring_pads_chunks_and_counts_hits(depth):
    read, reads = _chunk_reader()
    before = obs.counters_snapshot()
    ring = ChunkPrefetcher(read, 3, 4, "cpu", depth=depth)
    try:
        outs = []
        for i in range(3):
            if depth:
                time.sleep(0.05)     # the staging thread lands the chunk
            outs.append(ring.get(i))
    finally:
        ring.close()
    d0, v0, d1, v1, alive = outs[2]
    # the short last chunk (rows 8, 9) is padded with dead rows
    assert alive.tolist() == [True, True, False, False]
    assert d0[:2].tolist() == [8, 9] and v0[:2].tolist() == [True, False]
    assert d1.dtype == torch.int32 and v1[:2].all() and not v1[2:].any()
    assert sorted(reads) == [0, 1, 2]
    d = obs.counter_delta(before)
    if depth == 0:
        assert d.get("io.prefetch.hit", 0) == 0
        assert d.get("io.prefetch.miss", 0) == 3
    else:
        assert d.get("io.prefetch.hit", 0) >= 1


def test_ring_reset_stages_again():
    read, reads = _chunk_reader()
    ring = ChunkPrefetcher(read, 3, 4, "cpu", depth=2)
    try:
        first = [ring.get(i)[0].tolist() for i in range(3)]
        ring.reset(next_i=0)
        again = [ring.get(i)[0].tolist() for i in range(3)]
    finally:
        ring.close()
    assert first == again
    assert sorted(reads) == [0, 0, 1, 1, 2, 2]


def test_ring_degrades_under_the_prefetch_fault():
    read, _ = _chunk_reader()
    faults.install("io.prefetch:transient:1.0:seedF:times=1")
    before = obs.counters_snapshot()
    try:
        ring = ChunkPrefetcher(read, 3, 4, "cpu", depth=2)
        got = [ring.get(i)[0][:2].tolist() for i in range(3)]
        ring.close()
    finally:
        faults.uninstall()
    assert got == [[0, 1], [4, 5], [8, 9]]
    d = obs.counter_delta(before)
    assert d.get("io.prefetch.degraded", 0) == 1


# -- the chunked executor over the pipeline ---------------------------------------


@pytest.mark.parametrize("sql", [Q_AGG, Q_ROWS], ids=["agg", "rows"])
def test_prefetch_depths_identical(catalog, sql):
    """Depth 0/1/2 give the resident answer's rows in its order; the ring
    engages (hits at depth 2, none at depth 0) over >= 3 launches."""
    oracle = _oracle_rows(catalog, sql)
    for depth in (0, 1, 2):
        before = obs.counters_snapshot()
        got, exe = _chunked_rows(catalog, sql, depth=depth)
        chunked, n_launches = exe._chunk_info[0], exe._chunk_info[1]
        assert chunked and n_launches >= 3
        if sql is Q_ROWS:
            assert got == oracle, f"depth={depth}"
        else:
            assert sorted(got) == sorted(oracle), f"depth={depth}"
        d = obs.counter_delta(before)
        if depth == 0:
            assert d.get("io.prefetch.hit", 0) == 0
        assert d.get("engine.stream.execute_s", 0) > 0
        assert d.get("engine.stream.chunks", 0) == n_launches


def test_prefetch_fault_degrades_but_stays_correct(catalog):
    faults.install("io.prefetch:transient:1.0:seedF:times=1")
    before = obs.counters_snapshot()
    try:
        got, exe = _chunked_rows(catalog, Q_ROWS, depth=2)
    finally:
        faults.uninstall()
    assert exe._chunk_info[0]
    assert got == _oracle_rows(catalog, Q_ROWS)
    d = obs.counter_delta(before)
    assert d.get("io.prefetch.degraded", 0) >= 1
    assert d.get("faults.injected.io.prefetch.transient", 0) == 1


def test_scan_fault_degrades_but_stays_correct(catalog):
    faults.install("io.read:transient:1.0:seedR:times=1")
    before = obs.counters_snapshot()
    try:
        got, exe = _chunked_rows(catalog, Q_ROWS, depth=2)
    finally:
        faults.uninstall()
    assert exe._chunk_info[0]
    assert got == _oracle_rows(catalog, Q_ROWS)
    d = obs.counter_delta(before)
    assert d.get("io.scan.degraded", 0) >= 1
    assert d.get("faults.injected.io.read.transient", 0) == 1


def test_registered_stream_source_is_read(catalog):
    """A registered source serves the chunked scan (io.scan.bytes moves)
    with the resident answer, row order included."""
    src = loader.TableChunkSource(catalog.get("store_sales"), "store_sales",
                                  ["ss_item_sk", "ss_quantity"])
    loader.attach_stream_source(catalog, "store_sales", src)
    before = obs.counters_snapshot()
    try:
        got, exe = _chunked_rows(catalog, Q_ROWS, depth=1)
    finally:
        catalog.streams.pop("store_sales", None)
    assert exe._chunk_info[0]
    assert got == _oracle_rows(catalog, Q_ROWS)
    assert obs.counter_delta(before).get("io.scan.bytes", 0) > 0


# -- session and command-line settings --------------------------------------------


def test_session_stream_config_validation(catalog):
    for bad in (0, -5, True, "bogus", 3.5):
        with pytest.raises(ValueError):
            Session(catalog, device="cpu", spmd_chunk_rows=bad)
    for bad in (-1, True, 1.5):
        with pytest.raises(ValueError):
            Session(catalog, device="cpu", spmd_prefetch_depth=bad)
    s = Session(catalog, device="cpu", spmd_chunk_rows="auto",
                spmd_prefetch_depth=0)
    fresh = s.fresh()
    assert (fresh.spmd_chunk_rows, fresh.spmd_prefetch_depth) == ("auto", 0)


def test_session_auto_chunk_rows(catalog, monkeypatch):
    """spmd_chunk_rows='auto' sizes the stream from the (pinned) device
    budget and engages chunking when the fact exceeds it; the executor is
    cached and runs again."""
    monkeypatch.setenv("NDSTPU_HBM_BYTES", "200000")
    monkeypatch.setenv("NDSTPU_SPMD_STRICT", "1")
    sess = Session(catalog, device="cpu", spmd_threshold=500,
                   spmd_chunk_rows="auto")
    want = sorted(_oracle_rows(catalog, Q_AGG))
    assert sorted(map(str, sess.sql(Q_AGG).to_rows())) == want
    assert sess._spmd_used and not sess._spmd_errors
    assert any(ent[1]._chunk_info[0] for ent in sess._spmd_cache.values())
    before = obs.counters_snapshot()
    assert sorted(map(str, sess.sql(Q_AGG).to_rows())) == want
    d = obs.counter_delta(before)
    assert d.get("engine.cache.spmd.hit") == 1
    assert d.get("engine.spmd.reexecs") == 1


def test_power_spmd_properties(tmp_path):
    props = tmp_path / "e.properties"
    props.write_text("spmd.chunk_rows=4096\nspmd.threshold_rows=10\n")
    args = power.parse_args([
        "q.sql", "-", "t.csv", "--generate", "0.01", "--property_file",
        str(props), "--property", "spmd.chunk_rows=auto", "--property",
        "spmd.prefetch_depth=0"])
    conf = power.engine_properties(args)
    assert power.spmd_settings(conf) == {
        "spmd_threshold": 10, "spmd_chunk_rows": "auto",
        "spmd_prefetch_depth": 0}
    assert power.spmd_settings({}) == {}


def test_host_facts_keep_the_generator_values():
    a = datagen.generate(0.002, seed=1, device="cpu",
                         tables=["store_sales", "store_returns"])
    b = datagen.generate(0.002, seed=1, device="cpu",
                         tables=["store_sales", "store_returns"],
                         host_facts=True)
    for t in ("store_sales", "store_returns"):
        for c in a.get(t).column_names:
            x, y = a.get(t).column(c), b.get(t).column(c)
            assert torch.equal(x.data, y.data), (t, c)
            assert (x.valid is None) == (y.valid is None)
            assert y.data.device.type == "cpu"
    assert not b.on_host("store_sales", "cpu")
    assert b.on_host("store_sales", "cuda")
