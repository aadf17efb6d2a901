"""The decimals-as-doubles warehouse (the reference benchmark's
``--floats`` configuration) in the port: its generation, its loading, the
compile records of the decimal warehouse, and its out-of-core execution.

* ``datagen.generate(..., use_decimal=False)`` turns every DECIMAL column
  of the schema into FLOAT64, each value the double nearest the decimal:
  the value ``float(str(Decimal))`` parses, which is what the JAX
  package's ``transcode --floats`` reads from the CSV text; NULLs kept,
  resident and with the facts in host memory alike.
* ``io.loader.load_catalog(..., use_decimal=False)`` reads a ``transcode
  --floats`` warehouse as the JAX loader does.
* A decimal warehouse's compile records, preloaded into a floats session
  (whose canonical keys are the same), are dropped: each key rediscovers
  rather than replaying a size plan of other types.
* A few parts through the out-of-core executor as doubles, against the
  JAX package's chunked session over the same columns: the same rows
  (floats within 1e-5 relative) and the same fall-throughs (q5's union
  branches sum a float and a DECIMAL cast, NDS302 in both)."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
from decimal import Decimal

import numpy as np
import pytest
import torch

from ndstpu import obs as jax_obs
from ndstpu.engine.session import Session as JaxSession
from ndstpu.io import loader as jax_loader
from ndstpu_torch import datagen, obs
from ndstpu_torch.engine.columnar import Column
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from ndstpu_torch.io import loader
from ndstpu_torch.schema import get_schemas
from test_jaxexec import assert_tables_match
from test_torch_corpus_common import SQL, jax_catalog
from test_torch_floats_common import jax_floats_warehouse

SCALE = 0.01


def _money_columns(table: str):
    return [c.name for c in get_schemas()[table].columns
            if c.dtype.kind == "decimal"]


@pytest.fixture(scope="module")
def store_sales():
    """(decimal table, floats table) of store_sales at SCALE."""
    args = dict(seed=1, device="cpu", tables=["store_sales"])
    return (datagen.generate(SCALE, **args).get("store_sales"),
            datagen.generate(SCALE, use_decimal=False,
                             **args).get("store_sales"))


def test_every_money_value_is_the_nearest_double(store_sales):
    dec, flt = store_sales
    money = _money_columns("store_sales")
    assert len(money) == 12
    for name in money:
        d, f = dec.column(name), flt.column(name)
        assert f.ctype.kind == "float64" and f.data.dtype == torch.float64
        valid = np.ones(len(d.data), bool) if d.valid is None \
            else d.valid.numpy()
        assert (f.valid is None) == (d.valid is None)
        if f.valid is not None:
            assert torch.equal(f.valid, d.valid)
        scale = d.ctype.scale
        want = np.array([float(str(Decimal(int(u)).scaleb(-scale)))
                         for u in d.data.numpy()[valid]])
        got = f.data.numpy()[valid]
        assert np.array_equal(want.view(np.int64), got.view(np.int64)), name


def test_other_columns_keep_their_types_and_values(store_sales):
    dec, flt = store_sales
    for name in dec.column_names:
        if dec.column(name).ctype.kind != "decimal":
            assert flt.column(name).ctype == dec.column(name).ctype
            assert torch.equal(flt.column(name).data, dec.column(name).data)


def test_host_facts_as_doubles():
    """The out-of-core warehouse holds doubles too: the same values."""
    args = dict(seed=1, device="cpu", tables=["store_sales", "item"],
                use_decimal=False)
    resident = datagen.generate(0.002, **args)
    host = datagen.generate(0.002, host_facts=True, **args)
    for name in ("store_sales", "item"):
        a, b = resident.get(name), host.get(name)
        for c in a.column_names:
            assert a.column(c).ctype == b.column(c).ctype
            assert torch.equal(a.column(c).data, b.column(c).data), c
    assert host.get("store_sales").column(
        "ss_net_paid").ctype.kind == "float64"


def test_a_value_past_2_53_is_refused():
    col = datagen.generate(0.002, seed=1, device="cpu",
                           columns={"store_sales": ["ss_net_paid"]}
                           ).get("store_sales").column("ss_net_paid")
    big = Column(torch.tensor([1 << 53, 5]), col.ctype)
    with pytest.raises(ValueError, match="2\\*\\*53"):
        datagen.as_doubles(big, "store_sales.ss_net_paid")
    assert datagen.as_doubles(
        Column(torch.tensor([(1 << 53) - 1]), col.ctype)).data.item() == \
        float((1 << 53) - 1) / 100


def test_load_catalog_reads_a_floats_warehouse_as_the_jax_loader(
        tmp_path_factory):
    wh = str(jax_floats_warehouse(tmp_path_factory))
    want = jax_loader.load_catalog(wh, use_decimal=False)
    got = loader.load_catalog(wh, use_decimal=False)
    assert sorted(got.tables) == sorted(want.tables)
    doubles = 0
    for name, table in want.tables.items():
        mine = got.get(name)
        assert mine.column_names == table.column_names
        for c in table.column_names:
            a, b = table.column(c), mine.column(c)
            assert (a.ctype.kind, a.ctype.precision, a.ctype.scale) == \
                (b.ctype.kind, b.ctype.precision, b.ctype.scale), c
            doubles += a.ctype.kind == "float64"
            assert a.to_pylist() == b.to_pylist(), (name, c)
    assert doubles == sum(len(_money_columns(t)) for t in want.tables)


def test_decimal_compile_records_rediscover_in_a_floats_session(tmp_path):
    """The canonical keys of the two warehouses are the same; a record
    names its tables' column types, so none loads and each key
    discovers, with the floats answers."""
    names = ["query3", "query7", "query28", "query42"]
    dec = Session(datagen.generate(0.002, seed=1, device="cpu"),
                  device="cpu")
    cat = datagen.generate(0.002, seed=1, device="cpu", use_decimal=False)
    flt, fresh = Session(cat, device="cpu"), Session(cat, device="cpu")
    for n in names:
        dec.sql(SQL[n])
        assert dec.canonical_key(SQL[n]) == flt.canonical_key(SQL[n])
    path = str(tmp_path / "records.pkl")
    assert dec.save_compiled(path) == len(names)
    assert flt.preload_compiled(path) == 0
    exe = flt.executor
    for n in names:
        before = exe.n_discoveries
        got = flt.sql(SQL[n])
        assert exe.n_discoveries == before + 1, n
        assert_tables_match(fresh.sql(SQL[n]), got, ordered=True)
    # the floats session's own records load back into a floats session
    flt.save_compiled(str(tmp_path / "floats.pkl"))
    assert Session(cat, device="cpu").preload_compiled(
        str(tmp_path / "floats.pkl")) == len(names)


CHUNKED = ["query3", "query5", "query7", "query42", "query71", "query98"]


@pytest.fixture(scope="module")
def chunked():
    cat = datagen.generate(SCALE, seed=1, device="cpu", use_decimal=False)
    js = JaxSession(jax_catalog(cat), backend="tpu", spmd_threshold=500,
                    spmd_chunk_rows=1000)
    js._jax_executor().warm_replay = False
    return js, Session(cat, device="cpu", spmd_threshold=500,
                       spmd_chunk_rows=1000)


def _fallbacks(moved) -> dict:
    return {k: v for k, v in moved.items()
            if k.startswith("engine.spmd.fallback.")}


@pytest.mark.parametrize("name", CHUNKED)
def test_chunked_as_doubles_against_jax(chunked, name):
    js, ts = chunked
    sql = SQL[name]
    jax_obs.reset(enabled=True)
    want = js.sql(sql)
    jax_moved = jax_obs.counters_snapshot()
    obs.reset(enabled=True)
    got = ts.sql(sql)
    moved = obs.counters_snapshot()
    assert _fallbacks(moved) == _fallbacks(jax_moved)
    if name == "query5":
        assert _fallbacks(moved) == {"engine.spmd.fallback.NDS302": 1}
    else:
        assert not _fallbacks(moved)
        assert ts.last_spmd is not None and any(
            launches >= 2 for *_, launches, _why in ts.last_spmd.streams)
    assert want.column_names == got.column_names
    assert_tables_match(want, got, ordered=fixes_order(ts.plan(sql)[0]))


def test_card_float_sums_add_in_a_fixed_order():
    """The card's float64 grouped sum over many segments (``fp64``: a
    stable sort by segment, then two fixed-order levels of reductions;
    its torch ops run here on CPU tensors) equals ``index_add_``'s sums,
    keeps empty segments at 0 and is bit-identical from run to run."""
    from ndstpu_torch.engine import fp64
    gen = torch.Generator().manual_seed(7)
    gid = torch.randint(0, 300, (20_000,), generator=gen)
    gid[gid == 17] = 18                         # one empty segment
    x = torch.randint(-10**7, 10**7, (20_000,), generator=gen,
                      dtype=torch.float64) / 100.0
    want = torch.zeros(301, dtype=torch.float64).index_add_(0, gid, x)
    runs = [fp64._reduce(x, *fp64._fixed_order(gid, 301)) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    assert torch.allclose(runs[0], want, rtol=1e-12, atol=1e-9)
    assert runs[0][17] == 0 and runs[0][300] == 0


@pytest.mark.parametrize("segments", [1, 2, 5, 9])
def test_card_float_sums_long_and_few_segments(segments):
    """Segments longer than ``fp64.PIECE_ROWS`` rows (cut into pieces,
    one empty segment between them) and the masked sums of up to
    ``fp64.FEW_SEGMENTS`` segments equal ``index_add_``'s sums to 1e-12
    relative, bit-identical from run to run."""
    from ndstpu_torch.engine import fp64
    gen = torch.Generator().manual_seed(segments)
    n = 3 * fp64.PIECE_ROWS * segments + 17
    gid = torch.randint(0, segments, (n,), generator=gen)
    if segments > 2:
        gid[gid == 1] = 0                       # one empty segment
    x = torch.randint(-10**7, 10**7, (n,), generator=gen,
                      dtype=torch.float64) / 100.0
    want = torch.zeros(segments, dtype=torch.float64).index_add_(0, gid, x)
    if segments <= fp64.FEW_SEGMENTS:
        runs = [fp64._few(x, gid, segments) for _ in range(2)]
    else:
        order = fp64._fixed_order(gid, segments)
        assert int(order[1].max()) == fp64.PIECE_ROWS
        assert int(order[1].sum()) == n
        runs = [fp64._reduce(x, *order) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.allclose(runs[0], want, rtol=1e-12, atol=1e-9)
    if segments > 2:
        assert runs[0][1] == 0
