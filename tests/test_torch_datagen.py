"""The port's on-device generator, checked on the CPU at a small scale.

Row counts must equal the JAX package's C++ generator (``ndsgen -sizes``)
at the spec's step scales; the distributions follow its ``gen_sale``,
``gen_return``, ``gen_inventory`` and dimension ``gen_*`` models.  Counts
and keys are exact; shares are checked within four standard errors of
the model's value."""

import subprocess

import numpy as np
import pytest
import torch

from ndstpu.check import check_build
from ndstpu_torch import datagen
from ndstpu_torch.datagen import dims, model
from ndstpu_torch.engine.torchexec import civil_from_days
from ndstpu_torch.schema import get_schemas

_JD_EPOCH_1970 = 2440588


@pytest.fixture(scope="module")
def cat():
    return datagen.generate(0.2, seed=11, device="cpu")


@pytest.fixture(scope="module")
def cat_again():
    """A second warehouse from ``cat``'s seed, for reproducibility."""
    return datagen.generate(0.2, seed=11, device="cpu")


@pytest.mark.parametrize("sf", [1, 10, 100])
def test_row_counts_match_ndsgen(sf):
    out = subprocess.run([str(check_build()), "-sizes", str(sf)],
                         capture_output=True, text=True, check=True).stdout
    want = {ln.split("|")[0]: int(ln.split("|")[1])
            for ln in out.strip().splitlines()}
    got = datagen.sizes(sf)
    for table in ("store_sales", "item", "date_dim"):
        assert got[table] == want[table], table


_NEW_TABLES = ("store_returns", "store", "reason", "household_demographics",
               "time_dim", "customer")


@pytest.mark.parametrize("sf", [0.2, 1, 10, 100])
@pytest.mark.parametrize("table", _NEW_TABLES)
def test_store_channel_row_counts_match_ndsgen(sf, table, ndsgen_sizes):
    assert datagen.sizes(sf)[table] == ndsgen_sizes(sf)[table]


@pytest.fixture(scope="module")
def ndsgen_sizes():
    memo = {}

    def sizes(sf):
        if sf not in memo:
            out = subprocess.run([str(check_build()), "-sizes", str(sf)],
                                 capture_output=True, text=True,
                                 check=True).stdout
            memo[sf] = {ln.split("|")[0]: int(ln.split("|")[1])
                        for ln in out.strip().splitlines()}
        return memo[sf]
    return sizes


def _share_ok(share, p, n):
    return abs(share - p) < 4 * np.sqrt(p * (1 - p) / n)


def test_store_sales_keys_and_nulls(cat):
    """gen_sale's ranges: uniform time of day, hdemo and store keys; Zipf
    customers; 3% NULL customers and 2% NULL stores; three rows a
    ticket; the cent arithmetic of sales, discount and net paid."""
    n = datagen.sizes(0.2)
    ss = cat.get("store_sales")
    rows = ss.num_rows
    col = ss.column
    t = col("ss_sold_time_sk").data
    assert int(t.min()) >= 0 and int(t.max()) <= 86399
    h = col("ss_hdemo_sk").data
    assert int(h.min()) >= 1 and int(h.max()) <= 7200
    st = col("ss_store_sk")
    assert int(st.data.min()) >= 1 and int(st.data.max()) <= n["store"]
    assert _share_ok(1 - float(st.valid.double().mean()), 0.02, rows)
    cu = col("ss_customer_sk")
    assert int(cu.data.min()) >= 1 and int(cu.data.max()) <= n["customer"]
    assert _share_ok(1 - float(cu.valid.double().mean()), 0.03, rows)
    counts = torch.bincount(cu.data.long()).sort(descending=True).values
    top = counts[: max(1, n["customer"] // 100)].sum()
    assert float(top) / rows > 0.3                   # Zipf-skewed
    tk = col("ss_ticket_number").data
    assert tk.dtype == torch.int64
    assert torch.equal(tk, torch.arange(rows) // 3 + 1)
    q = col("ss_quantity").data
    assert int(q.min()) >= 1 and int(q.max()) <= 100
    sales = col("ss_sales_price").data
    ext = col("ss_ext_sales_price").data
    assert torch.equal(ext, q * sales)
    assert int(sales.min()) >= 20 and int(sales.max()) <= 20000
    disc = col("ss_ext_discount_amt").data
    assert int(disc.min()) >= 0                      # list >= sales
    paid = col("ss_net_paid").data
    coupon = ext - paid
    assert bool((coupon >= 0).all()) and bool((2 * coupon <= ext).all())
    # 15% carry a coupon; a few of those draw a zero coupon
    share = float((coupon > 0).double().mean())
    assert 0.13 < share <= 0.15 + 4 * np.sqrt(0.15 * 0.85 / rows)


def test_returns_reference_their_sales(cat):
    """Every (sr_item_sk, sr_ticket_number) is a store_sales row, the
    parent return_parent_row names; the return quantity is at most that
    sale's quantity; reasons are uniform over the reason table."""
    ss, sr = cat.get("store_sales"), cat.get("store_returns")
    parent = datagen.return_parent_rows(sr.num_rows, ss.num_rows, "cpu")
    assert int(parent.max()) < ss.num_rows
    item = sr.column("sr_item_sk").data
    ticket = sr.column("sr_ticket_number").data
    assert torch.equal(item, ss.column("ss_item_sk").data[parent])
    assert torch.equal(ticket, ss.column("ss_ticket_number").data[parent])
    pairs = set(zip(ss.column("ss_item_sk").data.tolist(),
                    ss.column("ss_ticket_number").data.tolist()))
    assert set(zip(item.tolist(), ticket.tolist())) <= pairs
    rq = sr.column("sr_return_quantity").data
    assert int(rq.min()) >= 1
    assert bool((rq <= ss.column("ss_quantity").data[parent]).all())
    reason = sr.column("sr_reason_sk").data
    n_reason = cat.get("reason").num_rows
    assert int(reason.min()) >= 1 and int(reason.max()) <= n_reason
    assert torch.bincount(reason.long()).shape[0] == n_reason + 1


def test_dimension_models(cat):
    """gen_store, gen_reason, gen_household_demographics, gen_time_dim and
    the date_dim day names."""
    store = cat.get("store")
    name = store.column("s_store_name")
    assert all(str(v).endswith(" Store") for v in name.dictionary)
    ids = store.column("s_store_id")
    assert list(ids.dictionary[ids.data.numpy()]) == [
        datagen.bkey(i) for i in range(1, store.num_rows + 1)]
    assert datagen.bkey(1) == "AAAAAAAAAAAAAAAB"
    assert set(store.column("s_gmt_offset").data.tolist()) <= {-500, -600}
    # SF 100's 55 reasons: the descriptions cycle through the 35 entries
    desc = dims.reason(55, "cpu")["r_reason_desc"]
    got = desc.dictionary[desc.data.numpy()]
    assert got[0] == "Package was damaged"
    assert got[34] == "reason 35" and got[35] == "Package was damaged"
    hd = cat.get("household_demographics")
    dep = hd.column("hd_dep_count").data
    assert sorted(set(dep.tolist())) == list(range(10))
    assert int((dep == 3).sum()) == 720
    assert set(hd.column("hd_vehicle_count").data.tolist()) == set(range(6))
    td = cat.get("time_dim")
    sk = td.column("t_time_sk").data.long()
    assert torch.equal(sk, torch.arange(86400))
    assert torch.equal(td.column("t_hour").data * 3600 +
                       td.column("t_minute").data * 60 +
                       td.column("t_second").data, sk)
    dd = cat.get("date_dim")
    day = dd.column("d_day_name")
    days = dd.column("d_date_sk").data.numpy().astype(np.int64) - \
        _JD_EPOCH_1970
    want = [["Thursday", "Friday", "Saturday", "Sunday", "Monday",
             "Tuesday", "Wednesday"][d % 7] for d in days]
    assert list(day.dictionary[day.data.numpy()]) == want


def test_generated_row_counts(cat):
    """The whole warehouse has every table with every schema column, in
    schema order; ``columns=COLUMNS`` gives the store channel's columns in
    their order."""
    n = datagen.sizes(0.2)
    assert set(cat.tables) == set(get_schemas())
    for table, schema in get_schemas().items():
        t = cat.get(table)
        assert t.num_rows == n[table]
        assert t.column_names == schema.column_names
    part = datagen.generate(0.01, seed=11, device="cpu",
                            columns=datagen.COLUMNS)
    for table, cols in datagen.COLUMNS.items():
        assert part.get(table).column_names == list(cols)


def test_key_ranges_and_dense_keys(cat):
    ss, item, dd = (cat.get(t) for t in ("store_sales", "item", "date_dim"))
    n_item = item.num_rows
    isk = ss.column("ss_item_sk").data
    assert int(isk.min()) >= 1 and int(isk.max()) <= n_item
    d = ss.column("ss_sold_date_sk")
    dv = d.data[d.valid]
    assert int(dv.min()) >= 2450816 and int(dv.max()) <= 2452642
    price = ss.column("ss_ext_sales_price").data
    # quantity 1..100 x sales <= 2 x wholesale <= 200.00
    assert int(price.min()) >= 20 and int(price.max()) <= 100 * 20000
    assert cat.meta["item"].dense_key == "i_item_sk"
    assert cat.meta["date_dim"].dense_key == "d_date_sk"
    assert int(item.column("i_manufact_id").data.min()) >= 1
    assert int(item.column("i_manufact_id").data.max()) <= 1000
    assert int(item.column("i_manager_id").data.max()) <= 100
    assert int(dd.column("d_date_sk").data[0]) == 2415022


def test_null_and_holiday_shares(cat):
    d = cat.get("store_sales").column("ss_sold_date_sk")
    n = d.data.shape[0]
    null_share = 1 - float(d.valid.double().mean())
    assert abs(null_share - 0.02) < 4 * np.sqrt(0.02 * 0.98 / n)
    _, m, _ = civil_from_days(d.data[d.valid].long() -
                                      _JD_EPOCH_1970)
    novdec = float((m >= 11).double().mean())
    # 30% moved into Nov/Dec, plus the uniform draws that land there
    days = 2452642 - 2450816 + 1
    in_window = sum(1 for j in range(days) if civil_from_days(
        torch.tensor([2450816 + j - _JD_EPOCH_1970]))[1].item() >= 11)
    want = 0.30 + 0.70 * in_window / days
    assert abs(novdec - want) < 4 * np.sqrt(want * (1 - want) / n)


def test_item_skew_and_calendar(cat):
    """Zipf item keys: the hottest 1% of items carry far more than 1% of
    sales; the calendar matches numpy's."""
    isk = cat.get("store_sales").column("ss_item_sk").data.long()
    counts = torch.bincount(isk).sort(descending=True).values
    top = counts[: max(1, counts.shape[0] // 100)].sum()
    assert float(top) / float(counts.sum()) > 0.3
    dd = cat.get("date_dim")
    days = dd.column("d_date_sk").data.numpy().astype(np.int64) - \
        _JD_EPOCH_1970
    dates = days.astype("datetime64[D]")
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    months = dates.astype("datetime64[M]").astype(int) % 12 + 1
    np.testing.assert_array_equal(dd.column("d_year").data.numpy(), years)
    np.testing.assert_array_equal(dd.column("d_moy").data.numpy(), months)


def test_brand_id_decodes(cat):
    """brand_id = (cat+1)*10^6 + (cls+1)*10^3 + brand, and i_brand is
    '<class> #<brand>' of the same class and brand."""
    item = cat.get("item")
    bid = item.column("i_brand_id").data.numpy()
    cat_id = item.column("i_category_id").data.numpy()
    brand = item.column("i_brand")
    names = brand.dictionary[brand.data.numpy()]
    category = item.column("i_category")
    cat_names = category.dictionary[category.data.numpy()]
    assert (bid // 1000000 == cat_id).all()
    for b, name, cname, cid in zip(bid, names, cat_names, cat_id):
        cls, num = name.rsplit(" #", 1)
        assert model.CLASSES[(b // 1000) % 1000 - 1] == cls
        assert b % 1000 == int(num) and 1 <= int(num) <= 10
        assert model.CATEGORIES[cid - 1] == cname
    # the weighted category pick: Women (18%) outnumbers Books (6%)
    assert (cat_names == "Women").sum() > 2 * (cat_names == "Books").sum()


def test_same_seed_same_data():
    a = datagen.generate(0.01, seed=5, device="cpu")
    b = datagen.generate(0.01, seed=5, device="cpu")
    c = datagen.generate(0.01, seed=6, device="cpu")
    col = "ss_ext_sales_price"
    for table, cols in datagen.COLUMNS.items():
        for name in cols:
            x, y = a.get(table).column(name), b.get(table).column(name)
            assert torch.equal(x.data, y.data), (table, name)
            assert (x.valid is None) == (y.valid is None)
            if x.valid is not None:
                assert torch.equal(x.valid, y.valid)
    assert not torch.equal(a.get("store_sales").column(col).data,
                           c.get("store_sales").column(col).data)


# the columns the store window and rollup reports (q36, q47, q67, q89,
# q98) read, with their schema kinds
_REPORT_COLUMNS = {
    ("item", "i_class"): "string",
    ("item", "i_current_price"): "decimal",
    ("item", "i_item_desc"): "string",
    ("item", "i_item_id"): "string",
    ("item", "i_product_name"): "string",
    ("store", "s_state"): "string",
    ("store", "s_company_name"): "string",
    ("date_dim", "d_date"): "date",
    ("date_dim", "d_qoy"): "int64",
    ("date_dim", "d_month_seq"): "int64",
    ("store_sales", "ss_net_profit"): "decimal",
}


@pytest.mark.parametrize("table,column", list(_REPORT_COLUMNS))
def test_report_columns_typed_and_reproducible(cat, cat_again, table,
                                               column):
    """Each new column has its schema type, no NULLs, and the same values
    and dictionary from the same seed."""
    c = cat.get(table).column(column)
    assert c.ctype.kind == _REPORT_COLUMNS[(table, column)]
    assert c.ctype == model.ctype(table, column)
    assert c.valid is None
    again = cat_again.get(table).column(column)
    assert torch.equal(c.data, again.data)
    if c.dictionary is not None:
        assert list(c.dictionary) == list(again.dictionary)
        assert list(c.dictionary) == sorted(c.dictionary)
        assert int(c.data.min()) >= 0
        assert int(c.data.max()) < len(c.dictionary)


def test_report_column_models(cat):
    """gen_item's class, business key, description, price and product
    name; gen_store's state and company; gen_date_dim's date, quarter and
    month sequence; gen_sale's net profit."""
    item = cat.get("item")
    n = item.num_rows

    def strings(col):
        c = item.column(col)
        return c.dictionary[c.data.numpy()]

    brand = strings("i_brand")
    assert [b.rsplit(" #", 1)[0] for b in brand] == list(strings("i_class"))
    assert list(strings("i_item_id")) == [datagen.bkey(i)
                                          for i in range(1, n + 1)]
    for sk, (desc, name) in enumerate(zip(strings("i_item_desc"),
                                          strings("i_product_name")), 1):
        words = desc.split(" ")
        assert 5 <= len(words) <= 20
        assert set(words) <= set(model.WORDS)
        assert name.endswith(str(sk))
        assert name[:-len(str(sk))] in model.COLORS
    price = item.column("i_current_price").data
    assert int(price.min()) >= 100 and int(price.max()) <= 10000
    store = cat.get("store")
    states = store.column("s_state")
    assert set(states.dictionary) <= set(model.STORE_STATES[0])
    assert set(store.column("s_company_name").dictionary) <= {
        "Company 1", "Company 2"}
    dd = cat.get("date_dim")
    days = dd.column("d_date_sk").data.numpy().astype(np.int64) - \
        _JD_EPOCH_1970
    np.testing.assert_array_equal(dd.column("d_date").data.numpy(), days)
    y = dd.column("d_year").data.numpy()
    m = dd.column("d_moy").data.numpy()
    np.testing.assert_array_equal(dd.column("d_qoy").data.numpy(),
                                  (m - 1) // 3 + 1)
    np.testing.assert_array_equal(dd.column("d_month_seq").data.numpy(),
                                  (y - 1900) * 12 + m - 1)
    # q67's month window 1193..1204 is June 1999 .. May 2000
    seq = dd.column("d_month_seq").data.numpy()
    assert (y[seq == 1193] == 1999).all() and (m[seq == 1193] == 6).all()
    ss = cat.get("store_sales")
    profit = ss.column("ss_net_profit").data
    paid = ss.column("ss_net_paid").data
    q = ss.column("ss_quantity").data
    wholesale_ext = paid - profit
    # the extended wholesale cost: quantity x 1.00 .. 100.00
    assert bool((wholesale_ext % q == 0).all())
    per_unit = wholesale_ext // q
    assert int(per_unit.min()) >= 100 and int(per_unit.max()) <= 10000
    # sales <= list <= 2 x wholesale
    assert bool((ss.column("ss_sales_price").data <= 2 * per_unit).all())


# every column generated before the set-operation reports' columns were
# added, and the digest of their values at SF 0.01, seed 5, on the CPU,
# taken before that change: the earlier paths read the same data
_EARLIER_COLUMNS = {
    "date_dim": ("d_date_sk", "d_date", "d_month_seq", "d_year", "d_moy",
                 "d_qoy", "d_day_name"),
    "item": ("i_item_sk", "i_item_id", "i_item_desc", "i_current_price",
             "i_brand_id", "i_brand", "i_class", "i_category_id",
             "i_category", "i_manufact_id", "i_manager_id",
             "i_product_name"),
    "store_sales": ("ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk",
                    "ss_customer_sk", "ss_hdemo_sk", "ss_store_sk",
                    "ss_ticket_number", "ss_quantity", "ss_sales_price",
                    "ss_ext_discount_amt", "ss_ext_sales_price",
                    "ss_net_paid", "ss_net_profit"),
    "store_returns": ("sr_item_sk", "sr_reason_sk", "sr_ticket_number",
                      "sr_return_quantity"),
    "store": ("s_store_sk", "s_store_id", "s_store_name", "s_company_name",
              "s_state", "s_gmt_offset"),
    "reason": ("r_reason_sk", "r_reason_id", "r_reason_desc"),
    "household_demographics": ("hd_demo_sk", "hd_income_band_sk",
                               "hd_buy_potential", "hd_dep_count",
                               "hd_vehicle_count"),
    "time_dim": ("t_time_sk", "t_time", "t_hour", "t_minute", "t_second"),
}
_EARLIER_DIGEST = \
    "2a00563c39f6f162275b92640bfe7200279f4066652558a45ccaa6a523bf48b4"


def test_earlier_columns_keep_their_values():
    import hashlib
    cat = datagen.generate(0.01, seed=5, device="cpu")
    h = hashlib.sha256()
    for table, cols in _EARLIER_COLUMNS.items():
        for name in cols:
            c = cat.get(table).column(name)
            h.update(f"{table}.{name}".encode())
            h.update(c.data.numpy().tobytes())
            if c.valid is not None:
                h.update(c.valid.numpy().tobytes())
            if c.dictionary is not None:
                h.update("\0".join(map(str, c.dictionary)).encode())
    assert h.hexdigest() == _EARLIER_DIGEST


# the digest of every store-channel column (``datagen.COLUMNS``, the
# earlier card paths' columns) at SF 0.01, seed 5, on the CPU, taken with
# the generator that made only those columns, before every schema column
# was generated
_STORE_CHANNEL_DIGEST = \
    "e7183defcbc3e9c225c1e6283898715563d3e37377671ff9f561bc0fd5faa273"


@pytest.mark.parametrize("ask", ["whole", "columns"])
def test_store_channel_columns_keep_their_values(ask):
    import hashlib
    kw = {"columns": datagen.COLUMNS} if ask == "columns" else {}
    cat = datagen.generate(0.01, seed=5, device="cpu", **kw)
    h = hashlib.sha256()
    for table, cols in datagen.COLUMNS.items():
        for name in cols:
            c = cat.get(table).column(name)
            h.update(f"{table}.{name}".encode())
            h.update(c.data.numpy().tobytes())
            if c.valid is not None:
                h.update(c.valid.numpy().tobytes())
            if c.dictionary is not None:
                h.update("\0".join(map(str, c.dictionary)).encode())
    assert h.hexdigest() == _STORE_CHANNEL_DIGEST


@pytest.mark.parametrize("sf", [0.2, 1, 10, 100])
@pytest.mark.parametrize("table", ["catalog_sales", "web_sales",
                                   "customer_address"])
def test_channel_row_counts_match_ndsgen(sf, table, ndsgen_sizes):
    assert datagen.sizes(sf)[table] == ndsgen_sizes(sf)[table]


# the columns the set-operation and distinct reports (q2, q28, q41, q76)
# read, with their schema kinds and whether the model has NULLs
_SETOP_COLUMNS = {
    ("date_dim", "d_week_seq"): ("int64", False),
    ("item", "i_manufact"): ("string", False),
    ("item", "i_color"): ("string", False),
    ("item", "i_units"): ("string", False),
    ("item", "i_size"): ("string", False),
    ("store_sales", "ss_wholesale_cost"): ("decimal", False),
    ("store_sales", "ss_list_price"): ("decimal", False),
    ("store_sales", "ss_coupon_amt"): ("decimal", False),
    ("catalog_sales", "cs_sold_date_sk"): ("int32", True),
    ("catalog_sales", "cs_ship_addr_sk"): ("int32", False),
    ("catalog_sales", "cs_item_sk"): ("int32", False),
    ("catalog_sales", "cs_ext_sales_price"): ("decimal", False),
    ("web_sales", "ws_sold_date_sk"): ("int32", True),
    ("web_sales", "ws_item_sk"): ("int32", False),
    ("web_sales", "ws_ship_customer_sk"): ("int32", True),
    ("web_sales", "ws_ext_sales_price"): ("decimal", False),
}


@pytest.mark.parametrize("table,column", list(_SETOP_COLUMNS))
def test_setop_columns_typed_and_reproducible(cat, cat_again, table,
                                              column):
    """Each column has its schema type, NULLs only where its model has
    them, and the same values and dictionary from the same seed."""
    kind, nulls = _SETOP_COLUMNS[(table, column)]
    c = cat.get(table).column(column)
    assert c.ctype.kind == kind
    assert c.ctype == model.ctype(table, column)
    assert (c.valid is not None) == nulls
    again = cat_again.get(table).column(column)
    assert torch.equal(c.data, again.data)
    if nulls:
        assert torch.equal(c.valid, again.valid)
    if c.dictionary is not None:
        assert list(c.dictionary) == list(again.dictionary)
        assert list(c.dictionary) == sorted(c.dictionary)
        assert int(c.data.min()) >= 0
        assert int(c.data.max()) < len(c.dictionary)


def test_setop_item_and_calendar_models(cat):
    """i_manufact names the same row's i_manufact_id; color, units and
    size come from their lists (colors weighted); d_week_seq counts weeks
    from 1900-01-02, as a direct calendar computation gives it."""
    item = cat.get("item")

    def strings(col):
        c = item.column(col)
        return c.dictionary[c.data.numpy()]

    ids = item.column("i_manufact_id").data.numpy()
    assert list(strings("i_manufact")) == [f"manu#{m}" for m in ids]
    color = strings("i_color")
    assert set(color) <= set(model.COLORS)
    # weight 12 against weight 1
    assert (color == "red").sum() > 3 * (color == "linen").sum()
    assert set(strings("i_units")) == set(model.UNITS)
    assert set(strings("i_size")) == set(model.SIZES)
    n = item.num_rows
    for col, pool in (("i_units", model.UNITS),
                      ("i_size", model.SIZES)):
        share = float((strings(col) == pool[0]).mean())
        assert _share_ok(share, 1 / len(pool), n), col
    dd = cat.get("date_dim")
    days = dd.column("d_date_sk").data.numpy().astype(np.int64) - \
        _JD_EPOCH_1970
    first = (np.datetime64("1900-01-02") -
             np.datetime64("1970-01-01")).astype(np.int64)
    np.testing.assert_array_equal(dd.column("d_week_seq").data.numpy(),
                                  (days - first) // 7 + 1)


def test_setop_store_sales_models(cat):
    """The wholesale cost, list price and coupon are the ones net paid and
    net profit were computed from."""
    ss = cat.get("store_sales")
    col = lambda c: ss.column(c).data  # noqa: E731
    wholesale, lst, coupon = (col("ss_wholesale_cost"), col("ss_list_price"),
                              col("ss_coupon_amt"))
    q, sales, ext = (col("ss_quantity"), col("ss_sales_price"),
                     col("ss_ext_sales_price"))
    assert int(wholesale.min()) >= 100 and int(wholesale.max()) <= 10000
    assert bool((lst >= wholesale).all())
    assert bool((lst <= 2 * wholesale).all())
    # 20..100% of list, rounded down to the cent
    assert bool((sales <= lst).all()) and bool((5 * sales > lst - 5).all())
    assert torch.equal(col("ss_net_paid"), ext - coupon)
    assert torch.equal(col("ss_net_profit"), ext - coupon - q * wholesale)
    assert torch.equal(col("ss_ext_discount_amt"), q * lst - ext)
    share = float((coupon > 0).double().mean())
    assert 0.13 < share <= 0.15 + 4 * np.sqrt(0.15 * 0.85 / len(q))


@pytest.mark.parametrize("table", ["catalog_sales", "web_sales"])
def test_channel_sales_models(cat, table):
    """gen_sale's dates (2% NULL, inside the sales window), Zipf items and
    cent arithmetic; catalog ship-to addresses uniform and never NULL,
    web ship-to customers NULL with the sale's customer (3%)."""
    n = datagen.sizes(0.2)
    t = cat.get(table)
    p = table[0] + "s_"
    rows = t.num_rows
    assert rows == n[table]
    d = t.column(p + "sold_date_sk")
    assert _share_ok(1 - float(d.valid.double().mean()), 0.02, rows)
    dv = d.data[d.valid]
    assert int(dv.min()) >= 2450816 and int(dv.max()) <= 2452642
    isk = t.column(p + "item_sk").data.long()
    assert int(isk.min()) >= 1 and int(isk.max()) <= n["item"]
    counts = torch.bincount(isk).sort(descending=True).values
    assert float(counts[: n["item"] // 100].sum()) / rows > 0.3
    ext = t.column(p + "ext_sales_price").data
    assert int(ext.min()) >= 20 and int(ext.max()) <= 100 * 20000
    if table == "catalog_sales":
        addr = t.column("cs_ship_addr_sk")
        assert addr.valid is None
        assert int(addr.data.min()) >= 1
        assert int(addr.data.max()) <= n["customer_address"]
        low = float((addr.data <= n["customer_address"] // 2).double()
                    .mean())
        assert _share_ok(low, 0.5, rows)
    else:
        cu = t.column("ws_ship_customer_sk")
        assert _share_ok(1 - float(cu.valid.double().mean()), 0.03, rows)
        assert int(cu.data.min()) >= 1
        assert int(cu.data.max()) <= n["customer"]


# ---------------------------------------------------------------------------
# the whole warehouse: 25 tables, 429 columns


@pytest.mark.parametrize("sf", [1, 10, 100])
@pytest.mark.parametrize("table", sorted(set(get_schemas()) -
                                         {"dbgen_version"}))
def test_every_table_row_count_matches_ndsgen(sf, table, ndsgen_sizes):
    assert datagen.sizes(sf)[table] == ndsgen_sizes(sf)[table]


def test_whole_warehouse_has_every_schema_column():
    """25 tables, 429 columns."""
    schemas = get_schemas()
    assert len(schemas) == 25
    assert sum(len(s.column_names) for s in schemas.values()) == 429
    assert datagen.TABLES == tuple(schemas)


@pytest.mark.parametrize("table", list(get_schemas()))
def test_columns_have_their_schema_types(cat, table):
    """Each column's type is its schema type, its data the engine's
    storage dtype for it, strings coded into their sorted dictionary, and
    NULLs only where the model has them."""
    from ndstpu_torch.engine.columnar import numpy_dtype
    t = cat.get(table)
    for spec in get_schemas()[table].columns:
        c = t.column(spec.name)
        assert c.ctype.kind == spec.dtype.kind, spec.name
        assert (c.ctype.precision, c.ctype.scale) == (
            spec.dtype.precision, spec.dtype.scale), spec.name
        assert c.data.numpy().dtype == np.dtype(numpy_dtype(c.ctype)), \
            spec.name
        assert len(c.data) == t.num_rows
        assert (c.valid is not None) == (spec.name in _NULLABLE), spec.name
        if c.ctype.kind == "string":
            d = list(c.dictionary)
            assert d == sorted(d), spec.name
            codes = c.data if c.valid is None else c.data[c.valid]
            if len(codes):
                assert int(codes.min()) >= 0 and \
                    int(codes.max()) < len(d), spec.name


# each column with NULLs and the model's NULL share (1.0: never present)
_NULL_SHARE = {
    "ss_sold_date_sk": 0.02, "ss_customer_sk": 0.03, "ss_store_sk": 0.02,
    "ss_promo_sk": 0.5,
    "cs_sold_date_sk": 0.02, "cs_bill_customer_sk": 0.03,
    "cs_ship_customer_sk": 0.03, "cs_call_center_sk": 0.02,
    "cs_promo_sk": 0.5,
    "ws_sold_date_sk": 0.02, "ws_bill_customer_sk": 0.03,
    "ws_ship_customer_sk": 0.03, "ws_web_site_sk": 0.02, "ws_promo_sk": 0.5,
    "sr_customer_sk": 0.03, "sr_store_sk": 0.02,
    "cr_refunded_customer_sk": 0.03, "cr_returning_customer_sk": 0.03,
    "cr_call_center_sk": 0.02,
    "wr_refunded_customer_sk": 0.03, "wr_returning_customer_sk": 0.03,
    "inv_quantity_on_hand": 0.05,
    "c_current_cdemo_sk": 0.04, "c_current_hdemo_sk": 0.04,
    "c_current_addr_sk": 0.04, "c_login": 1.0,
    "ca_suite_number": 0.15, "i_rec_end_date": 0.75,
    "s_rec_end_date": 1.0, "s_closed_date_sk": 0.9,
    "cc_rec_end_date": 1.0, "cc_closed_date_sk": 1.0,
    "web_rec_end_date": 1.0, "web_close_date_sk": 1.0,
    "wp_rec_end_date": 1.0, "wp_customer_sk": 0.8,
}
# t_meal_time is NULL outside the meal hours: 11 of 24 hours are meals
_NULLABLE = set(_NULL_SHARE) | {"t_meal_time"}


@pytest.mark.parametrize("column", sorted(_NULL_SHARE))
def test_null_shares(cat, column):
    table = next(t for t, s in get_schemas().items()
                 if column in s.column_names)
    c = cat.get(table).column(column)
    n = len(c.data)
    p = _NULL_SHARE[column]
    share = 1 - float(c.valid.double().mean())
    if p == 1.0:
        assert share == 1.0
    else:
        assert _share_ok(share, p, n), (share, p, n)


def test_meal_times(cat):
    td = cat.get("time_dim")
    h = td.column("t_hour").data
    meal = td.column("t_meal_time")
    names = meal.dictionary[meal.data.numpy()]
    want = np.where((h >= 6) & (h <= 9), "breakfast",
                    np.where((h >= 11) & (h <= 14), "lunch",
                             np.where((h >= 17) & (h <= 21), "dinner", "")))
    ok = meal.valid.numpy()
    assert (ok == (want != "")).all()
    assert (names[ok] == want[ok]).all()


_DIMENSION_OF = {
    "date": ("date_dim", "d_date_sk"), "time": ("time_dim", "t_time_sk"),
    "item": ("item", "i_item_sk"), "customer": ("customer", "c_customer_sk"),
    "cdemo": ("customer_demographics", "cd_demo_sk"),
    "hdemo": ("household_demographics", "hd_demo_sk"),
    "addr": ("customer_address", "ca_address_sk"),
    "store": ("store", "s_store_sk"), "promo": ("promotion", "p_promo_sk"),
    "reason": ("reason", "r_reason_sk"),
    "call_center": ("call_center", "cc_call_center_sk"),
    "catalog_page": ("catalog_page", "cp_catalog_page_sk"),
    "ship_mode": ("ship_mode", "sm_ship_mode_sk"),
    "warehouse": ("warehouse", "w_warehouse_sk"),
    "web_page": ("web_page", "wp_web_page_sk"),
    "web_site": ("web_site", "web_site_sk"),
    "income_band": ("income_band", "ib_income_band_sk"),
}


def _foreign_keys():
    """(table, column, dimension, key) of every foreign key: a column
    ending in ``_<dimension>_sk`` that is not its table's own key."""
    out = []
    for table, schema in get_schemas().items():
        for name in schema.column_names[1:]:
            for suffix in sorted(_DIMENSION_OF, key=len, reverse=True):
                if name.endswith(f"_{suffix}_sk"):
                    out.append((table, name) + _DIMENSION_OF[suffix])
                    break
    return out


_FOREIGN_KEYS = _foreign_keys()


def test_foreign_keys_found():
    names = {c for _t, c, _d, _k in _FOREIGN_KEYS}
    assert len(_FOREIGN_KEYS) == len(names) > 90
    assert {"ss_promo_sk", "cs_catalog_page_sk", "ws_web_site_sk",
            "wr_web_page_sk", "inv_warehouse_sk", "hd_income_band_sk",
            "c_current_addr_sk", "cr_returning_cdemo_sk",
            "p_item_sk"} <= names


@pytest.mark.parametrize("table,column,dim,key", _FOREIGN_KEYS,
                         ids=[c for _t, c, _d, _k in _FOREIGN_KEYS])
def test_foreign_keys_hit_their_dimension(cat, table, column, dim, key):
    """Every non-NULL foreign key is a key of its dimension."""
    c = cat.get(table).column(column)
    vals = c.data if c.valid is None else c.data[c.valid]
    keys = cat.get(dim).column(key).data
    assert bool(torch.isin(vals, keys).all()), (table, column)


@pytest.mark.parametrize("rets,sales", [
    ("store_returns", "store_sales"), ("catalog_returns", "catalog_sales"),
    ("web_returns", "web_sales")])
def test_returns_carry_their_parent_sale(cat, rets, sales):
    """Return j is sale return_parent_row(j): the same item, ticket or
    order, customer and address; its quantity at most the sale's, and
    its date 1..90 days after the sale's."""
    r, s = cat.get(rets), cat.get(sales)
    parent = datagen.return_parent_rows(r.num_rows, s.num_rows, "cpu")
    rp, sp = rets[0] + "r_", sales[0] + "s_"
    number = "ticket_number" if rets == "store_returns" else "order_number"
    pairs = [("item_sk", "item_sk"), (number, number)]
    if rets == "store_returns":
        pairs += [("customer_sk", "customer_sk"), ("addr_sk", "addr_sk")]
    else:
        pairs += [("refunded_customer_sk", "bill_customer_sk"),
                  ("returning_addr_sk", "bill_addr_sk")]
    for rc, sc in pairs:
        a, b = r.column(rp + rc), s.column(sp + sc)
        assert torch.equal(a.data, b.data[parent].to(a.data.dtype)), rc
        if b.valid is not None:
            assert torch.equal(a.valid, b.valid[parent]), rc
    assert bool((r.column(rp + "return_quantity").data <=
                 s.column(sp + "quantity").data[parent]).all())
    date = r.column(rp + ("returned_date_sk" if rets != "store_returns"
                          else "returned_date_sk")).data.long()
    sold = s.column(sp + "sold_date_sk").data[parent].long()
    lag = date - sold
    assert int(lag.min()) >= 1 and int(lag.max()) <= 90


# dimension columns drawn from a dists.json distribution
_FROM_DISTS = [
    ("customer_address", "ca_city", "cities"),
    ("customer_address", "ca_county", "fips_county"),
    ("customer_address", "ca_state", "states"),
    ("warehouse", "w_state", "states"),
    ("call_center", "cc_county", "fips_county"),
    ("web_site", "web_state", "states"),
    ("store", "s_city", "store_cities"),
    ("store", "s_county", "fips_county"),
    ("store", "s_state", "store_states"),
    ("customer_demographics", "cd_gender", "gender"),
    ("customer_demographics", "cd_marital_status", "marital_status"),
    ("customer_demographics", "cd_education_status", "education"),
    ("household_demographics", "hd_buy_potential", "buy_potential"),
    ("ship_mode", "sm_carrier", "carriers"),
    ("reason", "r_reason_desc", "reasons"),
    ("item", "i_category", "categories"),
    ("item", "i_class", "classes"),
    ("item", "i_color", "colors"),
]


@pytest.mark.parametrize("table,column,dist", _FROM_DISTS,
                         ids=[c for _t, c, _d in _FROM_DISTS])
def test_dimension_values_come_from_dists(cat, table, column, dist):
    """Every value is one of the distribution's; the cross products and
    cyclic columns hold every value, and in a large table of weighted
    draws the heaviest value has its weight's share."""
    values, weights = datagen.DISTS[dist]
    c = cat.get(table).column(column)
    present = c.dictionary[np.unique(c.data.numpy())]
    assert set(present) <= set(values)
    if table in ("customer_demographics", "household_demographics",
                 "ship_mode"):          # cross products and cycles
        assert set(present) == set(values)
    elif len(c.data) > 1000:
        heavy = int(np.argmax(weights))
        code = list(c.dictionary).index(values[heavy])
        share = float((c.data == code).double().mean())
        assert _share_ok(share, weights[heavy] / sum(weights), len(c.data))


def test_gmt_offsets_come_from_dists(cat):
    hours = {int(h) * 100 for h in datagen.DISTS["gmt_offset"][0]}
    got = set(cat.get("customer_address").column(
        "ca_gmt_offset").data.tolist())
    assert got == hours


def test_dists_copy_is_the_one_the_generator_reads():
    import json
    from ndstpu_torch.datagen import model
    raw = json.loads(model.DISTS_PATH.read_text())
    assert model.DISTS_PATH.parent.name == "datagen"
    assert model.DISTS_PATH.parent.parent.name == "ndstpu_torch"
    assert datagen.DISTS["categories"][0] == tuple(
        raw["categories"]["values"])


@pytest.mark.parametrize("ask", [
    {"tables": ["catalog_returns", "inventory", "customer"]},
    {"columns": {"web_sales": ["ws_net_profit", "ws_order_number"],
                 "store_returns": ["sr_return_amt", "sr_customer_sk"],
                 "store": ["s_city"]}},
])
def test_parts_equal_the_whole(ask):
    """``tables=`` and ``columns=`` give each column the values a whole
    run gives it."""
    whole = datagen.generate(0.01, seed=5, device="cpu")
    part = datagen.generate(0.01, seed=5, device="cpu", **ask)
    want = ask.get("columns") or {t: get_schemas()[t].column_names
                                  for t in ask["tables"]}
    assert set(part.tables) == set(want)
    for table, cols in want.items():
        assert part.get(table).column_names == list(cols)
        for name in cols:
            x, y = part.get(table).column(name), whole.get(table).column(name)
            assert torch.equal(x.data, y.data), (table, name)
            assert (x.valid is None) == (y.valid is None), (table, name)
            if x.valid is not None:
                assert torch.equal(x.valid, y.valid), (table, name)
            if x.dictionary is not None:
                assert list(x.dictionary) == list(y.dictionary)


def test_inventory_model(cat):
    """Every other item in every warehouse, one row a week for 261
    weeks, dated a week apart from 1997-12-26."""
    inv = cat.get("inventory")
    n = datagen.sizes(0.2)
    items = n["item"] // 2
    wh = n["warehouse"]
    assert inv.num_rows == 261 * items * wh
    item = inv.column("inv_item_sk").data.long()
    assert bool((item % 2 == 1).all())
    assert len(torch.unique(item)) == items
    date = inv.column("inv_date_sk").data.long()
    weeks = torch.unique(date)
    assert len(weeks) == 261
    assert bool(((weeks[1:] - weeks[:-1]) == 7).all())
    assert int(weeks[0]) == 2450816 - 7
    q = inv.column("inv_quantity_on_hand")
    v = q.data[q.valid]
    assert int(v.min()) >= 0 and int(v.max()) <= 1000


def test_customer_demographics_cross_product(cat):
    """One row for each combination of the eight attributes."""
    cd = cat.get("customer_demographics")
    assert cd.num_rows == 1920800
    keys = torch.zeros(cd.num_rows, dtype=torch.int64)
    for name in ("cd_gender", "cd_marital_status", "cd_education_status",
                 "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
                 "cd_dep_employed_count", "cd_dep_college_count"):
        d = cd.column(name).data.long()
        keys = keys * (int(d.max()) + 1) + d
    assert len(torch.unique(keys)) == cd.num_rows
    est = cd.column("cd_purchase_estimate").data
    assert set(est.tolist()) == {500 * k for k in range(1, 21)}


@pytest.mark.parametrize("table", ["catalog_sales", "web_sales",
                                   "store_sales"])
def test_sales_cent_arithmetic(cat, table):
    """gen_sale's cents: extended prices are quantity times the unit
    price, tax 0..9% of net paid, ship cost up to 5% of the extended list
    price, and the net columns their sums; ship dates 2..120 days after
    the sale; three rows an order."""
    t = cat.get(table)
    p = table[0] + "s_"

    def col(c):
        return t.column(p + c).data.long()

    q = col("quantity")
    assert torch.equal(col("ext_sales_price"), q * col("sales_price"))
    assert torch.equal(col("ext_wholesale_cost"), q * col("wholesale_cost"))
    assert torch.equal(col("ext_list_price"), q * col("list_price"))
    paid = col("net_paid")
    assert torch.equal(paid, col("ext_sales_price") - col("coupon_amt"))
    tax = col("ext_tax")
    assert bool((tax >= 0).all()) and bool((100 * tax <= 9 * paid).all())
    assert torch.equal(col("net_paid_inc_tax"), paid + tax)
    assert torch.equal(col("net_profit"), paid - col("ext_wholesale_cost"))
    number = col("ticket_number" if table == "store_sales" else
                 "order_number")
    assert torch.equal(number, torch.arange(t.num_rows) // 3 + 1)
    if table != "store_sales":
        ship = col("ext_ship_cost")
        assert bool((20 * ship <= col("ext_list_price")).all())
        assert torch.equal(col("net_paid_inc_ship"), paid + ship)
        assert torch.equal(col("net_paid_inc_ship_tax"), paid + tax + ship)
        lag = col("ship_date_sk") - col("sold_date_sk")
        assert int(lag.min()) >= 2 and int(lag.max()) <= 120
