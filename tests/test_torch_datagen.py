"""The port's on-device generator, checked on the CPU at a small scale.

Row counts must equal the JAX package's C++ generator (``ndsgen -sizes``)
at the spec's step scales; the distributions follow its ``gen_sale``,
``gen_return``, ``gen_item``, ``gen_date_dim``, ``gen_store``,
``gen_reason``, ``gen_household_demographics``, ``gen_time_dim``,
``gen_catalog_sales`` and ``gen_web_sales`` models.  Counts and keys
are exact; shares are checked within four standard errors of the
model's value."""

import subprocess

import numpy as np
import pytest
import torch

from ndstpu.check import check_build
from ndstpu_torch import datagen

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
    desc = datagen._reason(55, "cpu").column("r_reason_desc")
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
    n = datagen.sizes(0.2)
    for table, cols in datagen.COLUMNS.items():
        t = cat.get(table)
        assert t.num_rows == n[table]
        assert t.column_names == list(cols)


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
    _, m, _ = datagen.civil_from_days(d.data[d.valid].long() -
                                      _JD_EPOCH_1970)
    novdec = float((m >= 11).double().mean())
    # 30% moved into Nov/Dec, plus the uniform draws that land there
    days = 2452642 - 2450816 + 1
    in_window = sum(1 for j in range(days) if datagen.civil_from_days(
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
        assert datagen._CLASSES[(b // 1000) % 1000 - 1] == cls
        assert b % 1000 == int(num) and 1 <= int(num) <= 10
        assert datagen._CATEGORIES[cid - 1] == cname
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
    assert c.ctype == datagen._ctype(table, column)
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
        assert set(words) <= set(datagen._WORDS)
        assert name.endswith(str(sk))
        assert name[:-len(str(sk))] in datagen._COLORS
    price = item.column("i_current_price").data
    assert int(price.min()) >= 100 and int(price.max()) <= 10000
    store = cat.get("store")
    states = store.column("s_state")
    assert set(states.dictionary) <= set(datagen._STORE_STATES[0])
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
    assert c.ctype == datagen._ctype(table, column)
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
    assert set(color) <= set(datagen._COLORS)
    # weight 12 against weight 1
    assert (color == "red").sum() > 3 * (color == "linen").sum()
    assert set(strings("i_units")) == set(datagen._UNITS)
    assert set(strings("i_size")) == set(datagen._SIZES)
    n = item.num_rows
    for col, pool in (("i_units", datagen._UNITS),
                      ("i_size", datagen._SIZES)):
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
