"""The port's on-device generator, checked on the CPU at a small scale.

Row counts must equal the JAX package's C++ generator (``ndsgen -sizes``)
at the spec's step scales; the distributions follow its ``gen_sale``,
``gen_item`` and ``gen_date_dim`` models.  Counts and keys are exact;
shares are checked within a few standard errors of the model's value."""

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


@pytest.mark.parametrize("sf", [1, 10, 100])
def test_row_counts_match_ndsgen(sf):
    out = subprocess.run([str(check_build()), "-sizes", str(sf)],
                         capture_output=True, text=True, check=True).stdout
    want = {ln.split("|")[0]: int(ln.split("|")[1])
            for ln in out.strip().splitlines()}
    got = datagen.sizes(sf)
    for table in ("store_sales", "item", "date_dim"):
        assert got[table] == want[table], table


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
    assert torch.equal(a.get("store_sales").column(col).data,
                       b.get("store_sales").column(col).data)
    assert not torch.equal(a.get("store_sales").column(col).data,
                           c.get("store_sales").column(col).data)
