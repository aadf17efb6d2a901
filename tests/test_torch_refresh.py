"""The port's refresh set (``datagen.generate_refresh``) against the JAX
package's C++ generator's (``ndsgen -update 1``) at the same scales.

Row counts and column types equal the generator's; every date lies in
the refresh set's window (the 30 days after the sales window), as the
generator's do; the delete tables hold three ranges of a twentieth of the
sales window with date1 <= date2; every business key that names a
dimension row names one of the port's dimensions at that scale (or the
maintenance functions' joins would find nothing); and each table has the
same values whatever ``tables=`` asks for."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

from ndstpu import schema as jax_schema
from ndstpu.engine import columnar as jax_columnar
from ndstpu.io import csvio as jax_csvio
from ndstpu_torch import datagen
from ndstpu_torch.datagen.model import SALES_FIRST_JD, SALES_LAST_JD
from ndstpu_torch.datagen.refresh import TABLES, update_window
from test_torch_dm_common import SCALE, SEED, UPDATE, ndsgen_refresh

SCALES = (SCALE, 1)
JD_EPOCH_1970 = 2440588
# business-key columns -> the dimension column they name
KEYS = {
    "purc_store_id": ("store", "s_store_id"),
    "purc_customer_id": ("customer", "c_customer_id"),
    "plin_item_id": ("item", "i_item_id"),
    "plin_promotion_id": ("promotion", "p_promo_id"),
    "cord_bill_customer_id": ("customer", "c_customer_id"),
    "cord_ship_customer_id": ("customer", "c_customer_id"),
    "cord_ship_mode_id": ("ship_mode", "sm_ship_mode_id"),
    "cord_call_center_id": ("call_center", "cc_call_center_id"),
    "word_bill_customer_id": ("customer", "c_customer_id"),
    "word_ship_customer_id": ("customer", "c_customer_id"),
    "word_ship_mode_id": ("ship_mode", "sm_ship_mode_id"),
    "word_web_site_id": ("web_site", "web_site_id"),
    "clin_item_id": ("item", "i_item_id"),
    "clin_promotion_id": ("promotion", "p_promo_id"),
    "clin_warehouse_id": ("warehouse", "w_warehouse_id"),
    "wlin_item_id": ("item", "i_item_id"),
    "wlin_promotion_id": ("promotion", "p_promo_id"),
    "wlin_warehouse_id": ("warehouse", "w_warehouse_id"),
    "wlin_web_page_id": ("web_page", "wp_web_page_id"),
    "sret_store_id": ("store", "s_store_id"),
    "sret_item_id": ("item", "i_item_id"),
    "sret_customer_id": ("customer", "c_customer_id"),
    "sret_reason_id": ("reason", "r_reason_id"),
    "cret_call_center_id": ("call_center", "cc_call_center_id"),
    "cret_item_id": ("item", "i_item_id"),
    "cret_return_customer_id": ("customer", "c_customer_id"),
    "cret_refund_customer_id": ("customer", "c_customer_id"),
    "cret_reason_id": ("reason", "r_reason_id"),
    "cret_shipmode_id": ("ship_mode", "sm_ship_mode_id"),
    "cret_catalog_page_id": ("catalog_page", "cp_catalog_page_id"),
    "cret_warehouse_id": ("warehouse", "w_warehouse_id"),
    "wret_web_page_id": ("web_page", "wp_web_page_id"),
    "wret_item_id": ("item", "i_item_id"),
    "wret_return_customer_id": ("customer", "c_customer_id"),
    "wret_refund_customer_id": ("customer", "c_customer_id"),
    "wret_reason_id": ("reason", "r_reason_id"),
    "invn_warehouse_id": ("warehouse", "w_warehouse_id"),
    "invn_item_id": ("item", "i_item_id"),
}
DATES = ("purc_purchase_date", "cord_order_date", "word_order_date",
         "clin_ship_date", "wlin_ship_date", "sret_return_date",
         "cret_return_date", "wret_return_date", "invn_date")


@pytest.fixture(scope="module")
def port():
    return {sf: datagen.generate_refresh(sf, UPDATE, SEED, "cpu")
            for sf in SCALES}


@pytest.fixture(scope="module")
def ndsgen(tmp_path_factory):
    """The C++ generator's refresh set at each scale, read with the JAX
    package's csvio and decoded with its ``from_arrow``."""
    out = {}
    schemas = jax_schema.get_maintenance_schemas(True)
    for sf in SCALES:
        d = ndsgen_refresh(tmp_path_factory.mktemp(f"upd{sf}"), sf)
        out[sf] = {t: jax_columnar.from_arrow(
            jax_csvio.read_table_dir(str(d), t, schemas[t]), schemas[t])
            for t in TABLES}
    return out


@pytest.fixture(scope="module")
def dims():
    return datagen.generate(SCALE, seed=SEED, device="cpu", tables=sorted(
        {t for t, _c in KEYS.values()}))


@pytest.mark.parametrize("sf", SCALES)
@pytest.mark.parametrize("table", TABLES)
def test_rows_and_types_match_ndsgen(port, ndsgen, sf, table):
    got, want = port[sf][table], ndsgen[sf][table]
    assert got.num_rows == want.num_rows
    assert got.column_names == want.column_names
    assert [(c.ctype.kind, c.ctype.precision, c.ctype.scale)
            for c in got.columns.values()] == \
        [(c.ctype.kind, c.ctype.precision, c.ctype.scale)
         for c in want.columns.values()]


def test_sizes_at_sf_20():
    n = datagen.refresh_sizes(20)
    assert (n["s_purchase"], n["s_catalog_order"], n["s_web_order"]) == \
        (30000, 15000, 10000)
    assert (n["s_store_returns"], n["s_catalog_returns"],
            n["s_web_returns"], n["s_inventory"]) == (6000, 3750, 3000,
                                                      15000)
    assert n["s_purchase_lineitem"] == 90000


def _days(values):
    return [(np.datetime64(v) - np.datetime64("1970-01-01")).astype(int)
            + JD_EPOCH_1970 for v in values if v is not None]


@pytest.mark.parametrize("sf", SCALES)
def test_dates_in_the_update_window(port, ndsgen, sf):
    lo, hi = update_window(UPDATE)
    for tables in (port[sf], ndsgen[sf]):
        for t in tables.values():
            for c in t.column_names:
                if c in DATES:
                    jd = _days(t.column(c).to_pylist())
                    assert jd and lo <= min(jd) and max(jd) <= hi, c


@pytest.mark.parametrize("table", ["delete", "inventory_delete"])
def test_delete_ranges(port, ndsgen, table):
    span = (SALES_LAST_JD - SALES_FIRST_JD) // 20
    for tables in (port[SCALE], ndsgen[SCALE]):
        d = tables[table].to_pydict()
        assert len(d["date1"]) == 3
        for d1, d2 in zip(_days(d["date1"]), _days(d["date2"])):
            assert SALES_FIRST_JD <= d1 <= d2 <= SALES_LAST_JD
            assert d2 - d1 == span


def test_business_keys_name_the_ports_dimensions(port, dims):
    for t in port[SCALE].values():
        for c in t.column_names:
            if c not in KEYS:
                continue
            dim, col = KEYS[c]
            have = set(dims.get(dim).column(col).to_pylist())
            keys = {v for v in t.column(c).to_pylist() if v is not None}
            assert keys and keys <= have, c


def test_promotion_nulls(port):
    """Line items name no promotion half the time, as ndsgen writes
    them; no other column of the set is NULL."""
    for t in port[1].values():
        for c, col in t.columns.items():
            if c.endswith("_promotion_id"):
                share = float((~col.valid).float().mean())
                assert abs(share - 0.5) < 4 * (0.25 / len(col)) ** 0.5, c
            else:
                assert col.valid is None, c


def test_same_values_whatever_tables(port):
    for pick in (["s_inventory"], ["delete", "s_web_returns"],
                 ["s_purchase_lineitem"]):
        got = datagen.generate_refresh(SCALE, UPDATE, SEED, "cpu",
                                       tables=pick)
        assert list(got) == [t for t in TABLES if t in pick]
        for t in pick:
            assert got[t].to_rows() == port[SCALE][t].to_rows()
