"""Generate the NDS warehouse directly on the device.

Builds the 25 source tables of :mod:`ndstpu_torch.schema`, every column
at its schema type, as tensors on ``device``, following the models of the
JAX package's C++ generator (``ndstpu/datagen/ndsgen.cpp``):

* row counts from its step table (TPC-DS spec Table 3-2: SF 1/10/100/1000,
  linear for facts and log-linear for dimensions in between), inventory
  261 weeks x item/2 x warehouse, customer_demographics the full cross
  product (1,920,800 rows), ship_mode and income_band 20;
* ``gen_sale`` for the three sales tables: 2% NULL sold dates, uniform
  over 1998-01-02..2003-01-02 with 30% of sales moved into Nov/Dec, Zipf
  items and customers (3% NULL) with the coprime scatter, uniform
  demographics, household and address keys, the channel key 2% NULL,
  the promotion 50% NULL, three rows a ticket or order, and the cent
  arithmetic of every price column (15% of sales carry a coupon of up to
  half the extended price; tax 0..9%; catalog and web ship costs up to
  5% of the extended list price, and their ship dates 2..120 days after
  the sale);
* ``return_parent_row`` / ``gen_return``: return ``j`` is sale
  ``(j * stride) mod n``, whose item, ticket or order number, customer,
  demographics, address and channel keys it carries, returned 1..90 days
  after the sale with a quantity uniform up to the sale's, a uniform
  reason and ``gen_return``'s cents;
* ``gen_inventory``: every other item in every warehouse each week,
  quantity on hand 5% NULL;
* the dimensions' ``gen_*`` models: weighted categories, classes, colors,
  states, cities, counties, GMT offsets, education, marital status,
  gender and buy potential from ``dists.json`` (this package's copy of
  the JAX package's, the file the query templates draw their parameters
  from), business keys, calendars and the word pools of ``ndsgen.cpp``.

The numbers are not ndsgen's (the random streams differ); the
distributions are.  The main generator draws every column it drew when
only the store channel was made, in the same order; every column added
since draws from a stream of its own (ndsgen keeps its "extra columns
stream" the same way), so the earlier columns keep their values.
``tables=`` or ``columns=`` gets a part of the warehouse; each column has
the same values whatever else was asked for.  :func:`generate_refresh`
makes the data-maintenance refresh sets
(:mod:`ndstpu_torch.datagen.refresh`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence

import torch

from ndstpu_torch.datagen import dims, facts
from ndstpu_torch.datagen.facts import return_parent_rows
from ndstpu_torch.datagen.model import DISTS, bkey, sizes, stream
from ndstpu_torch.datagen.refresh import generate_refresh, refresh_sizes
from ndstpu_torch.engine.columnar import Column, Table
from ndstpu_torch.io.catalog import Catalog
from ndstpu_torch.schema import get_schemas

# the store-channel columns the q3 family, the store-channel reports,
# the window and rollup reports and the set-operation reports read
COLUMNS = {
    "date_dim": ("d_date_sk", "d_date", "d_month_seq", "d_year", "d_moy",
                 "d_qoy", "d_day_name", "d_week_seq"),
    "item": ("i_item_sk", "i_item_id", "i_item_desc", "i_current_price",
             "i_brand_id", "i_brand", "i_class", "i_category_id",
             "i_category", "i_manufact_id", "i_manager_id",
             "i_product_name", "i_manufact", "i_color", "i_units",
             "i_size"),
    "store_sales": ("ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk",
                    "ss_customer_sk", "ss_hdemo_sk", "ss_store_sk",
                    "ss_ticket_number", "ss_quantity", "ss_sales_price",
                    "ss_ext_discount_amt", "ss_ext_sales_price",
                    "ss_net_paid", "ss_net_profit", "ss_wholesale_cost",
                    "ss_list_price", "ss_coupon_amt"),
    "catalog_sales": ("cs_sold_date_sk", "cs_ship_addr_sk", "cs_item_sk",
                      "cs_ext_sales_price"),
    "web_sales": ("ws_sold_date_sk", "ws_item_sk", "ws_ship_customer_sk",
                  "ws_ext_sales_price"),
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

TABLES = tuple(get_schemas())
# the fact tables, which ``generate(host_facts=True)`` keeps in host memory
FACTS = ("store_sales", "store_returns", "catalog_sales", "catalog_returns",
         "web_sales", "web_returns", "inventory")

# seeds of the streams beside the main generator, mixed with ``seed``
_STREAMS = {
    "item": 1, "catalog_sales": 2, "web_sales": 3, "store": 4,
    "store_sales": 5, "catalog_sales extra": 6, "web_sales extra": 7,
    "store_returns": 8, "catalog_returns": 9, "web_returns": 10,
    "inventory": 11, "customer_address": 12, "customer": 13,
    "warehouse": 14, "ship_mode": 15, "call_center": 16, "web_site": 17,
    "web_page": 18, "promotion": 19, "catalog_page": 20,
}
# the tables the main generator draws, in its order
_MAIN = ("item", "store", "store_sales", "store_returns")


def _wanted(tables: Optional[Iterable[str]],
            columns: Optional[Mapping[str, Sequence[str]]]
            ) -> Dict[str, tuple]:
    """table -> the columns to make, in the order to register them."""
    schemas = get_schemas()
    if columns is not None:
        want = {t: tuple(cols) for t, cols in columns.items()}
    else:
        want = {t: tuple(schemas[t].column_names)
                for t in (TABLES if tables is None else tables)}
    for t, cols in want.items():
        unknown = set(cols) - set(schemas[t].column_names)
        if unknown:
            raise KeyError(f"{t} has no columns {sorted(unknown)}")
    return want


def generate(scale: float, seed: int, device,
             tables: Optional[Iterable[str]] = None,
             columns: Optional[Mapping[str, Sequence[str]]] = None,
             host_facts: bool = False) -> Catalog:
    """A catalog of the warehouse at ``scale``, generated on ``device``
    from ``seed``: every column of every table by default, every column
    of ``tables``, or the columns ``columns`` maps each table to.  With
    ``host_facts`` the seven fact tables (:data:`FACTS`) are generated on
    ``device`` chunk by chunk as always, and each chunk is copied into
    host memory, where the tables stay (the out-of-core warehouse, which
    the session streams with ``spmd_chunk_rows``); their values are the
    same.  The dimensions stay on ``device``."""
    device = torch.device(device)
    want = _wanted(tables, columns)
    n = sizes(scale)

    def extra(name):
        return stream(seed, _STREAMS[name], device)

    made: Dict[str, Dict[str, Column]] = {}
    small = {
        "date_dim": lambda: dims.date_dim(device),
        "time_dim": lambda: dims.time_dim(device),
        "household_demographics": lambda: dims.household_demographics(
            device),
        "customer_demographics": lambda: dims.customer_demographics(device),
        "income_band": lambda: dims.income_band(device),
        "reason": lambda: dims.reason(n["reason"], device),
        "ship_mode": lambda: dims.ship_mode(extra("ship_mode"), device),
        "warehouse": lambda: dims.warehouse(n["warehouse"],
                                            extra("warehouse"), device),
        "customer_address": lambda: dims.customer_address(
            n["customer_address"], extra("customer_address"), device),
        "customer": lambda: dims.customer(n["customer"], n,
                                          extra("customer"), device),
        "call_center": lambda: dims.call_center(
            n["call_center"], extra("call_center"), device),
        "web_site": lambda: dims.web_site(n["web_site"], extra("web_site"),
                                          device),
        "web_page": lambda: dims.web_page(n["web_page"], n["customer"],
                                          extra("web_page"), device),
        "promotion": lambda: dims.promotion(n["promotion"], n["item"],
                                            extra("promotion"), device),
        "catalog_page": lambda: dims.catalog_page(
            n["catalog_page"], extra("catalog_page"), device),
        "dbgen_version": lambda: dims.dbgen_version(device),
    }
    for table, make in small.items():
        if table in want:
            made[table] = make()

    # the main generator: item, store, store_sales, store_returns
    last = max((_MAIN.index(t) for t in want if t in _MAIN), default=-1)
    if last >= 0:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        made["item"] = dims.item(n["item"], gen, extra("item"), device)
        made["store"] = dims.store(n["store"], gen, extra("store"), device)
    if last >= 2:
        keep = set(want.get("store_sales", ()))
        if "store_returns" in want:
            keep |= facts.parent_columns("store_returns",
                                         want["store_returns"])
        made["store_sales"] = facts.store_sales(
            n["store_sales"], n, gen, extra("store_sales"), device, keep,
            host_facts)
    if last >= 3:
        made["store_returns"] = facts.returns(
            "store_returns", n["store_returns"], made["store_sales"],
            n["store_sales"], n["reason"], gen, extra("store_returns"),
            device, want["store_returns"], host_facts)

    for sales, rets in (("catalog_sales", "catalog_returns"),
                        ("web_sales", "web_returns")):
        if sales not in want and rets not in want:
            continue
        keep = set(want.get(sales, ()))
        if rets in want:
            keep |= facts.parent_columns(rets, want[rets])
        made[sales] = facts.channel_sales(
            sales, n[sales], n, extra(sales), extra(sales + " extra"),
            device, keep, host_facts)
        if rets in want:
            made[rets] = facts.returns(
                rets, n[rets], made[sales], n[sales], n["reason"], None,
                extra(rets), device, want[rets], host_facts)
    if "inventory" in want:
        made["inventory"] = facts.inventory(
            n["item"], n["warehouse"], extra("inventory"), device,
            want["inventory"], host_facts)

    cat = Catalog()
    for table in TABLES:
        if table in want:
            cat.register(table, Table({c: made[table][c]
                                       for c in want[table]}))
    return cat


def move(cat: Catalog, device) -> Catalog:
    """A copy of ``cat`` with every column on ``device``."""
    out = Catalog()
    for name, table in cat.tables.items():
        out.register(name, Table({
            c: Column(col.data.to(device), col.ctype,
                      None if col.valid is None else col.valid.to(device),
                      col.dictionary)
            for c, col in table.columns.items()}))
    return out


__all__ = ["COLUMNS", "FACTS", "TABLES", "DISTS", "generate", "generate_refresh",
           "move", "refresh_sizes", "sizes", "bkey", "return_parent_rows"]
