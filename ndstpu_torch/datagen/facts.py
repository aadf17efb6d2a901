"""The fact tables, after ``ndsgen.cpp``'s ``gen_sale``, ``gen_return``
and ``gen_inventory`` models.

Facts are generated in chunks of :data:`CHUNK_ROWS` rows: each chunk's
draws are temporaries, and only the columns a caller keeps get a
full-size tensor.  Every chunk makes every draw whatever is kept, so each
column has the same values whatever else was asked for.  The draws a
table made before every column was generated come from its earlier
generator, in their earlier order; the rest from a stream of its own.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ndstpu_torch.datagen.model import (
    CHUNK_ROWS, INVENTORY_WEEKS, JD_EPOCH_1970, SALES_FIRST_JD,
    SALES_LAST_JD, TICKET_SPREAD, chance, civil, ctype, days_from_civil,
    uniform_int, zipf)
from ndstpu_torch.engine.columnar import Column, numpy_dtype

Columns = Dict[str, Column]


class Sink:
    """The kept columns of one table of ``n`` rows, filled chunk by
    chunk in their schema types: on ``device``, or with ``host`` in host
    memory, each chunk copied there as it is made (the out-of-core
    warehouse: facts too large for the card stay in host memory)."""

    def __init__(self, table: str, n: int, keep: Iterable[str], device,
                 host: bool = False):
        self.table, self.n, self.keep = table, n, set(keep)
        self.device = torch.device("cpu") if host else device
        self.data: Dict[str, torch.Tensor] = {}
        self.valid: Dict[str, torch.Tensor] = {}

    def put(self, name: str, b: int, e: int, data: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> None:
        if name not in self.keep:
            return
        if name not in self.data:
            t = ctype(self.table, name)
            dtype = getattr(torch, np.dtype(numpy_dtype(t)).name)
            self.data[name] = torch.empty(self.n, dtype=dtype,
                                          device=self.device)
            if valid is not None:
                self.valid[name] = torch.empty(self.n, dtype=torch.bool,
                                               device=self.device)
        self.data[name][b:e] = data
        if valid is not None:
            self.valid[name][b:e] = valid

    def columns(self) -> Columns:
        return {name: Column(data, ctype(self.table, name),
                             self.valid.get(name))
                for name, data in self.data.items()}


def _chunks(n: int):
    for b in range(0, n, CHUNK_ROWS):
        e = min(n, b + CHUNK_ROWS)
        yield b, e, e - b


def sale_dates(k: int, gen, device):
    """gen_sale's sold date of ``k`` sales: (Julian day as int32, valid).
    2% NULL; uniform over the sales window, with 30% of sales moved into
    Nov/Dec of their year."""
    years = range(1998, 2004)
    # Nov 1 of each sales year, as a Julian day (holiday-season skew)
    nov1 = torch.tensor([days_from_civil(y, 11, 1) + JD_EPOCH_1970
                         for y in years], dtype=torch.int64, device=device)
    ok = ~chance(0.02, k, gen, device)
    jd = uniform_int(SALES_FIRST_JD, SALES_LAST_JD, k, gen, device)
    holiday = chance(0.30, k, gen, device)
    hol_off = uniform_int(0, 60, k, gen, device)
    y, _, _ = civil(jd)
    y = torch.clamp(y, max=2002)   # Nov 2003 exceeds the window
    jd = torch.where(holiday, nov1[y - years[0]] + hol_off, jd)
    return jd.to(torch.int32), ok


def sale_prices(k: int, gen, device):
    """gen_sale's quantity and cents: (quantity 1..100, wholesale cost
    1.00..100.00, list price with a markup up to 100%, sales price 20..100%
    of list)."""
    q = uniform_int(1, 100, k, gen, device)
    wholesale = uniform_int(100, 10000, k, gen, device)
    lst = wholesale + uniform_int(0, wholesale, k, gen, device)
    sales = (lst * uniform_int(20, 100, k, gen, device)) // 100
    return q, wholesale, lst, sales


def _money(out: Sink, p: str, b: int, e: int, q, wholesale, lst, sales,
           coupon, tax_rate):
    """gen_sale's cent columns from its draws; returns (net paid, net
    paid with tax)."""
    ext = q * sales
    ext_wholesale = q * wholesale
    net_paid = ext - coupon
    tax = (net_paid * tax_rate) // 100
    for name, v in (("quantity", q), ("wholesale_cost", wholesale),
                    ("list_price", lst), ("sales_price", sales),
                    ("ext_discount_amt", q * lst - ext),
                    ("ext_sales_price", ext),
                    ("ext_wholesale_cost", ext_wholesale),
                    ("ext_list_price", q * lst), ("ext_tax", tax),
                    ("coupon_amt", coupon), ("net_paid", net_paid),
                    ("net_paid_inc_tax", net_paid + tax),
                    ("net_profit", net_paid - ext_wholesale)):
        out.put(p + name, b, e, v)
    return net_paid, net_paid + tax


def store_sales(n: int, sz: Dict[str, int], gen, extra, device,
                keep, host: bool = False) -> Columns:
    """gen_store_sales.  The main generator ``gen`` makes the draws it
    made before every column was generated, in their order; demographics,
    address, promotion (50% NULL) and the tax rate come from ``extra``."""
    out = Sink("store_sales", n, keep, device, host)
    p = "ss_"
    for b, e, k in _chunks(n):
        date, date_ok = sale_dates(k, gen, device)
        out.put(p + "sold_date_sk", b, e, date, date_ok)
        out.put(p + "sold_time_sk", b, e, uniform_int(0, 86399, k, gen,
                                                      device))
        out.put(p + "item_sk", b, e, zipf(sz["item"], k, gen, device))
        cust_ok = ~chance(0.03, k, gen, device)
        out.put(p + "customer_sk", b, e, zipf(sz["customer"], k, gen, device),
                cust_ok)
        out.put(p + "hdemo_sk", b, e, uniform_int(
            1, sz["household_demographics"], k, gen, device))
        store_ok = ~chance(0.02, k, gen, device)
        out.put(p + "store_sk", b, e, uniform_int(1, sz["store"], k, gen,
                                                  device), store_ok)
        q, wholesale, lst, sales = sale_prices(k, gen, device)
        coupon = torch.where(chance(0.15, k, gen, device),
                             uniform_int(0, q * sales // 2, k, gen, device),
                             0)
        out.put(p + "cdemo_sk", b, e, uniform_int(
            1, sz["customer_demographics"], k, extra, device))
        out.put(p + "addr_sk", b, e, uniform_int(
            1, sz["customer_address"], k, extra, device))
        promo_ok = ~chance(0.5, k, extra, device)
        out.put(p + "promo_sk", b, e, uniform_int(1, sz["promotion"], k,
                                                  extra, device), promo_ok)
        _money(out, p, b, e, q, wholesale, lst, sales, coupon,
               uniform_int(0, 9, k, extra, device))
        out.put(p + "ticket_number", b, e, torch.arange(
            b, e, dtype=torch.int64, device=device) // TICKET_SPREAD + 1)
    return out.columns()


def channel_sales(table: str, n: int, sz: Dict[str, int], gen, extra,
                  device, keep, host: bool = False) -> Columns:
    """gen_catalog_sales or gen_web_sales.  The channel's stream ``gen``
    makes the draws it made before every column was generated, in their
    order: the sold date, the Zipf item, then the ship-to key (catalog: an
    address uniform over customer_address, never NULL; web: the sale's
    customer, NULL where it is, otherwise that Zipf customer 85% of the
    time and a uniform one else) and the prices.  The rest comes from
    ``extra``: the time, catalog's bill-to customer (3% NULL; the ship-to
    customer is it 85% of the time), demographics, household and address
    keys, the channel key (call center or web site, 2% NULL), the page,
    ship mode, warehouse, promotion (50% NULL), coupon, tax, ship cost and
    ship date."""
    out = Sink(table, n, keep, device, host)
    web = table == "web_sales"
    p = table[0] + "s_"
    for b, e, k in _chunks(n):
        date, date_ok = sale_dates(k, gen, device)
        out.put(p + "sold_date_sk", b, e, date, date_ok)
        out.put(p + "item_sk", b, e, zipf(sz["item"], k, gen, device))
        if web:
            bill_ok = ~chance(0.03, k, gen, device)
            bill = zipf(sz["customer"], k, gen, device)
            other = uniform_int(1, sz["customer"], k, gen, device)
            ship = torch.where(chance(0.85, k, gen, device), bill, other)
        else:
            out.put(p + "ship_addr_sk", b, e, uniform_int(
                1, sz["customer_address"], k, gen, device))
        q, wholesale, lst, sales = sale_prices(k, gen, device)

        out.put(p + "sold_time_sk", b, e, uniform_int(0, 86399, k, extra,
                                                      device))
        if not web:
            bill_ok = ~chance(0.03, k, extra, device)
            bill = zipf(sz["customer"], k, extra, device)
            other = uniform_int(1, sz["customer"], k, extra, device)
            ship = torch.where(chance(0.85, k, extra, device), bill, other)
        out.put(p + "bill_customer_sk", b, e, bill, bill_ok)
        out.put(p + "ship_customer_sk", b, e, ship, bill_ok)
        for who in ("bill", "ship"):
            out.put(f"{p}{who}_cdemo_sk", b, e, uniform_int(
                1, sz["customer_demographics"], k, extra, device))
            out.put(f"{p}{who}_hdemo_sk", b, e, uniform_int(
                1, sz["household_demographics"], k, extra, device))
            if who == "bill" or web:
                out.put(f"{p}{who}_addr_sk", b, e, uniform_int(
                    1, sz["customer_address"], k, extra, device))
        channel_ok = ~chance(0.02, k, extra, device)
        channel, page = (("web_site", "web_page") if web else
                         ("call_center", "catalog_page"))
        channel_col = p + ("web_site_sk" if web else "call_center_sk")
        out.put(channel_col, b, e, uniform_int(1, sz[channel], k, extra,
                                               device), channel_ok)
        out.put(p + page + "_sk", b, e, uniform_int(1, sz[page], k, extra,
                                                    device))
        out.put(p + "ship_mode_sk", b, e, uniform_int(1, sz["ship_mode"], k,
                                                      extra, device))
        out.put(p + "warehouse_sk", b, e, uniform_int(1, sz["warehouse"], k,
                                                      extra, device))
        promo_ok = ~chance(0.5, k, extra, device)
        out.put(p + "promo_sk", b, e, uniform_int(1, sz["promotion"], k,
                                                  extra, device), promo_ok)
        coupon = torch.where(chance(0.15, k, extra, device),
                             uniform_int(0, q * sales // 2, k, extra,
                                         device), 0)
        net_paid, net_paid_tax = _money(
            out, p, b, e, q, wholesale, lst, sales, coupon,
            uniform_int(0, 9, k, extra, device))
        ship_cost = (q * lst * uniform_int(0, 50, k, extra, device)) // 1000
        out.put(p + "ext_ship_cost", b, e, ship_cost)
        out.put(p + "net_paid_inc_ship", b, e, net_paid + ship_cost)
        out.put(p + "net_paid_inc_ship_tax", b, e, net_paid_tax + ship_cost)
        out.put(p + "ship_date_sk", b, e,
                date + uniform_int(2, 120, k, extra, device))
        out.put(p + "order_number", b, e, torch.arange(
            b, e, dtype=torch.int64, device=device) // TICKET_SPREAD + 1)
    return out.columns()


def return_parent_rows(n_ret: int, n_sales: int, device) -> torch.Tensor:
    """ndsgen.cpp return_parent_row: return ``j`` is sale
    ``(j * stride) mod n_sales`` with ``stride = max(n_sales // n_ret,
    1)``."""
    stride = max(n_sales // max(n_ret, 1), 1)
    j = torch.arange(n_ret, dtype=torch.int64, device=device)
    return (j * stride) % n_sales


# each returns table's columns carried from its parent sale, and the
# sale columns its own draws read
RETURN_PARENT = {
    "store_returns": {
        "sr_item_sk": "ss_item_sk", "sr_customer_sk": "ss_customer_sk",
        "sr_cdemo_sk": "ss_cdemo_sk", "sr_hdemo_sk": "ss_hdemo_sk",
        "sr_addr_sk": "ss_addr_sk", "sr_store_sk": "ss_store_sk",
        "sr_ticket_number": "ss_ticket_number"},
    "catalog_returns": {
        "cr_item_sk": "cs_item_sk",
        "cr_refunded_customer_sk": "cs_bill_customer_sk",
        "cr_refunded_cdemo_sk": "cs_bill_cdemo_sk",
        "cr_refunded_hdemo_sk": "cs_bill_hdemo_sk",
        "cr_refunded_addr_sk": "cs_bill_addr_sk",
        "cr_returning_customer_sk": "cs_bill_customer_sk",
        "cr_returning_cdemo_sk": "cs_bill_cdemo_sk",
        "cr_returning_hdemo_sk": "cs_bill_hdemo_sk",
        "cr_returning_addr_sk": "cs_bill_addr_sk",
        "cr_call_center_sk": "cs_call_center_sk",
        "cr_catalog_page_sk": "cs_catalog_page_sk",
        "cr_ship_mode_sk": "cs_ship_mode_sk",
        "cr_warehouse_sk": "cs_warehouse_sk",
        "cr_order_number": "cs_order_number"},
    "web_returns": {
        "wr_item_sk": "ws_item_sk",
        "wr_refunded_customer_sk": "ws_bill_customer_sk",
        "wr_refunded_cdemo_sk": "ws_bill_cdemo_sk",
        "wr_refunded_hdemo_sk": "ws_bill_hdemo_sk",
        "wr_refunded_addr_sk": "ws_bill_addr_sk",
        "wr_returning_customer_sk": "ws_bill_customer_sk",
        "wr_returning_cdemo_sk": "ws_bill_cdemo_sk",
        "wr_returning_hdemo_sk": "ws_bill_hdemo_sk",
        "wr_returning_addr_sk": "ws_bill_addr_sk",
        "wr_web_page_sk": "ws_web_page_sk",
        "wr_order_number": "ws_order_number"},
}
SALE_OF_RETURNS = {"store_returns": "store_sales",
                   "catalog_returns": "catalog_sales",
                   "web_returns": "web_sales"}


def parent_columns(table: str, keep) -> set:
    """The sale columns returns table ``table`` reads for ``keep``."""
    p = SALE_OF_RETURNS[table][0] + "s_"
    return {RETURN_PARENT[table][c] for c in keep
            if c in RETURN_PARENT[table]} | {
        p + "quantity", p + "sales_price", p + "sold_date_sk"}


_RETURN_NAMES = {
    "store_returns": ("sr_returned_date_sk", "sr_return_time_sk",
                      "sr_return_amt", "sr_store_credit"),
    "catalog_returns": ("cr_returned_date_sk", "cr_returned_time_sk",
                        "cr_return_amount", "cr_store_credit"),
    "web_returns": ("wr_returned_date_sk", "wr_returned_time_sk",
                    "wr_return_amt", "wr_account_credit"),
}


def returns(table: str, n: int, sales: Columns, n_sales: int,
            n_reason: int, gen, extra, device, keep,
            host: bool = False) -> Columns:
    """gen_return over the parent sales ``sales`` (full-size columns):
    each return carries its sale's keys, and ``gen_return``'s date (1..90
    days after the sale), time, reason, quantity up to the sale's and
    cents.  Store returns draw the reason and quantity from ``gen`` (the
    main generator, as they did before every column was made), the rest
    from ``extra``; the other channels draw all from ``extra``."""
    parent = return_parent_rows(n, n_sales, device)
    p = SALE_OF_RETURNS[table][0] + "s_"
    r = table[0] + "r_"
    date_name, time_name, amt_name, credit_name = _RETURN_NAMES[table]
    out = Sink(table, n, keep, device, host)

    def of(col):
        # the parent sales rows on the device, wherever the sales are
        c = sales[col]
        idx = parent.to(c.data.device)
        return c.data[idx].to(device), \
            None if c.valid is None else c.valid[idx].to(device)

    for name, sale_col in RETURN_PARENT[table].items():
        if name in out.keep:
            data, valid = of(sale_col)
            out.put(name, 0, n, data, valid)
    qty_of, _ = of(p + "quantity")
    sales_price, _ = of(p + "sales_price")
    sold, _ = of(p + "sold_date_sk")
    if table == "store_returns":
        reason = uniform_int(1, n_reason, n, gen, device)
        qty = uniform_int(1, qty_of, n, gen, device)
    else:
        reason = qty = None
    ret = sold.to(torch.int64) + uniform_int(1, 90, n, extra, device)
    out.put(date_name, 0, n, torch.clamp(ret, max=SALES_LAST_JD + 90))
    out.put(time_name, 0, n, uniform_int(0, 86399, n, extra, device))
    if reason is None:
        reason = uniform_int(1, n_reason, n, extra, device)
        qty = uniform_int(1, qty_of, n, extra, device)
    out.put(r + "reason_sk", 0, n, reason)
    out.put(r + "return_quantity", 0, n, qty)
    amt = qty * sales_price
    tax = (amt * uniform_int(0, 9, n, extra, device)) // 100
    fee = uniform_int(50, 10000, n, extra, device)
    ship = uniform_int(0, amt // 2 + 1, n, extra, device)
    refunded = (amt * uniform_int(0, 100, n, extra, device)) // 100
    reversed_ = ((amt - refunded) *
                 uniform_int(0, 100, n, extra, device)) // 100
    for name, v in ((amt_name, amt), (r + "return_tax", tax),
                    (r + "return_amt_inc_tax", amt + tax), (r + "fee", fee),
                    (r + "return_ship_cost", ship),
                    (r + "refunded_cash", refunded),
                    (r + "reversed_charge", reversed_),
                    (credit_name, amt - refunded - reversed_),
                    (r + "net_loss", fee + ship + tax)):
        out.put(name, 0, n, v)
    return out.columns()


def inventory(n_item: int, n_warehouse: int, gen, device, keep,
              host: bool = False) -> Columns:
    """gen_inventory: a weekly snapshot over the 261 weeks of the sales
    window of every other item in every warehouse; quantity on hand
    uniform 0..1000, 5% NULL."""
    items = max(n_item // 2, 1)
    n = INVENTORY_WEEKS * items * n_warehouse
    out = Sink("inventory", n, keep, device, host)
    for b, e, k in _chunks(n):
        i = torch.arange(b, e, dtype=torch.int64, device=device)
        week = i // (items * n_warehouse)
        rem = i % (items * n_warehouse)
        out.put("inv_date_sk", b, e, SALES_FIRST_JD - 7 + week * 7)
        out.put("inv_item_sk", b, e, (rem // n_warehouse) * 2 + 1)
        out.put("inv_warehouse_sk", b, e, rem % n_warehouse + 1)
        ok = ~chance(0.05, k, gen, device)
        out.put("inv_quantity_on_hand", b, e,
                uniform_int(0, 1000, k, gen, device), ok)
    return out.columns()

