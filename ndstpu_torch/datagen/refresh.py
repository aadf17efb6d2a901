"""The data-maintenance refresh set, generated on the device.

The 12 staging tables of :func:`ndstpu_torch.schema.get_maintenance_schemas`
for refresh set ``update``, after the models of the JAX package's C++
generator's refresh generators (``ndstpu/datagen/ndsgen.cpp``
``gen_s_purchase``, ``gen_s_lineitems``, ``gen_s_order``,
``gen_s_returns``, ``gen_s_inventory`` and ``gen_delete_table``, sized as
its ``-update`` mode sizes them):

* ``lin(sf, 1500)`` purchases, half as many catalog orders, a third as
  many web orders (each at least 1), three line items an order; store,
  catalog and web returns a fifth, an eighth and a tenth of the
  purchases, and inventory rows half of them;
* every date (order, ship, return and inventory dates) in the 30 days
  after the sales window that refresh set ``update`` covers
  (``update_window``), inventory on four dates a week apart;
* business keys ``bkey(sk)`` of a uniform surrogate key over the
  dimension's row count at ``sf``, so that the maintenance functions'
  joins find the warehouse's rows; promotions NULL half the time, the
  only NULLs ndsgen writes there;
* ``delete`` and ``inventory_delete``: three ``(date1, date2)`` ranges, a
  twentieth of the sales window each, starting uniformly inside it.

As in :mod:`ndstpu_torch.datagen`, the random streams are not ndsgen's;
the sizes and distributions are.  Each table draws from a stream of its
own, so it has the same values whatever else was asked for.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ndstpu_torch.datagen.model import (
    SALES_FIRST_JD, SALES_LAST_JD, TICKET_SPREAD, WORDS, bkey, chance,
    civil, sizes, stream, uniform_int)
from ndstpu_torch.engine.columnar import Column, Table
from ndstpu_torch.schema import get_maintenance_schemas

TABLES = tuple(get_maintenance_schemas())
LINES_PER_ORDER = 3
RETURN_TIME = "12:00:00"
# the stream of each table, mixed with the seed and the refresh set
_TAGS = {name: 100 + i for i, name in enumerate(TABLES)}


def refresh_sizes(sf: float) -> Dict[str, int]:
    """Rows of each staging table at ``sf`` (ndsgen's ``-update`` jobs;
    the line items are three an order)."""
    orders = max(int(np.floor(1500 * sf + 0.5)), 1)   # ndsgen lin()
    n = {"s_purchase": orders, "s_catalog_order": max(orders // 2, 1),
         "s_web_order": max(orders // 3, 1),
         "s_store_returns": max(orders // 5, 1),
         "s_catalog_returns": max(orders // 8, 1),
         "s_web_returns": max(orders // 10, 1),
         "s_inventory": max(orders // 2, 1), "delete": 3,
         "inventory_delete": 3}
    for order, lines in (("s_purchase", "s_purchase_lineitem"),
                         ("s_catalog_order", "s_catalog_order_lineitem"),
                         ("s_web_order", "s_web_order_lineitem")):
        n[lines] = n[order] * LINES_PER_ORDER
    return {t: n[t] for t in TABLES}


def update_window(update: int):
    """First and last Julian day of refresh set ``update``."""
    lo = SALES_LAST_JD + 1 + (update - 1) * 30
    return lo, lo + 29


def _codes(keys: torch.Tensor, render) -> tuple:
    """Dictionary codes of ``render(k)`` for integer ``keys``, whose
    rendering keeps their order (business keys, dates): the distinct
    keys rendered on the host, the codes searched on the device."""
    uniq = torch.unique(keys)
    codes = torch.searchsorted(uniq, keys).to(torch.int32)
    return codes, np.array([render(int(k)) for k in uniq.cpu().tolist()],
                           dtype=object)


def _date10(jd: int) -> str:
    y, m, d = (int(v) for v in civil(torch.tensor([jd])))
    return f"{y:04d}-{m:02d}-{d:02d}"


class _Maker:
    """One staging table's columns, each in its schema type."""

    def __init__(self, table: str, n: int, gen, device):
        self.schema = get_maintenance_schemas()[table]
        self.n, self.gen, self.device = n, gen, device
        self.cols: Dict[str, Column] = {}

    def _ctype(self, name):
        return self.schema.column(name).dtype

    def ints(self, name, data, valid=None):
        dtype = torch.int64 if self._ctype(name).kind in (
            "int64", "decimal") else torch.int32
        self.cols[name] = Column(data.to(dtype), self._ctype(name), valid)

    def uniform(self, name, lo, hi):
        self.ints(name, uniform_int(lo, hi, self.n, self.gen, self.device))

    def keys(self, name, sk, valid=None):
        """Business keys ``bkey(sk)``."""
        codes, d = _codes(sk, bkey)
        self.cols[name] = Column(codes, self._ctype(name), valid, d)

    def dim_key(self, name, dim_rows: int, p_null: float = 0.0):
        sk = uniform_int(1, dim_rows, self.n, self.gen, self.device)
        valid = None
        if p_null:
            valid = ~chance(p_null, self.n, self.gen, self.device)
        self.keys(name, sk, valid)

    def date(self, name, jd):
        codes, d = _codes(jd, _date10)
        self.cols[name] = Column(codes, self._ctype(name), None, d)

    def constant(self, name, value: str):
        self.cols[name] = Column(
            torch.zeros(self.n, dtype=torch.int32, device=self.device),
            self._ctype(name), None, np.array([value], dtype=object))

    def sentence(self, name, words: int):
        w = uniform_int(0, len(WORDS) - 1, self.n * words, self.gen,
                        self.device).view(self.n, words).cpu().tolist()
        text = [" ".join(WORDS[i] for i in row) for row in w]
        d, codes = np.unique(np.asarray(text, dtype=object),
                             return_inverse=True)
        self.cols[name] = Column(
            torch.as_tensor(codes.reshape(-1).astype(np.int32)).to(
                self.device), self._ctype(name), None, d.astype(object))

    def table(self) -> Table:
        return Table({c: self.cols[c] for c in self.schema.column_names})


def _order(m: _Maker, p: str, web: bool, lo: int, hi: int, dims) -> None:
    """gen_s_order: a catalog or web order."""
    m.ints(f"{p}_order_id", torch.arange(1, m.n + 1, device=m.device))
    m.dim_key(f"{p}_bill_customer_id", dims["customer"])
    m.dim_key(f"{p}_ship_customer_id", dims["customer"])
    m.date(f"{p}_order_date", uniform_int(lo, hi, m.n, m.gen, m.device))
    m.uniform(f"{p}_order_time", 0, 86399)
    m.dim_key(f"{p}_ship_mode_id", dims["ship_mode"])
    if web:
        m.dim_key("word_web_site_id", dims["web_site"])
    else:
        m.dim_key("cord_call_center_id", dims["call_center"])
    m.sentence(f"{p}_order_comments", 6)


def _lineitems(m: _Maker, p: str, kind: str, lo: int, hi: int,
               dims) -> None:
    """gen_s_lineitems: three line items an order of a purchase
    (``kind`` "store"), a catalog or a web order."""
    order = torch.arange(m.n, device=m.device) // LINES_PER_ORDER
    m.ints(f"{p}_{'purchase' if kind == 'store' else 'order'}_id",
           order + 1)
    m.ints(f"{p}_line_number",
           torch.arange(m.n, device=m.device) % LINES_PER_ORDER + 1)
    m.dim_key(f"{p}_item_id", dims["item"])
    m.dim_key(f"{p}_promotion_id", dims["promotion"], p_null=0.5)
    m.uniform(f"{p}_quantity", 1, 100)
    m.uniform(f"{p}_{'sale' if kind == 'store' else 'sales'}_price",
              100, 10000)
    coupon = uniform_int(0, 5000, m.n, m.gen, m.device)
    m.ints(f"{p}_coupon_amt", torch.where(
        chance(0.15, m.n, m.gen, m.device), coupon, 0))
    if kind == "store":
        m.sentence("plin_comment", 4)
        return
    m.dim_key(f"{p}_warehouse_id", dims["warehouse"])
    m.date(f"{p}_ship_date", uniform_int(lo, hi, m.n, m.gen, m.device))
    if kind == "catalog":
        m.uniform("clin_catalog_number", 1, 109)
        m.uniform("clin_catalog_page_number", 1, 108)
    m.uniform(f"{p}_ship_cost", 0, 5000)
    if kind == "web":
        m.dim_key("wlin_web_page_id", dims["web_page"])


def _returns(m: _Maker, p: str, kind: str, lo: int, hi: int,
             dims) -> None:
    """gen_s_returns: a store, catalog or web return."""
    ids = torch.arange(1, m.n + 1, device=m.device)
    if kind == "store":
        m.dim_key("sret_store_id", dims["store"])
        m.keys("sret_purchase_id", ids)
    elif kind == "catalog":
        m.dim_key("cret_call_center_id", dims["call_center"])
        m.ints("cret_order_id", ids)
    else:
        m.dim_key("wret_web_page_id", dims["web_page"])
        m.ints("wret_order_id", ids)
    m.uniform(f"{p}_line_number", 1, 10)
    m.dim_key(f"{p}_item_id", dims["item"])
    if kind == "store":
        m.dim_key("sret_customer_id", dims["customer"])
    else:
        m.dim_key(f"{p}_return_customer_id", dims["customer"])
        m.dim_key(f"{p}_refund_customer_id", dims["customer"])
    m.date(f"{p}_return_date", uniform_int(lo, hi, m.n, m.gen, m.device))
    m.constant(f"{p}_return_time", RETURN_TIME)
    if kind == "store":
        m.uniform("sret_ticket_number", 1,
                  dims["store_sales"] // TICKET_SPREAD + 1)
    m.uniform(f"{p}_return_qty", 1, 50)
    amt = uniform_int(100, 20000, m.n, m.gen, m.device)
    m.ints(f"{p}_return_amt", amt)
    m.ints(f"{p}_return_tax", amt // 10)
    m.uniform(f"{p}_return_fee", 50, 5000)
    m.uniform(f"{p}_return_ship_cost", 0, 5000)
    m.ints(f"{p}_refunded_cash", amt // 2)
    m.ints(f"{p}_reversed_charge", amt // 4)
    credit = {"store": "sret_store_credit",
              "catalog": "cret_merchant_credit",
              "web": "wret_account_credit"}[kind]
    m.ints(credit, amt // 4)
    m.dim_key(f"{p}_reason_id", dims["reason"])
    if kind == "catalog":
        m.dim_key("cret_shipmode_id", dims["ship_mode"])
        m.dim_key("cret_catalog_page_id", dims["catalog_page"])
        m.dim_key("cret_warehouse_id", dims["warehouse"])


def _delete_ranges(m: _Maker) -> None:
    """gen_delete_table: three ranges of a twentieth of the sales window,
    each starting uniformly inside it."""
    span = (SALES_LAST_JD - SALES_FIRST_JD) // 20
    lo = uniform_int(SALES_FIRST_JD, SALES_LAST_JD - span - 1, m.n, m.gen,
                     m.device)
    m.date("date1", lo)
    m.date("date2", lo + span)


def generate_refresh(sf: float, update: int, seed: int, device,
                     tables: Optional[Iterable[str]] = None
                     ) -> Dict[str, Table]:
    """Refresh set ``update`` (1, 2, ...) at ``sf`` from ``seed``, on
    ``device``: the staging tables (all 12, or ``tables``) by name, in
    the schema's order."""
    if update < 1:
        raise ValueError(f"refresh sets count from 1, got {update}")
    device = torch.device(device)
    want = TABLES if tables is None else tuple(tables)
    unknown = set(want) - set(TABLES)
    if unknown:
        raise KeyError(f"no staging tables {sorted(unknown)}")
    n = refresh_sizes(sf)
    dims = sizes(sf)
    lo, hi = update_window(update)
    out: Dict[str, Table] = {}
    for table in TABLES:
        if table not in want:
            continue
        gen = stream(seed, 1000 * update + _TAGS[table], device)
        m = _Maker(table, n[table], gen, device)
        if table == "s_purchase":
            m.ints("purc_purchase_id", torch.arange(1, m.n + 1,
                                                    device=device))
            m.dim_key("purc_store_id", dims["store"])
            m.dim_key("purc_customer_id", dims["customer"])
            m.date("purc_purchase_date",
                   uniform_int(lo, hi, m.n, gen, device))
            m.uniform("purc_purchase_time", 0, 86399)
            m.uniform("purc_register_id", 1, 1000)
            m.uniform("purc_clerk_id", 1, 1000)
            m.sentence("purc_comment", 6)
        elif table == "s_purchase_lineitem":
            _lineitems(m, "plin", "store", lo, hi, dims)
        elif table == "s_catalog_order":
            _order(m, "cord", False, lo, hi, dims)
        elif table == "s_catalog_order_lineitem":
            _lineitems(m, "clin", "catalog", lo, hi, dims)
        elif table == "s_web_order":
            _order(m, "word", True, lo, hi, dims)
        elif table == "s_web_order_lineitem":
            _lineitems(m, "wlin", "web", lo, hi, dims)
        elif table == "s_store_returns":
            _returns(m, "sret", "store", lo, hi, dims)
        elif table == "s_catalog_returns":
            _returns(m, "cret", "catalog", lo, hi, dims)
        elif table == "s_web_returns":
            _returns(m, "wret", "web", lo, hi, dims)
        elif table == "s_inventory":
            m.dim_key("invn_warehouse_id", dims["warehouse"])
            m.dim_key("invn_item_id", dims["item"])
            m.date("invn_date",
                   lo + (torch.arange(m.n, device=device) % 4) * 7)
            m.uniform("invn_qty_on_hand", 0, 1000)
        else:
            _delete_ranges(m)
        out[table] = m.table()
    return out
