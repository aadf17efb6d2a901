"""Table schema registry for the NDS-TPU decision-support benchmark.

Covers the 25 source tables and 12 data-maintenance (staging/refresh) tables of
the TPC-DS-derived NDS schema, with the same column names, nullability and
logical types as the reference harness (see /root/reference/nds/nds_schema.py:49-716),
including its two policy switches:

  * ``use_decimal`` — money columns are exact DECIMAL(p,s) or DOUBLE
    (reference: nds_schema.py:43-47).  In this framework DECIMAL is executed on
    TPU as scale-shifted int64 ("scaled integer"), DOUBLE as float64 on the CPU
    interpreter / float32 accumulating in float64-emulation on TPU.
  * identifier width — surrogate keys are int32 except ``ss_ticket_number`` /
    ``sr_ticket_number`` which must be int64 at large scale factors
    (reference rationale: nds_schema.py:61-65, 328-331).

Schemas are declared in a compact text DSL (one column per line:
``name  type  [!]``) rather than nested constructor calls; they are parsed once
at import into `TableSchema` objects and exposed via :func:`get_schemas` /
:func:`get_maintenance_schemas` with the same signatures as the reference.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Logical types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DType:
    """Logical column type.

    kind: one of 'int32', 'int64', 'float64', 'decimal', 'date', 'string'
    For 'decimal', precision/scale are set.  For fixed/var strings, length
    carries the declared CHAR(n)/VARCHAR(n) width (informational — storage is
    dictionary-encoded regardless).
    """

    kind: str
    precision: int = 0
    scale: int = 0
    length: int = 0
    fixed: bool = False  # CHAR(n) vs VARCHAR(n)

    @property
    def is_numeric(self) -> bool:
        return self.kind in ("int32", "int64", "float64", "decimal")

    @property
    def is_string(self) -> bool:
        return self.kind == "string"

    def __str__(self) -> str:
        if self.kind == "decimal":
            return f"decimal({self.precision},{self.scale})"
        if self.kind == "string" and self.length:
            return f"{'char' if self.fixed else 'varchar'}({self.length})"
        return self.kind


INT32 = DType("int32")
INT64 = DType("int64")
FLOAT64 = DType("float64")
DATE = DType("date")
STRING = DType("string")
BOOL = DType("bool")


def decimal(precision: int, scale: int) -> DType:
    return DType("decimal", precision=precision, scale=scale)


def char(n: int) -> DType:
    return DType("string", length=n, fixed=True)


def varchar(n: int) -> DType:
    return DType("string", length=n, fixed=False)


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    dtype: DType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[ColumnSpec, ...]

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"{self.name}: no column {name}")

    def __len__(self) -> int:
        return len(self.columns)


# ---------------------------------------------------------------------------
# DSL parsing
# ---------------------------------------------------------------------------

_TYPE_RE = re.compile(
    r"^(?P<base>int|long|date|string|char|varchar|dec)(\((?P<args>[\d,]+)\))?$"
)


def _parse_type(tok: str, use_decimal: bool) -> DType:
    m = _TYPE_RE.match(tok)
    if not m:
        raise ValueError(f"bad type token: {tok}")
    base, args = m.group("base"), m.group("args")
    if base == "int":
        return INT32
    if base == "long":
        return INT64
    if base == "date":
        return DATE
    if base == "string":
        return STRING
    if base == "char":
        return char(int(args))
    if base == "varchar":
        return varchar(int(args))
    if base == "dec":
        p, s = (int(x) for x in args.split(","))
        return decimal(p, s) if use_decimal else FLOAT64
    raise ValueError(tok)


def _parse_table(name: str, body: str, use_decimal: bool) -> TableSchema:
    cols = []
    for line in body.strip().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        cname, ctype = parts[0], parts[1]
        nullable = not (len(parts) > 2 and parts[2] == "!")
        cols.append(ColumnSpec(cname, _parse_type(ctype, use_decimal), nullable))
    return TableSchema(name, tuple(cols))


# ---------------------------------------------------------------------------
# Source table definitions (25 tables)
# ---------------------------------------------------------------------------
# Identifier policy: surrogate keys int32; ss_/sr_ticket_number int64
# (reference: nds_schema.py:61-65,328-331).  Numeric measures are declared
# `long` to match the reference's LongType for counts/quantities.

_SOURCE_TABLES: Dict[str, str] = {
    "customer_address": """
        ca_address_sk       int         !
        ca_address_id       char(16)    !
        ca_street_number    char(10)
        ca_street_name      varchar(60)
        ca_street_type      char(15)
        ca_suite_number     char(10)
        ca_city             varchar(60)
        ca_county           varchar(30)
        ca_state            char(2)
        ca_zip              char(10)
        ca_country          varchar(20)
        ca_gmt_offset       dec(5,2)
        ca_location_type    char(20)
    """,
    "customer_demographics": """
        cd_demo_sk              int     !
        cd_gender               char(1)
        cd_marital_status       char(1)
        cd_education_status     char(20)
        cd_purchase_estimate    long
        cd_credit_rating        char(10)
        cd_dep_count            long
        cd_dep_employed_count   long
        cd_dep_college_count    long
    """,
    "date_dim": """
        d_date_sk           int         !
        d_date_id           char(16)    !
        d_date              date
        d_month_seq         long
        d_week_seq          long
        d_quarter_seq       long
        d_year              long
        d_dow               long
        d_moy               long
        d_dom               long
        d_qoy               long
        d_fy_year           long
        d_fy_quarter_seq    long
        d_fy_week_seq       long
        d_day_name          char(9)
        d_quarter_name      char(6)
        d_holiday           char(1)
        d_weekend           char(1)
        d_following_holiday char(1)
        d_first_dom         long
        d_last_dom          long
        d_same_day_ly       long
        d_same_day_lq       long
        d_current_day       char(1)
        d_current_week      char(1)
        d_current_month     char(1)
        d_current_quarter   char(1)
        d_current_year      char(1)
    """,
    "warehouse": """
        w_warehouse_sk      int         !
        w_warehouse_id      char(16)    !
        w_warehouse_name    varchar(20)
        w_warehouse_sq_ft   long
        w_street_number     char(10)
        w_street_name       varchar(60)
        w_street_type       char(15)
        w_suite_number      char(10)
        w_city              varchar(60)
        w_county            varchar(30)
        w_state             char(2)
        w_zip               char(10)
        w_country           varchar(20)
        w_gmt_offset        dec(5,2)
    """,
    "ship_mode": """
        sm_ship_mode_sk     int         !
        sm_ship_mode_id     char(16)    !
        sm_type             char(30)
        sm_code             char(10)
        sm_carrier          char(20)
        sm_contract         char(20)
    """,
    "time_dim": """
        t_time_sk           int         !
        t_time_id           char(16)    !
        t_time              long        !
        t_hour              long
        t_minute            long
        t_second            long
        t_am_pm             char(2)
        t_shift             char(20)
        t_sub_shift         char(20)
        t_meal_time         char(20)
    """,
    "reason": """
        r_reason_sk         int         !
        r_reason_id         char(16)    !
        r_reason_desc       char(100)
    """,
    "income_band": """
        ib_income_band_sk   int         !
        ib_lower_bound      long
        ib_upper_bound      long
    """,
    "item": """
        i_item_sk           int         !
        i_item_id           char(16)    !
        i_rec_start_date    date
        i_rec_end_date      date
        i_item_desc         varchar(200)
        i_current_price     dec(7,2)
        i_wholesale_cost    dec(7,2)
        i_brand_id          long
        i_brand             char(50)
        i_class_id          long
        i_class             char(50)
        i_category_id       long
        i_category          char(50)
        i_manufact_id       long
        i_manufact          char(50)
        i_size              char(20)
        i_formulation       char(20)
        i_color             char(20)
        i_units             char(10)
        i_container         char(10)
        i_manager_id        long
        i_product_name      char(50)
    """,
    "store": """
        s_store_sk          int         !
        s_store_id          char(16)    !
        s_rec_start_date    date
        s_rec_end_date      date
        s_closed_date_sk    int
        s_store_name        varchar(50)
        s_number_employees  long
        s_floor_space       long
        s_hours             char(20)
        s_manager           varchar(40)
        s_market_id         long
        s_geography_class   varchar(100)
        s_market_desc       varchar(100)
        s_market_manager    varchar(40)
        s_division_id       long
        s_division_name     varchar(50)
        s_company_id        long
        s_company_name      varchar(50)
        s_street_number     varchar(10)
        s_street_name       varchar(60)
        s_street_type       char(15)
        s_suite_number      char(10)
        s_city              varchar(60)
        s_county            varchar(30)
        s_state             char(2)
        s_zip               char(10)
        s_country           varchar(20)
        s_gmt_offset        dec(5,2)
        s_tax_precentage    dec(5,2)
    """,
    "call_center": """
        cc_call_center_sk   int         !
        cc_call_center_id   char(16)    !
        cc_rec_start_date   date
        cc_rec_end_date     date
        cc_closed_date_sk   int
        cc_open_date_sk     int
        cc_name             varchar(50)
        cc_class            varchar(50)
        cc_employees        long
        cc_sq_ft            long
        cc_hours            char(20)
        cc_manager          varchar(40)
        cc_mkt_id           long
        cc_mkt_class        char(50)
        cc_mkt_desc         varchar(100)
        cc_market_manager   varchar(40)
        cc_division         long
        cc_division_name    varchar(50)
        cc_company          long
        cc_company_name     char(50)
        cc_street_number    char(10)
        cc_street_name      varchar(60)
        cc_street_type      char(15)
        cc_suite_number     char(10)
        cc_city             varchar(60)
        cc_county           varchar(30)
        cc_state            char(2)
        cc_zip              char(10)
        cc_country          varchar(20)
        cc_gmt_offset       dec(5,2)
        cc_tax_percentage   dec(5,2)
    """,
    "customer": """
        c_customer_sk           int         !
        c_customer_id           char(16)    !
        c_current_cdemo_sk      int
        c_current_hdemo_sk      int
        c_current_addr_sk       int
        c_first_shipto_date_sk  int
        c_first_sales_date_sk   int
        c_salutation            char(10)
        c_first_name            char(20)
        c_last_name             char(30)
        c_preferred_cust_flag   char(1)
        c_birth_day             long
        c_birth_month           long
        c_birth_year            long
        c_birth_country         varchar(20)
        c_login                 char(13)
        c_email_address         char(50)
        c_last_review_date_sk   int
    """,
    "web_site": """
        web_site_sk         int         !
        web_site_id         char(16)    !
        web_rec_start_date  date
        web_rec_end_date    date
        web_name            varchar(50)
        web_open_date_sk    int
        web_close_date_sk   int
        web_class           varchar(50)
        web_manager         varchar(40)
        web_mkt_id          long
        web_mkt_class       varchar(50)
        web_mkt_desc        varchar(100)
        web_market_manager  varchar(40)
        web_company_id      long
        web_company_name    char(50)
        web_street_number   char(10)
        web_street_name     varchar(60)
        web_street_type     char(15)
        web_suite_number    char(10)
        web_city            varchar(60)
        web_county          varchar(30)
        web_state           char(2)
        web_zip             char(10)
        web_country         varchar(20)
        web_gmt_offset      dec(5,2)
        web_tax_percentage  dec(5,2)
    """,
    "store_returns": """
        sr_returned_date_sk     int
        sr_return_time_sk       int
        sr_item_sk              int     !
        sr_customer_sk          int
        sr_cdemo_sk             int
        sr_hdemo_sk             int
        sr_addr_sk              int
        sr_store_sk             int
        sr_reason_sk            int
        sr_ticket_number        long    !
        sr_return_quantity      long
        sr_return_amt           dec(7,2)
        sr_return_tax           dec(7,2)
        sr_return_amt_inc_tax   dec(7,2)
        sr_fee                  dec(7,2)
        sr_return_ship_cost     dec(7,2)
        sr_refunded_cash        dec(7,2)
        sr_reversed_charge      dec(7,2)
        sr_store_credit         dec(7,2)
        sr_net_loss             dec(7,2)
    """,
    "household_demographics": """
        hd_demo_sk          int         !
        hd_income_band_sk   int
        hd_buy_potential    char(15)
        hd_dep_count        long
        hd_vehicle_count    long
    """,
    "web_page": """
        wp_web_page_sk      int         !
        wp_web_page_id      char(16)    !
        wp_rec_start_date   date
        wp_rec_end_date     date
        wp_creation_date_sk int
        wp_access_date_sk   int
        wp_autogen_flag     char(1)
        wp_customer_sk      int
        wp_url              varchar(100)
        wp_type             char(50)
        wp_char_count       long
        wp_link_count       long
        wp_image_count      long
        wp_max_ad_count     long
    """,
    "promotion": """
        p_promo_sk          int         !
        p_promo_id          char(16)    !
        p_start_date_sk     int
        p_end_date_sk       int
        p_item_sk           int
        p_cost              dec(15,2)
        p_response_target   long
        p_promo_name        char(50)
        p_channel_dmail     char(1)
        p_channel_email     char(1)
        p_channel_catalog   char(1)
        p_channel_tv        char(1)
        p_channel_radio     char(1)
        p_channel_press     char(1)
        p_channel_event     char(1)
        p_channel_demo      char(1)
        p_channel_details   varchar(100)
        p_purpose           char(15)
        p_discount_active   char(1)
    """,
    "catalog_page": """
        cp_catalog_page_sk      int         !
        cp_catalog_page_id      char(16)    !
        cp_start_date_sk        int
        cp_end_date_sk          int
        cp_department           varchar(50)
        cp_catalog_number       long
        cp_catalog_page_number  long
        cp_description          varchar(100)
        cp_type                 varchar(100)
    """,
    "inventory": """
        inv_date_sk             int     !
        inv_item_sk             int     !
        inv_warehouse_sk        int     !
        inv_quantity_on_hand    long
    """,
    "catalog_returns": """
        cr_returned_date_sk         int
        cr_returned_time_sk         int
        cr_item_sk                  int     !
        cr_refunded_customer_sk     int
        cr_refunded_cdemo_sk        int
        cr_refunded_hdemo_sk        int
        cr_refunded_addr_sk         int
        cr_returning_customer_sk    int
        cr_returning_cdemo_sk       int
        cr_returning_hdemo_sk       int
        cr_returning_addr_sk        int
        cr_call_center_sk           int
        cr_catalog_page_sk          int
        cr_ship_mode_sk             int
        cr_warehouse_sk             int
        cr_reason_sk                int
        cr_order_number             int     !
        cr_return_quantity          long
        cr_return_amount            dec(7,2)
        cr_return_tax               dec(7,2)
        cr_return_amt_inc_tax       dec(7,2)
        cr_fee                      dec(7,2)
        cr_return_ship_cost         dec(7,2)
        cr_refunded_cash            dec(7,2)
        cr_reversed_charge          dec(7,2)
        cr_store_credit             dec(7,2)
        cr_net_loss                 dec(7,2)
    """,
    "web_returns": """
        wr_returned_date_sk         int
        wr_returned_time_sk         int
        wr_item_sk                  int     !
        wr_refunded_customer_sk     int
        wr_refunded_cdemo_sk        int
        wr_refunded_hdemo_sk        int
        wr_refunded_addr_sk         int
        wr_returning_customer_sk    int
        wr_returning_cdemo_sk       int
        wr_returning_hdemo_sk       int
        wr_returning_addr_sk        int
        wr_web_page_sk              int
        wr_reason_sk                int
        wr_order_number             int     !
        wr_return_quantity          long
        wr_return_amt               dec(7,2)
        wr_return_tax               dec(7,2)
        wr_return_amt_inc_tax       dec(7,2)
        wr_fee                      dec(7,2)
        wr_return_ship_cost         dec(7,2)
        wr_refunded_cash            dec(7,2)
        wr_reversed_charge          dec(7,2)
        wr_account_credit           dec(7,2)
        wr_net_loss                 dec(7,2)
    """,
    "web_sales": """
        ws_sold_date_sk         int
        ws_sold_time_sk         int
        ws_ship_date_sk         int
        ws_item_sk              int     !
        ws_bill_customer_sk     int
        ws_bill_cdemo_sk        int
        ws_bill_hdemo_sk        int
        ws_bill_addr_sk         int
        ws_ship_customer_sk     int
        ws_ship_cdemo_sk        int
        ws_ship_hdemo_sk        int
        ws_ship_addr_sk         int
        ws_web_page_sk          int
        ws_web_site_sk          int
        ws_ship_mode_sk         int
        ws_warehouse_sk         int
        ws_promo_sk             int
        ws_order_number         int     !
        ws_quantity             long
        ws_wholesale_cost       dec(7,2)
        ws_list_price           dec(7,2)
        ws_sales_price          dec(7,2)
        ws_ext_discount_amt     dec(7,2)
        ws_ext_sales_price      dec(7,2)
        ws_ext_wholesale_cost   dec(7,2)
        ws_ext_list_price       dec(7,2)
        ws_ext_tax              dec(7,2)
        ws_coupon_amt           dec(7,2)
        ws_ext_ship_cost        dec(7,2)
        ws_net_paid             dec(7,2)
        ws_net_paid_inc_tax     dec(7,2)
        ws_net_paid_inc_ship    dec(7,2)
        ws_net_paid_inc_ship_tax dec(7,2)
        ws_net_profit           dec(7,2)
    """,
    "catalog_sales": """
        cs_sold_date_sk         int
        cs_sold_time_sk         int
        cs_ship_date_sk         int
        cs_bill_customer_sk     int
        cs_bill_cdemo_sk        int
        cs_bill_hdemo_sk        int
        cs_bill_addr_sk         int
        cs_ship_customer_sk     int
        cs_ship_cdemo_sk        int
        cs_ship_hdemo_sk        int
        cs_ship_addr_sk         int
        cs_call_center_sk       int
        cs_catalog_page_sk      int
        cs_ship_mode_sk         int
        cs_warehouse_sk         int
        cs_item_sk              int     !
        cs_promo_sk             int
        cs_order_number         int     !
        cs_quantity             long
        cs_wholesale_cost       dec(7,2)
        cs_list_price           dec(7,2)
        cs_sales_price          dec(7,2)
        cs_ext_discount_amt     dec(7,2)
        cs_ext_sales_price      dec(7,2)
        cs_ext_wholesale_cost   dec(7,2)
        cs_ext_list_price       dec(7,2)
        cs_ext_tax              dec(7,2)
        cs_coupon_amt           dec(7,2)
        cs_ext_ship_cost        dec(7,2)
        cs_net_paid             dec(7,2)
        cs_net_paid_inc_tax     dec(7,2)
        cs_net_paid_inc_ship    dec(7,2)
        cs_net_paid_inc_ship_tax dec(7,2)
        cs_net_profit           dec(7,2)
    """,
    "dbgen_version": """
        dv_version          varchar(16)
        dv_create_date      date
        dv_create_time      char(20)
        dv_cmdline_args     varchar(200)
    """,
    "store_sales": """
        ss_sold_date_sk         int
        ss_sold_time_sk         int
        ss_item_sk              int     !
        ss_customer_sk          int
        ss_cdemo_sk             int
        ss_hdemo_sk             int
        ss_addr_sk              int
        ss_store_sk             int
        ss_promo_sk             int
        ss_ticket_number        long    !
        ss_quantity             long
        ss_wholesale_cost       dec(7,2)
        ss_list_price           dec(7,2)
        ss_sales_price          dec(7,2)
        ss_ext_discount_amt     dec(7,2)
        ss_ext_sales_price      dec(7,2)
        ss_ext_wholesale_cost   dec(7,2)
        ss_ext_list_price       dec(7,2)
        ss_ext_tax              dec(7,2)
        ss_coupon_amt           dec(7,2)
        ss_net_paid             dec(7,2)
        ss_net_paid_inc_tax     dec(7,2)
        ss_net_profit           dec(7,2)
    """,
}

# ---------------------------------------------------------------------------
# Maintenance (staging/refresh) table definitions (12 tables)
# Reference: nds_schema.py:570-716.
# ---------------------------------------------------------------------------

_MAINTENANCE_TABLES: Dict[str, str] = {
    "s_purchase_lineitem": """
        plin_purchase_id    int         !
        plin_line_number    int         !
        plin_item_id        char(16)
        plin_promotion_id   char(16)
        plin_quantity       int
        plin_sale_price     dec(7,2)
        plin_coupon_amt     dec(7,2)
        plin_comment        varchar(100)
    """,
    "s_purchase": """
        purc_purchase_id    int         !
        purc_store_id       char(16)
        purc_customer_id    char(16)
        purc_purchase_date  char(10)
        purc_purchase_time  int
        purc_register_id    int
        purc_clerk_id       int
        purc_comment        char(100)
    """,
    "s_catalog_order": """
        cord_order_id           int     !
        cord_bill_customer_id   char(16)
        cord_ship_customer_id   char(16)
        cord_order_date         char(10)
        cord_order_time         int
        cord_ship_mode_id       char(16)
        cord_call_center_id     char(16)
        cord_order_comments     varchar(100)
    """,
    "s_web_order": """
        word_order_id           int     !
        word_bill_customer_id   char(16)
        word_ship_customer_id   char(16)
        word_order_date         char(10)
        word_order_time         int
        word_ship_mode_id       char(16)
        word_web_site_id        char(16)
        word_order_comments     char(100)
    """,
    "s_catalog_order_lineitem": """
        clin_order_id           int     !
        clin_line_number        int     !
        clin_item_id            char(16)
        clin_promotion_id       char(16)
        clin_quantity           int
        clin_sales_price        dec(7,2)
        clin_coupon_amt         dec(7,2)
        clin_warehouse_id       char(16)
        clin_ship_date          char(10)
        clin_catalog_number     int
        clin_catalog_page_number int
        clin_ship_cost          dec(7,2)
    """,
    "s_web_order_lineitem": """
        wlin_order_id           int     !
        wlin_line_number        int     !
        wlin_item_id            char(16)
        wlin_promotion_id       char(16)
        wlin_quantity           int
        wlin_sales_price        dec(7,2)
        wlin_coupon_amt         dec(7,2)
        wlin_warehouse_id       char(16)
        wlin_ship_date          char(10)
        wlin_ship_cost          dec(7,2)
        wlin_web_page_id        char(16)
    """,
    "s_store_returns": """
        sret_store_id           char(16)
        sret_purchase_id        char(16)    !
        sret_line_number        int         !
        sret_item_id            char(16)    !
        sret_customer_id        char(16)
        sret_return_date        char(10)
        sret_return_time        char(10)
        sret_ticket_number      long
        sret_return_qty         int
        sret_return_amt         dec(7,2)
        sret_return_tax         dec(7,2)
        sret_return_fee         dec(7,2)
        sret_return_ship_cost   dec(7,2)
        sret_refunded_cash      dec(7,2)
        sret_reversed_charge    dec(7,2)
        sret_store_credit       dec(7,2)
        sret_reason_id          char(16)
    """,
    "s_catalog_returns": """
        cret_call_center_id     char(16)
        cret_order_id           int         !
        cret_line_number        int         !
        cret_item_id            char(16)    !
        cret_return_customer_id char(16)
        cret_refund_customer_id char(16)
        cret_return_date        char(10)
        cret_return_time        char(10)
        cret_return_qty         int
        cret_return_amt         dec(7,2)
        cret_return_tax         dec(7,2)
        cret_return_fee         dec(7,2)
        cret_return_ship_cost   dec(7,2)
        cret_refunded_cash      dec(7,2)
        cret_reversed_charge    dec(7,2)
        cret_merchant_credit    dec(7,2)
        cret_reason_id          char(16)
        cret_shipmode_id        char(16)
        cret_catalog_page_id    char(16)
        cret_warehouse_id       char(16)
    """,
    "s_web_returns": """
        wret_web_page_id        char(16)
        wret_order_id           int         !
        wret_line_number        int         !
        wret_item_id            char(16)    !
        wret_return_customer_id char(16)
        wret_refund_customer_id char(16)
        wret_return_date        char(10)
        wret_return_time        char(10)
        wret_return_qty         int
        wret_return_amt         dec(7,2)
        wret_return_tax         dec(7,2)
        wret_return_fee         dec(7,2)
        wret_return_ship_cost   dec(7,2)
        wret_refunded_cash      dec(7,2)
        wret_reversed_charge    dec(7,2)
        wret_account_credit     dec(7,2)
        wret_reason_id          char(16)
    """,
    "s_inventory": """
        invn_warehouse_id   char(16)    !
        invn_item_id        char(16)    !
        invn_date           char(10)    !
        invn_qty_on_hand    int
    """,
    "delete": """
        date1   string  !
        date2   string  !
    """,
    "inventory_delete": """
        date1   string  !
        date2   string  !
    """,
}

# The 7 fact tables that are date-partitioned at transcode time, and the
# partition key for each (reference: nds_transcode.py:45-53).
TABLE_PARTITIONING: Dict[str, str] = {
    "catalog_sales": "cs_sold_date_sk",
    "catalog_returns": "cr_returned_date_sk",
    "inventory": "inv_date_sk",
    "store_sales": "ss_sold_date_sk",
    "store_returns": "sr_returned_date_sk",
    "web_sales": "ws_sold_date_sk",
    "web_returns": "wr_returned_date_sk",
}

SOURCE_TABLE_NAMES: List[str] = list(_SOURCE_TABLES)
MAINTENANCE_TABLE_NAMES: List[str] = list(_MAINTENANCE_TABLES)


def get_schemas(use_decimal: bool = True) -> Dict[str, TableSchema]:
    """Schemas of all 25 source tables.

    With ``use_decimal=False`` every DECIMAL column degrades to float64,
    mirroring the reference's ``--float`` mode (nds_schema.py:43-47).
    """
    return {
        name: _parse_table(name, body, use_decimal)
        for name, body in _SOURCE_TABLES.items()
    }


def get_maintenance_schemas(use_decimal: bool = True) -> Dict[str, TableSchema]:
    """Schemas of the 12 data-maintenance staging tables
    (reference: nds_schema.py:570-716)."""
    return {
        name: _parse_table(name, body, use_decimal)
        for name, body in _MAINTENANCE_TABLES.items()
    }


def get_schema(table: str, use_decimal: bool = True) -> TableSchema:
    """Schema for one table, searching source then maintenance tables."""
    if table in _SOURCE_TABLES:
        return _parse_table(table, _SOURCE_TABLES[table], use_decimal)
    if table in _MAINTENANCE_TABLES:
        return _parse_table(table, _MAINTENANCE_TABLES[table], use_decimal)
    raise KeyError(f"unknown table: {table}")


if __name__ == "__main__":
    for n, s in {**get_schemas(), **get_maintenance_schemas()}.items():
        print(f"{n}: {len(s)} columns")
