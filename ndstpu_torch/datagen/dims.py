"""The dimension tables, after ``ndsgen.cpp``'s ``gen_*`` models.

Each function returns every schema column of its table.  ``gen`` is the
main generator where a table drew from it before every column was made
(item, store); the columns added since draw from a stream of their own
(``extra``), after the earlier draws, so the earlier columns keep their
values.
"""

from __future__ import annotations

from typing import Dict

import torch

from ndstpu_torch.datagen.model import (
    BIRTH_COUNTRIES, BRANDS_PER_CLASS, BUY_POTENTIAL, CATALOG_PAGE_TYPES,
    CATALOG_PAGES_PER_CATALOG, CATEGORIES, CATEGORY_WEIGHTS, CC_CLASSES,
    CC_NAMES, CLASSES, CLASS_WEIGHTS, COLOR_WEIGHTS, COLORS, CREDIT,
    DATE_DIM_FIRST_JD, DATE_DIM_ROWS, DAY_NAMES, DESC_WORDS, DISTS,
    FIRST_NAMES, HOURS, HOUSEHOLD_DEMOGRAPHICS_ROWS, INCOME_BAND_ROWS,
    JD_EPOCH_1970, LAST_NAMES, LOCATION_TYPES, PAGE_TYPES, PURPOSES, REASONS,
    SALES_FIRST_JD, SALES_LAST_JD, SALUTATIONS, SHIFTS, SHIP_CODES,
    SHIP_MODE_ROWS, SHIP_TYPES, SITE_NAMES, SIZES, STORE_GMT, STORE_STATES,
    TIME_DIM_ROWS, UNITS, address, bkey, chance, civil, constant_string, ctype,
    customer_demographics_rows, date_column, days_from_civil, flags,
    int_column, keyed_strings, null_ints, null_strings, person_names,
    person_pool, pool_column, sentences, string_column, uniform_int,
    weighted_pick)
from ndstpu_torch.engine.columnar import Column

Columns = Dict[str, Column]


def _keys(table: str, sk_name: str, id_name: str, n: int, device) -> Columns:
    """The surrogate key 1..n and its business key."""
    codes, dictionary = keyed_strings(n, bkey, device)
    return {sk_name: int_column(torch.arange(1, n + 1, device=device),
                                table, sk_name),
            id_name: Column(codes, ctype(table, id_name), None, dictionary)}


def _ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def date_dim(device) -> Columns:
    jd = _ids(DATE_DIM_ROWS, device) + DATE_DIM_FIRST_JD
    y, m, d = civil(jd)
    days70 = jd - JD_EPOCH_1970
    dow = torch.remainder(days70 + 4, 7)       # 0 = Sunday
    qoy = (m - 1) // 3 + 1
    month_seq = (y - 1900) * 12 + m - 1
    week_seq = (jd - DATE_DIM_FIRST_JD) // 7 + 1
    quarter_seq = (y - 1900) * 4 + qoy - 1
    # the first day of each month from January 1900 on, as a Julian day
    first = torch.tensor(
        [days_from_civil(1900 + k // 12, k % 12 + 1, 1) + JD_EPOCH_1970
         for k in range(int(month_seq.max()) + 2)], device=device)
    jan1 = first[(y - 1900) * 12]
    doy = jd - jan1 + 1
    t = "date_dim"
    id_codes, id_dict = string_column(
        [bkey(int(j)) for j in range(DATE_DIM_FIRST_JD,
                                     DATE_DIM_FIRST_JD + DATE_DIM_ROWS)],
        _ids(DATE_DIM_ROWS, device))
    quarters = [f"{1900 + k // 4:04d}Q{k % 4 + 1}"
                for k in range(int(quarter_seq.max()) + 1)]
    never = torch.zeros(DATE_DIM_ROWS, dtype=torch.bool, device=device)
    return {
        "d_date_sk": int_column(jd, t, "d_date_sk"),
        "d_date_id": Column(id_codes, ctype(t, "d_date_id"), None, id_dict),
        "d_date": date_column(jd, t, "d_date"),
        "d_month_seq": int_column(month_seq, t, "d_month_seq"),
        "d_week_seq": int_column(week_seq, t, "d_week_seq"),
        "d_quarter_seq": int_column(quarter_seq, t, "d_quarter_seq"),
        "d_year": int_column(y, t, "d_year"),
        "d_dow": int_column(dow, t, "d_dow"),
        "d_moy": int_column(m, t, "d_moy"),
        "d_dom": int_column(d, t, "d_dom"),
        "d_qoy": int_column(qoy, t, "d_qoy"),
        "d_fy_year": int_column(y, t, "d_fy_year"),
        "d_fy_quarter_seq": int_column(quarter_seq, t, "d_fy_quarter_seq"),
        "d_fy_week_seq": int_column(week_seq, t, "d_fy_week_seq"),
        "d_day_name": pool_column(DAY_NAMES, dow, t, "d_day_name"),
        "d_quarter_name": pool_column(quarters, quarter_seq, t,
                                      "d_quarter_name"),
        "d_holiday": flags(((m == 12) & (d == 25)) | ((m == 1) & (d == 1)) |
                           (doy == 185), t, "d_holiday"),
        "d_weekend": flags((dow == 0) | (dow == 6), t, "d_weekend"),
        "d_following_holiday": flags(((m == 12) & (d == 26)) |
                                     ((m == 1) & (d == 2)), t,
                                     "d_following_holiday"),
        "d_first_dom": int_column(first[month_seq], t, "d_first_dom"),
        "d_last_dom": int_column(first[month_seq + 1] - 1, t, "d_last_dom"),
        "d_same_day_ly": int_column(jd - 365, t, "d_same_day_ly"),
        "d_same_day_lq": int_column(jd - 91, t, "d_same_day_lq"),
        **{c: flags(never, t, c) for c in (
            "d_current_day", "d_current_week", "d_current_month",
            "d_current_quarter", "d_current_year")},
    }


def time_dim(device) -> Columns:
    sk = _ids(TIME_DIM_ROWS, device)
    h = sk // 3600
    t = "time_dim"
    id_codes, id_dict = string_column(
        [bkey(i + 1) for i in range(TIME_DIM_ROWS)], sk)
    # breakfast 6-9, lunch 11-14, dinner 17-21; NULL between
    meal = torch.full_like(h, -1)
    for k, (lo, hi) in enumerate(((6, 9), (11, 14), (17, 21))):
        meal = torch.where((h >= lo) & (h <= hi), k, meal)
    return {
        "t_time_sk": int_column(sk, t, "t_time_sk"),
        "t_time_id": Column(id_codes, ctype(t, "t_time_id"), None, id_dict),
        "t_time": int_column(sk, t, "t_time"),
        "t_hour": int_column(h, t, "t_hour"),
        "t_minute": int_column((sk // 60) % 60, t, "t_minute"),
        "t_second": int_column(sk % 60, t, "t_second"),
        "t_am_pm": pool_column(("AM", "PM"), (h >= 12).to(torch.int64), t,
                               "t_am_pm"),
        "t_shift": pool_column(SHIFTS, h // 8, t, "t_shift"),
        "t_sub_shift": pool_column(SHIFTS, (h // 4) % 3, t, "t_sub_shift"),
        "t_meal_time": pool_column(("breakfast", "lunch", "dinner"),
                                   meal.clamp(min=0), t, "t_meal_time",
                                   meal >= 0),
    }


def household_demographics(device) -> Columns:
    i = _ids(HOUSEHOLD_DEMOGRAPHICS_ROWS, device)
    nbp = len(BUY_POTENTIAL)
    t = "household_demographics"
    return {
        "hd_demo_sk": int_column(i + 1, t, "hd_demo_sk"),
        "hd_income_band_sk": int_column(i % 20 + 1, t, "hd_income_band_sk"),
        "hd_buy_potential": pool_column(BUY_POTENTIAL, (i // 20) % nbp, t,
                                        "hd_buy_potential"),
        "hd_dep_count": int_column((i // (20 * nbp)) % 10, t,
                                   "hd_dep_count"),
        "hd_vehicle_count": int_column((i // (200 * nbp)) % 6, t,
                                       "hd_vehicle_count"),
    }


def customer_demographics(device) -> Columns:
    """ndsgen gen_customer_demographics: the full cross product, gender
    varying fastest."""
    genders = DISTS["gender"][0]
    marital = DISTS["marital_status"][0]
    education = DISTS["education"][0]
    v = _ids(customer_demographics_rows(), device)
    t = "customer_demographics"
    out = {"cd_demo_sk": int_column(v + 1, t, "cd_demo_sk")}
    for name, k in (("cd_gender", genders), ("cd_marital_status", marital),
                    ("cd_education_status", education), (
                        "cd_purchase_estimate", 20), ("cd_credit_rating",
                                                      CREDIT),
                    ("cd_dep_count", 7), ("cd_dep_employed_count", 7),
                    ("cd_dep_college_count", 7)):
        size = k if isinstance(k, int) else len(k)
        digit = v % size
        v = v // size
        if name == "cd_purchase_estimate":
            out[name] = int_column(500 * (digit + 1), t, name)
        elif isinstance(k, int):
            out[name] = int_column(digit, t, name)
        else:
            out[name] = pool_column(k, digit, t, name)
    return out


def income_band(device) -> Columns:
    i = _ids(INCOME_BAND_ROWS, device)
    t = "income_band"
    return {"ib_income_band_sk": int_column(i + 1, t, "ib_income_band_sk"),
            "ib_lower_bound": int_column(i * 10000 + 1 - (i == 0).long(), t,
                                         "ib_lower_bound"),
            "ib_upper_bound": int_column((i + 1) * 10000, t,
                                         "ib_upper_bound")}


def ship_mode(gen, device) -> Columns:
    n = SHIP_MODE_ROWS
    i = _ids(n, device)
    t = "ship_mode"
    carriers = DISTS["carriers"][0]
    contract = uniform_int(1000000, 9999999, n, gen, device)
    return {
        **_keys(t, "sm_ship_mode_sk", "sm_ship_mode_id", n, device),
        "sm_type": pool_column(SHIP_TYPES, i % 6, t, "sm_type"),
        "sm_code": pool_column(SHIP_CODES, (i // 6) % 3, t, "sm_code"),
        "sm_carrier": pool_column(carriers, i % len(carriers), t,
                                  "sm_carrier"),
        "sm_contract": pool_column([str(c) for c in contract.tolist()],
                                   i, t, "sm_contract"),
    }


def reason(n: int, device) -> Columns:
    t = "reason"
    return {**_keys(t, "r_reason_sk", "r_reason_id", n, device),
            "r_reason_desc": pool_column(REASONS, _ids(n, device) %
                                         len(REASONS), t, "r_reason_desc")}


def warehouse(n: int, gen, device) -> Columns:
    t = "warehouse"
    sq_ft = uniform_int(50000, 999999, n, gen, device)
    addr = address(t, "w_", n, gen, device)
    gmt = -uniform_int(5, 10, n, gen, device)
    return {
        **_keys(t, "w_warehouse_sk", "w_warehouse_id", n, device),
        "w_warehouse_name": pool_column(
            [f"Warehouse {k}" for k in range(1, n + 1)], _ids(n, device), t,
            "w_warehouse_name"),
        "w_warehouse_sq_ft": int_column(sq_ft, t, "w_warehouse_sq_ft"),
        **addr,
        "w_gmt_offset": int_column(gmt * 100, t, "w_gmt_offset"),
    }


def customer_address(n: int, gen, device) -> Columns:
    t = "customer_address"
    cols = _keys(t, "ca_address_sk", "ca_address_id", n, device)
    cols.update(address(t, "ca_", n, gen, device, two_word_streets=True,
                        suite_nulls=True))
    hours, weights = DISTS["gmt_offset"]
    gmt = torch.tensor([int(h) for h in hours], device=device)[
        weighted_pick(weights, n, gen, device)]
    cols["ca_gmt_offset"] = int_column(gmt * 100, t, "ca_gmt_offset")
    cols["ca_location_type"] = pool_column(
        LOCATION_TYPES, uniform_int(0, len(LOCATION_TYPES) - 1, n, gen,
                                    device), t, "ca_location_type")
    return cols


def _open_date(n, gen, device, lo=100, hi=2000):
    return SALES_FIRST_JD - uniform_int(lo, hi, n, gen, device)


def _companies(t, p, n, gen, device, id_hi, name_hi) -> Columns:
    cid = uniform_int(1, id_hi, n, gen, device)
    name = uniform_int(1, name_hi, n, gen, device)
    return {p[0]: int_column(cid, t, p[0]),
            p[1]: pool_column([f"Company {k}" for k in range(1, name_hi + 1)],
                              name - 1, t, p[1])}


def call_center(n: int, gen, device) -> Columns:
    t = "call_center"
    i = _ids(n, device)
    names = person_pool()
    out = _keys(t, "cc_call_center_sk", "cc_call_center_id", n, device)
    out["cc_rec_start_date"] = date_column(_open_date(n, gen, device), t,
                                           "cc_rec_start_date")
    out["cc_rec_end_date"] = null_ints(n, t, "cc_rec_end_date", device)
    out["cc_closed_date_sk"] = null_ints(n, t, "cc_closed_date_sk", device)
    out["cc_open_date_sk"] = int_column(_open_date(n, gen, device), t,
                                        "cc_open_date_sk")
    out["cc_name"] = pool_column(CC_NAMES, i % len(CC_NAMES), t, "cc_name")
    out["cc_class"] = pool_column(CC_CLASSES, i % 3, t, "cc_class")
    out["cc_employees"] = int_column(uniform_int(100, 700, n, gen, device),
                                     t, "cc_employees")
    out["cc_sq_ft"] = int_column(uniform_int(10000, 40000, n, gen, device),
                                 t, "cc_sq_ft")
    out["cc_hours"] = pool_column(HOURS, i % 3, t, "cc_hours")
    out["cc_manager"] = pool_column(names, person_names(n, gen, device), t,
                                    "cc_manager")
    out["cc_mkt_id"] = int_column(uniform_int(1, 6, n, gen, device), t,
                                  "cc_mkt_id")
    out["cc_mkt_class"] = _sentence(t, "cc_mkt_class", n, 3, gen, device)
    out["cc_mkt_desc"] = _sentence(t, "cc_mkt_desc", n, 8, gen, device)
    out["cc_market_manager"] = pool_column(
        names, person_names(n, gen, device), t, "cc_market_manager")
    div = uniform_int(1, 2, n, gen, device)
    out["cc_division"] = int_column(div, t, "cc_division")
    out["cc_division_name"] = pool_column(
        ("Division 1", "Division 2"), uniform_int(0, 1, n, gen, device), t,
        "cc_division_name")
    out.update(_companies(t, ("cc_company", "cc_company_name"), n, gen,
                          device, 6, 6))
    out.update(address(t, "cc_", n, gen, device))
    out["cc_gmt_offset"] = int_column(
        -uniform_int(5, 10, n, gen, device) * 100, t, "cc_gmt_offset")
    out["cc_tax_percentage"] = int_column(uniform_int(0, 11, n, gen, device),
                                          t, "cc_tax_percentage")
    return out


def _sentence(t, name, n, k, gen, device, width=None) -> Column:
    codes, dictionary = sentences(n, k, gen, device, width)
    return Column(codes, ctype(t, name), None, dictionary)


def customer(n: int, sz: Dict[str, int], gen, device) -> Columns:
    """ndsgen gen_customer: demographics, household and address keys 4%
    NULL each, a first sale up to 1,000 days before the sales window and
    its first ship-to up to 30 days after, a name and its e-mail."""
    t = "customer"
    out = _keys(t, "c_customer_sk", "c_customer_id", n, device)
    for name, dim in (("c_current_cdemo_sk", "customer_demographics"),
                      ("c_current_hdemo_sk", "household_demographics"),
                      ("c_current_addr_sk", "customer_address")):
        ok = chance(0.96, n, gen, device)
        out[name] = int_column(uniform_int(1, sz[dim], n, gen, device), t,
                               name, ok)
    first_sale = uniform_int(SALES_FIRST_JD - 1000, SALES_LAST_JD, n, gen,
                             device)
    out["c_first_shipto_date_sk"] = int_column(
        first_sale + uniform_int(0, 30, n, gen, device), t,
        "c_first_shipto_date_sk")
    out["c_first_sales_date_sk"] = int_column(first_sale, t,
                                              "c_first_sales_date_sk")
    out["c_salutation"] = pool_column(
        SALUTATIONS, uniform_int(0, len(SALUTATIONS) - 1, n, gen, device), t,
        "c_salutation")
    first = uniform_int(0, len(FIRST_NAMES) - 1, n, gen, device)
    last = uniform_int(0, len(LAST_NAMES) - 1, n, gen, device)
    out["c_first_name"] = pool_column(FIRST_NAMES, first, t, "c_first_name")
    out["c_last_name"] = pool_column(LAST_NAMES, last, t, "c_last_name")
    out["c_preferred_cust_flag"] = flags(chance(0.5, n, gen, device), t,
                                         "c_preferred_cust_flag")
    for name, lo, hi in (("c_birth_day", 1, 28), ("c_birth_month", 1, 12),
                         ("c_birth_year", 1924, 1992)):
        out[name] = int_column(uniform_int(lo, hi, n, gen, device), t, name)
    out["c_birth_country"] = pool_column(
        BIRTH_COUNTRIES, uniform_int(0, len(BIRTH_COUNTRIES) - 1, n, gen,
                                     device), t, "c_birth_country")
    out["c_login"] = null_strings(n, t, "c_login", device)
    out["c_email_address"] = pool_column(
        [f"{f}.{la}@example.com" for f in FIRST_NAMES for la in LAST_NAMES],
        first * len(LAST_NAMES) + last, t, "c_email_address")
    out["c_last_review_date_sk"] = int_column(
        uniform_int(SALES_LAST_JD - 400, SALES_LAST_JD, n, gen, device), t,
        "c_last_review_date_sk")
    return out


def web_site(n: int, gen, device) -> Columns:
    t = "web_site"
    i = _ids(n, device)
    names = person_pool()
    out = _keys(t, "web_site_sk", "web_site_id", n, device)
    out["web_rec_start_date"] = date_column(_open_date(n, gen, device), t,
                                            "web_rec_start_date")
    out["web_rec_end_date"] = null_ints(n, t, "web_rec_end_date", device)
    out["web_name"] = pool_column(SITE_NAMES, i % 6, t, "web_name")
    out["web_open_date_sk"] = int_column(_open_date(n, gen, device), t,
                                         "web_open_date_sk")
    out["web_close_date_sk"] = null_ints(n, t, "web_close_date_sk", device)
    out["web_class"] = _sentence(t, "web_class", n, 2, gen, device)
    out["web_manager"] = pool_column(names, person_names(n, gen, device), t,
                                     "web_manager")
    out["web_mkt_id"] = int_column(uniform_int(1, 6, n, gen, device), t,
                                   "web_mkt_id")
    out["web_mkt_class"] = _sentence(t, "web_mkt_class", n, 3, gen, device)
    out["web_mkt_desc"] = _sentence(t, "web_mkt_desc", n, 8, gen, device)
    out["web_market_manager"] = pool_column(
        names, person_names(n, gen, device), t, "web_market_manager")
    out.update(_companies(t, ("web_company_id", "web_company_name"), n, gen,
                          device, 2, 6))
    out.update(address(t, "web_", n, gen, device))
    out["web_gmt_offset"] = int_column(
        -uniform_int(5, 10, n, gen, device) * 100, t, "web_gmt_offset")
    out["web_tax_percentage"] = int_column(
        uniform_int(0, 11, n, gen, device), t, "web_tax_percentage")
    return out


def web_page(n: int, n_customer: int, gen, device) -> Columns:
    t = "web_page"
    i = _ids(n, device)
    out = _keys(t, "wp_web_page_sk", "wp_web_page_id", n, device)
    out["wp_rec_start_date"] = date_column(_open_date(n, gen, device), t,
                                           "wp_rec_start_date")
    out["wp_rec_end_date"] = null_ints(n, t, "wp_rec_end_date", device)
    out["wp_creation_date_sk"] = int_column(
        SALES_FIRST_JD - uniform_int(0, 1000, n, gen, device), t,
        "wp_creation_date_sk")
    out["wp_access_date_sk"] = int_column(
        SALES_FIRST_JD + uniform_int(0, 1000, n, gen, device), t,
        "wp_access_date_sk")
    out["wp_autogen_flag"] = flags(chance(0.3, n, gen, device), t,
                                   "wp_autogen_flag")
    ok = chance(0.2, n, gen, device)
    out["wp_customer_sk"] = int_column(
        uniform_int(1, n_customer, n, gen, device), t, "wp_customer_sk", ok)
    out["wp_url"] = pool_column(
        [f"http://www.example.com/page_{k}" for k in range(1, n + 1)], i, t,
        "wp_url")
    out["wp_type"] = pool_column(PAGE_TYPES, i % 7, t, "wp_type")
    for name, lo, hi in (("wp_char_count", 100, 7000),
                         ("wp_link_count", 2, 25),
                         ("wp_image_count", 1, 7),
                         ("wp_max_ad_count", 0, 4)):
        out[name] = int_column(uniform_int(lo, hi, n, gen, device), t, name)
    return out


def promotion(n: int, n_item: int, gen, device) -> Columns:
    t = "promotion"
    i = _ids(n, device)
    out = _keys(t, "p_promo_sk", "p_promo_id", n, device)
    start = uniform_int(SALES_FIRST_JD, SALES_LAST_JD - 60, n, gen, device)
    out["p_start_date_sk"] = int_column(start, t, "p_start_date_sk")
    out["p_end_date_sk"] = int_column(
        start + uniform_int(10, 60, n, gen, device), t, "p_end_date_sk")
    out["p_item_sk"] = int_column(uniform_int(1, n_item, n, gen, device), t,
                                  "p_item_sk")
    out["p_cost"] = int_column(torch.full_like(i, 100000), t, "p_cost")
    out["p_response_target"] = int_column(uniform_int(1, 3, n, gen, device),
                                          t, "p_response_target")
    out["p_promo_name"] = pool_column(
        [f"promo_{k}" for k in range(1, n + 1)], i, t, "p_promo_name")
    for c in ("dmail", "email", "catalog", "tv", "radio", "press", "event",
              "demo"):
        out[f"p_channel_{c}"] = flags(chance(0.5, n, gen, device), t,
                                      f"p_channel_{c}")
    out["p_channel_details"] = _sentence(t, "p_channel_details", n, 5, gen,
                                         device)
    out["p_purpose"] = pool_column(PURPOSES, i % 4, t, "p_purpose")
    out["p_discount_active"] = flags(chance(0.5, n, gen, device), t,
                                     "p_discount_active")
    return out


def catalog_page(n: int, gen, device) -> Columns:
    t = "catalog_page"
    i = _ids(n, device)
    catalog = i // CATALOG_PAGES_PER_CATALOG
    start = SALES_FIRST_JD + catalog * 30
    out = _keys(t, "cp_catalog_page_sk", "cp_catalog_page_id", n, device)
    out["cp_start_date_sk"] = int_column(start, t, "cp_start_date_sk")
    out["cp_end_date_sk"] = int_column(start + 90, t, "cp_end_date_sk")
    out["cp_department"] = constant_string("DEPARTMENT", n, t,
                                           "cp_department", device)
    out["cp_catalog_number"] = int_column(catalog + 1, t,
                                          "cp_catalog_number")
    out["cp_catalog_page_number"] = int_column(
        i % CATALOG_PAGES_PER_CATALOG + 1, t, "cp_catalog_page_number")
    out["cp_description"] = _sentence(t, "cp_description", n, 8, gen, device)
    out["cp_type"] = pool_column(CATALOG_PAGE_TYPES, i % 3, t, "cp_type")
    return out


def store(n: int, gen, extra, device) -> Columns:
    """gen_store: name, GMT offset, company and state from the main
    generator ``gen``, in their order; the rest from ``extra``."""
    name = uniform_int(0, len(LAST_NAMES) - 1, n, gen, device)
    gmt = torch.tensor(STORE_GMT[0], dtype=torch.int64, device=device)[
        weighted_pick(STORE_GMT[1], n, gen, device)]
    company = uniform_int(0, 1, n, gen, device)
    state = weighted_pick(STORE_STATES[1], n, gen, device)
    t = "store"
    i = _ids(n, device)
    names = person_pool()
    out = _keys(t, "s_store_sk", "s_store_id", n, device)
    out["s_rec_start_date"] = date_column(_open_date(n, extra, device), t,
                                          "s_rec_start_date")
    out["s_rec_end_date"] = null_ints(n, t, "s_rec_end_date", device)
    closed = chance(0.1, n, extra, device)
    out["s_closed_date_sk"] = int_column(
        uniform_int(SALES_FIRST_JD, SALES_LAST_JD, n, extra, device), t,
        "s_closed_date_sk", closed)
    out["s_store_name"] = pool_column([f"{s} Store" for s in LAST_NAMES],
                                      name, t, "s_store_name")
    out["s_number_employees"] = int_column(
        uniform_int(200, 300, n, extra, device), t, "s_number_employees")
    out["s_floor_space"] = int_column(
        uniform_int(5000000, 9999999, n, extra, device), t, "s_floor_space")
    out["s_hours"] = pool_column(HOURS, i % 3, t, "s_hours")
    out["s_manager"] = pool_column(names, person_names(n, extra, device), t,
                                   "s_manager")
    out["s_market_id"] = int_column(uniform_int(1, 10, n, extra, device), t,
                                    "s_market_id")
    out["s_geography_class"] = _sentence(t, "s_geography_class", n, 6, extra,
                                         device)
    out["s_market_desc"] = _sentence(t, "s_market_desc", n, 10, extra, device)
    out["s_market_manager"] = pool_column(
        names, person_names(n, extra, device), t, "s_market_manager")
    div = uniform_int(1, 2, n, extra, device)
    out["s_division_id"] = int_column(div, t, "s_division_id")
    out["s_division_name"] = pool_column(
        ("Division 1", "Division 2"), div - 1, t, "s_division_name")
    out["s_company_id"] = int_column(company + 1, t, "s_company_id")
    out["s_company_name"] = pool_column(("Company 1", "Company 2"), company,
                                        t, "s_company_name")
    out.update(address(t, "s_", n, extra, device, city_dist="store_cities",
                       state_dist="store_states"))
    out["s_state"] = pool_column(STORE_STATES[0], state, t, "s_state")
    out["s_gmt_offset"] = int_column(gmt * 100, t, "s_gmt_offset")
    out["s_tax_precentage"] = int_column(uniform_int(0, 11, n, extra, device),
                                         t, "s_tax_precentage")
    return out


def item(n: int, gen, extra, device) -> Columns:
    """gen_item's columns: those of the main generator ``gen`` first, in
    their order, then size, color and units, then the record dates,
    wholesale cost and formulation, from the stream ``extra``."""
    cat = weighted_pick(CATEGORY_WEIGHTS, n, gen, device)
    cls = weighted_pick(CLASS_WEIGHTS, n, gen, device)
    brand = uniform_int(1, BRANDS_PER_CLASS, n, gen, device)
    manufact = uniform_int(1, 1000, n, gen, device)
    manager = uniform_int(1, 100, n, gen, device)
    brand_names = [f"{c} #{b}" for c in CLASSES
                   for b in range(1, BRANDS_PER_CLASS + 1)]
    price = uniform_int(100, 10000, n, gen, device)
    t = "item"
    out = _keys(t, "i_item_sk", "i_item_id", n, device)
    # descriptions: 5..20 words of the pool
    lo, hi = DESC_WORDS
    n_words = uniform_int(lo, hi, n, gen, device)
    out["i_item_desc"] = _sentence(t, "i_item_desc", n, n_words, gen, device,
                                   width=hi)
    color = uniform_int(0, len(COLORS) - 1, n, gen, device).cpu().numpy()
    name_codes, name_dict = string_column(
        [f"{COLORS[c]}{sk}" for sk, c in enumerate(color.tolist(), 1)],
        _ids(n, device))
    size = uniform_int(0, len(SIZES) - 1, n, extra, device)
    i_color = weighted_pick(COLOR_WEIGHTS, n, extra, device)
    units = uniform_int(0, len(UNITS) - 1, n, extra, device)
    start = SALES_FIRST_JD - uniform_int(0, 1000, n, extra, device)
    ends = chance(0.25, n, extra, device)
    end = SALES_LAST_JD + uniform_int(0, 200, n, extra, device)
    wholesale = (price * uniform_int(30, 90, n, extra, device)) // 100
    out["i_rec_start_date"] = date_column(start, t, "i_rec_start_date")
    out["i_rec_end_date"] = date_column(end, t, "i_rec_end_date", ends)
    out["i_current_price"] = int_column(price, t, "i_current_price")
    out["i_wholesale_cost"] = int_column(wholesale, t, "i_wholesale_cost")
    out["i_brand_id"] = int_column(
        (cat + 1) * 1000000 + (cls + 1) * 1000 + brand, t, "i_brand_id")
    out["i_brand"] = pool_column(brand_names, cls * BRANDS_PER_CLASS +
                                 brand - 1, t, "i_brand")
    out["i_class_id"] = int_column(cls + 1, t, "i_class_id")
    out["i_class"] = pool_column(CLASSES, cls, t, "i_class")
    out["i_category_id"] = int_column(cat + 1, t, "i_category_id")
    out["i_category"] = pool_column(CATEGORIES, cat, t, "i_category")
    out["i_manufact_id"] = int_column(manufact, t, "i_manufact_id")
    out["i_manufact"] = pool_column([f"manu#{m}" for m in range(1, 1001)],
                                    manufact - 1, t, "i_manufact")
    out["i_size"] = pool_column(SIZES, size, t, "i_size")
    out["i_formulation"] = _sentence(t, "i_formulation", n, 2, extra, device)
    out["i_color"] = pool_column(COLORS, i_color, t, "i_color")
    out["i_units"] = pool_column(UNITS, units, t, "i_units")
    out["i_container"] = constant_string("Unknown", n, t, "i_container",
                                         device)
    out["i_manager_id"] = int_column(manager, t, "i_manager_id")
    out["i_product_name"] = Column(name_codes, ctype(t, "i_product_name"),
                                   None, name_dict)
    return out


def dbgen_version(device) -> Columns:
    t = "dbgen_version"
    return {
        "dv_version": constant_string("ndsgen-1.0", 1, t, "dv_version",
                                      device),
        "dv_create_date": date_column(torch.full((1,), SALES_LAST_JD,
                                                 device=device), t,
                                      "dv_create_date"),
        "dv_create_time": constant_string("00:00:00", 1, t, "dv_create_time",
                                          device),
        "dv_cmdline_args": constant_string("-scale", 1, t, "dv_cmdline_args",
                                           device),
    }
