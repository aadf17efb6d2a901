"""Generate the store-channel warehouse directly on the device.

Builds the tables the port's slices read as tensors on ``device`` with one
explicit ``torch.Generator``, following the models of the JAX package's
C++ generator (``ndstpu/datagen/ndsgen.cpp``):

* row counts from its step table (TPC-DS spec Table 3-2: SF 1/10/100/1000,
  linear for facts and log-linear for dimensions in between);
* ``gen_sale``: 2% NULL ``ss_sold_date_sk``, dates uniform over
  1998-01-02..2003-01-02 with 30% of sales moved into Nov/Dec, time of day
  uniform, Zipf ``ss_item_sk`` and ``ss_customer_sk`` (3% NULL) with the
  coprime scatter, uniform ``ss_hdemo_sk`` and ``ss_store_sk`` (2% NULL),
  ``ss_ticket_number = row / 3 + 1``, and the cent arithmetic of
  ``sales``, ``ext_discount``, ``net_paid`` (15% of sales carry a
  coupon of up to half the extended price) and ``net_profit`` (net paid
  less the extended wholesale cost);
* ``return_parent_row`` / ``gen_return``: return ``j`` is sale
  ``(j * stride) mod n``, whose item and ticket it carries, with a return
  quantity uniform up to the sale's and a uniform reason;
* ``gen_item``: weighted category and class (``dists.json`` weights), the
  ``brand_id = (cat+1)*10^6 + (cls+1)*10^3 + brand`` encoding, ``i_brand``
  and ``i_class`` strings, ``i_manufact_id`` 1..1000 and ``i_manufact``
  its ``"manu#<id>"`` name, ``i_manager_id`` 1..100, ``i_item_id`` the
  business key, ``i_item_desc`` a sentence of 5..20 words of the word
  pool, ``i_current_price`` 1.00..100.00, ``i_product_name`` a color and
  the surrogate key, ``i_color`` weighted by ``dists.json`` "colors", and
  ``i_units`` and ``i_size`` uniform over ``kUnits`` and ``kSizes``;
* ``gen_date_dim``: the calendar from 1900-01-02, 73,049 days, with the
  date, quarter, month sequence (months since January 1900), week
  sequence (weeks since 1900-01-02) and day names;
* ``gen_store_sales``: the sale's wholesale cost, list price and coupon
  kept as columns;
* ``gen_catalog_sales`` and ``gen_web_sales``, reduced to the sold date,
  item and extended sales price of ``gen_sale``'s model, with
  ``cs_ship_addr_sk`` uniform over customer_address (never NULL) and
  ``ws_ship_customer_sk`` NULL where the sale's customer is (3%),
  otherwise the sale's Zipf customer 85% of the time and a uniform one
  else;
* ``gen_store`` (weighted ``s_state`` from ``store_states``,
  ``s_company_name`` "Company 1" or "Company 2"), ``gen_reason``,
  ``gen_household_demographics`` and ``gen_time_dim``.

Only the columns of :data:`COLUMNS` are generated.  The numbers are not
ndsgen's (the random streams differ); the distributions are.  The main
generator draws every column it drew when the channel had only its first
columns, in the same order; the item columns added later and the catalog
and web tables draw from streams of their own (ndsgen keeps its "extra
columns stream" the same way), so the earlier columns keep their values.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ndstpu_torch.engine.columnar import Column, Table
from ndstpu_torch.engine.torchexec import civil_from_days
from ndstpu_torch.io.catalog import Catalog
from ndstpu_torch.schema import DType, get_schemas

# published row counts at SF 1 / 10 / 100 / 1000 (ndsgen.cpp compute_sizes)
_STEPS = {
    "store_sales": ((2880404, 28800991, 287997024, 2879987999), True),
    "catalog_sales": ((1441548, 14401261, 143997065, 1439980416), True),
    "web_sales": ((719384, 7197566, 72001237, 720000376), True),
    "store_returns": ((287514, 2875432, 28795080, 287999764), True),
    "item": ((18000, 102000, 204000, 300000), False),
    "customer": ((100000, 500000, 2000000, 12000000), False),
    "customer_address": ((50000, 250000, 1000000, 6000000), False),
    "store": ((12, 102, 402, 1002), False),
    "reason": ((35, 45, 55, 65), False),
}
DATE_DIM_ROWS = 73049
TIME_DIM_ROWS = 86400
HOUSEHOLD_DEMOGRAPHICS_ROWS = 7200
_TICKET_SPREAD = 3
_JD_EPOCH_1970 = 2440588
_DATE_DIM_FIRST_JD = 2415022        # 1900-01-02
_SALES_FIRST_JD = 2450816           # 1998-01-02
_SALES_LAST_JD = 2452642            # 2003-01-02
_ZIPF_SCATTER = (2654435761, 1073741827, 805306457, 100000007)

# ndstpu/datagen/dists.json "categories" and "classes"
_CATEGORIES = ("Women", "Men", "Children", "Shoes", "Music", "Jewelry",
               "Home", "Sports", "Books", "Electronics")
_CATEGORY_WEIGHTS = (18, 15, 12, 10, 10, 8, 8, 7, 6, 6)
_CLASSES = ("accent", "bathroom", "bedding", "classical", "country",
            "dresses", "fragrances", "infants", "maternity", "pants", "pop",
            "rock", "shirts", "swimwear", "athletic", "casual", "formal",
            "mens watch", "womens watch", "computers", "cameras",
            "televisions", "football", "baseball", "basketball", "fiction",
            "history", "romance", "self-help", "travel")
_CLASS_WEIGHTS = (4, 4, 5, 3, 3, 6, 4, 4, 4, 6, 4, 3, 6, 3, 5, 5, 4, 2, 2, 4,
                  3, 3, 3, 3, 3, 4, 3, 3, 2, 2)
_BRANDS_PER_CLASS = 10
_DAY_NAMES = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday")
# ndsgen.cpp kLastNames (store names are "<last name> Store")
_LAST_NAMES = (
    "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia", "Miller",
    "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez", "Gonzalez",
    "Wilson", "Anderson", "Thomas", "Taylor", "Moore", "Jackson", "Martin",
    "Lee", "Perez", "Thompson", "White", "Harris", "Sanchez", "Clark",
    "Ramirez", "Lewis", "Robinson", "Walker", "Young", "Allen", "King",
    "Wright", "Scott", "Torres", "Nguyen", "Hill", "Flores")
# dists.json "store_gmt" (hours, weights)
_STORE_GMT = ((-5, -6), (60, 40))
# dists.json "reasons": descriptions cycle through these 35 entries
_REASONS = (
    "Package was damaged", "Stopped working", "Did not get it on time",
    "Not the product that was ordred", "Parts missing",
    "Does not work with a product that I have", "Gift exchange",
    "Did not like the color", "Did not like the model",
    "Did not like the make", "Did not like the warranty",
    "No service location in my area", "Found a better price in a store",
    "Found a better extended warranty") + tuple(
        f"reason {i}" for i in range(15, 36))
# dists.json "store_states" (values, weights)
_STORE_STATES = (("TN", "GA", "TX", "CA", "OH", "IL", "NY", "FL"),
                 (30, 20, 15, 10, 8, 7, 6, 4))
# ndsgen.cpp kColors (i_product_name's color, picked uniformly)
_COLORS = (
    "red", "blue", "green", "yellow", "purple", "orange", "black", "white",
    "pink", "brown", "gray", "cyan", "magenta", "ivory", "khaki", "lavender",
    "maroon", "navy", "olive", "salmon", "tan", "teal", "turquoise",
    "violet", "beige", "azure", "chartreuse", "coral", "crimson", "gold",
    "silver", "plum", "orchid", "peach", "mint", "rose", "ghost", "snow",
    "seashell", "linen")
# dists.json "colors" weights, over _COLORS (i_color's weighted pick)
_COLOR_WEIGHTS = (12, 12, 10, 8, 7, 7, 10, 10, 6, 6, 5, 3, 3, 4, 4, 4, 4, 5,
                  4, 4, 4, 4, 3, 3, 4, 2, 2, 3, 3, 4, 4, 2, 2, 3, 2, 3, 1, 2,
                  1, 1)
# ndsgen.cpp kUnits and kSizes (i_units, i_size: picked uniformly)
_UNITS = ("Each", "Dozen", "Case", "Pound", "Ounce", "Pallet", "Gross", "Box",
          "Carton", "Bundle", "Ton", "Dram", "Cup", "Gram", "Lb", "Oz", "Tbl",
          "Tsp", "Unknown", "N/A")
_SIZES = ("small", "medium", "large", "extra large", "economy", "petite",
          "N/A")
# ndsgen.cpp kWordPool (the words of sentence())
_WORDS = (
    "results", "important", "whole", "right", "general", "great", "special",
    "large", "social", "economic", "national", "young", "early", "possible",
    "different", "small", "major", "final", "international", "full",
    "public", "available", "local", "sure", "low", "necessary", "true",
    "significant", "recent", "certain", "military", "central", "similar",
    "main", "individual", "political", "common", "strong", "easy", "clear",
    "single", "hard", "good", "new", "old", "high", "long", "little", "own",
    "other")
_DESC_WORDS = (5, 20)
# dists.json "buy_potential"
_BUY_POTENTIAL = ("0-500", "501-1000", "1001-5000", "5001-10000", ">10000",
                  "Unknown")

# the generated columns, per table
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

_CHUNK_ROWS = 1 << 25
# seeds of the streams beside the main generator, mixed with ``seed``
_STREAM_ITEM, _STREAM_CATALOG, _STREAM_WEB = 1, 2, 3


def _step_count(sf: float, steps, fact: bool) -> int:
    """ndsgen.cpp step_count: the spec's step table, interpolated."""
    if sf < 1.0:
        f = sf if fact else 0.1 + 0.9 * sf
        return max(1, round(steps[0] * f))
    xs = (1.0, 10.0, 100.0, 1000.0)
    if sf >= 1000.0:
        v = steps[3] * (sf / 1000.0) if fact else \
            steps[3] * (steps[3] / steps[2]) ** math.log10(sf / 1000.0)
        return round(v)
    i = 0 if sf < 10.0 else (1 if sf < 100.0 else 2)
    if sf == xs[i]:
        v = steps[i]
    elif fact:
        w = (sf - xs[i]) / (xs[i + 1] - xs[i])
        v = steps[i] + w * (steps[i + 1] - steps[i])
    else:
        v = steps[i] * (steps[i + 1] / steps[i]) ** math.log10(sf / xs[i])
    return max(1, round(v))


def sizes(scale: float) -> Dict[str, int]:
    """Row counts of the generated tables at ``scale``."""
    out = {t: _step_count(scale, s, fact) for t, (s, fact) in _STEPS.items()}
    out["date_dim"] = DATE_DIM_ROWS
    out["time_dim"] = TIME_DIM_ROWS
    out["household_demographics"] = HOUSEHOLD_DEMOGRAPHICS_ROWS
    return out


def bkey(sk: int) -> str:
    """ndsgen.cpp bkey: the 16-character business key of a surrogate key
    (base-26 digits of ``sk`` right-aligned, padded with 'A')."""
    out = ["A"] * 16
    i = 15
    while i >= 0 and sk:
        out[i] = chr(ord("A") + sk % 26)
        sk //= 26
        i -= 1
    return "".join(out)


def _days_from_civil(y: int, m: int, d: int) -> int:
    return (np.datetime64(f"{y:04d}-{m:02d}-{d:02d}") -
            np.datetime64("1970-01-01")).astype(int).item()


def _ctype(table: str, column: str) -> DType:
    t = get_schemas()[table].column(column).dtype
    return DType(t.kind, precision=t.precision, scale=t.scale)


def _stream(seed: int, tag: int, device) -> torch.Generator:
    """A generator of its own for stream ``tag``, derived from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1000003 + tag) % (1 << 63))
    return gen


def _uniform_int(lo, hi, n: int, gen, device) -> torch.Tensor:
    """Uniform int64 in [lo, hi] (inclusive; tensor bounds allowed)."""
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return lo + torch.floor(u * (hi - lo + 1)).to(torch.int64)


def _weighted_pick(weights, n: int, gen, device) -> torch.Tensor:
    """Index drawn with the given integer weights (ndsgen dpick_idx)."""
    cum = torch.tensor(np.cumsum(weights), dtype=torch.int64, device=device)
    x = _uniform_int(0, int(cum[-1]) - 1, n, gen, device)
    return torch.searchsorted(cum, x, right=True)


def _zipf(n_keys: int, n: int, gen, device) -> torch.Tensor:
    """ndsgen Rng::zipf: rank = floor((n+1)^u) in 1..n, scattered over the
    key space by the first multiplier coprime with n."""
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    rank = torch.exp(u * math.log(n_keys + 1.0)).to(torch.int64)
    rank = torch.clamp(rank, 1, n_keys)
    for p in _ZIPF_SCATTER:
        if math.gcd(p % n_keys, n_keys) == 1:
            return ((rank - 1) * p) % n_keys + 1
    return rank


def _string_column(values, idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, np.ndarray]:
    """Dictionary-code ``values[idx]`` against the sorted dictionary of
    the distinct values."""
    dictionary, code_of = np.unique(np.asarray(values, dtype=object),
                                    return_inverse=True)
    code_of = torch.as_tensor(code_of.reshape(-1).astype(np.int32)).to(
        idx.device)
    return code_of[idx], dictionary.astype(object)


def _date_dim(device) -> Table:
    jd = torch.arange(DATE_DIM_ROWS, dtype=torch.int64,
                      device=device) + _DATE_DIM_FIRST_JD
    days70 = jd - _JD_EPOCH_1970
    y, m, _ = civil_from_days(days70)
    y, m = y.to(torch.int64), m.to(torch.int64)
    dow = torch.remainder(days70 + 4, 7)       # 0 = Sunday
    day_codes, day_dict = _string_column(_DAY_NAMES, dow)
    return Table({
        "d_date_sk": Column(jd.to(torch.int32),
                            _ctype("date_dim", "d_date_sk")),
        "d_date": Column(days70.to(torch.int32), _ctype("date_dim",
                                                        "d_date")),
        "d_month_seq": Column((y - 1900) * 12 + m - 1,
                              _ctype("date_dim", "d_month_seq")),
        "d_year": Column(y, _ctype("date_dim", "d_year")),
        "d_moy": Column(m, _ctype("date_dim", "d_moy")),
        "d_qoy": Column((m - 1) // 3 + 1, _ctype("date_dim", "d_qoy")),
        "d_day_name": Column(day_codes, _ctype("date_dim", "d_day_name"),
                             None, day_dict),
        "d_week_seq": Column((jd - _DATE_DIM_FIRST_JD) // 7 + 1,
                             _ctype("date_dim", "d_week_seq")),
    })


def _time_dim(device) -> Table:
    sk = torch.arange(TIME_DIM_ROWS, dtype=torch.int64, device=device)
    ct = lambda c: _ctype("time_dim", c)  # noqa: E731
    return Table({
        "t_time_sk": Column(sk.to(torch.int32), ct("t_time_sk")),
        "t_time": Column(sk, ct("t_time")),
        "t_hour": Column(sk // 3600, ct("t_hour")),
        "t_minute": Column((sk // 60) % 60, ct("t_minute")),
        "t_second": Column(sk % 60, ct("t_second")),
    })


def _household_demographics(device) -> Table:
    i = torch.arange(HOUSEHOLD_DEMOGRAPHICS_ROWS, dtype=torch.int64,
                     device=device)
    nbp = len(_BUY_POTENTIAL)
    bp_codes, bp_dict = _string_column(_BUY_POTENTIAL, (i // 20) % nbp)
    ct = lambda c: _ctype("household_demographics", c)  # noqa: E731
    return Table({
        "hd_demo_sk": Column((i + 1).to(torch.int32), ct("hd_demo_sk")),
        "hd_income_band_sk": Column((i % 20 + 1).to(torch.int32),
                                    ct("hd_income_band_sk")),
        "hd_buy_potential": Column(bp_codes, ct("hd_buy_potential"), None,
                                   bp_dict),
        "hd_dep_count": Column((i // (20 * nbp)) % 10, ct("hd_dep_count")),
        "hd_vehicle_count": Column((i // (200 * nbp)) % 6,
                                   ct("hd_vehicle_count")),
    })


def _keyed_strings(n: int, fn, device) -> Tuple[torch.Tensor, np.ndarray]:
    """Codes of ``fn(sk)`` for sk in 1..n against their sorted
    dictionary (each value distinct)."""
    values = [fn(sk) for sk in range(1, n + 1)]
    return _string_column(values, torch.arange(n, device=device))


def _store(n: int, gen, device) -> Table:
    name = _uniform_int(0, len(_LAST_NAMES) - 1, n, gen, device)
    name_codes, name_dict = _string_column(
        [f"{s} Store" for s in _LAST_NAMES], name)
    gmt = torch.tensor(_STORE_GMT[0], dtype=torch.int64, device=device)[
        _weighted_pick(_STORE_GMT[1], n, gen, device)]
    id_codes, id_dict = _keyed_strings(n, bkey, device)
    company_codes, company_dict = _string_column(
        ("Company 1", "Company 2"), _uniform_int(0, 1, n, gen, device))
    state_codes, state_dict = _string_column(
        _STORE_STATES[0], _weighted_pick(_STORE_STATES[1], n, gen, device))
    ct = lambda c: _ctype("store", c)  # noqa: E731
    return Table({
        "s_store_sk": Column(torch.arange(1, n + 1, dtype=torch.int32,
                                          device=device), ct("s_store_sk")),
        "s_store_id": Column(id_codes, ct("s_store_id"), None, id_dict),
        "s_store_name": Column(name_codes, ct("s_store_name"), None,
                               name_dict),
        "s_company_name": Column(company_codes, ct("s_company_name"), None,
                                 company_dict),
        "s_state": Column(state_codes, ct("s_state"), None, state_dict),
        "s_gmt_offset": Column(gmt * 100, ct("s_gmt_offset")),
    })


def _reason(n: int, device) -> Table:
    id_codes, id_dict = _keyed_strings(n, bkey, device)
    desc_codes, desc_dict = _string_column(
        _REASONS, torch.arange(n, device=device) % len(_REASONS))
    ct = lambda c: _ctype("reason", c)  # noqa: E731
    return Table({
        "r_reason_sk": Column(torch.arange(1, n + 1, dtype=torch.int32,
                                           device=device), ct("r_reason_sk")),
        "r_reason_id": Column(id_codes, ct("r_reason_id"), None, id_dict),
        "r_reason_desc": Column(desc_codes, ct("r_reason_desc"), None,
                                desc_dict),
    })


def _item(n: int, gen, extra, device) -> Table:
    """gen_item's columns: those of the main generator ``gen`` first, in
    their order, then size, color and units from the stream ``extra``."""
    cat = _weighted_pick(_CATEGORY_WEIGHTS, n, gen, device)
    cls = _weighted_pick(_CLASS_WEIGHTS, n, gen, device)
    brand = _uniform_int(1, _BRANDS_PER_CLASS, n, gen, device)
    manufact = _uniform_int(1, 1000, n, gen, device)
    manager = _uniform_int(1, 100, n, gen, device)
    brand_names = [f"{c} #{b}" for c in _CLASSES
                   for b in range(1, _BRANDS_PER_CLASS + 1)]
    brand_codes, brand_dict = _string_column(
        brand_names, cls * _BRANDS_PER_CLASS + brand - 1)
    cat_codes, cat_dict = _string_column(_CATEGORIES, cat)
    class_codes, class_dict = _string_column(_CLASSES, cls)
    price = _uniform_int(100, 10000, n, gen, device)
    id_codes, id_dict = _keyed_strings(n, bkey, device)
    # descriptions: 5..20 words of the pool, joined on the host (strings
    # live in host dictionaries)
    lo, hi = _DESC_WORDS
    n_words = _uniform_int(lo, hi, n, gen, device).cpu().numpy()
    words = _uniform_int(0, len(_WORDS) - 1, n * hi, gen,
                         device).view(n, hi).cpu().numpy()
    every = torch.arange(n, device=device)
    desc_codes, desc_dict = _string_column(
        [" ".join(_WORDS[w] for w in row[:k])
         for row, k in zip(words.tolist(), n_words.tolist())], every)
    color = _uniform_int(0, len(_COLORS) - 1, n, gen, device).cpu().numpy()
    name_codes, name_dict = _string_column(
        [f"{_COLORS[c]}{sk}" for sk, c in enumerate(color.tolist(), 1)],
        every)
    manu_codes, manu_dict = _string_column(
        [f"manu#{m}" for m in range(1, 1001)], manufact - 1)
    size_codes, size_dict = _string_column(
        _SIZES, _uniform_int(0, len(_SIZES) - 1, n, extra, device))
    color_codes, color_dict = _string_column(
        _COLORS, _weighted_pick(_COLOR_WEIGHTS, n, extra, device))
    units_codes, units_dict = _string_column(
        _UNITS, _uniform_int(0, len(_UNITS) - 1, n, extra, device))
    ct = lambda c: _ctype("item", c)  # noqa: E731
    return Table({
        "i_item_sk": Column(torch.arange(1, n + 1, dtype=torch.int32,
                                         device=device), ct("i_item_sk")),
        "i_item_id": Column(id_codes, ct("i_item_id"), None, id_dict),
        "i_item_desc": Column(desc_codes, ct("i_item_desc"), None,
                              desc_dict),
        "i_current_price": Column(price, ct("i_current_price")),
        "i_brand_id": Column((cat + 1) * 1000000 + (cls + 1) * 1000 + brand,
                             ct("i_brand_id")),
        "i_brand": Column(brand_codes, ct("i_brand"), None, brand_dict),
        "i_class": Column(class_codes, ct("i_class"), None, class_dict),
        "i_category_id": Column(cat + 1, ct("i_category_id")),
        "i_category": Column(cat_codes, ct("i_category"), None, cat_dict),
        "i_manufact_id": Column(manufact, ct("i_manufact_id")),
        "i_manager_id": Column(manager, ct("i_manager_id")),
        "i_product_name": Column(name_codes, ct("i_product_name"), None,
                                 name_dict),
        "i_manufact": Column(manu_codes, ct("i_manufact"), None, manu_dict),
        "i_color": Column(color_codes, ct("i_color"), None, color_dict),
        "i_units": Column(units_codes, ct("i_units"), None, units_dict),
        "i_size": Column(size_codes, ct("i_size"), None, size_dict),
    })


def _chance(p: float, k: int, gen, device) -> torch.Tensor:
    return torch.rand(k, generator=gen, device=device,
                      dtype=torch.float64) < p


def _sale_dates(k: int, gen, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen_sale's sold date of ``k`` sales: (Julian day as int32, valid).
    2% NULL; uniform over the sales window, with 30% of sales moved into
    Nov/Dec of their year."""
    years = range(1998, 2004)
    # Nov 1 of each sales year, as a Julian day (holiday-season skew)
    nov1 = torch.tensor([_days_from_civil(y, 11, 1) + _JD_EPOCH_1970
                         for y in years], dtype=torch.int64, device=device)
    ok = ~_chance(0.02, k, gen, device)
    jd = _uniform_int(_SALES_FIRST_JD, _SALES_LAST_JD, k, gen, device)
    holiday = _chance(0.30, k, gen, device)
    hol_off = _uniform_int(0, 60, k, gen, device)
    y, _, _ = civil_from_days(jd - _JD_EPOCH_1970)
    y = torch.clamp(y, max=2002)   # Nov 2003 exceeds the window
    jd = torch.where(holiday, nov1[y - years[0]] + hol_off, jd)
    return jd.to(torch.int32), ok


def _sale_prices(k: int, gen, device):
    """gen_sale's quantity and cents: (quantity 1..100, wholesale cost
    1.00..100.00, list price with a markup up to 100%, sales price 20..100%
    of list)."""
    q = _uniform_int(1, 100, k, gen, device)
    wholesale = _uniform_int(100, 10000, k, gen, device)
    lst = wholesale + _uniform_int(0, wholesale, k, gen, device)
    sales = (lst * _uniform_int(20, 100, k, gen, device)) // 100
    return q, wholesale, lst, sales


def _store_sales(n: int, sz: Dict[str, int], gen, device) -> Table:
    def empty(dtype):
        return torch.empty(n, dtype=dtype, device=device)
    date_sk, time_sk, item_sk, cust_sk, hdemo_sk, store_sk = (
        empty(torch.int32) for _ in range(6))
    date_ok, cust_ok, store_ok = (empty(torch.bool) for _ in range(3))
    quantity, sales_price, ext_discount, ext_sales, net_paid, net_profit = (
        empty(torch.int64) for _ in range(6))
    wholesale_cost, list_price, coupon_amt = (
        empty(torch.int64) for _ in range(3))

    for b in range(0, n, _CHUNK_ROWS):
        e = min(n, b + _CHUNK_ROWS)
        k = e - b
        date_sk[b:e], date_ok[b:e] = _sale_dates(k, gen, device)
        time_sk[b:e] = _uniform_int(0, 86399, k, gen, device).to(torch.int32)
        item_sk[b:e] = _zipf(sz["item"], k, gen, device).to(torch.int32)
        cust_ok[b:e] = ~_chance(0.03, k, gen, device)
        cust_sk[b:e] = _zipf(sz["customer"], k, gen, device).to(torch.int32)
        hdemo_sk[b:e] = _uniform_int(
            1, sz["household_demographics"], k, gen, device).to(torch.int32)
        store_ok[b:e] = ~_chance(0.02, k, gen, device)
        store_sk[b:e] = _uniform_int(1, sz["store"], k, gen,
                                     device).to(torch.int32)
        q, wholesale, lst, sales = _sale_prices(k, gen, device)
        ext = q * sales
        coupon = torch.where(_chance(0.15, k, gen, device),
                             _uniform_int(0, ext // 2, k, gen, device), 0)
        quantity[b:e] = q
        sales_price[b:e] = sales
        ext_discount[b:e] = q * lst - ext
        ext_sales[b:e] = ext
        net_paid[b:e] = ext - coupon
        net_profit[b:e] = ext - coupon - q * wholesale
        wholesale_cost[b:e] = wholesale
        list_price[b:e] = lst
        coupon_amt[b:e] = coupon
    ticket = torch.arange(n, dtype=torch.int64, device=device) // \
        _TICKET_SPREAD + 1
    ct = lambda c: _ctype("store_sales", c)  # noqa: E731
    return Table({
        "ss_sold_date_sk": Column(date_sk, ct("ss_sold_date_sk"), date_ok),
        "ss_sold_time_sk": Column(time_sk, ct("ss_sold_time_sk")),
        "ss_item_sk": Column(item_sk, ct("ss_item_sk")),
        "ss_customer_sk": Column(cust_sk, ct("ss_customer_sk"), cust_ok),
        "ss_hdemo_sk": Column(hdemo_sk, ct("ss_hdemo_sk")),
        "ss_store_sk": Column(store_sk, ct("ss_store_sk"), store_ok),
        "ss_ticket_number": Column(ticket, ct("ss_ticket_number")),
        "ss_quantity": Column(quantity, ct("ss_quantity")),
        "ss_sales_price": Column(sales_price, ct("ss_sales_price")),
        "ss_ext_discount_amt": Column(ext_discount,
                                      ct("ss_ext_discount_amt")),
        "ss_ext_sales_price": Column(ext_sales, ct("ss_ext_sales_price")),
        "ss_net_paid": Column(net_paid, ct("ss_net_paid")),
        "ss_net_profit": Column(net_profit, ct("ss_net_profit")),
        "ss_wholesale_cost": Column(wholesale_cost, ct("ss_wholesale_cost")),
        "ss_list_price": Column(list_price, ct("ss_list_price")),
        "ss_coupon_amt": Column(coupon_amt, ct("ss_coupon_amt")),
    })


def _channel_sales(table: str, n: int, sz: Dict[str, int], gen,
                   device) -> Table:
    """catalog_sales or web_sales, reduced to the columns of
    :data:`COLUMNS`: gen_sale's sold date, Zipf item and extended sales
    price, and the ship-to key of gen_catalog_sales (an address uniform
    over customer_address, never NULL) or gen_web_sales (the sale's
    customer, NULL where it is; otherwise that Zipf customer 85% of the
    time, a uniform one else)."""
    date_sk = torch.empty(n, dtype=torch.int32, device=device)
    item_sk = torch.empty(n, dtype=torch.int32, device=device)
    ship_sk = torch.empty(n, dtype=torch.int32, device=device)
    date_ok = torch.empty(n, dtype=torch.bool, device=device)
    ship_ok = torch.empty(n, dtype=torch.bool, device=device) \
        if table == "web_sales" else None
    ext_sales = torch.empty(n, dtype=torch.int64, device=device)
    for b in range(0, n, _CHUNK_ROWS):
        e = min(n, b + _CHUNK_ROWS)
        k = e - b
        date_sk[b:e], date_ok[b:e] = _sale_dates(k, gen, device)
        item_sk[b:e] = _zipf(sz["item"], k, gen, device).to(torch.int32)
        if table == "web_sales":
            ship_ok[b:e] = ~_chance(0.03, k, gen, device)
            cust = _zipf(sz["customer"], k, gen, device)
            other = _uniform_int(1, sz["customer"], k, gen, device)
            ship = torch.where(_chance(0.85, k, gen, device), cust, other)
        else:
            ship = _uniform_int(1, sz["customer_address"], k, gen, device)
        ship_sk[b:e] = ship.to(torch.int32)
        q, _, _, sales = _sale_prices(k, gen, device)
        ext_sales[b:e] = q * sales
    ct = lambda c: _ctype(table, c)  # noqa: E731
    p = table[0] + "s_"
    cols = {p + "sold_date_sk": Column(date_sk, ct(p + "sold_date_sk"),
                                       date_ok)}
    if table == "web_sales":
        cols[p + "item_sk"] = Column(item_sk, ct(p + "item_sk"))
        cols[p + "ship_customer_sk"] = Column(
            ship_sk, ct(p + "ship_customer_sk"), ship_ok)
    else:
        cols[p + "ship_addr_sk"] = Column(ship_sk, ct(p + "ship_addr_sk"))
        cols[p + "item_sk"] = Column(item_sk, ct(p + "item_sk"))
    cols[p + "ext_sales_price"] = Column(ext_sales,
                                         ct(p + "ext_sales_price"))
    return Table(cols)


def return_parent_rows(n_ret: int, n_sales: int, device) -> torch.Tensor:
    """ndsgen.cpp return_parent_row: return ``j`` is sale
    ``(j * stride) mod n_sales`` with ``stride = max(n_sales // n_ret,
    1)``."""
    stride = max(n_sales // max(n_ret, 1), 1)
    j = torch.arange(n_ret, dtype=torch.int64, device=device)
    return (j * stride) % n_sales


def _store_returns(n: int, sales: Table, n_reason: int, gen,
                   device) -> Table:
    parent = return_parent_rows(n, sales.num_rows, device)
    qty = sales.column("ss_quantity").data[parent]
    ct = lambda c: _ctype("store_returns", c)  # noqa: E731
    return Table({
        "sr_item_sk": Column(sales.column("ss_item_sk").data[parent],
                             ct("sr_item_sk")),
        "sr_reason_sk": Column(
            _uniform_int(1, n_reason, n, gen, device).to(torch.int32),
            ct("sr_reason_sk")),
        "sr_ticket_number": Column(
            sales.column("ss_ticket_number").data[parent],
            ct("sr_ticket_number")),
        "sr_return_quantity": Column(_uniform_int(1, qty, n, gen, device),
                                     ct("sr_return_quantity")),
    })


def generate(scale: float, seed: int, device) -> Catalog:
    """A catalog of the tables of :data:`COLUMNS` at ``scale``, generated
    on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = sizes(scale)
    cat = Catalog()
    cat.register("date_dim", _date_dim(device))
    cat.register("time_dim", _time_dim(device))
    cat.register("household_demographics", _household_demographics(device))
    cat.register("item", _item(n["item"], gen,
                               _stream(seed, _STREAM_ITEM, device), device))
    cat.register("store", _store(n["store"], gen, device))
    cat.register("reason", _reason(n["reason"], device))
    sales = _store_sales(n["store_sales"], n, gen, device)
    cat.register("store_sales", sales)
    cat.register("store_returns", _store_returns(
        n["store_returns"], sales, n["reason"], gen, device))
    for table, tag in (("catalog_sales", _STREAM_CATALOG),
                       ("web_sales", _STREAM_WEB)):
        cat.register(table, _channel_sales(
            table, n[table], n, _stream(seed, tag, device), device))
    return cat
