"""Generate the q3-family warehouse directly on the device.

Builds ``date_dim``, ``item`` and ``store_sales`` as tensors on ``device``
with one explicit ``torch.Generator``, following the models of the JAX
package's C++ generator (``ndstpu/datagen/ndsgen.cpp``):

* row counts from its step table (TPC-DS spec Table 3-2: SF 1/10/100/1000,
  linear for facts and log-linear for dimensions in between);
* ``gen_sale``: 2% NULL ``ss_sold_date_sk``, dates uniform over
  1998-01-02..2003-01-02 with 30% of sales moved into Nov/Dec, Zipf
  ``ss_item_sk`` with the coprime scatter, ``ext_sales = quantity x sales``
  in the same cent ranges;
* ``gen_item``: weighted category and class (``dists.json`` weights), the
  ``brand_id = (cat+1)*10^6 + (cls+1)*10^3 + brand`` encoding, ``i_brand``
  strings, ``i_manufact_id`` 1..1000, ``i_manager_id`` 1..100;
* ``gen_date_dim``: the calendar from 1900-01-02, 73,049 days.

Only the columns the q3 family reads are generated.  The numbers are not
ndsgen's (the random streams differ); the distributions are.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ndstpu_torch.engine.columnar import Column, Table
from ndstpu_torch.io.catalog import Catalog
from ndstpu_torch.schema import DType, get_schemas

# published row counts at SF 1 / 10 / 100 / 1000 (ndsgen.cpp compute_sizes)
_STEPS = {
    "store_sales": ((2880404, 28800991, 287997024, 2879987999), True),
    "item": ((18000, 102000, 204000, 300000), False),
}
DATE_DIM_ROWS = 73049
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

# the generated columns, per table
COLUMNS = {
    "date_dim": ("d_date_sk", "d_year", "d_moy"),
    "item": ("i_item_sk", "i_brand_id", "i_brand", "i_category_id",
             "i_category", "i_manufact_id", "i_manager_id"),
    "store_sales": ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"),
}

_CHUNK_ROWS = 1 << 25


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
    return out


def civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), integer math only
    (jaxexec._civil_from_days, in int64)."""
    z = days.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - doe // 1460 + doe // 36524 - doe // 146096, 365,
                    rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = mp + torch.where(mp < 10, 3, -9)
    return y + (m <= 2).to(torch.int64), m, d


def _days_from_civil(y: int, m: int, d: int) -> int:
    return (np.datetime64(f"{y:04d}-{m:02d}-{d:02d}") -
            np.datetime64("1970-01-01")).astype(int).item()


def _ctype(table: str, column: str) -> DType:
    t = get_schemas()[table].column(column).dtype
    return DType(t.kind, precision=t.precision, scale=t.scale)


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
    """Dictionary-code ``values[idx]`` against the sorted dictionary."""
    dictionary = np.array(sorted(values), dtype=object)
    pos = {v: i for i, v in enumerate(dictionary)}
    code_of = torch.tensor([pos[v] for v in values], dtype=torch.int32,
                           device=idx.device)
    return code_of[idx], dictionary


def _date_dim(device) -> Table:
    jd = torch.arange(DATE_DIM_ROWS, dtype=torch.int64,
                      device=device) + _DATE_DIM_FIRST_JD
    y, m, _ = civil_from_days(jd - _JD_EPOCH_1970)
    return Table({
        "d_date_sk": Column(jd.to(torch.int32),
                            _ctype("date_dim", "d_date_sk")),
        "d_year": Column(y, _ctype("date_dim", "d_year")),
        "d_moy": Column(m, _ctype("date_dim", "d_moy")),
    })


def _item(n: int, gen, device) -> Table:
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
    ct = lambda c: _ctype("item", c)  # noqa: E731
    return Table({
        "i_item_sk": Column(torch.arange(1, n + 1, dtype=torch.int32,
                                         device=device), ct("i_item_sk")),
        "i_brand_id": Column((cat + 1) * 1000000 + (cls + 1) * 1000 + brand,
                             ct("i_brand_id")),
        "i_brand": Column(brand_codes, ct("i_brand"), None, brand_dict),
        "i_category_id": Column(cat + 1, ct("i_category_id")),
        "i_category": Column(cat_codes, ct("i_category"), None, cat_dict),
        "i_manufact_id": Column(manufact, ct("i_manufact_id")),
        "i_manager_id": Column(manager, ct("i_manager_id")),
    })


def _store_sales(n: int, n_item: int, gen, device) -> Table:
    date_sk = torch.empty(n, dtype=torch.int32, device=device)
    date_ok = torch.empty(n, dtype=torch.bool, device=device)
    item_sk = torch.empty(n, dtype=torch.int32, device=device)
    ext_sales = torch.empty(n, dtype=torch.int64, device=device)
    # Nov 1 of each sales year, as a Julian day (holiday-season skew)
    years = range(1998, 2004)
    nov1 = torch.tensor([_days_from_civil(y, 11, 1) + _JD_EPOCH_1970
                         for y in years], dtype=torch.int64, device=device)
    for b in range(0, n, _CHUNK_ROWS):
        e = min(n, b + _CHUNK_ROWS)
        k = e - b
        null = torch.rand(k, generator=gen, device=device,
                          dtype=torch.float64) < 0.02
        jd = _uniform_int(_SALES_FIRST_JD, _SALES_LAST_JD, k, gen, device)
        holiday = torch.rand(k, generator=gen, device=device,
                             dtype=torch.float64) < 0.30
        hol_off = _uniform_int(0, 60, k, gen, device)
        y, _, _ = civil_from_days(jd - _JD_EPOCH_1970)
        y = torch.clamp(y, max=2002)   # Nov 2003 exceeds the window
        jd = torch.where(holiday, nov1[y - years[0]] + hol_off, jd)
        date_sk[b:e] = jd.to(torch.int32)
        date_ok[b:e] = ~null
        item_sk[b:e] = _zipf(n_item, k, gen, device).to(torch.int32)
        quantity = _uniform_int(1, 100, k, gen, device)
        wholesale = _uniform_int(100, 10000, k, gen, device)
        lst = wholesale + _uniform_int(0, wholesale, k, gen, device)
        sales = (lst * _uniform_int(20, 100, k, gen, device)) // 100
        ext_sales[b:e] = quantity * sales
    ct = lambda c: _ctype("store_sales", c)  # noqa: E731
    return Table({
        "ss_sold_date_sk": Column(date_sk, ct("ss_sold_date_sk"), date_ok),
        "ss_item_sk": Column(item_sk, ct("ss_item_sk")),
        "ss_ext_sales_price": Column(ext_sales, ct("ss_ext_sales_price")),
    })


def generate(scale: float, seed: int, device) -> Catalog:
    """A catalog of ``date_dim``, ``item`` and ``store_sales`` at
    ``scale``, generated on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = sizes(scale)
    cat = Catalog()
    cat.register("date_dim", _date_dim(device))
    cat.register("item", _item(n["item"], gen, device))
    cat.register("store_sales",
                 _store_sales(n["store_sales"], n["item"], gen, device))
    return cat
