"""The generator's shared model: row counts, value pools, random draws and
column builders.

Row counts follow ``ndsgen.cpp``'s ``compute_sizes``; the weighted pools
come from this package's ``dists.json`` (a byte-for-byte copy of the JAX
package's, the file the query templates draw their parameters from), the
fixed pools from ``ndsgen.cpp``'s word lists.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ndstpu_torch.engine.columnar import Column, numpy_dtype
from ndstpu_torch.engine.torchexec import civil_from_days
from ndstpu_torch.schema import DType, get_schemas

DISTS_PATH = Path(__file__).resolve().parent / "dists.json"


def _load_dists() -> Dict[str, Tuple[tuple, tuple]]:
    with open(DISTS_PATH) as f:
        raw = json.load(f)
    return {name: (tuple(d["values"]), tuple(d["weights"]))
            for name, d in raw.items() if not name.startswith("_")}


DISTS = _load_dists()

# published row counts at SF 1 / 10 / 100 / 1000 (ndsgen.cpp compute_sizes)
STEPS = {
    "store_sales": ((2880404, 28800991, 287997024, 2879987999), True),
    "catalog_sales": ((1441548, 14401261, 143997065, 1439980416), True),
    "web_sales": ((719384, 7197566, 72001237, 720000376), True),
    "store_returns": ((287514, 2875432, 28795080, 287999764), True),
    "catalog_returns": ((144067, 1439749, 14404374, 143996756), True),
    "web_returns": ((71763, 719217, 7197670, 71997522), True),
    "item": ((18000, 102000, 204000, 300000), False),
    "customer": ((100000, 500000, 2000000, 12000000), False),
    "customer_address": ((50000, 250000, 1000000, 6000000), False),
    "store": ((12, 102, 402, 1002), False),
    "warehouse": ((5, 10, 15, 20), False),
    "web_page": ((60, 200, 2040, 3000), False),
    "promotion": ((300, 500, 1000, 1500), False),
    "call_center": ((6, 24, 30, 42), False),
    "web_site": ((30, 42, 24, 54), False),
    "catalog_page": ((11718, 12000, 20400, 30000), False),
    "reason": ((35, 45, 55, 65), False),
}
DATE_DIM_ROWS = 73049
TIME_DIM_ROWS = 86400
HOUSEHOLD_DEMOGRAPHICS_ROWS = 7200
INCOME_BAND_ROWS = 20
SHIP_MODE_ROWS = 20
INVENTORY_WEEKS = 261
TICKET_SPREAD = 3
JD_EPOCH_1970 = 2440588
DATE_DIM_FIRST_JD = 2415022        # 1900-01-02
SALES_FIRST_JD = 2450816           # 1998-01-02
SALES_LAST_JD = 2452642            # 2003-01-02
_ZIPF_SCATTER = (2654435761, 1073741827, 805306457, 100000007)
CHUNK_ROWS = 1 << 25


def _dist(name: str):
    return DISTS[name]


CATEGORIES, CATEGORY_WEIGHTS = _dist("categories")
CLASSES, CLASS_WEIGHTS = _dist("classes")
BRANDS_PER_CLASS = 10
DAY_NAMES = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday")
# ndsgen.cpp kLastNames and kFirstNames
LAST_NAMES = (
    "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia", "Miller",
    "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez", "Gonzalez",
    "Wilson", "Anderson", "Thomas", "Taylor", "Moore", "Jackson", "Martin",
    "Lee", "Perez", "Thompson", "White", "Harris", "Sanchez", "Clark",
    "Ramirez", "Lewis", "Robinson", "Walker", "Young", "Allen", "King",
    "Wright", "Scott", "Torres", "Nguyen", "Hill", "Flores")
FIRST_NAMES = (
    "James", "Mary", "John", "Patricia", "Robert", "Jennifer", "Michael",
    "Linda", "William", "Elizabeth", "David", "Barbara", "Richard", "Susan",
    "Joseph", "Jessica", "Thomas", "Sarah", "Charles", "Karen",
    "Christopher", "Nancy", "Daniel", "Lisa", "Matthew", "Margaret",
    "Anthony", "Betty", "Donald", "Sandra", "Mark", "Ashley", "Paul",
    "Dorothy", "Steven", "Kimberly", "Andrew", "Emily", "Kenneth", "Donna",
    "Jose", "Michelle", "Edward", "Carol", "Brian", "Amanda", "George",
    "Melissa", "Ronald", "Deborah")
STORE_GMT = tuple(int(v) for v in _dist("store_gmt")[0]), \
    _dist("store_gmt")[1]
REASONS = _dist("reasons")[0]
STORE_STATES = _dist("store_states")
# ndsgen.cpp kColors (i_product_name's color, picked uniformly); the
# dists.json "colors" values are the same list, with i_color's weights
COLORS, COLOR_WEIGHTS = _dist("colors")
UNITS = ("Each", "Dozen", "Case", "Pound", "Ounce", "Pallet", "Gross", "Box",
         "Carton", "Bundle", "Ton", "Dram", "Cup", "Gram", "Lb", "Oz", "Tbl",
         "Tsp", "Unknown", "N/A")
SIZES = ("small", "medium", "large", "extra large", "economy", "petite",
         "N/A")
WORDS = (
    "results", "important", "whole", "right", "general", "great", "special",
    "large", "social", "economic", "national", "young", "early", "possible",
    "different", "small", "major", "final", "international", "full",
    "public", "available", "local", "sure", "low", "necessary", "true",
    "significant", "recent", "certain", "military", "central", "similar",
    "main", "individual", "political", "common", "strong", "easy", "clear",
    "single", "hard", "good", "new", "old", "high", "long", "little", "own",
    "other")
DESC_WORDS = (5, 20)
BUY_POTENTIAL = _dist("buy_potential")[0]
STREET_NAMES = (
    "Main", "Oak", "Park", "First", "Elm", "Second", "Washington", "Maple",
    "Cedar", "Pine", "Lake", "Hill", "Walnut", "Spring", "North", "Ridge",
    "Church", "Willow", "Mill", "Sunset", "Railroad", "Jackson", "River",
    "Highland", "Johnson", "View", "Forest", "Green", "Meadow", "Broad",
    "Chestnut", "Franklin", "College", "Smith", "Center", "Davis", "Wilson",
    "Birch", "Locust", "Dogwood")
STREET_TYPES = ("Street", "Avenue", "Boulevard", "Drive", "Lane", "Road",
                "Court", "Circle", "Way", "Parkway", "Pkwy", "Blvd", "Ave",
                "Dr", "Ln", "RD", "Ct", "Cir", "ST", "Wy")
COUNTRY = "United States"
LOCATION_TYPES = ("apartment", "condo", "single family")
SALUTATIONS = ("Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir")
CREDIT = ("Low Risk", "Good", "High Risk", "Unknown")
HOURS = ("8AM-4PM", "8AM-8AM", "8AM-12AM")
SHIP_TYPES = ("EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY",
              "LIBRARY")
SHIP_CODES = ("AIR", "SURFACE", "SEA")
SHIFTS = ("first", "second", "third")
BIRTH_COUNTRIES = (
    "UNITED STATES", "CANADA", "MEXICO", "GERMANY", "FRANCE", "JAPAN",
    "CHINA", "INDIA", "BRAZIL", "ITALY", "NETHERLANDS", "PORTUGAL",
    "IRELAND", "GREECE", "TURKEY", "NIGERIA", "KENYA", "EGYPT", "PERU",
    "CHILE")
CC_NAMES = ("NY Metro", "Mid Atlantic", "Pacific NW", "North Midwest",
            "California", "New England", "Southeast", "Southwest",
            "Hawaii/Alaska", "Central", "Mountain", "Plains")
CC_CLASSES = ("small", "medium", "large")
SITE_NAMES = tuple(f"site_{i}" for i in range(6))
PAGE_TYPES = ("ad", "dynamic", "feedback", "general", "order", "protected",
              "welcome")
PURPOSES = ("Unknown", "ad", "discount", "coupon")
CATALOG_PAGE_TYPES = ("bi-annual", "quarterly", "monthly")
CATALOG_PAGES_PER_CATALOG = 108
ZIP_RANGE = (601, 99950)


def step_count(sf: float, steps, fact: bool) -> int:
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


def customer_demographics_rows() -> int:
    """The full cross product of the demographic attributes (ndsgen.cpp
    compute_sizes): gender x marital status x education x 20 purchase
    estimates x 4 credit ratings x 7^3 dependent counts."""
    return (len(DISTS["gender"][0]) * len(DISTS["marital_status"][0]) *
            len(DISTS["education"][0]) * 20 * 4 * 7 * 7 * 7)


def sizes(scale: float) -> Dict[str, int]:
    """Row counts of the 25 source tables at ``scale``."""
    out = {t: step_count(scale, s, fact) for t, (s, fact) in STEPS.items()}
    out["date_dim"] = DATE_DIM_ROWS
    out["time_dim"] = TIME_DIM_ROWS
    out["household_demographics"] = HOUSEHOLD_DEMOGRAPHICS_ROWS
    out["income_band"] = INCOME_BAND_ROWS
    out["ship_mode"] = SHIP_MODE_ROWS
    out["customer_demographics"] = customer_demographics_rows()
    out["inventory"] = INVENTORY_WEEKS * max(out["item"] // 2, 1) * \
        out["warehouse"]
    out["dbgen_version"] = 1
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


def days_from_civil(y: int, m: int, d: int) -> int:
    return (np.datetime64(f"{y:04d}-{m:02d}-{d:02d}") -
            np.datetime64("1970-01-01")).astype(int).item()


def ctype(table: str, column: str) -> DType:
    t = get_schemas()[table].column(column).dtype
    return DType(t.kind, precision=t.precision, scale=t.scale)


def stream(seed: int, tag: int, device) -> torch.Generator:
    """A generator of its own for stream ``tag``, derived from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1000003 + tag) % (1 << 63))
    return gen


def uniform_int(lo, hi, n: int, gen, device) -> torch.Tensor:
    """Uniform int64 in [lo, hi] (inclusive; tensor bounds allowed)."""
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return lo + torch.floor(u * (hi - lo + 1)).to(torch.int64)


def weighted_pick(weights, n: int, gen, device) -> torch.Tensor:
    """Index drawn with the given integer weights (ndsgen dpick_idx)."""
    cum = torch.tensor(np.cumsum(weights), dtype=torch.int64, device=device)
    x = uniform_int(0, int(cum[-1]) - 1, n, gen, device)
    return torch.searchsorted(cum, x, right=True)


def chance(p: float, k: int, gen, device) -> torch.Tensor:
    return torch.rand(k, generator=gen, device=device,
                      dtype=torch.float64) < p


def zipf(n_keys: int, n: int, gen, device) -> torch.Tensor:
    """ndsgen Rng::zipf: rank = floor((n+1)^u) in 1..n, scattered over the
    key space by the first multiplier coprime with n."""
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    rank = torch.exp(u * math.log(n_keys + 1.0)).to(torch.int64)
    rank = torch.clamp(rank, 1, n_keys)
    for p in _ZIPF_SCATTER:
        if math.gcd(p % n_keys, n_keys) == 1:
            return ((rank - 1) * p) % n_keys + 1
    return rank


def string_column(values, idx: torch.Tensor
                  ) -> Tuple[torch.Tensor, np.ndarray]:
    """Dictionary-code ``values[idx]`` against the sorted dictionary of
    the distinct values."""
    dictionary, code_of = np.unique(np.asarray(values, dtype=object),
                                    return_inverse=True)
    code_of = torch.as_tensor(code_of.reshape(-1).astype(np.int32)).to(
        idx.device)
    return code_of[idx], dictionary.astype(object)


def keyed_strings(n: int, fn, device) -> Tuple[torch.Tensor, np.ndarray]:
    """Codes of ``fn(sk)`` for sk in 1..n against their sorted
    dictionary (each value distinct)."""
    values = [fn(sk) for sk in range(1, n + 1)]
    return string_column(values, torch.arange(n, device=device))


def sentences(n: int, k, gen, device, width: Optional[int] = None
              ) -> Tuple[torch.Tensor, np.ndarray]:
    """ndsgen sentence(): ``k`` words of the pool a row (``k`` a number,
    or a tensor of counts of at most ``width``), coded against the
    distinct sentences.  The words are joined on the host (strings live
    in host dictionaries)."""
    hi = k if isinstance(k, int) else width
    words = uniform_int(0, len(WORDS) - 1, n * hi, gen,
                        device).view(n, hi).cpu().numpy()
    counts = [hi] * n if isinstance(k, int) else k.cpu().tolist()
    return string_column(
        [" ".join(WORDS[w] for w in row[:c])
         for row, c in zip(words.tolist(), counts)],
        torch.arange(n, device=device))


def pool_column(pool: Sequence[str], idx: torch.Tensor, table: str,
                name: str, valid: Optional[torch.Tensor] = None) -> Column:
    codes, dictionary = string_column(pool, idx)
    return Column(codes, ctype(table, name), valid, dictionary)


def int_column(data: torch.Tensor, table: str, name: str,
               valid: Optional[torch.Tensor] = None) -> Column:
    """A numeric column in its schema type's storage dtype."""
    t = ctype(table, name)
    dtype = getattr(torch, np.dtype(numpy_dtype(t)).name)
    return Column(data.to(dtype), t, valid)


def date_column(jd: torch.Tensor, table: str, name: str,
                valid: Optional[torch.Tensor] = None) -> Column:
    """A DATE column (days since 1970-01-01) from Julian day numbers."""
    return int_column(jd - JD_EPOCH_1970, table, name, valid)


def constant_string(value: str, n: int, table: str, name: str,
                    device) -> Column:
    """A string column holding ``value`` on every row."""
    return Column(torch.zeros(n, dtype=torch.int32, device=device),
                  ctype(table, name), None, np.array([value], dtype=object))


def null_strings(n: int, table: str, name: str, device) -> Column:
    """A string column that is NULL on every row."""
    return Column(torch.zeros(n, dtype=torch.int32, device=device),
                  ctype(table, name),
                  torch.zeros(n, dtype=torch.bool, device=device),
                  np.empty(0, dtype=object))


def null_ints(n: int, table: str, name: str, device) -> Column:
    return int_column(torch.zeros(n, dtype=torch.int64, device=device),
                      table, name,
                      torch.zeros(n, dtype=torch.bool, device=device))


def flags(yes: torch.Tensor, table: str, name: str) -> Column:
    """A 'Y'/'N' column."""
    return pool_column(("N", "Y"), yes.to(torch.int64), table, name)


def civil(jd: torch.Tensor):
    """Julian day -> (year, month, day) as int64 tensors."""
    y, m, d = civil_from_days(jd - JD_EPOCH_1970)
    return y.to(torch.int64), m.to(torch.int64), d.to(torch.int64)


def address(table: str, p: str, n: int, gen, device, two_word_streets=False,
            city_dist="cities", state_dist="states", suite_nulls=False,
            gmt=None) -> Dict[str, Column]:
    """The address block of ndsgen's customer_address, warehouse,
    call_center, web_site and store rows: street number 1..999, a street
    name (two names 30% of the time where ``two_word_streets``), a street
    type, a suite (NULL 15% of the time where ``suite_nulls``), a weighted
    city, county and state, a zip code, the country and, where ``gmt`` is
    given, its GMT offset column (hours as a tensor)."""
    num = uniform_int(1, 999, n, gen, device)
    first = uniform_int(0, len(STREET_NAMES) - 1, n, gen, device)
    pool = list(STREET_NAMES)
    street = first
    if two_word_streets:
        two = chance(0.3, n, gen, device)
        second = uniform_int(0, len(STREET_NAMES) - 1, n, gen, device)
        pool += [f"{a} {b}" for a in STREET_NAMES for b in STREET_NAMES]
        street = torch.where(two, len(STREET_NAMES) * (first + 1) + second,
                             first)
    stype = uniform_int(0, len(STREET_TYPES) - 1, n, gen, device)
    suite_ok = chance(0.85, n, gen, device) if suite_nulls else None
    suite = uniform_int(0, 99, n, gen, device)
    cities, city_w = DISTS[city_dist]
    city = weighted_pick(city_w, n, gen, device)
    counties, county_w = DISTS["fips_county"]
    county = weighted_pick(county_w, n, gen, device)
    states, state_w = DISTS[state_dist]
    state = weighted_pick(state_w, n, gen, device)
    zip_ = uniform_int(ZIP_RANGE[0], ZIP_RANGE[1], n, gen, device)
    zips = [f"{z:05d}" for z in range(ZIP_RANGE[1] + 1)]
    cols = {
        p + "street_number": pool_column(
            [str(i) for i in range(1000)], num, table, p + "street_number"),
        p + "street_name": pool_column(pool, street, table,
                                       p + "street_name"),
        p + "street_type": pool_column(STREET_TYPES, stype, table,
                                       p + "street_type"),
        p + "suite_number": pool_column(
            [f"Suite {i}" for i in range(100)], suite, table,
            p + "suite_number", suite_ok),
        p + "city": pool_column(cities, city, table, p + "city"),
        p + "county": pool_column(counties, county, table, p + "county"),
        p + "state": pool_column(states, state, table, p + "state"),
        p + "zip": pool_column(zips, zip_, table, p + "zip"),
        p + "country": constant_string(COUNTRY, n, table, p + "country",
                                       device),
    }
    if gmt is not None:
        cols[p + "gmt_offset"] = int_column(gmt * 100, table,
                                            p + "gmt_offset")
    return cols


def person_names(n: int, gen, device) -> torch.Tensor:
    """Index of "<first> <last>" into :func:`person_pool`."""
    f = uniform_int(0, len(FIRST_NAMES) - 1, n, gen, device)
    last = uniform_int(0, len(LAST_NAMES) - 1, n, gen, device)
    return f * len(LAST_NAMES) + last


def person_pool():
    return [f"{f} {last}" for f in FIRST_NAMES for last in LAST_NAMES]
