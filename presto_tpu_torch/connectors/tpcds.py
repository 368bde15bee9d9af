"""TPC-DS data-generator connector.

A copy of ``presto_tpu/connectors/tpcds.py`` whose page source emits the
port's batches on a given device. Conceptual parity with presto-tpcds
(reference presto-tpcds/src/main/java/io/prestosql/plugin/tpcds/
TpcdsMetadata.java, TpcdsRecordSetProvider wrapping the teradata tpcds
generators), built like the TPC-H connector (connectors/tpch.py): every
column is a stateless splitmix64 hash of the row's surrogate key, so any
split can generate any row range referentially consistently and in
parallel.

Tables: the star-schema core the q27/q55 configs touch (``store_sales``,
``date_dim``, ``item``, ``store``, ``customer_demographics``) plus the
rest of the spec's tables (``tpcds_ext.py``). Distributions follow the spec's shapes
(demographics are the spec's exact cross-product encoding; date_dim is a
real calendar); exact dsdgen bit-compatibility is NOT a goal —
correctness tests compare against an oracle over this same data.
"""
from __future__ import annotations

import datetime
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..batch import Batch, Schema
from ..device import resolve_device
from .spi import (
    ColumnStats, Connector, ConnectorMetadata, ConnectorSplitManager,
    PageSource, Split, TableHandle, TableStats,
)
from .tpch import _U64, _h, _money, _pick, _randint, _to_batch

# date_dim spans 1900-01-01 .. 2100-01-01 (spec); sk = julian day number,
# stored here as days since 1900-01-01 plus the spec's base surrogate
D_BASE_SK = 2415022            # julian day of 1900-01-01 (spec's first sk)
D_DAYS = 73_049                # rows in date_dim (fixed, scale-independent)
_EPOCH_1900 = datetime.date(1900, 1, 1)

# fact sales dates concentrate in 1998-2002 (spec's active window)
SALES_D0 = (datetime.date(1998, 1, 1) - _EPOCH_1900).days
SALES_D1 = (datetime.date(2003, 1, 1) - _EPOCH_1900).days

GENDERS = ("M", "F")
MARITAL = ("M", "S", "D", "W", "U")
EDUCATION = ("Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown")
CD_PURCHASE_MAX = 20           # purchase estimate buckets (500,1000,..)
CREDIT_RATING = ("Low Risk", "Good", "High Risk", "Unknown")
N_DEMOGRAPHICS = (len(GENDERS) * len(MARITAL) * len(EDUCATION)
                  * CD_PURCHASE_MAX * len(CREDIT_RATING)
                  * 7 * 7 * 7)   # dep, dep_employed, dep_college counts 0-6

STATES = ("TN", "TN", "TN", "TN", "TN", "TN", "AL", "GA", "KY", "NC",
          "OH", "TX", "VA", "MO", "SC")   # TN-heavy like dsdgen defaults
CATEGORIES = ("Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women")
CITIES = ("Midway", "Fairview", "Oak Grove", "Five Points", "Centerville",
          "Liberty", "Pleasant Hill", "Riverside", "Salem", "Union",
          "Greenville", "Bethel", "Springfield", "Clinton", "Marion")
COUNTIES = ("Williamson County", "Walker County", "Ziebach County",
            "Franklin Parish", "Luce County", "Richland County",
            "Bronx County", "Orange County", "Maverick County",
            "Mobile County")
BUY_POTENTIAL = ("0-500", "501-1000", "1001-5000", "5001-10000",
                 ">10000", "Unknown")
FIRST_NAMES = ("James", "Mary", "John", "Patricia", "Robert", "Jennifer",
               "Michael", "Linda", "William", "Elizabeth", "David",
               "Barbara", "Richard", "Susan", "Joseph", "Jessica")
LAST_NAMES = ("Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
              "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez",
              "Lopez", "Gonzalez", "Wilson", "Anderson", "Thomas")
MEAL_TIMES = ("breakfast", "lunch", "dinner", "")


def _rows(table: str, sf: float) -> int:
    if table == "store_sales":
        return int(2_880_000 * sf)
    if table == "date_dim":
        return D_DAYS
    if table == "item":
        return max(1, int(18_000 * max(sf, 1) ** 0.5))
    if table == "store":
        return max(1, int(12 * max(sf, 1) ** 0.5))
    if table == "customer_demographics":
        return 1_920_800     # fixed cross-product (spec)
    if table == "customer":
        return max(1, int(100_000 * max(sf, 1) ** 0.5))
    if table == "customer_address":
        return max(1, int(50_000 * max(sf, 1) ** 0.5))
    if table == "household_demographics":
        return 7_200         # fixed cross-product (spec)
    if table == "promotion":
        return max(1, int(300 * max(sf, 1) ** 0.5))
    if table == "time_dim":
        return 86_400        # one row per second of day (spec)
    if table in EXT_ROWS:
        return EXT_ROWS[table](sf)
    raise KeyError(table)


V = T.VARCHAR
_SCHEMAS: Dict[str, List[Tuple[str, T.Type]]] = {
    "store_sales": [
        ("ss_sold_date_sk", T.BIGINT), ("ss_sold_time_sk", T.BIGINT),
        ("ss_item_sk", T.BIGINT),
        ("ss_customer_sk", T.BIGINT), ("ss_cdemo_sk", T.BIGINT),
        ("ss_hdemo_sk", T.BIGINT), ("ss_addr_sk", T.BIGINT),
        ("ss_store_sk", T.BIGINT), ("ss_promo_sk", T.BIGINT),
        ("ss_ticket_number", T.BIGINT),
        ("ss_quantity", T.INTEGER), ("ss_wholesale_cost", T.DOUBLE),
        ("ss_list_price", T.DOUBLE), ("ss_sales_price", T.DOUBLE),
        ("ss_ext_sales_price", T.DOUBLE), ("ss_coupon_amt", T.DOUBLE),
        ("ss_ext_discount_amt", T.DOUBLE),
        ("ss_ext_wholesale_cost", T.DOUBLE),
        ("ss_ext_list_price", T.DOUBLE), ("ss_ext_tax", T.DOUBLE),
        ("ss_net_paid", T.DOUBLE), ("ss_net_paid_inc_tax", T.DOUBLE),
        ("ss_net_profit", T.DOUBLE),
    ],
    "date_dim": [
        ("d_date_sk", T.BIGINT), ("d_date", T.DATE),
        ("d_year", T.INTEGER), ("d_moy", T.INTEGER),
        ("d_dom", T.INTEGER), ("d_qoy", T.INTEGER),
        ("d_day_name", T.varchar(9)), ("d_dow", T.INTEGER),
        ("d_month_seq", T.INTEGER), ("d_week_seq", T.INTEGER),
        ("d_quarter_name", T.varchar(6)),
    ],
    "item": [
        ("i_item_sk", T.BIGINT), ("i_item_id", T.varchar(16)),
        ("i_brand_id", T.INTEGER), ("i_brand", T.varchar(50)),
        ("i_manufact_id", T.INTEGER), ("i_manager_id", T.INTEGER),
        ("i_category_id", T.INTEGER), ("i_category", T.varchar(50)),
        ("i_current_price", T.DOUBLE), ("i_class_id", T.INTEGER),
        ("i_class", T.varchar(50)), ("i_item_desc", T.varchar(200)),
        ("i_manufact", T.varchar(50)), ("i_color", T.varchar(20)),
        ("i_product_name", T.varchar(50)), ("i_size", T.varchar(20)),
        ("i_units", T.varchar(10)), ("i_wholesale_cost", T.DOUBLE),
    ],
    "store": [
        ("s_store_sk", T.BIGINT), ("s_store_id", T.varchar(16)),
        ("s_store_name", T.varchar(50)), ("s_city", T.varchar(60)),
        ("s_county", T.varchar(30)), ("s_state", T.varchar(2)),
        ("s_zip", T.varchar(10)), ("s_number_employees", T.INTEGER),
        ("s_gmt_offset", T.DOUBLE), ("s_company_id", T.INTEGER),
        ("s_company_name", T.varchar(50)), ("s_market_id", T.INTEGER),
        ("s_street_number", T.varchar(10)),
        ("s_street_name", T.varchar(60)),
        ("s_street_type", T.varchar(15)),
        ("s_suite_number", T.varchar(10)),
    ],
    "customer_demographics": [
        ("cd_demo_sk", T.BIGINT), ("cd_gender", T.varchar(1)),
        ("cd_marital_status", T.varchar(1)),
        ("cd_education_status", T.varchar(20)),
        ("cd_purchase_estimate", T.INTEGER),
        ("cd_credit_rating", T.varchar(10)),
        ("cd_dep_count", T.INTEGER),
        ("cd_dep_employed_count", T.INTEGER),
        ("cd_dep_college_count", T.INTEGER),
    ],
    "customer": [
        ("c_customer_sk", T.BIGINT), ("c_customer_id", T.varchar(16)),
        ("c_current_cdemo_sk", T.BIGINT),
        ("c_current_hdemo_sk", T.BIGINT),
        ("c_current_addr_sk", T.BIGINT),
        ("c_first_name", T.varchar(20)), ("c_last_name", T.varchar(30)),
        ("c_preferred_cust_flag", T.varchar(1)),
        ("c_birth_year", T.INTEGER), ("c_salutation", T.varchar(10)),
        ("c_birth_country", T.varchar(20)), ("c_birth_day", T.INTEGER),
        ("c_birth_month", T.INTEGER),
        ("c_email_address", T.varchar(50)), ("c_login", T.varchar(13)),
        ("c_first_sales_date_sk", T.BIGINT),
        ("c_first_shipto_date_sk", T.BIGINT),
        ("c_last_review_date_sk", T.BIGINT),
    ],
    "customer_address": [
        ("ca_address_sk", T.BIGINT), ("ca_address_id", T.varchar(16)),
        ("ca_city", T.varchar(60)), ("ca_county", T.varchar(30)),
        ("ca_state", T.varchar(2)), ("ca_zip", T.varchar(10)),
        ("ca_country", T.varchar(20)), ("ca_gmt_offset", T.DOUBLE),
        ("ca_location_type", T.varchar(20)),
        ("ca_street_number", T.varchar(10)),
        ("ca_street_name", T.varchar(60)),
        ("ca_street_type", T.varchar(15)),
        ("ca_suite_number", T.varchar(10)),
    ],
    "household_demographics": [
        ("hd_demo_sk", T.BIGINT), ("hd_income_band_sk", T.BIGINT),
        ("hd_buy_potential", T.varchar(15)), ("hd_dep_count", T.INTEGER),
        ("hd_vehicle_count", T.INTEGER),
    ],
    "promotion": [
        ("p_promo_sk", T.BIGINT), ("p_promo_id", T.varchar(16)),
        ("p_channel_dmail", T.varchar(1)),
        ("p_channel_email", T.varchar(1)),
        ("p_channel_event", T.varchar(1)),
        ("p_channel_tv", T.varchar(1)),
    ],
    "time_dim": [
        ("t_time_sk", T.BIGINT), ("t_time", T.INTEGER),
        ("t_hour", T.INTEGER), ("t_minute", T.INTEGER),
        ("t_second", T.INTEGER), ("t_meal_time", T.varchar(20)),
    ],
}

from .tpcds_ext import (  # noqa: E402
    EXT_PRIMARY_KEYS, EXT_ROWS, EXT_SCHEMAS, ExtGen,
)
_SCHEMAS.update(EXT_SCHEMAS)

TABLES = tuple(_SCHEMAS)

_DAY_NAMES = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
              "Saturday", "Sunday")
_BRANDS = tuple(f"Brand#{i}" for i in range(1, 1001))


class _Gen(ExtGen):
    """Column generators keyed by 1-based surrogate row keys."""

    def __init__(self, sf: float):
        self.sf = sf
        self.n_item = _rows("item", sf)
        self.n_store = _rows("store", sf)
        self.n_demo = _rows("customer_demographics", sf)
        self.n_cust = _rows("customer", sf)
        self.n_addr = _rows("customer_address", sf)
        self.n_hdemo = _rows("household_demographics", sf)
        self.n_promo = _rows("promotion", sf)

    # ---- store_sales (fact; key = row id) ----
    def store_sales(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        qty = 1 + (_h(key, 201) % _U64(100)).astype(np.int64)
        wholesale = _money(key, 202, 1.0, 100.0)
        list_price = np.round(wholesale * (1.0 + (
            _h(key, 203) % _U64(100)).astype(np.float64) / 100.0), 2)
        sales_price = np.round(list_price * (
            (_h(key, 204) % _U64(100)).astype(np.float64) / 100.0), 2)
        ext_sales = np.round(sales_price * qty, 2)
        coupon = np.where(_h(key, 205) % _U64(10) == 0,
                          np.round(ext_sales * 0.1, 2), 0.0)
        for c in cols:
            if c == "ss_sold_date_sk":
                d = SALES_D0 + (_h(key, 200)
                                % _U64(SALES_D1 - SALES_D0)).astype(np.int64)
                out[c] = (D_BASE_SK + d, None)
            elif c == "ss_item_sk":
                out[c] = (1 + (_h(key, 206)
                               % _U64(self.n_item)).astype(np.int64), None)
            elif c == "ss_customer_sk":
                out[c] = (1 + (_h(key, 207)
                               % _U64(self.n_cust)).astype(np.int64), None)
            elif c == "ss_cdemo_sk":
                out[c] = (1 + (_h(key, 208)
                               % _U64(self.n_demo)).astype(np.int64), None)
            elif c == "ss_store_sk":
                out[c] = (1 + (_h(key, 209)
                               % _U64(self.n_store)).astype(np.int64), None)
            elif c == "ss_sold_time_sk":
                out[c] = ((_h(key, 210)
                           % _U64(86_400)).astype(np.int64), None)
            elif c == "ss_hdemo_sk":
                out[c] = (1 + (_h(key, 211)
                               % _U64(self.n_hdemo)).astype(np.int64),
                          None)
            elif c == "ss_addr_sk":
                out[c] = (1 + (_h(key, 212)
                               % _U64(self.n_addr)).astype(np.int64), None)
            elif c == "ss_promo_sk":
                out[c] = (1 + (_h(key, 213)
                               % _U64(self.n_promo)).astype(np.int64),
                          None)
            elif c == "ss_ticket_number":
                out[c] = (1 + (key.astype(np.int64) - 1) // 8, None)
            elif c == "ss_quantity":
                out[c] = (qty.astype(np.int32), None)
            elif c == "ss_wholesale_cost":
                out[c] = (wholesale, None)
            elif c == "ss_list_price":
                out[c] = (list_price, None)
            elif c == "ss_sales_price":
                out[c] = (sales_price, None)
            elif c == "ss_ext_sales_price":
                out[c] = (ext_sales, None)
            elif c == "ss_coupon_amt":
                out[c] = (coupon, None)
            elif c == "ss_net_paid":
                out[c] = (np.round(ext_sales - coupon, 2), None)
            elif c == "ss_net_profit":
                out[c] = (np.round(ext_sales - coupon
                                   - wholesale * qty, 2), None)
            elif c == "ss_ext_discount_amt":
                out[c] = (np.round((list_price - sales_price) * qty, 2),
                          None)
            elif c == "ss_ext_wholesale_cost":
                out[c] = (np.round(wholesale * qty, 2), None)
            elif c == "ss_ext_list_price":
                out[c] = (np.round(list_price * qty, 2), None)
            elif c == "ss_ext_tax":
                out[c] = (np.round(ext_sales * 0.05, 2), None)
            elif c == "ss_net_paid_inc_tax":
                out[c] = (np.round((ext_sales - coupon) * 1.05, 2), None)
            else:
                raise KeyError(c)
        return out

    # ---- date_dim (key = 1..D_DAYS; calendar date = 1900-01-01 + key-1) --
    def date_dim(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        days = key.astype(np.int64) - 1
        # vectorized calendar via numpy datetime64
        dt = (np.datetime64("1900-01-01") + days.astype("timedelta64[D]"))
        years = dt.astype("datetime64[Y]").astype(np.int64) + 1970
        months = dt.astype("datetime64[M]").astype(np.int64) % 12 + 1
        dom = (dt - dt.astype("datetime64[M]")).astype(np.int64) + 1
        for c in cols:
            if c == "d_date_sk":
                out[c] = (D_BASE_SK + days, None)
            elif c == "d_date":
                # engine DATE storage = days since 1970-01-01
                epoch70 = (np.datetime64("1900-01-01")
                           - np.datetime64("1970-01-01")).astype(np.int64)
                out[c] = ((days + epoch70).astype(np.int32), None)
            elif c == "d_year":
                out[c] = (years.astype(np.int32), None)
            elif c == "d_moy":
                out[c] = (months.astype(np.int32), None)
            elif c == "d_dom":
                out[c] = (dom.astype(np.int32), None)
            elif c == "d_qoy":
                out[c] = (((months - 1) // 3 + 1).astype(np.int32), None)
            elif c == "d_day_name":
                # 1900-01-01 was a Monday
                out[c] = ((days % 7).astype(np.int32), _DAY_NAMES)
            else:
                out[c] = self.ext_column("date_dim", c, key)
        return out

    # ---- item ----
    def item(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        brand_id = 1 + (_h(key, 221) % _U64(1000)).astype(np.int64)
        cat = (_h(key, 222) % _U64(len(CATEGORIES))).astype(np.int64)
        for c in cols:
            if c == "i_item_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "i_item_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "i_brand_id":
                out[c] = (brand_id.astype(np.int32), None)
            elif c == "i_brand":
                out[c] = ((brand_id - 1).astype(np.int32), _BRANDS)
            elif c == "i_manufact_id":
                out[c] = (_randint(key, 223, 1, 1000).astype(np.int32), None)
            elif c == "i_manager_id":
                out[c] = (_randint(key, 224, 1, 100).astype(np.int32), None)
            elif c == "i_category_id":
                out[c] = ((cat + 1).astype(np.int32), None)
            elif c == "i_category":
                out[c] = (cat.astype(np.int32), CATEGORIES)
            elif c == "i_current_price":
                out[c] = (_money(key, 225, 0.09, 99.99), None)
            else:
                out[c] = self.ext_column("item", c, key)
        return out

    # ---- store ----
    def store(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "s_store_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "s_store_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "s_store_name":
                names = ("ought", "able", "pri", "ese", "anti", "cally",
                         "ation", "eing", "n st", "bar")
                out[c] = ((_h(key, 231)
                           % _U64(len(names))).astype(np.int32), names)
            elif c == "s_state":
                # STATES holds duplicates (TN-heavy weighting); codes must
                # index the deduped dictionary, not the weighted tuple
                uniq = tuple(dict.fromkeys(STATES))
                remap = np.array([uniq.index(s) for s in STATES],
                                 dtype=np.int32)
                out[c] = (remap[_pick(key, 232, STATES)], uniq)
            elif c == "s_number_employees":
                out[c] = (_randint(key, 233, 200, 300).astype(np.int32),
                          None)
            elif c == "s_city":
                out[c] = ((_h(key, 234)
                           % _U64(len(CITIES))).astype(np.int32), CITIES)
            elif c == "s_county":
                out[c] = ((_h(key, 235)
                           % _U64(len(COUNTIES))).astype(np.int32),
                          COUNTIES)
            elif c == "s_zip":
                zips = 10000 + (_h(key, 236) % _U64(90000)).astype(np.int64)
                out[c] = ([str(z) for z in zips], "text")
            elif c == "s_gmt_offset":
                out[c] = (np.where(_h(key, 237) % _U64(2) == 0,
                                   -5.0, -6.0), None)
            else:
                out[c] = self.ext_column("store", c, key)
        return out

    # ---- customer_demographics (exact cross-product, spec encoding) ----
    def customer_demographics(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        i = key.astype(np.int64) - 1
        g = i % len(GENDERS)
        i2 = i // len(GENDERS)
        ms = i2 % len(MARITAL)
        i3 = i2 // len(MARITAL)
        ed = i3 % len(EDUCATION)
        i4 = i3 // len(EDUCATION)
        pe = i4 % CD_PURCHASE_MAX
        i5 = i4 // CD_PURCHASE_MAX
        cr = i5 % len(CREDIT_RATING)
        i6 = i5 // len(CREDIT_RATING)
        dep = i6 % 7
        i7 = i6 // 7
        dep_emp = i7 % 7
        dep_col = (i7 // 7) % 7
        for c in cols:
            if c == "cd_demo_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "cd_gender":
                out[c] = (g.astype(np.int32), GENDERS)
            elif c == "cd_marital_status":
                out[c] = (ms.astype(np.int32), MARITAL)
            elif c == "cd_education_status":
                out[c] = (ed.astype(np.int32), EDUCATION)
            elif c == "cd_purchase_estimate":
                out[c] = (((pe + 1) * 500).astype(np.int32), None)
            elif c == "cd_credit_rating":
                out[c] = (cr.astype(np.int32), CREDIT_RATING)
            elif c == "cd_dep_count":
                out[c] = (dep.astype(np.int32), None)
            elif c == "cd_dep_employed_count":
                out[c] = (dep_emp.astype(np.int32), None)
            elif c == "cd_dep_college_count":
                out[c] = (dep_col.astype(np.int32), None)
            else:
                raise KeyError(c)
        return out

    # ---- customer ----
    def customer(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "c_customer_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "c_customer_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "c_current_cdemo_sk":
                out[c] = (1 + (_h(key, 241)
                               % _U64(self.n_demo)).astype(np.int64), None)
            elif c == "c_current_hdemo_sk":
                out[c] = (1 + (_h(key, 242)
                               % _U64(self.n_hdemo)).astype(np.int64),
                          None)
            elif c == "c_current_addr_sk":
                out[c] = (1 + (_h(key, 243)
                               % _U64(self.n_addr)).astype(np.int64), None)
            elif c == "c_first_name":
                out[c] = ((_h(key, 244)
                           % _U64(len(FIRST_NAMES))).astype(np.int32),
                          FIRST_NAMES)
            elif c == "c_last_name":
                out[c] = ((_h(key, 245)
                           % _U64(len(LAST_NAMES))).astype(np.int32),
                          LAST_NAMES)
            elif c == "c_preferred_cust_flag":
                out[c] = ((_h(key, 246) % _U64(2)).astype(np.int32),
                          ("N", "Y"))
            elif c == "c_birth_year":
                out[c] = (_randint(key, 247, 1924, 1992).astype(np.int32),
                          None)
            else:
                out[c] = self.ext_column("customer", c, key)
        return out

    # ---- customer_address ----
    def customer_address(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "ca_address_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "ca_address_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "ca_city":
                out[c] = ((_h(key, 251)
                           % _U64(len(CITIES))).astype(np.int32), CITIES)
            elif c == "ca_county":
                out[c] = ((_h(key, 252)
                           % _U64(len(COUNTIES))).astype(np.int32),
                          COUNTIES)
            elif c == "ca_state":
                uniq = tuple(dict.fromkeys(STATES))
                out[c] = ((_h(key, 253)
                           % _U64(len(uniq))).astype(np.int32), uniq)
            elif c == "ca_zip":
                zips = 10000 + (_h(key, 254) % _U64(90000)).astype(np.int64)
                out[c] = ([str(z) for z in zips], "text")
            elif c == "ca_country":
                out[c] = (np.zeros(len(key), dtype=np.int32),
                          ("United States",))
            elif c == "ca_gmt_offset":
                out[c] = (np.where(_h(key, 255) % _U64(2) == 0,
                                   -5.0, -6.0), None)
            else:
                out[c] = self.ext_column("customer_address", c, key)
        return out

    # ---- household_demographics (cross-product, spec encoding) ----
    def household_demographics(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        i = key.astype(np.int64) - 1
        inc = i % 20
        i2 = i // 20
        bp = i2 % len(BUY_POTENTIAL)
        i3 = i2 // len(BUY_POTENTIAL)
        dep = i3 % 10
        veh = (i3 // 10) % 6
        for c in cols:
            if c == "hd_demo_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "hd_income_band_sk":
                out[c] = ((inc + 1).astype(np.int64), None)
            elif c == "hd_buy_potential":
                out[c] = (bp.astype(np.int32), BUY_POTENTIAL)
            elif c == "hd_dep_count":
                out[c] = (dep.astype(np.int32), None)
            elif c == "hd_vehicle_count":
                out[c] = ((veh - 1).astype(np.int32), None)  # -1..4 (spec)
            else:
                raise KeyError(c)
        return out

    # ---- promotion ----
    def promotion(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        yn = ("N", "Y")
        for c in cols:
            if c == "p_promo_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "p_promo_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "p_channel_dmail":
                out[c] = ((_h(key, 261) % _U64(2)).astype(np.int32), yn)
            elif c == "p_channel_email":
                out[c] = ((_h(key, 262) % _U64(10) == 0)
                          .astype(np.int32), yn)
            elif c == "p_channel_event":
                out[c] = ((_h(key, 263) % _U64(10) == 0)
                          .astype(np.int32), yn)
            elif c == "p_channel_tv":
                out[c] = ((_h(key, 264) % _U64(2)).astype(np.int32), yn)
            else:
                raise KeyError(c)
        return out

    # ---- time_dim (key = 1..86400; second of day = key - 1) ----
    def time_dim(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        sec = key.astype(np.int64) - 1
        hour = sec // 3600
        for c in cols:
            if c == "t_time_sk":
                out[c] = (sec, None)          # spec: sk == second of day
            elif c == "t_time":
                out[c] = (sec.astype(np.int32), None)
            elif c == "t_hour":
                out[c] = (hour.astype(np.int32), None)
            elif c == "t_minute":
                out[c] = (((sec // 60) % 60).astype(np.int32), None)
            elif c == "t_second":
                out[c] = ((sec % 60).astype(np.int32), None)
            elif c == "t_meal_time":
                mt = np.full(len(key), 3, dtype=np.int32)
                mt = np.where((hour >= 6) & (hour <= 9), 0, mt)
                mt = np.where((hour >= 11) & (hour <= 13), 1, mt)
                mt = np.where((hour >= 17) & (hour <= 20), 2, mt)
                out[c] = (mt, MEAL_TIMES)
            else:
                raise KeyError(c)
        return out


def tpcds_schema(table: str) -> Schema:
    return Schema(_SCHEMAS[table])


class TpcdsPageSource(PageSource):
    def __init__(self, gen: _Gen, split: Split, columns: Sequence[str],
                 rows_per_batch: int, device):
        self.gen = gen
        self.device = device
        self.split = split
        self.columns = list(columns)
        self.rows_per_batch = rows_per_batch

    def host_chunks(self):
        """(schema, generated column dict, n) per chunk, host-side only."""
        table = self.split.table.table
        schema = tpcds_schema(table)
        start, end = self.split.info
        genfn = getattr(self.gen, table)
        for a in range(start, end, self.rows_per_batch):
            b = min(a + self.rows_per_batch, end)
            keys = np.arange(a, b, dtype=np.int64)
            yield schema, genfn(keys, self.columns), b - a

    def batches(self) -> Iterator[Batch]:
        for schema, data, n in self.host_chunks():
            yield _to_batch(schema, self.columns, data, n, self.device)


class _Metadata(ConnectorMetadata):
    def __init__(self, sf: float):
        self.sf = sf

    def list_tables(self, schema: Optional[str] = None) -> List[str]:
        return list(TABLES)

    def table_schema(self, table: TableHandle) -> Schema:
        if table.table not in _SCHEMAS:
            raise KeyError(f"unknown tpcds table {table.table!r}")
        return tpcds_schema(table.table)

    _PRIMARY_KEYS = {
        "store_sales": (),           # fact rows are not keyed by one column
        "date_dim": ("d_date_sk",),
        "item": ("i_item_sk",),
        "store": ("s_store_sk",),
        "customer_demographics": ("cd_demo_sk",),
        "customer": ("c_customer_sk",),
        "customer_address": ("ca_address_sk",),
        "household_demographics": ("hd_demo_sk",),
        "promotion": ("p_promo_sk",),
        "time_dim": ("t_time_sk",),
        **EXT_PRIMARY_KEYS,
    }

    def table_stats(self, table: TableHandle) -> TableStats:
        """Row counts plus EXACT per-column min/max and distinct counts
        for the generated key and low-cardinality columns. The
        generators are stateless functions of the surrogate key, so
        these bounds are true by construction (surrogate keys are dense
        1..n; fact foreign keys are uniform over the referenced
        domain) — which is exactly what lets the optimizer treat them
        as HARD bounds for the dense scatter group-by
        (optimizer._attach_group_bounds) and lets the greedy join order
        rank dimensions by real selectivity instead of bare size."""
        t = table.table
        n = float(_rows(t, self.sf))

        import math

        def sk(lo: int, hi: int, d: Optional[float] = None,
               draws: bool = False) -> ColumnStats:
            # ``draws``: the column is n uniform draws from the domain
            # (fact foreign keys), so publish the expected distinct count
            # E[d] = domain * (1 - (1 - 1/domain)^n). Publishing the raw
            # domain size would overstate NDV past the row count at small
            # scale factors and trip the optimizer's near-unique
            # heuristic (_key_unique's 0.999 * rows test) on foreign
            # keys that DO repeat — a silently wrong unique-build join.
            # Non-draw columns (dense surrogate ranges, calendar fields)
            # publish their exact domain cardinality.
            domain = float(d if d is not None else hi - lo + 1)
            est = domain
            if draws and domain > 1:
                est = domain * -math.expm1(n * math.log1p(-1.0 / domain))
            return ColumnStats(distinct_count=min(est, domain, n),
                               min_value=lo, max_value=hi)

        date_lo, date_hi = D_BASE_SK, D_BASE_SK + D_DAYS - 1
        sales_days = SALES_D1 - SALES_D0
        # one thunk per table so a stats call prices ONLY the requested
        # table (planning a 5-table query calls this once per table per
        # optimization pass; building all ten tables' ColumnStats each
        # time was ~10x dead work, and sk()'s draw math uses THIS
        # table's row count, so cross-table entries were wrong anyway)
        per_table: Dict[str, object] = {
            "store_sales": lambda: {
                "ss_sold_date_sk": sk(D_BASE_SK + SALES_D0,
                                      D_BASE_SK + SALES_D1 - 1,
                                      sales_days, draws=True),
                "ss_sold_time_sk": sk(0, 86_399, draws=True),
                "ss_item_sk": sk(1, _rows("item", self.sf), draws=True),
                "ss_customer_sk": sk(1, _rows("customer", self.sf),
                                     draws=True),
                "ss_cdemo_sk": sk(1, _rows("customer_demographics",
                                           self.sf), draws=True),
                "ss_hdemo_sk": sk(1, _rows("household_demographics",
                                           self.sf), draws=True),
                "ss_addr_sk": sk(1, _rows("customer_address", self.sf),
                                 draws=True),
                "ss_store_sk": sk(1, _rows("store", self.sf), draws=True),
                "ss_promo_sk": sk(1, _rows("promotion", self.sf),
                                  draws=True),
                "ss_quantity": sk(1, 100, draws=True),
            },
            "date_dim": lambda: {
                "d_date_sk": sk(date_lo, date_hi),
                "d_year": sk(1900, 2100, 201),
                "d_moy": sk(1, 12),
                "d_dom": sk(1, 31),
                "d_qoy": sk(1, 4),
            },
            "item": lambda: {
                "i_item_sk": sk(1, _rows("item", self.sf)),
                "i_brand_id": sk(1, 1000, min(1000.0, n)),
                "i_brand": ColumnStats(distinct_count=min(1000.0, n)),
                "i_manufact_id": sk(1, 1000, min(1000.0, n)),
                "i_manager_id": sk(1, 100, min(100.0, n)),
                "i_category_id": sk(1, len(CATEGORIES)),
                "i_category": ColumnStats(
                    distinct_count=float(len(CATEGORIES))),
            },
            "store": lambda: {
                "s_store_sk": sk(1, _rows("store", self.sf)),
                "s_state": ColumnStats(distinct_count=float(
                    len(dict.fromkeys(STATES)))),
            },
            "customer_demographics": lambda: {
                "cd_demo_sk": sk(1, _rows("customer_demographics",
                                          self.sf)),
                "cd_gender": ColumnStats(
                    distinct_count=float(len(GENDERS))),
                "cd_marital_status": ColumnStats(
                    distinct_count=float(len(MARITAL))),
                "cd_education_status": ColumnStats(
                    distinct_count=float(len(EDUCATION))),
                "cd_purchase_estimate": sk(500, 500 * CD_PURCHASE_MAX,
                                           CD_PURCHASE_MAX),
                "cd_credit_rating": ColumnStats(
                    distinct_count=float(len(CREDIT_RATING))),
                "cd_dep_count": sk(0, 6),
            },
            "customer": lambda: {
                "c_customer_sk": sk(1, _rows("customer", self.sf)),
                "c_current_cdemo_sk": sk(1, _rows(
                    "customer_demographics", self.sf), draws=True),
                "c_current_addr_sk": sk(1, _rows("customer_address",
                                                 self.sf), draws=True),
            },
            "customer_address": lambda: {
                "ca_address_sk": sk(1, _rows("customer_address",
                                             self.sf)),
            },
            "household_demographics": lambda: {
                "hd_demo_sk": sk(1, _rows("household_demographics",
                                          self.sf)),
            },
            "promotion": lambda: {
                "p_promo_sk": sk(1, _rows("promotion", self.sf)),
            },
            "time_dim": lambda: {
                "t_time_sk": sk(0, 86_399),
            },
        }
        thunk = per_table.get(t)
        cols: Dict[str, ColumnStats] = dict(thunk()) if thunk else {}
        schema_cols = {c for c, _ in _SCHEMAS.get(t, ())}
        cols = {c: s for c, s in cols.items() if c in schema_cols}
        for pk in self._PRIMARY_KEYS.get(t, ()):
            if pk not in cols:
                cols[pk] = ColumnStats(distinct_count=n)
        return TableStats(row_count=n, columns=cols,
                          primary_key=self._PRIMARY_KEYS.get(t, ()))


class _SplitManager(ConnectorSplitManager):
    def __init__(self, sf: float):
        self.sf = sf

    def splits(self, table: TableHandle, desired: int = 1) -> List[Split]:
        n = _rows(table.table, self.sf)
        desired = max(1, min(desired, n))
        bounds = np.linspace(1, n + 1, desired + 1, dtype=np.int64)
        return [
            Split(table, (int(bounds[i]), int(bounds[i + 1])))
            for i in range(desired)
            if bounds[i] < bounds[i + 1]
        ]


class TpcdsConnector(Connector):
    name = "tpcds"

    def __init__(self, sf: float = 0.01):
        self.sf = sf
        self._metadata = _Metadata(sf)
        self._splits = _SplitManager(sf)
        self._gen = _Gen(sf)

    def data_version(self, table: str):
        # stateless generator: any split regenerates identically for the
        # connector's whole lifetime, so the device scan cache may hold it
        return 0

    @property
    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    @property
    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source(self, split: Split, columns: Sequence[str],
                    pushdown=None, rows_per_batch: int = 1 << 17, *,
                    device=None) -> PageSource:
        """Batches of one split on ``device``: the GPU when none is named
        (an error without one)."""
        return TpcdsPageSource(self._gen, split, columns, rows_per_batch,
                               resolve_device(device))
