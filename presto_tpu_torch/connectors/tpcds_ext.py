"""TPC-DS full-schema extension: catalog/web channels, returns,
inventory, and the remaining dimensions.

Completes the connector's table surface to what the reference's TPC-DS
suite queries (reference presto-tpcds/.../TpcdsMetadata.java serves all
24 spec tables; presto-benchto-benchmarks/.../sql/presto/tpcds/*.sql is
the consumer this surface is sized against). Same generator design as
the base module (connectors/tpcds.py): every column is a stateless
splitmix64 hash of the row's surrogate key, so any split generates any
row range referentially consistently; exact dsdgen bit-compatibility is
NOT a goal — correctness tests compare against an oracle over this same
generated data.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import types as T
from .tpch import _U64, _h, _money, _pick, _randint

V = T.VARCHAR

# fact channels: catalog ~= ss/2, web ~= ss/4; returns ~= 10% of sales
# (spec's rough channel proportions)
EXT_ROWS = {
    "catalog_sales": lambda sf: max(1, int(1_440_000 * sf)),
    "web_sales": lambda sf: max(1, int(720_000 * sf)),
    "store_returns": lambda sf: max(1, int(288_000 * sf)),
    "catalog_returns": lambda sf: max(1, int(144_000 * sf)),
    "web_returns": lambda sf: max(1, int(72_000 * sf)),
    "inventory": lambda sf: max(1000, int(1_200_000 * sf)),
    "warehouse": lambda sf: max(1, int(5 * max(sf, 1) ** 0.5)),
    "ship_mode": lambda sf: 20,
    "reason": lambda sf: 35,
    "call_center": lambda sf: max(1, int(6 * max(sf, 1) ** 0.5)),
    "catalog_page": lambda sf: max(1, int(11_718 * max(sf, 1) ** 0.5)),
    "web_site": lambda sf: max(1, int(30 * max(sf, 1) ** 0.5)),
    "web_page": lambda sf: max(1, int(60 * max(sf, 1) ** 0.5)),
    "income_band": lambda sf: 20,
}

_D = T.DOUBLE
_B = T.BIGINT
_I = T.INTEGER


def _sales_schema(p: str, extra: List[Tuple[str, T.Type]]):
    return [
        (f"{p}_sold_date_sk", _B), (f"{p}_sold_time_sk", _B),
        (f"{p}_ship_date_sk", _B),
        (f"{p}_bill_customer_sk", _B), (f"{p}_bill_cdemo_sk", _B),
        (f"{p}_bill_hdemo_sk", _B), (f"{p}_bill_addr_sk", _B),
        (f"{p}_ship_customer_sk", _B), (f"{p}_ship_addr_sk", _B),
        (f"{p}_ship_mode_sk", _B), (f"{p}_warehouse_sk", _B),
        (f"{p}_item_sk", _B), (f"{p}_promo_sk", _B),
        (f"{p}_order_number", _B),
        (f"{p}_quantity", _I), (f"{p}_wholesale_cost", _D),
        (f"{p}_list_price", _D), (f"{p}_sales_price", _D),
        (f"{p}_ext_discount_amt", _D), (f"{p}_ext_sales_price", _D),
        (f"{p}_ext_wholesale_cost", _D), (f"{p}_ext_list_price", _D),
        (f"{p}_ext_ship_cost", _D), (f"{p}_coupon_amt", _D),
        (f"{p}_net_paid", _D), (f"{p}_net_paid_inc_tax", _D),
        (f"{p}_net_profit", _D),
    ] + extra


EXT_SCHEMAS: Dict[str, List[Tuple[str, T.Type]]] = {
    "catalog_sales": _sales_schema("cs", [
        ("cs_call_center_sk", _B), ("cs_catalog_page_sk", _B)]),
    "web_sales": _sales_schema("ws", [
        ("ws_web_page_sk", _B), ("ws_web_site_sk", _B),
        ("ws_ship_hdemo_sk", _B)]),
    "store_returns": [
        ("sr_returned_date_sk", _B), ("sr_item_sk", _B),
        ("sr_customer_sk", _B), ("sr_cdemo_sk", _B),
        ("sr_hdemo_sk", _B), ("sr_addr_sk", _B), ("sr_store_sk", _B),
        ("sr_reason_sk", _B), ("sr_ticket_number", _B),
        ("sr_return_quantity", _I), ("sr_return_amt", _D),
        ("sr_return_tax", _D), ("sr_return_amt_inc_tax", _D),
        ("sr_fee", _D), ("sr_refunded_cash", _D),
        ("sr_reversed_charge", _D), ("sr_store_credit", _D),
        ("sr_net_loss", _D),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", _B), ("cr_item_sk", _B),
        ("cr_refunded_customer_sk", _B), ("cr_refunded_cdemo_sk", _B),
        ("cr_refunded_addr_sk", _B),
        ("cr_returning_customer_sk", _B), ("cr_returning_cdemo_sk", _B),
        ("cr_returning_addr_sk", _B),
        ("cr_call_center_sk", _B), ("cr_catalog_page_sk", _B),
        ("cr_reason_sk", _B), ("cr_order_number", _B),
        ("cr_return_quantity", _I), ("cr_return_amount", _D),
        ("cr_return_tax", _D), ("cr_return_amt_inc_tax", _D),
        ("cr_fee", _D), ("cr_refunded_cash", _D),
        ("cr_reversed_charge", _D), ("cr_store_credit", _D),
        ("cr_net_loss", _D),
    ],
    "web_returns": [
        ("wr_returned_date_sk", _B), ("wr_item_sk", _B),
        ("wr_refunded_customer_sk", _B), ("wr_refunded_cdemo_sk", _B),
        ("wr_refunded_addr_sk", _B),
        ("wr_returning_customer_sk", _B), ("wr_returning_cdemo_sk", _B),
        ("wr_returning_addr_sk", _B),
        ("wr_web_page_sk", _B), ("wr_reason_sk", _B),
        ("wr_order_number", _B),
        ("wr_return_quantity", _I), ("wr_return_amt", _D),
        ("wr_return_tax", _D), ("wr_return_amt_inc_tax", _D),
        ("wr_fee", _D), ("wr_refunded_cash", _D),
        ("wr_reversed_charge", _D), ("wr_account_credit", _D),
        ("wr_net_loss", _D),
    ],
    "inventory": [
        ("inv_date_sk", _B), ("inv_item_sk", _B),
        ("inv_warehouse_sk", _B), ("inv_quantity_on_hand", _I),
    ],
    "warehouse": [
        ("w_warehouse_sk", _B), ("w_warehouse_id", T.varchar(16)),
        ("w_warehouse_name", T.varchar(20)),
        ("w_warehouse_sq_ft", _I), ("w_city", T.varchar(60)),
        ("w_county", T.varchar(30)), ("w_state", T.varchar(2)),
        ("w_country", T.varchar(20)),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", _B), ("sm_ship_mode_id", T.varchar(16)),
        ("sm_type", T.varchar(30)), ("sm_code", T.varchar(10)),
        ("sm_carrier", T.varchar(20)),
    ],
    "reason": [
        ("r_reason_sk", _B), ("r_reason_id", T.varchar(16)),
        ("r_reason_desc", T.varchar(100)),
    ],
    "call_center": [
        ("cc_call_center_sk", _B), ("cc_call_center_id", T.varchar(16)),
        ("cc_name", T.varchar(50)), ("cc_manager", T.varchar(40)),
        ("cc_county", T.varchar(30)),
    ],
    "catalog_page": [
        ("cp_catalog_page_sk", _B), ("cp_catalog_page_id", T.varchar(16)),
    ],
    "web_site": [
        ("web_site_sk", _B), ("web_site_id", T.varchar(16)),
        ("web_name", T.varchar(50)), ("web_company_name", T.varchar(50)),
    ],
    "web_page": [
        ("wp_web_page_sk", _B), ("wp_web_page_id", T.varchar(16)),
        ("wp_char_count", _I),
    ],
    "income_band": [
        ("ib_income_band_sk", _B), ("ib_lower_bound", _I),
        ("ib_upper_bound", _I),
    ],
}

EXT_PRIMARY_KEYS = {
    "catalog_sales": (), "web_sales": (), "store_returns": (),
    "catalog_returns": (), "web_returns": (), "inventory": (),
    "warehouse": ("w_warehouse_sk",), "ship_mode": ("sm_ship_mode_sk",),
    "reason": ("r_reason_sk",), "call_center": ("cc_call_center_sk",),
    "catalog_page": ("cp_catalog_page_sk",),
    "web_site": ("web_site_sk",), "web_page": ("wp_web_page_sk",),
    "income_band": ("ib_income_band_sk",),
}

_SHIP_TYPES = ("EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY")
_CARRIERS = ("UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
             "LATVIAN", "DIAMOND", "BARIAN")
_CC_NAMES = ("NY Metro", "Mid Atlantic", "Pacific Northwest",
             "North Midwest", "California", "Hawaii/Alaska")
_WEB_COMPANIES = ("pri", "able", "ought", "ese", "anti", "cally")
_REASONS = tuple(f"reason {i}" for i in range(1, 36))
_CLASSES = ("accessories", "blazers", "dresses", "pants", "shirts",
            "shoes", "sports", "swimwear", "athletic", "classical",
            "country", "pop", "rock", "fiction", "history", "romance")
_COLORS = ("azure", "beige", "black", "blue", "brown", "coral", "cream",
           "cyan", "gold", "green", "grey", "indigo", "ivory", "khaki",
           "lime", "magenta", "maroon", "navy", "olive", "orange",
           "pink", "plum", "purple", "red", "rose", "salmon", "silver",
           "tan", "teal", "violet", "white", "yellow")
_SIZES = ("petite", "small", "medium", "large", "extra large",
          "economy", "N/A")
_UNITS = ("Each", "Box", "Case", "Dozen", "Pallet", "Gross", "Unknown",
          "Carton", "Bundle", "Ton", "Lb", "Oz")
_SALUTATIONS = ("Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir")
_COUNTRIES = ("UNITED STATES", "CANADA", "MEXICO", "GERMANY", "FRANCE",
              "JAPAN", "CHILE", "BRAZIL", "INDIA", "AUSTRALIA")
_STREET_NAMES = ("Main", "Oak", "Park", "First", "Second", "Elm",
                 "Maple", "Cedar", "Pine", "Washington", "Lake", "Hill")
_STREET_TYPES = ("Street", "Avenue", "Boulevard", "Road", "Lane",
                 "Drive", "Court", "Circle", "Way", "Parkway")
_LOCATION_TYPES = ("apartment", "condo", "single family")
_QUARTERS = tuple(f"{y}Q{q}" for y in range(1900, 2101)
                  for q in range(1, 5))


class ExtGen:
    """Generator mixin for the extension tables (merged into _Gen)."""

    # populated in _Gen.__init__
    sf: float

    def _n(self, table: str) -> int:
        return EXT_ROWS[table](self.sf)

    # -- shared sales-channel pricing (cs_/ws_) -----------------------------
    def _channel_sales(self, key: np.ndarray, cols: Sequence[str],
                       p: str, tag0: int, lines_per_order: int):
        """Lazy per-column generation: only the requested columns hash
        (the base module's per-column elif dispatch, expressed as a
        thunk table); the mutually-consistent pricing intermediates
        memoize so a multi-price projection still computes each once."""
        from .tpcds import D_BASE_SK, SALES_D0, SALES_D1
        memo: Dict[str, np.ndarray] = {}

        def mget(name: str, f):
            v = memo.get(name)
            if v is None:
                v = memo[name] = f()
            return v

        qty = lambda: mget("qty", lambda: 1 + (
            _h(key, tag0 + 1) % _U64(100)).astype(np.int64))
        wholesale = lambda: mget("wh", lambda: _money(
            key, tag0 + 2, 1.0, 100.0))
        list_price = lambda: mget("lp", lambda: np.round(
            wholesale() * (1.0 + (_h(key, tag0 + 3) % _U64(100))
                           .astype(np.float64) / 100.0), 2))
        sales_price = lambda: mget("sp", lambda: np.round(
            list_price() * ((_h(key, tag0 + 4) % _U64(100))
                            .astype(np.float64) / 100.0), 2))
        ext_sales = lambda: mget("es", lambda: np.round(
            sales_price() * qty(), 2))
        coupon = lambda: mget("cp", lambda: np.where(
            _h(key, tag0 + 5) % _U64(10) == 0,
            np.round(ext_sales() * 0.1, 2), 0.0))
        sold = lambda: mget("sold", lambda: SALES_D0 + (
            _h(key, tag0 + 6) % _U64(SALES_D1 - SALES_D0)
        ).astype(np.int64))

        def fk(tag, n):
            return lambda: 1 + (_h(key, tag0 + tag)
                                % _U64(max(n, 1))).astype(np.int64)

        vals = {
            "sold_date_sk": lambda: D_BASE_SK + sold(),
            "sold_time_sk": lambda: (_h(key, tag0 + 7)
                                     % _U64(86_400)).astype(np.int64),
            "ship_date_sk": lambda: D_BASE_SK + sold() + 1 + (
                _h(key, tag0 + 8) % _U64(90)).astype(np.int64),
            "bill_customer_sk": fk(9, self.n_cust),
            "bill_cdemo_sk": fk(10, self.n_demo),
            "bill_hdemo_sk": fk(11, self.n_hdemo),
            "bill_addr_sk": fk(12, self.n_addr),
            "ship_customer_sk": fk(13, self.n_cust),
            "ship_addr_sk": fk(14, self.n_addr),
            "ship_mode_sk": fk(15, self._n("ship_mode")),
            "warehouse_sk": fk(16, self._n("warehouse")),
            "item_sk": fk(17, self.n_item),
            "promo_sk": fk(18, self.n_promo),
            "order_number": lambda: 1 + (key.astype(np.int64) - 1)
            // lines_per_order,
            "quantity": lambda: qty().astype(np.int32),
            "wholesale_cost": wholesale,
            "list_price": list_price,
            "sales_price": sales_price,
            "ext_discount_amt": lambda: np.round(
                (list_price() - sales_price()) * qty(), 2),
            "ext_sales_price": ext_sales,
            "ext_wholesale_cost": lambda: np.round(
                wholesale() * qty(), 2),
            "ext_list_price": lambda: np.round(list_price() * qty(), 2),
            "ext_ship_cost": lambda: _money(key, tag0 + 19, 0.0, 20.0),
            "coupon_amt": coupon,
            "net_paid": lambda: np.round(ext_sales() - coupon(), 2),
            "net_paid_inc_tax": lambda: np.round(
                (ext_sales() - coupon()) * 1.05, 2),
            "net_profit": lambda: np.round(
                ext_sales() - coupon() - wholesale() * qty(), 2),
            "call_center_sk": fk(20, self._n("call_center")),
            "catalog_page_sk": fk(21, self._n("catalog_page")),
            "web_page_sk": fk(22, self._n("web_page")),
            "web_site_sk": fk(23, self._n("web_site")),
            "ship_hdemo_sk": fk(24, self.n_hdemo),
        }
        return {c: (vals[c[len(p) + 1:]](), None) for c in cols}

    def catalog_sales(self, key, cols):
        return self._channel_sales(key, cols, "cs", 400, 4)

    def web_sales(self, key, cols):
        return self._channel_sales(key, cols, "ws", 440, 3)

    # -- returns ------------------------------------------------------------
    def _returns(self, key: np.ndarray, cols: Sequence[str], p: str,
                 tag0: int, sales_table: str, lines_per_order: int):
        """Lazy per-column generation (see _channel_sales)."""
        from .tpcds import D_BASE_SK, SALES_D0, SALES_D1
        memo: Dict[str, np.ndarray] = {}

        def mget(name: str, f):
            v = memo.get(name)
            if v is None:
                v = memo[name] = f()
            return v

        amt = lambda: mget("amt", lambda: _money(key, tag0 + 2, 1.0,
                                                 500.0))
        tax = lambda: mget("tax", lambda: np.round(amt() * 0.05, 2))
        cash = lambda: mget("cash", lambda: np.round(
            amt() * ((_h(key, tag0 + 3) % _U64(100))
                     .astype(np.float64) / 100.0), 2))
        n_orders = max(1, EXT_ROWS.get(
            sales_table, lambda sf: int(2_880_000 * sf))(self.sf)
            // lines_per_order)

        def fk(tag, n):
            return lambda: 1 + (_h(key, tag0 + tag)
                                % _U64(max(n, 1))).astype(np.int64)

        vals = {
            "returned_date_sk": lambda: D_BASE_SK + SALES_D0 + (
                _h(key, tag0 + 4) % _U64(SALES_D1 - SALES_D0)
            ).astype(np.int64),
            "item_sk": fk(5, self.n_item),
            "customer_sk": fk(6, self.n_cust),
            "cdemo_sk": fk(7, self.n_demo),
            "hdemo_sk": fk(8, self.n_hdemo),
            "addr_sk": fk(9, self.n_addr),
            "store_sk": fk(10, self.n_store),
            "reason_sk": fk(11, self._n("reason")),
            "ticket_number": fk(12, n_orders),
            "order_number": fk(12, n_orders),
            "refunded_customer_sk": fk(6, self.n_cust),
            "refunded_cdemo_sk": fk(7, self.n_demo),
            "refunded_addr_sk": fk(9, self.n_addr),
            "returning_customer_sk": fk(13, self.n_cust),
            "returning_cdemo_sk": fk(14, self.n_demo),
            "returning_addr_sk": fk(15, self.n_addr),
            "call_center_sk": fk(16, self._n("call_center")),
            "catalog_page_sk": fk(17, self._n("catalog_page")),
            "web_page_sk": fk(18, self._n("web_page")),
            "return_quantity": lambda: (1 + (
                _h(key, tag0 + 1) % _U64(100)).astype(np.int64)
            ).astype(np.int32),
            "return_amt": amt,
            "return_amount": amt,
            "return_tax": tax,
            "return_amt_inc_tax": lambda: np.round(amt() + tax(), 2),
            "fee": lambda: _money(key, tag0 + 19, 0.5, 100.0),
            "refunded_cash": cash,
            "reversed_charge": lambda: np.round((amt() - cash()) * 0.5, 2),
            "store_credit": lambda: np.round((amt() - cash()) * 0.5, 2),
            "account_credit": lambda: np.round((amt() - cash()) * 0.5, 2),
            "net_loss": lambda: _money(key, tag0 + 20, 0.5, 300.0),
        }
        return {c: (vals[c[len(p) + 1:]](), None) for c in cols}

    def store_returns(self, key, cols):
        # ss_ticket_number packs 8 lines per ticket (tpcds.py)
        return self._returns(key, cols, "sr", 480, "store_sales", 8)

    def catalog_returns(self, key, cols):
        return self._returns(key, cols, "cr", 500, "catalog_sales", 4)

    def web_returns(self, key, cols):
        return self._returns(key, cols, "wr", 520, "web_sales", 3)

    # -- inventory ----------------------------------------------------------
    def inventory(self, key: np.ndarray, cols: Sequence[str]):
        from .tpcds import D_BASE_SK, SALES_D0
        out = {}
        for c in cols:
            if c == "inv_date_sk":
                # weekly snapshots across the active window
                week = (_h(key, 541) % _U64(261)).astype(np.int64)
                out[c] = (D_BASE_SK + SALES_D0 + week * 7, None)
            elif c == "inv_item_sk":
                out[c] = (1 + (_h(key, 542)
                               % _U64(self.n_item)).astype(np.int64), None)
            elif c == "inv_warehouse_sk":
                out[c] = (1 + (_h(key, 543)
                               % _U64(self._n("warehouse"))
                               ).astype(np.int64), None)
            elif c == "inv_quantity_on_hand":
                out[c] = (_randint(key, 544, 0, 1000).astype(np.int32),
                          None)
            else:
                raise KeyError(c)
        return out

    # -- small dimensions ---------------------------------------------------
    def warehouse(self, key: np.ndarray, cols: Sequence[str]):
        from .tpcds import CITIES, COUNTIES, STATES
        uniq = tuple(dict.fromkeys(STATES))
        remap = np.array([uniq.index(s) for s in STATES], dtype=np.int32)
        out = {}
        for c in cols:
            if c == "w_warehouse_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "w_warehouse_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "w_warehouse_name":
                names = tuple(f"Warehouse {i}" for i in range(1, 31))
                out[c] = ((key.astype(np.int64) - 1).astype(np.int32)
                          % len(names), names)
            elif c == "w_warehouse_sq_ft":
                out[c] = (_randint(key, 551, 50_000,
                                   1_000_000).astype(np.int32), None)
            elif c == "w_city":
                out[c] = ((_h(key, 552)
                           % _U64(len(CITIES))).astype(np.int32), CITIES)
            elif c == "w_county":
                out[c] = ((_h(key, 553)
                           % _U64(len(COUNTIES))).astype(np.int32),
                          COUNTIES)
            elif c == "w_state":
                out[c] = (remap[_pick(key, 554, STATES)], uniq)
            elif c == "w_country":
                out[c] = (np.zeros(len(key), dtype=np.int32),
                          ("United States",))
            else:
                raise KeyError(c)
        return out

    def ship_mode(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "sm_ship_mode_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "sm_ship_mode_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "sm_type":
                out[c] = (((key.astype(np.int64) - 1)
                           % len(_SHIP_TYPES)).astype(np.int32),
                          _SHIP_TYPES)
            elif c == "sm_code":
                codes = ("AIR", "SURFACE", "SEA")
                out[c] = (((key.astype(np.int64) - 1)
                           % len(codes)).astype(np.int32), codes)
            elif c == "sm_carrier":
                out[c] = (((key.astype(np.int64) - 1)
                           % len(_CARRIERS)).astype(np.int32), _CARRIERS)
            else:
                raise KeyError(c)
        return out

    def reason(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "r_reason_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "r_reason_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "r_reason_desc":
                out[c] = (((key.astype(np.int64) - 1)
                           % len(_REASONS)).astype(np.int32), _REASONS)
            else:
                raise KeyError(c)
        return out

    def call_center(self, key: np.ndarray, cols: Sequence[str]):
        from .tpcds import COUNTIES, FIRST_NAMES, LAST_NAMES
        out = {}
        for c in cols:
            if c == "cc_call_center_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "cc_call_center_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "cc_name":
                out[c] = (((key.astype(np.int64) - 1)
                           % len(_CC_NAMES)).astype(np.int32), _CC_NAMES)
            elif c == "cc_manager":
                fn = _h(key, 561) % _U64(len(FIRST_NAMES))
                ln = _h(key, 562) % _U64(len(LAST_NAMES))
                out[c] = ([f"{FIRST_NAMES[int(a)]} {LAST_NAMES[int(b)]}"
                           for a, b in zip(fn, ln)], "text")
            elif c == "cc_county":
                out[c] = ((_h(key, 563)
                           % _U64(len(COUNTIES))).astype(np.int32),
                          COUNTIES)
            else:
                raise KeyError(c)
        return out

    def catalog_page(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "cp_catalog_page_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "cp_catalog_page_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            else:
                raise KeyError(c)
        return out

    def web_site(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "web_site_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "web_site_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "web_name":
                names = tuple(f"site_{i}" for i in range(30))
                out[c] = (((key.astype(np.int64) - 1)
                           % len(names)).astype(np.int32), names)
            elif c == "web_company_name":
                out[c] = (((key.astype(np.int64) - 1)
                           % len(_WEB_COMPANIES)).astype(np.int32),
                          _WEB_COMPANIES)
            else:
                raise KeyError(c)
        return out

    def web_page(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        for c in cols:
            if c == "wp_web_page_sk":
                out[c] = (key.astype(np.int64), None)
            elif c == "wp_web_page_id":
                out[c] = ([f"AAAAAAAA{i:08d}" for i in key], "text")
            elif c == "wp_char_count":
                out[c] = (_randint(key, 571, 100,
                                   8000).astype(np.int32), None)
            else:
                raise KeyError(c)
        return out

    def income_band(self, key: np.ndarray, cols: Sequence[str]):
        out = {}
        sk = key.astype(np.int64)
        for c in cols:
            if c == "ib_income_band_sk":
                out[c] = (sk, None)
            elif c == "ib_lower_bound":
                out[c] = (((sk - 1) * 10_000).astype(np.int32), None)
            elif c == "ib_upper_bound":
                out[c] = ((sk * 10_000).astype(np.int32), None)
            else:
                raise KeyError(c)
        return out

    # -- extra columns on the base dimensions -------------------------------
    def ext_column(self, table: str, c: str, key: np.ndarray):
        """Generator for columns the base module's dimensions don't carry
        (the long tail the reference SQL references)."""
        from .tpcds import D_BASE_SK, SALES_D0, SALES_D1
        k = key.astype(np.int64)
        if table == "date_dim":
            days = k - 1
            if c == "d_dow":
                return ((days + 1) % 7).astype(np.int32), None   # 1900-01-01 = Monday
            if c == "d_week_seq":
                return (days // 7 + 1).astype(np.int32), None
            if c == "d_month_seq":
                dt = (np.datetime64("1900-01-01")
                      + days.astype("timedelta64[D]"))
                years = dt.astype("datetime64[Y]").astype(np.int64) + 1970
                months = dt.astype("datetime64[M]").astype(np.int64) \
                    % 12 + 1
                return ((years - 1900) * 12 + months - 1).astype(np.int32), None
            if c == "d_quarter_name":
                dt = (np.datetime64("1900-01-01")
                      + days.astype("timedelta64[D]"))
                years = dt.astype("datetime64[Y]").astype(np.int64) + 1970
                months = dt.astype("datetime64[M]").astype(np.int64) \
                    % 12 + 1
                qi = (years - 1900) * 4 + (months - 1) // 3
                return qi.astype(np.int32), _QUARTERS
        if table == "item":
            if c == "i_class_id":
                return (1 + _h(key, 580)
                        % _U64(len(_CLASSES))).astype(np.int32), None
            if c == "i_class":
                return (_h(key, 580)
                        % _U64(len(_CLASSES))).astype(np.int32), _CLASSES
            if c == "i_item_desc":
                return [f"Item description {int(i)}" for i in k], "text"
            if c == "i_manufact":
                return [f"manufact#{int(_h(np.asarray([i]), 581)[0] % 1000)}"
                        for i in k], "text"
            if c == "i_color":
                return (_h(key, 582)
                        % _U64(len(_COLORS))).astype(np.int32), _COLORS
            if c == "i_product_name":
                return [f"product {int(i)}" for i in k], "text"
            if c == "i_size":
                return (_h(key, 583)
                        % _U64(len(_SIZES))).astype(np.int32), _SIZES
            if c == "i_units":
                return (_h(key, 584)
                        % _U64(len(_UNITS))).astype(np.int32), _UNITS
            if c == "i_wholesale_cost":
                return _money(key, 585, 0.02, 80.0), None
        if table == "store":
            if c == "s_company_id":
                return np.ones(len(key), dtype=np.int32), None
            if c == "s_company_name":
                return np.zeros(len(key), dtype=np.int32), ("Unknown",)
            if c == "s_market_id":
                return _randint(key, 586, 1, 10).astype(np.int32), None
            if c == "s_street_number":
                return [str(100 + int(i) * 7 % 900) for i in k], "text"
            if c == "s_street_name":
                return (_h(key, 587)
                        % _U64(len(_STREET_NAMES))).astype(np.int32), \
                    _STREET_NAMES
            if c == "s_street_type":
                return (_h(key, 588)
                        % _U64(len(_STREET_TYPES))).astype(np.int32), \
                    _STREET_TYPES
            if c == "s_suite_number":
                return [f"Suite {int(i) % 100}" for i in k], "text"
        if table == "customer":
            if c == "c_salutation":
                return (_h(key, 590)
                        % _U64(len(_SALUTATIONS))).astype(np.int32), \
                    _SALUTATIONS
            if c == "c_birth_country":
                return (_h(key, 591)
                        % _U64(len(_COUNTRIES))).astype(np.int32), \
                    _COUNTRIES
            if c == "c_birth_day":
                return _randint(key, 592, 1, 28).astype(np.int32), None
            if c == "c_birth_month":
                return _randint(key, 593, 1, 12).astype(np.int32), None
            if c == "c_email_address":
                return [f"user{int(i)}@example.com" for i in k], "text"
            if c == "c_login":
                return [f"login{int(i)}" for i in k], "text"
            if c in ("c_first_sales_date_sk", "c_first_shipto_date_sk",
                     "c_last_review_date_sk"):
                tag = {"c_first_sales_date_sk": 594,
                       "c_first_shipto_date_sk": 595,
                       "c_last_review_date_sk": 596}[c]
                d = SALES_D0 + (_h(key, tag)
                                % _U64(SALES_D1 - SALES_D0)
                                ).astype(np.int64)
                return D_BASE_SK + d, None
        if table == "customer_address":
            if c == "ca_location_type":
                return (_h(key, 597)
                        % _U64(len(_LOCATION_TYPES))).astype(np.int32), \
                    _LOCATION_TYPES
            if c == "ca_street_number":
                return [str(100 + int(i) * 3 % 900) for i in k], "text"
            if c == "ca_street_name":
                return (_h(key, 598)
                        % _U64(len(_STREET_NAMES))).astype(np.int32), \
                    _STREET_NAMES
            if c == "ca_street_type":
                return (_h(key, 599)
                        % _U64(len(_STREET_TYPES))).astype(np.int32), \
                    _STREET_TYPES
            if c == "ca_suite_number":
                return [f"Suite {int(i) % 100}" for i in k], "text"
        raise KeyError(f"{table}.{c}")
