"""TPC-H columns regenerated from frozen copies of the generator's formulas.

The engine's TPC-H connector makes every column a splitmix64 hash of the
row's key: orders are keyed 1..1.5M*SF, an order has 1 + h(okey, 100) mod 7
lines, a line is keyed okey*8 + its 0-based line number. The formulas
below restate those of the columns the templates read; dates are days
since 1970-01-01, flags are codes into the connector's dictionaries.
"""
from __future__ import annotations

import datetime
from typing import Dict

import torch

from ..hashing import div, h, umod

START_DATE = 8035        # 1992-01-01
END_ORDERDATE = 10440    # 1998-08-02
CURRENT_DATE = 9298      # 1995-06-17
ORDERDATE_SPAN = END_ORDERDATE - START_DATE + 1
RETURN_FLAGS = ("A", "N", "R")
LINE_STATUS = ("O", "F")
_EPOCH = datetime.date(1970, 1, 1)


def epoch_day(d: datetime.date) -> int:
    return (d - _EPOCH).days


def n_orders(sf: float) -> int:
    return int(1_500_000 * sf)


def n_part(sf: float) -> int:
    return int(200_000 * sf)


class Data:
    """The columns of one scale factor on one device, made once."""

    def __init__(self, sf: float, device):
        self.sf = sf
        self.device = torch.device(device)
        self._lineitem: Dict[str, torch.Tensor] = {}

    def lineitem(self) -> Dict[str, torch.Tensor]:
        """quantity, extendedprice, discount, tax (float64), returnflag,
        linestatus (int8 codes), shipdate (int32)."""
        if not self._lineitem:
            self._lineitem = _lineitem(self.sf, self.device)
        return self._lineitem

    def free(self) -> None:
        self._lineitem = {}


def _lineitem(sf: float, device) -> Dict[str, torch.Tensor]:
    okeys = torch.arange(1, n_orders(sf) + 1, dtype=torch.int64,
                         device=device)
    counts = 1 + umod(h(okeys, 100), 7)
    odate_of_order = START_DATE + umod(h(okeys, 5), ORDERDATE_SPAN)
    okey = torch.repeat_interleave(okeys, counts)
    odate = torch.repeat_interleave(odate_of_order, counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    ln = torch.arange(okey.shape[0], dtype=torch.int64, device=device) - first
    del okeys, counts, odate_of_order, first
    key = okey * 8 + ln
    del okey, ln
    partkey = 1 + umod(h(key, 11), n_part(sf))
    quantity = 1 + umod(h(key, 13), 50)
    shipdate = odate + 1 + umod(h(key, 17), 121)
    receipt = shipdate + 1 + umod(h(key, 19), 30)
    del odate
    pk = partkey
    retail = div((90000 + torch.div(pk, 10, rounding_mode="floor") % 20001
                  + 100 * (pk % 1000)).to(torch.float64), 100.0)
    qty = quantity.to(torch.float64)
    out = {
        "quantity": qty,
        "extendedprice": qty * retail,
        "discount": div(umod(h(key, 14), 11).to(torch.float64), 100.0),
        "tax": div(umod(h(key, 15), 9).to(torch.float64), 100.0),
        # A or R once received by CURRENT_DATE, N after it
        "returnflag": torch.where(receipt <= CURRENT_DATE,
                                  umod(h(key, 16), 2) * 2, 1).to(torch.int8),
        # O (0) when shipped after CURRENT_DATE, else F (1)
        "linestatus": (shipdate <= CURRENT_DATE).to(torch.int8),
        "shipdate": shipdate.to(torch.int32),
    }
    return out
