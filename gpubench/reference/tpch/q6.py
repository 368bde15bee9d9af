"""TPC-H Q6, the forecasting revenue change: one sum over the lines of a
year within a discount band and under a quantity."""
from __future__ import annotations

import datetime
from decimal import Decimal

import torch

from .tables import epoch_day

ORDER_BY = ()


def answer(data, params, dtype=torch.float64):
    li = data.lineitem()
    year = int(params["year"])
    cents = int(Decimal(params["discount"]) * 100)
    # the bounds are exact decimals, compared as doubles
    lo, hi = (cents - 1) / 100, (cents + 1) / 100
    ship = li["shipdate"]
    sel = ((ship >= epoch_day(datetime.date(year, 1, 1)))
           & (ship < epoch_day(datetime.date(year + 1, 1, 1)))
           & (li["discount"] >= lo) & (li["discount"] <= hi)
           & (li["quantity"] < int(params["quantity"])))
    if not bool(sel.any()):
        return [(None,)]
    revenue = torch.where(sel, li["extendedprice"].to(dtype)
                          * li["discount"].to(dtype), 0).sum()
    return [(float(revenue),)]
