"""TPC-H Q1, the pricing summary report: grouped sums and averages over
the lines shipped by 1998-12-01 less DELTA days."""
from __future__ import annotations

import datetime

import torch

from .tables import LINE_STATUS, RETURN_FLAGS, epoch_day

#: (column, descending): order by l_returnflag, l_linestatus
ORDER_BY = ((0, False), (1, False))


def answer(data, params, dtype=torch.float64):
    li = data.lineitem()
    cutoff = epoch_day(datetime.date(1998, 12, 1)) - int(params["delta"])
    live = li["shipdate"] <= cutoff
    qty, price, disc, tax = (li[c].to(dtype) for c in
                             ("quantity", "extendedprice", "discount", "tax"))
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    groups = sorted((RETURN_FLAGS[f], LINE_STATUS[s], f, s)
                    for f in range(len(RETURN_FLAGS))
                    for s in range(len(LINE_STATUS)))
    rows = []
    for fname, sname, f, s in groups:
        sel = live & (li["returnflag"] == f) & (li["linestatus"] == s)
        n = int(sel.sum())
        if n == 0:
            continue
        sums = [float(torch.where(sel, x, 0).sum())
                for x in (qty, price, disc_price, charge, disc)]
        rows.append((fname, sname, sums[0], sums[1], sums[2], sums[3],
                     sums[0] / n, sums[1] / n, sums[4] / n, n))
    return rows
