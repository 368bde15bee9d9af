"""Judging a statement's rows against its reference.

Rows match by their exact columns (strings, integers, NULLs); a float
column is compared by its relative gap to the reference's value. The
order is checked with the reference's values under the template's ORDER
BY, where float sort keys within ``TIE_REL`` of each other count as
ties.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: float sort keys this close (relative) are ties for the order check
TIE_REL = 1e-9
#: the denominator's floor of a relative gap (money is >= 0.01 when
#: it is not 0)
GAP_FLOOR = 1e-12


def plain(v):
    """numpy scalars as Python values."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    return v


@dataclasses.dataclass
class Verdict:
    matched: bool
    gap: float
    why: str = ""
    #: (row, column, got, reference) of the widest gap
    worst: Optional[Tuple] = None


def _gap(got, want) -> Optional[float]:
    """Relative gap of one float cell; None when the cells disagree on
    NULL."""
    if got is None or want is None:
        return 0.0 if got is None and want is None else None
    if math.isnan(got) or math.isinf(got):
        return math.inf
    return abs(got - want) / max(abs(want), GAP_FLOOR)


def _sort_key_cmp(a: Tuple, b: Tuple, order: Sequence[Tuple[int, bool]]):
    """-1, 0, 1: a before, tied with, after b under ``order`` (NULLs
    last), floats tied within TIE_REL."""
    for col, desc in order:
        x, y = a[col], b[col]
        if x is None or y is None:
            if x is None and y is None:
                continue
            return 1 if x is None else -1
        if isinstance(x, float) or isinstance(y, float):
            if abs(x - y) <= TIE_REL * max(abs(x), abs(y), GAP_FLOOR):
                continue
        if x == y:
            continue
        c = -1 if x < y else 1
        return -c if desc else c
    return 0


def judge(got_rows: Sequence[Sequence], want: List[Tuple],
          order: Sequence[Tuple[int, bool]]) -> Verdict:
    """Compare a statement's rows with all of the reference's."""
    got = [tuple(plain(v) for v in row) for row in got_rows]
    if len(got) != len(want):
        return Verdict(False, 0.0, f"{len(got)} rows, expected {len(want)}")
    floats = [isinstance(v, float) for v in (want[0] if want else ())]
    for row in want:
        for i, v in enumerate(row):
            floats[i] = floats[i] or isinstance(v, float)

    def exact(row):
        return tuple(v for v, f in zip(row, floats) if not f)

    index: Dict[Tuple, List[int]] = {}
    for i, row in enumerate(want):
        index.setdefault(exact(row), []).append(i)
    worst, where = 0.0, None
    picked: List[int] = []
    for n, row in enumerate(got):
        if len(row) != len(floats):
            return Verdict(False, worst, f"{len(row)} columns")
        cands = index.get(exact(row))
        if not cands:
            return Verdict(False, worst, f"no reference row {exact(row)}")
        i = cands.pop(0)
        picked.append(i)
        for c, (f, x, y) in enumerate(zip(floats, row, want[i])):
            if f:
                g = _gap(x, y)
                if g is None:
                    return Verdict(False, worst, f"NULL against {y!r}")
                if g > worst:
                    worst, where = g, (n, c, x, y)
    for a, b in zip(picked, picked[1:]):
        if _sort_key_cmp(want[a], want[b], order) > 0:
            return Verdict(False, worst, "rows out of order", where)
    return Verdict(True, worst, "", where)
