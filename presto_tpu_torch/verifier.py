"""Verifier: replay queries against a control and a test runner, compare.

The counterpart of ``presto_tpu/verifier.py`` (the role of
presto-verifier, reference presto-verifier/.../verifier/Verifier.java and
Validator.java:68: run each query on a control and a test cluster,
normalize, diff, report MATCH / MISMATCH / failures). A runner is
anything with ``execute(sql) -> QueryResult``, so the same harness holds
the port's CUDA runner against its CPU runner, or one commit against
another. Rows compare as sorted multisets; doubles compare after
rounding to ``precision`` decimal places, as in the reference, or, with
``rel_tol`` set, within that relative tolerance. The port's CUDA runner
sums doubles with atomic adds in no fixed order, so a sum near 1e9
differs from the CPU's by up to about 1e-4, which moves its sixth
decimal: a comparison of the two runners passes ``rel_tol``. The
command-line entry of the reference drives the distributed runner and
is not ported.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence


@dataclasses.dataclass
class VerifyResult:
    query: str
    status: str          # MATCH | MISMATCH | CONTROL_FAILED | TEST_FAILED
    detail: str = ""
    control_ms: float = 0.0
    test_ms: float = 0.0


def _normalize(rows: Sequence, precision: Optional[int]) -> List:
    out = []
    for r in rows:
        vals = []
        for v in r:
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, float) and precision is not None:
                v = round(v, precision)
            vals.append(v)
        out.append(tuple(vals))
    # order-insensitive: the reference re-sorts deterministically too
    # (Validator resultsMatch over sorted lists)
    return sorted(out, key=repr)


def _same(a, b, rel_tol: Optional[float]) -> bool:
    if rel_tol is None or len(a) != len(b):
        return a == b
    return all(math.isclose(u, v, rel_tol=rel_tol)
               if isinstance(u, float) and isinstance(v, float) else u == v
               for u, v in zip(a, b))


class Verifier:
    def __init__(self, control, test, precision: int = 6,
                 rel_tol: Optional[float] = None):
        self.control = control
        self.test = test
        self.precision = precision
        self.rel_tol = rel_tol

    def verify_one(self, sql: str) -> VerifyResult:
        t0 = time.perf_counter()
        try:
            want = self.control.execute(sql)
        except Exception as e:
            return VerifyResult(sql, "CONTROL_FAILED",
                                f"{type(e).__name__}: {e}")
        control_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        try:
            got = self.test.execute(sql)
        except Exception as e:
            return VerifyResult(sql, "TEST_FAILED",
                                f"{type(e).__name__}: {e}",
                                control_ms=control_ms)
        test_ms = (time.perf_counter() - t1) * 1e3
        digits = self.precision if self.rel_tol is None else None
        w = _normalize(want.rows, digits)
        g = _normalize(got.rows, digits)
        if len(w) != len(g):
            return VerifyResult(
                sql, "MISMATCH",
                f"row count: control={len(w)} test={len(g)}",
                control_ms, test_ms)
        for i, (a, b) in enumerate(zip(w, g)):
            if not _same(a, b, self.rel_tol):
                return VerifyResult(
                    sql, "MISMATCH",
                    f"first differing row {i}: control={a!r} test={b!r}",
                    control_ms, test_ms)
        return VerifyResult(sql, "MATCH", "", control_ms, test_ms)

    def run(self, queries: Sequence[str]) -> List[VerifyResult]:
        return [self.verify_one(q) for q in queries]
