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
decimal: a comparison of the two runners passes ``rel_tol``.

``python -m presto_tpu_torch.verifier QUERIES_FILE`` verifies a
``;``-separated query file with a LocalRunner as control and, by
default, a DistributedRunner over the same catalogs as test (the
reference verifier CLI's shape); ``--device cpu`` runs both on the CPU.
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


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: verify a ;-separated query file, local control vs
    distributed (or local) test; exit status 1 unless every query
    matches."""
    import argparse

    from .exec.runner import LocalRunner

    p = argparse.ArgumentParser(description="presto_tpu_torch verifier")
    p.add_argument("queries", help="file of ;-separated SQL statements")
    p.add_argument("--tpch-sf", type=float, default=0.01)
    p.add_argument("--test", choices=["distributed", "local"],
                   default="distributed")
    p.add_argument("--device", default=None,
                   help="torch device of both runners (default: the GPU)")
    p.add_argument("--rel-tol", type=float, default=None,
                   help="compare doubles within this relative tolerance")
    args = p.parse_args(argv)
    with open(args.queries, encoding="utf-8") as f:
        queries = [q.strip() for q in f.read().split(";") if q.strip()]
    control = LocalRunner(tpch_sf=args.tpch_sf, device=args.device)
    if args.test == "distributed":
        from .exec.distributed import DistributedRunner
        test = DistributedRunner(catalogs=control.session.catalogs,
                                 device=args.device)
    else:
        test = LocalRunner(tpch_sf=args.tpch_sf, device=args.device)
    results = Verifier(control, test, rel_tol=args.rel_tol).run(queries)
    for r in results:
        print(f"{r.status:15s} {r.control_ms:8.1f}ms {r.test_ms:8.1f}ms  "
              f"{r.query[:80]!r}" + (f"  -- {r.detail}" if r.detail
                                     else ""))
    failed = sum(r.status != "MATCH" for r in results)
    print(f"{len(results) - failed}/{len(results)} MATCH")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
