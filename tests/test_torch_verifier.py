"""The verifier of presto_tpu_torch against presto_tpu's (the cases of
tests/test_verifier.py): both harnesses over the same pairs of the
port's CPU runners give the same statuses and details."""
import pytest

from presto_tpu.verifier import Verifier as JVerifier
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.verifier import Verifier, _normalize

QUERIES = [
    "select count(*) from nation",
    "select n_regionkey, count(*) from nation group by 1 order by 1",
    "select sum(l_extendedprice * l_discount) from lineitem",
    "select n_name from nation order by 1",
]


@pytest.fixture(scope="module")
def runners():
    return (LocalRunner(tpch_sf=0.001, device="cpu"),
            LocalRunner(tpch_sf=0.001, device="cpu"),
            LocalRunner(tpch_sf=0.01, device="cpu"))


def _fields(results):
    return [(r.query, r.status, r.detail) for r in results]


def test_match_and_mismatch(runners):
    control, same, bigger = runners
    results = Verifier(control, same).run(QUERIES)
    assert [r.status for r in results] == ["MATCH"] * len(QUERIES)
    assert all(r.control_ms > 0 and r.test_ms > 0 for r in results)
    assert _fields(results) == _fields(JVerifier(control, same).run(QUERIES))
    # row-content mismatch (another scale factor)
    bad = Verifier(control, bigger).verify_one(
        "select count(*) from lineitem")
    assert bad.status == "MISMATCH" and "row 0" in bad.detail
    want = JVerifier(control, bigger).verify_one(
        "select count(*) from lineitem")
    assert (bad.status, bad.detail) == (want.status, want.detail)
    rows = Verifier(control, bigger).verify_one("select * from region")
    assert rows.status == "MATCH"
    count = Verifier(control, bigger).verify_one(
        "select n_name from nation where n_nationkey < 3 + "
        "(select count(*) from lineitem) / 1000")
    assert count.status == "MISMATCH" and "row count" in count.detail


def test_failures_classified(runners):
    control = runners[0]

    class Broken:
        def execute(self, sql):
            raise RuntimeError("boom")

    for cls in (Verifier, JVerifier):
        assert cls(Broken(), control).verify_one(
            "select 1").status == "CONTROL_FAILED"
        r = cls(control, Broken()).verify_one("select 1")
        assert r.status == "TEST_FAILED" and "boom" in r.detail


class _Rows:
    """A runner stand-in that answers every query with fixed rows."""

    def __init__(self, rows):
        self.rows = rows

    def execute(self, sql):
        return self


def test_relative_tolerance_for_unordered_sums():
    """Sums of ~1e9 that differ in their last bits (the card's atomic
    adds) miss at six decimals and match within rel_tol; a real
    difference still mismatches."""
    a = _Rows([("A", 533509561.0631726), ("B", 1.5)])
    b = _Rows([("B", 1.5), ("A", 533509561.06317246)])
    assert Verifier(a, b).verify_one("q").status == "MISMATCH"
    assert JVerifier(a, b).verify_one("q").status == "MISMATCH"
    assert Verifier(a, b, rel_tol=1e-9).verify_one("q").status == "MATCH"
    c = _Rows([("A", 533509600.0), ("B", 1.5)])
    assert Verifier(a, c, rel_tol=1e-9).verify_one("q").status == "MISMATCH"
    assert Verifier(a, _Rows([("A", 533509561.0631726)]),
                    rel_tol=1e-9).verify_one("q").detail.startswith(
                        "row count")


def test_normalize_unwraps_numpy_and_sorts():
    import numpy as np
    rows = [(np.int64(2), np.float64(0.1234567891)), (np.int64(1), 0.5)]
    assert _normalize(rows, 6) == [(1, 0.5), (2, 0.123457)]
    assert _normalize(rows, None)[1] == (2, 0.1234567891)
