"""TPC-DS battery queries with window functions (q53, q89, q98) at
SF 0.01, and q3, q42 and q52 at SF 0.05 (the smallest of 0.01, 0.05 and
0.1 where they return rows), through presto_tpu's LocalRunner and
presto_tpu_torch's on the CPU: the same names, types and rows in the
same order; doubles within rel 1e-12. Companion of test_torch_tpcds.py."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match
from tpcds_queries import Q

SQL = {name: sql for name, sql, _ in Q}


def _runners(sf):
    return (LocalRunner(tpch_sf=sf, catalog="tpcds"),
            TLocalRunner(tpch_sf=sf, catalog="tpcds", device="cpu"))


@pytest.fixture(scope="module")
def runners():
    return _runners(0.01)


@pytest.fixture(scope="module")
def runners_005():
    return _runners(0.05)


def _check(jax_runner, torch_runner, name):
    want = jax_runner.execute(SQL[name])
    got = torch_runner.execute(SQL[name])
    assert got.rows, name
    assert_results_match(got, want, 1e-12)


@pytest.mark.parametrize("name", ["q53", "q89", "q98"])
def test_window_query_matches_reference(runners, name):
    _check(*runners, name)


@pytest.mark.parametrize("name", ["q3", "q42", "q52"])
def test_query_matches_reference_at_sf_005(runners_005, name):
    _check(*runners_005, name)
