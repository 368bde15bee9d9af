"""TPC-H q13 to q22 by SQL through presto_tpu's LocalRunner and
presto_tpu_torch's LocalRunner on the CPU (the companion of
test_torch_tpch.py): the same names, types and rows in the same order;
doubles within rel 1e-12, everything else exact. q20 runs at SF 0.05,
the smallest scale of 0.01, 0.05 and 0.1 where it returns rows."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match
from tpch_queries import Q

SQL = {name: sql for name, sql, _ in Q}
SF = 0.01


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=SF), TLocalRunner(tpch_sf=SF, device="cpu")


def _check(jax_runner, torch_runner, name):
    want = jax_runner.execute(SQL[name])
    got = torch_runner.execute(SQL[name])
    assert got.rows, name
    assert_results_match(got, want, 1e-12)


@pytest.mark.parametrize("name", ["q13", "q14", "q15", "q16", "q17", "q18",
                                  "q19", "q21", "q22"])
def test_tpch_query_matches_reference(runners, name):
    _check(*runners, name)


def test_tpch_q20_matches_reference_at_sf_005():
    _check(LocalRunner(tpch_sf=0.05),
           TLocalRunner(tpch_sf=0.05, device="cpu"), "q20")
