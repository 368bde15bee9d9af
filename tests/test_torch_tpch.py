"""TPC-H queries beyond Q6, Q1 and Q3 (q2 to q12) by SQL through
presto_tpu's LocalRunner and presto_tpu_torch's LocalRunner on the CPU at
SF 0.01: the same names, types and rows in the same order; doubles within
rel 1e-12 (the engines sum doubles in different orders), everything else
exact. The rest of the queries are in test_torch_tpch_rest.py, so that
the JAX compiles of the two halves run in parallel workers."""
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


@pytest.mark.parametrize("name", ["q2", "q4", "q5", "q7", "q8", "q9", "q10",
                                  "q11", "q12"])
def test_tpch_query_matches_reference(runners, name):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(SQL[name])
    got = torch_runner.execute(SQL[name])
    assert got.rows, name
    assert_results_match(got, want, 1e-12)
