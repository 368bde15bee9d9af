"""ON residuals of outer joins through presto_tpu's LocalRunner and
presto_tpu_torch's LocalRunner on the CPU at TPC-H SF 0.01: the residual
gates matches and never drops probe rows, and a FULL join's
unmatched-build tail counts only matches that survive it; unique and
repeated builds. Same names, types and rows in the same order."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


QUERIES = {
    "left_residual_both_sides": """
        select c_custkey, o_orderkey from customer
        left join orders on c_custkey = o_custkey
                        and o_totalprice > 150000
        order by c_custkey, o_orderkey""",
    "left_residual_probe_side": """
        select c_custkey, count(o_orderkey) from customer
        left join orders on c_custkey = o_custkey and c_acctbal > 0
        group by c_custkey order by c_custkey""",
    "left_residual_expanding": """
        select o_orderkey, l_linenumber from orders
        left join lineitem on o_orderkey = l_orderkey
                          and l_quantity * 2 > 60
        order by o_orderkey, l_linenumber""",
    "full_residual": """
        select n_name, s_name from nation
        full outer join supplier on n_nationkey = s_nationkey
                                and s_acctbal > 4000
        order by n_name nulls last, s_name nulls last""",
    "left_residual_never_true": """
        select c_custkey, o_orderkey from customer
        left join orders on c_custkey = o_custkey and 1 = 0
        order by c_custkey limit 50""",
    "left_residual_unique_build": """
        select o_orderkey, c_name from orders
        left join customer on o_custkey = c_custkey
                          and c_acctbal * 50 > o_totalprice
        order by o_orderkey""",
    "full_residual_unique_build": """
        select n_name, r_name from nation
        full outer join region on n_regionkey = r_regionkey
                              and n_nationkey > r_regionkey * 5
        order by n_name nulls last, r_name nulls last""",
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_outer_residual_matches_reference(runners, name):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(QUERIES[name])
    got = torch_runner.execute(QUERIES[name])
    assert got.rows, name
    assert_results_match(got, want, 1e-12)
