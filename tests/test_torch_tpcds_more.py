"""TPC-DS battery queries of tests/tpcds_queries.py without windows
(the companion of test_torch_tpcds.py) through presto_tpu's LocalRunner
and presto_tpu_torch's on the CPU: the same names, types and rows in the
same order; doubles within rel 1e-12.

q34 returns no rows at any scale: its ``cnt between 15 and 20`` asks
for more rows per (ticket, customer) than the generator's eight rows per
ticket, so both engines must return none."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match
from tpcds_queries import Q

SQL = {name: sql for name, sql, _ in Q}
SF = 0.01


@pytest.fixture(scope="module")
def runners():
    return (LocalRunner(tpch_sf=SF, catalog="tpcds"),
            TLocalRunner(tpch_sf=SF, catalog="tpcds", device="cpu"))


@pytest.mark.parametrize("name", ["q43", "q65", "q68", "q73", "q79", "q88",
                                  "q96", "q96_meal", "q6_store"])
def test_tpcds_query_matches_reference(runners, name):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(SQL[name])
    got = torch_runner.execute(SQL[name])
    assert got.rows, name
    assert_results_match(got, want, 1e-12)


def test_q34_is_empty_in_both_engines(runners):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(SQL["q34"])
    got = torch_runner.execute(SQL["q34"])
    assert got.rows == want.rows == []
    assert_results_match(got, want, 1e-12)


@pytest.mark.parametrize("sql,count", [
    ("select count(*) from store, customer_address where s_zip = ca_zip",
     lambda hits, n: hits),
    ("select count(*) from customer_address where ca_zip in "
     "(select s_zip from store)", lambda hits, n: hits),
    ("select count(*) from customer_address where ca_zip not in "
     "(select s_zip from store)", lambda hits, n: n - hits),
])
def test_join_on_text_keys_of_two_vocabularies(runners, sql, count):
    """Free-text columns (zip codes) carry per-batch vocabularies, so the
    two sides of a join on them code equal strings differently; the port
    re-codes the probe's keys into the build's vocabulary first. Held
    against a count over the scanned strings (presto_tpu compares the raw
    codes here and counts 34 for the first query; ROADMAP section 3)."""
    torch_runner = runners[1]
    zips = {r[0] for r in torch_runner.execute("select s_zip from store").rows}
    ca = [r[0] for r in torch_runner.execute(
        "select ca_zip from customer_address").rows]
    hits = sum(z in zips for z in ca)
    assert 0 < hits < len(ca)
    assert torch_runner.execute(sql).rows == [(count(hits, len(ca)),)]
