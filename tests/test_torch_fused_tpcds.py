"""Fused join chains on TPC-DS (the companion of test_torch_fused.py, so
the two files' JAX compiles run in parallel workers): at SF 0.01 every
battery query of tests/tpcds_queries.py takes the chain exactly where
presto_tpu does and returns its rows; the q27-shaped star chain of
test_dense_group.py, with the compaction floor at 1 and a window of 2,
sends fewer than half its source lanes into the tail and returns the
rows of presto_tpu and of the port's own run with fused_pipeline off."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY

from test_torch_fused import run_both
from torch_parity import assert_results_match
from tpcds_queries import Q

SQL = {name: sql for name, sql, _ in Q}
SF = 0.01
#: the battery queries the reference runs through a fused chain
FUSED_TPCDS = {"q3", "q7", "q13", "q19", "q34", "q42", "q48", "q52", "q53",
               "q65", "q68", "q73", "q79", "q89", "q26_store", "q6_store"}

#: tests/test_dense_group.py's _Q27ISH
Q27ISH = """
select i_item_id, s_state, avg(ss_quantity) agg1
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College' and d_year = 2002
group by i_item_id, s_state
order by i_item_id, s_state
limit 50
"""


@pytest.fixture(scope="module")
def runners():
    return (LocalRunner(tpch_sf=SF, catalog="tpcds"),
            TLocalRunner(tpch_sf=SF, catalog="tpcds", device="cpu"))


@pytest.mark.parametrize("name", sorted(SQL))
def test_tpcds_chain_taken_where_reference_takes_it(runners, name):
    got, want, lanes, ref_lanes = run_both(runners, SQL[name])
    assert (ref_lanes > 0) == (name in FUSED_TPCDS)
    assert (lanes > 0) == (ref_lanes > 0), (lanes, ref_lanes)
    assert_results_match(got, want, 1e-12)


def test_q27ish_tail_lanes_shrink(runners):
    props = {"fused_compact_floor": 1, "fused_compact_window": 2}
    src = REGISTRY.counter("fused_source_lanes_total")
    tail = REGISTRY.counter("fused_tail_lanes_total")
    readbacks = REGISTRY.counter("fused_liveness_readbacks_total")
    s0, t0, r0 = src.value, tail.value, readbacks.value
    got, want, _, ref_lanes = run_both(runners, Q27ISH, props)
    n_src, n_tail = src.value - s0, tail.value - t0
    assert ref_lanes > 0 and n_src > 0
    assert n_tail < n_src / 2, (n_src, n_tail)
    assert readbacks.value > r0
    assert got.rows
    assert_results_match(got, want, 1e-12)
    plain = runners[1].execute(Q27ISH, properties={"fused_pipeline": False})
    assert plain.rows == got.rows
