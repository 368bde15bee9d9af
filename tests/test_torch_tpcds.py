"""TPC-DS through presto_tpu's LocalRunner and presto_tpu_torch's on the
CPU at SF 0.01 (catalog ``tpcds``): q27 (ROLLUP and GROUPING()) and the
star joins over customer_demographics and promotion of
tests/tpcds_queries.py. The same names, types and rows in the same
order; doubles within rel 1e-12. Also: the port's TPC-DS generators give
the same arrays as presto_tpu's for every table. The other battery
queries are in test_torch_tpcds_more.py and test_torch_tpcds_windows.py,
so that the JAX compiles of the three files run in parallel workers."""
import numpy as np
import pytest

from presto_tpu.connectors.tpcds import TpcdsConnector
from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.connectors.spi import Split, TableHandle
from presto_tpu_torch.connectors.tpcds import (
    TABLES, TpcdsConnector as TTpcds, tpcds_schema,
)
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match
from tpcds_queries import Q

SQL = {name: sql for name, sql, _ in Q}
SF = 0.01

#: q27 as the benchmark runs it (bench.py)
Q27 = """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College' and d_year = 2002
  and s_state in ('TN', 'TN', 'TN', 'TN', 'TN', 'TN')
group by rollup (i_item_id, s_state)
order by i_item_id nulls last, s_state nulls last
limit 100
"""


@pytest.fixture(scope="module")
def runners():
    return (LocalRunner(tpch_sf=SF, catalog="tpcds"),
            TLocalRunner(tpch_sf=SF, catalog="tpcds", device="cpu"))


def test_q27_matches_reference(runners):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(Q27)
    got = torch_runner.execute(Q27)
    assert {r[2] for r in got.rows} == {0, 1}
    assert_results_match(got, want, 1e-12)


@pytest.mark.parametrize("name", ["q7", "q13", "q19", "q26_store", "q48",
                                  "q55"])
def test_tpcds_query_matches_reference(runners, name):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(SQL[name])
    got = torch_runner.execute(SQL[name])
    assert got.rows, name
    assert_results_match(got, want, 1e-12)


def _key_range(table):
    """A range of surrogate keys inside the table at SF 0.01: the first
    rows, and a slice deeper in the large tables."""
    from presto_tpu_torch.connectors.tpcds import _rows
    n = _rows(table, SF)
    lo = max(1, min(n // 2, 700_000))
    return [(1, min(n, 600) + 1), (lo, min(n, lo + 900) + 1)]


@pytest.mark.parametrize("table", TABLES)
def test_generators_make_identical_arrays(table):
    from presto_tpu.connectors.spi import Split as JSplit
    from presto_tpu.connectors.spi import TableHandle as JHandle
    jconn, tconn = TpcdsConnector(sf=SF), TTpcds(sf=SF)
    cols = tpcds_schema(table).names
    for a, b in _key_range(table):
        js = JSplit(JHandle("tpcds", "default", table), (a, b))
        ts = Split(TableHandle("tpcds", "default", table), (a, b))
        jb = list(jconn.page_source(js, cols, rows_per_batch=512).batches())
        tb = list(tconn.page_source(ts, cols, rows_per_batch=512,
                                    device="cpu").batches())
        assert len(jb) == len(tb) > 0
        for x, y in zip(jb, tb):
            assert np.array_equal(np.asarray(x.row_mask), y.row_mask.numpy())
            for name, cx, cy in zip(cols, x.columns, y.columns):
                assert cx.dictionary == cy.dictionary, name
                assert np.array_equal(np.asarray(cx.data), cy.data.numpy()), \
                    name
                assert np.array_equal(np.asarray(cx.validity),
                                      cy.validity.numpy()), name


def test_stats_and_splits_match_reference():
    from presto_tpu.connectors.spi import TableHandle as JHandle
    jconn, tconn = TpcdsConnector(sf=SF), TTpcds(sf=SF)
    for table in TABLES:
        js = jconn.metadata.table_stats(JHandle("tpcds", "default", table))
        ts = tconn.metadata.table_stats(TableHandle("tpcds", "default",
                                                    table))
        assert ts.row_count == js.row_count
        assert ts.primary_key == js.primary_key
        assert {c: (s.distinct_count, s.min_value, s.max_value)
                for c, s in ts.columns.items()} == \
            {c: (s.distinct_count, s.min_value, s.max_value)
             for c, s in js.columns.items()}
        jsp = jconn.split_manager.splits(JHandle("tpcds", "default", table),
                                         3)
        tsp = tconn.split_manager.splits(TableHandle("tpcds", "default",
                                                     table), 3)
        assert [s.info for s in tsp] == [s.info for s in jsp]


def test_page_source_without_device_wants_the_gpu():
    """No device means the GPU; without one the connector raises instead
    of building CPU batches."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    tconn = TTpcds(sf=SF)
    split = tconn.split_manager.splits(TableHandle("tpcds", "default",
                                                   "store"), 1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconn.page_source(split, ["s_store_sk"])
