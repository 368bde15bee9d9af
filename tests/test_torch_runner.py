"""The slice end to end: TPC-H Q6, Q1 and Q3 by SQL through
presto_tpu's LocalRunner and presto_tpu_torch's LocalRunner on the CPU.
Integers, dates and strings must be identical; doubles within rel 1e-12
(the two engines sum doubles in different orders)."""
import numpy as np
import pytest

from presto_tpu.connectors.tpch import TpchConnector
from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.connectors.tpch import TpchConnector as TTpch
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match
from tpch_queries import Q

_SQL = {name: sql for name, sql, _ in Q}
SF = 0.01


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=SF), TLocalRunner(tpch_sf=SF, device="cpu")


@pytest.mark.parametrize("name", ["q6", "q1", "q3"])
def test_tpch_query_matches_reference(runners, name):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(_SQL[name])
    got = torch_runner.execute(_SQL[name])
    assert got.rows, name
    assert_results_match(got, want, 1e-12)


@pytest.mark.parametrize("table,cols", [
    ("lineitem", ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
                  "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                  "l_shipdate"]),
    ("lineitem", ["l_suppkey", "l_linenumber", "l_commitdate",
                  "l_receiptdate", "l_shipmode", "l_shipinstruct"]),
    ("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                "o_shippriority", "o_orderpriority"]),
    ("orders", ["o_orderstatus", "o_totalprice", "o_comment"]),
    ("customer", ["c_custkey", "c_mktsegment", "c_nationkey"]),
    ("customer", ["c_name", "c_phone", "c_acctbal", "c_address",
                  "c_comment"]),
    ("part", ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type",
              "p_size", "p_container", "p_retailprice"]),
    ("partsupp", ["ps_partkey", "ps_suppkey", "ps_availqty",
                  "ps_supplycost"]),
    ("supplier", ["s_suppkey", "s_name", "s_address", "s_nationkey",
                  "s_phone", "s_acctbal", "s_comment"]),
    ("nation", ["n_nationkey", "n_name", "n_regionkey"]),
    ("region", ["r_regionkey", "r_name"]),
])
def test_generators_make_identical_arrays(table, cols):
    jconn, tconn = TpchConnector(sf=SF), TTpch(sf=SF)
    jsplits = jconn.split_manager.splits(
        _handle(table), 2)
    tsplits = tconn.split_manager.splits(_handle(table), 2)
    assert [s.info for s in jsplits] == [s.info for s in tsplits]
    for js, ts in zip(jsplits, tsplits):
        jb = list(jconn.page_source(js, cols).batches())
        tb = list(tconn.page_source(ts, cols, device="cpu").batches())
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert np.array_equal(np.asarray(a.row_mask), b.row_mask.numpy())
            for ca, cb in zip(a.columns, b.columns):
                assert ca.dictionary == cb.dictionary
                assert np.array_equal(np.asarray(ca.data), cb.data.numpy())
                assert np.array_equal(np.asarray(ca.validity),
                                      cb.validity.numpy())


def _handle(table):
    from presto_tpu_torch.connectors.spi import TableHandle
    return TableHandle("tpch", "default", table)


def test_page_source_without_device_wants_the_gpu():
    """No device means the GPU; without one the connector raises instead
    of building CPU batches."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    tconn = TTpch(sf=SF)
    split = tconn.split_manager.splits(_handle("nation"), 1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconn.page_source(split, ["n_nationkey"])
