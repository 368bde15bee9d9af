"""Plan shapes on the port's mesh of 8 CPU slots against the port's own
single-device run (which the other test_torch_*.py files hold to
presto_tpu): FULL and LEFT joins with ON residuals (unique and expanding
builds, the FULL tail), correlated EXISTS (the mark join), NULL-aware
NOT IN, windows with and without a partition (the gathered finalize),
UNNEST, ROLLUP over empty input (the default grouping rows), grouped
and global approx_percentile, DISTINCT aggregates beside others
(MarkDistinct), DISTINCT, VALUES, set operations, semi joins and top-n,
each under the broadcast joins the optimizer picks at SF 0.01, under
partitioned joins (``broadcast_join_row_limit=1``) and with the fused
exchange forced. Rows compare in order; doubles within rel 1e-9."""
import pytest

from presto_tpu_torch.exec.runner import LocalRunner

from torch_parity import assert_rows_match

SHAPES = [
 "select n_name, r_name from nation full join region on n_regionkey = r_regionkey and r_regionkey < 2 order by 1, 2",
 "select c_custkey, o_orderkey from customer full join orders on c_custkey = o_custkey where c_custkey < 20 or o_orderkey < 100 order by 1, 2",
 "select s_name, n_name from supplier left join nation on s_nationkey = n_nationkey and n_regionkey < 2 order by 1, 2 limit 20",
 "select o_orderkey, l_linenumber from orders left join lineitem on o_orderkey = l_orderkey and l_quantity > 45 where o_orderkey < 200 order by 1, 2",
 "select count(*) from orders o where exists (select * from lineitem l where l.l_orderkey = o.o_orderkey and l.l_quantity > o.o_totalprice / 10000)",
 "select count(*) from orders where o_custkey not in (select case when c_acctbal < 0 then null else c_custkey end from customer)",
 "select n_name, rank() over (order by n_nationkey desc) from nation order by 2",
 "select n_name, row_number() over (partition by n_regionkey order by n_name) from nation order by 1",
 "select x, count(*) from nation cross join unnest(array[n_regionkey, n_nationkey]) as u(x) group by x order by x",
 "select n_regionkey, count(*) from nation where n_nationkey < 0 group by rollup(n_regionkey)",
 "select l_returnflag, approx_percentile(l_quantity, 0.5) from lineitem group by 1 order by 1",
 "select approx_percentile(l_quantity, 0.5), count(distinct l_suppkey), sum(l_quantity) from lineitem",
 "select l_returnflag, count(distinct l_suppkey), sum(l_quantity) from lineitem group by 1 order by 1",
 "select distinct o_orderpriority from orders order by 1",
 "select * from (values (1, 'a'), (2, 'b')) t(x, y) order by 1",
 "select n_regionkey from nation union select r_regionkey from region order by 1",
 "select n_regionkey from nation intersect select r_regionkey from region order by 1",
 "select count(*) from lineitem where l_orderkey in (select o_orderkey from orders where o_orderpriority = '1-URGENT')",
 "select o_orderpriority, count(*) from orders, lineitem where o_orderkey = l_orderkey group by 1 order by 1",
 "select c_name, sum(o_totalprice) from customer join orders on c_custkey = o_custkey group by 1 order by 2 desc, 1 limit 3",
 "select p_brand, count(*) from part, partsupp where p_partkey = ps_partkey group by 1 order by 2 desc, 1 limit 5",
 "select l_orderkey, sum(l_quantity) from lineitem group by 1 order by 2 desc, 1 limit 5",
 "select count(*), sum(x) from (select l_orderkey, count(*) x from lineitem group by 1) t",
 "select o_orderkey from orders order by o_comment limit 5",
]
PLANES = {
    "broadcast": {},
    "partitioned": {"broadcast_join_row_limit": 1},
    "fused": {"broadcast_join_row_limit": 1, "mesh_fused_exchange": True},
}


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "8")


@pytest.fixture(scope="module")
def runner():
    return LocalRunner(tpch_sf=0.01, device="cpu", rows_per_batch=1 << 11)


@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_shape_on_the_mesh(runner, i, plane):
    sql = SHAPES[i]
    want = runner.execute(sql, properties={"mesh_execution": "off"}).rows
    got = runner.execute(sql, properties={
        "mesh_execution": "on", "mesh_devices": 8, **PLANES[plane]})
    assert runner.last_stats.mesh_flight.n_devices == 8
    assert_rows_match(got.rows, want, 1e-9)
