"""ROLLUP, CUBE and GROUPING SETS (GroupId + one aggregation over
$group_id, with default rows over empty input), GROUPING() and the set
operations (UNION [ALL], and INTERSECT / EXCEPT as the planner lowers
them) by SQL through presto_tpu's LocalRunner and presto_tpu_torch's on
the CPU at SF 0.01: the same names, types and rows in the same order;
doubles within rel 1e-12. The set-operation texts are those of
tests/test_set_ops.py."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match

SF = 0.01

GROUPING_SQL = {
    "rollup": """
        select d_year, d_qoy, count(*) n, sum(d_dom) s
        from date_dim where d_year between 1999 and 2001
        group by rollup (d_year, d_qoy)
        order by d_year nulls last, d_qoy nulls last""",
    "cube": """
        select d_year, d_qoy, count(*) n
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk and d_year between 1999 and 2000
        group by cube (d_year, d_qoy)
        order by d_year nulls last, d_qoy nulls last""",
    "grouping_sets": """
        select s_state, s_store_name, count(*) n
        from store group by grouping sets ((s_state), (s_store_name), ())
        order by s_state nulls last, s_store_name nulls last, n""",
    "only_empty_sets": """
        select count(*) n, max(s_store_sk) m
        from store group by grouping sets ((), ())""",
    "multi_argument_grouping": """
        select d_year, d_qoy, grouping(d_year, d_qoy) g, count(*) n
        from date_dim where d_year between 2000 and 2001
        group by cube (d_year, d_qoy)
        order by g, d_year nulls last, d_qoy nulls last""",
    "having_on_grouping": """
        select d_year, grouping(d_qoy) gq, avg(d_dom) a
        from date_dim where d_year between 1998 and 2002
        group by rollup (d_year, d_qoy)
        having grouping(d_qoy) = 1
        order by d_year nulls last""",
    "rollup_over_empty_input": """
        select d_year, count(*) n, sum(d_date_sk) s
        from date_dim where d_date_sk < 0 group by rollup (d_year)""",
    "rollup_over_fact_keys": """
        select ss_store_sk, ss_quantity, count(*) c, sum(ss_net_paid) p
        from store_sales where ss_quantity < 20
        group by rollup (ss_store_sk, ss_quantity)
        order by ss_store_sk nulls last, ss_quantity nulls last""",
}

SET_OP_SQL = {
    "intersect": "SELECT * FROM (VALUES 1,2,3,3) INTERSECT "
                 "SELECT * FROM (VALUES 2,3,4) ORDER BY 1",
    "except": "SELECT * FROM (VALUES 1,2,3,3) EXCEPT "
              "SELECT * FROM (VALUES 2,4) ORDER BY 1",
    "except_multi_column": "SELECT * FROM (VALUES (1,'a'),(2,'b')) EXCEPT "
                           "SELECT * FROM (VALUES (2,'b'),(3,'c'))",
    "intersect_null_equality":
        "SELECT * FROM (VALUES 1, cast(null as integer)) INTERSECT "
        "SELECT * FROM (VALUES cast(null as integer), 2)",
    "intersect_binds_tighter_than_union":
        "SELECT * FROM (VALUES 1,2) UNION SELECT * FROM (VALUES 3,5) "
        "INTERSECT SELECT * FROM (VALUES 3) ORDER BY 1",
    "except_left_assoc_with_union":
        "SELECT * FROM (VALUES 1,2) UNION SELECT * FROM (VALUES 3) "
        "EXCEPT SELECT * FROM (VALUES 2) ORDER BY 1",
    "intersect_over_tpch": "SELECT c_nationkey FROM customer INTERSECT "
                           "SELECT s_nationkey FROM supplier ORDER BY 1",
    "union_all_across_vocabularies":
        "SELECT n_name, n_regionkey FROM nation WHERE n_regionkey < 2 "
        "UNION ALL SELECT r_name, r_regionkey FROM region ORDER BY 1, 2",
    "union_distinct": "SELECT o_orderstatus FROM orders UNION "
                      "SELECT l_linestatus FROM lineitem ORDER BY 1",
}


@pytest.fixture(scope="module")
def ds_runners():
    return (LocalRunner(tpch_sf=SF, catalog="tpcds"),
            TLocalRunner(tpch_sf=SF, catalog="tpcds", device="cpu"))


@pytest.fixture(scope="module")
def h_runners():
    return LocalRunner(tpch_sf=SF), TLocalRunner(tpch_sf=SF, device="cpu")


@pytest.mark.parametrize("name", list(GROUPING_SQL))
def test_grouping_query_matches_reference(ds_runners, name):
    jax_runner, torch_runner = ds_runners
    want = jax_runner.execute(GROUPING_SQL[name])
    got = torch_runner.execute(GROUPING_SQL[name])
    assert got.rows
    assert_results_match(got, want, 1e-12)


def test_rollup_over_empty_input_is_one_default_row(ds_runners):
    rows = ds_runners[1].execute(GROUPING_SQL["rollup_over_empty_input"]).rows
    assert rows == [(None, 0, None)]


def test_rollup_dense_and_sort_paths_agree(ds_runners):
    """$group_id joins the stats-bounded dense grouping with its [0, 3)
    bound; with dense grouping off the sort path gives the same rows."""
    runner = ds_runners[1]
    sql = GROUPING_SQL["rollup_over_fact_keys"]
    plan = runner.plan(sql)
    stack, bounds = [plan.root], []
    while stack:
        node = stack.pop()
        if getattr(node, "default_gids", None):
            bounds.append(node.key_bounds)
        stack.extend(node.children)
    assert bounds and bounds[0][-1] == (0, 2)
    dense = runner.execute(sql).rows
    runner.session.properties["dense_grouping"] = False
    try:
        plain = runner.execute(sql).rows
    finally:
        del runner.session.properties["dense_grouping"]
    assert dense == plain


#: set operations over VALUES of integer literals: the column is INTEGER
#: in the port (Presto's LongLiteral typing), BIGINT in the reference
SET_OP_RETYPED = {name: {0: ("bigint", "integer")} for name in (
    "intersect", "except", "except_multi_column", "intersect_null_equality",
    "intersect_binds_tighter_than_union", "except_left_assoc_with_union")}


@pytest.mark.parametrize("name", list(SET_OP_SQL))
def test_set_operation_matches_reference(h_runners, name):
    jax_runner, torch_runner = h_runners
    want = jax_runner.execute(SET_OP_SQL[name])
    got = torch_runner.execute(SET_OP_SQL[name])
    assert got.rows
    assert_results_match(got, want, 1e-12, SET_OP_RETYPED.get(name))
