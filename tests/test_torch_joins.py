"""Join, semi-join and subquery shapes through presto_tpu's LocalRunner
and presto_tpu_torch's LocalRunner on the CPU (TPC-H SF 0.01 where a
table is read): FULL OUTER joins over VALUES, multi-key and wide keys,
builds skewed past the executor's SKEW_MATCH_LIMIT, NOT IN against NULL
and empty builds, EXISTS and NOT EXISTS with a residual, cross joins,
scalar subqueries, DISTINCT and SELECT without FROM (ON residuals of
outer joins are in test_torch_outer_joins.py). Same names, types and
rows in the same order; doubles within rel 1e-12."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


def _skewed(n, extra=""):
    return ", ".join(f"(1, {i})" for i in range(n)) + extra


QUERIES = {
    "full_basic": """
        SELECT a.x, a.v, b.x, b.w FROM
         (VALUES (1, 'a1'), (2, 'a2'), (4, 'a4')) a(x, v)
         FULL OUTER JOIN (VALUES (2, 'b2'), (3, 'b3'), (4, 'b4')) b(x, w)
         ON a.x = b.x
        ORDER BY coalesce(a.x, b.x), a.v NULLS LAST""",
    "full_null_keys_never_match": """
        SELECT a.v, b.w FROM
         (VALUES (1, 'a1'), (cast(null as integer), 'an')) a(x, v)
         FULL OUTER JOIN
         (VALUES (1, 'b1'), (cast(null as integer), 'bn')) b(x, w)
         ON a.x = b.x
        ORDER BY a.v NULLS LAST, b.w NULLS LAST""",
    "full_many_to_many": """
        SELECT a.v, b.w FROM
         (VALUES (1, 'a1'), (1, 'a2'), (5, 'a5')) a(x, v)
         FULL OUTER JOIN
         (VALUES (1, 'b1'), (1, 'b2'), (7, 'b7')) b(x, w)
         ON a.x = b.x
        ORDER BY a.v NULLS LAST, b.w NULLS LAST""",
    "three_key_join": """
        SELECT a.v, b.w FROM
         (VALUES (9223372036854775806, 2.5, 1, 10),
                 (1, -0.0, 2, 20),
                 (5, 3.25, 3, 30)) a(x, y, z, v)
         JOIN (VALUES (9223372036854775806, 2.5, 1, 'hit1'),
                      (1, 0.0, 2, 'hit2'),
                      (5, 3.5, 3, 'miss')) b(x, y, z, w)
         ON a.x = b.x AND a.y = b.y AND a.z = b.z
        ORDER BY a.v""",
    "wide_key_join": """
        SELECT a.v, b.w FROM
         (VALUES (4294967296123, 8589934592456, 1)) a(x, y, v)
         JOIN (VALUES (4294967296123, 8589934592456, 'hit'),
                      (4294967296123, 8589934592457, 'miss')) b(x, y, w)
         ON a.x = b.x AND a.y = b.y""",
    "skewed_inner": f"""
        SELECT a.x, count(*), sum(b.i) FROM
         (VALUES (1), (1), (2), (3)) a(x)
         JOIN (VALUES {_skewed(300, ", (2, 9000)")}) b(x, i) ON a.x = b.x
        GROUP BY a.x ORDER BY a.x""",
    "skewed_left": f"""
        SELECT a.x, count(b.i) FROM
         (VALUES (1), (5)) a(x)
         LEFT JOIN (VALUES {_skewed(200)}) b(x, i) ON a.x = b.x
        GROUP BY a.x ORDER BY a.x""",
    "not_in_null_build_key": """
        SELECT x FROM (VALUES (1), (2), (cast(null as integer))) a(x)
        WHERE x NOT IN (SELECT y FROM (VALUES (1), (cast(null as integer)))
                        b(y))""",
    "not_in_empty_build": """
        SELECT x FROM (VALUES (1), (2), (cast(null as integer))) a(x)
        WHERE x NOT IN (SELECT n_nationkey FROM nation
                        WHERE n_nationkey < 0)
        ORDER BY x NULLS FIRST""",
    "exists_with_residual": """
        select o_orderpriority, count(*) from orders o
        where exists (select 1 from lineitem l
                      where l.l_orderkey = o.o_orderkey
                        and l.l_commitdate < l.l_receiptdate
                        and l.l_quantity > o.o_totalprice / 10000)
        group by o_orderpriority order by o_orderpriority""",
    "not_exists_with_residual": """
        select count(*), sum(o_totalprice) from orders o
        where not exists (select 1 from lineitem l
                          where l.l_orderkey = o.o_orderkey
                            and l.l_linenumber <> o.o_shippriority + 1
                            and l.l_discount > 0.05)""",
    "cross_join_scalar_subquery": """
        select n_name, t.m from nation,
         (select max(r_regionkey) as m from region) t
        order by n_name""",
    "select_distinct": """
        select distinct n_regionkey, substr(n_name, 1, 1) from nation
        order by 1, 2""",
    "count_distinct": "select count(distinct o_custkey) from orders",
    "select_without_from": "select 1 + 2, 'x', year(date '1998-12-01')",
    "scalar_subquery_no_rows_is_null": """
        select n_name, (select r_name from region where r_regionkey = 99)
        from nation order by n_name limit 3""",
}


#: a NULL in a NOT IN list leaves every other row UNKNOWN: no row passes
EMPTY = {"not_in_null_build_key"}

#: output columns of integer literals (VALUES columns, ``1 + 2``): INTEGER
#: in the port (Presto's LongLiteral typing), BIGINT in the reference
_INT = ("bigint", "integer")
RETYPED = {
    "full_basic": {0: _INT, 2: _INT},
    "three_key_join": {0: _INT},
    "wide_key_join": {0: _INT},
    "skewed_inner": {0: _INT},
    "skewed_left": {0: _INT},
    "not_in_null_build_key": {0: _INT},
    "not_in_empty_build": {0: _INT},
    "select_without_from": {0: _INT},
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_join_shape_matches_reference(runners, name):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(QUERIES[name])
    got = torch_runner.execute(QUERIES[name])
    assert bool(got.rows) != (name in EMPTY), name
    assert_results_match(got, want, 1e-12, RETYPED.get(name))


def test_scalar_subquery_of_two_rows_raises(runners):
    sql = "select n_name from nation where n_regionkey = " \
          "(select r_regionkey from region where r_regionkey < 2)"
    for runner in runners:
        with pytest.raises(ValueError, match="more than one row"):
            runner.execute(sql)


def test_repeated_subplan_runs_once(runners, monkeypatch):
    """Q15's view feeds the main plan and its scalar subquery: it runs
    once and both read the same batches (and the same double sums)."""
    from presto_tpu_torch.exec import local
    from tpch_queries import Q
    sql = {name: s for name, s, _ in Q}["q15"]
    seen = []
    run_agg = local._Executor._AggregationNode

    def counting(self, node):
        seen.append(node)
        return run_agg(self, node)
    monkeypatch.setattr(local._Executor, "_AggregationNode", counting)
    jax_runner, torch_runner = runners
    got = torch_runner.execute(sql)
    assert len(seen) == len(set(seen)) >= 1
    assert_results_match(got, jax_runner.execute(sql), 1e-12)


@pytest.mark.parametrize("sql,props", [
    ("select n_name, count(*) c from nation join region "
     "on n_regionkey = r_regionkey group by n_name order by n_name",
     {"query_max_memory": 1 << 20}),
    ("select o_orderpriority, count(*) c from orders join customer "
     "on o_custkey = c_custkey group by o_orderpriority order by 1",
     {"spill_partitions": 4, "query_max_memory": 60_000}),
], ids=["query_max_memory", "spill_partitions"])
def test_spill_properties_run(runners, sql, props):
    """Sessions that set the spill properties run their joins and return
    the reference's rows under the same properties."""
    jax_runner, torch_runner = runners
    got = torch_runner.execute(sql, properties=props)
    want = jax_runner.execute(sql, properties=props)
    assert got.rows
    assert_results_match(got, want, 1e-12)
    assert torch_runner.session.last_memory_stats.peak_bytes <= \
        props["query_max_memory"]


@pytest.mark.parametrize("sql,props,what", [
    ("explain (type validate) select 1", {}, "TYPE VALIDATE"),
    ("start transaction", {}, "StartTransaction"),
])
def test_unported_surface_raises(sql, props, what):
    """EXPLAIN (TYPE VALIDATE) and START TRANSACTION, which raised until
    the port took them, now run; what the port still does not run raises
    NotImplementedError naming the module it waits for (EXPLAIN (TYPE
    DISTRIBUTED) did until the fragmenter came, the timeseries table
    until the time-series store came: both run now)."""
    runner = TLocalRunner(tpch_sf=0.01, device="cpu")
    runner.session.properties.update(props)
    (first,) = runner.execute(sql).rows[0]
    assert first is True or first.startswith("tx_"), (what, first)
    assert runner.execute(
        "explain (type distributed) select 1").rows[0][0].startswith(
        "Fragment 0 [")
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    (n,), = runner.execute(
        "select count(*) from system.runtime.timeseries").rows
    assert n == len(TIMESERIES.rows())
