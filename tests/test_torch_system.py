"""The system catalog, query events, the metrics registry and the query
history of presto_tpu_torch against presto_tpu (the cases of
tests/test_system.py and the system-table, event and metrics cases of
tests/test_obs.py), at TPC-H SF 0.01 on the CPU."""
import time

import pytest

from presto_tpu.events import EventListenerManager as JEvents
from presto_tpu.events import SplitCompletedEvent as JSplit
from presto_tpu.events import completed_event as j_completed
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.obs.metrics import MetricsRegistry as JRegistry
from presto_tpu.obs.metrics import attach_event_listeners as j_attach
from presto_tpu_torch.events import (
    EventListenerManager, SplitCompletedEvent, completed_event,
)
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.history import HISTORY
from presto_tpu_torch.obs.metrics import (
    NODES, REGISTRY, TASKS, MetricsRegistry, attach_event_listeners,
)
from presto_tpu_torch.obs.profiler import KERNELS

SF = 0.01


@pytest.fixture(scope="module")
def pair():
    return JRunner(tpch_sf=SF), LocalRunner(tpch_sf=SF, device="cpu")


@pytest.fixture(scope="module")
def runner(pair):
    return pair[1]


def _rows(runner, sql, **kw):
    return [tuple(r) for r in runner.execute(sql, **kw).rows]


# -- tests/test_system.py -----------------------------------------------------

def test_catalogs(pair):
    sql = ("select catalog_name from system.default.catalogs "
           "order by catalog_name")
    got = _rows(pair[1], sql)
    assert got == _rows(pair[0], sql)
    assert {"tpch", "tpcds", "memory", "system"} <= {r[0] for r in got}


@pytest.mark.parametrize("sql", [
    "select table_name from system.default.tables "
    "where table_catalog = 'tpch' order by table_name",
    "select column_name, data_type from system.default.columns "
    "where table_catalog = 'tpch' and table_name = 'nation' "
    "order by ordinal",
    "select c.table_name, count(*) n from system.default.columns c "
    "where c.table_catalog = 'tpch' group by c.table_name "
    "order by c.table_name",
    "select table_name from system.runtime.tables "
    "where table_catalog = 'system' order by table_name",
])
def test_metadata_tables_equal_reference(pair, sql):
    got = _rows(pair[1], sql)
    assert got and got == _rows(pair[0], sql)


def test_tables_and_columns(runner):
    assert ("lineitem",) in _rows(
        runner, "select table_name from system.default.tables "
                "where table_catalog = 'tpch'")
    rows = _rows(runner, "select column_name, data_type from "
                         "system.default.columns where table_catalog = "
                         "'tpch' and table_name = 'nation' order by ordinal")
    assert rows[0] == ("n_nationkey", "bigint")
    by_table = dict(_rows(runner, """
        select c.table_name, count(*) n from system.default.columns c
        where c.table_catalog = 'tpch'
        group by c.table_name order by c.table_name"""))
    assert by_table["nation"] == 4 and by_table["lineitem"] == 16


def test_query_log(runner):
    runner.execute("select 42")
    states = {r[2]: r[1] for r in _rows(
        runner, "select query_id, state, query from system.default.queries")}
    assert states.get("select 42") == "FINISHED"
    assert "RUNNING" in states.values()     # the in-flight query


def test_query_log_failures(pair):
    for r in pair:
        with pytest.raises(Exception):
            r.execute("select nope from nation")
    sql = ("select state from system.default.queries "
           "where query = 'select nope from nation'")
    assert _rows(pair[1], sql) == _rows(pair[0], sql) == [("FAILED",)]


# -- system.runtime tables of tests/test_obs.py ------------------------------

def test_system_runtime_queries_group_by_state(runner):
    runner.execute("select 1")
    finished = sum(e.state == "FINISHED" for e in runner.query_log)
    states = dict(_rows(runner, "select state, count(*) from "
                                "system.runtime.queries group by state"))
    assert states["FINISHED"] == finished >= 1
    assert states["RUNNING"] == 1            # the in-flight query itself


def test_system_runtime_queries_user_and_error(runner):
    runner.execute("select 2", user="alice")
    with pytest.raises(Exception):
        runner.execute("select nope from nation", user="bob")
    by_query = {r[0]: (r[1], r[2]) for r in _rows(
        runner, "select query, user, error from system.runtime.queries")}
    assert by_query["select 2"][0] == "alice"
    assert by_query["select nope from nation"][0] == "bob"
    assert by_query["select nope from nation"][1]


def test_system_runtime_metrics_table(runner):
    runner.execute("select count(*) from nation")
    rows = _rows(runner, "select name, kind, value from "
                         "system.runtime.metrics "
                         "where name = 'queries_started_total'")
    assert len(rows) == 1
    assert rows[0][1] == "counter" and rows[0][2] >= 1


def test_system_table_count_star_matches_count_col(runner):
    """count(*) prunes every column of a system table; the batch must
    still carry the row count."""
    runner.execute("select count(*) from nation")
    star = _rows(runner, "select count(*) from system.runtime.metrics")
    col = _rows(runner, "select count(name) from system.runtime.metrics")
    assert star == col and star[0][0] > 0


@pytest.mark.parametrize("table,module", [
    ("mesh_rounds", "obs/flight.py"), ("timeseries", "obs/timeseries.py"),
    ("slo", "obs/slo.py"), ("alerts", "obs/slo.py"),
    ("resource_groups", "serving/groups.py")])
def test_waiting_tables_name_their_module(runner, table, module):
    """Each of these tables waited for the module named beside it, and
    now serves that module's feed: the flight log, the time-series
    store's derived series, the SLO objectives and alert transitions,
    and the resource-group snapshot."""
    from presto_tpu_torch.obs.flight import FLIGHTS
    from presto_tpu_torch.obs.slo import SLO
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    from presto_tpu_torch.serving.groups import group_snapshot
    feed = {"mesh_rounds": FLIGHTS.rows, "timeseries": TIMESERIES.rows,
            "slo": SLO.snapshot_rows, "alerts": SLO.alert_rows,
            "resource_groups": group_snapshot}[table]
    (n,), = _rows(runner, f"select count(*) from system.runtime.{table}")
    assert n == len(feed())


def test_tasks_and_nodes_outside_a_cluster(runner):
    TASKS.reset()
    NODES.reset()
    assert _rows(runner, "select * from system.runtime.tasks") == []
    nodes = _rows(runner, "select node_id, state, coordinator, uri from "
                          "system.runtime.nodes")
    assert nodes == [("cpu", "active", True, "cpu")]
    NODES.update("w1", state="active", uri="http://w1", hbm_in_use_bytes=7)
    TASKS.update("q_1.0.0", query_id="q_1", state="FINISHED", node_id="w1")
    try:
        assert _rows(runner, "select node_id, uri, hbm_in_use_bytes from "
                             "system.runtime.nodes") == [("w1", "http://w1",
                                                          7)]
        assert _rows(runner, "select task_id, query_id, state from "
                             "system.runtime.tasks") == [
            ("q_1.0.0", "q_1", "FINISHED")]
    finally:
        TASKS.reset()
        NODES.reset()


def test_completed_queries_and_operator_stats(runner):
    """A profiled query leaves one history record whose operator rows
    carry device seconds (the host clock on the CPU)."""
    runner.execute("select l_returnflag, count(*) from lineitem "
                   "group by l_returnflag", properties={"profile": True})
    qid = runner.query_log[-1].query_id
    rec = _rows(runner, "select state, rows, mode, plan_summary from "
                        "system.runtime.completed_queries "
                        f"where query_id = '{qid}'")
    # ids are unique in the process: another runner's first query is
    # not this one
    other = LocalRunner(tpch_sf=0.001, device="cpu")
    other.execute("select 1")
    assert other.query_log[-1].query_id != qid
    assert rec == [("FINISHED", 3, "local", rec[0][3])]
    assert "Aggregation" in rec[0][3] and "TableScan" in rec[0][3]
    ops = _rows(runner, "select operator, batches, device_time_s, flops "
                        "from system.runtime.operator_stats "
                        f"where query_id = '{qid}'")
    assert {o[0] for o in ops} >= {"Aggregation", "TableScan"}
    assert sum(o[2] for o in ops) > 0 and all(o[3] == 0 for o in ops)
    assert qid in {r["query_id"] for r in HISTORY.snapshot()}


def test_executables_lists_the_kernels(runner):
    runner.execute("select l_orderkey, count(*) from lineitem "
                   "group by l_orderkey", properties={"dense_grouping": False})
    rows = {r[0]: r for r in _rows(
        runner, "select name, static_key, invocations, flops, temp_bytes "
                "from system.runtime.executables")}
    assert set(rows) == {"segment_sum_sorted_i64", "direct_probe"}
    assert rows["segment_sum_sorted_i64"][1] == \
        "presto_tpu_torch/csrc/scan.cu"
    # on the CPU the plain versions run: no launch is counted
    assert rows["segment_sum_sorted_i64"][2] == \
        [k for k in KERNELS.snapshot()
         if k["name"] == "segment_sum_sorted_i64"][0]["launches"]
    assert rows["direct_probe"][3] is None and rows["direct_probe"][4] is None


# -- metrics registry and events ---------------------------------------------

def test_registry_counter_gauge_histogram():
    snaps = []
    for reg in (MetricsRegistry(), JRegistry()):
        reg.counter("c_total").inc()
        reg.counter("c_total").inc(2)
        reg.gauge("g").max_update(5)
        reg.gauge("g").max_update(3)          # the high-water mark stays
        reg.histogram("h").observe(1.0)
        reg.histogram("h").observe(3.0)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    got = {r["name"]: r["value"] for r in snaps[0]}
    assert got["c_total"] == 3 and got["g"] == 5
    assert got["h.count"] == 2 and got["h.sum"] == 4.0
    assert got["h.min"] == 1.0 and got["h.max"] == 3.0


def test_event_listener_sink_equals_reference():
    out = []
    for events, split, done, attach, reg in (
            (EventListenerManager(), SplitCompletedEvent, completed_event,
             attach_event_listeners, MetricsRegistry()),
            (JEvents(), JSplit, j_completed, j_attach, JRegistry())):
        attach(events, reg)
        events.query_completed(done("q1", "select 1", "u", "FINISHED",
                                    time.perf_counter()))
        events.split_completed(split("q1", "t", 0, 1.5, 4))
        rows = {r["name"]: r["value"] for r in reg.snapshot()}
        assert rows["queries_finished_total"] == 1
        assert rows["splits_completed_total"] == 1
        assert rows["split_batches_total"] == 4
        out.append(sorted(rows))
    assert out[0] == out[1]


def test_metrics_after_query(runner):
    """The reference's case without its scheduler_quanta_total check: the
    fair device scheduler (exec/taskexec.py) is not ported."""
    before = {r["name"]: r["value"] for r in REGISTRY.snapshot()}
    runner.execute("select l_returnflag, sum(l_quantity) from lineitem "
                   "group by l_returnflag")
    after = {r["name"]: r["value"] for r in REGISTRY.snapshot()}
    for name in ("queries_started_total", "queries_finished_total",
                 "operator_batches_total.tablescan",
                 "splits_completed_total", "query_seconds.count"):
        assert after[name] > before.get(name, 0), name


def test_query_completed_events(pair):
    seen = {}
    for name, r in zip(("jax", "torch"), pair):
        got = seen[name] = []
        r.events.register(got.append)
        r.execute("select count(*) from region", user="jane")
        with pytest.raises(Exception):
            r.execute("select nope from region")
    for got in seen.values():
        ok, bad = got
        assert ok.state == "FINISHED" and ok.user == "jane"
        assert ok.elapsed_ms > 0 and "region" in ok.query
        assert bad.state == "FAILED" and bad.error
    assert seen["torch"][1].error == seen["jax"][1].error
    assert set(seen["torch"][0].history) == set(seen["jax"][0].history)


def test_broken_listener_does_not_break_queries():
    r = LocalRunner(tpch_sf=0.001, device="cpu")
    r.events.register(lambda e: 1 / 0)
    r.events.register_split_listener(lambda e: 1 / 0)
    assert r.execute("select 1").rows == [(1,)]
