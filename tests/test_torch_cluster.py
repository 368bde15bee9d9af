"""presto_tpu_torch's cluster (exec/cluster.py, server/worker.py)
against presto_tpu's, each a ClusterRunner over two in-process workers
(the port's on the CPU) at SF 0.01: the queries of the reference's
tests/test_cluster.py (its CLUSTER_TPCH list, its BASICS, partitioned
joins under broadcast_join_row_limit=0) give the reference's cluster
rows, integers exactly and doubles within rel 1e-9 (partial-aggregation
pages merge in arrival order); plus the failure detector, the drain, the
no-worker and request-retry paths, the partitioned producer
(``pages.serialize_partitioned``) byte for byte, system.runtime.nodes /
tasks, a traced query's task spans, and the memory manager's cases of
tests/test_cluster_memory.py. The other TPC-H queries are in
test_torch_cluster_rest.py."""
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_cluster import Clusters

sys.path.insert(0, "tests")
from tpch_queries import Q as TPCH  # noqa: E402

from presto_tpu_torch.exec.cluster import (  # noqa: E402
    ClusterMemoryManager, ClusterRunner, HeartbeatFailureDetector,
    QueryFailedError,
)
from presto_tpu_torch.server.worker import WorkerServer  # noqa: E402

SF = 0.01
SQL = {name: sql for name, sql, *_ in TPCH}
CLUSTER_TPCH = ["q1", "q3", "q4", "q5", "q6", "q12", "q13", "q14", "q19"]


@pytest.fixture(scope="module")
def clusters():
    c = Clusters(SF)
    yield c
    c.stop()


@pytest.mark.parametrize("name", CLUSTER_TPCH)
def test_tpch_cluster(clusters, name):
    clusters.check(SQL[name])


BASICS = [
    "select count(*) from lineitem",
    "select o_orderstatus, count(*), sum(o_totalprice) from orders "
    "group by 1 order by 1",
    "select distinct l_shipmode from lineitem order by 1",
    "select o_orderkey, o_totalprice from orders "
    "order by o_totalprice desc limit 5",
    "select n_name from nation union select r_name from region "
    "order by 1 limit 8",
    "select o_custkey, row_number() over (partition by o_custkey "
    "order by o_orderkey) rn from orders order by 1, 2 limit 20",
    "select max(o_totalprice) from orders where o_totalprice < "
    "(select avg(o_totalprice) from orders)",
    "select o_orderpriority, count(*) from orders where exists "
    "(select 1 from lineitem where l_orderkey = o_orderkey) "
    "group by 1 order by 1",
    "select stddev(l_quantity), var_pop(l_extendedprice) from lineitem",
    "select o_orderstatus, count(distinct o_custkey) c, count(*) n "
    "from orders group by 1 order by 1",
]


@pytest.mark.parametrize("sql", BASICS, ids=range(len(BASICS)))
def test_basics_cluster(clusters, sql):
    clusters.check(sql)


@pytest.mark.parametrize("sql", [
    "select c_mktsegment, count(*) c, sum(o_totalprice) s from customer, "
    "orders where c_custkey = o_custkey group by 1 order by 1",
    SQL["q3"]], ids=["customer_orders", "q3"])
def test_partitioned_join_cluster(clusters, sql):
    """Forced partitioned joins (no broadcast): both sides hash-exchange
    by the join key into a fixed stage, over HTTP."""
    from presto_tpu_torch.obs.metrics import REGISTRY
    sent0 = REGISTRY.counter("exchange_sent_pages_total").value
    clusters.check(sql, properties={"broadcast_join_row_limit": 0})
    assert REGISTRY.counter("exchange_sent_pages_total").value > sent0


def test_integer_scalar_subquery_runs(clusters):
    """An integer scalar subquery's value ships to the workers (the
    reference's codec raises ``cannot encode int64`` here); the rows
    equal the port's single-device run."""
    sql = ("select r_name from region where r_regionkey < "
           "(select max(n_regionkey) from nation) order by 1")
    with pytest.raises(TypeError, match="cannot encode int64"):
        clusters.ref.execute(sql)
    assert clusters.port.execute(sql).rows == \
        clusters.port.local.execute(sql).rows


#: a query with a scalar subquery, and the kinds of subplan it shares
#: with the main plan that run once on the workers: only the views
#: aggregate (Q11 and the count share scans and joins, Q22 nothing)
SHARED = [
    ("q15", SQL["q15"], ["AggregationNode"]),
    ("q11", SQL["q11"], []),
    ("q22", SQL["q22"], []),
    ("scan", "select count(*) from lineitem where l_quantity > "
     "(select avg(l_quantity) from lineitem)", []),
    ("nested", "with t as (select l_suppkey k, sum(l_extendedprice) s "
     "from lineitem group by 1) select count(*) from t where s >= "
     "(select max(s) from t where s < (select max(s) from t))",
     ["ProjectNode"]),
]


@pytest.mark.parametrize("sql,kinds", [c[1:] for c in SHARED],
                         ids=[c[0] for c in SHARED])
def test_init_shared_subplans(clusters, sql, kinds):
    from presto_tpu_torch.exec.cluster import _init_shared
    from presto_tpu_torch.planner.optimizer import optimize
    from presto_tpu_torch.planner.planner import plan_query
    from presto_tpu_torch.serving.plancache import parse_cached
    session = clusters.port.session
    plan = optimize(plan_query(parse_cached(sql), session), session)
    assert [type(n).__name__ for n in _init_shared(plan)] == kinds


def test_shared_subplan_runs_once():
    """Q15's view runs once on the workers and both the main plan and
    its ``max`` read its rows: at SF 0.02 in 4096-row batches, run
    twice, its double sums for the top supplier differ in the last bit
    and the equality matched no row. The rows equal the single-device
    run's."""
    from presto_tpu_torch.obs.metrics import REGISTRY
    workers = [WorkerServer(tpch_sf=0.02, device="cpu") for _ in range(2)]
    for w in workers:
        w.start()
    try:
        runner = ClusterRunner(Clusters.urls(workers), tpch_sf=0.02,
                               heartbeat=False, device="cpu",
                               rows_per_batch=4096)
        q0 = REGISTRY.counter("cluster_queries_total").value
        got = runner.execute(SQL["q15"])
        want = runner.local.execute(SQL["q15"])
        assert len(want.rows) == 1
        torch_parity.assert_results_match(got, want, 1e-9)
        assert REGISTRY.counter("cluster_queries_total").value == q0 + 2
        # the same view under the same sums as a CTE read twice
        sql = ("with t as (select l_suppkey k, sum(l_extendedprice * "
               "(1 - l_discount)) s from lineitem group by 1) "
               "select k from t where s = (select max(s) from t)")
        assert runner.execute(sql).rows == runner.local.execute(sql).rows
    finally:
        for w in workers:
            w.stop()


def test_serialize_partitioned_equals_reference():
    """The partitioned producer: a seeded batch with NULLs, strings and
    doubles splits into the same partitions, page bytes equal."""
    from presto_tpu import types as JT
    from presto_tpu.batch import Batch as JBatch, Schema as JSchema
    from presto_tpu.exec.pages import serialize_partitioned as jser
    from presto_tpu_torch.exec.pages import serialize_partitioned
    rng = np.random.default_rng(5)
    n = 1000
    arrays = [rng.integers(0, 50, n).astype(np.int64),
              rng.integers(0, 4, n).astype(np.int32), rng.normal(size=n)]
    valid = [rng.random(n) > 0.1 for _ in arrays]
    vocab = ("AIR", "MAIL", "RAIL", "SHIP")
    jschema = JSchema([("k", JT.BIGINT), ("s", JT.VARCHAR),
                       ("d", JT.DOUBLE)])
    jb = JBatch.from_arrays(jschema, arrays, valid, [None, vocab, None],
                            num_rows=n)
    tb = torch_parity.to_port(jb)
    for keys in ([0], [1], [0, 1]):
        for parts in (1, 2, 3):
            got = serialize_partitioned(tb, keys, parts)
            want = jser(jb, keys, parts)
            assert got == want, (keys, parts)
            assert any(p is not None for p in got)


def test_nodes_and_tasks_tables_show_the_workers(clusters):
    runner = clusters.port
    runner.execute("select count(*) from orders")
    runner.poll_nodes()
    nodes = {r[0]: r[1] for r in runner.local.execute(
        "select node_id, state from system.runtime.nodes").rows}
    for w in clusters.workers:
        assert nodes.get(w.node_id) == "ACTIVE", nodes
    tasks = runner.local.execute(
        "select task_id, state from system.runtime.tasks").rows
    assert any(tid.startswith("cq_") and state == "FINISHED"
               for tid, state in tasks)


def test_traced_query_imports_every_task_span(clusters):
    """With the tracer on, each task's span joins the query's trace
    under its stage span (the coordinator's wire-carried context), and
    the coordinator holds the spans of every task of both workers."""
    from presto_tpu_torch.obs.trace import TRACER
    TRACER.clear()
    TRACER.enable()
    try:
        clusters.port.execute(SQL["q3"],
                              properties={"broadcast_join_row_limit": 0})
    finally:
        TRACER.enable(False)
    spans = TRACER.export()
    query = [s for s in spans if s["name"] == "query"
             and s["attrs"].get("mode") == "cluster"][-1]
    trace = [s for s in spans if s["traceId"] == query["traceId"]]
    stages = {s["spanId"] for s in trace if s["name"] == "stage"}
    tasks = [s for s in trace if s["name"] == "task"]
    assert stages and tasks
    assert all(t["parentId"] in stages for t in tasks)
    nodes = {t["attrs"]["node_id"] for t in tasks}
    assert nodes == {w.node_id for w in clusters.workers}
    TRACER.clear()


def test_failure_detector_excludes_dead_worker(clusters):
    live = f"http://127.0.0.1:{clusters.workers[0].port}"
    dead_url = "http://127.0.0.1:1"   # nothing listens there
    det = HeartbeatFailureDetector([live, dead_url], max_consecutive=1)
    assert det.ping(live)
    assert not det.ping(dead_url)
    det.failures[dead_url] = 1
    assert det.active() == [live]


def test_heartbeat_thread_federates_nodes():
    """A runner with its heartbeat on learns its workers' node ids and
    states from the background pings."""
    w = WorkerServer(tpch_sf=0.001, device="cpu")
    w.start()
    runner = ClusterRunner([f"http://127.0.0.1:{w.port}"], tpch_sf=0.001,
                           heartbeat=False, device="cpu")
    runner.detector.interval_s = 0.05
    runner.detector.start()
    try:
        deadline = time.time() + 10
        while not runner._node_ids and time.time() < deadline:
            time.sleep(0.05)
        assert list(runner._node_ids.values()) == [w.node_id]
        assert runner.execute("select count(*) from region").rows == [(5,)]
    finally:
        runner.detector.stop()
        w.stop()


def test_no_active_workers_fails_fast():
    runner = ClusterRunner(["http://127.0.0.1:1"], tpch_sf=SF,
                           heartbeat=False, device="cpu")
    runner.detector.failures["http://127.0.0.1:1"] = 99
    with pytest.raises(QueryFailedError, match="no active workers"):
        runner.execute("select count(*) from nation")


def test_graceful_shutdown_drains():
    w = WorkerServer(tpch_sf=SF, device="cpu")
    w.start()
    url = f"http://127.0.0.1:{w.port}"
    runner = ClusterRunner([url], tpch_sf=SF, heartbeat=False,
                           device="cpu")
    assert runner.execute("select count(*) from nation").rows == [(25,)]
    req = urllib.request.Request(f"{url}/v1/info/state", method="PUT",
                                 data=json.dumps("SHUTTING_DOWN").encode())
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert json.loads(resp.read())["state"] == "SHUTTING_DOWN"
    with pytest.raises(Exception):
        runner.execute("select count(*) from region")
    # the drain ends in stop() within its grace; a request that merely
    # timed out under load is no proof that it did
    assert w.stopped.wait(20), "worker did not stop after drain"
    with pytest.raises(Exception):
        urllib.request.urlopen(f"{url}/v1/info", timeout=2)


def test_request_retries_transient_failures(monkeypatch):
    """One transient socket error does not fail the query: _request
    retries with backoff (reference server/remotetask/
    RequestErrorTracker.java)."""
    import urllib.error
    calls = {"n": 0}

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return b'{"ok": true}'

    def flaky_open(req, timeout=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise urllib.error.URLError("connection refused")
        return _Resp()

    runner = ClusterRunner.__new__(ClusterRunner)  # no workers needed
    monkeypatch.setattr("urllib.request.urlopen", flaky_open)
    monkeypatch.setattr(ClusterRunner, "REQUEST_BACKOFF_S", 0.001)
    out = runner._request("http://127.0.0.1:1/v1/task/x")
    assert out == {"ok": True} and calls["n"] == 3


def test_request_gives_up_after_budget(monkeypatch):
    import urllib.error

    def always_down(req, timeout=None):
        raise urllib.error.URLError("connection refused")

    runner = ClusterRunner.__new__(ClusterRunner)
    monkeypatch.setattr("urllib.request.urlopen", always_down)
    monkeypatch.setattr(ClusterRunner, "REQUEST_BACKOFF_S", 0.001)
    with pytest.raises(QueryFailedError, match="after 5 attempts"):
        runner._request("http://127.0.0.1:1/v1/task/x")


# -- tests/test_cluster_memory.py ---------------------------------------------

def test_heartbeat_reports_query_memory(clusters):
    runner = clusters.port
    seen = {}
    stop = threading.Event()

    def snoop():
        while not stop.is_set():
            for url in runner.worker_urls:
                try:
                    info = runner._request(f"{url}/v1/info")
                except Exception:
                    continue
                for q, b in info.get("queryMemory", {}).items():
                    seen[q] = max(seen.get(q, 0), b)
            time.sleep(0.005)

    t = threading.Thread(target=snoop, daemon=True)
    t.start()
    try:
        for _ in range(10):
            runner.execute(
                "select l_orderkey, count(*) c from lineitem "
                "group by 1 order by c desc limit 5",
                properties={"scan_cache": False})
            time.sleep(0.05)
            if max(list(seen.values()) or [0]) > 0:
                break
    finally:
        stop.set()
        t.join(timeout=5)
    assert seen, "no queryMemory payload observed during execution"
    assert max(seen.values()) > 0


def test_kill_biggest_query_under_pressure(clusters):
    """A cluster limit below the query's reservation kills it with the
    reference's error."""
    runner = clusters.port
    mm = ClusterMemoryManager(runner, limit_bytes=1, interval_s=0.02)
    runner.memory_manager = mm
    mm.start()
    try:
        with pytest.raises(QueryFailedError,
                           match="exceeded cluster memory limit"):
            for _ in range(20):
                runner.execute(
                    "select l_partkey, count(*), sum(l_extendedprice) "
                    "from lineitem group by 1",
                    properties={"scan_cache": False})
    finally:
        mm.stop()
        runner.memory_manager = None
    assert mm.killed, "memory manager never killed a query"


def test_enforce_picks_largest(clusters):
    mm = ClusterMemoryManager(clusters.port, limit_bytes=100)
    mm.enforce({"cq_1": 60, "cq_2": 80})
    assert list(mm.killed) == ["cq_2"]
    mm.enforce({"cq_1": 60})
    assert list(mm.killed) == ["cq_2"]
