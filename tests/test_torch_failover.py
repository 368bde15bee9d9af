"""The port's fault-tolerant cluster execution (presto_tpu_torch/
exec/cluster.py retry layer, server/worker.py buffer and exchange
failure semantics) through the cluster-bound cases of presto_tpu's
tests/test_failover.py, on two in-process CPU workers: duration and
retry-policy parsing, output-buffer retry semantics, exchange failure
attribution, drain-aware scheduling, query-deadline abort propagation
(DELETE /v1/query frees the task registry and leaves a FAILED history
record) and cluster EXPLAIN ANALYZE's fault-tolerance section, whose
text is held to the reference's. (The failpoint-harness cases and the
scan cache's insert-on-abort case are in test_torch_failpoints.py; the
end-to-end recovery scenarios in test_torch_chaos.py.)"""
import json
import threading
import time
import types as _pytypes
import urllib.error
import urllib.request

import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

from presto_tpu_torch.exec.cluster import (
    ClusterRunner, QueryFailedError, _retry_policy, parse_duration_s,
)
from presto_tpu_torch.exec.failpoints import FAILPOINTS
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.server.worker import (
    ExchangeClient, ExchangeFailedError, OutputBuffer, WorkerServer,
)

SF = 0.01


@pytest.fixture(autouse=True)
def clean_failpoints():
    """The registry is process-wide: no rule may leak across tests."""
    FAILPOINTS.clear()
    yield
    FAILPOINTS.clear()


@pytest.fixture(scope="module")
def cluster():
    workers = [WorkerServer(tpch_sf=SF, device="cpu") for _ in range(2)]
    for w in workers:
        w.start()
    urls = [f"http://127.0.0.1:{w.port}" for w in workers]
    runner = ClusterRunner(urls, tpch_sf=SF, heartbeat=False,
                           device="cpu")
    yield runner, workers
    for w in workers:
        try:
            w.stop()
        except Exception:
            pass


def _counter(name: str) -> float:
    return REGISTRY.counter(name).value


# -- session property parsing ------------------------------------------------

def test_parse_duration():
    assert parse_duration_s(None) is None and parse_duration_s("") is None
    assert parse_duration_s("500ms") == pytest.approx(0.5)
    assert parse_duration_s("30s") == 30.0
    assert parse_duration_s("5m") == 300.0
    assert parse_duration_s("2h") == 7200.0
    assert parse_duration_s("12.5") == 12.5 and parse_duration_s(3) == 3.0
    with pytest.raises(ValueError):
        parse_duration_s("fast")


def test_retry_policy_validation():
    ses = _pytypes.SimpleNamespace(properties={})
    assert _retry_policy(ses) == "TASK"            # default
    for p in ("task", "QUERY", "none"):
        ses.properties["retry_policy"] = p
        assert _retry_policy(ses) == p.upper()
    ses.properties["retry_policy"] = "ALWAYS"
    with pytest.raises(ValueError, match="retry_policy"):
        _retry_policy(ses)


def test_bad_session_value_leaves_no_phantom_query(cluster):
    """A bad retry_policy/query_max_run_time now fails at SET SESSION
    time (config.SESSION_PROPERTIES validation) — and even a bad value
    injected directly into the session dict still raises before the
    RUNNING log entry is appended, so there is never a forever-RUNNING
    phantom row in system.runtime.queries."""
    runner, _ = cluster
    for prop, bad in (("retry_policy", "ALWAYS"),
                      ("query_max_run_time", "soon")):
        # the SQL path rejects the value up front...
        with pytest.raises(ValueError):
            runner.execute(f"set session {prop} = '{bad}'")
        assert prop not in runner.session.properties
        # ...and the belt-and-braces execution-time check still guards
        # values that bypass SET SESSION (direct dict writes)
        runner.session.properties[prop] = bad
        try:
            with pytest.raises(ValueError):
                runner.execute("select count(*) from nation")
        finally:
            runner.session.properties.pop(prop, None)
    assert not [e for e in runner.local.query_log
                if e.state == "RUNNING"]


# -- output buffer retry semantics ------------------------------------------

def test_output_buffer_retain_rereads_from_zero():
    """retain=True (retry_policy=TASK): acked pages survive so a
    re-created consumer attempt replays the buffer from token 0."""
    buf = OutputBuffer(1, retain=True)
    buf.add(0, b"p0")
    buf.add(0, b"p1")
    buf.finish()
    pages, token, _ = buf.get(0, 0, 0.1)
    assert pages == [b"p0", b"p1"]
    # ack everything, then a NEW attempt re-reads the full stream
    again, _, complete = buf.get(0, token, 0.1)
    assert complete and again == []
    replay, token, _ = buf.get(0, 0, 0.1)
    assert replay == [b"p0", b"p1"]
    assert buf.get(0, token, 0.1)[2] is True


def test_output_buffer_default_drops_acked():
    buf = OutputBuffer(1)
    buf.add(0, b"p0")
    pages, token, _ = buf.get(0, 0, 0.1)
    assert pages == [b"p0"]
    buf.get(0, token, 0.0)                        # ack drops it
    pages, _, _ = buf.get(0, 0, 0.0)
    assert pages == []


def test_output_buffer_first_failure_wins():
    """An abort racing (or following) the real error must not clobber
    the diagnostic a late poller needs."""
    buf = OutputBuffer(1)
    buf.fail("ValueError: the real cause")
    buf.fail("task aborted")
    with pytest.raises(RuntimeError, match="the real cause"):
        buf.get(0, 0, 0.1)


# -- exchange failure attribution -------------------------------------------

def test_exchange_transport_failure_names_upstream():
    """A dead upstream worker surfaces ExchangeFailedError with the
    source task id after fail_fast_s — not a 300s generic timeout."""
    client = ExchangeClient(
        ["http://127.0.0.1:9/v1/task/cq_9.1.0"], 0, "cpu",
        fail_fast_s=0.4)
    t0 = time.monotonic()
    with pytest.raises(ExchangeFailedError) as ei:
        list(client.batches())
    assert time.monotonic() - t0 < 10.0
    assert ei.value.task_id == "cq_9.1.0"
    assert "cq_9.1.0" in str(ei.value)


def test_exchange_http_error_names_upstream(cluster):
    """An upstream that ANSWERS with an error (task gone) fails the
    pull immediately with the upstream task id embedded."""
    _, workers = cluster
    url = f"http://127.0.0.1:{workers[0].port}/v1/task/cq_9.2.0"
    client = ExchangeClient([url], 0, "cpu")
    with pytest.raises(ExchangeFailedError) as ei:
        list(client.batches())
    assert ei.value.task_id == "cq_9.2.0"
    assert "HTTP 404" in str(ei.value)


def test_exchange_pull_failpoint():
    FAILPOINTS.configure("exchange.pull", message="chaos drop")
    client = ExchangeClient(
        ["http://127.0.0.1:9/v1/task/cq_9.3.0"], 0, "cpu",
        fail_fast_s=30.0)
    with pytest.raises(ExchangeFailedError, match="chaos drop"):
        list(client.batches())


def test_exchange_wait_is_cancellable():
    """A DELETE-aborted task blocked on its upstreams must wake on the
    cancel event, not after the transport window."""
    from presto_tpu_torch.errors import QueryCancelledError
    cancel = threading.Event()
    client = ExchangeClient(
        ["http://127.0.0.1:9/v1/task/cq_9.4.0"], 0, "cpu",
        fail_fast_s=60.0, cancel_event=cancel)
    threading.Timer(0.3, cancel.set).start()
    t0 = time.monotonic()
    with pytest.raises(QueryCancelledError):
        list(client.batches())
    assert time.monotonic() - t0 < 5.0
    client.stop.set()


# -- drain-aware scheduling --------------------------------------------------

def test_discovery_tracks_announced_state():
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager
    dm = DiscoveryNodeManager()
    dm.announce("n1", "http://a:1")
    dm.announce("n2", "http://b:2", state="SHUTTING_DOWN")
    assert dm.states() == {"http://a:1": "ACTIVE",
                           "http://b:2": "SHUTTING_DOWN"}
    # draining nodes still announce (their buffers stay reachable)
    assert dm.active_urls() == ["http://a:1", "http://b:2"]
    assert [n["state"] for n in dm.nodes()] == ["ACTIVE",
                                                "SHUTTING_DOWN"]


def test_draining_worker_gets_no_new_tasks(cluster):
    """A SHUTTING_DOWN node leaves the schedulable set (reference
    NodeScheduler + GracefulShutdownHandler) but queries still run on
    the survivors."""
    runner, workers = cluster
    w_drain = workers[1]
    url_drain = f"http://127.0.0.1:{w_drain.port}"
    drained0 = _counter("node_drained_total")
    w_drain.shutting_down = True       # /v1/info now reports the drain
    try:
        assert runner._schedulable_workers() == \
            [f"http://127.0.0.1:{workers[0].port}"]
        assert _counter("node_drained_total") == drained0 + 1
        before = len(w_drain.tasks) + len(w_drain.done)
        res = runner.execute(
            "select count(*), sum(n_regionkey) from nation")
        assert res.rows == [(25, 50)]
        assert len(w_drain.tasks) + len(w_drain.done) == before
    finally:
        w_drain.shutting_down = False
    assert url_drain in runner._schedulable_workers()


def test_all_draining_fails_fast(cluster):
    runner, workers = cluster
    for w in workers:
        w.shutting_down = True
    try:
        with pytest.raises(QueryFailedError, match="draining"):
            runner.execute("select count(*) from region")
    finally:
        for w in workers:
            w.shutting_down = False


# -- abort propagation (DELETE /v1/query) ------------------------------------

def _put_sleeping_task(worker, task_id: str, sleep_s: float) -> str:
    """PUT a real single-fragment task that stalls in a failpoint."""
    from presto_tpu_torch.planner.codec import encode
    from presto_tpu_torch.exec.runner import LocalRunner
    FAILPOINTS.configure("worker.task_run", action="sleep",
                         sleep_s=sleep_s, match=task_id.split(".")[0])
    lr = LocalRunner(tpch_sf=SF, device="cpu")
    plan = lr.plan("select count(*) from nation")
    url = f"http://127.0.0.1:{worker.port}"
    doc = {"fragment": encode(plan.root),
           "output": {"kind": "single", "n_buffers": 1},
           "splits": [], "sources": {}}
    req = urllib.request.Request(f"{url}/v1/task/{task_id}",
                                 method="PUT",
                                 data=json.dumps(doc).encode())
    with urllib.request.urlopen(req, timeout=10):
        pass
    return url


def test_query_delete_frees_tasks_and_tombstones(cluster):
    """DELETE /v1/query/{id} aborts every task of the query, frees the
    task-registry entries, and late status/result polls still see the
    terminal verdict (persisted failure state, not a 404/empty page)."""
    _, workers = cluster
    qid, tid = "qabort", "qabort.0.0"
    url = _put_sleeping_task(workers[0], tid, sleep_s=8.0)
    req = urllib.request.Request(f"{url}/v1/query/{qid}",
                                 method="DELETE")
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert json.loads(resp.read())["aborted_tasks"] == 1
    assert tid not in workers[0].tasks            # registry freed
    with urllib.request.urlopen(f"{url}/v1/task/{tid}",
                                timeout=5) as resp:
        tomb = json.loads(resp.read())
    assert tomb["state"] == "ABORTED"
    # late results poll: the real verdict, not an empty page
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{url}/v1/task/{tid}/results/0/0",
                               timeout=5)
    assert ei.value.code == 500
    assert "aborted" in json.loads(ei.value.read())["error"]


def test_deadline_aborts_query_and_records_history(cluster):
    """query_max_run_time: the coordinator aborts the whole query
    (DELETE /v1/query on every worker), the error names the deadline,
    workers keep no registry entries, and the history record is FAILED
    with the retry column present."""
    runner, workers = cluster
    FAILPOINTS.configure("worker.task_run", action="sleep",
                         sleep_s=6.0, times=None)
    runner.session.properties["query_max_run_time"] = "300ms"
    try:
        with pytest.raises(QueryFailedError,
                           match="query_max_run_time"):
            runner.execute("select count(*) from orders")
    finally:
        del runner.session.properties["query_max_run_time"]
        FAILPOINTS.clear()
    for w in workers:
        assert not any(t.state in ("PLANNED", "RUNNING")
                       and not t._abort.is_set()
                       for t in w.tasks.values())
    res = runner.local.execute(
        "select state, error, retries from "
        "system.runtime.completed_queries where mode = 'cluster' "
        "order by create_time")
    assert res.rows, "no cluster history record"
    state, error, retries = res.rows[-1]
    assert state == "FAILED" and "query_max_run_time" in error
    assert retries == 0
    # let the injected sleeps drain before the next test queries
    deadline = time.time() + 12
    while time.time() < deadline and any(
            t.state in ("PLANNED", "RUNNING")
            for w in workers for t in list(w.tasks.values())):
        time.sleep(0.2)


# -- explain analyze surface -------------------------------------------------

def test_format_retry_summary():
    from presto_tpu_torch.planner.printer import format_retry_summary
    assert format_retry_summary({"retries": 0, "events": []}) == ""
    text = format_retry_summary({
        "policy": "TASK", "retries": 1, "speculative_launched": 1,
        "speculative_won": 1,
        "events": [
            {"kind": "task_retry", "task": "cq.1.0.a1", "attempt": 1,
             "from": "http://a", "to": "http://b", "reason": "boom"},
            {"kind": "speculative_launched", "task": "cq.2.0.a1",
             "straggler": "cq.2.0", "worker": "http://b"},
            {"kind": "speculative_won", "task": "cq.2.0.a1",
             "worker": "http://b"},
        ]})
    assert "1 task retry" in text and "1 speculative launched" in text
    assert "cq.1.0.a1" in text and "straggler cq.2.0" in text


def test_cluster_explain_analyze_includes_retries(cluster):
    runner, _ = cluster
    FAILPOINTS.configure("worker.task_run", action="error",
                         message="explain chaos", times=1)
    res = runner.execute("explain analyze select count(*) from nation")
    text = "\n".join(r[0] for r in res.rows)
    assert "Cluster:" in text
    assert "Fault tolerance [TASK]: 1 task retry" in text
    # the per-event detail line names the replaced attempt
    assert "\n  retry cq_" in text


def test_cluster_explain_analyze_text_equals_reference(cluster):
    """Without a fault, cluster EXPLAIN ANALYZE prints the reference's
    plan and stage line; only the measured wall differs."""
    import re
    from presto_tpu.exec.cluster import ClusterRunner as JCluster
    from presto_tpu.server.worker import WorkerServer as JWorker
    runner, _ = cluster
    sql = ("explain analyze select n_regionkey, count(*) from nation "
           "group by n_regionkey order by n_regionkey")
    jworkers = [JWorker(tpch_sf=SF) for _ in range(2)]
    for w in jworkers:
        w.start()
    try:
        jrunner = JCluster([f"http://127.0.0.1:{w.port}" for w in jworkers],
                           tpch_sf=SF, heartbeat=False)
        texts = [[re.sub(r"total [0-9,]+ms", "total _ms", r[0])
                  for r in x.execute(sql).rows] for x in (runner, jrunner)]
    finally:
        for w in jworkers:
            w.stop()
    assert texts[0] == texts[1]
    assert any(line.startswith("Cluster: ") for line in texts[0])


