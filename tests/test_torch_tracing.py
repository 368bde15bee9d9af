"""The span tracer, the structured log and the Chrome-trace export of
presto_tpu_torch against presto_tpu (the tracer and Chrome-trace cases
of tests/test_obs.py), and the spans the port's executor opens: one per
operator, a ``device-sync`` span at each host readback it already makes,
the spill spans under a memory budget. On the CPU, TPC-H SF 0.01."""
import collections
import io
import json
import threading

import pytest

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.obs.trace import TRACER as JTRACER
from presto_tpu.obs.trace import chrome_trace as j_chrome_trace
from presto_tpu.planner.printer import format_trace_summary as j_summary
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.log import LOG
from presto_tpu_torch.obs.trace import (
    NOOP_SPAN, TRACER, Tracer, chrome_trace, current_span_ids,
    write_chrome_trace,
)
from presto_tpu_torch.planner.printer import format_trace_summary

SF = 0.01
Q_JOIN = ("select l_returnflag, count(*) from lineitem join orders "
          "on l_orderkey = o_orderkey group by 1 order by 1")
Q_SMALL = ("select n_name, r_name from nation join region "
           "on n_regionkey = r_regionkey order by 1")
Q_SPILL = "select c_nationkey, count(*) c from customer group by c_nationkey"
SPILL = {"query_max_memory": 2000, "dense_grouping": False,
         "spill_partitions": 4}


@pytest.fixture
def tracing():
    """Both packages' global tracers on, and empty, for one test."""
    was = TRACER.enabled, JTRACER.enabled
    for t in (TRACER, JTRACER):
        t.clear()
        t.enable(True)
    yield TRACER
    TRACER.enable(was[0])
    JTRACER.enable(was[1])


@pytest.fixture(scope="module")
def runner():
    return LocalRunner(tpch_sf=SF, device="cpu", rows_per_batch=1 << 12)


@pytest.fixture(scope="module")
def jrunner():
    return JRunner(tpch_sf=SF, rows_per_batch=1 << 12)


# -- tracer core ---------------------------------------------------------------

def test_disabled_tracer_is_noop():
    t = Tracer(node="t0")
    assert t.enabled is False
    s = t.span("anything", x=1)
    assert s is NOOP_SPAN
    with s:
        pass
    assert t.export() == [] and t.context() is None
    it = iter([1, 2])
    assert t.wrap_iter("op:Scan", it) is it


def test_span_nesting_and_context():
    t = Tracer(node="t1")
    t.enable(True)
    with t.span("query", query_id="q1") as q:
        assert t.context() == {"traceId": q.trace_id, "spanId": q.span_id}
        assert current_span_ids() == {"query_id": "q1",
                                      "trace_id": q.trace_id}
        with t.span("plan"):
            pass
        with t.span("stage", stage_id=0) as st:
            assert st.parent_id == q.span_id
    spans = t.export()
    assert [s["name"] for s in spans] == ["plan", "stage", "query"]
    by_name = {s["name"]: s for s in spans}
    assert by_name["plan"]["parentId"] == by_name["query"]["spanId"]
    assert len({s["traceId"] for s in spans}) == 1
    assert all(s["end"] >= s["start"] for s in spans)


def test_wrap_iter_records_batches():
    t = Tracer(node="t4")
    t.enable(True)
    assert list(t.wrap_iter("op:Scan", iter([1, 2, 3]))) == [1, 2, 3]
    (span,) = t.export()
    assert span["name"] == "op:Scan" and span["attrs"]["batches"] == 3


def test_span_error_is_recorded():
    t = Tracer(node="t5")
    t.enable(True)
    with pytest.raises(ZeroDivisionError):
        with t.span("query"):
            1 / 0
    assert t.export()[0]["attrs"]["error"].startswith("ZeroDivisionError")


def test_context_crosses_threads_started_in_a_copy():
    import contextvars
    t = Tracer(node="t6")
    t.enable(True)
    with t.span("query") as q:
        ctx = contextvars.copy_context()
        th = threading.Thread(target=ctx.run,
                              args=(lambda: t.span("worker").finish(),))
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    worker = [s for s in t.export() if s["name"] == "worker"][0]
    assert worker["parentId"] == q.span_id


# -- the runner's spans ------------------------------------------------------

def test_query_span_tree(runner, tracing):
    """query -> plan and op:* spans, every parent inside the trace, the
    probe side's operators included (they run on the probe-prefetch
    producer thread, in a copy of the query's context)."""
    runner.execute(Q_JOIN)
    spans = TRACER.export()
    q = [s for s in spans if s["name"] == "query"][-1]
    tree = [s for s in spans if s["traceId"] == q["traceId"]]
    names = collections.Counter(s["name"] for s in tree)
    assert names["plan"] == 1 and names["op:TableScan"] == 2
    assert names["op:Join"] == 1 and names["device-sync"] >= 1
    ids = {s["spanId"] for s in tree}
    assert all(s["parentId"] in ids for s in tree
               if s["parentId"] is not None)
    assert q["attrs"]["query_id"] == runner.query_log[-1].query_id


def test_operator_spans_equal_reference(runner, jrunner, tracing):
    """The same plan opens the same operator spans in both packages."""
    runner.execute(Q_SMALL)
    jrunner.execute(Q_SMALL)

    def ops(spans):
        return collections.Counter(s["name"] for s in spans
                                   if s["name"].startswith("op:"))
    assert ops(TRACER.export()) == ops(JTRACER.export())


def test_tracer_off_records_nothing(runner):
    assert not TRACER.enabled
    TRACER.clear()
    got = runner.execute(Q_JOIN).rows
    assert TRACER.export() == []
    TRACER.enable(True)
    try:
        assert runner.execute(Q_JOIN).rows == got
    finally:
        TRACER.enable(False)


def test_explain_analyze_trace_section(runner, tracing):
    text = "\n".join(r[0] for r in runner.execute(
        "explain analyze select count(*) from nation").rows)
    assert "Trace (spans by name):" in text and "op:" in text
    assert "explain-analyze" in text


def test_explain_analyze_no_trace_section_when_disabled(runner):
    assert not TRACER.enabled
    text = "\n".join(r[0] for r in runner.execute(
        "explain analyze select count(*) from nation").rows)
    assert "Trace (spans by name):" not in text


def test_history_reads_plan_and_device_sync_spans(runner, tracing):
    runner.execute(Q_JOIN)
    from presto_tpu_torch.obs.history import HISTORY
    rec = HISTORY.snapshot()[-1]
    assert rec["planning_ms"] > 0 and rec["device_sync_ms"] > 0


def test_spill_spans_equal_reference(runner, jrunner, tracing):
    """Under a budget the aggregation's revocation is a spill-revoke span
    naming its buffer, in both packages."""
    runner.execute(Q_SPILL, properties=SPILL)
    jrunner.execute(Q_SPILL, properties=SPILL)

    def spill(spans):
        return sorted((s["name"], s["attrs"].get("buffer"))
                      for s in spans if s["name"].startswith("spill"))
    got = spill(TRACER.export())
    assert got == spill(JTRACER.export())
    assert ("spill-revoke", "hash-agg") in got


def test_spill_to_disk_and_join_revoke_spans(runner, tracing, tmp_path):
    runner.execute("select o_orderpriority, count(*) c from orders, "
                   "lineitem where l_orderkey = o_orderkey "
                   "group by o_orderpriority order by o_orderpriority",
                   properties={**SPILL, "query_max_memory": 200_000,
                               "spill_to_disk_bytes": 10_000,
                               "spill_path": str(tmp_path)})
    spans = TRACER.export()
    names = {(s["name"], s["attrs"].get("buffer")) for s in spans}
    assert ("spill-revoke", "join-build") in names
    disk = [s for s in spans if s["name"] == "spill-to-disk"]
    assert disk and all(s["attrs"]["host_bytes"] > 0 for s in disk)


def test_parallel_drivers_stay_in_the_trace(runner, tracing):
    runner.execute("select l_orderkey, count(*) c from lineitem "
                   "group by l_orderkey",
                   properties={"dense_grouping": False,
                               "task_concurrency": 4})
    spans = TRACER.export()
    q = [s for s in spans if s["name"] == "query"][-1]
    tree = [s for s in spans if s["traceId"] == q["traceId"]]
    assert len(tree) == len(spans)


def test_log_carries_span_ids(runner):
    buf = io.StringIO()
    LOG.configure(stream=buf)
    TRACER.enable(True)
    try:
        runner.execute("select 1", user="ann")
        with TRACER.span("outer", query_id="qx") as sp:
            LOG.log("note", detail=1)
    finally:
        LOG.close()
        TRACER.enable(False)
    docs = [json.loads(line) for line in buf.getvalue().splitlines()]
    done = [d for d in docs if d["event"] == "query_completed"][0]
    assert done["user"] == "ann" and done["state"] == "FINISHED"
    assert done["query_id"] == runner.query_log[-1].query_id
    note = [d for d in docs if d["event"] == "note"][0]
    assert note["trace_id"] == sp.trace_id and note["query_id"] == "qx"


# -- Chrome-trace export --------------------------------------------------------

def test_chrome_trace_schema(tmp_path, tracing):
    with TRACER.span("query", query_id="qx") as q:
        with TRACER.span("op:Scan"):
            pass
    path = write_chrome_trace(str(tmp_path / "trace.json"),
                              TRACER.export(q.trace_id))
    with open(path) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 2 and any(e["ph"] == "M" for e in doc["traceEvents"])
    for e in xs:
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        assert e["dur"] >= 0 and e["args"]["traceId"] == q.trace_id
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    by_name = {e["name"]: e for e in xs}
    assert by_name["op:Scan"]["args"]["parentId"] == \
        by_name["query"]["args"]["spanId"]


def test_chrome_trace_and_summary_equal_reference(runner, tracing):
    """The same spans render to the reference's Chrome-trace document
    (but for the package's name) and to its trace summary."""
    runner.execute(Q_JOIN)
    spans = TRACER.export()
    got = json.dumps(chrome_trace(spans)).replace("presto_tpu_torch",
                                                  "presto_tpu")
    assert got == json.dumps(j_chrome_trace(spans))
    assert format_trace_summary(spans) == j_summary(spans)


def test_chrome_trace_empty():
    assert chrome_trace([]) == {"traceEvents": [], "displayTimeUnit": "ms"}
