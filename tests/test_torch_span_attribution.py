"""Charging CUDA records to the engine's spans: the spans' clock, thread
and query ids, the per-batch operator spans, the scheduler's
``sched-wait`` and ``quantum`` spans, and the benchmark's attribution
(``gpubench/harness/attribution.py``) with the metric readers that read
it, on hand-made records and on CPU queries at TPC-H SF 0.01."""
import collections
import contextvars
import threading
import time
import types

import pytest
import torch

from gpubench.harness import attribution, spec, trace
from gpubench.harness.cell import Context
from gpubench.harness.loop import Statement
from gpubench.harness.traffic import Instance
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.taskexec import DeviceScheduler
from presto_tpu_torch.obs.trace import (
    NOOP_SPAN, TRACER, Tracer, epoch_s, thread_key,
)

S = 1_000_000_000
Q_AGG = ("select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
         "from lineitem where l_shipdate <= date '1998-09-01' "
         "group by 1, 2 order by 1, 2")


@pytest.fixture
def tracing():
    was = TRACER.enabled
    TRACER.clear()
    TRACER.enable(True)
    yield TRACER
    TRACER.enable(was)
    TRACER.clear()


@pytest.fixture(scope="module")
def runner():
    return LocalRunner(tpch_sf=0.01, device="cpu", rows_per_batch=1 << 12)


# -- the spans' clock, thread and query ------------------------------------------

def test_span_carries_clock_thread_and_inherited_query():
    t = Tracer(node="a1")
    t.enable(True)
    with t.span("query", query_id="q7") as q:
        with t.span("op:Filter"):
            pass
        ctx = contextvars.copy_context()
        th = threading.Thread(target=ctx.run,
                              args=(lambda: t.span("worker").finish(),))
        th.start()
        th.join(timeout=10)
    by = {s["name"]: s for s in t.export()}
    main = thread_key(threading.get_ident())
    assert by["query"]["thread"] == main == by["op:Filter"]["thread"]
    assert by["worker"]["thread"] != main
    assert {s["queryId"] for s in by.values()} == {"q7"}
    for s in by.values():
        assert isinstance(s["startNs"], int) and s["endNs"] >= s["startNs"]
        assert s["start"] == epoch_s(s["startNs"])
        assert s["end"] == epoch_s(s["endNs"])
    assert by["query"]["startNs"] <= by["op:Filter"]["startNs"]
    assert abs(epoch_s(q.start_ns) - time.time()) < 60


def test_thread_key_is_the_low_32_bits_signed():
    assert thread_key(140157366092544) == -301677824
    assert thread_key(118) == 118
    assert thread_key((5 << 32) + 7) == 7


def test_disabled_tracer_opens_nothing_anywhere(runner):
    assert not TRACER.enabled
    TRACER.clear()
    assert TRACER.span("op:Scan", node_id=0) is NOOP_SPAN
    sched = DeviceScheduler()
    h = sched.task(name="off")
    assert sched.run_quantum(h, lambda: 5) == 5
    runner.execute(Q_AGG)
    assert TRACER.export() == []


# -- per-batch operator spans ----------------------------------------------------

def test_operator_spans_per_batch_nest_and_carry_ids(runner, tracing):
    runner.execute(Q_AGG)
    qid = runner.query_log[-1].query_id
    spans = TRACER.export()
    ops = [s for s in spans if s["name"].startswith("op:")]
    by_id = {s["spanId"]: s for s in spans}
    assert ops and all(s["queryId"] == qid for s in spans)
    name_of = collections.defaultdict(set)
    for s in ops:
        name_of[s["attrs"]["node_id"]].add(s["name"])
    # one name a node; the plan's three projections are three nodes
    assert all(len(v) == 1 for v in name_of.values())
    assert collections.Counter(n for (n,) in name_of.values()) == {
        "op:Sort": 1, "op:Project": 3, "op:Aggregation": 1,
        "op:Filter": 1, "op:TableScan": 1}
    # 60 k lineitem rows in batches of 4096: a scan span a batch, and one
    # for the call that finds the scan exhausted
    scans = [s for s in ops if s["name"] == "op:TableScan"]
    assert len(scans) == 17
    for s in scans:
        parent = by_id[s["parentId"]]
        assert parent["name"].startswith("op:")
        assert parent["startNs"] <= s["startNs"] <= s["endNs"] \
            <= parent["endNs"]
        assert parent["thread"] == s["thread"]
    # every scan batch nests, through its parents, in the aggregation's
    agg = [s for s in ops if s["name"] == "op:Aggregation"]

    def under_agg(s):
        while s["parentId"] in by_id:
            s = by_id[s["parentId"]]
            if s["name"] == "op:Aggregation":
                return True
        return False
    assert agg and all(under_agg(s) for s in scans)


# -- the scheduler's spans -------------------------------------------------------

def test_sched_wait_and_quantum_spans_carry_the_bill(tracing):
    sched = DeviceScheduler()
    h = sched.task(name="t1")

    def body():
        time.sleep(0.02)
        sched.note_stall(0.005)
        return 3
    with TRACER.span("query", query_id="qs"):
        assert sched.run_quantum(h, body) == 3
    by = {s["name"]: s for s in TRACER.export()}
    wait, quantum = by["sched-wait"], by["quantum"]
    assert wait["attrs"] == {"task": "t1", "level": 0}
    assert wait["endNs"] <= quantum["startNs"]
    assert wait["queryId"] == quantum["queryId"] == "qs"
    a = quantum["attrs"]
    assert a["stall_credit_s"] == pytest.approx(0.005)
    assert a["billed_s"] == pytest.approx(h.device_seconds)
    assert 0.01 < a["billed_s"] < \
        (quantum["endNs"] - quantum["startNs"]) / S


def test_sched_wait_covers_the_wait_for_another_task(tracing):
    sched = DeviceScheduler()
    a, b = sched.task(name="a"), sched.task(name="b")
    inside, go = threading.Event(), threading.Event()

    def hold():
        inside.set()
        go.wait(5)
    th = threading.Thread(target=sched.run_quantum, args=(a, hold))
    th.start()
    assert inside.wait(5)
    threading.Timer(0.05, go.set).start()
    sched.run_quantum(b, lambda: None)
    th.join(5)
    waits = {s["attrs"]["task"]: s for s in TRACER.export()
             if s["name"] == "sched-wait"}
    assert (waits["b"]["endNs"] - waits["b"]["startNs"]) / S >= 0.04


def test_query_spans_of_the_scheduler(runner, tracing):
    runner.execute(Q_AGG)
    qid = runner.query_log[-1].query_id
    spans = TRACER.export()
    quanta = [s for s in spans if s["name"] == "quantum"]
    assert quanta and all("billed_s" in s["attrs"] for s in quanta)
    assert [s for s in spans if s["name"] == "sched-wait"]
    assert all(s["queryId"] == qid for s in spans)


# -- attribution -----------------------------------------------------------------

def _span(name, thread, a, b, query="q1", **attrs):
    return {"name": name, "thread": thread, "startNs": a, "endNs": b,
            "start": a / S, "end": b / S, "queryId": query,
            "spanId": f"{name}.{thread}.{a}", "attrs": attrs}


SPANS = [_span("query", 1, 0, 100), _span("op:Aggregation", 1, 10, 50),
         _span("device-sync", 1, 20, 30), _span("op:TableScan", 2, 0, 100),
         _span("op:Filter", 1, 55, 60)]


def test_attribute_innermost_on_the_launching_thread():
    recs = [("k", 7, 1000, 1010, c) for c in range(1, 8)]
    launches = [(1, 25, 1), (1, 40, 2), (1, 70, 3), (3, 25, 4),
                (2, 5, 6), (1, 55, 7)]
    got = attribution.attribute(recs, launches, SPANS)
    names = [s["name"] if s else None for s in got]
    # 4: launched on a thread with no span, while others had some open;
    # 5: no launch record
    assert names == ["device-sync", "op:Aggregation", "query", None, None,
                     "op:TableScan", "op:Filter"]
    ops = attribution.attribute(recs, launches, SPANS, prefix="op:")
    assert [s["name"] if s else None for s in ops] == \
        ["op:Aggregation", "op:Aggregation", None, None, None,
         "op:TableScan", "op:Filter"]
    assert attribution.attribute(recs, launches, []) == [None] * 7


def test_attribute_outlasting_span_and_equal_starts():
    spans = [_span("op:A", 1, 0, 10), _span("op:B", 1, 5, 100),
             _span("op:C", 1, 5, 8), _span("op:D", 1, 200, 300)]
    recs = [("k", 7, 0, 1, c) for c in range(4)]
    got = attribution.attribute(
        recs, [(1, 6, 0), (1, 50, 1), (1, 150, 2), (1, 200, 3)], spans)
    assert [s["name"] if s else None for s in got] == \
        ["op:C", "op:B", None, "op:D"]


class _Event:
    def __init__(self, cuda, name, start, dur, res, corr):
        self._v = (torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU, name, start, dur,
                   res, corr)

    def device_type(self):
        return self._v[0]

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_resource_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


class _Prof:
    def step(self):
        pass

    def stop(self):
        pass


def _stopped(cls, events, monkeypatch):
    """``cls.stop()`` over ``events``, the slice [1000, 1008] s."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        time=lambda: 1008.0))
    rec = cls.__new__(cls)
    rec.torch, rec.device = torch, torch.device("cpu")
    rec._results, rec._prof = _Results(events), _Prof()
    rec._start = 1000.0
    rec._wall_ns, rec._mono_ns = 1000 * S, 5 * S
    was = TRACER.enabled
    try:
        return rec.stop()
    finally:
        TRACER.enable(was)


EVENTS = [
    _Event(False, "cudaLaunchKernel", 999 * S, 10, -301677824, 11),
    _Event(True, "before", 999 * S, 2 * S, 7, 11),         # clipped
    _Event(False, "cudaLaunchKernel", 1001 * S, 10, -301677824, 12),
    _Event(True, "index_add", 1001 * S + 50, 3 * S, 7, 12),
    _Event(False, "cudaMemcpyAsync", 1002 * S, 10, 118, 13),
    _Event(True, "Memcpy HtoD", 1002 * S + 90, 1000, 8, 13),
    _Event(True, "after", 1009 * S, 10, 7, 14),             # outside
    _Event(False, "cudaStreamIsCapturing", 1003 * S, 10, 118, 15),
    # the profiler's own record of a launch: same id, no thread
    _Event(False, "Lazy Function Loading", 1001 * S + 5, 10, 0, 12),
]


def test_launch_recorder_keeps_what_recorder_reads(monkeypatch):
    plain = _stopped(trace.Recorder, EVENTS, monkeypatch)
    linked = _stopped(attribution.LaunchRecorder, EVENTS, monkeypatch)
    assert isinstance(linked, attribution.LaunchSlice)
    assert linked.records == plain.records and len(plain.records) == 3
    assert linked.busy() == plain.busy()
    assert trace.device_ops(linked.records) == trace.device_ops(plain.records)
    _, gaps = plain.busy()
    assert trace.idle_gaps(gaps, linked.ns_to_epoch, linked.spans,
                           lambda _: True) == \
        trace.idle_gaps(gaps, plain.ns_to_epoch, plain.spans,
                        lambda _: True)
    assert linked.correlations == [11, 12, 13]
    assert sorted(linked.launches) == [(-301677824, 999 * S, 11),
                                       (-301677824, 1001 * S, 12),
                                       (118, 1002 * S, 13)]
    assert attribution.LaunchRecorder.last is linked


# -- the readers -----------------------------------------------------------------

def _ctx(slice_):
    q1, q6 = Instance("q1", {}, ""), Instance("q6", {}, "")
    sts = [Statement(0, q1, 0.0, 2.0, []), Statement(1, q6, 0.5, 3.0, []),
           Statement(2, q6, 1.0, 9.5, [])]
    return Context(10.0, 42.0, sts, {}, None, slice_, "H100", 1000.0)


def _launch_slice():
    t = 1000 * S
    spans = [_span("query", 1, t, t + 6 * S, "qa"),
             _span("quantum", 1, t + S, t + 3 * S, "qa", billed_s=1.5,
                   stall_credit_s=0.0),
             _span("op:Aggregation", 1, t + S, t + 3 * S, "qa"),
             _span("op:TableScan", 1, t + S, t + 2 * S, "qa"),
             _span("sched-wait", 2, t + S, t + 2 * S, "qb"),
             _span("sched-wait", 2, t - S, t + S // 2, "qb"),
             _span("quantum", 2, t + 2 * S, t + 4 * S, "qb", billed_s=0.1,
                   stall_credit_s=0.0),
             _span("op:Filter", 2, t + 2 * S, t + 4 * S, "qb")]
    recs = [("index_add", 7, t + 2 * S, t + 3 * S),          # agg, qa
            ("scan", 7, t + 3 * S, t + 3 * S + S // 2),      # scan, qa
            ("filter", 7, t + 4 * S, t + 4 * S + S // 4),    # filter, qb
            ("lost", 7, t + 5 * S, t + 5 * S + S // 4)]      # no launch
    launches = [(1, t + 2 * S + 5, 21), (1, t + S + 5, 22),
                (2, t + 3 * S, 23)]
    return attribution.LaunchSlice(t / S, t / S + 8.0, recs, 0, spans,
                                   correlations=[21, 22, 23, 24],
                                   launches=launches)


def read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_attribution_readers():
    ctx = _ctx(_launch_slice())
    # two statements completed in the slice [0, 8] s: 1 s of agg records
    assert read("agg_device_ms_per_query", ctx) == pytest.approx(500.0)
    # quanta: qa billed 1.5 against 1.5 s, qb 0.1 against 0.25 s
    assert read("quantum_billing_gap_pct", ctx) == \
        pytest.approx(100 * 0.15 / 1.75)
    # waits clipped to the slice: 1 s + 0.5 s over two statements
    assert read("sched_wait_ms_per_query", ctx) == pytest.approx(750.0)


def test_readers_find_nothing_without_what_they_read():
    sl = _launch_slice()
    plain = trace.Slice(sl.start_epoch, sl.stop_epoch, sl.records, 0,
                        [{k: v for k, v in s.items()
                          if k not in ("thread", "startNs", "endNs")}
                         for s in sl.spans if s["name"] != "sched-wait"])
    for name in ("agg_device_ms_per_query", "quantum_billing_gap_pct",
                 "sched_wait_ms_per_query"):
        assert read(name, _ctx(plain)) is None
        assert read(name, _ctx(None)) is None


def test_report_splits_templates_and_names_what_went_uncharged():
    sl = _launch_slice()
    lines = attribution.report(sl, {"qa": "q1", "qb": "q6"}.get)
    assert lines[0].startswith("attribution: 1.750 s of 2.000 s busy")
    assert any("no launch record): 0.250 s" in x for x in lines)
    # only qa's query span lies in the slice
    assert "device ms a statement, q1: 1500.000 over 1 statements " \
        "in the slice" in lines
    assert "  q1 op:Aggregation: 1000.000 ms" in lines
    assert "  q1 op:TableScan: 500.000 ms" in lines
    assert "kernel index_add: 1.000 s, op:Aggregation 100.00%" in lines
    assert "kernel filter: 0.250 s, op:Filter 100.00%" in lines
    assert not any(x.startswith("kernel lost") for x in lines)   # top 3
    assert not any("q6" in x for x in lines)
