"""The traced slice's reduction after the window: ``trace.idle_gaps`` and
``Context.out_at`` against the scans they replaced (kept here as the
oracle), the reduction's time at the size of a fast cell's slice, and
the launch records that ``trace.Recorder.stop`` keeps for the readers
that charge records to spans."""
import random
import time
import types

import pytest
import torch

from gpubench.harness import spec, trace
from gpubench.harness.cell import Context
from gpubench.harness.loop import Statement
from gpubench.harness.traffic import Instance

S = 1_000_000_000
#: epoch seconds of the synthetic slices' start
T0 = 1_700_000_000


# -- the oracle: the scans before the sweep --------------------------------------

def oracle_host_activity(mid_s, spans, in_flight):
    best = None
    for s in spans:
        if s["start"] <= mid_s <= s["end"]:
            if best is None or (s["start"], -s["end"]) > \
                    (best["start"], -best["end"]):
                best = s
    if best is None:
        return "statement, no span open" if in_flight \
            else "no statement out"
    what = best.get("attrs", {}).get("what")
    return f"{best['name']}:{what}" if what else best["name"]


def oracle_idle_gaps(gaps, ns_to_epoch, spans, out_at, top=trace.TOP):
    by = {}
    for a, b in gaps:
        mid = ((a + b) / 2 + ns_to_epoch) / 1e9
        name = oracle_host_activity(mid, spans, out_at(mid))
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def oracle_out_at(ctx, epoch_s):
    t = epoch_s - ctx.window_epoch
    return any(s.sent <= t and (s.done is None or s.done >= t)
               for s in ctx.statements)


# -- seeded random slices --------------------------------------------------------

NAMES = ("op:Aggregation", "op:Filter", "op:Project", "op:TableScan",
         "sched-wait", "quantum", "plan", "device-sync", "query")


def _span(rng, a, b):
    s = {"name": rng.choice(NAMES), "start": a, "end": b, "attrs": {}}
    if rng.random() < 0.2:
        s["attrs"]["what"] = rng.choice(("copy", "sort", "hash"))
    if rng.random() < 0.1:
        del s["attrs"]
    return s


def random_slice(seed, n_records=400, n_spans=300, n_statements=60):
    """(gaps, ns_to_epoch, spans, context): records on a profiler clock
    that starts at 0, spans and statements on the epoch clock. Spans nest,
    share starts and whole (start, end) pairs, open or close on a gap's
    midpoint, and leave the slice's first and last seconds uncovered."""
    rng = random.Random(seed)
    ns_to_epoch = T0 * S
    recs = []
    for _ in range(n_records):
        a = rng.randrange(0, 10 * S)
        recs.append((a, a + rng.randrange(1, S // 50)))
    _, gaps = trace.union(recs, 0, 10 * S)
    mids = [((a + b) / 2 + ns_to_epoch) / 1e9 for a, b in gaps]
    lo, hi = T0 + 1.5, T0 + 8.5
    spans = []
    while len(spans) < n_spans:
        r = rng.random()
        if r < 0.35 or not spans:
            a = rng.uniform(lo, hi)
            spans.append(_span(rng, a, min(hi, a + rng.expovariate(5.0))))
        elif r < 0.55:                      # nested in another
            p = rng.choice(spans)
            a = rng.uniform(p["start"], p["end"])
            spans.append(_span(rng, a, rng.uniform(a, p["end"])))
        elif r < 0.65:                      # the same start
            p = rng.choice(spans)
            spans.append(_span(rng, p["start"],
                               p["start"] + rng.expovariate(20.0)))
        elif r < 0.75:                      # the same (start, end)
            p = rng.choice(spans)
            spans.append(_span(rng, p["start"], p["end"]))
        else:                               # opens or closes on a midpoint
            m = rng.choice(mids)
            if rng.random() < 0.5:
                spans.append(_span(rng, m, m + rng.expovariate(10.0)))
            else:
                spans.append(_span(rng, m - rng.expovariate(10.0), m))
    rng.shuffle(spans)
    window_epoch = T0 - 2.0
    inst = Instance("q1", {}, "")
    sts = []
    for _ in range(n_statements):
        sent = rng.uniform(0.0, 13.0)
        r = rng.random()
        if r < 0.15:                        # still out at the close
            sent, done = rng.uniform(10.5, 13.0), None
        elif r < 0.3:                       # back on a midpoint
            done = rng.choice(mids) - window_epoch
            sent = done - rng.expovariate(4.0)
        else:
            done = sent + rng.expovariate(4.0)
        sts.append(Statement(rng.randrange(3), inst, sent, done, []))
    ctx = Context(20.0, 1.0, sts, {}, None, None, "cpu", window_epoch)
    return gaps, ns_to_epoch, spans, ctx


@pytest.mark.parametrize("seed", [1, 2, 3, 4294967311, 2305843009213693951])
def test_idle_gaps_equal_the_scan(seed):
    gaps, ns_to_epoch, spans, ctx = random_slice(seed)
    assert len(gaps) > 200
    want = oracle_idle_gaps(gaps, ns_to_epoch, spans,
                            lambda m: oracle_out_at(ctx, m), top=len(NAMES) * 4)
    got = trace.idle_gaps(gaps, ns_to_epoch, spans, ctx.out_at,
                          top=len(NAMES) * 4)
    assert got == want                      # float for float
    names = {k for k, _ in got}
    assert {"statement, no span open", "no statement out"} <= names
    assert any(k.endswith((":copy", ":sort", ":hash")) for k in names)
    assert trace.idle_gaps(gaps, ns_to_epoch, spans, ctx.out_at) == \
        oracle_idle_gaps(gaps, ns_to_epoch, spans,
                         lambda m: oracle_out_at(ctx, m))


def test_idle_gaps_in_any_order_and_with_nothing_open():
    gaps, ns_to_epoch, spans, ctx = random_slice(11)
    random.Random(5).shuffle(gaps)
    for sp in (spans, []):
        assert trace.idle_gaps(gaps, ns_to_epoch, sp, ctx.out_at) == \
            oracle_idle_gaps(gaps, ns_to_epoch, sp,
                             lambda m: oracle_out_at(ctx, m))
    assert trace.idle_gaps([], ns_to_epoch, spans, ctx.out_at) == []


def test_equal_spans_keep_the_first():
    spans = [{"name": "a", "start": 1.0, "end": 3.0, "attrs": {}},
             {"name": "b", "start": 1.0, "end": 3.0, "attrs": {}},
             {"name": "c", "start": 1.0, "end": 5.0, "attrs": {}},
             {"name": "d", "start": 0.5, "end": 2.0, "attrs": {"what": "x"}}]
    gaps = [(1_800_000_000, 2_200_000_000),       # mid 2.0: a
            (3_000_000_000, 3_000_000_000),       # mid 3.0: a, closed end
            (3_500_000_000, 4_500_000_000),       # mid 4.0: c
            (500_000_000, 500_000_000),           # mid 0.5: d:x
            (5_500_000_000, 6_500_000_000)]       # mid 6.0: none
    for out in (True, False):
        got = trace.idle_gaps(gaps, 0, spans, lambda _: out)
        assert got == oracle_idle_gaps(gaps, 0, spans, lambda _: out)
    assert dict(trace.idle_gaps(gaps, 0, spans, lambda _: False)) == {
        "a": 0.4, "c": 1.0, "d:x": 0.0, "no statement out": 1.0}


@pytest.mark.parametrize("seed", [1, 7, 2147483659])
def test_out_at_equals_the_scan(seed):
    gaps, ns_to_epoch, spans, ctx = random_slice(seed, n_statements=300)
    rng = random.Random(seed)
    ends = [x for s in ctx.statements for x in (s.sent, s.done)
            if x is not None]
    asked = [x + ctx.window_epoch for x in ends]
    asked += [((a + b) / 2 + ns_to_epoch) / 1e9 for a, b in gaps]
    asked += [ctx.window_epoch + rng.uniform(-1.0, 25.0)
              for _ in range(2000)]
    got = [ctx.out_at(e) for e in asked]
    assert got == [oracle_out_at(ctx, e) for e in asked]
    assert any(got) and not all(got)
    # on the statements' own clock, both closed ends included
    inside = trace.cover((s.sent, s.done) for s in ctx.statements)
    for t in ends + [rng.uniform(-1.0, 25.0) for _ in range(2000)]:
        assert inside(t) == any(s.sent <= t and (s.done is None
                                                 or s.done >= t)
                                for s in ctx.statements)


def test_cover_edges():
    inside = trace.cover([(1.0, 2.0), (2.0, 3.0), (5.0, 4.0), (6.0, None),
                          (0.5, 1.5)])
    assert [inside(t) for t in (0.4, 0.5, 2.0, 3.0, 3.1, 4.5, 5.9, 6.0,
                                1e300)] == \
        [False, True, True, True, False, False, False, True, True]
    assert not trace.cover([])(0.0)


# -- the reduction at the size of a fast cell -------------------------------------

def fast_slice(n_gaps=500_000, n_spans=30_000, n_statements=1_500,
               threads=3, seconds=25.5):
    """A slice of ``n_gaps`` records with a gap after each, a launch record
    a record, and ``n_statements`` statements on ``threads`` threads, each
    opening a ``query`` span and operator spans nested in it."""
    rng = random.Random(0)
    lo = T0 * S
    step = int(seconds * S) // n_gaps
    recs, corr, launches = [], [], []
    for i in range(n_gaps):
        a = lo + i * step + step // 2
        recs.append((rng.choice(("indexFuncLargeIndex_double",
                                 "indexFuncLargeIndex_long", "reduce",
                                 "elementwise")), 7, a, a + step // 4))
        corr.append(i)
        launches.append((i % threads, a - 3000, i))
    per_statement = n_spans // n_statements
    span_ns = threads * int(seconds * S) // n_statements
    spans, sts = [], []
    inst = Instance("q1", {}, "")
    for k in range(n_statements):
        thread = k % threads
        a = lo + (k // threads) * span_ns
        b = a + span_ns - 1000
        qid = f"q{k}"
        spans.append({"name": "query", "start": a / S, "end": b / S,
                      "startNs": a, "endNs": b, "thread": thread,
                      "queryId": qid, "spanId": f"s{k}", "attrs": {}})
        width = (b - a) // per_statement
        for j in range(per_statement - 1):
            sa = a + j * width
            name = ("op:Aggregation", "op:Filter", "op:TableScan",
                    "plan", "sched-wait")[j % 5]
            spans.append({"name": name, "start": sa / S,
                          "end": (sa + width - 10) / S, "startNs": sa,
                          "endNs": sa + width - 10, "thread": thread,
                          "queryId": qid, "spanId": f"s{k}.{j}",
                          "attrs": {"what": "copy"} if j % 7 == 3 else {}})
        sts.append(Statement(thread, inst, 12.75 + (a - lo) / S,
                             12.75 + (b - lo) / S, []))
    sl = trace.Slice(T0, T0 + seconds, recs, 0, spans, corr, launches)
    ctx = Context(51.0, 1.0, sts, {"scan_cache_hits": 1,
                                   "scan_cache_misses": 0}, None, sl,
                  "cpu", T0 - 12.75)
    return sl, ctx


def test_reduction_of_a_fast_cells_slice_is_near_linear():
    sl, ctx = fast_slice()
    assert len(sl.spans) == 30_000 and len(ctx.statements) == 1_500
    per_layer = [m for m in spec.load_cell(spec.HERE.parent,
                                           "tpch_sf10.agg").metrics
                 if m.kind == "per_layer"]
    t = time.perf_counter()
    busy, gaps = sl.busy()
    out = trace.breakdown(sl, ctx.out_at)
    read = {m.name: spec.metric_reader(m.name).read(ctx) for m in per_layer}
    took = time.perf_counter() - t
    assert len(gaps) == 500_001
    assert took < 60.0, took
    assert out["idle_gaps"] and out["device_ops"]
    assert read["agg_device_ms_per_query"] > 0
    assert read["device_idle_pct"] == pytest.approx(75.0, abs=0.1)
    assert sl.busy() is sl.busy()


# -- the launch records of run.py's traced run ------------------------------------

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


EVENTS = [
    _Event(False, "cudaLaunchKernel", 999 * S, 10, 1, 11),
    _Event(True, "before", 999 * S, 2 * S, 7, 11),              # clipped
    _Event(False, "cudaLaunchKernel", 1001 * S, 10, 1, 12),
    _Event(True, "index_add", 1001 * S + 50, S, 7, 12),
    _Event(False, "cudaMemcpyAsync", 1002 * S + 5, 10, 2, 13),
    _Event(True, "filter", 1003 * S, S // 2, 8, 13),
    _Event(True, "after", 1009 * S, 10, 7, 14),                 # outside
    _Event(False, "cudaLaunchKernel", 1008 * S + 1, 10, 1, 14),
    _Event(False, "cudaStreamIsCapturing", 1003 * S, 10, 2, 15),
    # the profiler's own record of a launch: same id, no thread
    _Event(False, "Lazy Function Loading", 1001 * S + 5, 10, 0, 12),
]


def _stopped(monkeypatch):
    """``trace.Recorder.stop()`` over ``EVENTS``, the slice [1000, 1008] s,
    with the spans that the engine's tracer held."""
    from presto_tpu_torch.obs.trace import TRACER
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        time=lambda: 1008.0))
    spans = [{"name": "query", "thread": 1, "startNs": 1000 * S,
              "endNs": 1006 * S, "start": 1000.0, "end": 1006.0,
              "queryId": "qa", "attrs": {}},
             {"name": "op:Aggregation", "thread": 1, "startNs": 1000 * S,
              "endNs": 1002 * S, "start": 1000.0, "end": 1002.0,
              "queryId": "qa", "attrs": {}},
             {"name": "op:Filter", "thread": 2, "startNs": 1002 * S,
              "endNs": 1004 * S, "start": 1002.0, "end": 1004.0,
              "queryId": "qb", "attrs": {}}]
    monkeypatch.setattr(TRACER, "export", lambda: spans)
    rec = trace.Recorder.__new__(trace.Recorder)
    rec.torch, rec.device = torch, torch.device("cpu")
    rec._results = types.SimpleNamespace(events=lambda: list(EVENTS))
    rec._prof = types.SimpleNamespace(step=lambda: None, stop=lambda: None)
    rec._start = 1000.0
    rec._wall_ns, rec._mono_ns = 1000 * S, 5 * S
    was = TRACER.enabled
    try:
        return rec.stop()
    finally:
        TRACER.enable(was)


def test_recorder_keeps_the_launch_records(monkeypatch):
    sl = _stopped(monkeypatch)
    assert type(sl) is trace.Slice
    assert sl.records == [("before", 7, 1000 * S, 1001 * S),
                          ("index_add", 7, 1001 * S + 50, 1002 * S + 50),
                          ("filter", 8, 1003 * S, 1003 * S + S // 2)]
    assert sl.correlations == [11, 12, 13]
    # runtime calls of the kept records only, in the profiler's order
    assert sl.launches == [(1, 999 * S, 11), (1, 1001 * S, 12),
                           (2, 1002 * S + 5, 13)]
    assert trace.link(EVENTS, torch.autograd.DeviceType.CUDA,
                      *sl.bounds_ns()) == (sl.correlations, sl.launches)
    # "before" was launched before any span of its thread opened
    assert [s["name"] if s else None for s in sl.charged("op:")] == \
        [None, "op:Aggregation", "op:Filter"]


def test_agg_device_ms_per_query_reads_a_plain_slice(monkeypatch):
    sl = _stopped(monkeypatch)
    inst = Instance("q1", {}, "")
    sts = [Statement(0, inst, 1.0, 5.0, []), Statement(1, inst, 2.0, 6.0,
                                                       [])]
    ctx = Context(10.0, 1.0, sts, {}, None, sl, "cpu", 999.0)
    # both statements done in the slice [1, 9] s of the window; the
    # record launched under op:Aggregation took 1 s
    assert spec.metric_reader("agg_device_ms_per_query").read(ctx) == \
        pytest.approx(500.0)
    sl.launches = []
    assert spec.metric_reader("agg_device_ms_per_query").read(ctx) is None
