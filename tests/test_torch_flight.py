"""The mesh flight recorder of presto_tpu_torch (obs/flight.py): the
tests of tests/test_mesh_flight.py that are not marked slow, on the
port's mesh of CPU slots, and the attribution held to presto_tpu's
recorder on the same round records.

Every host-observable event of a mesh query lands in the active
FlightRecorder; ``finish()`` reconciles the rounds against measured wall
into the six buckets plus a per-shard critical path; and every surface
that re-renders the timeline (EXPLAIN ANALYZE's "Mesh rounds" section,
``system.runtime.mesh_rounds``, the completed-queries columns, the
metric families, the Chrome trace) agrees with the recorder."""
import json
import re
import time

import pytest

from presto_tpu.obs import flight as jflight
from presto_tpu_torch.exec.failpoints import FAILPOINTS
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs import flight
from presto_tpu_torch.obs.flight import (
    BUCKETS, FLIGHTS, KIND_BUCKET, FlightRecorder, chrome_events,
)
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.obs.trace import chrome_trace

SF = 0.005

Q1 = ("select l_returnflag, l_linestatus, sum(l_quantity), "
      "sum(l_extendedprice), avg(l_discount), count(*) from lineitem "
      "where l_shipdate <= date '1998-09-02' "
      "group by l_returnflag, l_linestatus order by 1, 2")

#: hash-partitioned join (broadcast suppressed): its probe stream crosses
#: the exchange every round
QJOIN = ("select c_name, sum(o_totalprice) from customer "
         "join orders on c_custkey = o_custkey "
         "group by 1 order by 2 desc, 1 limit 5")
_QJOIN_PROPS = {"broadcast_join_row_limit": 1}


@pytest.fixture(autouse=True)
def _slots(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")


def _props(n, **extra):
    # "on" (not "auto") so the one-slot flight exists too
    return {"mesh_execution": "on", "mesh_devices": n, **extra}


def _value(name):
    return REGISTRY.counter(name).value


@pytest.fixture(scope="module")
def tpch():
    return LocalRunner(tpch_sf=SF, rows_per_batch=1 << 11, device="cpu")


def _fly(runner, sql, n, warm=True, **extra):
    """Execute on a forced n-slot mesh; return (result, flight)."""
    if warm:
        runner.execute(sql, properties=_props(n, **extra))
    before = FLIGHTS.snapshot()
    res = runner.execute(sql, properties=_props(n, **extra))
    after = FLIGHTS.snapshot()
    assert after and (not before or after[-1] is not before[-1]), \
        "run did not produce a flight"
    return res, after[-1]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_q1_reconciles_and_reports_dominant(tpch, n):
    _, fl = _fly(tpch, Q1, n)
    a = fl.attribution
    assert a is not None
    assert a["n_devices"] == n
    assert a["rounds"] > 0
    unattributed = a["wall_s"] * (100.0 - a["reconciled_pct"]) / 100.0
    assert a["reconciled_pct"] >= 90.0 or unattributed <= 0.25, a
    assert abs(sum(a["buckets"].values())
               - a["wall_s"] * a["reconciled_pct"] / 100.0) < 0.05 \
        or a["reconciled_pct"] == 100.0
    assert a["dominant_bucket"] in BUCKETS
    assert a["buckets"][a["dominant_bucket"]] == \
        max(a["buckets"].values())
    cp = a["critical_path"]
    assert len(cp["per_shard_s"]) == n
    assert cp["per_shard_s"][cp["slowest_shard"]] == \
        max(cp["per_shard_s"])
    slack = (len(a["buckets"]) + 1) * 5e-7
    assert max(cp["per_shard_s"]) <= sum(a["buckets"].values()) + slack


@pytest.mark.parametrize("fused", [None, True])
def test_round_counts_match_exchange_rounds(tpch, fused):
    extra = dict(_QJOIN_PROPS)
    if fused is not None:
        extra["mesh_fused_exchange"] = fused
    tpch.execute(QJOIN, properties=_props(4, **extra))
    ship0 = _value("exchange_repartitions_total")
    resplit0 = _value("mesh_repartition_resplit_total")
    _, fl = _fly(tpch, QJOIN, 4, warm=False, **extra)
    shipped = _value("exchange_repartitions_total") - ship0
    resplits = _value("mesh_repartition_resplit_total") - resplit0
    kinds = [r["kind"] for r in fl.records()]
    assert kinds.count("repartition") == int(shipped) > 0
    assert kinds.count("resplit") == int(resplits)
    assert [r["round"] for r in fl.records()] == list(range(len(kinds)))
    assert all(KIND_BUCKET[k] in BUCKETS for k in kinds)


def test_fused_q1_has_no_exchange_rounds(tpch):
    """Q1's stats-bounded grouped aggregation rides the fused wave
    programs and the gathered finisher: no partial state crosses a
    repartition round."""
    tpch.execute(Q1, properties=_props(4))
    ship0 = _value("exchange_repartitions_total")
    _, fl = _fly(tpch, Q1, 4, warm=False)
    assert _value("exchange_repartitions_total") == ship0
    kinds = [r["kind"] for r in fl.records()]
    assert kinds.count("repartition") == 0
    assert kinds.count("dispatch") > 0
    a = fl.attribution
    assert a["device_rounds"] >= a["rounds"]


def test_explain_analyze_matches_system_table(tpch):
    res = tpch.execute("explain analyze " + Q1, properties=_props(2))
    text = "\n".join(r[0] for r in res.rows)
    assert "Mesh rounds:" in text
    assert "Mesh verdict:" in text and "dominates" in text
    fl = FLIGHTS.last()
    m = re.search(r"Mesh rounds: (\d+) rounds on (\d+) devices", text)
    assert m and int(m.group(1)) == fl.attribution["rounds"]
    assert int(m.group(2)) == 2
    # the statement's query id names the flight
    assert fl.query_id == tpch.query_log[-1].query_id
    rows = tpch.execute(
        "select round, stage, kind, bucket, rows, bytes, loads, rounds "
        "from system.runtime.mesh_rounds "
        f"where query_id = '{fl.query_id}'").rows
    assert len(rows) == fl.attribution["rounds"]
    printed = re.findall(
        r"^\s+(\d+)\s+(-?\d+)\s+(\w+)\s+(\w+)\s+[\d,.]+\s+(\d+)"
        r"\s+(\d+)\s*(\S*)\s+(\d+)\s*$", text, re.M)
    assert len(printed) == min(len(rows), 48)
    for p, r in zip(printed, rows):
        assert (int(p[0]), int(p[1]), p[2], p[3]) == \
            (r[0], r[1], r[2], r[3])
        assert (int(p[4]), int(p[5])) == (r[4], r[5])
        assert p[6] == (r[6] or "")
        assert int(p[7]) == r[7]


def test_completed_queries_carries_attribution(tpch):
    _, fl = _fly(tpch, Q1, 2, warm=False)
    rows = tpch.execute(
        "select mesh_rounds, mesh_dominant_bucket, mesh_overhead_ms, "
        "mesh_buckets from system.runtime.completed_queries "
        f"where query_id = '{fl.query_id}'").rows
    want = json.dumps(fl.attribution["buckets"], sort_keys=True)
    ours = [r for r in rows if r[3] == want]
    assert len(ours) == 1, rows
    rounds, dominant, overhead_ms, buckets_json = ours[0]
    assert rounds == fl.attribution["rounds"]
    assert dominant == fl.attribution["dominant_bucket"]
    assert overhead_ms == pytest.approx(
        fl.attribution["overhead_s"] * 1e3, abs=0.01)
    assert sorted(json.loads(buckets_json)) == sorted(BUCKETS)
    # non-mesh queries carry the zero/NULL tail, not stale data
    tpch.execute("select 17 * 3")
    rows = tpch.execute(
        "select mesh_rounds, mesh_dominant_bucket from "
        "system.runtime.completed_queries "
        "where query = 'select 17 * 3'").rows
    assert rows[-1][0] == 0 and rows[-1][1] is None


def test_injected_repartition_sleep_attributed(tpch):
    _, green = _fly(tpch, QJOIN, 2, **_QJOIN_PROPS)
    FAILPOINTS.configure("mesh.repartition", action="sleep",
                         sleep_s=1.0, times=1)
    try:
        _, red = _fly(tpch, QJOIN, 2, warm=False, **_QJOIN_PROPS)
    finally:
        FAILPOINTS.clear("mesh.repartition")
    g = green.attribution["buckets"]
    r = red.attribution["buckets"]
    assert r["repartition"] - g["repartition"] >= 0.5, (g, r)
    for other in ("control_sync", "stall", "host_staging"):
        assert r[other] - g[other] < 0.5, (other, g, r)


def test_recorder_overhead_under_one_percent(tpch):
    _, fl = _fly(tpch, Q1, 2, warm=False)
    a = fl.attribution
    bench = FlightRecorder("overhead_bench", 4)
    n = 5000
    t0 = time.perf_counter()
    for _ in range(n):
        bench.record("dispatch", stage=1, wall=1e-4, rows=10, nbytes=100)
    per_record = (time.perf_counter() - t0) / n
    assert per_record * a["rounds"] < 0.01 * a["wall_s"], \
        (per_record, a["rounds"], a["wall_s"])
    t0 = time.perf_counter()
    bench.finish(1.0)
    per_record_finish = (time.perf_counter() - t0) / n
    assert per_record_finish * a["rounds"] < 0.01 * a["wall_s"]


def test_mesh_flight_off_skips_recording(tpch):
    flights0 = _value("mesh_flight_queries_total")
    last0 = FLIGHTS.last()
    res = tpch.execute(Q1, properties=_props(2, mesh_flight=False))
    assert res.rows
    assert _value("mesh_flight_queries_total") == flights0
    assert FLIGHTS.last() is last0
    res = tpch.execute("explain analyze " + Q1,
                       properties=_props(2, mesh_flight=False))
    assert "Mesh rounds:" not in "\n".join(r[0] for r in res.rows)


def test_metric_families_populated(tpch):
    _fly(tpch, Q1, 2, warm=False)
    _fly(tpch, QJOIN, 2, warm=False, **_QJOIN_PROPS)
    assert _value("mesh_flight_queries_total") > 0
    assert _value("mesh_rounds_total") > 0
    assert REGISTRY.histogram("mesh_round_seconds").state()["count"] > 0
    assert _value("mesh_attr_dispatch_overhead_seconds_total") > 0
    assert _value("mesh_attr_repartition_seconds_total") > 0
    assert _value("mesh_flight_overhead_seconds_total") > 0
    assert _value("mesh_path_selected_total") > 0
    assert _value("mesh_dispatches_total") > 0
    assert _value("mesh_dispatches_total.agg") > 0
    for b in BUCKETS:
        assert _value(f"mesh_attr_{b}_seconds_total") >= 0.0


def test_chrome_trace_track(tpch):
    _, fl = _fly(tpch, Q1, 2, warm=False)
    events = chrome_events(fl)
    names = [e for e in events if e["ph"] == "M"]
    slices = [e for e in events if e["ph"] == "X"]
    assert len(names) == len(BUCKETS) + 1
    assert len(slices) == fl.attribution["rounds"]
    assert all(e["dur"] > 0 for e in slices)
    # the query's trace carries the mesh rounds beside its spans
    span = {"name": "query", "node": "n", "start": 0.0, "end": 1.0,
            "traceId": "t", "attrs": {"query_id": fl.query_id}}
    doc = chrome_trace([span])
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == \
        1 + len(slices)
    assert len(chrome_trace([span], flights=[])["traceEvents"]) < \
        len(doc["traceEvents"])


def test_history_fields_shape():
    assert flight.history_fields(None) == {}
    a = {"rounds": 3, "dominant_bucket": "repartition",
         "overhead_s": 0.5,
         "buckets": {b: 0.0 for b in BUCKETS}}
    f = flight.history_fields(a)
    assert f == jflight.history_fields(a)
    assert f["mesh_rounds"] == 3
    assert f["mesh_overhead_ms"] == 500.0


def test_tables_equal_reference():
    assert flight.BUCKETS == jflight.BUCKETS
    assert flight.KIND_BUCKET == jflight.KIND_BUCKET
    assert flight.ROUND_COLUMNS == jflight.ROUND_COLUMNS


def _replay(mod, records, n):
    fl = mod.FlightRecorder("q_same", n)
    for r in records:
        fl.record(r[0], wall=r[1], rows=r[2], nbytes=r[3], loads=r[4],
                  t_start=100.0 + r[1], rounds=r[5])
    return fl


def test_attribution_equals_reference_on_the_same_rounds():
    """The same round records give the same attribution, round rows and
    Chrome events in both recorders."""
    recs = [("dispatch", 0.010, 0, 0, None, 1),
            ("stall", 0.002, 0, 0, None, 1),
            ("repartition", 0.030, 40, 800, (10, 20, 5, 5), 1),
            ("staging", 0.004, 12, 96, (3, 3, 3, 3), 1),
            ("sync", 0.001, 0, 0, None, 1),
            ("resplit", 0.0005, 40, 0, (10, 10, 10, 10), 1),
            ("dispatch", 0.020, 0, 0, None, 8),
            ("drain", 0.003, 0, 0, None, 1)]
    got = _replay(flight, recs, 4)
    want = _replay(jflight, recs, 4)
    ga, wa = got.finish(0.08), want.finish(0.08)
    assert ga == wa
    assert flight.round_rows("q", got.records()) == \
        jflight.round_rows("q", want.records())
    assert chrome_events(got) == jflight.chrome_events(want)
