"""The SLO plane of presto_tpu_torch (obs/slo.py, obs/signals.py)
against presto_tpu: burn-rate math against hand-computed fixtures, the
OK/WARN/PAGE state machine's hysteresis, per-group objective parsing,
the alert-rule registry, the signals feed, the same synthetic traffic
through both packages' trackers giving the same rows, and an end-to-end
drill: queries admitted through a resource group with a latency
objective, slowed by the fair scheduler's service floor, firing WARN
then PAGE and recovering, visible through ``system.runtime.alerts`` over
plain SQL. The front door's latency record is made by the test, as the
server makes it; the statement server's own drill is in
tests/test_torch_protocol.py. The autoscale watcher's contract test runs
the port's watcher against the reference tool's decisions.

Burn windows and evaluation instants are synthetic throughout
(``now=`` everywhere), so window arithmetic is deterministic.
"""
import dataclasses

import pytest

from presto_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from presto_tpu_torch.obs.slo import (
    ALERT_RULES, CLEAR_AFTER, EXIT_FRACTION, PAGE_ENTER_BURN,
    WARN_ENTER_BURN, SLO, SloObjective, SloTracker, _AlertState,
    alert_rule, burn_rate, objectives_from_spec,
)
from presto_tpu_torch.obs.timeseries import TIMESERIES, TimeSeriesStore


def _tracker():
    reg = MetricsRegistry()
    ts = TimeSeriesStore(registry=reg)
    return reg, ts, SloTracker(store=ts)


# -- burn-rate math (hand fixtures) -------------------------------------------

def test_burn_rate_formula():
    # 5% errors against a 95% objective: burning exactly at plan
    assert burn_rate(0.05, 0.95) == pytest.approx(1.0)
    # 2% errors against 99%: double plan
    assert burn_rate(0.02, 0.99) == pytest.approx(2.0)
    assert burn_rate(0.0, 0.99) == 0.0


def test_latency_error_fraction_hand_fixture():
    """10 good (1s) + 10 bad (3s) observations against a 2s target:
    the 2s threshold snaps UP to the bucket ladder's 2.5s bound, the
    error fraction is exactly 0.5, and at target 0.95 that is a 10x
    burn — the PAGE threshold."""
    reg, ts, tr = _tracker()
    h = reg.histogram("serving_latency_seconds.g")
    ts.sample(now=100.0)
    for _ in range(10):
        h.observe(1.0)
    for _ in range(10):
        h.observe(3.0)
    ts.sample(now=110.0)
    obj = SloObjective(group="g", objective="latency", target=0.95,
                       threshold_s=2.0)
    frac = tr._error_fraction(obj, 300.0, now=110.0)
    assert frac == pytest.approx(0.5)
    burns = tr.burns(obj, now=110.0)
    assert burns[300.0] == pytest.approx(10.0)
    assert burns[3600.0] == pytest.approx(10.0)


def test_latency_threshold_above_ladder_never_errors():
    reg, ts, tr = _tracker()
    h = reg.histogram("serving_latency_seconds.g")
    ts.sample(now=100.0)
    for _ in range(5):
        h.observe(10.0)
    ts.sample(now=110.0)
    obj = SloObjective(group="g", objective="latency", target=0.95,
                       threshold_s=500.0)   # beyond the 120s top bound
    assert tr._error_fraction(obj, 300.0, now=110.0) == 0.0


def test_availability_error_fraction_hand_fixture():
    """100 requests, 2 errors over the window against a 99% target:
    error fraction 0.02, burn 2.0 — the WARN threshold."""
    reg, ts, tr = _tracker()
    req = reg.counter("serving_requests_total.g")
    err = reg.counter("serving_errors_total.g")
    ts.sample(now=100.0)
    req.inc(100)
    err.inc(2)
    ts.sample(now=110.0)
    obj = SloObjective(group="g", objective="availability",
                       target=0.99)
    assert tr._error_fraction(obj, 300.0,
                              now=110.0) == pytest.approx(0.02)
    assert tr.burns(obj, now=110.0)[300.0] == pytest.approx(2.0)


def test_no_traffic_means_no_burn_data():
    _, ts, tr = _tracker()
    ts.sample(now=100.0)
    ts.sample(now=110.0)
    obj = SloObjective(group="g", objective="availability",
                       target=0.99)
    assert tr._error_fraction(obj, 300.0, now=110.0) is None


# -- objective parsing --------------------------------------------------------

def test_objectives_from_spec_normalized_block():
    objs = objectives_from_spec("serving.dash", {
        "latencyObjective": 0.95, "latencyTargetMs": 500.0,
        "availabilityObjective": 0.99, "windows": [60.0, 600.0]})
    by_kind = {o.objective: o for o in objs}
    lat = by_kind["latency"]
    assert lat.group == "serving.dash" and lat.target == 0.95
    assert lat.threshold_s == pytest.approx(0.5)
    assert lat.windows == (60.0, 600.0)
    assert lat.rule == "latency_burn"
    avail = by_kind["availability"]
    assert avail.target == 0.99 and avail.rule == "availability_burn"
    assert objectives_from_spec("g", None) == []


def test_group_config_slo_validation():
    from presto_tpu_torch.server.resource_groups import _parse_slo
    ok = _parse_slo({"latencyTargetMs": 250, "latencyObjective": 0.9})
    assert ok == {"latencyObjective": 0.9, "latencyTargetMs": 250.0}
    assert _parse_slo(None) is None
    with pytest.raises(ValueError):
        _parse_slo({"latencyObjective": 0.9})       # no target ms
    with pytest.raises(ValueError):
        _parse_slo({"availabilityObjective": 1.5})  # out of (0,1)
    with pytest.raises(ValueError):
        _parse_slo({})                              # no objective
    with pytest.raises(ValueError):
        _parse_slo({"availabilityObjective": 0.99,
                    "windows": [0.0]})              # bad window
    with pytest.raises(ValueError):
        _parse_slo("latency<1s")                    # not an object


# -- state machine hysteresis -------------------------------------------------

def _step_seq(burns, start="OK"):
    st = _AlertState(0.0)
    st.state = start
    out = []
    for b in burns:
        new = SloTracker._step(st, b)
        if new != st.state:
            st.state = new
            st.ok_streak = 0
        out.append(st.state)
    return out


def test_state_machine_escalates_immediately():
    assert _step_seq([0.5, 3.0, 12.0]) == ["OK", "WARN", "PAGE"]
    assert _step_seq([15.0]) == ["PAGE"]          # straight to PAGE


def test_state_machine_does_not_flap_at_the_threshold():
    """Burn oscillating just below the WARN entry threshold (but above
    the exit threshold, entry x 0.5) must NOT clear the alert."""
    assert WARN_ENTER_BURN * EXIT_FRACTION == pytest.approx(1.0)
    seq = _step_seq([3.0, 1.9, 1.1, 1.9, 1.1, 1.9], start="OK")
    assert seq == ["WARN"] * 6                    # held, no flapping


def test_state_machine_clears_after_consecutive_quiet_evals():
    assert CLEAR_AFTER == 2
    # one quiet eval is not enough; a burp resets the streak
    seq = _step_seq([3.0, 0.5, 1.5, 0.5, 0.5])
    assert seq == ["WARN", "WARN", "WARN", "WARN", "OK"]
    # PAGE exits against its own (higher) threshold: 10 x 0.5 = 5;
    # a burn still in WARN territory steps DOWN to WARN, not to OK
    seq = _step_seq([12.0, 4.0, 4.0])
    assert seq == ["PAGE", "PAGE", "WARN"]
    seq = _step_seq([12.0, 0.5, 0.5])
    assert seq == ["PAGE", "PAGE", "OK"]


def test_window_without_data_holds_alert_down():
    """A huge burn in one window but no data in the other must not
    page — no escalation without evidence in EVERY window."""
    reg, ts, tr = _tracker()
    h = reg.histogram("serving_latency_seconds.g")
    ts.sample(now=100.0)
    for _ in range(10):
        h.observe(50.0)                 # everything over threshold
    ts.sample(now=110.0)
    obj = SloObjective(group="g", objective="latency", target=0.95,
                       threshold_s=0.1, windows=(5.0, 3600.0))
    tr.objectives = lambda: [obj]       # bypass live-manager walk
    # the 5s window at now=110 has baseline 100 (at/before 105) and
    # end 110 -> burn 20; at now=200 the short window's baseline and
    # end collapse to the same sample -> no data -> held OK
    burns = tr.burns(obj, now=200.0)
    assert burns[3600.0] == pytest.approx(20.0)
    assert burns[5.0] is None
    tr.evaluate(now=200.0)
    assert tr.state_of("g", "latency") == "OK"


# -- the signals feed ---------------------------------------------------------

def test_cluster_signals_snapshot_is_frozen():
    from presto_tpu_torch.obs.signals import cluster_signals

    snap = cluster_signals(now=1000.0)
    assert snap.ts == 1000.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        snap.ts = 0.0
    assert snap.group("no.such.group") is None
    assert snap.node("no-such-node") is None
    # cache limits come from the live serving caches
    assert snap.caches.scan_cache_limit_bytes >= 0
    assert 0.0 <= snap.caches.plan_cache_pressure <= 1.0


def test_autoscale_watcher_consumes_the_feed():
    """The watcher (``_devtools/autoscale_watch.py``) exercises every
    classic rule against the synthetic snapshot: the feed's contract
    test, with the reference watcher's decisions."""
    import tools.autoscale_watch as ref_watch
    from presto_tpu_torch._devtools import autoscale_watch as watch

    decisions = watch.decide(watch.demo_signals())
    by_action = {}
    for d in decisions:
        by_action.setdefault(d["action"], []).append(d["target"])
    assert by_action["scale_up"] == ["serving.dash", "serving.adhoc"]
    assert by_action["scale_down"] == ["batch"]
    assert by_action["replace_node"] == ["w1"]
    assert by_action["grow_cache"] == ["scan_cache"]
    # every decision carries the signal values that justified it
    assert all("reason" in d and "signals" in d for d in decisions)
    # a paging group is never scaled down, even when idle
    paged = watch.demo_signals().group("serving.adhoc")
    assert paged.alert_state == "PAGE"
    assert "serving.adhoc" not in by_action["scale_down"]
    assert decisions == ref_watch.decide(ref_watch.demo_signals())


# -- end to end: failpoint latency spike through the whole plane --------------

@pytest.fixture
def health_plane():
    """The process-global plane (protocol records into REGISTRY; the
    system tables read TIMESERIES/SLO), reset around the test. An
    earlier test's server may have left the wall-clock sampler thread
    running and the tracker installed as a sample listener — stop the
    thread and drop listeners so only this test's synthetic clock and
    explicit evaluate() calls drive the plane (srv.start() re-installs
    for later tests)."""
    TIMESERIES.stop()
    TIMESERIES.reset(keep_listeners=False)
    SLO.reset()
    yield
    TIMESERIES.reset(keep_listeners=False)
    SLO.reset()


def test_evaluate_sets_burn_gauges_and_history(health_plane):
    """Gauges + the history ring (the bench slo block's feed) update
    on every evaluation pass."""
    reg, ts, tr = _tracker()
    req = reg.counter("serving_requests_total.g")
    err = reg.counter("serving_errors_total.g")
    ts.sample(now=100.0)
    req.inc(100)
    err.inc(3)
    ts.sample(now=110.0)
    obj = SloObjective(group="g", objective="availability",
                       target=0.99, windows=(300.0, 3600.0))
    tr.objectives = lambda: [obj]
    tr.evaluate(now=110.0)
    # note: gauges land on the GLOBAL registry (the exposition path),
    # keyed by group:objective:window
    g = REGISTRY.gauge("slo_burn_rate_ratio.g:availability:300s")
    assert g.value == pytest.approx(3.0)
    budget = REGISTRY.gauge("slo_error_budget_remaining_ratio."
                            "g:availability")
    assert budget.value == pytest.approx(0.0)    # 1 - 3.0, clamped
    hist = tr.history()
    assert hist and hist[-1]["group"] == "g"
    assert hist[-1]["burn"]["300"] == pytest.approx(3.0)
    assert hist[-1]["state"] == "WARN"


def test_alert_rule_registry():
    assert alert_rule("latency_burn") == "latency_burn"
    with pytest.raises(ValueError):
        alert_rule("typo_burn")
    from presto_tpu.obs.slo import ALERT_RULES as JRULES
    assert ALERT_RULES == JRULES


def test_failpoint_latency_spike_pages_and_recovers(health_plane):
    """The chaos drill: slow queries of a group with a latency
    objective drive its burn through WARN then PAGE; fast traffic
    recovers it to OK after the hysteresis streak, and the whole story
    is queryable via system.runtime.{slo,alerts,timeseries}."""
    from presto_tpu_torch.exec import taskexec
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.server.resource_groups import ResourceGroupManager
    from presto_tpu_torch.serving.groups import QueryServingContext

    runner = LocalRunner(tpch_sf=0.001, device="cpu")
    mgr = ResourceGroupManager({
        "rootGroups": [{"name": "sloe2e", "hardConcurrencyLimit": 4,
                        "slo": {"latencyTargetMs": 100.0,
                                "latencyObjective": 0.95,
                                "availabilityObjective": 0.99,
                                "windows": [5.0, 10.0]}}],
        "selectors": [{"group": "sloe2e"}]})
    sql = "select count(*) from nation"

    def serve(n, slow=False):
        # the front door's part: admit, run, record the served wall
        floor = taskexec.set_service_floor_ms(300.0 if slow else 0.0)
        try:
            for _ in range(n):
                adm = mgr.submit()
                assert adm.wait(10)
                ctx = QueryServingContext(adm.group)
                import time
                t0 = time.perf_counter()
                try:
                    runner.execute(sql, serving=ctx)
                    REGISTRY.counter(
                        "serving_requests_total.sloe2e").inc()
                finally:
                    REGISTRY.histogram(
                        "serving_latency_seconds.sloe2e").observe(
                            time.perf_counter() - t0)
                    ctx.close()
                    adm.release()
        finally:
            taskexec.set_service_floor_ms(floor)

    serve(2)                          # warm the plan outside any window
    TIMESERIES.sample(now=100.0)
    # phase 1: one slow request among eight fast -> ~2.2x burn
    serve(1, slow=True)
    serve(8)
    TIMESERIES.sample(now=101.0)
    transitions = SLO.evaluate(now=101.0)
    assert [(t["from"], t["to"]) for t in transitions] == [("OK", "WARN")]
    assert transitions[0]["rule"] == "latency_burn"
    # phase 2: every request slow -> 20x burn -> PAGE
    serve(4, slow=True)
    TIMESERIES.sample(now=115.0)
    transitions = SLO.evaluate(now=115.0)
    assert [(t["from"], t["to"]) for t in transitions] == [("WARN", "PAGE")]
    assert SLO.state_of("sloe2e", "latency") == "PAGE"
    # recovery: hysteresis holds the page for CLEAR_AFTER quiet passes
    serve(6)
    TIMESERIES.sample(now=130.0)
    assert SLO.evaluate(now=130.0) == []
    assert SLO.state_of("sloe2e", "latency") == "PAGE"
    TIMESERIES.sample(now=131.0)
    transitions = SLO.evaluate(now=131.0)
    assert [(t["from"], t["to"]) for t in transitions] == [("PAGE", "OK")]
    assert SLO.state_of("sloe2e", "availability") == "OK"

    res = runner.execute("select from_state, to_state, rule from "
                         "system.runtime.alerts")
    lat = [(f, t) for f, t, r in res.rows if r == "latency_burn"]
    assert lat == [("OK", "WARN"), ("WARN", "PAGE"), ("PAGE", "OK")]
    res = runner.execute(
        "select objective, state, budget_remaining from "
        "system.runtime.slo where group_path = 'sloe2e'")
    states = {o: (s, b) for o, s, b in res.rows}
    assert states["latency"][0] == "OK"
    assert states["availability"] == ("OK", 1.0)
    res = runner.execute(
        "select name, kind from system.runtime.timeseries "
        "where name = 'serving_latency_seconds.sloe2e.p95'")
    assert res.rows and res.rows[0][1] == "histogram"
    res = runner.execute(
        "select sampled_at from system.runtime.metrics limit 3")
    stamps = {r[0] for r in res.rows}
    assert len(stamps) == 1 and stamps.pop() > 0
    assert mgr.info()[0]["memoryReservedBytes"] == 0


def _tracker_story(pkg):
    """One synthetic traffic story through a package's own registry,
    store and tracker: every read surface it gives."""
    import importlib
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    ts_mod = importlib.import_module(f"{pkg}.obs.timeseries")
    slo = importlib.import_module(f"{pkg}.obs.slo")
    reg = metrics.MetricsRegistry()
    ts = ts_mod.TimeSeriesStore(registry=reg)
    tr = slo.SloTracker(store=ts)
    objs = [slo.SloObjective("g", "latency", 0.95, threshold_s=0.1,
                             windows=(5.0, 10.0)),
            slo.SloObjective("g", "availability", 0.99,
                             windows=(5.0, 10.0))]
    tr.objectives = lambda: objs
    h = reg.histogram("serving_latency_seconds.g")
    req = reg.counter("serving_requests_total.g")
    err = reg.counter("serving_errors_total.g")
    out = []
    t = 100.0
    ts.sample(now=t)
    for slow, n, errors in ((1, 9, 0), (4, 4, 1), (0, 6, 0), (0, 6, 0),
                            (2, 10, 0), (0, 3, 2)):
        for i in range(n):
            h.observe(0.3 if i < slow else 0.02)
        req.inc(n)
        err.inc(errors)
        t += 3.0
        ts.sample(now=t)
        out.append(tr.evaluate(now=t))
        out.append(tr.snapshot_rows(now=t))
    out += [tr.alert_rows(), tr.history(), ts.rows(),
            ts.window_quantile_rows(10.0, now=t)]
    return out


def test_tracker_story_equals_reference():
    """The same traffic gives the same transitions, objective rows,
    alert rows, history and derived series in both packages."""
    assert _tracker_story("presto_tpu_torch") == _tracker_story("presto_tpu")
