"""The time-series plane of presto_tpu_torch (obs/timeseries.py) and
its exposition (obs/exposition.py) against presto_tpu: counter rates,
windowed histogram quantiles, retention rings, the range/reduce API,
the metrics-history document, the system.runtime.timeseries table feed
and the sampler's own overhead budget (the cases of
tests/test_timeseries.py but the servers' history route, whose
coordinator half is in tests/test_torch_protocol.py);
the Prometheus text round trip of tests/test_obs_ops.py; and the same
synthetic series through both packages' stores and renderers giving the
same reads and the same text, bit for bit.

Everything runs against a private MetricsRegistry + TimeSeriesStore
with synthetic ``now`` values, so windows are deterministic: no sleeps,
no wall-clock flake.
"""
import threading

import pytest

from presto_tpu_torch.obs.metrics import MetricsRegistry
from presto_tpu_torch.obs.timeseries import (
    DEFAULT_RETENTION_POINTS, DEFAULT_SAMPLE_INTERVAL_S,
    TimeSeriesStore, _per_bucket, _window_pair,
)


def _store(retention: int = 64, interval: float = 1.0):
    reg = MetricsRegistry()
    ts = TimeSeriesStore(registry=reg)
    ts.configure(sample_interval_s=interval, retention_points=retention)
    return reg, ts


# -- primitives ---------------------------------------------------------------

def test_per_bucket_from_cumulative():
    assert _per_bucket((0, 3, 3, 10)) == [0, 3, 0, 7]
    assert _per_bucket(()) == []


def test_window_pair_needs_two_distinct_samples():
    assert _window_pair([], 60.0, 100.0) is None
    assert _window_pair([(99.0, 1.0)], 60.0, 100.0) is None
    # two points inside the window: earliest is the baseline
    base, end = _window_pair([(50.0, 1.0), (99.0, 5.0)], 60.0, 100.0)
    assert base == (50.0, 1.0) and end == (99.0, 5.0)
    # a point at/before now-window becomes the baseline instead
    base, end = _window_pair(
        [(30.0, 1.0), (50.0, 2.0), (99.0, 5.0)], 50.0, 100.0)
    assert base == (50.0, 2.0) and end == (99.0, 5.0)


# -- counters + gauges --------------------------------------------------------

def test_counter_windowed_rate():
    reg, ts = _store()
    c = reg.counter("req_total")
    for i in range(11):
        c.inc(6)                      # 6/sample at 1s spacing
        ts.sample(now=100.0 + i)
    assert ts.rate("req_total", 10.0, now=110.0) == pytest.approx(6.0)
    # the range API agrees with the dedicated accessor
    assert ts.range("req_total", 10.0, reduce="rate",
                    now=110.0) == pytest.approx(6.0)
    # outside any data: None, not garbage
    assert ts.rate("req_total", 10.0, now=500.0) is None
    assert ts.rate("nope_total", 10.0, now=110.0) is None


def test_gauge_reducers_and_unknown_reducer():
    reg, ts = _store()
    g = reg.gauge("depth")
    for i, v in enumerate((1.0, 5.0, 3.0)):
        g.set(v)
        ts.sample(now=100.0 + i)
    assert ts.range("depth", 60.0, reduce="max", now=102.0) == 5.0
    assert ts.range("depth", 60.0, reduce="avg",
                    now=102.0) == pytest.approx(3.0)
    assert ts.range("depth", 60.0, reduce="sum",
                    now=102.0) == pytest.approx(9.0)
    with pytest.raises(ValueError):
        ts.range("depth", 60.0, reduce="median", now=102.0)


def test_registry_reset_mid_run_yields_none_not_negative():
    reg, ts = _store()
    c = reg.counter("req_total")
    c.inc(100)
    ts.sample(now=100.0)
    ts.sample(now=101.0)
    reg.reset()                       # counter back to 0 in place
    reg.counter("req_total").inc(1)
    ts.sample(now=102.0)
    # the window spanning the reset has a negative delta — reported as
    # "unknown", never as a negative rate
    assert ts.rate("req_total", 10.0, now=102.0) is None


# -- windowed histogram quantiles ---------------------------------------------

def test_windowed_quantile_diverges_from_lifetime():
    """A latency spike AFTER a long quiet history: the lifetime p95
    still reads fast, the 5m-windowed p95 reads the spike — the whole
    reason the plane exists."""
    reg, ts = _store()
    h = reg.histogram("lat_seconds")
    for _ in range(10_000):
        h.observe(0.01)               # long fast history
    ts.sample(now=100.0)
    for _ in range(100):
        h.observe(1.0)                # recent spike (1% of lifetime)
    ts.sample(now=160.0)
    lifetime_p95 = h.quantile(0.95)
    windowed = ts.window_quantile("lat_seconds", 120.0, 0.95,
                                  now=160.0)
    assert lifetime_p95 == pytest.approx(0.01, abs=0.01)
    assert windowed is not None and windowed > 0.5
    # window with only the quiet prefix: no second sample, None
    assert ts.window_quantile("lat_seconds", 120.0, 0.95,
                              now=100.0) is None


def test_window_counts_are_cumulative_deltas():
    reg, ts = _store()
    h = reg.histogram("q_seconds")
    h.observe(0.01)
    ts.sample(now=10.0)
    for _ in range(3):
        h.observe(0.01)
    h.observe(50.0)
    ts.sample(now=20.0)
    dc, dsum, cum, bounds = ts.window_counts("q_seconds", 60.0,
                                             now=20.0)
    assert dc == 4
    assert dsum == pytest.approx(3 * 0.01 + 50.0)
    # cumulative within the window: every 0.01 obs is ≤ every bound,
    # the 50s obs only lands at/above the 60s bound
    assert cum[bounds.index(0.025)] == 3
    assert cum[bounds.index(60.0)] == 4
    assert list(cum) == sorted(cum)


def test_quantile_rows_for_metrics_table():
    reg, ts = _store()
    h = reg.histogram("query_seconds")
    for _ in range(10):
        h.observe(0.2)
    ts.sample(now=100.0)
    for _ in range(90):
        h.observe(0.2)
    ts.sample(now=200.0)
    rows = dict(ts.window_quantile_rows(window=300.0, now=200.0))
    for tag in ("p50_5m", "p95_5m", "p99_5m"):
        assert f"query_seconds.{tag}" in rows
        assert rows[f"query_seconds.{tag}"] == pytest.approx(0.2,
                                                             abs=0.15)


# -- retention ----------------------------------------------------------------

def test_retention_ring_is_bounded():
    reg, ts = _store(retention=16)
    g = reg.gauge("depth")
    for i in range(10_000):           # a long run: 625x the ring
        g.set(float(i))
        ts.sample(now=float(i))
    pts = ts.points("depth")
    assert len(pts) == 16
    assert pts[-1] == (9999.0, 9999.0)
    assert pts[0][0] == 9984.0        # oldest retained, not oldest ever


def test_configure_shrinks_existing_rings():
    reg, ts = _store(retention=32)
    g = reg.gauge("depth")
    for i in range(32):
        g.set(float(i))
        ts.sample(now=float(i))
    ts.configure(retention_points=4)
    assert ts.retention_points == 4
    assert len(ts.points("depth")) == 4
    assert ts.points("depth")[-1][1] == 31.0


# -- federated points + sampler lifecycle -------------------------------------

def test_record_federated_point():
    _, ts = _store()
    ts.record("node_active_tasks.w1", 3.0, now=50.0)
    ts.record("node_active_tasks.w1", 5.0, now=51.0)
    assert ts.kind("node_active_tasks.w1") == "gauge"
    assert ts.range("node_active_tasks.w1", 60.0, reduce="max",
                    now=51.0) == 5.0


def test_env_kill_switch(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_TIMESERIES", "off")
    reg = MetricsRegistry()
    ts = TimeSeriesStore(registry=reg)
    assert ts.ensure_started() is False
    ts.stop()


def test_sampler_thread_runs_and_stops():
    reg, ts = _store(interval=0.05)
    reg.counter("beat_total").inc()
    assert ts.ensure_started() is True
    assert ts.ensure_started() is True    # idempotent
    deadline = threading.Event()
    for _ in range(100):
        if len(ts.points("beat_total")) >= 2:
            break
        deadline.wait(0.05)
    ts.stop()
    assert len(ts.points("beat_total")) >= 2
    # the sampler meters itself on the sampled registry
    assert reg.counter("timeseries_samples_total").value >= 2


def test_sampler_overhead_under_one_percent():
    """The plane must be free: average sample() cost over a registry
    of realistic size stays under 1% of the default 5s cadence."""
    import time as _time

    reg, ts = _store()
    for i in range(40):
        reg.counter(f"c{i}_total").inc(i)
        reg.gauge(f"g{i}_bytes").set(i)
    for i in range(20):
        h = reg.histogram(f"h{i}_seconds")
        for j in range(50):
            h.observe(0.001 * (j + 1))
    rounds = 200
    t0 = _time.perf_counter()
    for i in range(rounds):
        ts.sample(now=float(i))
    per_sample = (_time.perf_counter() - t0) / rounds
    assert per_sample < 0.01 * DEFAULT_SAMPLE_INTERVAL_S, \
        f"sample() cost {per_sample * 1e3:.2f}ms"


# -- history doc (the metrics-history payload) --------------------------------

def test_history_doc_contract():
    import time as _time

    reg, ts = _store()
    c = reg.counter("req_total")
    # the doc's window ends at the wall clock (it serves live HTTP
    # requests), so anchor the synthetic samples just behind it
    t0 = _time.time() - 4.0
    for i in range(5):
        c.inc(10)
        ts.sample(now=t0 + i)

    code, doc = ts.history_doc("")
    assert code == 400 and "series" in doc

    code, doc = ts.history_doc("name=unknown_total")
    assert code == 404

    code, doc = ts.history_doc("name=req_total&window=60")
    assert code == 200
    assert doc["name"] == "req_total" and doc["kind"] == "counter"
    assert doc["window_s"] == 60.0
    # counters plot as per-interval rates: 5 samples -> 4 points
    assert len(doc["points"]) == 4
    assert all(len(p) == 2 for p in doc["points"])
    assert doc["points"][-1][1] == pytest.approx(10.0)

    code, doc = ts.history_doc("name=req_total&window=60&reduce=rate")
    assert code == 200 and doc["reduce"] == "rate"
    assert doc["reduced"] == pytest.approx(10.0)

    code, doc = ts.history_doc("name=req_total&window=banana")
    assert code == 400


def test_rows_feed_for_system_table():
    reg, ts = _store()
    c = reg.counter("req_total")
    g = reg.gauge("depth")
    h = reg.histogram("lat_seconds")
    for i in range(4):
        c.inc(5)
        g.set(float(i))
        h.observe(0.1)
        ts.sample(now=100.0 + i)
    rows = ts.rows(now=103.0)
    by_name = {}
    for name, kind, t, value in rows:
        by_name.setdefault(name, []).append((kind, t, value))
    # gauges verbatim, counters as per-interval rates, histograms as
    # rate + derived windowed quantiles
    assert [v for _, _, v in by_name["depth"]] == [0.0, 1.0, 2.0, 3.0]
    assert all(k == "counter" for k, _, _ in by_name["req_total.rate"])
    assert by_name["req_total.rate"][-1][2] == pytest.approx(5.0)
    assert "lat_seconds.rate" in by_name
    assert "lat_seconds.p95" in by_name
    ts_sorted = sorted(rows, key=lambda r: (r[0], r[2]))
    assert ts_sorted == rows


# -- exposition: windowed gauges ----------------------------------------------

def test_exposition_carries_windowed_quantile_gauges():
    """The exposition grows `<family>_p95_5m`-style gauges for every
    histogram the GLOBAL store has windowed data on (and only when
    rendering the global registry — private registries stay clean)."""
    import time as _time

    from presto_tpu_torch.obs.exposition import render_exposition
    from presto_tpu_torch.obs.timeseries import TIMESERIES

    TIMESERIES.reset()
    try:
        h = TIMESERIES.registry.histogram("expo_win_seconds")
        t0 = _time.time() - 2.0
        h.observe(0.2)
        TIMESERIES.sample(now=t0)
        for _ in range(50):
            h.observe(0.2)
        TIMESERIES.sample(now=t0 + 1.0)
        text = render_exposition(TIMESERIES.registry)
        for tag in ("p50_5m", "p95_5m", "p99_5m"):
            assert f"expo_win_seconds_{tag}" in text
        # a private registry never leaks the global store's series
        other = MetricsRegistry()
        other.counter("lonely_total").inc()
        assert "expo_win_seconds_p95_5m" not in render_exposition(other)
    finally:
        TIMESERIES.reset()


# -- defaults sanity ----------------------------------------------------------

def test_defaults_match_documented_config():
    assert DEFAULT_SAMPLE_INTERVAL_S == 5.0
    assert DEFAULT_RETENTION_POINTS == 360   # 30 min at 5s


# -- exposition round trip (tests/test_obs_ops.py) ------------------------------

def test_exposition_round_trip():
    from presto_tpu_torch.obs.exposition import (
        parse_exposition, render_exposition,
    )
    reg = MetricsRegistry()
    reg.counter("c_total").inc(3)
    reg.counter("op_total.scan").inc(2)      # dotted name -> label
    reg.gauge("g_bytes").set(5)
    for v in (0.01, 0.2, 3.0):
        reg.histogram("h_seconds").observe(v)
    text = render_exposition(reg)
    assert text.rstrip().endswith("# EOF")
    samples, types = parse_exposition(text)
    assert types["c_total"] == "counter"
    assert types["op_total"] == "counter"
    assert types["g_bytes"] == "gauge"
    assert types["h_seconds"] == "histogram"
    assert types["h_seconds_quantile"] == "gauge"
    assert samples[("c_total", ())] == 3
    assert samples[("op_total", (("key", "scan"),))] == 2
    assert samples[("g_bytes", ())] == 5
    assert samples[("h_seconds_count", ())] == 3
    assert samples[("h_seconds_sum", ())] == pytest.approx(3.21)
    assert samples[("h_seconds_bucket", (("le", "+Inf"),))] == 3
    buckets = sorted(
        ((dict(lbl)["le"], v) for (n, lbl), v in samples.items()
         if n == "h_seconds_bucket"), key=lambda kv: float(kv[0]))
    counts = [v for _, v in buckets]
    assert counts == sorted(counts)


def test_parse_exposition_rejects_garbage():
    from presto_tpu_torch.obs.exposition import parse_exposition
    with pytest.raises(ValueError):
        parse_exposition("not a sample line at all {")
    with pytest.raises(ValueError):
        parse_exposition('x{bad-label="1"} 2')


def test_node_series_in_exposition():
    from presto_tpu_torch.obs.exposition import (
        parse_exposition, render_exposition,
    )
    from presto_tpu_torch.obs.metrics import NodeRegistry
    nodes = NodeRegistry()
    nodes.update("w1", state="ACTIVE", active_tasks=2,
                 hbm_in_use_bytes=7, hbm_peak_bytes=9)
    samples, _ = parse_exposition(render_exposition(MetricsRegistry(),
                                                    nodes))
    assert samples[("node_up", (("node", "w1"),))] == 1.0
    assert samples[("node_active_tasks", (("node", "w1"),))] == 2.0
    assert samples[("node_hbm_in_use_bytes", (("node", "w1"),))] == 7.0


def _series_story(pkg):
    """One synthetic series story through a package's own registry and
    store: every read and the rendered exposition text."""
    import importlib
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    ts_mod = importlib.import_module(f"{pkg}.obs.timeseries")
    expo = importlib.import_module(f"{pkg}.obs.exposition")
    reg = metrics.MetricsRegistry()
    ts = ts_mod.TimeSeriesStore(registry=reg)
    ts.configure(sample_interval_s=1.0, retention_points=16)
    c, g = reg.counter("req_total.dash"), reg.gauge("depth")
    h = reg.histogram("lat_seconds.dash")
    for i in range(24):
        c.inc(3 + i % 4)
        g.set(float(i % 5))
        for j in range(1 + i % 3):
            h.observe(0.003 * (i + 1) * (j + 1))
        ts.sample(now=1000.0 + 2.0 * i)
    now = 1046.0
    out = [ts.rows(now=now), ts.window_quantile_rows(30.0, now=now),
           ts.series_names()]
    for w in (5.0, 20.0, 100.0):
        out.append([ts.rate("req_total.dash", w, now=now),
                    ts.window_counts("lat_seconds.dash", w, now=now),
                    ts.window_quantile("lat_seconds.dash", w, 0.9,
                                       now=now),
                    ts.derived_points("lat_seconds.dash", w, now=now),
                    [ts.range("depth", w, r, now=now)
                     for r in ("sum", "avg", "max")],
                    ts.range("lat_seconds", w, "quantile",
                             labels="dash", now=now)])
    out.append(expo.render_exposition(reg))
    return out


def test_series_story_equals_reference():
    assert _series_story("presto_tpu_torch") == _series_story("presto_tpu")


def test_node_config_sizes_the_caches_and_the_sampler():
    """``config.apply_node_config`` applies the JAX package's
    ``config.properties`` keys of the result cache, the scan cache and
    the time-series sampler."""
    from presto_tpu_torch.config import NODE_CONFIG_KEYS, apply_node_config
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    from presto_tpu_torch.serving.resultcache import RESULTS
    saved = (RESULTS.pool.limit, CACHE.limit_bytes,
             TIMESERIES.sample_interval_s, TIMESERIES.retention_points)
    try:
        apply_node_config({"result-cache.max-bytes": "12345",
                           "scan-cache.max-bytes": str(3 << 30),
                           "timeseries.sample-interval-s": "0.5",
                           "timeseries.retention-points": "90"})
        assert RESULTS.pool.limit == 12345
        assert CACHE.limit_bytes == 3 << 30
        assert TIMESERIES.sample_interval_s == 0.5
        assert TIMESERIES.retention_points == 90
        apply_node_config({})               # absent keys change nothing
        assert RESULTS.pool.limit == 12345
    finally:
        RESULTS.set_limit(saved[0])
        CACHE.set_limit(saved[1])
        TIMESERIES.configure(sample_interval_s=saved[2],
                             retention_points=saved[3])
    assert set(NODE_CONFIG_KEYS) == {
        "scan-cache.max-bytes", "result-cache.max-bytes",
        "timeseries.sample-interval-s", "timeseries.retention-points"}
