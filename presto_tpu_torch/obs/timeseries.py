"""In-process, fixed-memory time-series plane over the metrics registry.

The counterpart of ``presto_tpu/obs/timeseries.py``.

Every other observability surface in the repo is a *snapshot*: the
``/v1/metrics`` exposition and ``system.runtime.metrics`` render whatever
the counters/gauges/histograms hold *right now*, and histogram quantiles
are derived from process-lifetime cumulative bucket counts — a latency
spike vanishes into the lifetime average within minutes.  This module
adds the time axis (the Monarch insight: control loops and SLO
enforcement consume *windowed* series, never raw counters):

- a background **sampler** (``timeseries.sample-interval-s`` config key,
  default 5s) snapshots :data:`presto_tpu_torch.obs.metrics.REGISTRY` into
  typed series, each a bounded ring (``timeseries.retention-points``,
  default 360 points = 30 min at the default cadence) so memory is fixed
  no matter how long the process lives;
- **counters** become windowed *rates* via successive-sample deltas;
- **gauges** sample directly;
- **histograms** store cumulative ``(count, sum, bucket_counts)``
  tuples, and windowed quantiles are derived by *differencing* the
  cumulative bucket counts between the window's first and last samples —
  "p95 over the last 5 minutes" finally means what it says;
- :meth:`TimeSeriesStore.range` reads any series back with
  ``sum/avg/max/rate/quantile`` reducers;
- :meth:`TimeSeriesStore.record` accepts externally-fed points so a
  coordinator can federate worker-side series that arrive through its
  heartbeat/poll path.

Deliberate non-goals: no persistence, no cross-process aggregation
protocol, no downsampling tiers.  The store is one process's bounded
ring; federation is "the coordinator records what heartbeats told it".

Windowed-delta semantics (shared by ``rate`` and ``quantile``): the
baseline is the latest sample at or before ``now - window`` (so a full
window is covered when history allows) or, failing that, the earliest
sample inside the window; the end point is the latest sample at or
before ``now``.  At least two distinct samples are required — otherwise
the reducer reports ``None`` rather than inventing a number.

Everything is import-safe and near-free when idle: no thread runs until
:meth:`TimeSeriesStore.ensure_started` (a server calls it at startup;
``PRESTO_TPU_TORCH_TIMESERIES=off`` disables it) and an unstarted store
costs one dict.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .._devtools.lockcheck import checked_lock
from .metrics import REGISTRY, MetricsRegistry, _quantile

DEFAULT_SAMPLE_INTERVAL_S = 5.0
DEFAULT_RETENTION_POINTS = 360

_REDUCERS = ("sum", "avg", "max", "rate", "quantile")


class _Series:
    """One named series: a bounded ring of ``(t, value)`` points.

    ``kind`` is the registry kind ("counter" | "gauge" | "histogram").
    Counter/gauge points hold a float; histogram points hold the
    cumulative ``(count, sum, bucket_counts)`` tuple so windowed
    quantiles can be derived by differencing.
    """

    __slots__ = ("name", "kind", "points", "bounds")

    def __init__(self, name: str, kind: str, retention: int,
                 bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.kind = kind
        self.points: deque = deque(maxlen=retention)
        self.bounds = bounds  # histogram bucket bounds (finite ones)


def _per_bucket(cumulative: Sequence[int]) -> List[int]:
    """Cumulative bucket counts -> per-bucket counts (what
    :func:`presto_tpu_torch.obs.metrics._quantile` consumes)."""
    out: List[int] = []
    prev = 0
    for c in cumulative:
        out.append(max(0, c - prev))
        prev = c
    return out


def _window_pair(points: Sequence[Tuple[float, object]], window: float,
                 now: float):
    """(baseline, end) points for a windowed delta, or ``None``.

    Baseline prefers the latest point at or before ``now - window``
    (full-window coverage); otherwise the earliest point inside the
    window.  End is the latest point at or before ``now``.  Tolerates
    out-of-order timestamps (federated points and synthetic test
    clocks interleave with the wall-clock sampler).
    """
    start = now - window
    base = None
    end = None
    first_in = None
    for pt in points:
        t = pt[0]
        if t > now:
            continue
        if t <= start:
            if base is None or t >= base[0]:
                base = pt
        elif first_in is None or t < first_in[0]:
            first_in = pt
        if end is None or t >= end[0]:
            end = pt
    if base is None:
        base = first_in
    if base is None or end is None or end[0] <= base[0]:
        return None
    return base, end


class TimeSeriesStore:
    """Bounded in-memory store of typed series sampled from a registry."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self._registry = registry if registry is not None else REGISTRY
        self._lock = checked_lock("timeseries.store")
        self._series: Dict[str, _Series] = {}
        self._retention = DEFAULT_RETENTION_POINTS
        self._interval = DEFAULT_SAMPLE_INTERVAL_S
        self._listeners: List[Callable[[float], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        env = os.environ.get("PRESTO_TPU_TORCH_TIMESERIES",
                             "").strip().lower()
        self._enabled = env not in ("off", "0", "false")

    # -- configuration ------------------------------------------------------

    def configure(self, sample_interval_s: Optional[float] = None,
                  retention_points: Optional[int] = None) -> None:
        """Set sampler cadence / per-series ring size.

        Shrinking ``retention_points`` re-rings existing series (keeps
        the newest points); growing applies on the next append.
        """
        with self._lock:
            if sample_interval_s is not None:
                self._interval = max(0.05, float(sample_interval_s))
            if retention_points is not None:
                retention = max(2, int(retention_points))
                if retention != self._retention:
                    self._retention = retention
                    for s in self._series.values():
                        s.points = deque(s.points, maxlen=retention)

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    @property
    def sample_interval_s(self) -> float:
        return self._interval

    @property
    def retention_points(self) -> int:
        return self._retention

    def add_listener(self, fn: Callable[[float], None]) -> None:
        """Register ``fn(now)`` to run after every sampler tick (used by
        the SLO tracker).  Idempotent per function object."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    # -- ingest -------------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> float:
        """Snapshot the registry into the rings; returns the timestamp.

        Collects outside the store lock (the registry has its own), then
        appends under it.  Also invoked by the background sampler; tests
        drive it directly with an explicit ``now`` for synthetic time.
        """
        t = time.time() if now is None else float(now)
        collected = self._registry.collect()
        with self._lock:
            for state in collected:
                name = state["name"]
                kind = state["kind"]
                s = self._series.get(name)
                if kind == "histogram":
                    buckets = state["buckets"]
                    if s is None:
                        bounds = tuple(le for le, _ in buckets
                                       if le != float("inf"))
                        s = _Series(name, kind, self._retention, bounds)
                        self._series[name] = s
                    value = (int(state["count"]), float(state["sum"]),
                             tuple(c for _, c in buckets))
                else:
                    if s is None:
                        s = _Series(name, kind, self._retention)
                        self._series[name] = s
                    value = float(state["value"])
                s.points.append((t, value))
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(t)
            except Exception:
                pass
        return t

    def record(self, name: str, value: float, now: Optional[float] = None,
               kind: str = "gauge") -> None:
        """Append one externally-fed point (coordinator federation of
        worker series arriving via heartbeats)."""
        t = time.time() if now is None else float(now)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = _Series(name, kind, self._retention)
                self._series[name] = s
            s.points.append((t, float(value)))

    # -- background sampler -------------------------------------------------

    def ensure_started(self) -> bool:
        """Start the daemon sampler once per process (idempotent).

        Returns True when a sampler is (now) running; False when the
        store is disabled via ``PRESTO_TPU_TORCH_TIMESERIES=off``.
        """
        if not self._enabled:
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop_event = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, name="timeseries-sampler", daemon=True)
            self._thread.start()
            return True

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
            self._stop_event.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)

    def _loop(self) -> None:
        stop = self._stop_event
        while not stop.wait(self._interval):
            t0 = time.perf_counter()
            try:
                self.sample()
            except Exception:
                pass
            cost = time.perf_counter() - t0
            self._registry.counter("timeseries_samples_total").inc()
            self._registry.counter("timeseries_sample_seconds_total").inc(cost)

    # -- reads --------------------------------------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            s = self._series.get(name)
            return s.kind if s is not None else None

    def points(self, name: str, window: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, object]]:
        """Raw ring points for ``name`` (newest last), optionally
        restricted to ``[now - window, now]``."""
        t = time.time() if now is None else float(now)
        with self._lock:
            s = self._series.get(name)
            pts = list(s.points) if s is not None else []
        if window is not None:
            start = t - float(window)
            pts = [p for p in pts if start <= p[0] <= t]
        return pts

    def rate(self, name: str, window: float,
             now: Optional[float] = None) -> Optional[float]:
        """Windowed per-second rate of a counter (successive-sample
        delta over elapsed time); ``None`` without two samples."""
        t = time.time() if now is None else float(now)
        with self._lock:
            s = self._series.get(name)
            pts = list(s.points) if s is not None else []
        pair = _window_pair(pts, float(window), t)
        if pair is None:
            return None
        (t0, v0), (t1, v1) = pair
        delta = float(v1) - float(v0)
        if delta < 0:  # registry was reset mid-window
            return None
        return delta / (t1 - t0)

    def window_counts(self, name: str, window: float,
                      now: Optional[float] = None):
        """Histogram window delta: ``(count, sum, bucket_counts, bounds)``
        differenced between the window's baseline and end samples, or
        ``None``.  ``bucket_counts`` are *cumulative* window deltas
        aligned with ``bounds + (+Inf,)``."""
        t = time.time() if now is None else float(now)
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "histogram":
                return None
            pts = list(s.points)
            bounds = s.bounds or ()
        pair = _window_pair(pts, float(window), t)
        if pair is None:
            return None
        (_, (c0, s0, b0)), (_, (c1, s1, b1)) = pair
        dc = c1 - c0
        if dc < 0:  # registry was reset mid-window
            return None
        db = tuple(max(0, x1 - x0) for x0, x1 in zip(b0, b1))
        return dc, s1 - s0, db, bounds

    def window_quantile(self, name: str, window: float, q: float,
                        now: Optional[float] = None) -> Optional[float]:
        """Quantile of a histogram over the window, from differenced
        cumulative bucket counts.  The estimate interpolates inside the
        winning bucket and clamps to the highest finite bound for the
        +Inf bucket (no windowed min/max exists).
        """
        delta = self.window_counts(name, window, now)
        if delta is None:
            return None
        count, _total, bucket_counts, bounds = delta
        if count <= 0 or not bounds:
            return None
        hi = bounds[-1]
        return _quantile(q, count, _per_bucket(bucket_counts),
                         tuple(bounds), 0.0, hi)

    def range(self, name: str, window: float, reduce: str = "avg",
              q: float = 0.95, labels: Optional[str] = None,
              now: Optional[float] = None) -> Optional[float]:
        """One reduced value for ``name`` over the trailing ``window``.

        ``labels`` (a dotted tail, e.g. ``"serving.dash"``) is appended
        to ``name`` — the registry collapses labels into dotted names,
        so ``range("serving_latency_seconds", 300, "quantile",
        labels="serving.dash")`` reads the per-group series.

        Reducers: ``sum``/``avg``/``max`` fold raw gauge (or counter
        level) points; ``rate`` is the windowed counter rate;
        ``quantile`` is the windowed histogram quantile ``q``.
        Returns ``None`` when the window lacks data.
        """
        if reduce not in _REDUCERS:
            raise ValueError(f"unknown reducer {reduce!r}; "
                             f"expected one of {_REDUCERS}")
        if labels:
            name = f"{name}.{labels}"
        if reduce == "rate":
            return self.rate(name, window, now=now)
        if reduce == "quantile":
            return self.window_quantile(name, window, q, now=now)
        pts = [p for p in self.points(name, window=window, now=now)
               if not isinstance(p[1], tuple)]
        if not pts:
            return None
        vals = [float(v) for _, v in pts]
        if reduce == "sum":
            return sum(vals)
        if reduce == "max":
            return max(vals)
        return sum(vals) / len(vals)

    # -- system.runtime.timeseries ------------------------------------------

    def rows(self, max_points_per_series: int = 32,
             now: Optional[float] = None) -> List[Tuple]:
        """``system.runtime.timeseries`` rows: ``(name, kind, ts, value)``.

        Derived, not raw: counters emit per-interval rates (name suffixed
        ``.rate``), histograms emit per-interval windowed ``.p50/.p95/
        .p99`` plus a ``.rate`` of observations, gauges emit raw points.
        Capped at the newest ``max_points_per_series`` intervals per
        series so the table stays scannable.
        """
        with self._lock:
            snap = [(s.name, s.kind, list(s.points), s.bounds)
                    for s in self._series.values()]
        out: List[Tuple] = []
        for name, kind, pts, bounds in snap:
            pts = pts[-(max_points_per_series + 1):]
            if kind == "gauge":
                out.extend((name, kind, t, float(v))
                           for t, v in pts[-max_points_per_series:])
                continue
            for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                dt = t1 - t0
                if dt <= 0:
                    continue
                if kind == "counter":
                    out.append((f"{name}.rate", kind, t1,
                                (float(v1) - float(v0)) / dt))
                    continue
                c0, _s0, b0 = v0
                c1, _s1, b1 = v1
                dc = c1 - c0
                out.append((f"{name}.rate", kind, t1, max(0, dc) / dt))
                if dc <= 0 or not bounds:
                    continue
                db = _per_bucket([max(0, x1 - x0)
                                  for x0, x1 in zip(b0, b1)])
                for label, q in (("p50", 0.5), ("p95", 0.95),
                                 ("p99", 0.99)):
                    est = _quantile(q, dc, db, tuple(bounds), 0.0,
                                    bounds[-1])
                    out.append((f"{name}.{label}", kind, t1, float(est)))
        out.sort(key=lambda r: (r[0], r[2]))
        return out

    def window_quantile_rows(self, window: float = 300.0,
                             now: Optional[float] = None
                             ) -> List[Tuple[str, float]]:
        """Latest windowed quantiles per histogram series, named like
        the lifetime flattening with a window tag:
        ``("query_seconds.p95_5m", 0.012)``.  Series without two
        samples in the window are omitted (windowed means windowed —
        no lifetime fallback)."""
        label = f"{max(1, int(round(window / 60.0)))}m"
        out: List[Tuple[str, float]] = []
        for name in self.series_names():
            if self.kind(name) != "histogram":
                continue
            for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = self.window_quantile(name, window, q, now=now)
                if v is not None:
                    out.append((f"{name}.{tag}_{label}", float(v)))
        return out

    def derived_points(self, name: str, window: float, q: float = 0.95,
                       now: Optional[float] = None
                       ) -> List[Tuple[float, float]]:
        """Plottable ``(t, value)`` points for one series over the
        window: gauges raw, counters per-interval rates, histograms
        per-interval quantile ``q`` (empty intervals skipped)."""
        t = time.time() if now is None else float(now)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return []
            kind, pts = s.kind, list(s.points)
            bounds = s.bounds or ()
        start = t - float(window)
        if kind == "gauge":
            return [(pt, float(v)) for pt, v in pts
                    if start <= pt <= t]
        out: List[Tuple[float, float]] = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            if t1 < start or t1 > t or t1 <= t0:
                continue
            if kind == "counter":
                out.append((t1, (float(v1) - float(v0)) / (t1 - t0)))
                continue
            c0, _s0, b0 = v0
            c1, _s1, b1 = v1
            dc = c1 - c0
            if dc <= 0 or not bounds:
                continue
            per = _per_bucket([max(0, x1 - x0)
                               for x0, x1 in zip(b0, b1)])
            out.append((t1, float(_quantile(q, dc, per, tuple(bounds),
                                            0.0, bounds[-1]))))
        return out

    def history_doc(self, query_string: str) -> Tuple[int, Dict]:
        """``GET /v1/metrics/history?name=&window=[&reduce=&q=]`` body,
        shared by the coordinator and worker handlers: (status, doc).

        The doc carries the derived plottable points plus, when a
        ``reduce`` parameter names a reducer, one reduced scalar over
        the whole window.
        """
        from urllib.parse import parse_qs
        params = parse_qs(query_string or "")

        def one(key, default=None):
            vals = params.get(key)
            return vals[0] if vals else default

        name = one("name")
        if not name:
            return 400, {"error": "missing required parameter 'name'",
                         "series": self.series_names()}
        try:
            window = float(one("window", 300.0))
            q = float(one("q", 0.95))
        except ValueError as e:
            return 400, {"error": f"bad parameter: {e}"}
        kind = self.kind(name)
        if kind is None:
            return 404, {"error": f"unknown series {name!r}",
                         "series_count": len(self.series_names())}
        now = time.time()
        doc: Dict = {
            "name": name, "kind": kind, "window_s": window,
            "sampled_at": now,
            "points": [[t, v] for t, v in
                       self.derived_points(name, window, q, now=now)],
        }
        reduce_ = one("reduce")
        if reduce_:
            try:
                doc["reduce"] = reduce_
                doc["reduced"] = self.range(name, window, reduce_, q=q,
                                            now=now)
            except ValueError as e:
                return 400, {"error": str(e)}
        return 200, doc

    # -- lifecycle ----------------------------------------------------------

    def reset(self, keep_listeners: bool = True) -> None:
        """Drop all series (tests).  The sampler thread, configuration,
        and (by default) listeners survive."""
        with self._lock:
            self._series.clear()
            if not keep_listeners:
                self._listeners.clear()


TIMESERIES = TimeSeriesStore()
