"""Process-wide metrics registry: counters, gauges, histograms.

The counterpart of the registry in ``presto_tpu/obs/metrics.py`` (the
role of the reference's JMX-exposed engine metrics): named metrics
created on first use and updated from direct instrumentation (the scan
cache and prefetcher, the memory pools). Each update is one
lock-guarded number change, so the registry stays always on; nothing
here touches the device.

Dotted names carry a label after the family (``scan_cache_resident_bytes.
cuda`` is the family ``scan_cache_resident_bytes`` for device ``cuda``).
The mesh, flight-recorder and scheduler families are registered up front
(``MESH_COUNTERS``, ``SCHEDULER_COUNTERS``).

Beside the registry: ``TASKS`` and ``NODES``, the feeds of
``system.runtime.tasks`` and ``system.runtime.nodes``. A cluster
coordinator fills them; one process holds no task rows, and the nodes
table then lists the runner's own device. ``attach_event_listeners``
hangs the query and split completion counters and histograms on a
runner's ``events.EventListenerManager``.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .._devtools.lockcheck import checked_lock

_INF = float("inf")

#: histogram bucket upper bounds in seconds (the last implicit bucket is
#: +Inf), shared by every histogram so quantiles need no sample store
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _quantile(q: float, count: int, bucket_counts: List[int],
              bounds: Tuple[float, ...], lo_clamp: float,
              hi_clamp: float) -> float:
    """Linear-interpolated quantile from bucket counts, clamped to the
    observed range."""
    target = q * count
    cum = 0
    lo = 0.0
    for i, c in enumerate(bucket_counts):
        hi = bounds[i] if i < len(bounds) else hi_clamp
        if c and cum + c >= target:
            # the reference's operation order, so estimates agree to
            # the last bit
            frac = (target - cum) / c
            v = lo + (hi - lo) * frac
            return min(max(v, lo_clamp), hi_clamp)
        cum += c
        lo = hi
    return hi_clamp


class Counter:
    """Monotonic counter (``*_total`` names by convention)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write or high-water value."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def max_update(self, v: float) -> None:
        with self._lock:
            if v > self.value:
                self.value = float(v)


class Histogram:
    """Count/sum/min/max summary plus fixed buckets, from which
    ``state()`` derives p50/p95/p99."""

    __slots__ = ("name", "count", "sum", "min", "max", "buckets",
                 "bucket_counts", "_lock")

    def __init__(self, name: str,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = _INF
        self.max = -_INF
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1

    def state(self) -> Dict:
        """Consistent copy with cumulative buckets and derived quantiles
        (over the process lifetime)."""
        with self._lock:
            count, total = self.count, self.sum
            mn, mx = self.min, self.max
            counts = list(self.bucket_counts)
        doc: Dict = {"name": self.name, "kind": "histogram",
                     "count": count, "sum": total}
        if count:
            doc["min"], doc["max"] = mn, mx
            doc["quantiles"] = {
                q: _quantile(q, count, counts, self.buckets, mn, mx)
                for q in (0.5, 0.95, 0.99)}
        cum = 0
        cumulative = []
        for i, c in enumerate(counts):
            cum += c
            cumulative.append(
                (self.buckets[i] if i < len(self.buckets) else _INF, cum))
        doc["buckets"] = cumulative
        return doc

    def quantile(self, q: float) -> Optional[float]:
        """Lifetime quantile estimate (``obs/timeseries`` has windowed
        ones)."""
        with self._lock:
            if not self.count:
                return None
            return _quantile(q, self.count, list(self.bucket_counts),
                             self.buckets, self.min, self.max)


class MetricsRegistry:
    """Name -> metric, created on first use; one per process
    (``REGISTRY``)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def collect(self) -> List[Dict]:
        """Typed metric states, one entry per metric: histograms
        structured (``Histogram.state``), counters and gauges as
        ``{"name", "kind", "value"}``."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: List[Dict] = []
        for name, m in metrics:
            if isinstance(m, Histogram):
                out.append(m.state())
            else:
                out.append({"name": name, "kind": "counter"
                            if isinstance(m, Counter) else "gauge",
                            "value": m.value})
        return out

    def snapshot(self) -> List[Dict]:
        """One row per scalar: histograms flatten to
        ``name.count/sum/min/max/p50/p95/p99``."""
        out: List[Dict] = []
        for m in self.collect():
            if m["kind"] != "histogram":
                out.append(m)
                continue
            name = m["name"]
            rows = [("count", float(m["count"])), ("sum", m["sum"])]
            if m["count"]:
                rows += [("min", m["min"]), ("max", m["max"])]
                rows += [(label, m["quantiles"][q]) for q, label in
                         ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"))]
            out += [{"name": f"{name}.{k}", "kind": "histogram",
                     "value": v} for k, v in rows]
        return out

    def reset(self) -> None:
        """Zero every metric in place (tests): instrumentation sites
        hold their metric objects, so values reset and identities
        survive."""
        with self._lock:
            for m in self._metrics.values():
                if isinstance(m, (Counter, Gauge)):
                    m.value = 0.0
                elif isinstance(m, Histogram):
                    m.count, m.sum = 0, 0.0
                    m.min, m.max = _INF, -_INF
                    m.bucket_counts = [0] * (len(m.buckets) + 1)


#: the process-wide registry
REGISTRY = MetricsRegistry()

#: families registered up front, so ``system.runtime.metrics`` lists them
#: (at zero) before the first mesh query or scheduler quantum. The mesh
#: router and exchange (``exec/distributed.py``): queries routed onto the
#: mesh, hot-bucket re-splits, shard-program dispatches (the dotted tail
#: names the stage kind), exchange rounds. The flight recorder
#: (``obs/flight.py``): flights, rounds, round seconds, the recorder's
#: host overhead and the seconds of each attribution bucket. The fair
#: device scheduler (``exec/taskexec.py``): billed device seconds, quanta,
#: quanta weighted by the slots they hold, the wait for a turn, and the
#: quanta given back while blocked on input.
MESH_COUNTERS = (
    "mesh_path_selected_total", "mesh_repartition_resplit_total",
    "mesh_dispatches_total", "exchange_repartitions_total",
    "mesh_flight_queries_total", "mesh_rounds_total",
    "mesh_flight_overhead_seconds_total",
    "mesh_attr_device_compute_seconds_total",
    "mesh_attr_dispatch_overhead_seconds_total",
    "mesh_attr_host_staging_seconds_total",
    "mesh_attr_control_sync_seconds_total",
    "mesh_attr_repartition_seconds_total",
    "mesh_attr_stall_seconds_total")
SCHEDULER_COUNTERS = (
    "scheduler_device_seconds_total", "scheduler_quanta_total",
    "scheduler_chip_quanta_total", "device_stall_release_total")
for _name in MESH_COUNTERS + SCHEDULER_COUNTERS:
    REGISTRY.counter(_name)
for _name in ("mesh_round_seconds", "scheduler_wait_seconds"):
    REGISTRY.histogram(_name)


# -- task registry (system.runtime.tasks) ------------------------------------

_TERMINAL_TASK_STATES = ("FINISHED", "FAILED", "ABORTED")


class TaskRegistry:
    """Bounded registry of worker-task states: the feed of the
    ``system.runtime.tasks`` table (reference SqlTaskManager's task info
    map behind server/TaskResource.java)."""

    def __init__(self, max_tasks: int = 1000):
        self._tasks: "OrderedDict[str, Dict]" = OrderedDict()
        self._max = max_tasks
        self._lock = checked_lock("metrics.tasks")

    def update(self, task_id: str, **fields) -> None:
        evicted = 0
        with self._lock:
            t = self._tasks.get(task_id)
            if t is None:
                t = self._tasks[task_id] = {
                    "task_id": task_id, "created": time.time()}
            t.update(fields)
            # over the cap: the oldest terminal task goes first, so a
            # RUNNING entry stays visible; only when every task is live
            # does the oldest one go (the counter makes either loss
            # visible)
            while len(self._tasks) > self._max:
                victim = next(
                    (k for k, v in self._tasks.items()
                     if v.get("state") in _TERMINAL_TASK_STATES), None)
                if victim is None:
                    victim = next(iter(self._tasks))
                del self._tasks[victim]
                evicted += 1
        if evicted:
            REGISTRY.counter("task_registry_evicted_total").inc(evicted)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [dict(t) for t in self._tasks.values()]

    def reset(self) -> None:
        with self._lock:
            self._tasks.clear()


TASKS = TaskRegistry()


# -- node registry (system.runtime.nodes) -------------------------------------

class NodeRegistry:
    """A coordinator's view of its cluster's nodes: the feed of the
    ``system.runtime.nodes`` table (reference connector/system/
    NodesSystemTable over DiscoveryNodeManager). Heartbeat age is worked
    out at read time, so a stalled poller shows as a growing age."""

    def __init__(self):
        self._nodes: Dict[str, Dict] = {}
        self._lock = checked_lock("metrics.nodes")

    def update(self, node_id: str, seen: bool = True, drop=(),
               **fields) -> None:
        """Merge ``fields`` into the node's doc; ``drop`` removes keys a
        fresh heartbeat no longer carries."""
        with self._lock:
            n = self._nodes.setdefault(node_id, {"node_id": node_id})
            n.update(fields)
            for k in drop:
                n.pop(k, None)
            if seen:
                n["last_seen"] = time.monotonic()

    def snapshot(self, now: Optional[float] = None) -> List[Dict]:
        """Node docs with ``heartbeat_age_s`` from one clock read."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            out = []
            for n in self._nodes.values():
                doc = dict(n)
                seen = doc.pop("last_seen", None)
                doc["heartbeat_age_s"] = (
                    round(now - seen, 3) if seen is not None else _INF)
                out.append(doc)
            return out

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()


NODES = NodeRegistry()


# -- EventListenerManager sink -----------------------------------------------

def attach_event_listeners(events,
                           registry: Optional[MetricsRegistry] = None
                           ) -> None:
    """Register metrics-feeding listeners on an EventListenerManager:
    query-completion state counters and the latency histogram, split
    completion counters (the sink half of the metrics; the other half is
    direct instrumentation)."""
    reg = registry if registry is not None else REGISTRY

    def on_query_completed(ev) -> None:
        state = str(getattr(ev, "state", "unknown")).lower()
        reg.counter(f"queries_{state}_total").inc()
        reg.histogram("query_seconds").observe(
            getattr(ev, "elapsed_ms", 0.0) / 1e3)

    def on_split_completed(ev) -> None:
        reg.counter("splits_completed_total").inc()
        reg.counter("split_batches_total").inc(
            getattr(ev, "batches", 0) or 0)
        reg.histogram("split_seconds").observe(
            (getattr(ev, "wall_ms", 0.0) or 0.0) / 1e3)

    events.register(on_query_completed)
    events.register_split_listener(on_split_completed)
