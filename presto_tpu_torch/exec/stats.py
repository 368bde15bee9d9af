"""Per-operator execution statistics.

The counterpart of ``presto_tpu/exec/stats.py`` (the reference's
OperatorStats/DriverStats recorded inside the Driver loop, reference
operator/Driver.java:380-385, surfaced through EXPLAIN ANALYZE): every
plan-node iterator is wrapped to record wall time, batches and, in
analyze mode where a host sync per batch is acceptable, live rows.

Wall time is inclusive (a node's clock runs while it waits on its
children), so the printer reports exclusive time by subtracting the
children's. Under a profile context (``obs/profiler.py``: the
``profile`` session property, or EXPLAIN ANALYZE) each iterator frame is
also timed on the device, exclusive of its children's frames, into
``NodeStats.device_time_s``, and each hand-kernel launch made in the
frame is charged to the node's kernel table (``record_device``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

from ..obs import profiler


@dataclasses.dataclass
class NodeStats:
    wall_s: float = 0.0          # inclusive iterator time
    batches: int = 0
    rows: int = 0                # live rows (analyze mode only)
    capacity: int = 0            # total batch capacity emitted
    #: device seconds of this operator's frames, exclusive of its
    #: children's (profile mode only: obs/profiler.operator_frame)
    device_time_s: float = 0.0


class StatsCollector:
    """NodeStats keyed by plan node (structural equality, the keying of
    the executor's shared-subplan memo, so a replayed subtree reports its
    one real execution), plus the scans' split records and scan-cache
    outcomes."""

    def __init__(self, count_rows: bool = False):
        self.count_rows = count_rows
        self.by_node: Dict[object, NodeStats] = {}
        self.total_wall_s: float = 0.0
        self.planning_s: float = 0.0
        #: per-split completion records from table scans (the reference's
        #: event/SplitMonitor.java split events): dicts with table, split,
        #: startMs, wallMs, batches
        self.splits: List[Dict] = []
        #: scan-cache outcome per split and the consumer's cumulative
        #: prefetch stall: the EXPLAIN ANALYZE scan-cache line's feed
        self.cache_hits = 0
        self.cache_misses = 0
        self.prefetch_stall_s = 0.0
        #: the mesh flight recorder of a mesh-path run (obs/flight.py),
        #: else None: EXPLAIN ANALYZE's mesh rounds and the history's
        #: mesh_* columns read it
        self.mesh_flight = None
        #: the fair scheduler's account of the run (exec/taskexec.py):
        #: level, billed device seconds, quanta and slots, or None when
        #: fair_scheduling was off
        self.scheduler = None
        #: plan node -> {KernelRecord: [launches, device_s, bytes]}: the
        #: hand kernels each operator launched while profiled
        self.exe_by_node: Dict[object, Dict[object, list]] = {}
        #: plan node -> (strategy, distribution) each join or semi-join
        #: actually executed (direct / sorted / expand x replicated /
        #: partitioned)
        self.join_strategy: Dict[object, tuple] = {}
        # prefetch worker threads record concurrently: an unlocked += would
        # drop updates
        self._lock = threading.Lock()

    def record_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def record_stall(self, seconds: float) -> None:
        with self._lock:
            self.prefetch_stall_s += seconds

    def record_frame(self, node, seconds: float) -> None:
        """Charge one profiled iterator frame's exclusive device seconds
        to a plan operator (obs/profiler.operator_frame's sink)."""
        with self._lock:
            self.by_node.setdefault(node, NodeStats()).device_time_s += \
                seconds

    def record_device(self, node, seconds: float, record,
                      nbytes: int = 0) -> None:
        """Charge one profiled kernel launch to a plan operator's kernel
        table (obs/profiler.kernel_call's sink). Its seconds already lie
        inside the operator's frame time."""
        with self._lock:
            ent = self.exe_by_node.setdefault(node, {}).setdefault(
                record, [0, 0.0, 0])
            ent[0] += 1
            ent[1] += seconds
            ent[2] += nbytes

    def device_for(self, node) -> Optional[Dict]:
        """Per-operator device account for the printer: frame seconds,
        the seconds and bound-formula bytes of its kernel launches. None
        when the operator was not profiled."""
        st = self.by_node.get(node)
        kernels = self.exe_by_node.get(node) or {}
        if (st is None or st.device_time_s <= 0.0) and not kernels:
            return None
        return {"device_time_s": st.device_time_s if st else 0.0,
                "kernel_s": sum(e[1] for e in list(kernels.values())),
                "bytes": sum(e[2] for e in list(kernels.values()))}

    def executables_used(self) -> List[Dict]:
        """This query's hand kernels, aggregated across operators, by
        device time: the EXPLAIN ANALYZE "Kernels" section's feed."""
        agg: Dict[object, list] = {}
        for per_node in list(self.exe_by_node.values()):
            for rec, (n, secs, nbytes) in list(per_node.items()):
                ent = agg.setdefault(rec, [0, 0.0, 0])
                ent[0] += n
                ent[1] += secs
                ent[2] += nbytes
        out = [{"name": rec.name, "source": rec.source, "invocations": n,
                "device_time_s": secs, "build_seconds": rec.build_seconds,
                "bytes_per_call": nbytes / n if n else 0.0}
               for rec, (n, secs, nbytes) in agg.items()]
        out.sort(key=lambda d: -d["device_time_s"])
        return out

    def record_join_strategy(self, node, strategy: str,
                             distribution: str) -> None:
        """The executed join dispatch of one join or semi-join operator
        (exec/local._note_join_strategy's sink)."""
        with self._lock:
            self.join_strategy[node] = (strategy, distribution)

    def join_strategy_for(self, node) -> Optional[tuple]:
        return self.join_strategy.get(node)

    def record_split(self, table: str, split_no: int, started_at: float,
                     wall_s: float, batches: int) -> None:
        with self._lock:
            self.splits.append({
                "table": table, "split": split_no,
                "startMs": round(started_at * 1e3, 1),
                "wallMs": round(wall_s * 1e3, 1), "batches": batches})

    def snapshot(self) -> List[Dict]:
        """JSON-able per-node stats (the live per-stage surface of the
        reference's server/QueryResource.java)."""
        return [{"node": type(node).__name__.replace("Node", ""),
                 "wallMs": round(st.wall_s * 1e3, 1),
                 "batches": st.batches,
                 "rows": st.rows if self.count_rows else None,
                 "capacity": st.capacity}
                for node, st in list(self.by_node.items())]

    def stats_for(self, node) -> Optional[NodeStats]:
        return self.by_node.get(node)

    def wrap(self, node, it: Iterator) -> Iterator:
        with self._lock:
            st = self.by_node.setdefault(node, NodeStats())

        def timed():
            try:
                while True:
                    t0 = time.perf_counter()
                    session = profiler.active_session()
                    try:
                        if session is None:
                            b = next(it)
                        else:
                            with profiler.operator_frame(session, self,
                                                         node):
                                b = next(it)
                    except StopIteration:
                        st.wall_s += time.perf_counter() - t0
                        return
                    st.wall_s += time.perf_counter() - t0
                    st.batches += 1
                    st.capacity += b.capacity
                    if self.count_rows:
                        st.rows += b.host_count()
                    yield b
            finally:
                # an abandoned consumer (LIMIT) closes the node's own
                # generator now, so a scan below stops its threads
                close = getattr(it, "close", None)
                if close is not None:
                    close()
        return timed()
