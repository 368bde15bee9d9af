"""Per-operator execution statistics.

The counterpart of ``presto_tpu/exec/stats.py`` (the reference's
OperatorStats/DriverStats recorded inside the Driver loop, reference
operator/Driver.java:380-385, surfaced through EXPLAIN ANALYZE): every
plan-node iterator is wrapped to record wall time, batches and, in
analyze mode where a host sync per batch is acceptable, live rows.

Wall time is inclusive (a node's clock runs while it waits on its
children), so the printer reports exclusive time by subtracting the
children's. The profiler's device-time attribution is not ported.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional


@dataclasses.dataclass
class NodeStats:
    wall_s: float = 0.0          # inclusive iterator time
    batches: int = 0
    rows: int = 0                # live rows (analyze mode only)
    capacity: int = 0            # total batch capacity emitted


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
                    try:
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
