"""Persistent query history: bounded ring and optional JSON-lines sink.

The counterpart of ``presto_tpu/obs/history.py`` (the role of the
reference's completed-query history, QueryMonitor's QueryCompletedEvent
payload kept past the query, surfaced as
``system.runtime.completed_queries``): every finished or failed query
leaves one final record carrying the SQL text, a plan summary, wall /
cpu / device-sync time, per-operator rows, batches and wall, peak
memory and the error, fed through ``events.EventListenerManager``.

The per-operator device columns come from the runner's
``exec/stats.StatsCollector.device_for`` and are nonzero only when the
query was profiled (the ``profile`` session property, or EXPLAIN
ANALYZE): ``device_time_s`` is the operator's frame seconds on the card;
``hbm_bytes`` carries the bound-formula bytes of the hand kernels the
operator launched (``obs/profiler.KERNELS``: each input read once, each
output written once) and 0 for operators that launched none; ``flops``
is always 0, since the port counts no operations (its two kernels are
integer work bound by bytes, and eager torch ops carry no cost model).

The ring is bounded; records live past the process only with a sink,
``HISTORY.configure(sink_path=...)``. ``slow_threshold_s`` also logs the
full record through the structured logger. The sink rotates to
``<path>.1`` when it passes ``max_sink_bytes`` (64 MiB by default), one
generation kept; the records of the generation dropped are counted in
``history_records_dropped_total``.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, List, Optional

#: flattened columns of system.runtime.completed_queries, in order. The
#: mesh_* tail belongs to the mesh flight recorder, which is not ported:
#: NULL or zero in every record of the port.
RECORD_COLUMNS = (
    "query_id", "state", "user", "query", "error", "error_code",
    "create_time", "elapsed_ms", "cpu_ms", "device_sync_ms",
    "planning_ms", "peak_memory_bytes", "rows", "mode", "plan_summary",
    "retries", "mesh_rounds", "mesh_dominant_bucket",
    "mesh_overhead_ms", "mesh_buckets")


class QueryHistory:
    """Bounded store of final per-query records (dicts)."""

    def __init__(self, max_records: int = 1000):
        from .._devtools.lockcheck import checked_lock
        self._ring: deque = deque(maxlen=max_records)
        self._lock = checked_lock("history.ring")
        self.sink_path: Optional[str] = None
        self.slow_threshold_s: Optional[float] = None
        #: rotate the sink when it passes this size (0/None = unbounded,
        #: the pre-rotation behaviour, for tests that diff whole files)
        self.max_sink_bytes: Optional[int] = 64 << 20
        self._sink_lock = checked_lock("history.sink")
        # records written to the current sink file / living in the .1
        # generation — the .1 count is what one more rotation drops
        self._sink_records = 0
        self._rotated_records = 0

    def configure(self, sink_path: Optional[str] = None,
                  slow_threshold_s: Optional[float] = None,
                  max_sink_bytes: Optional[int] = None) -> None:
        # the whole reconfiguration happens under the sink lock: a
        # concurrent add() must never observe a half-switched sink
        # (new path with the old generation's record counts)
        with self._sink_lock:
            if sink_path is not None:
                self.sink_path = sink_path
                # resuming onto files a previous process wrote: seed the
                # record counts from what's on disk, so the FIRST
                # rotation after a restart still attributes the dropped
                # generation correctly (one line scan at configure time,
                # never per add)
                self._sink_records = self._count_lines(sink_path)
                self._rotated_records = self._count_lines(
                    sink_path + ".1")
            if slow_threshold_s is not None:
                self.slow_threshold_s = slow_threshold_s
            if max_sink_bytes is not None:
                self.max_sink_bytes = int(max_sink_bytes) or None

    @staticmethod
    def _count_lines(path: str) -> int:
        try:
            with open(path, "rb") as f:
                return sum(chunk.count(b"\n")
                           for chunk in iter(lambda: f.read(1 << 20),
                                             b""))
        except OSError:
            return 0

    def add(self, record: Dict) -> None:
        with self._lock:
            self._ring.append(record)
        if self.sink_path:
            try:
                with self._sink_lock:
                    with open(self.sink_path, "a") as f:
                        f.write(json.dumps(record, default=str) + "\n")
                        size = f.tell()
                    self._sink_records += 1
                    if self.max_sink_bytes \
                            and size >= self.max_sink_bytes:
                        self._rotate()
            except Exception:   # history must not break queries
                pass
        thr = self.slow_threshold_s
        if thr is not None \
                and float(record.get("elapsed_ms") or 0.0) >= thr * 1e3:
            from .log import LOG
            LOG.log("slow_query", **record)

    def _rotate(self) -> None:
        """Current sink becomes ``<path>.1`` (replacing — and thereby
        dropping — the previous generation); appends continue into a
        fresh file. Called with the sink lock held."""
        dropped = self._rotated_records
        os.replace(self.sink_path, self.sink_path + ".1")
        self._rotated_records = self._sink_records
        self._sink_records = 0
        if dropped:
            from .metrics import REGISTRY
            REGISTRY.counter("history_records_dropped_total").inc(dropped)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


#: the process-wide history store
HISTORY = QueryHistory()


def attach_history(events, history: Optional[QueryHistory] = None) -> None:
    """Register a query-completion listener that lands every query's
    final record in the history store. The runner attaches the rich
    payload on the event (``QueryCompletedEvent.history``); events
    without one (foreign publishers) still get a minimal record from
    the event fields."""
    h = history if history is not None else HISTORY

    def on_query_completed(ev) -> None:
        rec = dict(getattr(ev, "history", None) or {})
        rec.setdefault("query_id", ev.query_id)
        rec.setdefault("query", ev.query)
        rec.setdefault("user", ev.user)
        rec.setdefault("state", ev.state)
        rec.setdefault("error", ev.error)
        rec.setdefault("elapsed_ms", round(ev.elapsed_ms, 3))
        rec.setdefault("create_time", ev.create_time)
        rec.setdefault("mode", "local")
        # task retries this query survived; a local query has no retry
        # layer
        rec.setdefault("retries", 0)
        h.add(rec)

    events.register(on_query_completed)
