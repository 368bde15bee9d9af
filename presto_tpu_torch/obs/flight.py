"""Mesh flight recorder: per-round wall-clock attribution for SPMD.

The counterpart of ``presto_tpu/obs/flight.py``. Every host-observable
event on the mesh path (a shard-program dispatch, a scan's host staging,
a control-scalar fetch, an exchange round, a prefetch stall) becomes a
timestamped **round record**, and a post-query attribution pass
reconciles measured wall time into named buckets plus a cross-round
critical path per shard.

Design constraints, in order:

- **Cheap.** ``record()`` is one perf_counter read and one list append
  under a lock; no device work, no allocation beyond the record dict.
- **Honest.** The buckets are *host-blocking wall* observed at each
  instrumentation site; asynchronous device time the host never waits
  for is invisible by construction, so ``finish()`` reports the
  reconciled fraction explicitly instead of inventing a remainder.
- **Ambient.** Instrumentation sites (exec/distributed.py, the scan
  cache's prefetch stall accounting) reach the active recorder through a
  contextvar, with no signature threaded through the executor.

Record kinds map onto six attribution buckets:

==============  ===================  =====================================
kind            bucket               instrumentation site
==============  ===================  =====================================
dispatch        dispatch_overhead    ``_smap`` host-side dispatch call
drain           device_compute       result gather / final ``to_pylist``
sync            control_sync         ``device-sync`` control-scalar fetch
staging         host_staging         scan split pull / host staging
resplit         repartition          ``_PartitionMap`` epoch re-split
repartition     repartition          all-to-all exchange round
stall           stall                scan-prefetch stall (cache feed)
==============  ===================  =====================================

On the CPU a ``dispatch`` wall *contains* the compute (the slots run
their kernels synchronously inside the call); on the card it is the
host-side launch time and the device wall shows up at the next blocking
point. Either way the sum of the buckets is what the host measurably
spent.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .metrics import REGISTRY
from .trace import _now

#: attribution bucket names, display order (docs/observability.md)
BUCKETS: Tuple[str, ...] = (
    "device_compute", "dispatch_overhead", "host_staging",
    "control_sync", "repartition", "stall")

#: record kind -> attribution bucket
KIND_BUCKET: Dict[str, str] = {
    "dispatch": "dispatch_overhead",
    "drain": "device_compute",
    "sync": "control_sync",
    "staging": "host_staging",
    "resplit": "repartition",
    "repartition": "repartition",
    "stall": "stall",
}

#: ``system.runtime.mesh_rounds`` column order — printer and connector
#: both render from this so the EXPLAIN ANALYZE section and the system
#: table can never drift apart
ROUND_COLUMNS: Tuple[str, ...] = (
    "query_id", "round", "stage", "kind", "bucket", "t_start",
    "wall_s", "rows", "bytes", "loads", "blocking", "rounds")

_FLIGHT_QUERIES = REGISTRY.counter("mesh_flight_queries_total")
_ROUNDS_TOTAL = REGISTRY.counter("mesh_rounds_total")
_ROUND_SECONDS = REGISTRY.histogram("mesh_round_seconds")
_OVERHEAD_TOTAL = REGISTRY.counter("mesh_flight_overhead_seconds_total")
_ATTR_TOTALS = {
    b: REGISTRY.counter(f"mesh_attr_{b}_seconds_total")
    for b in BUCKETS
}


class FlightRecorder:
    """Per-query round timeline + post-query attribution.

    One instance per mesh-path query execution, installed as
    :data:`CURRENT_FLIGHT` for the duration. Thread-safe: scan streams
    and the executor may record from worker threads.
    """

    __slots__ = ("query_id", "n_devices", "started_at", "_records",
                 "_sums", "_lock", "attribution")

    def __init__(self, query_id: str = "", n_devices: int = 1):
        self.query_id = query_id
        self.n_devices = max(int(n_devices), 1)
        self.started_at = _now()
        self._records: List[dict] = []
        self._sums: Dict[str, float] = {}
        self._lock = threading.Lock()
        #: set by :meth:`finish`
        self.attribution: Optional[dict] = None

    # -- hot path -------------------------------------------------------------
    def record(self, kind: str, stage: int = -1, wall: float = 0.0,
               rows: int = 0, nbytes: int = 0,
               loads: Optional[Sequence[int]] = None,
               blocking: bool = True, t_start: float = 0.0,
               rounds: int = 1) -> None:
        """Append one round record. ``wall`` is host-blocking seconds
        measured by the caller; ``loads`` is the per-shard row load of
        the round (feeds the critical path); ``t_start`` is the
        trace-epoch wall clock at the start of the interval (defaults
        to now - wall); ``rounds`` is the number of DEVICE rounds the
        dispatch covers — a fused multi-round program (lax.fori_loop
        over exchange rounds) is one host record with rounds=R, so the
        per-fused-dispatch timeline still exposes how much device-side
        looping each host touch amortizes."""
        rec = {
            "kind": kind,
            "stage": int(stage),
            "t": t_start if t_start else _now() - wall,
            "wall": float(wall),
            "rows": int(rows),
            "bytes": int(nbytes),
            "loads": tuple(int(x) for x in loads) if loads else None,
            "blocking": bool(blocking),
            "rounds": max(int(rounds), 1),
        }
        with self._lock:
            rec["round"] = len(self._records)
            self._records.append(rec)
            self._sums[kind] = self._sums.get(kind, 0.0) + rec["wall"]

    def kind_wall(self, kind: str) -> float:
        """Running wall-seconds total of one record kind — lets nesting
        instrumentation subtract already-recorded inner intervals (the
        scan pull loop nets out prefetch stalls) without re-scanning
        the record list."""
        with self._lock:
            return self._sums.get(kind, 0.0)

    @contextlib.contextmanager
    def timed(self, kind: str, stage: int = -1, rows: int = 0,
              nbytes: int = 0, loads: Optional[Sequence[int]] = None,
              blocking: bool = True):
        """Measure a host-blocking interval and record it."""
        t0 = time.perf_counter()
        w0 = _now()
        try:
            yield
        finally:
            self.record(kind, stage=stage,
                        wall=time.perf_counter() - t0, rows=rows,
                        nbytes=nbytes, loads=loads, blocking=blocking,
                        t_start=w0)

    # -- read side ------------------------------------------------------------
    def records(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._records]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -- attribution ----------------------------------------------------------
    def finish(self, wall_s: float) -> dict:
        """Reconcile the round timeline against the measured query wall
        and publish the flight: bucket seconds, dominant bucket,
        reconciled fraction, per-shard critical path, metrics, and the
        process-wide :data:`FLIGHTS` log."""
        records = self.records()
        buckets = {b: 0.0 for b in BUCKETS}
        per_shard = [0.0] * self.n_devices
        for r in records:
            bucket = KIND_BUCKET.get(r["kind"], "dispatch_overhead")
            buckets[bucket] += r["wall"]
            loads = r["loads"]
            if loads and len(loads) == self.n_devices and max(loads):
                # critical path: the straggler shard accrues the full
                # round wall (the round cannot finish before it does);
                # the rest accrue their proportional share
                peak = max(loads)
                for i, ld in enumerate(loads):
                    per_shard[i] += r["wall"] * (ld / peak)
            else:
                # no per-shard signal: the round gates every shard
                for i in range(self.n_devices):
                    per_shard[i] += r["wall"]
        bucketed = sum(buckets.values())
        wall_s = max(float(wall_s), 1e-9)
        overhead = bucketed - buckets["device_compute"]
        dominant = max(BUCKETS, key=lambda b: buckets[b])
        slowest = max(range(self.n_devices),
                      key=lambda i: per_shard[i]) if per_shard else 0
        attribution = {
            "query_id": self.query_id,
            "n_devices": self.n_devices,
            "wall_s": round(wall_s, 6),
            "rounds": len(records),
            # device rounds covered by those records: > rounds when
            # fused dispatches loop multiple exchange rounds on device
            "device_rounds": sum(r.get("rounds", 1) for r in records),
            "buckets": {b: round(s, 6) for b, s in buckets.items()},
            "dominant_bucket": dominant,
            "reconciled_pct": round(
                min(bucketed / wall_s, 1.0) * 100.0, 2),
            "overhead_s": round(max(overhead, 0.0), 6),
            "critical_path": {
                "per_shard_s": [round(s, 6) for s in per_shard],
                "slowest_shard": slowest,
            },
        }
        self.attribution = attribution
        _FLIGHT_QUERIES.inc()
        _ROUNDS_TOTAL.inc(len(records))
        for r in records:
            _ROUND_SECONDS.observe(r["wall"])
        _OVERHEAD_TOTAL.inc(max(overhead, 0.0))
        for b, s in buckets.items():
            if s:
                _ATTR_TOTALS[b].inc(s)
        FLIGHTS.add(self)
        return attribution


class FlightLog:
    """Bounded process-wide log of finished flights — the backing
    store of ``system.runtime.mesh_rounds`` (and the profile
    attribution readback). Ring-buffered by query: round detail for
    the most recent ``maxlen`` mesh queries."""

    def __init__(self, maxlen: int = 32):
        self._maxlen = maxlen
        self._flights: List[FlightRecorder] = []
        self._lock = threading.Lock()

    def add(self, flight: FlightRecorder) -> None:
        with self._lock:
            self._flights.append(flight)
            if len(self._flights) > self._maxlen:
                del self._flights[:len(self._flights) - self._maxlen]

    def clear(self) -> None:
        with self._lock:
            self._flights.clear()

    def snapshot(self) -> List[FlightRecorder]:
        with self._lock:
            return list(self._flights)

    def last(self) -> Optional[FlightRecorder]:
        with self._lock:
            return self._flights[-1] if self._flights else None

    def rows(self) -> List[tuple]:
        """``system.runtime.mesh_rounds`` rows, :data:`ROUND_COLUMNS`
        order, oldest flight first."""
        out: List[tuple] = []
        for fl in self.snapshot():
            out.extend(round_rows(fl.query_id, fl.records()))
        return out


def round_rows(query_id: str,
               records: Iterable[dict]) -> List[tuple]:
    """Render round records as :data:`ROUND_COLUMNS` tuples: the ONE
    row shape shared by the system table and the EXPLAIN ANALYZE
    section."""
    return [
        (query_id, r["round"], r["stage"], r["kind"],
         KIND_BUCKET.get(r["kind"], "dispatch_overhead"),
         round(r["t"], 6), round(r["wall"], 6), r["rows"], r["bytes"],
         "/".join(str(x) for x in r["loads"]) if r["loads"] else "",
         r["blocking"], r.get("rounds", 1))
        for r in records
    ]


def chrome_events(flight: FlightRecorder, pid: int = 3) -> List[dict]:
    """Chrome-trace ``X`` events for one flight: the mesh-rounds track
    that ``obs/trace.chrome_trace`` adds beside the query's spans (one
    tid per bucket so Perfetto groups the timeline by attribution)."""
    tids = {b: i for i, b in enumerate(BUCKETS)}
    events: List[dict] = [{
        "ph": "M", "pid": pid, "name": "process_name",
        "args": {"name": "mesh rounds"},
    }]
    for b, tid in tids.items():
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": b}})
    for r in flight.records():
        bucket = KIND_BUCKET.get(r["kind"], "dispatch_overhead")
        events.append({
            "ph": "X", "pid": pid, "tid": tids[bucket],
            "ts": r["t"] * 1e6, "dur": max(r["wall"], 1e-7) * 1e6,
            "name": f"{r['kind']}#{r['round']}",
            "args": {"stage": r["stage"], "rows": r["rows"],
                     "bytes": r["bytes"],
                     "loads": list(r["loads"] or ())},
        })
    return events


def history_fields(attribution: Optional[dict]) -> dict:
    """Query-history fields (the ``mesh_*`` columns of obs/history.py
    and ``system.runtime.completed_queries``) from one attribution;
    empty when the query never flew."""
    if not attribution:
        return {}
    return {
        "mesh_rounds": int(attribution["rounds"]),
        "mesh_dominant_bucket": attribution["dominant_bucket"],
        "mesh_overhead_ms": round(
            attribution["overhead_s"] * 1e3, 3),
        "mesh_buckets": json.dumps(attribution["buckets"],
                                   sort_keys=True),
    }


_SEQ = itertools.count(1)


def next_seq() -> int:
    """Fallback flight ids (``mesh_000001``) for executions outside a
    traced query span."""
    return next(_SEQ)


#: process-wide finished-flight log
FLIGHTS = FlightLog()

#: the active recorder for this execution context (None = mesh flight
#: off or not on the mesh path); set by exec/local.py around
#: execute_plan and read by the distributed executor + scan cache
CURRENT_FLIGHT: "contextvars.ContextVar[Optional[FlightRecorder]]" = \
    contextvars.ContextVar("presto_tpu_torch_mesh_flight", default=None)


def current_flight() -> Optional[FlightRecorder]:
    return CURRENT_FLIGHT.get()
