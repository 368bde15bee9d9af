"""Lightweight span tracer with context propagation.

The counterpart of ``presto_tpu/obs/trace.py`` (the role the reference
spreads across QueryTracker / QueryStateMachine timestamps and the
per-operator OperationTimer records, collapsed into one span model): a
span is a named [start, end) interval on the host clock with a trace id,
a parent and free-form attributes. Parentage flows through a
contextvar, so ``query -> plan -> op:* -> device-sync`` nests without
span handles threaded through every call; a thread started in a copy of
the caller's context (the local exchange's producer and drivers, the
scan's split workers) keeps its parent.

The tracer times the host and adds no device synchronization: a
``device-sync`` span brackets a readback the engine makes anyway (an
error-flag reduction, a liveness count, a build summary), so its length
is how long the host waited for the card there. Disabled (the default)
the tracer is invisible on hot paths: ``span()`` returns one shared
no-op object and takes no lock. Finished spans land in a bounded ring;
``export()`` snapshots them and ``chrome_trace()`` renders the Chrome
``chrome://tracing`` / Perfetto JSON format (one "X" complete event per
span, processes keyed by node, threads keyed by query).

Spans are stamped on the clock of ``torch.profiler``'s records
(``clock_ns``) and carry the id of the thread they opened on, in the form
the CUDA runtime's launch records carry it, and the query id of their
trace: a CUDA record joins the innermost span open on its launching
thread at its launch instant, and through it an operator and a query.

Enable with ``TRACER.enable()`` or ``PRESTO_TPU_TORCH_TRACE=1``; write a
query's spans with ``write_chrome_trace(path, TRACER.export())``. A mesh
query's flight recorder rounds (``obs/flight.chrome_events``) join its
spans in the Chrome trace as a "mesh rounds" process, one lane per
attribution bucket.

Across the cluster, ``context()`` rides each task-create document; the
worker's task thread opens ``task_span(ctx, ...)``, a span re-parented
under the coordinator's stage span, and the coordinator harvests each
worker's spans after the query and merges them with ``import_spans``
(deduplicated by span id: in-process workers share this ring). A task
thread starts in a fresh context, so its spans hang off the wire-carried
parent and never off whatever span the HTTP handler's thread held.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

#: the active span for the current thread/context (parent of new spans)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "presto_tpu_torch_span", default=None)

#: the clock of ``torch.profiler``'s records: its CUDA runtime launch
#: records are stamped in CLOCK_REALTIME nanoseconds (on the H100 a
#: launch's record falls between two stamps of this clock taken around
#: it; ``tests/test_torch_trace_clock.py``). Spans are stamped with it.
clock_ns = time.time_ns


def epoch_s(ns: int) -> float:
    """Epoch seconds of an instant on ``clock_ns``: the unit spans and
    profiler events are exported in, so spans from different processes
    and the card's records line up on one timeline."""
    return ns / 1e9


def _now() -> float:
    return epoch_s(clock_ns())


def thread_key(ident: int) -> int:
    """A thread id as the CUDA runtime's launch records carry it in
    ``torch.profiler`` (their ``device_resource_id``): the low 32 bits of
    ``threading.get_ident()``, signed."""
    low = ident & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


class Span:
    """One finished-or-running interval. Mutable while open; after
    ``finish`` it is only read."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_ns",
                 "end_ns", "node", "attrs", "thread", "query_id",
                 "_tracer", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attrs: Dict,
                 query_id: Optional[str] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.span_id = f"{tracer.node}.{next(tracer._seq)}"
        self.node = tracer.node
        self.attrs = attrs
        #: the opening thread, as launch records name it
        self.thread = thread_key(threading.get_ident())
        #: the trace's query, inherited from the parent
        self.query_id = attrs.get("query_id", query_id)
        self.start_ns = clock_ns()
        self.end_ns: Optional[int] = None
        self._token = None

    # -- context-manager protocol --------------------------------------------
    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        if exc is not None:
            self.attrs.setdefault("error", f"{type(exc).__name__}: {exc}")
        self.finish()
        return False

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def finish(self) -> None:
        if self.end_ns is None:
            self.end_ns = clock_ns()
            self._tracer._record(self)

    def to_dict(self) -> Dict:
        end_ns = self.end_ns if self.end_ns is not None else self.start_ns
        return {
            "name": self.name, "traceId": self.trace_id,
            "spanId": self.span_id, "parentId": self.parent_id,
            "node": self.node, "start": epoch_s(self.start_ns),
            "end": epoch_s(end_ns), "startNs": self.start_ns,
            "endNs": end_ns, "thread": self.thread,
            "queryId": self.query_id, "attrs": dict(self.attrs),
        }


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer's only allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass

    def finish(self) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Process-wide span collector (one per process, ``TRACER``)."""

    def __init__(self, node: Optional[str] = None,
                 max_spans: int = 100_000):
        #: plain attribute (not a property) so hot paths pay one load
        self.enabled = os.environ.get("PRESTO_TPU_TORCH_TRACE", "") \
            .strip().lower() not in ("", "0", "false", "off", "no")
        # random suffix: span ids stay unique across processes even
        # where containers share a pid
        self.node = node or \
            f"pid-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._seq = itertools.count(1)
        self._ring: deque = deque(maxlen=max_spans)
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def enable(self, flag: bool = True) -> None:
        self.enabled = flag

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def _record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span.to_dict())

    # -- span creation -------------------------------------------------------
    def span(self, name: str, **attrs):
        """New child span of the current context (or a new trace root).
        Returns the shared no-op when disabled."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _CURRENT.get()
        if parent is not None:
            return Span(self, name, parent.trace_id, parent.span_id, attrs,
                        parent.query_id)
        return Span(self, name, uuid.uuid4().hex[:16], None, attrs)

    def task_span(self, ctx: Optional[Dict], name: str, **attrs):
        """Span re-parented from a wire-carried context (a worker task
        resuming a coordinator trace). ``ctx`` is what ``context()``
        produced on the sending side; None or a malformed one degrades
        to a plain ``span()``."""
        if not self.enabled:
            return NOOP_SPAN
        if not isinstance(ctx, dict) or "traceId" not in ctx:
            return self.span(name, **attrs)
        return Span(self, name, str(ctx["traceId"]),
                    ctx.get("spanId"), attrs)

    def context(self) -> Optional[Dict]:
        """Serializable context of the current span (trace and span
        ids); None when disabled or outside a span."""
        if not self.enabled:
            return None
        cur = _CURRENT.get()
        if cur is None:
            return None
        return {"traceId": cur.trace_id, "spanId": cur.span_id}

    # -- export / merge ------------------------------------------------------
    def export(self, trace_id: Optional[str] = None) -> List[Dict]:
        with self._lock:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s["traceId"] == trace_id]
        return spans

    def import_spans(self, spans: List[Dict]) -> int:
        """Merge foreign (worker-exported) spans, deduplicating by span
        id: in-process workers share this ring with the coordinator, so
        a harvest must not record a span twice. Returns spans added."""
        if not spans:
            return 0
        with self._lock:
            seen = {s.get("spanId") for s in self._ring}
            added = 0
            for s in spans:
                if not isinstance(s, dict) or s.get("spanId") in seen:
                    continue
                seen.add(s.get("spanId"))
                self._ring.append(s)
                added += 1
            return added


#: the process-wide tracer
TRACER = Tracer()


def current_span_ids() -> Dict:
    """Correlation ids of the active span for structured logging
    (``obs.log``): its ``query_id`` / ``task_id`` / ``stage_id``
    attributes and the trace id, when a span is open on this context."""
    cur = _CURRENT.get()
    if not isinstance(cur, Span):
        return {}
    out = {k: cur.attrs[k] for k in ("query_id", "task_id", "stage_id")
           if k in cur.attrs}
    out["trace_id"] = cur.trace_id
    return out


# -- Chrome-trace (chrome://tracing / Perfetto) export -----------------------

def chrome_trace(spans: List[Dict], flights=None) -> Dict:
    """Render exported spans as the Chrome Trace Event JSON object
    format: one complete ("X") event per span with microsecond
    timestamps, processes keyed by node, lanes (tids) keyed by
    task/query so concurrent work stacks readably, plus "M" metadata
    events naming both. ``flights`` (mesh flight recorders; by default
    those of ``obs/flight.FLIGHTS`` whose query id a span carries) add
    their round tracks."""
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[Dict] = []

    def pid_of(node: str) -> int:
        if node not in pids:
            pids[node] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[node], "tid": 0,
                           "args": {"name": f"presto_tpu_torch {node}"}})
        return pids[node]

    def tid_of(pid: int, lane: str) -> int:
        key = (pid, lane)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tids[key],
                           "args": {"name": lane}})
        return tids[key]

    for s in spans:
        attrs = s.get("attrs", {}) or {}
        pid = pid_of(s.get("node", "?"))
        lane = str(attrs.get("task_id") or attrs.get("query_id")
                   or s.get("traceId", "main"))
        start = float(s.get("start", 0.0))
        end = float(s.get("end", start))
        events.append({
            "ph": "X", "name": s.get("name", "?"), "cat": "presto_tpu_torch",
            "ts": round(start * 1e6, 1),
            "dur": round(max(end - start, 0.0) * 1e6, 1),
            "pid": pid, "tid": tid_of(pid, lane),
            "args": {"traceId": s.get("traceId"),
                     "spanId": s.get("spanId"),
                     "parentId": s.get("parentId"), **attrs},
        })
    from . import flight as _flight
    if flights is None:
        qids = {str((s.get("attrs") or {}).get("query_id"))
                for s in spans} - {"None"}
        flights = [fl for fl in _flight.FLIGHTS.snapshot()
                   if fl.query_id in qids]
    for k, fl in enumerate(flights):
        events.extend(_flight.chrome_events(fl, pid=len(pids) + 1 + k))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: List[Dict], flights=None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, flights), f)
    return path
