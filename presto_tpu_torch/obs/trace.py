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
no-op object and takes no lock, and ``wrap_iter`` returns the iterator
itself. Finished spans land in a bounded ring; ``export()`` snapshots
them and ``chrome_trace()`` renders the Chrome ``chrome://tracing`` /
Perfetto JSON format (one "X" complete event per span, processes keyed
by node, threads keyed by query).

Enable with ``TRACER.enable()`` or ``PRESTO_TPU_TORCH_TRACE=1``; write a
query's spans with ``write_chrome_trace(path, TRACER.export())``. The
re-parenting of spans carried over the wire (``task_span``,
``import_spans``) belongs to the distributed executor and is not ported.
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
from typing import Dict, Iterator, List, Optional

#: the active span for the current thread/context (parent of new spans)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "presto_tpu_torch_span", default=None)

#: perf_counter -> epoch anchor: spans are timed with the monotonic
#: clock but exported on the wall clock so spans from different
#: processes line up on one Chrome-trace timeline
_EPOCH_WALL = time.time()
_EPOCH_PERF = time.perf_counter()


def _now() -> float:
    return _EPOCH_WALL + (time.perf_counter() - _EPOCH_PERF)


class Span:
    """One finished-or-running interval. Mutable while open; after
    ``end`` is set it is only read."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "node", "attrs", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.span_id = f"{tracer.node}.{next(tracer._seq)}"
        self.node = tracer.node
        self.attrs = attrs
        self.start = _now()
        self.end: Optional[float] = None
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
        if self.end is None:
            self.end = _now()
            self._tracer._record(self)

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "traceId": self.trace_id,
            "spanId": self.span_id, "parentId": self.parent_id,
            "node": self.node, "start": self.start,
            "end": self.end if self.end is not None else self.start,
            "attrs": dict(self.attrs),
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
            return Span(self, name, parent.trace_id, parent.span_id, attrs)
        return Span(self, name, uuid.uuid4().hex[:16], None, attrs)

    def context(self) -> Optional[Dict]:
        """Serializable context of the current span (trace and span
        ids); None when disabled or outside a span."""
        if not self.enabled:
            return None
        cur = _CURRENT.get()
        if cur is None:
            return None
        return {"traceId": cur.trace_id, "spanId": cur.span_id}

    def wrap_iter(self, name: str, it: Iterator, **attrs) -> Iterator:
        """Span covering an iterator's lifetime (first ``next`` to
        exhaustion) — operator spans over streaming plan nodes. The
        parent is captured at call time, matching the plan structure
        rather than whichever operator happens to be draining."""
        if not self.enabled:
            return it
        parent = _CURRENT.get()
        trace_id = parent.trace_id if parent is not None \
            else uuid.uuid4().hex[:16]
        parent_id = parent.span_id if parent is not None else None

        def gen():
            span = Span(self, name, trace_id, parent_id, attrs)
            batches = 0
            try:
                for item in it:
                    batches += 1
                    yield item
            finally:
                span.attrs["batches"] = batches
                span.finish()
        return gen()

    # -- export --------------------------------------------------------------
    def export(self, trace_id: Optional[str] = None) -> List[Dict]:
        with self._lock:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s["traceId"] == trace_id]
        return spans


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

def chrome_trace(spans: List[Dict]) -> Dict:
    """Render exported spans as the Chrome Trace Event JSON object
    format: one complete ("X") event per span with microsecond
    timestamps, processes keyed by node, lanes (tids) keyed by
    task/query so concurrent work stacks readably, plus "M" metadata
    events naming both."""
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
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: List[Dict]) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f)
    return path
