"""Query event listeners.

The counterpart of ``presto_tpu/events.py`` (the reference's
event-listener plugin point, eventlistener/EventListenerManager.java and
event/QueryMonitor.java publishing spi/eventlistener/
QueryCompletedEvent.java): the runner publishes query and split
completion events to the registered listeners; the metrics sink
(``obs/metrics.attach_event_listeners``) and the query history
(``obs/history.attach_history``) hang off it. A listener that raises
never breaks the query.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    query: str
    user: str
    state: str                  # FINISHED | FAILED
    elapsed_ms: float
    error: Optional[str] = None
    create_time: float = 0.0    # epoch seconds
    #: rich final record (plan summary, per-operator stats, peak
    #: memory, cpu/device-sync time) — the publisher-built payload the
    #: query-history listener (obs.history) persists verbatim
    history: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class SplitCompletedEvent:
    """Per-split completion (reference event/SplitMonitor.java +
    spi/eventlistener/SplitCompletedEvent.java)."""
    query_id: str
    table: str
    split: int
    wall_ms: float
    batches: int


class EventListenerManager:
    def __init__(self) -> None:
        self._listeners: List[Callable[[QueryCompletedEvent], None]] = []
        self._split_listeners: List[
            Callable[[SplitCompletedEvent], None]] = []

    def register(self,
                 listener: Callable[[QueryCompletedEvent], None]) -> None:
        self._listeners.append(listener)

    def register_split_listener(
            self, listener: Callable[[SplitCompletedEvent], None]) -> None:
        self._split_listeners.append(listener)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        for listener in self._listeners:
            try:
                listener(event)
            except Exception:   # listeners must not break queries
                pass

    def split_completed(self, event: SplitCompletedEvent) -> None:
        for listener in self._split_listeners:
            try:
                listener(event)
            except Exception:
                pass


def completed_event(query_id: str, query: str, user: str, state: str,
                    started_at: float, error: Optional[str] = None,
                    history: Optional[dict] = None) -> QueryCompletedEvent:
    return QueryCompletedEvent(
        query_id=query_id, query=query, user=user, state=state,
        elapsed_ms=(time.perf_counter() - started_at) * 1e3,
        error=error, create_time=time.time(), history=history)
