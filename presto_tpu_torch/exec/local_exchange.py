"""Local exchange: batch redistribution between pipelines in one process.

The counterpart of ``presto_tpu/exec/local_exchange.py`` (reference
presto-main/.../operator/exchange/LocalExchange.java:105-125): producers
push device batches into bounded per-consumer queues and consumer
iterators drain them. On one card the parallelism this buys is on the
host: a join's probe side is generated, copied and filtered on a
producer thread while the build side drains (``exchange_source``), the
role of the reference's build and probe pipelines running at once.

Modes:
- single:      every batch to consumer 0
- broadcast:   every batch to every consumer (batches are never mutated)
- round_robin: batch i to consumer i % n (FIXED_ARBITRARY's role)
- passthrough: producer p feeds consumer p (FIXED_PASSTHROUGH)

The hash mode (FIXED_HASH over ``parallel/exchange.py``'s row hash) and
``parallel_drivers`` (``task_concurrency``) are not ported yet.
"""
from __future__ import annotations

import contextvars
import queue as _queue
import threading
from typing import Callable, Iterator, List, Optional

from ..batch import Batch

_DONE = object()

MODES = ("single", "broadcast", "round_robin", "passthrough")


class LocalExchange:
    def __init__(self, mode: str, n_consumers: int,
                 buffer_batches: int = 4):
        if mode == "hash":
            raise NotImplementedError("the hash local exchange is not ported")
        if mode not in MODES:
            raise ValueError(f"unknown local exchange mode {mode!r}")
        self.mode = mode
        self.n = n_consumers
        self._queues = [_queue.Queue(maxsize=buffer_batches)
                        for _ in range(n_consumers)]
        self._rr = 0
        self._failed: Optional[BaseException] = None
        self._closed = threading.Event()
        #: producer thread (exchange_source), joined by close() so the
        #: subplan it drives cannot outlive the consumer that aborted it
        self._producer: Optional[threading.Thread] = None

    # -- producer side -------------------------------------------------------
    def push(self, batch: Batch, producer: int = 0) -> None:
        if self.mode == "single":
            self._put(0, batch)
        elif self.mode == "broadcast":
            for c in range(self.n):
                self._put(c, batch)
        elif self.mode == "round_robin":
            self._put(self._rr % self.n, batch)
            self._rr += 1
        else:    # passthrough
            self._put(producer % self.n, batch)

    def finish(self, error: Optional[BaseException] = None) -> None:
        """Signal end of stream (or a failure) to every consumer."""
        if error is not None:
            self._failed = error
        for c in range(self.n):
            self._put(c, _DONE, force=True)

    def close(self) -> None:
        """Consumer-side abort: unblock the producer (e.g. LIMIT
        satisfied) and any consumer still blocked in ``get`` (each queue
        gets a final DONE after the drain), then join the producer thread,
        which would otherwise drive the upstream subplan on."""
        self._closed.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            try:
                q.put_nowait(_DONE)
            except _queue.Full:
                pass
        if self._producer is not None and self._producer.is_alive():
            # bounded: the producer notices _closed within one 0.1 s put
            # timeout; anything longer is upstream work finishing a batch
            self._producer.join(timeout=5.0)

    def start_producer(self, produce: Callable[[], None]) -> None:
        """Run ``produce`` on an owned daemon thread that close() joins,
        in a copy of the caller's context."""
        ctx = contextvars.copy_context()
        self._producer = threading.Thread(target=ctx.run, args=(produce,),
                                          daemon=True,
                                          name="local-exchange-producer")
        self._producer.start()

    def _put(self, c: int, item, force: bool = False) -> None:
        while not self._closed.is_set():
            try:
                self._queues[c].put(item, timeout=0.1)
                return
            except _queue.Full:
                continue
        if force:    # DONE must always land so consumers terminate
            try:
                self._queues[c].put_nowait(item)
            except _queue.Full:
                pass

    # -- consumer side -------------------------------------------------------
    def consumer(self, c: int) -> Iterator[Batch]:
        q = self._queues[c]
        while True:
            item = q.get()
            if item is _DONE:
                if self._failed is not None:
                    raise self._failed
                return
            yield item

    def consumers(self) -> List[Iterator[Batch]]:
        return [self.consumer(c) for c in range(self.n)]


def exchange_source(batches: Iterator[Batch], mode: str, n_consumers: int,
                    buffer_batches: int = 4) -> LocalExchange:
    """Start a producer thread draining ``batches`` into a LocalExchange,
    the driver-decoupling shape of LocalExchangeSourceOperator."""
    ex = LocalExchange(mode, n_consumers, buffer_batches)

    def produce() -> None:
        try:
            for b in batches:
                if ex._closed.is_set():
                    # the consumer aborted: stop driving the upstream
                    # subplan, don't just drop its batches
                    break
                ex.push(b)
        except BaseException as e:   # re-raised on the consumer side
            ex.finish(e)
            return
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        ex.finish()

    ex.start_producer(produce)
    return ex
