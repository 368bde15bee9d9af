"""Local exchange: batch redistribution between pipelines in one process.

The counterpart of ``presto_tpu/exec/local_exchange.py`` (reference
presto-main/.../operator/exchange/LocalExchange.java:105-125): producers
push device batches into bounded per-consumer queues and consumer
iterators drain them. On one card the parallelism this buys is on the
host: a join's probe side is generated, copied and filtered on a
producer thread while the build side drains (``exchange_source``), the
role of the reference's build and probe pipelines running at once; and
``parallel_drivers`` runs a grouped aggregation's partial step on
``task_concurrency`` driver threads (the reference's multi-driver
pipelines), whose kernels still serialize on the card.

Modes:
- single:      every batch to consumer 0
- broadcast:   every batch to every consumer (batches are never mutated)
- round_robin: batch i to consumer i % n (FIXED_ARBITRARY's role)
- hash:        consumer c gets the sub-batch of rows whose key columns
               hash to c (FIXED_HASH), by ``parallel/exchange.py``'s
               ``hash_partition_ids``, the row hash the spill and the
               distributed exchange use
- passthrough: producer p feeds consumer p (FIXED_PASSTHROUGH)

Every thread started here runs in a copy of its starter's context, so a
profiled query's frames and the tracer's span parentage follow the work
onto it. A new thread launches on the default CUDA stream of the device
(torch keeps the current stream per thread, and no thread of the engine
sets another), the stream the consumer's kernels use too.
"""
from __future__ import annotations

import contextvars
import queue as _queue
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

from ..batch import Batch
from ..obs import profiler
from ..parallel.exchange import hash_partition_ids

_DONE = object()

MODES = ("single", "broadcast", "round_robin", "hash", "passthrough")


class LocalExchange:
    def __init__(self, mode: str, n_consumers: int,
                 key_cols: Optional[Sequence[int]] = None,
                 buffer_batches: int = 4):
        if mode not in MODES:
            raise ValueError(f"unknown local exchange mode {mode!r}")
        if mode == "hash" and not key_cols:
            raise ValueError("hash mode needs key columns")
        self.mode = mode
        self.n = n_consumers
        self.key_cols = list(key_cols or ())
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
        elif self.mode == "passthrough":
            self._put(producer % self.n, batch)
        else:    # hash
            pid = hash_partition_ids(batch, self.key_cols, self.n)
            for c in range(self.n):
                self._put(c, Batch(batch.schema, batch.columns,
                                   batch.row_mask & (pid == c)))

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
            # (which may need this thread's profile frame lock)
            with profiler.blocking():
                self._producer.join(timeout=5.0)

    def start_producer(self, produce: Callable[[], None]) -> None:
        """Run ``produce`` on an owned daemon thread that close() joins,
        in a copy of the caller's context (so a profiled query's frames
        and kernel launches there are timed and attributed too)."""
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
            try:
                item = q.get_nowait()
            except _queue.Empty:
                # the producer's frames need this thread's profile frame
                # lock (obs/profiler.py) to make the next batch
                with profiler.blocking():
                    item = q.get()
            if item is _DONE:
                if self._failed is not None:
                    raise self._failed
                return
            yield item

    def consumers(self) -> List[Iterator[Batch]]:
        return [self.consumer(c) for c in range(self.n)]


def exchange_source(batches: Iterator[Batch], mode: str, n_consumers: int,
                    key_cols: Optional[Sequence[int]] = None,
                    buffer_batches: int = 4) -> LocalExchange:
    """Start a producer thread draining ``batches`` into a LocalExchange,
    the driver-decoupling shape of LocalExchangeSourceOperator."""
    ex = LocalExchange(mode, n_consumers, key_cols, buffer_batches)

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


def parallel_drivers(batches: Iterator[Batch],
                     driver_fn: Callable[[Batch], Batch],
                     concurrency: int,
                     buffer_batches: int = 4) -> Iterator[Batch]:
    """Fan ``batches`` over ``concurrency`` driver threads, each applying
    ``driver_fn``, and yield the results as they complete, in no fixed
    order (the multi-driver pipeline of reference SqlTaskExecution). One
    driver, or fewer, runs ``driver_fn`` inline.

    Each driver applies ``driver_fn`` in a frame of the operator that
    started the drivers (``profiler.resumed_frame``), so a profiled
    query charges the drivers' device time to that operator; while the
    calling thread waits for a result it gives up its frame lock
    (``profiler.blocking``)."""
    if concurrency <= 1:
        for b in batches:
            yield driver_fn(b)
        return
    ex = exchange_source(batches, "round_robin", concurrency,
                         buffer_batches=buffer_batches)
    out: _queue.Queue = _queue.Queue(maxsize=concurrency * 2)
    errors: List[BaseException] = []

    def drive(c: int) -> None:
        try:
            for b in ex.consumer(c):
                with profiler.resumed_frame():
                    r = driver_fn(b)
                out.put(("row", r))
        except BaseException as e:   # re-raised on the calling thread
            errors.append(e)
        finally:
            out.put(("done", None))

    drivers: List[threading.Thread] = []
    for c in range(concurrency):
        # one context copy per driver (a Context cannot be entered by two
        # threads at once)
        ctx = contextvars.copy_context()
        t = threading.Thread(target=ctx.run, args=(drive, c), daemon=True,
                             name=f"local-driver-{c}")
        drivers.append(t)
        t.start()
    done = 0
    try:
        while done < concurrency:
            try:
                kind, item = out.get_nowait()
            except _queue.Empty:
                with profiler.blocking():
                    kind, item = out.get()
            if kind == "done":
                done += 1
                continue
            yield item
    finally:
        with profiler.blocking():
            ex.close()
            # an early exit (LIMIT, an error) may leave drivers blocked on
            # a full ``out``: drain it until they see the closed exchange
            deadline = time.monotonic() + 5.0
            while any(t.is_alive() for t in drivers) \
                    and time.monotonic() < deadline:
                try:
                    out.get_nowait()
                except _queue.Empty:
                    time.sleep(0.01)
            for t in drivers:
                t.join(timeout=1.0)
    if errors:
        raise errors[0]
