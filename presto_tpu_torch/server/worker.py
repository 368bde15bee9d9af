"""Worker node: executes plan fragments shipped by a coordinator.

The counterpart of ``presto_tpu/server/worker.py`` (the role of the
reference's worker half: presto-main/.../execution/SqlTaskManager.java:
85,356 task CRUD keyed by TaskId; server/TaskResource.java:83,124,240,
299,311 REST surface; execution/buffer/ output buffers with token/ack
semantics; operator/ExchangeClient.java pull exchange). Each task runs
its fragment on the port's local executor (``exec/local._Executor``) on
the worker's device over its assigned splits; exchange pages travel
between tasks in the page wire format (``exec/pages.py``) over HTTP.
The kernels run inside the tasks: on the GPU a task's grouped
aggregations launch the segment-sum kernel and its unique-build joins
the probe kernel, each counted in this process (``/v1/metrics``).

Device: ``WorkerServer(device=None)`` takes the GPU and raises without
one; ``device="cpu"`` runs the worker on the CPU. A task thread starts
in a fresh ``contextvars.Context``, so the tracer, binding scopes and
profile sessions of the HTTP handler that created it never leak into
it; its spans hang off the coordinator's wire-carried span
(``Tracer.task_span``).

REST surface (mirrors the reference's TaskResource):

- ``PUT    /v1/task/{id}``                     create + start a task
- ``GET    /v1/task/{id}``                     status JSON
- ``GET    /v1/task/{id}/results/{buf}/{tok}`` long-poll pages; the
  token acknowledges everything below it (reread-on-retry semantics,
  the reference's execution/buffer/ClientBuffer token protocol)
- ``DELETE /v1/task/{id}``                     abort
- ``DELETE /v1/query/{id}``                    abort every task of a query
- ``DELETE /v1/spool/{id}``                    release a query's spool
- ``GET    /v1/info``                          node state + heartbeat
- ``GET    /v1/metrics[/history]``             exposition / time series
- ``PUT    /v1/info/state``                    "SHUTTING_DOWN" drains
  active tasks, then refuses new ones (reference
  server/GracefulShutdownHandler.java:43,73)

Run one as a process: ``python -m presto_tpu_torch.server.worker
--device cuda --tpch-sf 1 --coordinator http://host:port``.
"""
from __future__ import annotations

import contextvars
import json
import os
import queue as _queue
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Tuple

from .._devtools.lockcheck import checked_lock
from ..batch import Batch
from ..connectors.spi import CatalogManager, Split
from ..device import resolve_device
from ..errors import QueryError
from ..exec import local as local_exec
from ..exec.backoff import jittered
from ..exec.failpoints import FAILPOINTS, FailpointError
from ..obs.log import LOG
from ..obs.metrics import REGISTRY, TASKS
from ..obs.profiler import hbm_totals, profiled
from ..obs.trace import TRACER
from ..exec.pages import deserialize_page, serialize_page, \
    serialize_partitioned
from ..planner import codec
from ..planner.planner import Session
from ..sql.analyzer import AnalysisError

PAGES_CONTENT_TYPE = "application/x-presto-tpu-pages"

_EXCHANGE_SENT_BYTES = REGISTRY.counter("exchange_sent_bytes_total")
_EXCHANGE_SENT_PAGES = REGISTRY.counter("exchange_sent_pages_total")
#: results responses served (one long poll each, empty ones included):
#: the HTTP round trips an exchange costs
_EXCHANGE_RESPONSES = REGISTRY.counter("exchange_responses_total")
_EXCHANGE_RECV_BYTES = REGISTRY.counter("exchange_received_bytes_total")
_EXCHANGE_WAIT = REGISTRY.histogram("exchange_wait_seconds")
_EXCHANGE_SPOOL_FALLBACK = REGISTRY.counter(
    "exchange_spool_fallback_total")
_SPEC_READS = REGISTRY.counter("exchange_speculative_read_total")
_SPEC_REPLAY_WON = REGISTRY.counter(
    "exchange_speculative_replay_won_total")
_SPEC_LIVE_WON = REGISTRY.counter(
    "exchange_speculative_live_won_total")

_query_handles: Dict[str, list] = {}
_query_handles_lock = checked_lock("worker.query_handles")


def _query_handle(query_id: str, serving: Optional[dict] = None):
    from ..exec.taskexec import GLOBAL as scheduler
    with _query_handles_lock:
        ent = _query_handles.get(query_id)
        if ent is None:
            # serving-plane handoff riding the task doc: the admitting
            # resource group's scheduler share + weight, so cluster
            # queries get the same group-weighted device scheduling as
            # LocalRunner queries (first task of the query wins — all
            # of a query's tasks share one admission)
            serving = serving or {}
            handle = scheduler.task(
                query_id, group=str(serving.get("group", "")),
                weight=int(serving.get("weight", 1)),
                label=str(serving.get("label", "")) or None)
            ent = _query_handles[query_id] = [handle, 0]
        ent[1] += 1
        return ent[0]


def _release_query_handle(query_id: str) -> None:
    with _query_handles_lock:
        ent = _query_handles.get(query_id)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] <= 0:
            del _query_handles[query_id]
            ent[0].close()


def frame_pages(pages: List[bytes]) -> bytes:
    """Length-prefix each page into one body."""
    return b"".join(struct.pack("<I", len(p)) + p for p in pages)


def unframe_pages(body: bytes) -> List[bytes]:
    pages, off = [], 0
    while off < len(body):
        (n,) = struct.unpack_from("<I", body, off)
        pages.append(body[off + 4:off + 4 + n])
        off += 4 + n
    return pages


class OutputBuffer:
    """Per-task partitioned output with token/ack reread semantics.

    Replay storage comes in two flavours:

    - ``spool`` (a :class:`~presto_tpu_torch.exec.spool.SpoolWriter`, set by
      the coordinator when ``retry_policy=TASK`` and spooled exchange
      is on — the default): every page is written through to the
      durable page-addressed spool BEFORE it becomes visible, acked
      pages are dropped from memory (shuffle size is no longer capped
      by worker RAM), and a re-created consumer re-reading from token
      0 is served back out of the spool by token;
    - ``retain=True`` (the in-memory fallback used when
      ``spool_exchange=false``): acked pages are kept resident.

    Buffers are attempt-versioned by construction: every attempt is
    its own task id with its own buffer (and its own spool page logs),
    so a consumer can never interleave pages from two attempts."""

    def __init__(self, n_buffers: int, retain: bool = False,
                 spool=None):
        self.n = n_buffers
        self.retain = retain and spool is None
        self.spool = spool
        self.pages: List[List[Tuple[int, bytes]]] = \
            [[] for _ in range(n_buffers)]
        self.next_token = [0] * n_buffers
        self.finished = False
        self.failed: Optional[str] = None
        self.cond = threading.Condition()

    def add(self, buffer_id: int, page: bytes) -> None:
        _EXCHANGE_SENT_BYTES.inc(len(page))
        _EXCHANGE_SENT_PAGES.inc()
        if self.spool is not None:
            # durable before visible: next_token only advances on this
            # producer thread, so reading it unlocked is safe; a spool
            # write failure propagates and fails the task (which the
            # coordinator then retries elsewhere)
            self.spool.append(buffer_id, self.next_token[buffer_id],
                              page)
        with self.cond:
            self.pages[buffer_id].append(
                (self.next_token[buffer_id], page))
            self.next_token[buffer_id] += 1
            self.cond.notify_all()

    def add_broadcast(self, page: bytes) -> None:
        _EXCHANGE_SENT_BYTES.inc(len(page) * self.n)
        _EXCHANGE_SENT_PAGES.inc(self.n)
        if self.spool is not None:
            for b in range(self.n):
                self.spool.append(b, self.next_token[b], page)
        with self.cond:
            for b in range(self.n):
                self.pages[b].append((self.next_token[b], page))
                self.next_token[b] += 1
            self.cond.notify_all()

    def finish(self) -> None:
        with self.cond:
            self.finished = True
            self.cond.notify_all()

    def fail(self, message: str) -> None:
        # first failure wins: an abort racing (or following) a real
        # error must not overwrite the diagnostic a late poller needs
        with self.cond:
            if self.failed is None:
                self.failed = message
            self.cond.notify_all()

    def drained(self) -> bool:
        """True when nothing depends on this PROCESS to serve the
        buffer anymore: terminal-failed, or finished with its replay
        copy in the durable spool (consumers re-fetch from there), or
        finished with every in-memory page acked. The drain fast-exit
        gate (WorkerServer.begin_shutdown)."""
        with self.cond:
            if self.failed is not None:
                return True
            if not self.finished:
                return False
            if self.spool is not None:
                return True
            return all(not q for q in self.pages)

    def get(self, buffer_id: int, token: int, max_wait_s: float,
            max_bytes: int = 8 << 20):
        """Ack pages below ``token``, long-poll for pages at/after it.
        Returns (pages, next_token, complete). With a spool attached,
        tokens below the in-memory window (a re-created consumer
        re-reading from 0) are served from the spool."""
        deadline = time.monotonic() + max_wait_s
        with self.cond:
            if not self.retain:
                # ack: drop everything the client has by token
                q = self.pages[buffer_id]
                self.pages[buffer_id] = [e for e in q if e[0] >= token]
            while True:
                if self.failed is not None:
                    raise RuntimeError(self.failed)
                avail = [e for e in self.pages[buffer_id]
                         if e[0] >= token]
                if self.spool is not None and not avail \
                        and token < self.next_token[buffer_id]:
                    # the requested token was produced but already
                    # acked out of memory: replay from the spool
                    # (outside the lock — disk reads must not block
                    # the producer)
                    break
                if avail:
                    if self.spool is not None and avail[0][0] != token:
                        # gap below memory (acked away): spool replay.
                        # Spool-less buffers keep the legacy behavior
                        # (serve what memory holds) — they have no
                        # second copy to consult.
                        break
                    out, size = [], 0
                    for t, p in avail:
                        out.append(p)
                        size += len(p)
                        if size >= max_bytes:
                            break
                    nxt = token + len(out)
                    return out, nxt, False
                if self.finished:
                    return [], token, True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], token, False
                self.cond.wait(remaining)
        pages, nxt = self.spool.store.read_pages(
            self.spool.query_id, self.spool.task_id, buffer_id, token,
            max_bytes)
        return pages, nxt, False


class ExchangeFailedError(RuntimeError):
    """A pull exchange lost its upstream. Distinguishable from a plain
    timeout, and the message embeds the upstream TASK id — the
    coordinator's retry layer parses it out of the failed consumer's
    status doc to know *which* upstream attempt to replace."""

    def __init__(self, message: str, task_id: Optional[str] = None,
                 url: Optional[str] = None):
        super().__init__(message)
        self.task_id = task_id
        self.url = url


class ExchangeClient:
    """Pulls pages from every task of an upstream fragment (reference
    operator/ExchangeClient.java:55 + HttpPageBufferClient.java:88):
    one prefetch thread per upstream location, merged into one queue.

    Failure semantics (the retry layer's feed): an HTTP error from the
    upstream (its buffer failed, or the task is gone) fails the pull
    IMMEDIATELY; transport errors (dead worker process) fail after
    ``fail_fast_s`` of consecutive failures rather than the old
    generic 300 s deadline — both as :class:`ExchangeFailedError`
    naming the upstream task. Pages land on ``device``."""

    #: consecutive-transport-failure budget before an upstream is
    #: declared lost (session property ``exchange_failure_timeout_s``)
    TRANSPORT_FAILURE_TIMEOUT_S = 45.0

    def __init__(self, locations: List[str], buffer_id: int,
                 device, timeout_s: float = 300.0,
                 fail_fast_s: Optional[float] = None,
                 cancel_event: Optional[threading.Event] = None,
                 speculative: bool = True,
                 stall_handle=None):
        self.locations = locations
        self.buffer_id = buffer_id
        self.device = device
        self.timeout_s = timeout_s
        self.fail_fast_s = (self.TRANSPORT_FAILURE_TIMEOUT_S
                            if fail_fast_s is None else float(fail_fast_s))
        #: session property ``speculative_spool_reads``: on a transport
        #: failure with a committed spool copy, race the spool replay
        #: against resumed live pulls instead of committing to either
        self.speculative = bool(speculative)
        #: abort propagation: a DELETEd task must stop waiting on its
        #: upstreams NOW — an exchange wait runs inside a device-
        #: scheduler quantum, and a cancelled task parked there would
        #: hold the device hostage for the whole transport window
        self.cancel_event = cancel_event
        #: the consuming task's device-scheduler handle: a blocking
        #: wait on remote pages releases the device through
        #: ``DeviceScheduler.stalled`` — holding it while parked on
        #: another worker's output deadlocks multi-process clusters
        #: (each worker's device held by a consumer whose producer is
        #: starved behind it on the peer)
        self.stall_handle = stall_handle
        self.queue: "_queue.Queue" = _queue.Queue(maxsize=64)
        self.stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._pull, args=(u,), daemon=True)
            for u in locations
        ]

    def _drain_spool(self, task_id: str, token: int) -> Optional[bool]:
        """Serve the remainder of this upstream from the durable spool
        when the attempt's completion marker is present (the producing
        worker drained-and-exited, or died after finishing). Returns
        True when fully drained, None when the spool has no committed
        copy (caller keeps its normal retry semantics); raises
        :class:`ExchangeFailedError` on a corrupt page — the retry
        layer's cue to re-run the producer."""
        from ..exec.spool import SPOOL, SpoolCorruptionError
        query_id = task_id.split(".")[0]
        tokens = SPOOL.finished_tokens(query_id, task_id)
        if tokens is None or self.buffer_id >= len(tokens):
            return None
        _EXCHANGE_SPOOL_FALLBACK.inc()
        end = tokens[self.buffer_id]
        while token < end:
            try:
                pages, nxt = SPOOL.read_pages(
                    query_id, task_id, self.buffer_id, token)
            except (SpoolCorruptionError, FailpointError) as e:
                raise ExchangeFailedError(
                    f"upstream task {task_id} spool replay failed: "
                    f"{e}", task_id=task_id) from None
            if nxt == token:
                # the marker promised more tokens than the page log
                # holds: the spool copy is incomplete/damaged
                raise ExchangeFailedError(
                    f"upstream task {task_id} spool replay failed: "
                    f"page log ends at token {token} of {end}",
                    task_id=task_id)
            for page in pages:
                _EXCHANGE_RECV_BYTES.inc(len(page))
                self.queue.put(page)
            token = nxt
        return True

    def _replay_arm(self, query_id: str, task_id: str, token: int,
                    end: int, cancel: threading.Event,
                    results: "_queue.Queue") -> None:
        """Speculative-race arm 1: buffer the remainder from the spool
        (NOT into the consumer queue — the main thread enqueues only
        the winner's pages)."""
        from ..exec.spool import SPOOL, SpoolCorruptionError
        buf: List[bytes] = []
        try:
            FAILPOINTS.hit("exchange.spec_replay", key=task_id,
                           task_id=task_id)
            while token < end:
                if cancel.is_set():
                    return
                try:
                    pages, nxt = SPOOL.read_pages(
                        query_id, task_id, self.buffer_id, token)
                except (SpoolCorruptionError, FailpointError) as e:
                    # a committed-but-damaged copy is decisive: the
                    # producer must re-run no matter what the live arm
                    # finds — surface it as the race verdict
                    results.put(("replay", None, ExchangeFailedError(
                        f"upstream task {task_id} spool replay "
                        f"failed: {e}", task_id=task_id), True))
                    return
                if nxt == token:
                    results.put(("replay", None, ExchangeFailedError(
                        f"upstream task {task_id} spool replay "
                        f"failed: page log ends at token {token} "
                        f"of {end}", task_id=task_id), True))
                    return
                buf.extend(pages)
                token = nxt
            results.put(("replay", buf, None, False))
        except FailpointError as e:
            results.put(("replay", None, ExchangeFailedError(
                f"upstream task {task_id} spool replay failed: {e}",
                task_id=task_id), False))

    def _live_arm(self, url: str, task_id: str, token: int,
                  cancel: threading.Event,
                  results: "_queue.Queue") -> None:
        """Speculative-race arm 2: resume pulling from the (possibly
        merely slow or restarting) live worker, buffering pages until
        the upstream reports complete."""
        buf: List[bytes] = []
        deadline = time.monotonic() + self.fail_fast_s
        while not cancel.is_set() and not self.stop.is_set():
            try:
                FAILPOINTS.hit("exchange.spec_live", key=url,
                               task_id=task_id)
                FAILPOINTS.hit("exchange.pull", key=url,
                               task_id=task_id)
                req = urllib.request.Request(
                    f"{url}/results/{self.buffer_id}/{token}"
                    f"?max_wait=2")
                with urllib.request.urlopen(req, timeout=10) as resp:
                    body = resp.read()
                    complete = resp.headers.get(
                        "X-Buffer-Complete") == "true"
                    token = int(resp.headers.get("X-Next-Token", token))
            except (FailpointError, urllib.error.HTTPError) as e:
                # injected loss, or the upstream answered and refused:
                # the live arm is out of the race for good
                results.put(("live", None, e, False))
                return
            except Exception as e:
                if time.monotonic() >= deadline:
                    results.put(("live", None, e, False))
                    return
                time.sleep(jittered(0.2))
                continue
            buf.extend(unframe_pages(body))
            if complete:
                results.put(("live", buf, None, False))
                return
        # cancelled: the replay arm already won

    def _race_spool(self, url: str, task_id: str,
                    token: int) -> Optional[bool]:
        """Speculative read: race the durable-spool replay against a
        resumed live pull, first complete remainder wins, loser
        cancelled. Engaged on transport failures when the upstream's
        attempt has a committed spool copy — with an object-store
        backend a replay pays real GCS/S3-style latency, so a worker
        that was merely restarting can beat it; with the producer truly
        gone the replay wins unopposed. Returns True when the
        remainder was enqueued (either arm), None when there is no
        committed copy; raises :class:`ExchangeFailedError` when both
        arms lose (a corrupt spool copy is decisive immediately)."""
        from ..exec.spool import SPOOL
        query_id = task_id.split(".")[0]
        tokens = SPOOL.finished_tokens(query_id, task_id)
        if tokens is None or self.buffer_id >= len(tokens):
            return None
        if not self.speculative:
            return self._drain_spool(task_id, token)
        # the replay ATTEMPT counts as a spool fallback (same meaning
        # as the non-speculative path: a committed copy is being read)
        _EXCHANGE_SPOOL_FALLBACK.inc()
        _SPEC_READS.inc()
        end = tokens[self.buffer_id]
        cancel = threading.Event()
        results: "_queue.Queue" = _queue.Queue()
        arms = [
            threading.Thread(
                target=self._replay_arm,
                args=(query_id, task_id, token, end, cancel, results),
                daemon=True),
            threading.Thread(
                target=self._live_arm,
                args=(url, task_id, token, cancel, results),
                daemon=True),
        ]
        for t in arms:
            t.start()
        errors: List[Exception] = []
        decisive: Optional[Exception] = None
        for _ in range(len(arms)):
            who, buf, err, is_decisive = results.get()
            if buf is not None:
                cancel.set()           # first complete remainder wins
                (_SPEC_REPLAY_WON if who == "replay"
                 else _SPEC_LIVE_WON).inc()
                for page in buf:
                    _EXCHANGE_RECV_BYTES.inc(len(page))
                    self.queue.put(page)
                return True
            if is_decisive:
                cancel.set()
                decisive = err
                break
            errors.append(err)
        cancel.set()
        if decisive is not None:
            raise decisive
        raise ExchangeFailedError(
            f"upstream task {task_id} lost the speculative read on "
            f"both arms: {'; '.join(str(e) for e in errors)}",
            task_id=task_id, url=url)

    def _pull(self, url: str) -> None:
        token = 0
        task_id = url.rsplit("/v1/task/", 1)[-1]
        deadline = time.monotonic() + self.timeout_s
        first_err: Optional[float] = None
        try:
            while not self.stop.is_set():
                try:
                    FAILPOINTS.hit("exchange.pull", key=url,
                                   task_id=task_id)
                except FailpointError as e:
                    raise ExchangeFailedError(
                        f"exchange pull from upstream task {task_id} "
                        f"failed: {e}", task_id=task_id, url=url) \
                        from None
                req = urllib.request.Request(
                    f"{url}/results/{self.buffer_id}/{token}?max_wait=2")
                try:
                    with urllib.request.urlopen(req, timeout=30) as resp:
                        body = resp.read()
                        complete = resp.headers.get(
                            "X-Buffer-Complete") == "true"
                        token = int(resp.headers.get("X-Next-Token",
                                                     token))
                except urllib.error.HTTPError as e:
                    # the upstream answered: its task failed, was
                    # aborted, or is unknown — before declaring it
                    # dead, check the durable spool: a drained (or
                    # restarted) worker's committed attempt replays
                    # from storage with no producer re-run
                    if self._drain_spool(task_id, token):
                        break
                    try:
                        detail = json.loads(
                            e.read() or b"{}").get("error") or ""
                    except Exception:
                        detail = ""
                    raise ExchangeFailedError(
                        f"upstream task {task_id} failed: HTTP "
                        f"{e.code}: {detail or e.reason}",
                        task_id=task_id, url=url) from None
                except Exception as e:  # transport: bounded retry
                    # a dead producer whose attempt committed its
                    # spool needs no retry window at all — race the
                    # spool replay against a resumed live pull (the
                    # worker may be merely restarting; with an
                    # object-store spool the replay is not free)
                    if self._race_spool(url, task_id, token):
                        break
                    now = time.monotonic()
                    if first_err is None:
                        first_err = now
                    if now - first_err >= self.fail_fast_s \
                            or now > deadline:
                        raise ExchangeFailedError(
                            f"upstream task {task_id} unreachable "
                            f"for {now - first_err:.1f}s: {e}",
                            task_id=task_id, url=url) from None
                    time.sleep(jittered(0.2))
                    continue
                first_err = None
                deadline = time.monotonic() + self.timeout_s
                for page in unframe_pages(body):
                    _EXCHANGE_RECV_BYTES.inc(len(page))
                    self.queue.put(page)
                if complete:
                    break
        except BaseException as e:   # surfaced on the consumer side
            self.queue.put(e)
        finally:
            self.queue.put(None)   # this upstream is drained

    def _next(self):
        """Next queue item; waits cancellably and records the wait as
        an input stall (credited back to the device scheduler — time
        blocked on the network is not device time)."""
        try:
            return self.queue.get_nowait()
        except _queue.Empty:
            pass
        from ..exec import taskexec
        sched = (self.stall_handle.scheduler
                 if self.stall_handle is not None else taskexec.GLOBAL)
        t0 = time.monotonic()
        try:
            with sched.stalled(self.stall_handle):
                while True:
                    if self.cancel_event is not None \
                            and self.cancel_event.is_set():
                        from ..errors import QueryCancelledError
                        raise QueryCancelledError("task aborted")
                    try:
                        return self.queue.get(timeout=0.25)
                    except _queue.Empty:
                        continue
        finally:
            dt = time.monotonic() - t0
            _EXCHANGE_WAIT.observe(dt)
            taskexec.GLOBAL.note_stall(dt)

    def batches(self) -> Iterator[Batch]:
        for t in self._threads:
            t.start()
        done = 0
        try:
            while done < len(self._threads):
                item = self._next()
                if item is None:
                    done += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                yield deserialize_page(item, self.device)
        finally:
            self.stop.set()


class _TaskExecutor(local_exec._Executor):
    """Local device engine bound to one task: scans read only the task's
    assigned splits; RemoteSourceNodes pull from upstream tasks, and
    their pages land on the task's device."""

    def __init__(self, session: Session, rows_per_batch: int, device,
                 splits: List[Split],
                 sources: Dict[int, List[str]], partition: int):
        super().__init__(session, rows_per_batch, device)
        self.assigned_splits = splits
        self.sources = sources
        self.partition = partition

    def _TableScanNode(self, node) -> Iterator[Batch]:
        # same cache + prefetch pipeline as the local executor: repeated
        # queries hit device memory on every node, and cold splits
        # decode/stage on background threads while this task's kernels
        # run (exec/scancache.py)
        from ..exec import scancache, taskexec
        conn = self.session.catalogs.get(node.catalog)
        opts = scancache.options_from_session(self.session)
        it = scancache.scan_splits(
            conn, node.catalog, list(node.columns),
            list(self.assigned_splits), self._scan_pushdown_fn(node),
            self.rows_per_batch, opts, self.device,
            check_cancel=self._check_cancel, stats=self.stats,
            static_pushdown=node.pushdown or None)
        # modeled device floor per SCANNED batch (no-op unless
        # PRESTO_TPU_TORCH_DEVICE_FLOOR_MS is set): the output buffer above
        # this node coalesces pages, so the quantum-level floor alone
        # would bill a worker by what it EMITS, not what it processes
        sentinel = object()
        while True:
            t0 = time.perf_counter()
            b = next(it, sentinel)
            if b is sentinel:
                return
            taskexec.device_floor_pad(time.perf_counter() - t0)
            yield b

    def _RemoteSourceNode(self, node) -> Iterator[Batch]:
        locations: List[str] = []
        for fid in node.fragment_ids:
            locations.extend(self.sources.get(fid, ()))
        fail_fast = float(self.session.properties.get(
            "exchange_failure_timeout_s",
            ExchangeClient.TRANSPORT_FAILURE_TIMEOUT_S))
        from ..exec.local import bool_property
        client = ExchangeClient(locations, self.partition, self.device,
                                fail_fast_s=fail_fast,
                                cancel_event=getattr(
                                    self, "cancel_event", None),
                                speculative=bool_property(
                                    self.session,
                                    "speculative_spool_reads", True),
                                stall_handle=getattr(
                                    self, "task_handle", None))
        schema = local_exec._plan_schema(node)
        for b in client.batches():
            # positional contract: upstream emits the same field layout
            yield Batch(schema, b.columns, b.row_mask)


class Task:
    """One fragment execution (reference execution/SqlTask.java +
    TaskStateMachine states PLANNED/RUNNING/FINISHED/FAILED/ABORTED)."""

    def __init__(self, task_id: str, doc: dict, catalogs: CatalogManager,
                 device, node_id: str = ""):
        self.task_id = task_id
        self.device = device
        self.node_id = node_id
        self.state = "PLANNED"
        self.error: Optional[str] = None
        #: the QueryError code of a failed task (a row error such as
        #: NUMERIC_VALUE_OUT_OF_RANGE): the coordinator fails the query
        #: with it instead of retrying the task
        self.error_code: Optional[int] = None
        #: wire-carried span context (coordinator trace/parent ids) so
        #: this task's spans stitch into the query trace
        self.trace_ctx = doc.get("trace")
        self.started_at: Optional[float] = None
        self.elapsed_ms = 0.0
        #: output accounting, surfaced in status docs (the feed of the
        #: coordinator's progress/straggler/skew monitor) and in
        #: system.runtime.tasks
        self.rows_out = 0
        self.bytes_out = 0
        self.root = codec.decode(doc["fragment"])
        self.output_kind = doc["output"]["kind"]
        self.output_keys = list(doc["output"].get("keys", ()))
        n_buffers = int(doc["output"]["n_buffers"])
        #: spooled exchange (exec/spool.py): the coordinator sets
        #: output.spool for non-root fragments under retry_policy=TASK
        #: — every page becomes durable and replayable by token, so
        #: retries/speculation/drain never need this process alive to
        #: re-read this attempt's output
        self.spool_writer = None
        if bool(doc["output"].get("spool", False)):
            from ..exec.spool import SPOOL
            self.spool_writer = SPOOL.writer(
                task_id.split(".")[0], task_id, n_buffers)
        self.buffer = OutputBuffer(
            n_buffers,
            retain=bool(doc["output"].get("retain", False)),
            spool=self.spool_writer)
        #: set by DELETE-abort; checked between quanta (and, via the
        #: executor's cancel_event, inside scans) so an aborted task
        #: stops burning device time instead of running to completion
        self._abort = threading.Event()
        self.splits = [codec.decode(s) for s in doc.get("splits", [])]
        self.sources = {int(k): list(v)
                        for k, v in doc.get("sources", {}).items()}
        self.partition = int(doc.get("partition", 0))
        #: group scheduling handoff (serving/groups.py via the task
        #: doc): {"group", "weight", "label"} or None
        self.serving = doc.get("serving")
        session_doc = doc.get("session", {})
        self.session = Session(
            catalogs=catalogs,
            catalog=session_doc.get("catalog", "tpch"),
            schema=session_doc.get("schema", "default"),
            properties=dict(session_doc.get("properties", {})))
        self.init_values = list(codec.decode(doc.get("init_values", [])))
        self.rows_per_batch = int(doc.get("rows_per_batch", 1 << 17))
        # a fresh context: the task's spans, binding scopes and profile
        # session start from nothing the creating handler thread held
        self._thread = threading.Thread(
            target=contextvars.Context().run, args=(self._run,),
            daemon=True)
        self._register()

    def _task_ids(self):
        """(query_id, stage_id) parsed from 'qid.fid.part'."""
        parts = self.task_id.split(".")
        qid = parts[0]
        fid = int(parts[1]) if len(parts) > 2 and parts[1].isdigit() else 0
        return qid, fid

    def _register(self) -> None:
        qid, fid = self._task_ids()
        TASKS.update(self.task_id, query_id=qid, stage_id=fid,
                     partition=self.partition, node_id=self.node_id,
                     state=self.state, elapsed_ms=self._elapsed_now(),
                     output_rows=self.rows_out,
                     output_bytes=self.bytes_out)

    def _elapsed_now(self) -> float:
        """Live elapsed for RUNNING tasks; frozen value once terminal."""
        if self.state == "RUNNING" and self.started_at is not None:
            return (time.monotonic() - self.started_at) * 1e3
        return self.elapsed_ms

    def _set_state(self, state: str) -> None:
        self.state = state
        if self.started_at is not None:
            self.elapsed_ms = (time.monotonic() - self.started_at) * 1e3
        self._register()

    def start(self) -> None:
        self.started_at = time.monotonic()
        self._set_state("RUNNING")
        self._thread.start()

    def _run(self) -> None:
        # one shared handle per QUERY: pipeline stages of a query feed
        # each other pages and must never serialize behind their own
        # query's scheduler turn (reference TaskExecutor groups splits
        # under a per-task TaskHandle the same way)
        qid, fid = self._task_ids()
        handle = _query_handle(qid, self.serving)
        try:
            with TRACER.task_span(self.trace_ctx, "task",
                                  task_id=self.task_id, query_id=qid,
                                  stage_id=fid,
                                  partition=self.partition,
                                  node_id=self.node_id):
                FAILPOINTS.hit("worker.task_run",
                               key=f"{self.task_id}@{self.node_id}",
                               task_id=self.task_id,
                               node_id=self.node_id)
                ex = _TaskExecutor(self.session, self.rows_per_batch,
                                   self.device, self.splits, self.sources,
                                   self.partition)
                self.pool = ex.pool  # visible to /v1/info memory report
                # abort propagation: the executor checks this event per
                # scan batch, so a DELETE interrupts a task mid-scan
                ex.cancel_event = self._abort
                # exchange consumers release the device while parked on
                # remote pages (DeviceScheduler.stalled via this handle)
                ex.task_handle = handle
                ex.init_values = self.init_values
                ex.mark_shared([self.root])
                # fair device scheduling across concurrent tasks: one
                # quantum per produced batch (reference TaskExecutor
                # time slicing)
                # `profile` session prop rides the task doc: this
                # task's operator frames and kernel launches are timed
                # on the worker's device and land in its
                # obs.profiler.KERNELS (system.runtime.executables)
                from ..exec.local import bool_property
                profile_ctx = profiled(
                    bool_property(self.session, "profile", False),
                    self.device)
                it = ex.run(self.root)
                sentinel = object()
                with profile_ctx:
                    while True:
                        if self._abort.is_set():
                            from ..errors import QueryCancelledError
                            raise QueryCancelledError("task aborted")
                        batch = handle.scheduler.run_quantum(
                            handle, lambda: next(it, sentinel))
                        if batch is sentinel:
                            break
                        live = batch.host_count()
                        if live == 0:
                            continue
                        self.rows_out += live
                        if self.output_kind == "partition":
                            pages = serialize_partitioned(
                                batch, self.output_keys, self.buffer.n)
                            for b, page in enumerate(pages):
                                if page is not None:
                                    self.bytes_out += len(page)
                                    self.buffer.add(b, page)
                        elif self.output_kind == "broadcast":
                            page = serialize_page(batch)
                            self.bytes_out += len(page)
                            self.buffer.add_broadcast(page)
                        else:   # single
                            page = serialize_page(batch)
                            self.bytes_out += len(page)
                            self.buffer.add(0, page)
                ex.check_errors()
            if self.spool_writer is not None:
                # commit the spool BEFORE announcing FINISHED: a
                # consumer (or the coordinator's lost-task probe) that
                # sees the completion marker can trust the page logs
                self.spool_writer.finish(self.buffer.next_token)
            self.buffer.finish()
            self._set_state("FINISHED")
        except Exception as e:   # noqa: BLE001 - reported to coordinator
            if self.spool_writer is not None:
                # a failed/aborted attempt's partial page logs are
                # garbage: drop them now instead of squatting on
                # spool.max-bytes until query-end GC
                self.spool_writer.abandon()
            if self._abort.is_set():
                # a DELETE-abort interrupted the run loop: ABORTED (set
                # by abort()) is the verdict, not FAILED, and the
                # buffer already carries "task aborted"
                self.buffer.fail("task aborted")
            else:
                self.error = f"{type(e).__name__}: {e}"
                if isinstance(e, QueryError):
                    self.error_code = e.code
                self._set_state("FAILED")
                self.buffer.fail(self.error)
                LOG.log("task_failed", query_id=qid,
                        task_id=self.task_id, node_id=self.node_id,
                        error=self.error)
        finally:
            _release_query_handle(qid)

    def abort(self) -> None:
        if self.state in ("PLANNED", "RUNNING"):
            self._abort.set()
            self._set_state("ABORTED")
            self.error = self.error or "task aborted"
            self.buffer.fail("task aborted")

    def status(self, include_spans: bool = False) -> dict:
        doc = {"taskId": self.task_id, "state": self.state,
               "error": self.error, "errorCode": self.error_code,
               "elapsedMs": round(self._elapsed_now(), 1),
               "rowsOut": self.rows_out, "bytesOut": self.bytes_out}
        self._register()     # status polls refresh system.runtime.tasks
        if include_spans and isinstance(self.trace_ctx, dict):
            # span harvest: the coordinator pulls this worker's spans for
            # the query's trace after completion and merges them into its
            # own ring (dedup by span id — in-process workers share it)
            doc["spans"] = TRACER.export(
                trace_id=self.trace_ctx.get("traceId"))
        return doc


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet
        pass

    @property
    def worker(self) -> "WorkerServer":
        return self.server.worker    # type: ignore[attr-defined]

    def _json(self, code: int, doc: dict) -> None:
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        parts = self.path.split("?")[0].strip("/").split("/")
        if parts[:2] == ["v1", "info"]:
            self._json(200, self.worker.info())
            return
        if parts[:3] == ["v1", "metrics", "history"]:
            # windowed range reads (obs/timeseries.py); must precede
            # the prefix match below — ["v1","metrics"] would swallow
            # the history path
            from ..obs.timeseries import TIMESERIES
            qs = self.path.split("?", 1)[1] if "?" in self.path else ""
            code, doc = TIMESERIES.history_doc(qs)
            self._json(code, doc)
            return
        if parts[:2] == ["v1", "metrics"]:
            # Prometheus scrape surface: the process-wide registry in
            # text exposition format (obs/exposition.py)
            from ..obs.exposition import render_exposition
            body = render_exposition(REGISTRY).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if parts[:2] == ["v1", "task"] and len(parts) == 3:
            task = self.worker.tasks.get(parts[2])
            if task is None:
                tomb = self.worker.done.get(parts[2])
                if tomb is not None:
                    self._json(200, dict(tomb))
                    return
                self._json(404, {"error": "no such task"})
                return
            self._json(200, task.status(
                include_spans="spans=1" in self.path))
            return
        if (parts[:2] == ["v1", "task"] and len(parts) == 6
                and parts[3] == "results"):
            task = self.worker.tasks.get(parts[2])
            if task is None:
                # terminal-state tombstone: a late poller (an exchange
                # client that out-lived the task) gets the REAL verdict
                # — a clean complete page for FINISHED, the persisted
                # failure for FAILED/ABORTED — never a bare 404 it
                # would misread as a transient drop
                tomb = self.worker.done.get(parts[2])
                if tomb is None:
                    self._json(404, {"error": "no such task"})
                    return
                if tomb.get("state") == "FINISHED":
                    self.send_response(200)
                    self.send_header("Content-Type", PAGES_CONTENT_TYPE)
                    self.send_header("Content-Length", "0")
                    self.send_header("X-Next-Token", parts[5])
                    self.send_header("X-Buffer-Complete", "true")
                    self.end_headers()
                    return
                self._json(500, {"error": tomb.get("error")
                                 or f"task {tomb.get('state')}"})
                return
            buf, token = int(parts[4]), int(parts[5])
            wait = 2.0
            if "max_wait=" in self.path:
                wait = float(self.path.split("max_wait=")[1].split("&")[0])
            try:
                pages, nxt, complete = task.buffer.get(buf, token, wait)
            except RuntimeError as e:
                self._json(500, {"error": str(e)})
                return
            body = frame_pages(pages)
            _EXCHANGE_RESPONSES.inc()
            self.send_response(200)
            self.send_header("Content-Type", PAGES_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Next-Token", str(nxt))
            self.send_header("X-Buffer-Complete",
                             "true" if complete else "false")
            self.end_headers()
            self.wfile.write(body)
            return
        self._json(404, {"error": "not found"})

    def do_PUT(self) -> None:
        parts = self.path.strip("/").split("/")
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if n else b""
        if parts[:2] == ["v1", "info"] and parts[2:] == ["state"]:
            state = json.loads(body) if body else ""
            if state == "SHUTTING_DOWN":
                self.worker.begin_shutdown()
                self._json(200, {"state": "SHUTTING_DOWN"})
            else:
                self._json(400, {"error": f"bad state {state!r}"})
            return
        if parts[:2] == ["v1", "task"] and len(parts) == 3:
            if self.worker.shutting_down:
                self._json(503, {"error": "worker is shutting down"})
                return
            try:
                task = self.worker.create_task(parts[2],
                                               json.loads(body))
            except (KeyError, ValueError, AnalysisError) as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, task.status())
            return
        self._json(404, {"error": "not found"})

    def do_DELETE(self) -> None:
        parts = self.path.strip("/").split("/")
        if parts[:2] == ["v1", "task"] and len(parts) == 3:
            task = self.worker.tasks.pop(parts[2], None)
            if task is not None:
                task.abort()
                self.worker.retire(task)
            self._json(200, {"aborted": task is not None})
            return
        if parts[:2] == ["v1", "query"] and len(parts) == 3:
            n = self.worker.abort_query(parts[2])
            self._json(200, {"aborted_tasks": n})
            return
        if parts[:2] == ["v1", "spool"] and len(parts) == 3:
            # per-query spool GC (coordinator-driven at query end; the
            # abort path releases through abort_query)
            from ..exec.spool import SPOOL
            self._json(200,
                       {"released_bytes": SPOOL.release_query(parts[2])})
            return
        self._json(404, {"error": "not found"})


class WorkerServer:
    """One worker node: the task manager and its REST surface, running
    every task on ``device`` (the GPU when none is named; raises without
    one)."""

    def __init__(self, catalogs: Optional[CatalogManager] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 node_id: Optional[str] = None, tpch_sf: float = 0.01,
                 drain_grace_s: float = 5.0, device=None):
        self.device = resolve_device(device)
        if catalogs is None:
            from ..connectors.memory import MemoryConnector
            from ..connectors.system import SystemConnector
            from ..connectors.tpcds import TpcdsConnector
            from ..connectors.tpch import TpchConnector
            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector(sf=tpch_sf))
            catalogs.register("tpcds", TpcdsConnector(sf=tpch_sf))
            catalogs.register("memory", MemoryConnector())
            catalogs.register("system",
                              SystemConnector(catalogs, device=self.device))
        self.catalogs = catalogs
        self.tasks: Dict[str, Task] = {}
        #: terminal-state tombstones of deleted tasks (bounded), so late
        #: status/results polls see the real verdict instead of a 404
        self.done: "OrderedDict[str, dict]" = OrderedDict()
        self.started_at = time.time()
        self.shutting_down = False
        #: bounded consumer-drain window after active tasks finish:
        #: spool-backed buffers skip it entirely (consumers re-fetch
        #: already-acked pages from the durable spool), so a draining
        #: worker EXITS within this grace instead of lingering until
        #: every downstream consumer completes
        self.drain_grace_s = float(drain_grace_s)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.worker = self   # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self.node_id = node_id or f"worker-{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._announcer = None
        #: set once stop() ran: a subprocess worker (``main``) parks its
        #: main thread on it, so a drained worker exits its process
        #: instead of sleeping forever
        self.stopped = threading.Event()

    def start(self) -> None:
        # workers carry the same windowed-history surface as the
        # coordinator: the process-wide sampler feeds /v1/metrics/history
        from ..obs.timeseries import TIMESERIES
        TIMESERIES.ensure_started()
        self._thread.start()

    def start_announcing(self, discovery_uri,
                         advertised_host: str = "127.0.0.1",
                         interval_s: float = 5.0) -> None:
        """Join a coordinator by announcement (reference workers announce
        via discovery and may join any time — elastic scale-out).
        ``discovery_uri`` may be a list (or a comma-separated string)
        of coordinator URIs: a fleet worker announces to every
        coordinator each beat, making ONE worker pool visible to all
        fleet members, and the coordinators that join the fleet later
        (``exec/discovery.Announcer``)."""
        from ..exec.discovery import Announcer
        if isinstance(discovery_uri, str) and "," in discovery_uri:
            discovery_uri = [u.strip() for u in discovery_uri.split(",")
                             if u.strip()]
        self._announcer = Announcer(
            discovery_uri, self.node_id,
            f"http://{advertised_host}:{self.port}", interval_s)
        self._announcer.start()

    def stop(self) -> None:
        if self._announcer is not None:
            # explicit leave: a final GONE announcement removes this
            # node from discovery immediately (elastic scale-in),
            # instead of waiting out the announcement TTL
            self._announcer.deregister()
        self.httpd.shutdown()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        # release the listening socket too: a stopped worker must
        # REFUSE connections — a bound-but-unserved socket makes every
        # peer (exchange pulls, coordinator probes) hang to its full
        # timeout instead of failing over to the spool instantly
        self.httpd.server_close()
        self.stopped.set()

    def create_task(self, task_id: str, doc: dict) -> Task:
        # idempotent: the coordinator's transport retries task PUTs, so
        # a re-delivered create must return the existing task instead of
        # spawning a duplicate executor over the same splits (reference
        # SqlTaskManager.updateTask is an upsert keyed by TaskId)
        existing = self.tasks.get(task_id)
        if existing is not None:
            return existing
        self.done.pop(task_id, None)
        task = Task(task_id, doc, self.catalogs, self.device,
                    node_id=self.node_id)
        self.tasks[task_id] = task
        task.start()
        return task

    def retire(self, task: Task) -> None:
        """Record a deleted task's terminal state (bounded tombstone
        map — the persistence half of OutputBuffer failure state)."""
        self.done[task.task_id] = {
            "taskId": task.task_id, "state": task.state,
            "error": task.error, "errorCode": task.error_code,
            "elapsedMs": round(task._elapsed_now(), 1),
            "rowsOut": task.rows_out, "bytesOut": task.bytes_out,
        }
        while len(self.done) > 512:
            self.done.popitem(last=False)

    def info(self) -> dict:
        # per-query reserved bytes ride the heartbeat payload — the feed
        # of the coordinator's cluster memory manager (reference
        # memory/ClusterMemoryManager.java polls worker memory info)
        queries: Dict[str, int] = {}
        for t in list(self.tasks.values()):
            pool = getattr(t, "pool", None)
            if pool is None or t.state != "RUNNING":
                continue
            qid = t.task_id.split(".")[0]
            queries[qid] = queries.get(qid, 0) + int(pool.reserved)
        return {
            "nodeId": self.node_id,
            "state": "SHUTTING_DOWN" if self.shutting_down else "ACTIVE",
            "uptime_s": time.time() - self.started_at,
            "tasks": {s: sum(1 for t in list(self.tasks.values())
                             if t.state == s)
                      for s in ("RUNNING", "FINISHED", "FAILED")},
            "queryMemory": queries,
            # pool high-water for the coordinator's node federator
            # (process-wide gauge: in-process test workers share it)
            "memPoolPeakBytes": int(
                REGISTRY.gauge("memory_pool_peak_bytes").value),
            # device memory sample riding the heartbeat: the worker's
            # device's allocator stats, also published as
            # hbm_in_use_bytes/hbm_peak_bytes gauges on this worker's
            # /v1/metrics (zeros and no devices on the CPU)
            "hbm": hbm_totals([self.device]),
        }

    def abort_query(self, query_id: str) -> int:
        """Query-level abort: every task of the query is aborted AND
        freed from the task map (tombstoned), so a cancelled query
        releases its buffers instead of squatting until eviction."""
        n = 0
        for t in list(self.tasks.values()):
            if t.task_id.split(".")[0] != query_id:
                continue
            if t.state in ("PLANNED", "RUNNING"):
                t.abort()
                n += 1
            self.tasks.pop(t.task_id, None)
            self.retire(t)
        # wake any task thread of this query blocked in the device
        # scheduler's wait queue (exec/taskexec.py): the shared
        # per-query handle carries the abort
        with _query_handles_lock:
            ent = _query_handles.get(query_id)
            if ent is not None:
                ent[0].aborted.set()
        # an aborted query's spooled pages can never be read again —
        # GC now so aborts don't orphan per-query spool directories
        from ..exec.spool import SPOOL
        SPOOL.release_query(query_id)
        return n

    def begin_shutdown(self) -> None:
        """Drain: refuse new tasks, wait for active ones to finish
        (their output commits to the spool), give un-spooled buffers a
        bounded ``drain_grace_s`` for consumers to pull, then stop —
        the worker EXITS without waiting for downstream completion;
        consumers re-fetch already-acked pages from the durable spool
        (ExchangeClient spool fallback)."""
        self.shutting_down = True
        if self._announcer is not None:
            # push the drain state to discovery immediately — the
            # scheduler must stop assigning before the next heartbeat
            self._announcer.set_state("SHUTTING_DOWN")

        def drain():
            # snapshot per round: abort_query pops entries from other
            # threads, and a dict-changed-mid-iteration RuntimeError
            # here would silently kill the drain thread — the worker
            # would linger forever with stop() never called
            while any(t.state in ("PLANNED", "RUNNING")
                      for t in list(self.tasks.values())):
                time.sleep(0.1)
            grace = time.monotonic() + self.drain_grace_s
            while time.monotonic() < grace \
                    and any(not t.buffer.drained()
                            for t in list(self.tasks.values())):
                time.sleep(0.1)
            self.stop()
        threading.Thread(target=drain, daemon=True).start()


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="presto_tpu_torch worker node")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (0 = ephemeral; default: the etc "
                        "directory's http-server.http.port, else 0)")
    p.add_argument("--tpch-sf", type=float, default=0.01)
    p.add_argument("--node-id", default=None)
    p.add_argument("--etc-dir", default=None,
                   help="config directory (config.properties + catalog/)")
    p.add_argument("--spool-dir", default=None,
                   help="exchange spool directory (overrides etc "
                        "spool.dir; point every node at shared storage)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator URL to announce to "
                        "(overrides etc discovery.uri)")
    p.add_argument("--device", default=None,
                   help="torch device the tasks run on (default: the "
                        "GPU, which must exist; 'cpu' for the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    try:
        # ops hook: SIGUSR1 dumps every thread's stack to stderr — the
        # way to see what a wedged worker is waiting on without
        # attaching a debugger to the subprocess
        import faulthandler
        import signal
        faulthandler.register(signal.SIGUSR1)
    except (ImportError, AttributeError, ValueError):
        pass
    catalogs = None
    node_id = args.node_id
    port = args.port
    discovery_uri = args.coordinator
    spool_dir = args.spool_dir
    if args.etc_dir:
        from ..config import load_catalogs, load_node_config
        cfg = load_node_config(args.etc_dir)
        catalogs = load_catalogs(args.etc_dir, device=device)
        node_id = node_id or cfg.node_id
        # an explicit --port 0 stays ephemeral: only a port not given
        # at all takes the directory's
        port = cfg.http_port if port is None else port
        discovery_uri = discovery_uri or cfg.discovery_uri
        if cfg.failpoints:
            FAILPOINTS.configure_from_spec(cfg.failpoints)
        spool_dir = spool_dir or cfg.spool_dir
        from ..config import configure_spool
        configure_spool(cfg, directory=spool_dir)
    elif spool_dir:
        from ..exec.spool import SPOOL
        SPOOL.configure(directory=spool_dir)
    w = WorkerServer(catalogs=catalogs, host=args.host, port=port or 0,
                     node_id=node_id, tpch_sf=args.tpch_sf, device=device)
    print(json.dumps({"nodeId": w.node_id, "port": w.port}), flush=True)
    w.start()
    if discovery_uri:
        w.start_announcing(discovery_uri, advertised_host=args.host)
    try:
        # park until drained: a PUT /v1/info/state SHUTTING_DOWN ends
        # in stop(), and the process exits
        while not w.stopped.wait(timeout=3600):
            pass
    except KeyboardInterrupt:
        return
    # drained: every task finished and its output is in the spool. Exit
    # without tearing the interpreter down under the daemon threads (the
    # scan cache's prefetch pool, the metrics sampler) that may still be
    # inside torch or CUDA: a CUDA worker finalizing under them aborted
    # (exit -6) instead of exiting 0
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
