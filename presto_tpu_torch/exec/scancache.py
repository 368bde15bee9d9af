"""Device-resident scan cache + prefetching scan pipeline.

The counterpart of ``presto_tpu/exec/scancache.py``, the input side of
the executor (exec/local.py):

- **ScanCache**: a memory-accounted, LRU, cross-query cache of a split's
  batches as they lie on the device, keyed by (connector instance,
  catalog, table, split, column set, pushdown, table data version, batch
  size, device). A warm run of a scan-heavy query replays the batches
  already on the card instead of generating and copying every split
  again. Entries are accounted against the cache's own
  ``memory.QueryMemoryPool`` (the resident set is bounded and
  observable) and invalidated on connector writes through
  ``connectors.spi.notify_data_change``. Connectors that cannot attest a
  data version (``Connector.data_version`` returns None) are never
  cached.

- **One cache per device.** The JAX engine has one device per process;
  the port runs ``cuda`` and ``cpu`` runners in one process. ``CACHE``
  keeps one ScanCache per device, each with the full default bound, so
  a CPU reference run neither replays into a CUDA query (the device is
  in the key too) nor evicts the card's entries, and the card's resident
  bytes stay under its own bound.

- **Prefetching pipeline**: bounded per-split reorder queues filled by
  background threads. Split N+1 is generated and copied to the device
  while the consumer's kernels work on split N. Delivery stays in split
  order (physical row order feeds order-sensitive semantics downstream).
  Consumer-side waits are prefetch stalls, the histogram that says
  whether a query is input-bound. The workers are handed the runner's
  device and copy on their thread's default stream: a pageable,
  synchronous copy on the stream the consumer's kernels also use.

- **Bucketed capacity padding**: the ragged final chunk of a split pads
  up to the scan stream's bucket, so every batch of a stream has one
  capacity.

Metrics: ``scan_cache_{hit,miss,insert,invalidated}_total``,
``scan_cache_evicted_bytes_total``, ``scan_cache_resident_bytes.<device>``,
``scan_prefetch_stall_seconds``, ``scan_prefetch_batches_total``,
``scan_shared_attach_total``. Session properties: ``scan_cache``,
``scan_prefetch``, ``scan_prefetch_depth``, ``scan_pad_batches``,
``scan_threads``, ``shared_scan``. The resident limit is process-wide
(``CACHE.set_limit``), never a session property: one session must not
evict every other session's cache.

Not ported yet: the fair device scheduler's stall credit
(``exec/taskexec.py``), the mesh flight recorder and the failpoints.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..batch import Batch, bucket_capacity
from ..connectors import spi
from ..memory import QueryMemoryPool, batch_device_bytes
from ..obs.metrics import REGISTRY
from ..planner.planner import bool_property

_HITS = REGISTRY.counter("scan_cache_hit_total")
_MISSES = REGISTRY.counter("scan_cache_miss_total")
_INSERTS = REGISTRY.counter("scan_cache_insert_total")
_INVALIDATED = REGISTRY.counter("scan_cache_invalidated_total")
_EVICTED_BYTES = REGISTRY.counter("scan_cache_evicted_bytes_total")
_STALL = REGISTRY.histogram("scan_prefetch_stall_seconds")
_PREFETCH_BATCHES = REGISTRY.counter("scan_prefetch_batches_total")
_SHARED_ATTACH = REGISTRY.counter("scan_shared_attach_total")

#: longest a query waits on another query's in-flight decode before giving
#: up and decoding solo (a wedged producer must not wedge its attached
#: consumers)
SHARED_WAIT_S = 30.0

#: default resident-set bound of each device's cache
DEFAULT_CACHE_BYTES = 2 << 30

#: key field positions (ScanCache.key)
_K_TABLE, _K_VERSION = 3, 7


def _freeze(v):
    """Hashable form of split and pushdown payloads (connector split info
    is opaque and may carry lists)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


class _Entry:
    __slots__ = ("batches", "nbytes", "ctx", "conn_ref")

    def __init__(self, batches, nbytes, ctx, conn_ref):
        self.batches = batches
        self.nbytes = nbytes
        self.ctx = ctx
        self.conn_ref = conn_ref


class _InFlight:
    """One split decode in progress: attached scans wait on ``event`` and
    read ``batches`` (None: the producer failed or gave up; waiters retry,
    possibly becoming the producer themselves)."""

    __slots__ = ("event", "batches")

    def __init__(self):
        self.event = threading.Event()
        self.batches: Optional[List[Batch]] = None


class ScanCache:
    """Cross-query LRU of one device's split batches, accounted against
    its own memory pool (the reference has no analogue: Presto reads the
    source again for each query; the nearest relatives are Alluxio-style
    local caches and tf.data's ``cache()``, which this is, on the device).

    It also brokers shared scans: concurrent queries missing on the same
    key attach to ONE in-flight decode (``join_inflight`` /
    ``finish_inflight``) instead of racing duplicate decodes."""

    def __init__(self, limit_bytes: int = DEFAULT_CACHE_BYTES,
                 label: str = ""):
        self.pool = QueryMemoryPool(limit_bytes)
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._inflight: Dict[Tuple, _InFlight] = {}
        self._lock = threading.RLock()
        self._resident = REGISTRY.gauge(
            "scan_cache_resident_bytes" + (f".{label}" if label else ""))

    # -- keying ---------------------------------------------------------------
    @staticmethod
    def key(conn, catalog: str, split, columns, pushdown, version,
            rows_per_batch: int = 0, device=None):
        """Raises TypeError when split info or pushdown are unhashable
        (callers treat that split as uncacheable). ``rows_per_batch`` is
        part of the key, so a runner with another batch size misses
        instead of replaying batches sized for another; so is the device,
        so a CPU entry never replays into a CUDA query or the reverse."""
        k = (id(conn), catalog, split.table.schema, split.table.table,
             _freeze(split.info), tuple(columns), _freeze(pushdown),
             _freeze(version), int(rows_per_batch),
             None if device is None else str(device))
        hash(k)
        return k

    # -- lookup / insert ------------------------------------------------------
    def get(self, key, conn) -> Optional[List[Batch]]:
        return self.get_any([key], conn)

    def get_any(self, keys, conn,
                count_miss: bool = True) -> Optional[List[Batch]]:
        """First hit among ``keys`` (one hit or miss counted for the whole
        probe: callers pass [effective-pushdown key, static-pushdown key];
        an entry made WITHOUT dynamic bounds is a superset the join
        filters again, so it serves a bounds-carrying consumer).
        ``count_miss=False`` for probes that are retried with accounting."""
        with self._lock:
            for key in keys:
                e = self._entries.get(key)
                if e is None:
                    continue
                if e.conn_ref() is not conn:
                    # id() reused after a connector was collected: never
                    # serve another connector's data for a recycled address
                    self._drop(key, e)
                    continue
                self._entries.move_to_end(key)
                _HITS.inc()
                return e.batches
            if count_miss:
                _MISSES.inc()
            return None

    def put(self, key, conn, batches: List[Batch]) -> bool:
        nbytes = sum(batch_device_bytes(b) for b in batches)
        with self._lock:
            if key in self._entries:
                return True          # first writer won; identical data
            # version check under the lock: a write that landed while this
            # scan decoded already bumped data_version (and its invalidate
            # found nothing to drop); an entry under the stale version
            # would squat on reserved bytes, unreachable
            ver_fn = getattr(conn, "data_version", None)
            if ver_fn is not None and \
                    _freeze(ver_fn(key[_K_TABLE])) != key[_K_VERSION]:
                return False
            if nbytes > self.pool.limit:
                return False         # can never fit: don't flush the LRU
            self._sweep_dead()
            ctx = self.pool.context("scan-cache-entry")
            while not self.pool.try_reserve(nbytes, ctx):
                if not self._entries:
                    ctx.close()
                    return False
                self._evict_lru()
            self._entries[key] = _Entry(batches, nbytes, ctx,
                                        weakref.ref(conn))
            _INSERTS.inc()
            self._resident.set(self.pool.reserved)
            return True

    # -- shared-scan batching -------------------------------------------------
    def join_inflight(self, key) -> Tuple[_InFlight, bool]:
        """(record, is_owner): the first caller per key becomes the owner
        (it decodes and MUST call :meth:`finish_inflight` on every exit
        path); later callers attach and wait on ``record.event``."""
        with self._lock:
            fl = self._inflight.get(key)
            if fl is not None:
                return fl, False
            fl = self._inflight[key] = _InFlight()
            return fl, True

    def finish_inflight(self, key, batches: Optional[List[Batch]]) -> None:
        """Publish the owner's outcome: the complete batch list, or None
        when the decode failed or was abandoned (waiters retry)."""
        with self._lock:
            fl = self._inflight.pop(key, None)
        if fl is not None:
            fl.batches = batches
            fl.event.set()

    # -- eviction / invalidation ---------------------------------------------
    def _drop(self, key, e: _Entry) -> None:
        del self._entries[key]
        e.ctx.close()
        self._resident.set(self.pool.reserved)

    def _evict_lru(self) -> None:
        key, e = next(iter(self._entries.items()))
        _EVICTED_BYTES.inc(e.nbytes)
        self._drop(key, e)

    def _sweep_dead(self) -> None:
        """Drop entries whose connector was garbage-collected: a long-lived
        process goes through many short-lived runners."""
        for key in [k for k, e in self._entries.items()
                    if e.conn_ref() is None]:
            self._drop(key, self._entries[key])

    def invalidate(self, conn=None, table: Optional[str] = None) -> None:
        """Drop the entries of a connector (and optionally one table): the
        connector write path, through spi.notify_data_change."""
        with self._lock:
            victims = []
            for key, e in self._entries.items():
                ref = e.conn_ref()
                if ref is None:
                    victims.append(key)   # dead connector: always drop
                    continue
                if conn is not None and ref is not conn:
                    continue
                if table is not None and key[_K_TABLE] != table:
                    continue
                victims.append(key)
            for key in victims:
                self._drop(key, self._entries[key])
            if victims:
                _INVALIDATED.inc(len(victims))

    def clear(self) -> None:
        with self._lock:
            for key in list(self._entries):
                self._drop(key, self._entries[key])

    def set_limit(self, limit_bytes: int) -> None:
        with self._lock:
            self.pool.limit = int(limit_bytes)
            while self._entries and self.pool.reserved > self.pool.limit:
                self._evict_lru()

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return int(self.pool.reserved)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class DeviceScanCaches:
    """One :class:`ScanCache` per device, each bounded by the same limit;
    the process-wide ``CACHE``."""

    def __init__(self, limit_bytes: int = DEFAULT_CACHE_BYTES):
        self._limit = int(limit_bytes)
        self._caches: Dict[str, ScanCache] = {}
        self._lock = threading.Lock()

    def for_device(self, device) -> ScanCache:
        name = str(device)
        with self._lock:
            cache = self._caches.get(name)
            if cache is None:
                cache = self._caches[name] = ScanCache(self._limit, name)
            return cache

    def _all(self) -> List[ScanCache]:
        with self._lock:
            return list(self._caches.values())

    def invalidate(self, conn=None, table: Optional[str] = None) -> None:
        for cache in self._all():
            cache.invalidate(conn, table)

    def clear(self) -> None:
        for cache in self._all():
            cache.clear()

    def set_limit(self, limit_bytes: int) -> None:
        """The bound of every device's cache, now and for caches made
        later."""
        with self._lock:
            self._limit = int(limit_bytes)
        for cache in self._all():
            cache.set_limit(limit_bytes)

    def resident_bytes(self, device=None) -> int:
        """Resident bytes on ``device``, or on all devices together."""
        if device is not None:
            return self.for_device(device).resident_bytes
        return sum(c.resident_bytes for c in self._all())


#: the process-wide caches, one per device
CACHE = DeviceScanCaches()

# connector writes invalidate through the shared SPI notification hook
spi.on_data_change(lambda conn, table: CACHE.invalidate(conn, table))


# -- scan options -------------------------------------------------------------

@dataclasses.dataclass
class ScanOptions:
    cache: bool = True
    prefetch: bool = True
    pad: bool = True
    threads: int = 2
    depth: int = 4
    #: attach concurrent identical-split misses to one in-flight decode
    shared: bool = True


def options_from_session(session) -> ScanOptions:
    return ScanOptions(
        cache=bool_property(session, "scan_cache", True),
        prefetch=bool_property(session, "scan_prefetch", True),
        pad=bool_property(session, "scan_pad_batches", True),
        threads=int(session.properties.get("scan_threads", 2)),
        depth=int(session.properties.get("scan_prefetch_depth", 4)),
        shared=bool_property(session, "shared_scan", True))


class _PadTracker:
    """Largest capacity so far of one scan stream: a smaller batch (the
    ragged final chunk) pads up to it, bounded by the rows_per_batch
    bucket."""

    __slots__ = ("_lock", "_max", "ceiling")

    def __init__(self, ceiling: int):
        self._lock = threading.Lock()
        self._max = 0
        self.ceiling = ceiling

    def target(self, capacity: int) -> int:
        with self._lock:
            if capacity > self._max:
                self._max = capacity
                return capacity
            return min(self._max, self.ceiling)


# -- the scan pipeline --------------------------------------------------------

def scan_splits(conn, catalog: str, columns: Sequence[str],
                splits: Sequence, pushdown_fn: Callable[[], object],
                rows_per_batch: int, opts: ScanOptions, device,
                record_split=None, check_cancel=None,
                stats=None, static_pushdown=None) -> Iterator[Batch]:
    """Stream a table scan's batches on ``device``: per-split cache
    lookup, background generation and staging, split-order delivery,
    bucketed capacity padding. ``pushdown_fn`` is evaluated when each
    split starts (dynamic join bounds may arrive while earlier splits
    stream; the bounds in force become part of that split's cache key).
    ``static_pushdown`` (the plan-time bounds) keys a fallback lookup: an
    entry made without the dynamic bounds is a superset the join filters
    again, so warm hits stay deterministic when bounds race the scan."""
    if not splits:
        return
    columns = tuple(columns)
    cache = CACHE.for_device(device)
    version = None
    cacheable = opts.cache
    if cacheable:
        # getattr: connector doubles may predate the SPI method
        ver_fn = getattr(conn, "data_version", None)
        version = ver_fn(splits[0].table.table) if ver_fn else None
        cacheable = version is not None
    pad = _PadTracker(bucket_capacity(max(int(rows_per_batch), 1))) \
        if opts.pad else None
    # inline scans (no prefetch threads) never ATTACH to another query's
    # decode (they still register and publish, so threaded peers can ride
    # theirs): an inline scan runs on the consumer's own thread
    inline_scan = not opts.prefetch or opts.threads <= 1

    def split_keys(split, pushdown):
        """[effective key, static-pushdown fallback key] (deduplicated);
        empty when uncacheable."""
        if not cacheable:
            return []
        try:
            keys = [ScanCache.key(conn, catalog, split, columns, pushdown,
                                  version, rows_per_batch, device)]
            if _freeze(static_pushdown) != _freeze(pushdown):
                keys.append(ScanCache.key(conn, catalog, split, columns,
                                          static_pushdown, version,
                                          rows_per_batch, device))
            return keys
        except TypeError:
            return []            # unhashable connector payload

    def stage(b: Batch) -> Batch:
        if pad is not None:
            b = b.pad(pad.target(b.capacity))
        if opts.prefetch:
            # only batches the background pipeline staged count
            _PREFETCH_BATCHES.inc()
        return b

    def stall(dt: float) -> None:
        _STALL.observe(dt)
        if stats is not None:
            stats.record_stall(dt)

    def replay(i: int, cached, t0: float) -> Iterator[Batch]:
        if stats is not None:
            stats.record_cache(True)
        for b in cached:
            if pad is not None:
                pad.target(b.capacity)
            yield b
        if record_split is not None:
            record_split(i, t0, len(cached))

    def attach_wait(fl: _InFlight) -> bool:
        """Wait on another query's in-flight decode of this split (shared
        scan); True when its batches are usable. The wait is an input
        stall."""
        _SHARED_ATTACH.inc()
        t_stall = time.perf_counter()
        deadline = t_stall + SHARED_WAIT_S
        done = True
        while not fl.event.wait(0.1):
            if check_cancel is not None:
                check_cancel()
            if time.perf_counter() > deadline:
                done = False      # wedged producer: decode solo
                break
        stall(time.perf_counter() - t_stall)
        return done and fl.batches is not None

    def split_batches(i: int, split) -> Iterator[Batch]:
        t0 = time.perf_counter()
        pushdown = pushdown_fn()
        keys = split_keys(split, pushdown)
        owner_key = None
        solo = False
        while keys:
            cached = cache.get_any(keys, conn)
            if cached is not None:
                yield from replay(i, cached, t0)
                return
            if not opts.shared or solo:
                break
            fl, owner = cache.join_inflight(keys[0])
            if not owner and inline_scan:
                break             # duplicate work beats a stall inline
            if owner:
                # close the probe->register gap: a decode that started and
                # finished between this miss and the registration already
                # inserted the entry
                cached = cache.get_any(keys, conn, count_miss=False)
                if cached is not None:
                    cache.finish_inflight(keys[0], cached)
                    yield from replay(i, cached, t0)
                    return
                owner_key = keys[0]
                break
            if attach_wait(fl):
                # ride the other query's decode (its put() may have been
                # refused by the limit; the list is live either way)
                yield from replay(i, fl.batches, t0)
                return
            # producer failed or gave up (event set, no batches): probe
            # again, possibly as the owner now. Producer wedged past the
            # wait budget (event unset): decode solo, unregistered.
            solo = not fl.event.is_set()
        if keys and stats is not None:
            stats.record_cache(False)
        complete = None
        try:
            src = conn.page_source(split, list(columns), pushdown,
                                   rows_per_batch, device=device)
            acc = [] if keys else None
            nb = 0
            try:
                for b in src.batches():
                    b = stage(b)
                    nb += 1
                    if acc is not None:
                        acc.append(b)
                    yield b
            finally:
                src.close()
            if record_split is not None:
                record_split(i, t0, nb)
            if acc is not None:
                # only complete split streams insert: every early exit
                # above (an error, the consumer's GeneratorExit) skips it
                complete = acc
                cache.put(keys[0], conn, acc)
        finally:
            if owner_key is not None:
                # publish to attached queries on EVERY exit path
                cache.finish_inflight(owner_key, complete)

    # serial warm fast path: splits already resident replay in order with
    # no thread or queue at all; the pipeline starts at the first cold
    # split (fully warm queries never pay prefetch overhead)
    start = 0
    if cacheable:
        for i, split in enumerate(splits):
            t0 = time.perf_counter()
            keys = split_keys(split, pushdown_fn())
            cached = cache.get_any(keys, conn, count_miss=False) \
                if keys else None
            if cached is None:
                break                # split_batches probes again, counted
            for b in replay(i, cached, t0):
                if check_cancel is not None:
                    check_cancel()
                yield b
            start = i + 1
        if start == len(splits):
            return
        splits = list(splits)[start:]

    if inline_scan:
        for i, split in enumerate(splits, start):
            for b in split_batches(i, split):
                if check_cancel is not None:
                    check_cancel()
                yield b
        return

    # background prefetch: one bounded queue per split; the consumer drains
    # them in split order while workers generate and stage ahead of it
    done_marker = object()
    stop = threading.Event()     # consumer gone (e.g. LIMIT satisfied)
    queues = [_queue.Queue(maxsize=max(1, opts.depth)) for _ in splits]
    pending: "_queue.Queue[int]" = _queue.Queue()
    for i in range(len(splits)):
        pending.put(i)

    def put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def worker() -> None:
        while not stop.is_set():
            try:
                i = pending.get_nowait()
            except _queue.Empty:
                return
            gen = split_batches(start + i, splits[i])
            try:
                # ``start + i``: split numbers stay global when the warm
                # fast path served a prefix
                for b in gen:
                    if not put(queues[i], b):
                        return
            except BaseException as e:  # re-raised on the consumer side
                put(queues[i], e)
                return
            finally:
                gen.close()
            put(queues[i], done_marker)

    n_workers = max(1, min(int(opts.threads), len(splits)))
    workers = [threading.Thread(target=worker, daemon=True,
                                name=f"scan-prefetch-{j}")
               for j in range(n_workers)]
    for w in workers:
        w.start()
    try:
        for q in queues:
            while True:
                try:
                    item = q.get_nowait()
                except _queue.Empty:
                    # the consumer outran the prefetcher: an input stall
                    t_stall = time.perf_counter()
                    item = q.get()
                    stall(time.perf_counter() - t_stall)
                if item is done_marker:
                    break
                if isinstance(item, BaseException):
                    raise item
                if check_cancel is not None:
                    check_cancel()
                yield item
    finally:
        stop.set()
        for w in workers:
            # bounded: workers notice ``stop`` within one 0.1 s put timeout
            # (or when the batch they are generating is done)
            w.join(timeout=2.0)
