"""Device-time fair scheduling of concurrent queries.

The counterpart of ``presto_tpu/exec/taskexec.py`` (the role of the
reference's TaskExecutor + MultilevelSplitQueue + PrioritizedSplitRunner,
presto-main/.../execution/executor/TaskExecutor.java:79,
MultilevelSplitQueue.java:43-44, PrioritizedSplitRunner.java:43): worker
threads time-slice drivers by cumulative CPU so short queries are not
starved behind long scans.

Reshaped for one accelerator: the contended resource is the card's
launch stream, and the quantum is "produce one output batch" (one chain
of kernel launches) rather than a 1 s wall-clock slice. Each concurrent
query registers a task; before every quantum the executor passes through
``run_quantum``, which grants the device to the eligible task in the
LOWEST level (levels by cumulative device seconds, the reference's
thresholds 0/1/10/60/300 s), breaking ties by least in-level usage. A
long-running query climbs levels and yields to fresh short queries.

Device seconds are the quantum's host wall: kernels launch
asynchronously, so a quantum is billed for the host time it held the
stream, and no synchronization is added per quantum. A mesh query is
billed per slot (``devices``): its quantum holds every slot of its mesh.
With the tracer on (``obs/trace.py``) a task's wait for the device is a
``sched-wait`` span and each quantum a ``quantum`` span that carries the
seconds billed (``billed_s``) and the stall credit (``stall_credit_s``).

Quanta are first allotted **per resource group**: stride scheduling over
the group's ``schedulingWeight``. Each billed quantum advances the
group's virtual time by ``billed / weight``, and the waiting task whose
group has the LOWEST virtual time runs next, so under saturation a
weight-2 group receives ~2x the device seconds of a weight-1 group. Only
running advances virtual time, so a waiting group's priority can only
improve; a group returning from idle is clamped UP to the floor of the
active groups' virtual times. Tasks registered without a group share
the default ``""`` group at weight 1 (the resource groups themselves
come with the serving plane).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional, TypeVar

from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER

_DEVICE_SECONDS = REGISTRY.counter("scheduler_device_seconds_total")
_QUANTA = REGISTRY.counter("scheduler_quanta_total")
#: quanta weighted by the chips a task occupies: a mesh query's quantum
#: holds EVERY chip in its mesh for the duration, so fair-share
#: accounting (and this observable) bills per chip, not per dispatch
_CHIP_QUANTA = REGISTRY.counter("scheduler_chip_quanta_total")
_WAIT_SECONDS = REGISTRY.histogram("scheduler_wait_seconds")

#: level thresholds in cumulative device seconds (reference
#: MultilevelSplitQueue.LEVEL_THRESHOLD_SECONDS = {0, 1, 10, 60, 300})
LEVEL_THRESHOLDS = (0.0, 1.0, 10.0, 60.0, 300.0)

#: idle GroupShare retention bound (see DeviceScheduler._shares)
_MAX_SHARES = 256


def _service_floor_s() -> float:
    """Modeled per-quantum device-service floor, seconds
    (``PRESTO_TPU_TORCH_DEVICE_FLOOR_MS``). Zero (the default) is a no-op.

    When set, every quantum holds the device for at least this long —
    a fixed-throughput device model, the same spirit as the object
    spool's modeled RTT/bandwidth. Elasticity benches set it on their
    WORKER processes so per-worker capacity is the bottleneck even on
    a single-core host, where real multi-process compute cannot
    overlap and throughput could never track the worker count."""
    import os
    try:
        return max(0.0, float(
            os.environ.get("PRESTO_TPU_TORCH_DEVICE_FLOOR_MS", "0") or 0)
            / 1e3)
    except ValueError:
        return 0.0


_SERVICE_FLOOR_S = _service_floor_s()


def set_service_floor_ms(ms: float) -> float:
    """Set the modeled per-quantum device-service floor, in milliseconds
    (what ``PRESTO_TPU_TORCH_DEVICE_FLOOR_MS`` sets at import; 0 turns
    it off). Returns the floor it replaces."""
    global _SERVICE_FLOOR_S
    old, _SERVICE_FLOOR_S = _SERVICE_FLOOR_S * 1e3, max(0.0, ms / 1e3)
    return old


def device_floor_pad(elapsed_s: float = 0.0) -> None:
    """Pad one fused kernel chain up to the modeled device-service
    floor (no-op unless ``PRESTO_TPU_TORCH_DEVICE_FLOOR_MS`` is set).

    ``run_quantum`` applies this to each task OUTPUT page, but a source
    task's device work is proportional to the batches it SCANS, and the
    output buffer coalesces those (filters and partial aggregates can
    collapse a whole partition into one output page). Scan paths call
    this per input batch, from inside the owning quantum, so modeled
    per-worker capacity tracks the rows a worker actually processes —
    which is what shrinks when the pool scales out."""
    if _SERVICE_FLOOR_S > 0.0:
        pad = _SERVICE_FLOOR_S - elapsed_s
        if pad > 0.0:
            time.sleep(pad)


R = TypeVar("R")


class GroupShare:
    """One resource group's device-time account (stride scheduling):
    ``vtime`` advances by billed-seconds/weight, so heavier groups
    accrue slower and win eligibility more often. ``name`` is the
    account key (manager-scoped by the serving plane, so two servers'
    same-named groups never share one account); ``label`` is the
    human-facing group path used for the metric series."""

    __slots__ = ("name", "label", "weight", "vtime", "device_seconds",
                 "quanta")

    def __init__(self, name: str, weight: int = 1,
                 label: Optional[str] = None):
        self.name = name
        self.label = label if label is not None else name
        self.weight = max(int(weight), 1)
        self.vtime = 0.0
        self.device_seconds = 0.0
        self.quanta = 0


class TaskHandle:
    def __init__(self, scheduler: "DeviceScheduler", name: str,
                 share: Optional[GroupShare] = None, devices: int = 1):
        self.scheduler = scheduler
        self.name = name
        self.share = share
        #: chips this task's quanta occupy (mesh queries hold the whole
        #: mesh per quantum): billed seconds multiply by it so a
        #: weight-1 tenant cannot buy n chips for the price of one
        self.devices = max(int(devices), 1)
        self.device_seconds = 0.0
        self.quanta = 0
        self.closed = False
        #: query-level abort (worker DELETE /v1/query): a task thread
        #: blocked waiting for its device turn must notice the abort
        #: promptly instead of running one more quantum for a dead query
        self.aborted = threading.Event()
        #: input-stall seconds accrued DURING the current quantum (the
        #: scan prefetcher's consumer waits, exec/scancache.py): credited
        #: back when the quantum closes so device-time fairness bills
        #: compute, not waiting on host-side decode
        self.stall_credit = 0.0

    @property
    def level(self) -> int:
        lv = 0
        for i, t in enumerate(LEVEL_THRESHOLDS):
            if self.device_seconds >= t:
                lv = i
        return lv

    def close(self) -> None:
        self.scheduler.remove(self)


class DeviceScheduler:
    """One per process (one device); tasks round through it."""

    def __init__(self):
        # checked_lock: acquisition edges feed the runtime lock-order
        # validator under pytest (_devtools/lockcheck.py); plain Lock
        # in production
        from .._devtools.lockcheck import checked_lock
        self._lock = checked_lock("taskexec.scheduler")
        self._cv = threading.Condition(self._lock)
        self._tasks: List[TaskHandle] = []
        self._waiting: List[TaskHandle] = []
        self._running: Optional[TaskHandle] = None
        self._running_depth = 0
        #: group key -> GroupShare (the "" default group is created on
        #: first ungrouped task; serving-plane keys are manager-scoped).
        #: Bounded: idle shares beyond _MAX_SHARES evict oldest-first,
        #: so restart-per-tenant / embedded-server churn cannot grow
        #: this dict (or the group_snapshot denominator) forever.
        self._shares: dict = {}
        #: ident of the thread executing the current quantum's fn():
        #: stall credits only attach when the STALLED thread is the one
        #: being billed (a query running outside the scheduler must not
        #: discount another query's quantum)
        self._running_thread: Optional[int] = None

    def task(self, name: str = "", group: str = "",
             weight: int = 1,
             label: Optional[str] = None,
             devices: int = 1) -> TaskHandle:
        with self._lock:
            share = self._shares.get(group)
            if share is None:
                share = self._shares[group] = GroupShare(group, weight,
                                                         label)
            else:
                share.weight = max(int(weight), 1)
            # idle-return clamp: a group with no active task competes
            # from the current floor — its idle period is not device
            # debt it may burn down at everyone else's expense
            active = {t.share for t in self._tasks
                      if t.share is not None and t.share is not share}
            if active and not any(t.share is share for t in self._tasks):
                floor = min(s.vtime for s in active)
                if share.vtime < floor:
                    share.vtime = floor
            h = TaskHandle(self, name, share, devices=devices)
            self._tasks.append(h)
            if len(self._shares) > _MAX_SHARES:
                live = {t.share for t in self._tasks
                        if t.share is not None}
                for key in list(self._shares):
                    if len(self._shares) <= _MAX_SHARES:
                        break
                    if self._shares[key] not in live:
                        del self._shares[key]
        return h

    def group_shares(self) -> dict:
        """Per-group ledger snapshot (system.runtime.resource_groups)."""
        with self._lock:
            return {name: {"weight": s.weight, "vtime": s.vtime,
                           "device_seconds": s.device_seconds,
                           "quanta": s.quanta}
                    for name, s in self._shares.items()}

    def remove(self, handle: TaskHandle) -> None:
        with self._cv:
            handle.closed = True
            if handle in self._tasks:
                self._tasks.remove(handle)
            self._cv.notify_all()

    @staticmethod
    def _wait_key(t: TaskHandle):
        """Group virtual time first (stride fairness across groups),
        then the multilevel-feedback order within the group."""
        vtime = t.share.vtime if t.share is not None else 0.0
        return (vtime, t.level, t.device_seconds)

    def _eligible(self, handle: TaskHandle) -> bool:
        if self._running is handle:
            return True       # re-entrant: tasks of one query (pipeline
            # stages feeding each other) must not serialize against
            # themselves — only against OTHER queries
        if self._running is not None:
            return False
        best = min(self._waiting, key=self._wait_key)
        return best is handle

    def run_quantum(self, handle: Optional[TaskHandle],
                    fn: Callable[[], R]) -> R:
        """Run ``fn`` (one batch's worth of device dispatches) when it is
        this task's turn; account its wall time as device time."""
        if handle is None:
            return fn()
        if handle.aborted.is_set():
            from ..errors import QueryCancelledError
            raise QueryCancelledError("query aborted")
        t_wait = time.perf_counter()
        wait = (TRACER.span("sched-wait", task=handle.name,
                            level=handle.level)
                if TRACER.enabled else None)
        with self._cv:
            self._waiting.append(handle)
            try:
                while not self._eligible(handle):
                    if handle.aborted.is_set():
                        from ..errors import QueryCancelledError
                        raise QueryCancelledError("query aborted")
                    self._cv.wait(timeout=1.0)
            finally:
                self._waiting.remove(handle)
            self._running = handle
            self._running_thread = threading.get_ident()
            self._running_depth += 1
        if wait is not None:
            wait.finish()
        t0 = time.perf_counter()
        _WAIT_SECONDS.observe(t0 - t_wait)
        span = (TRACER.span("quantum", task=handle.name,
                            level=handle.level)
                if TRACER.enabled else None)
        try:
            result = fn()
            # fixed-throughput device model: pad the quantum to the
            # floor while HOLDING the device, so capacity is
            # per-worker and additive across workers
            device_floor_pad(time.perf_counter() - t0)
            return result
        finally:
            dt = time.perf_counter() - t0
            _QUANTA.inc()
            with self._cv:
                # input-stall credit (note_stall): time this quantum
                # spent blocked on the scan prefetcher is not device
                # time — billing it would climb an input-bound query up
                # the levels for compute it never dispatched
                credit = min(handle.stall_credit, dt)
                handle.stall_credit = 0.0
                # per-chip billing: a quantum on an n-device mesh
                # consumed n chip-seconds of the fleet per wall second
                billed = (dt - credit) * handle.devices
                _DEVICE_SECONDS.inc(billed)
                _CHIP_QUANTA.inc(handle.devices)
                handle.device_seconds += billed
                handle.quanta += 1
                if handle.share is not None:
                    # stride accounting: billed seconds advance the
                    # group's virtual time inversely to its weight
                    share = handle.share
                    share.vtime += billed / share.weight
                    share.device_seconds += billed
                    share.quanta += 1
                    if share.label:
                        REGISTRY.counter(
                            "resource_group_device_seconds_total."
                            f"{share.label}").inc(billed)
                self._running_depth -= 1
                if self._running_depth == 0:
                    self._running = None
                    self._running_thread = None
                self._cv.notify_all()
            if span is not None:
                # what the quantum was billed, to set beside the device
                # records launched during it
                span.annotate(billed_s=billed, stall_credit_s=credit)
                span.finish()

    @contextmanager
    def stalled(self, handle: Optional[TaskHandle]):
        """Release the device for the duration of a blocking INPUT
        wait inside a quantum (an exchange consumer parked on remote
        pages), re-acquiring through normal eligibility on exit.

        ``note_stall`` credits the TIME; this releases the DEVICE.
        Without it a consumer blocked on another worker's producer
        holds this worker's device, and two workers whose consumers
        wait on each other's starved producers deadlock the fleet —
        the multi-process cluster's version of the classic
        quantum-holder-waits-on-queued-producer cycle (single-process
        clusters never see it: all workers share one scheduler and a
        query's tasks share one re-entrant handle)."""
        ident = threading.get_ident()
        with self._cv:
            # the calling thread is inside run_quantum for this handle
            # (it owns one nesting level), so giving that level back is
            # safe even when a sibling thread of the same query is the
            # recorded runner
            held = (handle is not None and self._running is handle
                    and self._running_depth > 0)
            if held:
                self._running_depth -= 1
                if self._running_depth == 0:
                    self._running = None
                    self._running_thread = None
                REGISTRY.counter("device_stall_release_total").inc()
                self._cv.notify_all()
        try:
            yield
        finally:
            if held:
                # re-acquire as soon as the device frees: this is the
                # CONTINUATION of a quantum already granted through
                # fair eligibility, not a new one — rejoining the
                # fair queue here would bill one full queue rotation
                # per input page, quantizing exchange-bound queries to
                # the whole cluster's quantum length. Abort is NOT an
                # escape hatch: the nesting level must be restored so
                # the enclosing run_quantum's bookkeeping stays
                # balanced; the body's own cancellation check raises
                # right after.
                with self._cv:
                    while not (self._running is None
                               or self._running is handle):
                        self._cv.wait(timeout=1.0)
                    self._running = handle
                    self._running_thread = ident
                    self._running_depth += 1

    def note_stall(self, seconds: float) -> None:
        """Record input-stall time (the scan pipeline's consumer waited
        on a prefetch queue) against the currently-running quantum —
        only when the caller IS that quantum's thread, so a query
        stalling outside the scheduler (init plans, fair_scheduling off)
        never discounts another query's bill."""
        with self._cv:
            if self._running is not None \
                    and self._running_thread == threading.get_ident():
                self._running.stall_credit += seconds


#: process-wide scheduler (one real device per process)
GLOBAL = DeviceScheduler()
