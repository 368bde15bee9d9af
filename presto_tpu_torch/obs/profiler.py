"""Device profiling and cost attribution of the port.

The counterpart of ``presto_tpu/obs/profiler.py`` (the role of the
reference's OperatorStats device accounting; tf.data's input-bound
versus compute-bound framing is the verdict surfaced). Host walls lie on
an asynchronous device, so this module holds the engine's device-level
account:

- ``KERNELS``: one record per hand-written CUDA kernel of
  ``presto_tpu_torch/csrc`` (the counterpart of the reference's
  ``EXECUTABLES``, which records jit executables; the port has none):
  launches, calls of the plain version on CPU tensors, profiled device
  seconds, the build seconds ``ops/kernels.build`` measures (in place of
  compile seconds) and bytes per call from the kernel's bound formula
  (each input read once, each output written once; the probe's lanes
  counted live and matched from its inputs and its ``cnt`` output, read
  back in profile mode only), in place of XLA's cost analysis. Eager torch ops have no record: their
  time is charged to the operator whose frame issued them.
- a **profile context** (``profiled()``): while active, each plan
  operator's iterator frame (``exec/stats.StatsCollector.wrap``)
  synchronizes the device at its entry and exit and is timed with a CUDA
  event pair, exclusive of its children's frames (the innermost frame
  wins, as ``operator_scope`` does); each kernel launch (``kernel_call``,
  the counterpart of ``profiled_call``) is bracketed by its own event
  pair and charged to the kernel's record and to the current operator.
  On a CPU device the host clock stands in for the events. Off (the
  default) the cost is one contextvar load per frame and per launch.
  A fused join chain (``exec/fused.py``) runs its head and tail inside
  the head join's frames, so its device time and its probe launches are
  charged to that join (the role of the reference's ``_TimedEntry``
  around its fused executables); the chain's interior joins, filters and
  projections never run on their own and get no frame.
- **HBM telemetry** (``sample_hbm``): the caching allocator's
  ``allocated_bytes.all.current`` / ``.peak`` and the card's memory size
  as gauges. A CPU device has none and gives ``[]``.

What a frame's number includes: the card's span over the frame, so idle
gaps while the host works inside the frame count too. That is the
per-operator wall on the device's clock, bounded below by the kernels it
ran. Two threads' frames on one stream would overlap each other's
intervals (a join's probe side runs on a producer thread), so profile
mode serializes frames per device: a frame holds the device's frame lock,
and a thread that blocks on another thread's work inside a frame
(``blocking()``: the local exchange's queue, a shared subplan's memo, a
shared scan, a scan's prefetch queue) closes its frames' segments and
releases the lock until it resumes. A table scan's split workers run in
a copy of the scan frame's context and decode each batch in a frame of
the scan (``resumed_frame``), so their host decode and device work are
charged to the scan, never to an operator they would overlap; they
decode while the operators wait on them, which the consumer's prefetch
stall then counts. Profile mode trades overlap for truth, as in the
reference; it is a per-query session property (``profile``), on under
EXPLAIN ANALYZE, and never on for plain queries.

``KERNELS`` feeds ``system.runtime.executables``
(``connectors/system.py``), and the per-operator frame seconds and kernel
bytes feed the query history's device columns (``obs/history.py``).

**Device-trace merging** (``write_merged_trace``, the CLI's
``--profile-out``): the CLI captures a ``torch.profiler`` trace (CPU and
CUDA activities) of the statements it runs and exports it as a Chrome
trace into a per-session subdirectory of the profile directory; the
newest session's events, shifted from the profiler's clock onto the
span tracer's epoch clock, are merged with the tracer's host spans into
one Perfetto timeline.
"""
from __future__ import annotations

import contextlib
import contextvars
import glob
import gzip
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from .metrics import REGISTRY

#: active profile session (None = off), checked at every frame and launch
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "presto_tpu_torch_profile", default=None)

#: (stats_collector, plan_node) of the operator whose iterator frame is
#: executing; innermost wins
_OP: contextvars.ContextVar = contextvars.ContextVar(
    "presto_tpu_torch_operator", default=None)

_DEVICE_SECONDS = REGISTRY.counter("kernel_device_seconds_total")


class KernelRecord:
    """One hand-written kernel's ledger. Its launches and plain calls
    are also the process's ``kernel_launches_total.<name>`` and
    ``kernel_plain_calls_total.<name>`` counters, so a worker's
    ``/v1/metrics`` shows the launches its own tasks made."""

    __slots__ = ("name", "kernel", "source", "launches", "plain_calls",
                 "profiled_calls", "device_time_s", "bytes_profiled",
                 "build_seconds", "_lock", "_launch_counter",
                 "_plain_counter")

    def __init__(self, name: str, kernel: str, source: str):
        self.name = name
        #: the ``ops/kernels.SOURCES`` key its build is recorded under
        self.kernel = kernel
        self.source = source
        self.launches = 0
        self.plain_calls = 0
        self.profiled_calls = 0
        self.device_time_s = 0.0
        self.bytes_profiled = 0
        self.build_seconds = 0.0
        self._lock = threading.Lock()
        self._launch_counter = REGISTRY.counter(
            f"kernel_launches_total.{name}")
        self._plain_counter = REGISTRY.counter(
            f"kernel_plain_calls_total.{name}")

    def note_call(self, launched: bool) -> None:
        with self._lock:
            if launched:
                self.launches += 1
            else:
                self.plain_calls += 1
        (self._launch_counter if launched else self._plain_counter).inc()

    def note_profiled(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.profiled_calls += 1
            self.device_time_s += seconds
            self.bytes_profiled += nbytes

    def to_row(self) -> Dict:
        calls = self.profiled_calls
        return {"name": self.name, "source": self.source,
                "launches": self.launches, "plain_calls": self.plain_calls,
                "profiled_calls": calls,
                "device_time_s": self.device_time_s,
                "build_seconds": self.build_seconds,
                "bytes_per_call": (self.bytes_profiled / calls
                                   if calls else None)}


class KernelRegistry:
    """Process-wide name -> KernelRecord."""

    def __init__(self):
        self._records: Dict[str, KernelRecord] = {}
        #: kernel source -> build seconds (a build may precede the import
        #: of the wrapper that registers the record)
        self._builds: Dict[str, float] = {}
        self._lock = threading.Lock()

    def register(self, name: str, kernel: str, source: str) -> KernelRecord:
        with self._lock:
            rec = self._records.get(name)
            if rec is None:
                rec = self._records[name] = KernelRecord(name, kernel,
                                                         source)
                rec.build_seconds = self._builds.get(kernel, 0.0)
            return rec

    def note_build(self, kernel: str, seconds: float) -> None:
        """Build seconds of the kernel source ``kernel``, from
        ``ops/kernels.build``."""
        with self._lock:
            self._builds[kernel] = seconds
            for rec in self._records.values():
                if rec.kernel == kernel:
                    rec.build_seconds = seconds

    def snapshot(self) -> List[Dict]:
        with self._lock:
            recs = list(self._records.values())
        recs.sort(key=lambda r: -r.device_time_s)
        return [r.to_row() for r in recs]


#: the process-wide kernel registry
KERNELS = KernelRegistry()


# -- device clocks ------------------------------------------------------------

class _FrameLock:
    """Re-entrant lock whose holder can give up all its holds while it
    blocks on another thread and take them back after (``blocking()``)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self, depth: int = 1) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                self._depth += depth
                return
            while self._owner is not None:
                self._cond.wait()
            self._owner, self._depth = me, depth

    def release(self) -> None:
        with self._cond:
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._cond.notify_all()

    def release_all(self) -> int:
        """Drop every hold of the calling thread; returns their count."""
        with self._cond:
            if self._owner != threading.get_ident():
                return 0
            depth, self._owner, self._depth = self._depth, None, 0
            self._cond.notify_all()
            return depth


class DeviceClock:
    """Time stamps on one device: CUDA events on the current stream, the
    host clock on the CPU; and the device's frame lock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.lock = _FrameLock()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def elapsed(self, start, end) -> float:
        """Seconds from ``start`` to ``end`` (waits for ``end``)."""
        if not self.cuda:
            return end - start
        end.synchronize()
        return start.elapsed_time(end) / 1e3


_CLOCKS: Dict[str, DeviceClock] = {}
_CLOCKS_LOCK = threading.Lock()


def device_clock(device) -> DeviceClock:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _CLOCKS_LOCK:
        clock = _CLOCKS.get(str(device))
        if clock is None:
            clock = _CLOCKS[str(device)] = DeviceClock(device)
        return clock


# -- profile context ----------------------------------------------------------

class ProfileSession:
    """Held by the ``_ACTIVE`` contextvar while a query profiles: the
    query's device clock."""

    __slots__ = ("clock",)

    def __init__(self, device):
        self.clock = device_clock(device)


@contextlib.contextmanager
def profiled(on: bool, device):
    """Time operator frames and kernel launches on ``device`` under this
    context (this thread, and threads started in a copy of its context,
    such as the local exchange's producer). The device has no default:
    CUDA work timed against a CPU clock would read the enqueue, not the
    work."""
    if not on:
        yield
        return
    token = _ACTIVE.set(ProfileSession(device))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def profiling_active() -> bool:
    return _ACTIVE.get() is not None


def active_session() -> Optional[ProfileSession]:
    return _ACTIVE.get()


@contextlib.contextmanager
def operator_scope(stats, node):
    """Attribute kernel launches made under this context to ``node`` on
    ``stats`` (a StatsCollector). Innermost scope wins."""
    token = _OP.set((stats, node))
    try:
        yield
    finally:
        _OP.reset(token)


class _Frame:
    __slots__ = ("seg_start", "inclusive", "children")

    def __init__(self, start):
        self.seg_start = start
        self.inclusive = 0.0
        self.children = 0.0


class _Stacks(threading.local):
    def __init__(self):
        self.frames: List[_Frame] = []


_STACKS = _Stacks()


@contextlib.contextmanager
def operator_frame(session: ProfileSession, stats, node):
    """One profiled iterator frame of ``node``: the device synchronized
    at entry and exit, the span between charged to ``stats`` exclusive of
    the child frames run inside it, kernel launches attributed to
    ``node``."""
    clock = session.clock
    stack = _STACKS.frames
    clock.lock.acquire()
    try:
        clock.sync()
        f = _Frame(clock.stamp())
        stack.append(f)
        try:
            with operator_scope(stats, node):
                yield
        finally:
            end = clock.stamp()
            clock.sync()
            f.inclusive += clock.elapsed(f.seg_start, end)
            stack.remove(f)
            if stack:
                stack[-1].children += f.inclusive
            stats.record_frame(node, max(f.inclusive - f.children, 0.0))
    finally:
        clock.lock.release()


def resumed_frame():
    """A frame of the current operator, for a thread that works on its
    behalf in a copy of its context (a table scan's split workers); a
    no-op unless profiling."""
    session = _ACTIVE.get()
    op = _OP.get()
    if session is None or op is None:
        return contextlib.nullcontext()
    return operator_frame(session, *op)


@contextlib.contextmanager
def blocking():
    """Around a wait on another thread's work: the calling thread's open
    frames stop their clocks and its frame lock is released (that thread
    may need it to make progress), both resumed after."""
    session = _ACTIVE.get()
    stack = _STACKS.frames
    if session is None or not stack:
        yield
        return
    clock = session.clock
    end = clock.stamp()
    clock.sync()
    for f in stack:
        f.inclusive += clock.elapsed(f.seg_start, end)
    depth = clock.lock.release_all()
    try:
        yield
    finally:
        if depth:
            clock.lock.acquire(depth)
        clock.sync()
        start = clock.stamp()
        for f in stack:
            f.seg_start = start


def kernel_call(record: KernelRecord, device: torch.device, nbytes,
                launch):
    """Run ``launch()`` (a kernel launch, or on a CPU tensor its plain
    version); under a profile context bracket it with a CUDA event pair
    (the host clock on the CPU) and charge the interval and
    ``nbytes(out)``, the launch's bound-formula bytes, to ``record`` and
    to the current operator. Off, ``nbytes`` is never called."""
    session = _ACTIVE.get()
    if session is None:
        return launch()
    clock = device_clock(device)
    start = clock.stamp()
    out = launch()
    seconds = clock.elapsed(start, clock.stamp())
    moved = int(nbytes(out))
    record.note_profiled(seconds, moved)
    _DEVICE_SECONDS.inc(seconds)
    op = _OP.get()
    if op is not None:
        stats, node = op
        stats.record_device(node, seconds, record, moved)
    return out


# -- verdict (tf.data's input-bound vs compute-bound framing) -----------------

def cost_verdict(stats) -> Optional[Dict]:
    """Classify a profiled query: device time of the non-scan operators
    (compute) against scan-side host time, the scan operators' exclusive
    wall (decode, staging) plus the consumer's prefetch stall (input).
    None when nothing was profiled."""
    from ..planner.plan import TableScanNode
    compute_s = 0.0
    scan_wall_s = 0.0
    for node, st in list(stats.by_node.items()):
        dev = getattr(st, "device_time_s", 0.0)
        if isinstance(node, TableScanNode):
            child_wall = sum(
                (stats.stats_for(c).wall_s
                 if stats.stats_for(c) is not None else 0.0)
                for c in node.children)
            scan_wall_s += max(st.wall_s - child_wall, 0.0)
        else:
            compute_s += dev
    input_s = scan_wall_s + getattr(stats, "prefetch_stall_s", 0.0)
    if compute_s <= 0.0 and input_s <= 0.0:
        return None
    if input_s > 2.0 * compute_s:
        verdict = "input-bound"
    elif compute_s > 2.0 * input_s:
        verdict = "compute-bound"
    else:
        verdict = "balanced"
    return {"verdict": verdict, "compute_s": compute_s,
            "input_s": input_s}


# -- HBM telemetry ------------------------------------------------------------

def sample_hbm(devices=None, registry=None) -> List[Dict]:
    """Sample each CUDA device's allocator into gauges
    (``hbm_in_use_bytes.<dev>`` / ``hbm_peak_bytes.<dev>``) and return
    the per-device docs: ``allocated_bytes.all.current`` and ``.peak``
    of ``torch.cuda.memory_stats``, and the card's memory size from
    ``torch.cuda.mem_get_info`` as the limit. A CPU device has no such
    stats and is skipped, so a CPU-only list gives ``[]``."""
    reg = registry if registry is not None else REGISTRY
    if devices is None:
        if not torch.cuda.is_available():
            return []
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out: List[Dict] = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        index = d.index if d.index is not None else \
            torch.cuda.current_device()
        ms = torch.cuda.memory_stats(index)
        in_use = int(ms.get("allocated_bytes.all.current", 0))
        peak = int(ms.get("allocated_bytes.all.peak", in_use))
        _, limit = torch.cuda.mem_get_info(index)
        label = f"cuda{index}"
        reg.gauge(f"hbm_in_use_bytes.{label}").set(in_use)
        reg.gauge(f"hbm_peak_bytes.{label}").set(peak)
        out.append({"device": label, "device_id": index,
                    "bytes_in_use": in_use, "peak_bytes_in_use": peak,
                    "bytes_limit": int(limit)})
    return out


def hbm_totals(devices=None, registry=None) -> Dict[str, int]:
    """Summed HBM sample: zeros when no device has memory stats."""
    docs = sample_hbm(devices, registry)
    return {
        "bytesInUse": sum(d["bytes_in_use"] for d in docs),
        "peakBytes": sum(d["peak_bytes_in_use"] for d in docs),
        "devices": len(docs),
    }


# -- device-trace merging (--profile-out) -------------------------------------

#: where a profile directory keeps its sessions, one subdirectory each
#: (the layout ``jax.profiler`` leaves, kept so one reader serves both)
TRACE_SESSIONS = os.path.join("plugins", "profile")


def device_trace_path(profile_dir: str) -> str:
    """A new session subdirectory of ``profile_dir`` and the Chrome-trace
    file a ``torch.profiler`` export of this session goes to."""
    session = os.path.join(profile_dir, TRACE_SESSIONS,
                           f"{time.strftime('%Y_%m_%d_%H_%M_%S')}_"
                           f"{time.time_ns() % 10**9:09d}")
    os.makedirs(session, exist_ok=True)
    return os.path.join(session, f"{os.getpid()}.trace.json")


def find_device_traces(profile_dir: str) -> List[str]:
    """Chrome-trace files from the NEWEST profiling session under a
    profile dir (``plugins/profile/<session>/*.trace.json[.gz]``). A
    reused ``--profile-out`` DIR accumulates sessions; merging any but
    the latest would interleave a past run's kernels onto the current
    host timeline."""
    pats = [os.path.join(profile_dir, TRACE_SESSIONS, "*",
                         "*.trace.json.gz"),
            os.path.join(profile_dir, TRACE_SESSIONS, "*", "*.trace.json")]
    found: List[str] = []
    for p in pats:
        found.extend(glob.glob(p))
    if not found:
        return []
    found.sort(key=lambda p: os.path.getmtime(p), reverse=True)
    newest_session = os.path.dirname(found[0])
    return [p for p in found if os.path.dirname(p) == newest_session]


def load_trace_events(path: str) -> List[Dict]:
    """The events of one Chrome-trace file. ``torch.profiler`` counts an
    event's ``ts`` in microseconds from the trace's
    ``baseTimeNanoseconds`` (an instant on the profiler's clock, which
    the span tracer stamps with: ``obs/trace.clock_ns``); such events
    come back shifted by it, onto the epoch microseconds the span
    tracer's events carry, so a kernel lands inside the host span that
    launched it."""
    from .trace import epoch_s
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        return list(doc or [])
    events = list(doc.get("traceEvents") or [])
    base = doc.get("baseTimeNanoseconds")
    if not isinstance(base, (int, float)) or not base:
        return events
    shift_us = epoch_s(base) * 1e6
    out = []
    for e in events:
        if isinstance(e.get("ts"), (int, float)):
            e = dict(e, ts=e["ts"] + shift_us)
        out.append(e)
    return out


def merge_chrome_traces(host: Dict, device_events: List[Dict]) -> Dict:
    """One Chrome-trace object holding the span tracer's host events AND
    the profiler's device tracks. Device pids are remapped above the
    host range so Perfetto shows them as separate processes instead of
    colliding lanes."""
    events = list(host.get("traceEvents") or [])
    base = max([int(e.get("pid", 0)) for e in events] + [0]) + 1000
    remap: Dict[int, int] = {}
    for e in device_events:
        e = dict(e)
        pid = e.get("pid")
        if isinstance(pid, int):
            if pid not in remap:
                remap[pid] = base + len(remap)
            e["pid"] = remap[pid]
        e.setdefault("cat", "device")
        events.append(e)
    out = dict(host)
    out["traceEvents"] = events
    return out


def write_merged_trace(path: str, spans: List[Dict],
                       profile_dir: str) -> str:
    """Merge the span tracer's export (with the mesh flight recorders'
    round tracks of its queries, ``obs/trace.chrome_trace``) and the
    newest ``torch.profiler`` session under ``profile_dir`` into one
    Perfetto-loadable JSON file. Missing or unreadable device traces
    degrade to a host-only trace: the file always lands."""
    from .trace import chrome_trace
    host = chrome_trace(spans)
    device_events: List[Dict] = []
    for p in find_device_traces(profile_dir):
        try:
            device_events.extend(load_trace_events(p))
        except (OSError, ValueError):
            continue
    merged = merge_chrome_traces(host, device_events)
    with open(path, "w") as f:
        json.dump(merged, f)
    return path
