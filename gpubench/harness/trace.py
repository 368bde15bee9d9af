"""The traced slice of a ``--trace 1`` run.

Over the middle of the window (``SLICE``) the run records:

- the card's operations, from ``torch.profiler``'s CUDA records (kernels,
  copies, sets), as (name, stream, start, end) in nanoseconds;
- the engine's host spans (``obs/trace.TRACER``: ``plan``, operators,
  ``device-sync``);
- beside each CUDA record, the correlation id of the CUDA runtime call
  that launched it, and those calls (``link``), so that ``attribute``
  charges a record to the span that launched it.

The reduction functions below take plain lists, so they are tested
without a card. Each runs in time near-linear in the records, gaps,
spans and statements it reads: a traced slice of a fast cell holds
about a million records and as many idle gaps.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: the traced slice, as shares of the window
SLICE = (0.25, 0.75)
#: entries of each breakdown list
TOP = 10

Record = Tuple[str, int, int, int]        # name, stream, start, end (ns)
Launch = Tuple[int, int, int]       # thread, launch instant (ns), correlation
#: a CUDA record with the correlation id of its launch
Linked = Tuple[str, int, int, int, int]


def union(intervals: Sequence[Tuple[int, int]], lo: int, hi: int):
    """(busy nanoseconds, idle gaps) of intervals clipped to [lo, hi]."""
    busy, gaps = 0, []
    cur = lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def device_ops(records: Sequence[Record], top: int = TOP):
    """[name, seconds] of the operations that took most device time."""
    by: Dict[str, int] = {}
    for name, _, a, b in records:
        by[name] = by.get(name, 0) + (b - a)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], ns / 1e9] for name, ns in ranked]


def _activity(span: Optional[Dict], in_flight: bool) -> str:
    if span is None:
        return "statement, no span open" if in_flight \
            else "no statement out"
    what = span.get("attrs", {}).get("what")
    return f"{span['name']}:{what}" if what else span["name"]


def host_activity(mid_s: float, spans: Sequence[Dict],
                  in_flight: bool) -> str:
    """What the host was doing at ``mid_s`` (epoch seconds): the innermost
    engine span open then, or whether a statement was out at all."""
    best = None
    for s in spans:
        if s["start"] <= mid_s <= s["end"]:
            if best is None or (s["start"], -s["end"]) > \
                    (best["start"], -best["end"]):
                best = s
    return _activity(best, in_flight)


def idle_gaps(gaps: Sequence[Tuple[int, int]], ns_to_epoch: int,
              spans: Sequence[Dict], out_at: Callable[[float], bool],
              top: int = TOP):
    """[name, seconds]: idle device time summed by what the host was
    doing at each gap's midpoint (``host_activity``; ``out_at(epoch_s)``
    says whether a statement was out).

    One sweep over the midpoints in ascending order: the spans that
    opened by the midpoint wait on a heap whose top is the span
    ``host_activity`` picks (latest start, then earliest end, then first
    in ``spans``), and a top that closed before the midpoint is dropped
    for good, since the midpoints only grow."""
    mids = [((a + b) / 2 + ns_to_epoch) / 1e9 for a, b in gaps]
    names: List[str] = [""] * len(gaps)
    order = sorted(range(len(spans)), key=lambda i: spans[i]["start"])
    heap: List[Tuple[float, float, int]] = []   # (-start, end, index)
    j = 0
    for g in sorted(range(len(gaps)), key=mids.__getitem__):
        mid = mids[g]
        while j < len(order) and spans[order[j]]["start"] <= mid:
            i = order[j]
            heapq.heappush(heap, (-spans[i]["start"], spans[i]["end"], i))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        names[g] = _activity(spans[heap[0][2]], True) if heap \
            else _activity(None, out_at(mid))
    by: Dict[str, float] = {}
    for (a, b), name in zip(gaps, names):
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def cover(intervals: Iterable[Tuple[float, Optional[float]]]
          ) -> Callable[[float], bool]:
    """Whether ``t`` lies in some closed interval ``[a, b]`` of
    ``intervals`` (``b`` None: open to the end): their union, merged
    once, asked by bisection."""
    starts: List[float] = []
    ends: List[float] = []
    for a, b in sorted((a, math.inf if b is None else b)
                       for a, b in intervals):
        if b < a:
            continue
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]
    return inside


def attribute(records: Sequence[Linked], launches: Sequence[Launch],
              spans: Sequence[Dict], prefix: str = "") -> List[Optional[Dict]]:
    """For each record, the innermost span whose name starts with
    ``prefix`` that was open on the record's launching thread at its
    launch instant; None where no such span was open or the launch was
    not recorded. Innermost is the latest to open: a sweep over each
    thread's launches in time order keeps its spans on a stack by
    opening time and drops those that closed from the top."""
    when = {corr: (thread, t) for thread, t, corr in launches}
    asked: Dict[int, List[Tuple[int, int]]] = {}
    for i, rec in enumerate(records):
        hit = when.get(rec[4])
        if hit is not None:
            asked.setdefault(hit[0], []).append((hit[1], i))
    by_thread: Dict[int, List[Dict]] = {}
    for s in spans:
        if s.get("thread") is not None and "startNs" in s \
                and s["name"].startswith(prefix):
            by_thread.setdefault(s["thread"], []).append(s)
    out: List[Optional[Dict]] = [None] * len(records)
    for thread, queries in asked.items():
        mine = sorted(by_thread.get(thread, ()),
                      key=lambda s: (s["startNs"], -s["endNs"]))
        stack: List[Dict] = []
        j = 0
        for t, i in sorted(queries):
            while j < len(mine) and mine[j]["startNs"] <= t:
                stack.append(mine[j])
                j += 1
            # every span above the top's is later to open and closed
            while stack and stack[-1]["endNs"] < t:
                stack.pop()
            out[i] = stack[-1] if stack else None
    return out


def epoch_offset(first_ns: int, wall_ns: int, mono_ns: int) -> int:
    """What to add to the profiler's timestamps to get epoch
    nanoseconds: they are read either on the epoch or on the monotonic
    clock."""
    if abs(first_ns - wall_ns) <= abs(first_ns - mono_ns):
        return 0
    return wall_ns - mono_ns


def _split(events, device_type):
    """In one pass over the profiler's events: the CUDA records with the
    correlation ids of their launches, and the CUDA runtime or driver
    calls (``cuda*``, ``cu*``) as launches. The profiler's own host
    records of a launch (module loading, activity buffers) share its
    correlation id but name no thread, and are not such calls."""
    cuda: List[Linked] = []
    calls: List[Launch] = []
    for e in events:
        if e.device_type() == device_type:
            a = int(e.start_ns())
            cuda.append((e.name(), int(e.device_resource_id()), a,
                         a + int(e.duration_ns()), int(e.correlation_id())))
        elif e.name().startswith("cu"):
            calls.append((int(e.device_resource_id()), int(e.start_ns()),
                          int(e.correlation_id())))
    return cuda, calls


def _linked(cuda: Sequence[Linked], calls: Sequence[Launch], lo: int,
            hi: int):
    """(the CUDA records that overlap [lo, hi], unclipped; the launches
    of those records)."""
    kept = [r for r in cuda if r[3] > lo and r[2] < hi]
    wanted = {r[4] for r in kept}
    return kept, [c for c in calls if c[2] in wanted]


def link(events, device_type, lo: int, hi: int):
    """(correlation ids aligned with the CUDA records ``Recorder.stop``
    keeps of ``events`` for the profiler-clock bounds [lo, hi], launch
    records of those ids)."""
    kept, launches = _linked(*_split(events, device_type), lo, hi)
    return [r[4] for r in kept], launches


@dataclasses.dataclass
class Slice:
    """What a traced slice holds once it has stopped: the CUDA records,
    the spans, and each record's correlation id (aligned with
    ``records``) with the runtime's launch records."""
    start_epoch: float
    stop_epoch: float
    records: List[Record]
    ns_to_epoch: int
    spans: List[Dict]
    correlations: List[int] = dataclasses.field(default_factory=list)
    launches: List[Launch] = dataclasses.field(default_factory=list)
    #: ``busy`` and ``charged``, worked out once for every reader
    _memo: Dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def seconds(self) -> float:
        return self.stop_epoch - self.start_epoch

    def bounds_ns(self) -> Tuple[int, int]:
        """The slice on the profiler's clock."""
        return (int(self.start_epoch * 1e9) - self.ns_to_epoch,
                int(self.stop_epoch * 1e9) - self.ns_to_epoch)

    def busy(self):
        """(busy nanoseconds, idle gaps) of the CUDA records over the
        slice, on the profiler's clock."""
        if "busy" not in self._memo:
            self._memo["busy"] = union(
                [(a, b) for _, _, a, b in self.records], *self.bounds_ns())
        return self._memo["busy"]

    def linked(self) -> List[Linked]:
        return [r + (c,) for r, c in zip(self.records, self.correlations)]

    def charged(self, prefix: str = "") -> List[Optional[Dict]]:
        """``attribute`` over this slice, aligned with ``records``."""
        key = ("charged", prefix)
        if key not in self._memo:
            self._memo[key] = attribute(self.linked(), self.launches,
                                        self.spans, prefix)
        return self._memo[key]

    def launch_instants(self) -> List[Optional[int]]:
        """Each record's launch instant, or None."""
        when = {corr: t for _, t, corr in self.launches}
        return [when.get(c) for c in self.correlations]


def breakdown(sl: Slice, out_at: Callable[[float], bool]) -> Dict:
    """The traced result's ``breakdown``: the device operations that took
    most time, and the idle gaps by what the host was doing."""
    _, gaps = sl.busy()
    return {"device_ops": device_ops(sl.records),
            "idle_gaps": idle_gaps(gaps, sl.ns_to_epoch, sl.spans, out_at)}


class Recorder:
    """Starts and stops the traced slice on a CUDA device."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)

    def prepare(self) -> None:
        """Start the profiler in its warm-up step, before the window:
        starting it takes seconds, stepping it into recording does
        not."""
        torch = self.torch
        self._results = None

        def ready(prof):
            self._results = prof.profiler.kineto_results

        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=ready)
        self._prof.start()

    def start(self) -> None:
        from presto_tpu_torch.obs.trace import TRACER
        TRACER.clear()
        TRACER.enable(True)
        self._prof.step()                    # warm-up -> recording
        self._wall_ns, self._mono_ns = time.time_ns(), time.monotonic_ns()
        self._start = time.time()

    def stop(self) -> Slice:
        from presto_tpu_torch.obs.trace import TRACER
        torch = self.torch
        stop = time.time()
        self._prof.step()                    # recording -> results
        self._prof.stop()
        TRACER.enable(False)
        spans = [s for s in TRACER.export()
                 if s["end"] >= self._start and s["start"] <= stop]
        TRACER.clear()
        cuda, calls = _split(self._results.events() if self._results
                             else (), torch.autograd.DeviceType.CUDA)
        offset = epoch_offset(min((r[2] for r in cuda), default=0),
                              self._wall_ns, self._mono_ns)
        lo = int(self._start * 1e9) - offset
        hi = int(stop * 1e9) - offset
        kept, launches = _linked(cuda, calls, lo, hi)
        records = [(n, s, max(a, lo), min(b, hi)) for n, s, a, b, _ in kept]
        torch.cuda.synchronize(self.device)
        return Slice(self._start, stop, records, offset, spans,
                     [r[4] for r in kept], launches)
