"""The traced slice of a ``--trace 1`` run.

Over the middle of the window (``SLICE``) the run records:

- the card's operations, from ``torch.profiler``'s CUDA records (kernels,
  copies, sets), as (name, stream, start, end) in nanoseconds;
- the engine's host spans (``obs/trace.TRACER``: ``plan``, operators,
  ``device-sync``).

The reduction functions below take plain lists, so they are tested
without a card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

#: the traced slice, as shares of the window
SLICE = (0.25, 0.75)
#: entries of each breakdown list
TOP = 10

Record = Tuple[str, int, int, int]        # name, stream, start, end (ns)


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
    if best is None:
        return "statement, no span open" if in_flight \
            else "no statement out"
    what = best.get("attrs", {}).get("what")
    return f"{best['name']}:{what}" if what else best["name"]


def idle_gaps(gaps: Sequence[Tuple[int, int]], ns_to_epoch: int,
              spans: Sequence[Dict], out_at, top: int = TOP):
    """[name, seconds]: idle device time summed by what the host was
    doing (``out_at(epoch_s)`` says whether a statement was out)."""
    by: Dict[str, float] = {}
    for a, b in gaps:
        mid = ((a + b) / 2 + ns_to_epoch) / 1e9
        name = host_activity(mid, spans, out_at(mid))
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def epoch_offset(first_ns: int, wall_ns: int, mono_ns: int) -> int:
    """What to add to the profiler's timestamps to get epoch
    nanoseconds: they are read either on the epoch or on the monotonic
    clock."""
    if abs(first_ns - wall_ns) <= abs(first_ns - mono_ns):
        return 0
    return wall_ns - mono_ns


@dataclasses.dataclass
class Slice:
    """What a traced slice holds once it has stopped."""
    start_epoch: float
    stop_epoch: float
    records: List[Record]
    ns_to_epoch: int
    spans: List[Dict]

    @property
    def seconds(self) -> float:
        return self.stop_epoch - self.start_epoch

    def busy(self):
        """(busy nanoseconds, idle gaps) of the CUDA records over the
        slice, on the profiler's clock."""
        lo = int(self.start_epoch * 1e9) - self.ns_to_epoch
        hi = int(self.stop_epoch * 1e9) - self.ns_to_epoch
        return union([(a, b) for _, _, a, b in self.records], lo, hi)


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
        records = []
        for e in (self._results.events() if self._results else ()):
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            a = int(e.start_ns())
            records.append((e.name(), int(e.device_resource_id()), a,
                            a + int(e.duration_ns())))
        offset = epoch_offset(min((r[2] for r in records), default=0),
                              self._wall_ns, self._mono_ns)
        lo = int(self._start * 1e9) - offset
        hi = int(stop * 1e9) - offset
        records = [(n, s, max(a, lo), min(b, hi))
                   for n, s, a, b in records if b > lo and a < hi]
        torch.cuda.synchronize(self.device)
        return Slice(self._start, stop, records, offset, spans)
