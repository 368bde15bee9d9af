"""Charging the traced slice's CUDA records to the engine spans that
launched them.

``torch.profiler`` keeps, beside each CUDA record (kernel, copy, set),
the CUDA runtime's record of the call that launched it: the same
correlation id, the launching thread (the low 32 bits of its
``threading.get_ident()``, as ``device_resource_id``) and the launch
instant, on the clock the engine's spans are stamped with
(``presto_tpu_torch/obs/trace.clock_ns``). Each span carries the thread
it opened on and its query, so a record is charged to the innermost span
open on its launching thread at its launch instant (``attribute``), and
through that span to an operator and a query.

``LaunchRecorder`` is the traced slice's recorder that also keeps the
launch records; ``python3 gpubench/attribute.py --workload <cell> --seed
<n> --seconds <s>`` runs a cell as ``run.py --trace 1`` does with it, adds
the per-layer metrics that read the launches and ``queries_per_s`` to
the result line, and prints on standard error the device time a
statement by template and by operator, and what share of the busy time
a span was charged.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import spec, trace

Launch = Tuple[int, int, int]       # thread, launch instant (ns), correlation
#: a CUDA record with the correlation id of its launch
Linked = Tuple[str, int, int, int, int]

#: the per-layer metrics that read the launch records
LAUNCH_METRICS = (("agg_device_ms_per_query", "ms"),
                  ("quantum_billing_gap_pct", "%"))


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


@dataclasses.dataclass
class LaunchSlice(trace.Slice):
    """A traced slice with each CUDA record's correlation id (aligned
    with ``records``) and the runtime's launch records."""
    correlations: List[int] = dataclasses.field(default_factory=list)
    launches: List[Launch] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._charged: Dict[str, List[Optional[Dict]]] = {}

    def linked(self) -> List[Linked]:
        return [r + (c,) for r, c in zip(self.records, self.correlations)]

    def charged(self, prefix: str = "") -> List[Optional[Dict]]:
        """``attribute`` over this slice, aligned with ``records``."""
        if prefix not in self._charged:
            self._charged[prefix] = attribute(self.linked(), self.launches,
                                              self.spans, prefix)
        return self._charged[prefix]

    def launch_instants(self) -> List[Optional[int]]:
        """Each record's launch instant, or None."""
        when = {corr: t for _, t, corr in self.launches}
        return [when.get(c) for c in self.correlations]

    def bounds_ns(self) -> Tuple[int, int]:
        """The slice on the profiler's clock."""
        return (int(self.start_epoch * 1e9) - self.ns_to_epoch,
                int(self.stop_epoch * 1e9) - self.ns_to_epoch)


def link(events, device_type, lo: int, hi: int):
    """(correlation ids aligned with the CUDA records ``Recorder.stop``
    keeps of ``events`` for the profiler-clock bounds [lo, hi], launch
    records of those ids). A launch record is a CUDA runtime or driver
    call (``cuda*``, ``cu*``): the profiler's own host records of a
    launch (module loading, activity buffers) share its correlation id
    but name no thread."""
    correlations = []
    for e in events:
        if e.device_type() != device_type:
            continue
        a = int(e.start_ns())
        if a + int(e.duration_ns()) > lo and a < hi:
            correlations.append(int(e.correlation_id()))
    wanted = set(correlations)
    launches = [(int(e.device_resource_id()), int(e.start_ns()),
                 int(e.correlation_id())) for e in events
                if e.device_type() != device_type
                and e.name().startswith("cu")
                and int(e.correlation_id()) in wanted]
    return correlations, launches


class LaunchRecorder(trace.Recorder):
    """``trace.Recorder`` that also keeps the launch records."""

    #: the slice of the last ``stop``
    last: Optional[LaunchSlice] = None

    def stop(self) -> LaunchSlice:
        sl = super().stop()
        out = LaunchSlice(**{f.name: getattr(sl, f.name)
                             for f in dataclasses.fields(trace.Slice)})
        events = list(self._results.events()) if self._results else []
        out.correlations, out.launches = link(
            events, self.torch.autograd.DeviceType.CUDA, *out.bounds_ns())
        LaunchRecorder.last = out
        return out


def done_in_slice(ctx) -> list:
    """Statements completed in the traced slice (the denominator of
    ``device_ms_per_query``)."""
    sl = ctx.slice
    t0, t1 = (x - ctx.window_epoch for x in (sl.start_epoch, sl.stop_epoch))
    return [s for s in ctx.completed() if t0 <= s.done <= t1]


def launch_slice(ctx) -> Optional[LaunchSlice]:
    """The context's slice where it holds launch records and spans that
    name their thread (the engine's since they were added), else None."""
    sl = ctx.slice
    if not isinstance(sl, LaunchSlice) or not sl.launches:
        return None
    if not any(s.get("thread") is not None for s in sl.spans):
        return None
    return sl


# -- the split on standard error ------------------------------------------------

def _ns(rec) -> int:
    return rec[3] - rec[2]


def report(sl: LaunchSlice, template_of: Callable[[str], Optional[str]]
           ) -> List[str]:
    """Lines for standard error: the share of the busy time charged to a
    span and where the rest was launched; the device time a statement by
    template and by operator, over the statements whose ``query`` span
    lies in the slice (joined to the statement by its query id)."""
    owners = sl.charged()
    ops = sl.charged("op:")
    busy, _ = sl.busy()
    lo, hi = sl.bounds_ns()
    charged, _ = trace.union([(r[2], r[3]) for r, s in zip(sl.records, owners)
                              if s is not None], lo, hi)
    lines = [f"attribution: {charged / 1e9:.3f} s of {busy / 1e9:.3f} s "
             f"busy charged to a span ({100 * charged / max(busy, 1):.2f}%)"]
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for s in sl.spans:
        if s.get("thread") is not None and "startNs" in s:
            first[s["thread"]] = min(first.get(s["thread"], s["startNs"]),
                                     s["startNs"])
            last[s["thread"]] = max(last.get(s["thread"], s["endNs"]),
                                    s["endNs"])
    when = {corr: (thread, t) for thread, t, corr in sl.launches}
    why: Dict[str, int] = {}
    for r, c, s in zip(sl.records, sl.correlations, owners):
        if s is not None:
            continue
        hit = when.get(c)
        if hit is None:
            k = "launched before the slice (no launch record)"
        elif hit[0] not in first:
            k = "launched on a thread that opened no span"
        elif hit[1] < first[hit[0]]:
            k = "launched before its thread's first span"
        elif hit[1] > last[hit[0]]:
            k = "launched after its thread's last span closed"
        else:
            k = "launched between its thread's spans"
        why[k] = why.get(k, 0) + _ns(r)
    for k, ns in sorted(why.items(), key=lambda kv: -kv[1]):
        lines.append(f"attribution: not charged, {k}: {ns / 1e9:.3f} s")
    queries = {s["queryId"]: s for s in sl.spans
               if s["name"] == "query" and s.get("queryId")
               and lo <= s["startNs"] and s["endNs"] <= hi}
    count: Dict[str, int] = {}
    for q in queries:
        t = template_of(q) or "?"
        count[t] = count.get(t, 0) + 1
    per: Dict[Tuple[str, str], int] = {}
    for r, s in zip(sl.records, ops):
        if s is None or s.get("queryId") not in queries:
            continue
        key = (template_of(s["queryId"]) or "?", s["name"])
        per[key] = per.get(key, 0) + _ns(r)
    for t in sorted(count):
        total = sum(ns for (tt, _), ns in per.items() if tt == t)
        lines.append(f"device ms a statement, {t}: {total / 1e6 / count[t]:.3f}"
                     f" over {count[t]} statements in the slice")
        for (tt, op), ns in sorted(per.items(), key=lambda kv: -kv[1]):
            if tt == t:
                lines.append(f"  {t} {op}: {ns / 1e6 / count[t]:.3f} ms")
    # where the heaviest kernels were launched from
    by_kernel: Dict[str, Dict[str, int]] = {}
    for r, s in zip(sl.records, ops):
        k = by_kernel.setdefault(r[0], {})
        name = s["name"] if s is not None else "no operator span"
        k[name] = k.get(name, 0) + _ns(r)
    for kernel, where in sorted(by_kernel.items(),
                                key=lambda kv: -sum(kv[1].values()))[:3]:
        total = sum(where.values())
        lines.append(f"kernel {kernel[:90]}: {total / 1e9:.3f} s, " + ", ".join(
            f"{op} {100 * ns / total:.2f}%"
            for op, ns in sorted(where.items(), key=lambda kv: -kv[1])))
    return lines


def template_lookup(cell: spec.Cell, seed: int, per_client: int = 4000):
    """query id -> template of the statements the engine ran, from the
    query history's SQL text and the cell's instances of that seed."""
    from presto_tpu_torch.obs.history import HISTORY
    from .traffic import sequence
    by_sql = {}
    for c in range(int(cell.traffic["clients"])):
        for inst in itertools.islice(
                sequence(cell.config["suite"], cell.traffic, seed, c),
                per_client):
            by_sql[inst.sql.strip()] = inst.template
    by_qid = {r.get("query_id"): by_sql.get(str(r.get("query")).strip())
              for r in HISTORY.snapshot()}
    return by_qid.get


def main(argv=None, t_start: Optional[float] = None) -> int:
    from . import cell as cellmod
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(spec.HERE.parent, args.workload)
    # read under the trace too: the launch metrics, and the throughput,
    # to set the traced run's cost beside an untraced run of the seed
    have = {m.name for m in cell.metrics if m.kind == "per_layer"}
    cell.metrics += [spec.Metric(n, unit, "per_layer", {})
                     for n, unit in LAUNCH_METRICS
                     + (("queries_per_s", "queries/s"),) if n not in have]
    import torch
    if not torch.cuda.is_available():
        cellmod.log(f"{args.workload} needs a CUDA device")
        return 2
    # the run is run.py's with this recorder
    trace.Recorder = LaunchRecorder
    result = cellmod.run_cell(cell, args.seed, args.seconds, True, "cuda",
                              t_start)
    if LaunchRecorder.last is not None:
        for line in report(LaunchRecorder.last,
                           template_lookup(cell, args.seed)):
            cellmod.log(line)
    print(json.dumps(result), flush=True)
    return 0
