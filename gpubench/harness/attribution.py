"""Charging the traced slice's CUDA records to the engine spans that
launched them.

``torch.profiler`` keeps, beside each CUDA record (kernel, copy, set),
the CUDA runtime's record of the call that launched it: the same
correlation id, the launching thread (the low 32 bits of its
``threading.get_ident()``, as ``device_resource_id``) and the launch
instant, on the clock the engine's spans are stamped with
(``presto_tpu_torch/obs/trace.clock_ns``). Each span carries the thread
it opened on and its query, so a record is charged to the innermost span
open on its launching thread at its launch instant (``trace.attribute``),
and through that span to an operator and a query. ``trace.Recorder``
keeps the launch records of every traced slice (``trace.link``).

``python3 gpubench/attribute.py --workload <cell> --seed <n> --seconds
<s>`` runs a cell as ``run.py --trace 1`` does, adds the per-layer
metrics that read the launches and ``queries_per_s`` to the result
line, and prints on standard error the device time a
statement by template and by operator, and what share of the busy time
a span was charged.
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import spec, trace
from .trace import attribute, link  # noqa: F401  (the charging's entry points)

#: the per-layer metrics that read the launch records
LAUNCH_METRICS = (("agg_device_ms_per_query", "ms"),
                  ("quantum_billing_gap_pct", "%"))

#: every traced slice keeps its launch records (``trace.Recorder.stop``)
LaunchSlice = trace.Slice


class LaunchRecorder(trace.Recorder):
    """``trace.Recorder`` that keeps its last slice for ``report``."""

    #: the slice of the last ``stop``
    last: Optional[trace.Slice] = None

    def stop(self) -> trace.Slice:
        LaunchRecorder.last = super().stop()
        return LaunchRecorder.last


def done_in_slice(ctx) -> list:
    """Statements completed in the traced slice (the denominator of
    ``device_ms_per_query``)."""
    sl = ctx.slice
    t0, t1 = (x - ctx.window_epoch for x in (sl.start_epoch, sl.stop_epoch))
    return [s for s in ctx.completed() if t0 <= s.done <= t1]


def launch_slice(ctx) -> Optional[trace.Slice]:
    """The context's slice where it holds launch records and spans that
    name their thread (the engine's since they were added), else None."""
    sl = ctx.slice
    if sl is None or not sl.launches:
        return None
    if not any(s.get("thread") is not None for s in sl.spans):
        return None
    return sl


# -- the split on standard error ------------------------------------------------

def _ns(rec) -> int:
    return rec[3] - rec[2]


def report(sl: trace.Slice, template_of: Callable[[str], Optional[str]]
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
