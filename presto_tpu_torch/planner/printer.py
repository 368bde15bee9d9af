"""Plan printer for EXPLAIN and EXPLAIN ANALYZE.

The counterpart of the text half of ``presto_tpu/planner/printer.py``
(reference presto-main/.../sql/planner/planprinter/PlanPrinter.java,
textLogicalPlan). Under EXPLAIN ANALYZE each executed node carries its
profiled device time and its kernels' bytes (``[device ...]``), and the
runner appends the skew, scan-cache, kernels (``format_executables_summary``)
and verdict (``format_cost_verdict``) sections. The JSON, Graphviz,
distributed and IO renderings and the sections that read the mesh and
the result cache are not ported.
"""
from __future__ import annotations

from typing import List

from .plan import (
    AggregationNode, DistinctNode, FilterNode, GroupIdNode, JoinNode,
    LimitNode, OutputNode, PlanNode, ProjectNode, SemiJoinNode, SortNode,
    TableScanNode, TopNNode, UnionNode, ValuesNode,
)
from .planner import LogicalPlan


def print_plan(plan: LogicalPlan, stats=None) -> str:
    """Text plan; with a StatsCollector, each node carries its runtime
    stats (EXPLAIN ANALYZE)."""
    lines: List[str] = []
    _walk(plan.root, 0, lines, stats)
    for i, init in enumerate(plan.init_plans):
        lines.append(f"InitPlan[{i}]:")
        _walk(init, 1, lines, stats)
    if stats is not None:
        lines.append(
            f"Total: {stats.total_wall_s * 1e3:,.0f}ms "
            f"(planning {stats.planning_s * 1e3:,.0f}ms)")
    return "\n".join(lines)


def format_skew_summary(stats, straggler_ratio: float = 3.0,
                        min_wall_ms: float = 10.0) -> str:
    """EXPLAIN ANALYZE's skew section: per-table split wall-time and
    batch-count spread, flagging splits whose wall exceeds
    ``straggler_ratio`` x the median of the table's other splits. Empty
    when no table had two splits."""
    import statistics
    by_table: dict = {}
    for s in stats.splits:
        by_table.setdefault(s["table"], []).append(s)
    lines = []
    for table in sorted(by_table):
        splits = by_table[table]
        if len(splits) < 2:
            continue
        walls = [float(s["wallMs"]) for s in splits]
        batches = [int(s["batches"]) for s in splits]
        med = statistics.median(walls)
        ratio = max(walls) / med if med > 0 else float("inf")
        stragglers = []
        for i, w in enumerate(walls):
            omed = statistics.median(walls[:i] + walls[i + 1:])
            if omed >= min_wall_ms and w > straggler_ratio * omed:
                stragglers.append(splits[i]["split"])
        line = (f"  {table}: {len(splits)} splits, wall med "
                f"{med:,.1f}ms max {max(walls):,.1f}ms (x{ratio:,.1f}), "
                f"batches {min(batches)}..{max(batches)}")
        if stragglers:
            line += (" STRAGGLER split"
                     f"{'s' if len(stragglers) > 1 else ''} "
                     f"{sorted(stragglers)}")
        lines.append(line)
    if not lines:
        return ""
    return "\n".join(["Skew (splits per table):"] + lines)


def format_scan_cache_summary(stats, device) -> str:
    """EXPLAIN ANALYZE's scan-cache section: this query's split-level
    cache outcomes, the resident set on ``device``, and how long the
    consumer stalled waiting on the prefetcher (input-bound queries show
    a large stall). Empty when the query touched no cacheable scan and
    never stalled."""
    hits = stats.cache_hits
    misses = stats.cache_misses
    stall_s = stats.prefetch_stall_s
    if not hits and not misses and stall_s < 1e-4:
        return ""
    from ..exec.scancache import CACHE
    return (f"Scan cache: {hits} split hit{'s' if hits != 1 else ''} / "
            f"{misses} miss{'es' if misses != 1 else ''}, resident "
            f"{CACHE.resident_bytes(device) / 1048576.0:,.1f} MiB; "
            f"prefetch stall {stall_s * 1e3:,.1f}ms")


def format_executables_summary(stats, max_rows: int = 12) -> str:
    """EXPLAIN ANALYZE's kernels section under profile mode: the hand
    kernels this query launched, by device time, with their build
    seconds and bound-formula bytes per call (obs/profiler.KERNELS holds
    the process-lifetime view). Empty when none was profiled."""
    used = stats.executables_used()
    if not used:
        return ""
    lines = ["Kernels (this query, by device time):"]
    for e in used[:max_rows]:
        lines.append(
            f"  {e['name']:<24} x{e['invocations']:<5} device "
            f"{e['device_time_s'] * 1e3:,.1f}ms, build "
            f"{e['build_seconds']:,.2f}s, "
            f"{_si(e['bytes_per_call'])}B per call")
    if len(used) > max_rows:
        lines.append(f"  ... and {len(used) - max_rows} more")
    return "\n".join(lines)


def format_cost_verdict(stats) -> str:
    """Closing EXPLAIN ANALYZE line, tf.data's framing: is the query
    input-bound (scan decode and staging plus prefetch stall dominate)
    or compute-bound (the other operators' device time dominates)? Empty
    when nothing was profiled."""
    from ..obs.profiler import cost_verdict
    v = cost_verdict(stats)
    if v is None:
        return ""
    return (f"Verdict: {v['verdict']} "
            f"(device compute {v['compute_s'] * 1e3:,.1f}ms vs input "
            f"{v['input_s'] * 1e3:,.1f}ms scan+stall)")


def _si(v: float) -> str:
    """Compact engineering notation for byte totals."""
    for thresh, unit in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(v) >= thresh:
            return f"{v / thresh:,.2f}{unit}"
    return f"{v:,.0f}"


def _label(n: PlanNode) -> str:
    cols = ", ".join(f"{f.name}:{f.type.display()}" for f in n.fields)
    if isinstance(n, TableScanNode):
        return f"TableScan[{n.table}] => [{cols}]"
    if isinstance(n, FilterNode):
        return f"Filter[{n.predicate!r}]"
    if isinstance(n, ProjectNode):
        return f"Project => [{cols}]"
    if isinstance(n, AggregationNode):
        aggs = ", ".join(f"{a.name}:={a.fn}({a.arg})" for a in n.aggs)
        dense = ""
        if n.key_bounds:
            spans = ["?" if b is None else f"{b[0]}..{b[1]}"
                     for b in n.key_bounds]
            dense = f", bounds=[{', '.join(spans)}]"
        return (f"Aggregate[{n.step}, keys={list(n.group_indices)}"
                f"{dense}] => [{aggs}]")
    if isinstance(n, JoinNode):
        return (f"Join[{n.join_type}, {n.distribution}, "
                f"L{list(n.left_keys)}=R{list(n.right_keys)}"
                f"{', unique' if n.build_unique else ''}"
                f"{_bounds_label(n.key_bounds)}]")
    if isinstance(n, SemiJoinNode):
        res = ", residual" if n.residual is not None else ""
        return (f"SemiJoin[{'anti' if n.negated else 'semi'}, "
                f"{n.distribution}, keys={list(n.source_keys)}{res}"
                f"{_bounds_label(n.key_bounds)}]")
    if isinstance(n, SortNode):
        return f"Sort[{_keys_label(n.keys)}]"
    if isinstance(n, TopNNode):
        return f"TopN[{n.count}, {_keys_label(n.keys)}]"
    if isinstance(n, LimitNode):
        return f"Limit[{n.count}]"
    if isinstance(n, DistinctNode):
        return "Distinct"
    if isinstance(n, UnionNode):
        return f"Union[{'distinct' if n.distinct else 'all'}]"
    if isinstance(n, ValuesNode):
        return f"Values[{len(n.rows)} rows]"
    if isinstance(n, GroupIdNode):
        return f"GroupId[sets={list(map(list, n.grouping_sets))}]"
    if isinstance(n, OutputNode):
        return f"Output => [{cols}]"
    return type(n).__name__


def _keys_label(keys) -> list:
    return [(k.index, 'asc' if k.ascending else 'desc') for k in keys]


def _bounds_label(key_bounds) -> str:
    """Planner-promised build-key bounds on a join row: the signal that
    the dense-key direct-address strategy was chosen."""
    if not key_bounds:
        return ""
    spans = ["?" if b is None else f"{b[0]}..{b[1]}" for b in key_bounds]
    return f", direct bounds=[{', '.join(spans)}]"


def _walk(n: PlanNode, depth: int, lines: List[str], stats=None) -> None:
    suffix = ""
    if stats is not None:
        st = stats.stats_for(n)
        if st is not None:
            child_wall = sum(stats.stats_for(c).wall_s
                             for c in n.children
                             if stats.stats_for(c) is not None)
            self_ms = max(st.wall_s - child_wall, 0.0) * 1e3
            suffix = (f"   [self {self_ms:,.1f}ms, wall "
                      f"{st.wall_s * 1e3:,.1f}ms, {st.rows:,} rows, "
                      f"{st.batches} batches]")
            # profiled device account: the operator's frames on the
            # device's clock (exclusive of its children) and the bytes
            # its kernel launches move by their bound formulas
            dev = stats.device_for(n)
            if dev is not None:
                suffix += (f" [device {dev['device_time_s'] * 1e3:,.1f}ms"
                           f", {_si(dev['bytes'])}B kernels]")
        elif not isinstance(n, OutputNode):
            suffix = "   [not executed]"
    lines.append("  " * depth + "- " + _label(n) + suffix)
    for c in n.children:
        _walk(c, depth + 1, lines, stats)
