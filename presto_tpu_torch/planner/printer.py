"""Plan printer for EXPLAIN and EXPLAIN ANALYZE.

The counterpart of ``presto_tpu/planner/printer.py`` (reference
presto-main/.../sql/planner/planprinter/: PlanPrinter.java's
textLogicalPlan, JsonRenderer.java, GraphvizPrinter.java,
IoPlanPrinter.java): the text plan, EXPLAIN (FORMAT JSON)
(``plan_json``), (FORMAT GRAPHVIZ) (``plan_graphviz``) and (TYPE IO)
(``plan_io``), (TYPE DISTRIBUTED) (``print_distributed_plan``: the
fragmenter's stages with their partitioning and output spec), each
equal to the reference's for the same plan. Under
EXPLAIN ANALYZE each executed node carries its profiled device time and
its kernels' bytes (``[device ...]``), and the runner appends the trace
(``format_trace_summary``, with the tracer on), skew, scan-cache,
kernels (``format_executables_summary``) and verdict
(``format_cost_verdict``) sections, and for a mesh query the mesh
rounds (``format_mesh_rounds``: the flight recorder's attribution and
round table). The result-cache section waits for the serving plane.
"""
from __future__ import annotations

from typing import List

from .plan import (
    AggregationNode, DistinctNode, FilterNode, GroupIdNode, JoinNode,
    LimitNode, OutputNode, PlanNode, ProjectNode, SemiJoinNode, SortNode,
    TableScanNode, TopNNode, UnionNode, ValuesNode,
)
from .planner import LogicalPlan


def plan_json(plan: LogicalPlan) -> dict:
    """Plan tree as a JSON-able dict — EXPLAIN (FORMAT JSON) (reference
    planprinter/JsonRenderer.java)."""
    def node_doc(n: PlanNode) -> dict:
        return {
            "name": type(n).__name__.replace("Node", ""),
            "label": _label(n),
            "outputs": [{"symbol": f.name, "type": f.type.display()}
                        for f in n.fields],
            "children": [node_doc(c) for c in n.children],
        }
    doc = node_doc(plan.root)
    if plan.init_plans:
        doc["initPlans"] = [node_doc(p) for p in plan.init_plans]
    return doc


def plan_graphviz(plan: LogicalPlan) -> str:
    """dot digraph — EXPLAIN (FORMAT GRAPHVIZ) (reference
    planprinter/GraphvizPrinter.java)."""
    lines = ["digraph logical_plan {", "  node [shape=box];"]
    counter = [0]

    def walk(n: PlanNode) -> int:
        my_id = counter[0]
        counter[0] += 1
        label = _label(n).replace('"', "'")
        lines.append(f'  n{my_id} [label="{label}"];')
        for c in n.children:
            cid = walk(c)
            lines.append(f"  n{my_id} -> n{cid};")
        return my_id

    walk(plan.root)
    for p in plan.init_plans:
        walk(p)
    lines.append("}")
    return "\n".join(lines)


def print_distributed_plan(plan: LogicalPlan) -> str:
    """Fragmented plan with per-fragment partitioning and output spec:
    EXPLAIN (TYPE DISTRIBUTED) (reference PlanPrinter.textDistributedPlan
    over PlanFragmenter output)."""
    from .fragmenter import fragment_plan
    lines: List[str] = []

    def render(root: PlanNode) -> None:
        fp = fragment_plan(root)
        for frag in fp.fragments:
            out = frag.output
            spec = "" if out is None else (
                f" => {out.kind}" + (f"{list(out.keys)}"
                                     if out.kind == "partition" else ""))
            lines.append(f"Fragment {frag.id} [{frag.partitioning}]{spec}")
            _walk(frag.root, 1, lines)
            lines.append("")

    render(plan.root)
    for i, init in enumerate(plan.init_plans):
        lines.append(f"InitPlan[{i}]:")
        render(init)
    return "\n".join(lines).rstrip()


def plan_io(plan: LogicalPlan) -> dict:
    """Catalog/table access summary — EXPLAIN (TYPE IO) (reference
    planprinter/IoPlanPrinter.java)."""
    tables = []

    def walk(n: PlanNode) -> None:
        if isinstance(n, TableScanNode):
            tables.append({
                "catalog": n.catalog,
                "schema": n.table.schema,
                "table": n.table.table,
                "columns": list(n.columns)})
        for c in n.children:
            walk(c)

    walk(plan.root)
    for p in plan.init_plans:
        walk(p)
    return {"inputTableColumnInfos": tables}


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


def format_trace_summary(spans) -> str:
    """Trace section appended to EXPLAIN ANALYZE when the tracer is on:
    spans aggregated by name (count, total/max ms), compile and
    device-sync work called out the way the reference's query stats
    separate blocked/compile time from operator wall."""
    agg = {}
    for s in spans:
        name = s.get("name", "?")
        dur = (float(s.get("end", 0.0)) - float(s.get("start", 0.0)))
        st = agg.setdefault(name, [0, 0.0, 0.0])
        st[0] += 1
        st[1] += dur
        st[2] = max(st[2], dur)
    lines = ["Trace (spans by name):"]
    for name in sorted(agg, key=lambda n: -agg[n][1]):
        n, total, peak = agg[name]
        lines.append(f"  {name:<32} x{n:<5} total "
                     f"{total * 1e3:,.1f}ms, max {peak * 1e3:,.1f}ms")
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


def format_retry_summary(info) -> str:
    """Fault-tolerance section appended to cluster EXPLAIN ANALYZE:
    task retries, speculative attempts, and the per-event detail the
    recovery layer recorded (exec/cluster._QueryExecution.summary()).
    Empty string when the query ran clean — the common case must not
    grow the plan output."""
    retries = int(info.get("retries") or 0)
    q_retries = int(info.get("query_retries") or 0)
    launched = int(info.get("speculative_launched") or 0)
    won = int(info.get("speculative_won") or 0)
    replays = sum(1 for ev in info.get("events") or ()
                  if ev.get("kind") == "spool_replay")
    if not (retries or q_retries or launched or won or replays):
        return ""
    head = (f"Fault tolerance [{info.get('policy', 'TASK')}]: "
            f"{retries} task retr{'y' if retries == 1 else 'ies'}, "
            f"{launched} speculative launched, {won} won"
            + (f", {q_retries} query rerun"
               f"{'' if q_retries == 1 else 's'}" if q_retries else "")
            + (f", {replays} spool replay"
               f"{'' if replays == 1 else 's'}" if replays else ""))
    lines = [head]
    for ev in info.get("events") or ():
        kind = ev.get("kind", "")
        if kind == "task_retry":
            lines.append(
                f"  retry {ev.get('task')} (attempt "
                f"{ev.get('attempt')}) {ev.get('from')} -> "
                f"{ev.get('to')}: {str(ev.get('reason', ''))[:120]}")
        elif kind == "speculative_launched":
            lines.append(f"  speculate {ev.get('task')} on "
                         f"{ev.get('worker')} (straggler "
                         f"{ev.get('straggler')})")
        elif kind == "speculative_won":
            lines.append(f"  speculative win {ev.get('task')} on "
                         f"{ev.get('worker')}")
        elif kind == "spool_replay":
            lines.append(f"  spool replay {ev.get('task')} "
                         f"(worker {ev.get('worker')} gone, output "
                         f"served from spool — not re-run)")
    return "\n".join(lines)


def format_kernels_registry(max_rows: int = 12) -> str:
    """Process-lifetime kernels section of a cluster EXPLAIN ANALYZE
    under profile mode (per-query attribution lives on the workers):
    the hand kernels this process launched, by device time. In-process
    workers share the coordinator's registry; a subprocess worker keeps
    its own (``system.runtime.executables`` and ``/v1/metrics`` there).
    Empty when nothing launched or was profiled."""
    from ..obs.profiler import KERNELS
    rows = [e for e in KERNELS.snapshot()
            if e["launches"] or e["profiled_calls"]]
    if not rows:
        return ""
    lines = ["Kernels (process lifetime, by device time):"]
    for e in rows[:max_rows]:
        lines.append(
            f"  {e['name']:<24} x{e['launches']:<6} device "
            f"{e['device_time_s'] * 1e3:,.1f}ms, build "
            f"{e['build_seconds']:,.2f}s")
    return "\n".join(lines)


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


def format_result_cache_summary(stats) -> str:
    """Result-cache section appended to EXPLAIN ANALYZE: this query's
    outcome (hit / partial / miss on plain queries; EXPLAIN ANALYZE
    always runs, so it reports whether a resident entry would serve)
    plus the process-wide resident set. Empty string when the result
    cache never engaged (``result_cache`` off)."""
    outcome = getattr(stats, "result_cache", None)
    probe = getattr(stats, "result_cache_probe", ())
    totals = getattr(stats, "result_cache_stats", None)
    if outcome is None and probe == () and totals is None:
        return ""
    if totals is None:
        from ..serving.resultcache import RESULTS
        totals = RESULTS.stats()
    if outcome is None:
        outcome = ("miss" if probe is None else
                   f"cached ({probe[0]} rows"
                   + (", incremental)" if probe[2] else ")"))
    return (f"Result cache: {outcome}; resident "
            f"{totals['entries']} entr"
            f"{'y' if totals['entries'] == 1 else 'ies'}, "
            f"{totals['resident_bytes'] / 1048576.0:,.1f} MiB")


#: round rows the EXPLAIN ANALYZE mesh section prints before it points at
#: system.runtime.mesh_rounds
_MESH_ROUND_ROWS = 48


def format_mesh_rounds(stats) -> str:
    """Mesh-rounds section of EXPLAIN ANALYZE for a mesh-path query: the
    flight recorder's wall-clock attribution (bucket seconds and share
    of wall), the per-shard critical path, and the per-round table,
    rendered from the same row shape as ``system.runtime.mesh_rounds``
    (obs/flight.round_rows). Closes with the dominant-bucket verdict.
    Empty when the query never flew (single-device path or
    ``mesh_flight=off``)."""
    fl = getattr(stats, "mesh_flight", None)
    if fl is None or fl.attribution is None:
        return ""
    from ..obs.flight import BUCKETS, round_rows
    a = fl.attribution
    wall = max(a["wall_s"], 1e-9)
    lines = [
        f"Mesh rounds: {a['rounds']} rounds on {a['n_devices']} "
        f"device{'s' if a['n_devices'] != 1 else ''}, wall "
        f"{a['wall_s'] * 1e3:,.1f}ms, {a['reconciled_pct']:.1f}% "
        f"attributed"]
    for b in BUCKETS:
        s = a["buckets"][b]
        if s:
            lines.append(f"  {b:<18} {s * 1e3:>10,.1f}ms "
                         f"{s / wall * 100.0:5.1f}%")
    cp = a["critical_path"]
    if cp["per_shard_s"]:
        lines.append(f"  critical path: shard {cp['slowest_shard']} "
                     f"({max(cp['per_shard_s']) * 1e3:,.1f}ms)")
    rows = round_rows(fl.query_id, fl.records())
    if rows:
        lines.append("  round stage kind         bucket             "
                     "wall_ms       rows      bytes loads  dev_rounds")
        for r in rows[:_MESH_ROUND_ROWS]:
            (_qid, rnd, stage, kind, bucket, _t, wall_s, nrows,
             nbytes, loads, _blocking, dev_rounds) = r
            lines.append(
                f"  {rnd:>5} {stage:>5} {kind:<12} {bucket:<18} "
                f"{wall_s * 1e3:>7,.1f} {nrows:>10} {nbytes:>10} "
                f"{loads} {dev_rounds:>3}")
        if len(rows) > _MESH_ROUND_ROWS:
            lines.append(
                f"  ... {len(rows) - _MESH_ROUND_ROWS} more rounds "
                f"(system.runtime.mesh_rounds has the full timeline)")
    lines.append(
        f"Mesh verdict: {a['dominant_bucket']} dominates "
        f"({a['buckets'][a['dominant_bucket']] / wall * 100.0:.0f}% "
        f"of wall)")
    return "\n".join(lines)


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
            # executed join dispatch (strategy x distribution)
            js = (stats.join_strategy_for(n)
                  if hasattr(stats, "join_strategy_for") else None)
            if js is not None:
                suffix += f" [strategy {js[0]}/{js[1]}]"
        elif not isinstance(n, OutputNode):
            suffix = "   [not executed]"
    lines.append("  " * depth + "- " + _label(n) + suffix)
    for c in n.children:
        _walk(c, depth + 1, lines, stats)
