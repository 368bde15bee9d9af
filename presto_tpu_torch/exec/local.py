"""Local plan executor: logical plan -> streaming batch iterators on one
device.

The counterpart of ``presto_tpu/exec/local.py`` (reference
presto-main/.../sql/planner/LocalExecutionPlanner.java:357 and
operator/Driver.java): each plan node becomes a generator over device
batches, so scan->filter->project->partial-agg chains stream without
materializing, while join builds, sorts and aggregations drain their
input. Ported node kinds: output, table scan, VALUES, filter, project,
limit, sort, top-n, aggregation (with the default rows of grouping sets
over empty input), DISTINCT, GroupId (ROLLUP, CUBE, GROUPING SETS),
union (UNION [ALL], and INTERSECT / EXCEPT as the planner lowers them),
window, joins (inner, left, full and cross; unique or expanding builds;
ON residuals) and semi joins (IN, NOT IN, [NOT] EXISTS, with or without
a residual). Init plans (uncorrelated scalar subqueries) run before the
main plan and their values substitute into its expressions; a subplan
that occurs more than once runs once and replays its batches.
MarkDistinct drains and flags the first occurrence of each distinct
tuple; Unnest expands array columns into rows (with ordinality).

Join builds, grouped aggregation states (DISTINCT included) and sorts
accumulate in the spill buffers of ``exec/spill.py`` against the query's
memory pool (``query_max_memory``): past the budget they stage to host
memory, then to disk pages, and a spilled join build probes partition by
partition (``_partitioned_join``).

A chain of two or more unique-build inner or left joins, with the
filters and projections between them, runs fused (``exec/fused.py``,
``_try_fused_chain``): every build drains first, all their dynamic
bounds reach the source scan before it starts, and each source batch
goes through a head (bounds and the first join's membership mask, no
payload) and, after windowed compaction, a tail with every payload
gather.

Table scans go through the device scan cache and the prefetching split
pipeline (``exec/scancache.py``); a join whose probe side a dynamic
filter cannot prune runs that side on a producer thread while its build
drains (``exec/local_exchange.py``); a fused chain streams its source
without that thread. Shared subplans are memoized within the query's
``memory.QueryMemoryPool``.

Unique-build joins probe through the CUDA direct-address probe kernel
(``ops/probe.py``) whenever the build gets a direct-address table, and
through binary search over the sorted build otherwise.

Local parallelism: under ``task_concurrency`` > 1 a grouped
aggregation's partial step runs on that many driver threads
(``local_exchange.parallel_drivers``). Grouped (lifespan) execution: an
inner join of two tables partitioned on its keys runs one partition at a
time (``_lifespan_partitions``), each partition's scans restricted to
its splits and its dynamic bounds kept to that partition. With the
tracer on (``obs/trace.py``) every batch an operator produces is an
``op:*`` span and each host readback the executor makes (error flags,
compaction and fused liveness counts, build summaries and
multiplicities) a ``device-sync`` span.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch

from .. import types as T
from ..batch import (
    Batch, Column, Schema, bucket_capacity, concat_batches, map_parts,
    repeat_rows,
)
from ..errors import STATS_BOUND_VIOLATION, QueryCancelledError, QueryError
from ..expr import ir
from ..expr import params as P
from ..expr.params import has_params
from ..expr.compiler import (
    _err_scalar, _inputs, compile_filter, compile_projection, eval_expr,
)
from ..expr.rewrite import referenced_inputs, remap_inputs
from ..expr.rewrite import rewrite as ir_rewrite
from ..memory import QueryMemoryPool, batch_device_bytes
from ..obs import profiler
from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER
from ..ops.aggregation import (
    AggSpec, dense_path_selected, global_aggregate, grouped_aggregate,
    mark_distinct_flags, percentile_drains,
)
from ..ops.join import (
    build_key_ranks, build_match_mask, direct_keyed_plan, expand_join,
    expand_match_origins, is_direct_prepared, lookup_join, mark_rows,
    match_count_max, max_multiplicity, prepare_build, prepare_direct,
    prepare_direct_keyed, semi_join_mask, unique_match_build_mask,
)
from ..ops.probe import lookup_join_direct, sorted_payload
from ..ops.sort import SortKey, limit as limit_kernel, sort_batch, top_n
from ..ops.window import WindowSpec, evaluate_window
from ..planner.plan import (
    AggregationNode, DistinctNode, FilterNode, GroupIdNode, JoinNode,
    LimitNode, MarkDistinctNode, OutputNode, PlanNode, ProjectNode,
    SemiJoinNode, SortNode, TableScanNode, TopNNode, UnionNode, UnnestNode,
    ValuesNode, WindowNode,
)
from ..planner.planner import (
    InitPlanRef, LogicalPlan, Session, bool_property,
)
from . import scancache
from .fused import (
    FilterStage, JoinStage, ProjectStage, fused_pipeline, fused_prefilter,
    keys_in_build_vocab,
)
from .local_exchange import exchange_source, parallel_drivers
from .spill import (
    AggSpillBuffer, HostPartitionStore, SortSpillBuffer,
    SpillableBuildBuffer,
)

_DYN_TYPES = (T.BigintType, T.IntegerType, T.SmallintType, T.TinyintType,
              T.DateType)

#: an exhausted operator iterator (``_Executor._traced``)
_END = object()

#: fused-chain lane accounting: capacities entering the chain (source)
#: and entering the tail's payload gathers (after the head's masks and
#: the windowed compaction); their ratio is the gather-lane reduction of
#: the selectivity-first head. Readbacks count the head's windowed
#: liveness syncs.
_FUSED_SOURCE_LANES = REGISTRY.counter("fused_source_lanes_total")
_FUSED_TAIL_LANES = REGISTRY.counter("fused_tail_lanes_total")
_FUSED_READBACKS = REGISTRY.counter("fused_liveness_readbacks_total")


def _note_join_strategy(stats, node, strategy: str, dist: str) -> None:
    """One count per executed join or semi-join operator, labeled
    strategy (direct / sorted / expand) x distribution, and the
    operator's entry in the query's stats (the profile document's
    ``join_strategy``)."""
    REGISTRY.counter(
        f"join_strategy_selected_total.{strategy}.{dist}").inc()
    if stats is not None and hasattr(stats, "record_join_strategy"):
        stats.record_join_strategy(node, strategy, dist)


@dataclasses.dataclass
class QueryResult:
    names: List[str]
    types: List[T.Type]
    rows: List[tuple]


def _default_grouping_batch(node: AggregationNode, device) -> Batch:
    """One default row per empty grouping set for an aggregation over
    empty input (reference AggregationNode.hasDefaultOutput +
    AggregationOperator's default output page): keys NULL, $group_id set,
    count aggregates 0, everything else NULL."""
    nk = len(node.group_indices)
    n = len(node.default_gids)
    data: Dict[str, tuple] = {}
    for pos, f in enumerate(node.fields):
        if pos < nk - 1:
            vals = [None] * n
        elif pos == nk - 1:                 # the $group_id column
            vals = [int(g) for g in node.default_gids]
        else:
            zero = node.aggs[pos - nk].fn in ("count", "count_star")
            vals = [0 if zero else None] * n
        data[f.name] = (f.type, vals)
    return Batch.from_pydict(data, device=device)


def run_init_plans(ex: "_Executor", plan: LogicalPlan) -> None:
    """Run the uncorrelated scalar subqueries (init plans) and bind their
    values for the main plan AND for later init plans: inner subqueries
    come first (lower indices), so binding the live list before the loop
    lets a nested init plan's InitPlanRef resolve while the outer one
    runs. No row gives NULL; more than one row raises."""
    ex.mark_shared(list(plan.init_plans) + [plan.root])
    for p in plan.init_plans:
        rows = [r for b in ex.run(p) for r in b.to_pylist()]
        if len(rows) > 1:
            raise ValueError("scalar subquery returned more than one row")
        ex.init_values.append(rows[0][0] if rows else None)


def execute_plan(plan: LogicalPlan, session: Session, device,
                 rows_per_batch: int = 1 << 17, stats=None,
                 collect_rows: bool = True, cancel_event=None,
                 split_restrict=None) -> QueryResult:
    """Run a planned query on ``device`` and decode its rows.
    ``stats`` (a StatsCollector) records per-node and per-split stats;
    ``collect_rows=False`` drains without decoding (EXPLAIN ANALYZE);
    a set ``cancel_event`` stops the query between batches;
    ``split_restrict`` ({(catalog, table): predicate over Split}) keeps
    only the matching splits of those scans (the result cache's delta
    run, which stays on one device).

    A plan-template plan runs under its query's bindings
    (``session.param_bindings``, expr/params.py): the binding scope opens
    here, before any thread that runs batches is started, and the mesh
    executor gets the plan with its bindings made literals. An admitted
    query (``session.serving``) bills its memory to its resource group
    and draws its quanta from the group's share.

    Mesh routing (``exec/distributed.select_mesh``): under
    ``mesh_execution`` the plan runs on a mesh of slots of ``device``'s
    type through the DistributedExecutor, billed to the fair scheduler
    per slot, with the mesh flight recorder installed for the query
    (``stats.mesh_flight``). Every output batch is one
    quantum of the fair device scheduler (``exec/taskexec.py``) unless
    ``fair_scheduling`` is off."""
    from ..obs import flight as _flight
    from ..obs.trace import current_span_ids
    from .distributed import (
        DistributedExecutor, mesh_flight_on, select_mesh,
    )
    from .taskexec import GLOBAL as scheduler
    bindings = session.param_bindings
    mesh = (select_mesh(session, plan, device)
            if split_restrict is None else None)
    if mesh is not None and bindings:
        # the mesh executor takes values as constants: materialize this
        # query's bindings into literals (the cached template itself is
        # never mutated)
        plan = P.bind_plan(plan, bindings)
        bindings = None
    if mesh is not None:
        ex = DistributedExecutor(session, rows_per_batch, mesh,
                                 stats=stats)
        n_slots = mesh.size
    else:
        ex = _Executor(session, rows_per_batch, torch.device(device),
                       stats=stats)
        n_slots = 1
    ex.cancel_event = cancel_event
    ex.split_restrict = split_restrict
    # quanta are billed per slot: a mesh query's quantum holds every
    # slot; an admitted query's task registers under its resource
    # group's share (serving/groups.py), allotted by schedulingWeight
    serving = session.serving
    handle = (scheduler.task(
        name=str(id(ex)),
        group=serving.scheduler_group if serving is not None else "",
        weight=serving.weight if serving is not None else 1,
        label=serving.group_path if serving is not None else None,
        devices=n_slots)
        if bool_property(session, "fair_scheduling", True) else None)
    # device-time profiling (obs/profiler.py): per-operator frames timed
    # on the device and kernel launches bracketed. On under the `profile`
    # session property, and always under EXPLAIN ANALYZE, which already
    # pays a host sync per batch for live row counts; plain queries pay
    # one contextvar load per frame and launch
    profile_on = stats is not None and (
        bool_property(session, "profile", False) or stats.count_rows)
    # mesh flight recorder (obs/flight.py): a mesh query records its
    # rounds for the post-query attribution unless mesh_flight=off
    flight = fl_token = None
    if mesh is not None and mesh_flight_on(session):
        qid = (str(current_span_ids().get("query_id") or "")
               or f"mesh_{_flight.next_seq():06d}")
        flight = _flight.FlightRecorder(qid, mesh.size)
        fl_token = _flight.CURRENT_FLIGHT.set(flight)
    t_flight0 = time.perf_counter()
    root = plan.root
    out: List[Batch] = []
    sentinel = object()
    try:
        # template bindings: Param evaluation reads this query's values
        # from the scope; the threads that run batches copy their spawn
        # context, so the scope reaches them
        with P.bound(bindings), profiler.profiled(profile_on, ex.device):
            run_init_plans(ex, plan)
            it = ex.run(root.child)
            try:
                while True:
                    ex._check_cancel()
                    # one quantum per output batch: concurrent queries
                    # interleave at batch granularity by cumulative
                    # device time
                    b = scheduler.run_quantum(handle,
                                              lambda: next(it, sentinel))
                    if b is sentinel:
                        break
                    if collect_rows:
                        out.append(b)
            finally:
                # closing the root generator runs every suspended finally
                # below it (the threaded scan's stop and join) on error,
                # cancel or LIMIT
                close = getattr(it, "close", None)
                if close is not None:
                    close()
        ex.check_errors()
        if flight is not None:
            with flight.timed("drain"):
                rows = [r for b in out for r in b.to_pylist()]
        else:
            rows = [r for b in out for r in b.to_pylist()]
        return QueryResult(names=[f.name for f in root.fields],
                           types=[f.type for f in root.fields], rows=rows)
    finally:
        if flight is not None:
            _flight.CURRENT_FLIGHT.reset(fl_token)
            flight.finish(time.perf_counter() - t_flight0)
            if stats is not None:
                stats.mesh_flight = flight
        if handle is not None:
            handle.close()
            if stats is not None:
                stats.scheduler = {"level": handle.level,
                                   "device_seconds": handle.device_seconds,
                                   "quanta": handle.quanta,
                                   "devices": handle.devices}


def _plan_schema(node: PlanNode) -> Schema:
    return Schema([(f.name, f.type) for f in node.fields])


def _apply_dynamic_bounds(probe: Batch,
                          dyn: List[Tuple[int, int, int]]) -> Batch:
    """Device-side probe prefilter: drop rows whose key cannot match any
    build row (outside [lo, hi] or NULL — inner-join semantics)."""
    keep = probe.row_mask
    for pk, lo, hi in dyn:
        c = probe.columns[pk]
        keep = keep & c.validity & (c.data >= lo) & (c.data <= hi)
    return Batch(probe.schema, probe.columns, keep)


def mark_exists_mask(probe: Batch, build: Batch, probe_keys, build_keys,
                     residual: ir.Expr, negated: bool, max_matches: int,
                     ex: "_Executor") -> torch.Tensor:
    """Correlated-EXISTS mark: a probe row passes iff ANY build row with
    equal keys satisfies the residual (over probe fields + build fields).
    The decorrelated mark join of reference
    TransformExistsApplyToCorrelatedJoin.java: expand the m:n matches,
    filter them by the residual, then mark the probe rows that kept a
    match. The expansion carries only the key and residual columns and a
    probe row id."""
    n_src = len(probe.columns)
    refs = referenced_inputs(residual)
    pcols = sorted(set(probe_keys) | {i for i in refs if i < n_src})
    bcols = sorted(i - n_src for i in refs if i >= n_src)
    cap = probe.capacity
    rid = Column(T.BIGINT, torch.arange(cap, dtype=torch.int64,
                                        device=probe.device),
                 probe.row_mask)
    narrow = Batch(Schema([(probe.schema.names[i], probe.schema.types[i])
                           for i in pcols] + [("$rid", T.BIGINT)]),
                   [probe.columns[i] for i in pcols] + [rid], probe.row_mask)
    expanded = expand_join(narrow, build,
                           [pcols.index(k) for k in probe_keys], build_keys,
                           bcols, [f"$f{i}" for i in bcols], "inner",
                           max_matches)
    # expanded layout: narrowed probe columns, $rid, referenced build cols
    shift = {i: (pcols.index(i) if i < n_src
                 else len(pcols) + 1 + bcols.index(i - n_src))
             for i in refs}
    filt = compile_filter(remap_inputs(residual, shift), expanded.schema,
                          errors=True)
    kept, err = filt(expanded)
    if err is not None:
        ex.error_flags.append(err)
    found = mark_rows(kept.columns[len(pcols)].data, kept.row_mask, cap)
    return probe.row_mask & (~found if negated else found)


def values_batch(node: ValuesNode, device) -> Batch:
    """A VALUES node's rows as one batch on ``device``."""
    if node.fields:
        return Batch.from_pydict(
            {f.name: (f.type, [r[i] for r in node.rows])
             for i, f in enumerate(node.fields)}, device=device)
    # zero-column values (SELECT without FROM): live rows, no columns
    n = len(node.rows)
    return Batch(Schema([]), [], torch.arange(
        bucket_capacity(max(n, 1)), device=device) < n)


def grouping_set_batch(b: Batch, node: GroupIdNode, g: int,
                       schema: Schema) -> Batch:
    """Grouping set ``g``'s replica of ``b``: absent keys get their
    validity cleared (NULL), $group_id is the constant ``g``."""
    s = node.grouping_sets[g]
    cols = []
    for i, c in enumerate(b.columns):
        if i < node.n_keys and i not in s:
            # zero the data too: the sort path groups on (null rank,
            # data), so stale data under a cleared validity would still
            # split groups
            cols.append(Column(c.type, torch.zeros_like(c.data),
                               torch.zeros_like(b.row_mask), c.dictionary))
        else:
            cols.append(c)
    cols.append(Column(T.BIGINT, torch.full(
        (b.capacity,), g, dtype=torch.int64, device=b.device),
        torch.ones_like(b.row_mask)))
    return Batch(schema, cols, b.row_mask)


def cross_expand(probe: Batch, build: Batch, nb: int,
                 schema: Schema) -> Batch:
    """One copy of ``probe`` per live row of the compacted ``build``
    (its first ``nb`` rows), the build row's columns appended."""
    cap = probe.capacity
    reps: List[Batch] = []
    for k in range(nb):
        cols = list(probe.columns)
        for c in build.columns:
            data = map_parts(c.data, lambda a: a[k:k + 1].expand(
                (cap,) + tuple(a.shape[1:])).contiguous())
            valid = c.validity[k:k + 1].expand(cap) & probe.row_mask
            cols.append(Column(c.type, data, valid, c.dictionary))
        reps.append(Batch(schema, cols, probe.row_mask))
    return concat_batches(reps) if len(reps) > 1 else reps[0]


def _null_columns(fields, cap: int, device) -> List[Column]:
    """All-NULL columns for ``fields`` (the null-extended side of an outer
    join)."""
    cols = []
    novalid = torch.zeros(cap, dtype=torch.bool, device=device)
    for f in fields:
        width = getattr(f.type, "storage_width", None)
        shape = (cap,) if width is None else (cap, width)
        cols.append(Column(f.type, torch.zeros(shape,
                                               dtype=f.type.storage_dtype,
                                               device=device),
                           novalid, () if f.type.is_string else None))
    return cols


def unnest_expand(b: Batch, exprs, ordinality: bool, schema: Schema):
    """Lateral array expansion (reference operator/unnest/
    UnnestOperator.java): [cap, L] element tiles flatten to [cap*L] rows
    and the child's columns repeat per element slot. Rows past an array's
    length are dead; several arrays zip to the longest (shorter ones pad
    with NULL elements); a NULL array gives no rows. Returns (batch,
    row error scalar or None)."""
    arrs = [eval_expr(e, _inputs(b)) for e in exprs]
    err = _err_scalar([a.err for a in arrs], b.row_mask)
    widths = [a.data[0].shape[1] for a in arrs]
    L = max(widths)
    cap = b.capacity
    eff_lens = [torch.where(a.valid, a.data[1], 0) for a in arrs]
    max_len = eff_lens[0]
    for ln in eff_lens[1:]:
        max_len = torch.maximum(max_len, ln)
    slot = torch.arange(L, device=b.device)[None, :].expand(cap, L)
    out_mask = (b.row_mask[:, None] & (slot < max_len[:, None])).reshape(-1)
    cols = [Column(c.type, repeat_rows(c.data, L),
                   c.validity.repeat_interleave(L), c.dictionary)
            for c in b.columns]
    for a, w, ln in zip(arrs, widths, eff_lens):
        values, _, elem_valid = a.data
        if w < L:
            values = _pad_cols(values, L)
            elem_valid = _pad_cols(elem_valid, L)
        ev = elem_valid & (slot < ln[:, None])
        cols.append(Column(a.type.element,
                           values.reshape((cap * L,) + values.shape[2:]),
                           ev.reshape(-1), a.dictionary))
    if ordinality:
        cols.append(Column(T.BIGINT, (slot + 1).to(torch.int64).reshape(-1),
                           out_mask))
    return Batch(schema, cols, out_mask), err


def _without_key_pairs(node: JoinNode, drop) -> JoinNode:
    """``node`` joining on its key pairs outside ``drop`` (their build-key
    bounds with them); ``node`` itself when no pair would remain."""
    keep = [i for i, kp in enumerate(zip(node.left_keys, node.right_keys))
            if kp not in drop]
    if not keep or len(keep) == len(node.left_keys):
        return node
    return dataclasses.replace(
        node, left_keys=tuple(node.left_keys[i] for i in keep),
        right_keys=tuple(node.right_keys[i] for i in keep),
        key_bounds=tuple(node.key_bounds[i] for i in keep)
        if node.key_bounds else ())


def _pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the element axis (axis 1) of ``t`` to ``width``."""
    pad = t.new_zeros((t.shape[0], width - t.shape[1]) + tuple(t.shape[2:]))
    return torch.cat([t, pad], dim=1)


def key_bounds_violation(batch: Batch, cols: Sequence[int],
                         key_bounds) -> torch.Tensor:
    """Device int32 scalar: STATS_BOUND_VIOLATION when a live, valid key
    lies outside its stats-promised [lo, hi], else 0. The dense kernels
    clamp such keys, so the executor fails the query through its error
    channel instead of returning misgrouped rows."""
    bad = torch.zeros((), dtype=torch.bool, device=batch.device)
    for ci, kb in zip(cols, key_bounds):
        if kb is None:
            continue
        c = batch.columns[ci]
        data = c.data.to(torch.int64)
        out = batch.row_mask & c.validity & ((data < kb[0]) | (data > kb[1]))
        bad = bad | out.any()
    return torch.where(bad, STATS_BOUND_VIOLATION, 0).to(torch.int32)


class _ChainBuilds:
    """A fused chain's prepared builds, one entry per join stage in
    bottom-up order, and the spill buffers holding their reservations
    (released by ``close``)."""

    def __init__(self):
        self.preps: List[object] = []
        self.builds: List[Batch] = []
        #: sorted payload of a direct-address build, else None
        self.sorted_cols: List[object] = []
        #: per join stage: [(lo, hi)] aligned with its dyn_keys
        self.dyns: List[Tuple[Tuple[int, int], ...]] = []
        self.bufs: List[SpillableBuildBuffer] = []

    def close(self) -> None:
        for bf in self.bufs:
            bf.close()


class _Executor:
    #: largest (max-min+1) key span served by a direct-address lookup
    #: table; wider spans use the sorted build's binary search
    DIRECT_SPAN_LIMIT = 1 << 26

    #: grouped partial states merge once this many are buffered
    MERGE_EVERY = 16

    #: per-kernel expansion cap: one skewed key would otherwise scale the
    #: expand_join output (probe capacity x max matches) without bound;
    #: past this the executor slices the build into bounded-multiplicity
    #: chunks through build_key_ranks
    SKEW_MATCH_LIMIT = 64

    def __init__(self, session: Session, rows_per_batch: int,
                 device: torch.device, stats=None):
        self.session = session
        self.rows_per_batch = rows_per_batch
        self.device = device
        self.stats = stats
        #: set by execute_plan: checked per scan batch, so a cancel stops
        #: a query mid-drain
        self.cancel_event = None
        #: result-cache incremental delta: {(catalog, table): predicate
        #: over Split} restricting a scan to the changed splits only
        #: (serving/resultcache.py); None scans everything
        self.split_restrict = None
        #: the query's memory pool: the spill buffers and memoized
        #: subplans reserve from it; staged host bytes beyond
        #: spill_to_disk_bytes flush to pages on disk (reference
        #: NodeSpillConfig)
        props = session.properties

        def int_prop(name, default=None):
            v = props.get(name, default)
            return int(v) if v is not None else None
        self.pool = QueryMemoryPool(
            int_prop("query_max_memory"),
            disk_threshold=int_prop("spill_to_disk_bytes", 4 << 30),
            spill_dir=props.get("spill_path"),
            # admitted queries mirror reservations to their resource
            # group's ledger (kill-or-queue on group memory limits)
            group=session.serving)
        self.spill_partitions = int_prop("spill_partitions", 16)
        session.last_memory_stats = self.pool.stats
        #: runtime (dynamic-filter) scan bounds: scan node ->
        #: [(column, lo, hi)]
        self.dynamic_pushdown: Dict[PlanNode, List[Tuple]] = {}
        #: grouped (lifespan) execution: scan node -> the splits of the
        #: one partition it is restricted to (reference
        #: execution/Lifespan.java:26, scheduler/group/LifespanScheduler)
        self.lifespan_splits: Dict[PlanNode, List] = {}
        # device int32 scalars from error-checking kernels; reduced to one
        # host sync by check_errors() after the plan drains
        self.error_flags: List[torch.Tensor] = []
        #: init-plan values, appended by run_init_plans
        self.init_values: List[object] = []
        #: subplans that occur more than once (mark_shared) and the
        #: batches of those already run
        self._shared: Set[PlanNode] = set()
        self._ever_shared: Set[PlanNode] = set()
        self._materialized: Dict[PlanNode, List[Batch]] = {}
        # one lock per shared subplan: with probe prefetch two threads can
        # reach the same subplan, and it must still run once
        self._memo_locks: Dict[PlanNode, threading.Lock] = {}
        self._memo_locks_lock = threading.Lock()
        #: plan node ids of the operator spans (``_traced``), by identity
        self._node_ids: Dict[int, int] = {}
        self._node_seq = itertools.count()

    def mark_shared(self, roots: Sequence[PlanNode]) -> None:
        """Find the structurally repeated subplans (Q15's view, read by
        the main plan and by its scalar subquery): each runs once and its
        batches replay to every consumer, so all of them see the same
        rows and the same double sums (float adds on the card sum in no
        fixed order)."""
        counts: Counter = Counter()

        def walk(n: PlanNode) -> None:
            counts[n] += 1
            if counts[n] == 1:
                for c in n.children:
                    walk(c)

        for r in roots:
            walk(r)
        self._shared = {n for n, c in counts.items() if c > 1}
        # never discarded: dynamic-filter pushdown must see a subtree as
        # multi-consumer even after its memo was abandoned
        self._ever_shared = set(self._shared)

    def _resolve(self, e: ir.Expr) -> ir.Expr:
        """Substitute init-plan values for their InitPlanRef literals."""
        def fn(n: ir.Expr) -> ir.Expr:
            if isinstance(n, ir.Literal) and isinstance(n.value, InitPlanRef):
                return ir.Literal(type=n.type,
                                  value=self.init_values[n.value.index])
            return n
        return ir_rewrite(e, fn)

    def checked_filter(self, pred: ir.Expr, schema: Schema):
        """A filter that feeds its row errors into this query's error
        flags (Filter nodes and join ON residuals)."""
        fn = compile_filter(pred, schema, errors=True)

        def run(b: Batch) -> Batch:
            out, err = fn(b)
            if err is not None:
                self.error_flags.append(err)
            return out
        return run

    def _check_cancel(self) -> None:
        ev = self.cancel_event
        if ev is not None and ev.is_set():
            raise QueryCancelledError()

    def check_errors(self) -> None:
        """Raise the highest-coded row error seen this query (one sync)."""
        if not self.error_flags:
            return
        with TRACER.span("device-sync", what="error-flags"):
            code = int(torch.stack(self.error_flags).max())
        self.error_flags = []
        if code:
            raise QueryError(code)

    def run(self, node: PlanNode) -> Iterator[Batch]:
        if node in self._materialized:
            # replay: the node's stats already hold its one execution
            return iter(self._materialized[node])
        m = getattr(self, "_" + type(node).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"{type(node).__name__} is not ported")
        if node in self._shared:
            with self._memo_locks_lock:
                lock = self._memo_locks.setdefault(node, threading.Lock())
            if not lock.acquire(blocking=False):
                # another thread runs the subplan, in frames that may need
                # this thread's profile frame lock
                with profiler.blocking():
                    lock.acquire()
            try:
                if node in self._materialized:
                    return iter(self._materialized[node])
                return self._run_memoized(node, m)
            finally:
                lock.release()
        it = m(node)
        if self.stats is not None:
            it = self.stats.wrap(node, it)
        if TRACER.enabled:
            it = self._traced(node, it)
        return it

    def _traced(self, node: PlanNode, it: Iterator[Batch],
                **attrs) -> Iterator[Batch]:
        """One ``op:<Name>`` span per ``next()`` of the node's iterator,
        current while it runs: the children's spans and the device-sync
        spans under it nest by parentage (its self time is its length
        less theirs), and it is the innermost operator span open on this
        thread while the node itself launches work. Spans carry the plan
        node's id within this query."""
        name = "op:" + type(node).__name__.replace("Node", "")
        node_id = self._node_ids.setdefault(id(node), next(self._node_seq))

        def batches():
            try:
                while True:
                    with TRACER.span(name, node_id=node_id, **attrs):
                        b = next(it, _END)
                    if b is _END:
                        return
                    yield b
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
        return batches()

    def _run_memoized(self, node: PlanNode, m) -> Iterator[Batch]:
        """Materialize a shared subplan's output once, within the memory
        budget: each kept batch reserves from the query pool, and when the
        pool cannot hold the next one the memo is abandoned (later
        consumers run the subplan again instead of running out of device
        memory)."""
        ctx = self.pool.context(f"memo-{type(node).__name__}")
        it = m(node)
        if self.stats is not None:
            it = self.stats.wrap(node, it)
        if TRACER.enabled:
            it = self._traced(node, it, memoized=True)
        out: List[Batch] = []
        for b in it:
            if not self.pool.try_reserve(batch_device_bytes(b), ctx):
                # over budget: this consumer streams on, later ones re-run
                ctx.release_all()
                self._shared.discard(node)
                return itertools.chain(out, [b], it)
            out.append(b)
        self._materialized[node] = out
        return iter(out)

    def _OutputNode(self, node: OutputNode) -> Iterator[Batch]:
        return self.run(node.child)

    def _scan_pushdown_fn(self, node: TableScanNode):
        """Closure giving a scan's EFFECTIVE pushdown, evaluated per
        split: dynamic (join build) bounds may arrive while earlier splits
        already stream, and later splits still get them (the reference's
        dynamic filters race the probe scan the same way)."""
        def current_pushdown():
            pushdown = node.pushdown or None
            dyn = self.dynamic_pushdown.get(node)
            if dyn:
                # intersect per column: connectors keep one bound per name,
                # so appending would let a wider dynamic bound shadow a
                # tighter WHERE-derived one
                merged: Dict[str, List] = {}
                for name, lo, hi in list(pushdown or ()) + dyn:
                    b = merged.setdefault(name, [lo, hi])
                    if lo is not None:
                        b[0] = lo if b[0] is None else max(b[0], lo)
                    if hi is not None:
                        b[1] = hi if b[1] is None else min(b[1], hi)
                pushdown = tuple((n, lo, hi)
                                 for n, (lo, hi) in merged.items())
            return pushdown
        return current_pushdown

    def _TableScanNode(self, node: TableScanNode) -> Iterator[Batch]:
        """Split-parallel scan through the device scan cache and the
        prefetching pipeline (exec/scancache.py): splits resident on the
        device replay across queries; cold splits are generated and copied
        on background threads ahead of the consumer (reference
        execution/SqlTaskExecution.java:390, one driver per split, and
        BufferingSplitSource prefetch). Delivery is in split order, so row
        order does not change run to run."""
        conn = self.session.catalogs.get(node.catalog)
        opts = scancache.options_from_session(self.session)
        splits = self.lifespan_splits.get(node)
        if splits is None:
            splits = conn.split_manager.splits(node.table,
                                               max(opts.threads, 1))
        if self.split_restrict is not None:
            pred = self.split_restrict.get((node.catalog, node.table.table))
            if pred is not None:
                # result-cache delta run: only the changed splits
                splits = [s for s in splits if pred(s)]
        t_query0 = time.perf_counter()

        def record_split(i: int, t0: float, batches: int) -> None:
            # per-split completion record (reference event/SplitMonitor)
            if self.stats is not None:
                self.stats.record_split(
                    node.table.table, i, t0 - t_query0,
                    time.perf_counter() - t0, batches)

        yield from scancache.scan_splits(
            conn, node.catalog, list(node.columns), splits,
            self._scan_pushdown_fn(node), self.rows_per_batch, opts,
            self.device, record_split=record_split,
            check_cancel=self._check_cancel, stats=self.stats,
            static_pushdown=node.pushdown or None)

    def _ValuesNode(self, node: ValuesNode) -> Iterator[Batch]:
        yield values_batch(node, self.device)

    #: the mesh executor turns this off: its nodes run per slot
    compact_streams = True

    def _compactor(self):
        """Per-operator adaptive compaction (one host sync per checked
        batch; reference operator/project/PageProcessor.java compacted
        output pages): a selective filter or join leaves mostly-dead
        lanes that every later sort pays for. After the first batch that
        does not shrink 4x it stops checking."""
        state = {"check": self.compact_streams}

        def maybe_compact(b: Batch) -> Batch:
            if not state["check"] or b.capacity <= (1 << 17):
                return b
            with TRACER.span("device-sync", what="compaction-liveness"):
                tgt = bucket_capacity(b.host_count())
            if tgt * 4 <= b.capacity:
                return b.compact(tgt, check=False)
            state["check"] = False
            return b
        return maybe_compact

    def _FilterNode(self, node: FilterNode) -> Iterator[Batch]:
        fn = self.checked_filter(self._resolve(node.predicate),
                                 _plan_schema(node.child))
        compact = self._compactor()
        for b in self.run(node.child):
            yield compact(fn(b))

    def _ProjectNode(self, node: ProjectNode) -> Iterator[Batch]:
        fn = compile_projection([self._resolve(e) for e in node.exprs],
                                [f.name for f in node.fields],
                                _plan_schema(node.child), errors=True)
        for b in self.run(node.child):
            out, err = fn(b)
            if err is not None:
                self.error_flags.append(err)
            yield out

    def _LimitNode(self, node: LimitNode) -> Iterator[Batch]:
        remaining = node.count
        for b in self.run(node.child):
            if remaining <= 0:
                return
            out = limit_kernel(b, remaining)
            remaining -= out.host_count()
            yield out

    def _UnionNode(self, node: UnionNode) -> Iterator[Batch]:
        for c in node.children:
            yield from self.run(c)

    def _GroupIdNode(self, node: GroupIdNode) -> Iterator[Batch]:
        """One replica batch per grouping set: absent keys get their
        validity cleared (NULL), $group_id is a constant column
        (reference operator/GroupIdOperator.java)."""
        schema = _plan_schema(node)
        for b in self.run(node.child):
            for g in range(len(node.grouping_sets)):
                yield grouping_set_batch(b, node, g, schema)

    def _WindowNode(self, node: WindowNode) -> Iterator[Batch]:
        b = self._drain(node.child)
        if b is None:
            return
        specs = [WindowSpec(f.fn, f.args, f.output_type, f.name, f.offset,
                            f.ignore_order, f.frame, f.frame_start,
                            f.frame_end) for f in node.functions]
        out = evaluate_window(b, list(node.partition_indices),
                              self._sort_keys(node.order_keys), specs,
                              errors=self.error_flags)
        yield Batch(_plan_schema(node), out.columns, out.row_mask)

    def _MarkDistinctNode(self, node: MarkDistinctNode) -> Iterator[Batch]:
        """Drain, then one sort for first-occurrence flags (reference
        MarkDistinctOperator keeps a hash set across pages instead)."""
        b = self._drain(node.child)
        if b is None:
            return
        flags = mark_distinct_flags(b, list(node.cols))
        yield Batch(_plan_schema(node), list(b.columns)
                    + [Column(T.BOOLEAN, flags, b.row_mask)], b.row_mask)

    def _UnnestNode(self, node: UnnestNode) -> Iterator[Batch]:
        exprs = [self._resolve(e) for e in node.exprs]
        schema = _plan_schema(node)
        compact = self._compactor()
        for b in self.run(node.child):
            out, err = unnest_expand(b, exprs, node.ordinality, schema)
            if err is not None:
                self.error_flags.append(err)
            yield compact(out)

    def _drain(self, node: PlanNode) -> Optional[Batch]:
        batches = list(self.run(node))
        if not batches:
            return None
        return batches[0] if len(batches) == 1 else concat_batches(batches)

    @staticmethod
    def _sort_keys(keys) -> List[SortKey]:
        return [SortKey(k.index, k.ascending, k.nulls_first) for k in keys]

    def _SortNode(self, node: SortNode) -> Iterator[Batch]:
        buf = SortSpillBuffer(self.pool, "order-by",
                              self._sort_keys(node.keys))
        try:
            for b in self.run(node.child):
                buf.add(b)
            yield from buf.results(self.rows_per_batch)
        finally:
            buf.close()

    def _TopNNode(self, node: TopNNode) -> Iterator[Batch]:
        keys = self._sort_keys(node.keys)
        cap = bucket_capacity(node.count)
        state: Optional[Batch] = None
        for b in self.run(node.child):
            cand = top_n(b, keys, node.count).compact(cap)
            state = cand if state is None else top_n(
                concat_batches([state, cand]), keys, node.count).compact(cap)
        if state is not None:
            yield sort_batch(state, keys)

    # -- aggregation ----------------------------------------------------------
    def _AggregationNode(self, node: AggregationNode) -> Iterator[Batch]:
        if any(a.distinct for a in node.aggs):
            raise NotImplementedError(
                "DISTINCT aggregates must be lowered by the planner")
        aggs = [AggSpec(a.fn, a.arg, a.output_type, a.name, mask=a.mask,
                        param=a.param) for a in node.aggs]
        group = list(node.group_indices)
        step = node.step
        if step != "final" and percentile_drains(
                aggs, _plan_schema(node.child).types, bool(group)):
            # grouped or string approx_percentile has no mergeable state:
            # drain the input and evaluate in one exact segmented-sort
            # pass (the global numeric form carries histogram state
            # through the partial/final path below)
            b = self._drain(node.child)
            if b is None:
                if group:
                    return
                b = Batch.from_arrays(
                    _plan_schema(node.child),
                    [[] for _ in node.child.fields], num_rows=0,
                    device=self.device)
            yield (grouped_aggregate(b, group, aggs, mode="single",
                                     errors=self.error_flags)
                   if group else global_aggregate(b, aggs, mode="single",
                                                  errors=self.error_flags))
            return
        if not group:
            yield from self._global_agg(node, aggs, step)
            return
        kb = tuple(node.key_bounds) if node.key_bounds else None
        out = self._grouped_agg(node.child, group, aggs, kb, step)
        if not (node.default_gids and step in ("single", "final")):
            yield from out
            return
        # grouping sets over EMPTY input: the empty sets still owe their
        # grand-total rows (reference AggregationNode.hasDefaultOutput);
        # aggregated outputs are small, so the host count is cheap
        outs = list(out)
        yield from outs
        if sum(b.host_count() for b in outs) == 0:
            yield _default_grouping_batch(node, self.device)

    def _DistinctNode(self, node: DistinctNode) -> Iterator[Batch]:
        """A grouped aggregate with no aggregates under the node's key
        bounds."""
        kb = tuple(node.key_bounds) if node.key_bounds else None
        yield from self._grouped_agg(node.child, range(len(node.fields)),
                                     [], kb, "single", name="distinct")

    def _grouped_agg(self, child: PlanNode, group, aggs, kb, step: str,
                     name: str = "hash-agg") -> Iterator[Batch]:
        """Partial aggregation per batch into an AggSpillBuffer (partial
        states merged every MERGE_EVERY batches on the device, or staged
        to the host hash-partitioned by group key under memory
        pressure), then the final (or, for a partial step, the merge)
        aggregation of what it holds, partition by partition when it
        spilled."""
        allow = bool_property(self.session, "dense_grouping", True)
        group = list(group)
        key_idx = list(range(len(group)))
        buf = AggSpillBuffer(
            self.pool, name, key_idx, aggs, self.spill_partitions,
            merge_every=self.MERGE_EVERY, key_bounds=kb, allow_dense=allow,
            flag_bounds=lambda b: self._flag_bounds(b, key_idx, aggs, kb,
                                                    allow),
            errors=self.error_flags)
        def partial(b: Batch) -> Batch:
            self._flag_bounds(b, group, aggs, kb, allow)
            return grouped_aggregate(b, group, aggs, mode="partial",
                                     key_bounds=kb, allow_dense=allow,
                                     errors=self.error_flags)
        try:
            if step == "final":
                partials = self.run(child)
            else:
                # task_concurrency > 1: the partials run on that many
                # driver threads over a round-robin local exchange
                # (reference AddLocalExchanges + multi-driver pipelines)
                partials = parallel_drivers(
                    self.run(child), partial,
                    int(self.session.properties.get("task_concurrency", 1)))
            for part in partials:
                buf.add_partial(part)
            yield from buf.results(final=step != "partial")
        finally:
            buf.close()

    def _flag_bounds(self, b: Batch, cols, aggs, kb, allow) -> None:
        """Stats-bounds contract: a batch that takes the dense (clamping)
        path owes a violation flag on the error channel."""
        if kb is not None and allow and dense_path_selected(
                b, cols, aggs, key_bounds=kb):
            self.error_flags.append(key_bounds_violation(b, cols, kb))

    def _global_agg(self, node: AggregationNode, aggs, step):
        def agg(b: Batch, mode: str) -> Batch:
            return global_aggregate(b, aggs, mode=mode,
                                    errors=self.error_flags)
        parts: List[Batch] = []
        for b in self.run(node.child):
            parts.append(agg(b, "partial") if step != "final" else b)
            if len(parts) >= 64:
                parts = [agg(concat_batches(parts), "merge")]
        if not parts:
            # no input still finalizes to one row (count = 0)
            empty = Batch.from_arrays(
                _plan_schema(node.child), [[] for _ in node.child.fields],
                num_rows=0, device=self.device)
            parts = [empty if step == "final" else agg(empty, "partial")]
        states = concat_batches(parts) if len(parts) > 1 else parts[0]
        if step == "partial":
            yield agg(states, "merge") if len(parts) > 1 else states
        else:
            yield agg(states, "final")

    # -- joins ----------------------------------------------------------------
    def _JoinNode(self, node: JoinNode) -> Iterator[Batch]:
        yield from self._coalesce(self._join_dispatch(node))

    def _coalesce(self, it: Iterator[Batch],
                  min_cap: int = 1 << 15) -> Iterator[Batch]:
        """Merge runs of small batches (selective joins compact to tiny
        buckets) so later operators launch fewer, larger kernels."""
        pend: List[Batch] = []
        acc = 0
        for b in it:
            if b.capacity >= min_cap:
                if pend:
                    yield pend[0] if len(pend) == 1 else concat_batches(pend)
                    pend, acc = [], 0
                yield b
                continue
            pend.append(b)
            acc += b.capacity
            if acc >= min_cap:
                yield concat_batches(pend)
                pend, acc = [], 0
        if pend:
            yield pend[0] if len(pend) == 1 else concat_batches(pend)

    def _join_dispatch(self, node: JoinNode) -> Iterator[Batch]:
        lifespan = self._lifespan_partitions(node)
        if lifespan is None and bool_property(self.session,
                                              "fused_pipeline", True):
            fused = self._try_fused_chain(node)
            if fused is not None:
                yield from fused
                return
        if lifespan is None:
            yield from self._join_once(node)
            return
        ls, rs, part_pairs, buckets = lifespan
        bucket_node = _without_key_pairs(node, part_pairs)
        for lsplits, rsplits in buckets:
            self.lifespan_splits[ls] = lsplits
            self.lifespan_splits[rs] = rsplits
            # dynamic-filter bounds are bucket-local: bounds pushed while
            # joining bucket k must not prune bucket k+1
            saved_dyn = dict(self.dynamic_pushdown)
            try:
                yield from self._join_once(bucket_node)
            finally:
                self.lifespan_splits.pop(ls, None)
                self.lifespan_splits.pop(rs, None)
                self.dynamic_pushdown = saved_dyn

    def _lifespan_partitions(self, node: JoinNode):
        """Partition-wise (grouped, lifespan) execution check: when both
        sides of an inner join scan Hive-partitioned tables whose
        partition keys are covered pairwise by the equi-join keys, rows
        match only within equal partition values, so the join runs one
        partition at a time and its build holds one partition's rows
        (reference execution/Lifespan.java:26,
        scheduler/group/LifespanScheduler.java). Such a join never takes
        the fused chain. Returns (left scan, right scan, the (left key,
        right key) pairs on partition columns, [(left splits, right
        splits)] of the common partition values in order), or None.

        Unlike the reference, a bucket joins on the other key pairs
        alone: every row of both sides holds the bucket's partition value
        (a file catalog's partition values are the directory names, never
        NULL), so the dropped pairs are equal on every row pair, and a
        join left with one integer key probes a direct-address table
        through the probe kernel instead of a multi-key binary search."""
        if node.join_type != "inner" or not bool_property(
                self.session, "grouped_execution", True):
            return None

        def unwrap(n):
            while isinstance(n, FilterNode):
                n = n.child
            return n if isinstance(n, TableScanNode) else None

        ls, rs = unwrap(node.left), unwrap(node.right)
        if ls is None or rs is None or ls is rs:
            return None
        # a memoized (shared) scan would cache its first bucket's output
        if any(n in self._ever_shared
               for n in (ls, rs, node.left, node.right)):
            return None

        def partition_info(scan: TableScanNode):
            conn = self.session.catalogs.get(scan.catalog)
            keys_fn = getattr(conn, "partition_keys", None)
            keys = keys_fn(scan.table.table) if keys_fn is not None else None
            if not keys:
                return None
            try:
                idx = [scan.columns.index(k) for k in keys]
            except ValueError:
                return None     # a partition column not even scanned
            # one split listing per side; a bucket is then a dict lookup
            by_value: Dict[Tuple, List] = {}
            for sp in conn.split_manager.splits(scan.table, 1):
                if len(sp.info) > 1:
                    by_value.setdefault(tuple(sp.info[1]), []).append(sp)
            return idx, by_value

        li, ri = partition_info(ls), partition_info(rs)
        if li is None or ri is None or len(li[0]) != len(ri[0]):
            return None
        # every partition-key position must be an equi-join pair
        pairs = set(zip(node.left_keys, node.right_keys))
        part_pairs = set(zip(li[0], ri[0]))
        if not part_pairs <= pairs:
            return None
        common = sorted(li[1].keys() & ri[1].keys())
        return ls, rs, part_pairs, [(li[1][v], ri[1][v]) for v in common]

    # -- fused join chains ----------------------------------------------------
    def _try_fused_chain(self, top: JoinNode):
        """Head check for a fused chain (exec/fused.py): two or more
        unique-build inner or left joins without residuals, with the
        filters and projections between them, over one streaming source.
        Returns the output iterator, or None when the shape does not
        qualify (the generic per-operator path then runs unchanged). The
        chain's work runs in the head join's frames, so EXPLAIN ANALYZE
        and the profiler charge it there; interior nodes never run on
        their own."""
        def join_ok(j: PlanNode) -> bool:
            return (isinstance(j, JoinNode)
                    and j.join_type in ("inner", "left")
                    and j.build_unique and j.residual is None)

        if not join_ok(top):
            return None
        nodes: List[PlanNode] = []       # top-down
        cur: PlanNode = top
        njoins = 0
        while True:
            if cur is not top and cur in self._shared:
                break                    # memoized source boundary
            if join_ok(cur):
                nodes.append(cur)
                njoins += 1
                cur = cur.left
            elif isinstance(cur, (FilterNode, ProjectNode)):
                nodes.append(cur)
                cur = cur.child
            else:
                break
        if njoins < 2:
            return None
        if any(has_params(getattr(n, "predicate", None))
               or has_params(getattr(n, "exprs", None))
               for n in nodes):
            # plan-template parameters: the fused chain runs as the
            # reference's does, which gives its head/tail programs no
            # channel for runtime bindings; the per-operator path reads
            # them from the binding scope
            return None
        return self._run_fused_chain(nodes, cur)

    def _run_fused_chain(self, nodes: List[PlanNode], source: PlanNode):
        """Drain and prepare every build of the chain (bottom-up), push
        every bound that maps to a source column to the source scan
        before it starts (the generic path can push only the bottom
        join's), then stream the source through the head and tail
        (``_stream_fused``). None when a build is empty or spilled: the
        generic path then runs the joins (and drains those builds
        again)."""
        src_map = {i: i for i in range(len(source.fields))}
        dyn_enabled = bool_property(self.session,
                                    "enable_dynamic_filtering", True)
        stages: List[object] = []
        builds = _ChainBuilds()
        pre_rows: List[Tuple[int, int, int]] = []
        try:
            ok = self._drain_fused_builds(list(reversed(nodes)), src_map,
                                          dyn_enabled, stages, builds,
                                          pre_rows)
        except BaseException:
            builds.close()
            raise
        if not ok:
            builds.close()
            return None
        if pre_rows:
            self._push_dynamic_bounds(source, pre_rows)
        first_join = next(i for i, st in enumerate(stages)
                          if isinstance(st, JoinStage))
        head, tail = stages[:first_join], stages[first_join:]
        join1 = tail[0]
        semi_keys = ((join1.lkeys, join1.rkeys)
                     if join1.join_type == "inner" else None)
        fn_head = fused_prefilter(tuple(head),
                                  tuple(k for k, _, _ in pre_rows),
                                  semi_keys)
        fn_tail = fused_pipeline(tuple(tail))
        window = max(1, int(self.session.properties.get(
            "fused_compact_window", 4)))
        return self._stream_fused(fn_head, fn_tail, source,
                                  [(lo, hi) for _, lo, hi in pre_rows],
                                  builds, window)

    def _stream_fused(self, fn_head, fn_tail, source, pre_vals,
                      builds: "_ChainBuilds",
                      window: int) -> Iterator[Batch]:
        """Head -> windowed compaction -> tail. The head returns each
        batch's live count as a device scalar; one readback per
        ``window`` batches stacks them, each batch compacts to its live
        bucket, and the tail gathers over the compacted lanes. The check
        disables itself after a window with no 4x shrink (as
        _compactor's does), so a non-selective chain pays one sync."""
        compact = self._compactor()
        state = {"check": True}
        pend: List[Tuple[Batch, torch.Tensor]] = []
        # the _compactor floor: below it the tail over the full capacity
        # costs less than the (amortized) readback
        floor = int(self.session.properties.get("fused_compact_floor",
                                                1 << 17))

        def drain_pend() -> List[Batch]:
            if not pend:
                return []
            with TRACER.span("device-sync", what="fused-liveness",
                             batches=len(pend)):
                counts = torch.stack([c for _, c in pend]).cpu().tolist()
            _FUSED_READBACKS.inc()
            outs, shrunk = [], False
            for (b, _), live in zip(pend, counts):
                tgt = bucket_capacity(max(int(live), 1))
                if b.capacity > floor and tgt * 4 <= b.capacity:
                    b = b.compact(tgt, check=False)
                    shrunk = True
                outs.append(b)
            if not shrunk:
                # selectivity is near-uniform across a chain's batches
                state["check"] = False
            pend.clear()
            return outs

        def run_tail(hb: Batch) -> Iterator[Batch]:
            _FUSED_TAIL_LANES.inc(hb.capacity)
            out, err = fn_tail(hb, builds.preps, builds.builds,
                               builds.sorted_cols, builds.dyns)
            if err is not None:
                self.error_flags.append(err)
            yield compact(out)

        try:
            for probe in self.run(source):
                _FUSED_SOURCE_LANES.inc(probe.capacity)
                hb, err, cnt = fn_head(probe, pre_vals, builds.builds[0],
                                       builds.preps[0])
                if err is not None:
                    self.error_flags.append(err)
                if not state["check"] or hb.capacity <= floor:
                    # a sub-floor batch never compacts: no readback, and
                    # no vote on the adaptive disable
                    yield from run_tail(hb)
                    continue
                pend.append((hb, cnt))
                if len(pend) >= window:
                    for b in drain_pend():
                        yield from run_tail(b)
            for b in drain_pend():
                yield from run_tail(b)
        finally:
            builds.close()

    def _drain_fused_builds(self, order, src_map, dyn_enabled, stages,
                            builds: "_ChainBuilds", pre_rows) -> bool:
        """Drain and prepare every build of a chain (bottom-up), appending
        its stages; False when a build is empty or spilled. ``pre_rows``
        collects every dynamic bound whose key maps to a raw source column,
        as (source index, lo, hi), for the head's mask."""
        for nd in order:
            if isinstance(nd, FilterNode):
                stages.append(FilterStage(self._resolve(nd.predicate)))
                continue
            if isinstance(nd, ProjectNode):
                exprs = tuple(self._resolve(e) for e in nd.exprs)
                stages.append(ProjectStage(
                    exprs, tuple(f.name for f in nd.fields)))
                src_map = {out_i: src_map[e.index]
                           for out_i, e in enumerate(exprs)
                           if isinstance(e, ir.InputRef)
                           and e.index in src_map}
                continue
            rkeys = list(nd.right_keys)
            # through the spillable buffer for memory accounting; a build
            # the pool forces to the host cannot fuse
            buf = SpillableBuildBuffer(self.pool, "join-build", rkeys,
                                       self.spill_partitions)
            builds.bufs.append(buf)
            for b in self.run(nd.right):
                buf.add(b)
            build = buf.finish()
            if build is None or isinstance(build, HostPartitionStore):
                return False
            summary = self._build_summary(build, rkeys)
            if int(summary[0]) == 0:
                return False
            scap = bucket_capacity(max(int(summary[0]), 1))
            if scap < build.capacity:
                build = build.compact(scap, check=False)
            prep = self._prepare_join_build(build, rkeys, summary,
                                            nd.key_bounds)
            _note_join_strategy(
                self.stats, nd,
                "direct" if is_direct_prepared(prep) else "sorted",
                nd.distribution)
            payload = tuple(range(len(nd.right.fields)))
            dyn_keys: Tuple[int, ...] = ()
            dyn_val: Tuple[Tuple[int, int], ...] = ()
            if nd.join_type == "inner" and dyn_enabled:
                bounds = self._summary_bounds(summary, nd.left_keys)
                dyn_keys = tuple(k for k, _, _ in bounds)
                dyn_val = tuple((lo, hi) for _, lo, hi in bounds)
                pre_rows.extend((src_map[k], lo, hi) for k, lo, hi in bounds
                                if k in src_map)
            stages.append(JoinStage(
                lkeys=tuple(nd.left_keys), rkeys=tuple(rkeys),
                payload=payload, names=tuple(f"$b{i}" for i in payload),
                join_type=nd.join_type,
                out_fields=tuple((f.name, f.type) for f in nd.fields),
                dyn_keys=dyn_keys))
            builds.preps.append(prep)
            builds.builds.append(build)
            builds.sorted_cols.append(
                sorted_payload(build, payload, prep)
                if is_direct_prepared(prep) else None)
            builds.dyns.append(dyn_val)
        return True

    # -- per-operator joins ---------------------------------------------------
    def _join_once(self, node: JoinNode) -> Iterator[Batch]:
        payload = list(range(len(node.right.fields)))
        payload_names = [f"$b{i}" for i in payload]
        if node.join_type == "cross":
            yield from self._cross_join(node, self._drain(node.right))
            return
        if node.join_type not in ("inner", "left", "full"):
            raise NotImplementedError(f"{node.join_type} joins are not ported")
        residual_fn = residual_outer = None
        if node.residual is not None:
            fn = self.checked_filter(self._resolve(node.residual),
                                     _plan_schema(node))
            # the ON filter of an outer join gates matches and never drops
            # probe rows (_probe_outer_residual)
            if node.join_type == "inner":
                residual_fn = fn
            else:
                residual_outer = fn
        dyn_on = node.join_type == "inner" and bool_property(
            self.session, "enable_dynamic_filtering", True)
        # inter-pipeline overlap: the probe side runs on a producer thread
        # while the build drains (the reference's build and probe
        # pipelines of one task). Not for a probe scan a dynamic filter
        # could prune: its splits would be read before the bounds exist.
        probe_ex = None
        if bool_property(self.session, "probe_prefetch", True) and not (
                dyn_on and self._dynamic_scan_target(node.left) is not None):
            probe_ex = exchange_source(self.run(node.left), "single", 1,
                                       buffer_batches=4)
        try:
            yield from self._join_probe(node, probe_ex, payload,
                                        payload_names, residual_fn,
                                        residual_outer, dyn_on)
        finally:
            if probe_ex is not None:
                probe_ex.close()

    def _join_probe(self, node: JoinNode, probe_ex, payload, payload_names,
                    residual_fn, residual_outer,
                    dyn_on: bool) -> Iterator[Batch]:
        """Drain the build through a SpillableBuildBuffer, then stream the
        probe side (from the producer thread's exchange when prefetched)
        through the probe kernels, or, when the build spilled, join
        partition by partition."""
        buf = SpillableBuildBuffer(self.pool, "join-build",
                                   list(node.right_keys),
                                   self.spill_partitions)
        try:
            for b in self.run(node.right):
                buf.add(b)
            build = buf.finish()
            probes = probe_ex.consumer(0) if probe_ex is not None \
                else self.run(node.left)
            if isinstance(build, HostPartitionStore):
                yield from self._partitioned_join(
                    node, build, payload, payload_names, residual_fn,
                    residual_outer, probes)
                return
            yield from self._join_build(node, build, probes, payload,
                                        payload_names, residual_fn,
                                        residual_outer, dyn_on)
        finally:
            buf.close()

    def _join_build(self, node: JoinNode, build: Optional[Batch], probes,
                    payload, payload_names, residual_fn, residual_outer,
                    dyn_on: bool) -> Iterator[Batch]:
        """Probe a device-resident build with every probe batch."""
        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        dyn = prep = sorted_cols = maxk = None
        unique = node.build_unique
        if build is not None:
            summary = self._build_summary(build, rkeys)
            if dyn_on:
                dyn = self._summary_bounds(summary, lkeys)
                if dyn:
                    self._push_dynamic_bounds(node.left, dyn)
            # compact a sparse build before sorting it
            scap = bucket_capacity(max(int(summary[0]), 1))
            if scap < build.capacity:
                build = build.compact(scap, check=False)
            prep = self._prepare_join_build(build, rkeys, summary,
                                            node.key_bounds)
            _note_join_strategy(
                self.stats, node,
                ("direct" if is_direct_prepared(prep) else "sorted")
                if node.build_unique else "expand",
                node.distribution)
            if not node.build_unique:
                maxk = self._build_multiplicity(prep)
                # a direct build the planner could not prove unique (file
                # catalogs declare no keys) whose keys measure unique
                # probes like a unique one: the same rows in the same
                # lanes as the expansion at one match a row
                unique = (maxk == 1 and is_direct_prepared(prep)
                          and residual_outer is None)
            if unique and is_direct_prepared(prep):
                sorted_cols = sorted_payload(build, payload, prep)
        track_full = node.join_type == "full" and build is not None
        build_matched = None
        full_acc = ({"m": None} if track_full and residual_outer is not None
                    else None)
        compact = self._compactor()
        for probe in probes:
            if build is None:
                if node.join_type != "inner":
                    yield compact(self._null_extend(probe, node))
                continue
            probe = keys_in_build_vocab(probe, build, lkeys, rkeys)
            if dyn:
                probe = _apply_dynamic_bounds(probe, dyn)
            if residual_outer is not None:
                for out in self._probe_outer_residual(
                        node, probe, build, payload, payload_names, prep,
                        sorted_cols, residual_outer, full_acc, maxk):
                    yield compact(out)
                continue
            for out in self._probe_batches(node, probe, build, payload,
                                           payload_names, prep, sorted_cols,
                                           maxk, unique):
                if residual_fn is not None:
                    out = residual_fn(out)
                yield compact(out)
            if track_full:
                m = build_match_mask(probe, build, lkeys, rkeys, prep)
                build_matched = m if build_matched is None \
                    else build_matched | m
        if track_full:
            # FULL OUTER tail: build rows no probe row matched, with NULL
            # probe columns (reference LookupOuterOperator)
            if full_acc is not None:
                build_matched = full_acc["m"]
            yield compact(self._null_extend_build(build, node, build_matched))

    def _dynamic_scan_target(self, probe: PlanNode):
        """(scan node, out-index -> scan-column mapping) when the probe
        chain maps columns straight to a scan through filters and
        identity projections; None otherwise."""
        mapping = {i: i for i in range(len(probe.fields))}
        node = probe
        while True:
            if node in self._ever_shared:
                return None  # a replayed subtree feeds other consumers too
            if isinstance(node, FilterNode):
                node = node.child
                continue
            if isinstance(node, ProjectNode):
                mapping = {out_i: node.exprs[in_i].index
                           for out_i, in_i in mapping.items()
                           if isinstance(node.exprs[in_i], ir.InputRef)}
                node = node.child
                continue
            break
        if not isinstance(node, TableScanNode) or not mapping:
            return None
        return node, mapping

    def _push_dynamic_bounds(self, probe: PlanNode,
                             dyn: List[Tuple[int, int, int]]) -> None:
        """Runtime scan pushdown: when the probe chain maps the join keys
        straight to scan columns, hand the build side's [lo, hi] to the
        scan (reference sql/DynamicFilters.java:43). The TPC-H, TPC-DS
        and memory connectors prune nothing with it; it enters the scan
        cache's key."""
        target = self._dynamic_scan_target(probe)
        if target is None:
            return
        node, mapping = target
        extra = [(node.columns[mapping[k]], lo, hi)
                 for k, lo, hi in dyn if k in mapping]
        if extra:
            self.dynamic_pushdown.setdefault(node, []).extend(extra)

    def _partitioned_join(self, node: JoinNode, store: HostPartitionStore,
                          payload, payload_names, residual_fn,
                          residual_outer, probes) -> Iterator[Batch]:
        """Spilled-build probe: stage the probe side host-partitioned by
        the same key hash, then join partition by partition, so one build
        partition and one probe chunk are on the device at a time
        (reference GenericPartitioningSpiller.java's probe protocol).
        Partitions probe over the sorted build path: a direct-address
        table per partition would add the very memory that forced the
        spill. Each probe row hashes to one partition, so per-partition
        outer semantics compose to the global outer join."""
        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        full = node.join_type == "full"
        _note_join_strategy(
            self.stats, node,
            "sorted" if node.build_unique else "expand", "partitioned")
        pstore: Optional[HostPartitionStore] = None
        try:
            for probe in probes:
                if pstore is None:
                    pstore = HostPartitionStore(probe.schema, store.n,
                                                pool=self.pool)
                pstore.add(probe, lkeys)
            if pstore is None:
                if full:
                    # no probe rows at all: every build row is unmatched
                    for p in range(store.n):
                        bpart = store.partition_batch(p)
                        if bpart is not None:
                            yield self._null_extend_build(bpart, node, None)
                return
            for p in range(store.n):
                bpart = store.partition_batch(p)
                matched = prep = maxk = None
                for probe_p in pstore.partition_batches(
                        p, self.rows_per_batch):
                    if bpart is None:
                        if node.join_type in ("left", "full"):
                            yield self._null_extend(probe_p, node)
                        continue
                    if prep is None:
                        prep = prepare_build(bpart, rkeys)
                        if not node.build_unique:
                            maxk = self._build_multiplicity(prep)
                    probe_p = keys_in_build_vocab(probe_p, bpart, lkeys,
                                                  rkeys)
                    if residual_outer is not None:
                        acc = {"m": None} if full else None
                        yield from self._probe_outer_residual(
                            node, probe_p, bpart, payload, payload_names,
                            prep, None, residual_outer, acc, maxk)
                        m = acc["m"] if acc is not None else None
                    else:
                        for out in self._probe_batches(
                                node, probe_p, bpart, payload,
                                payload_names, prep, None, maxk,
                                node.build_unique):
                            yield residual_fn(out) \
                                if residual_fn is not None else out
                        m = (build_match_mask(probe_p, bpart, lkeys, rkeys,
                                              prep) if full else None)
                    if m is not None:
                        matched = m if matched is None else matched | m
                if full and bpart is not None:
                    yield self._null_extend_build(bpart, node, matched)
        finally:
            if pstore is not None:
                pstore.close()

    def _build_summary(self, build: Batch, keys) -> List[int]:
        """Host copy of [live_count, lo_0, hi_0, ...] over the integer key
        columns (non-integer keys report (0, -1)): one readback."""
        live = build.row_mask
        out = [live.sum(dtype=torch.int64)]
        i64 = torch.iinfo(torch.int64)
        for k in keys:
            c = build.columns[k]
            if not isinstance(c.type, _DYN_TYPES):
                out += [torch.zeros((), dtype=torch.int64, device=live.device),
                        torch.full((), -1, dtype=torch.int64,
                                   device=live.device)]
                continue
            ok = live & c.validity
            data = c.data.to(torch.int64)
            out.append(torch.where(ok, data, i64.max).min())
            out.append(torch.where(ok, data, i64.min).max())
        with TRACER.span("device-sync", what="build-summary"):
            return torch.stack(out).tolist()

    @staticmethod
    def _summary_bounds(summary, out_keys):
        """[(out_key, lo, hi), ...] for the integer keys in a summary."""
        out = []
        for i, pk in enumerate(out_keys):
            lo, hi = int(summary[1 + 2 * i]), int(summary[2 + 2 * i])
            if lo <= hi:
                out.append((pk, lo, hi))
        return out

    def _prepare_join_build(self, build: Batch, keys, summary=None,
                            key_bounds=()):
        """LookupSource choice, stats first (reference HashBuilderOperator):
        planner-promised key bounds build a composite direct-address
        table (cross-checked through the error channel); a single integer
        key with a bounded measured span builds a direct table; anything
        else sorts."""
        keys = tuple(keys)
        if key_bounds and bool_property(self.session, "join_dense_path",
                                        True):
            plan = direct_keyed_plan(tuple(key_bounds))
            if plan is not None:
                los, sizes, K = plan
                self.error_flags.append(
                    key_bounds_violation(build, keys, key_bounds))
                return prepare_direct_keyed(build, keys, los, sizes,
                                            bucket_capacity(K))
        if len(keys) == 1 and isinstance(build.columns[keys[0]].type,
                                         _DYN_TYPES):
            if summary is None:
                summary = self._build_summary(build, keys)
            if summary[0] > 0:
                lo, hi = int(summary[1]), int(summary[2])
                span = hi - lo + 1
                if 0 < span <= self.DIRECT_SPAN_LIMIT:
                    return prepare_direct(build, keys, lo,
                                          bucket_capacity(span))
        return prepare_build(build, keys)

    @staticmethod
    def _dispatch_lookup(probe, build, lkeys, rkeys, payload, payload_names,
                         jt, prepared, sorted_cols):
        """Unique-build probe: the direct-address probe kernel for direct
        builds, binary search over the sorted build otherwise."""
        if is_direct_prepared(prepared):
            return lookup_join_direct(probe, build, lkeys, rkeys, payload,
                                      payload_names, jt, prepared,
                                      sorted_cols=sorted_cols)
        return lookup_join(probe, build, lkeys, rkeys, payload,
                           payload_names, jt, prepared)

    def _build_multiplicity(self, prepared) -> Optional[int]:
        """The build's largest key multiplicity (one readback for every
        probe batch of the join), or None when it exceeds
        SKEW_MATCH_LIMIT: sizing every batch by the hottest key would push
        all of them into the chunked skew path, so those batches count
        their own matches instead."""
        with TRACER.span("device-sync", what="build-multiplicity"):
            m = int(max_multiplicity(prepared))
        return m if m <= self.SKEW_MATCH_LIMIT else None

    def _skew_chunks(self, probe: Batch, build: Batch, lkeys, rkeys,
                     prepared, maxk):
        """[(build, expansion factor, prepared)] to expand ``probe``
        against: the whole build at the bucketed factor, or, past
        SKEW_MATCH_LIMIT, chunks of the build by within-key occurrence
        rank. Ranks are dense from 0, so a probe row with any match
        matches in chunk 0."""
        if maxk is None:
            maxk = int(match_count_max(probe, build, lkeys, rkeys, prepared))
        limit = self.SKEW_MATCH_LIMIT
        if maxk <= limit:
            return [(build, bucket_capacity(max(maxk, 1), minimum=1),
                     prepared)]
        ranks = build_key_ranks(build, rkeys, prepared)
        return [(Batch(build.schema, build.columns,
                       build.row_mask & (ranks >= c) & (ranks < c + limit)),
                 limit, None)
                for c in range(0, maxk, limit)]

    def _probe_batches(self, node: JoinNode, probe: Batch, build: Batch,
                       payload, payload_names, prepared, sorted_cols,
                       maxk, unique: bool) -> Iterator[Batch]:
        schema = _plan_schema(node)
        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        # FULL OUTER probes like LEFT; _join_once emits the unmatched
        # build tail
        jt = "left" if node.join_type == "full" else node.join_type
        if unique:
            out = self._dispatch_lookup(probe, build, lkeys, rkeys, payload,
                                        payload_names, jt, prepared,
                                        sorted_cols)
            yield Batch(schema, out.columns, out.row_mask)
            return
        chunks = self._skew_chunks(probe, build, lkeys, rkeys, prepared,
                                   maxk)
        for c, (sub, k, prep) in enumerate(chunks):
            # later chunks join inner: chunk 0 keeps the outer rows
            out = expand_join(probe, sub, lkeys, rkeys, payload,
                              payload_names, jt if c == 0 else "inner", k,
                              prep)
            yield Batch(schema, out.columns, out.row_mask)

    def _probe_outer_residual(self, node: JoinNode, probe: Batch,
                              build: Batch, payload, payload_names,
                              prepared, sorted_cols, residual_fn, full_acc,
                              maxk) -> Iterator[Batch]:
        """LEFT/FULL OUTER probe with an ON residual: a probe row pairs
        with the build rows whose keys match AND whose residual passes; a
        probe row with no surviving match comes back null-extended
        (reference LookupJoinOperator + JoinFilterFunctionCompiler).
        ``full_acc`` (FULL only) collects the build rows with a surviving
        match. The residual runs over matched lanes only, so its row
        errors fire exactly for the rows it really evaluates."""
        schema = _plan_schema(node)
        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        npro = len(node.left.fields)

        def mark_full(mask):
            if full_acc is not None:
                full_acc["m"] = mask if full_acc["m"] is None \
                    else full_acc["m"] | mask

        if node.build_unique:
            out = self._dispatch_lookup(probe, build, lkeys, rkeys, payload,
                                        payload_names, "left", prepared,
                                        sorted_cols)
            match = semi_join_mask(probe, build, lkeys, rkeys, False, False,
                                   prepared)
            survived = residual_fn(Batch(schema, out.columns,
                                         probe.row_mask & match)).row_mask
            cols = list(out.columns[:npro])
            for c in out.columns[npro:]:
                cols.append(Column(c.type, c.data, c.validity & survived,
                                   c.dictionary))
            if full_acc is not None:
                mark_full(unique_match_build_mask(probe, build, lkeys, rkeys,
                                                  survived, prepared))
            yield Batch(schema, cols, probe.row_mask)
            return
        has_survivor = torch.zeros_like(probe.row_mask)
        for sub, k, prep in self._skew_chunks(probe, build, lkeys, rkeys,
                                              prepared, maxk):
            e = expand_join(probe, sub, lkeys, rkeys, payload,
                            payload_names, "inner", k, prep)
            survived = residual_fn(Batch(schema, e.columns,
                                         e.row_mask)).row_mask
            has_survivor |= survived.reshape(k, probe.capacity).any(0)
            if full_acc is not None:
                orig, _ = expand_match_origins(probe, sub, lkeys, rkeys, k,
                                               prep)
                mark_full(mark_rows(orig, survived, sub.capacity))
            yield Batch(schema, e.columns, survived)
        # probe rows with no surviving match, null-extended
        reinstated = self._null_extend(probe, node)
        yield Batch(schema, reinstated.columns,
                    probe.row_mask & ~has_survivor)

    def _null_extend_build(self, build: Batch, node: JoinNode,
                           matched) -> Batch:
        """Unmatched build rows as output rows with NULL probe columns."""
        mask = build.row_mask
        if matched is not None:
            mask = mask & ~matched
        cols = _null_columns(node.left.fields, build.capacity, build.device)
        return Batch(_plan_schema(node), cols + list(build.columns), mask)

    def _null_extend(self, probe: Batch, node: JoinNode) -> Batch:
        cols = list(probe.columns) + _null_columns(
            node.fields[len(node.left.fields):], probe.capacity,
            probe.device)
        return Batch(_plan_schema(node), cols, probe.row_mask)

    def _cross_join(self, node: JoinNode, build: Optional[Batch]
                    ) -> Iterator[Batch]:
        """Cross join against a tiny build (scalar subqueries, VALUES):
        one copy of the probe batch per build row."""
        if build is None:
            return
        build = build.compact()
        nb = build.host_count()
        if nb == 0:
            return
        schema = _plan_schema(node)
        for probe in self.run(node.left):
            yield cross_expand(probe, build, nb, schema)

    def _SemiJoinNode(self, node: SemiJoinNode) -> Iterator[Batch]:
        build = self._drain(node.filtering)
        skeys = list(node.source_keys)
        fkeys = list(node.filtering_keys)
        residual = (self._resolve(node.residual)
                    if node.residual is not None else None)
        prep = res_maxk = None
        if build is not None:
            prep = self._prepare_join_build(build, fkeys,
                                            key_bounds=node.key_bounds)
            _note_join_strategy(
                self.stats, node,
                "direct" if is_direct_prepared(prep) else "sorted",
                node.distribution)
            if residual is not None:
                res_maxk = self._build_multiplicity(prep)
        for b in self.run(node.source):
            if build is None:
                # an empty filtering side: NOT IN / NOT EXISTS keep every
                # row, IN / EXISTS none
                yield b if node.negated else Batch(
                    b.schema, b.columns, torch.zeros_like(b.row_mask))
                continue
            b = keys_in_build_vocab(b, build, skeys, fkeys)
            if residual is None:
                mask = semi_join_mask(b, build, skeys, fkeys, node.negated,
                                      node.null_aware, prep)
            else:
                maxk = res_maxk if res_maxk is not None else int(
                    match_count_max(b, build, skeys, fkeys, prep))
                mask = mark_exists_mask(
                    b, build, skeys, fkeys, residual, node.negated,
                    bucket_capacity(max(maxk, 1), minimum=1), self)
            yield Batch(b.schema, b.columns, mask)
