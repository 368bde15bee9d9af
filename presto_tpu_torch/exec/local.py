"""Local plan executor: logical plan -> streaming batch iterators on one
device.

The counterpart of ``presto_tpu/exec/local.py`` (reference
presto-main/.../sql/planner/LocalExecutionPlanner.java:357 and
operator/Driver.java): each plan node becomes a generator over device
batches, so scan->filter->project->partial-agg chains stream without
materializing, while join builds, sorts and aggregations drain their
input. Ported node kinds: output, table scan, VALUES, filter, project,
limit, sort, top-n, aggregation, DISTINCT, joins (inner, left, full and
cross; unique or expanding builds; ON residuals) and semi joins (IN, NOT
IN, [NOT] EXISTS, with or without a residual). Init plans (uncorrelated
scalar subqueries) run before the main plan and their values substitute
into its expressions; a subplan that occurs more than once runs once and
replays its batches. Any other node kind raises NotImplementedError
naming it; so do spilled builds.

Unique-build joins probe through the CUDA direct-address probe kernel
(``ops/probe.py``) whenever the build gets a direct-address table, and
through binary search over the sorted build otherwise.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch

from .. import types as T
from ..batch import (
    Batch, Column, Schema, bucket_capacity, concat_batches,
)
from ..errors import STATS_BOUND_VIOLATION, QueryError
from ..expr import ir
from ..expr.compiler import compile_filter, compile_projection
from ..expr.rewrite import referenced_inputs, remap_inputs
from ..expr.rewrite import rewrite as ir_rewrite
from ..ops.aggregation import (
    AggSpec, dense_path_selected, global_aggregate, grouped_aggregate,
)
from ..ops.join import (
    build_key_ranks, build_match_mask, direct_keyed_plan, expand_join,
    expand_match_origins, is_direct_prepared, lookup_join, mark_rows,
    match_count_max, max_multiplicity, prepare_build, prepare_direct,
    prepare_direct_keyed, semi_join_mask, unique_match_build_mask,
)
from ..ops.probe import lookup_join_direct, sorted_payload
from ..ops.sort import SortKey, limit as limit_kernel, sort_batch, top_n
from ..planner.plan import (
    AggregationNode, DistinctNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanNode, ProjectNode, SemiJoinNode, SortNode,
    TableScanNode, TopNNode, ValuesNode,
)
from ..planner.planner import (
    InitPlanRef, LogicalPlan, Session, bool_property,
)

_DYN_TYPES = (T.BigintType, T.IntegerType, T.SmallintType, T.TinyintType,
              T.DateType)


@dataclasses.dataclass
class QueryResult:
    names: List[str]
    types: List[T.Type]
    rows: List[tuple]


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
                 rows_per_batch: int = 1 << 17) -> QueryResult:
    """Run a planned query on ``device`` and decode its rows."""
    ex = _Executor(session, rows_per_batch, torch.device(device))
    run_init_plans(ex, plan)
    root = plan.root
    out = list(ex.run(root.child))
    ex.check_errors()
    return QueryResult(names=[f.name for f in root.fields],
                       types=[f.type for f in root.fields],
                       rows=[r for b in out for r in b.to_pylist()])


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
                 device: torch.device):
        for prop in ("query_max_memory", "spill_partitions"):
            if prop in session.properties:
                raise NotImplementedError(
                    f"spilled, partitioned builds ({prop}) are not ported")
        self.session = session
        self.rows_per_batch = rows_per_batch
        self.device = device
        # device int32 scalars from error-checking kernels; reduced to one
        # host sync by check_errors() after the plan drains
        self.error_flags: List[torch.Tensor] = []
        #: init-plan values, appended by run_init_plans
        self.init_values: List[object] = []
        #: subplans that occur more than once (mark_shared) and the
        #: batches of those already run
        self._shared: Set[PlanNode] = set()
        self._materialized: Dict[PlanNode, List[Batch]] = {}

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

    def check_errors(self) -> None:
        """Raise the highest-coded row error seen this query (one sync)."""
        if not self.error_flags:
            return
        code = int(torch.stack(self.error_flags).max())
        self.error_flags = []
        if code:
            raise QueryError(code)

    def run(self, node: PlanNode) -> Iterator[Batch]:
        if node in self._materialized:
            return iter(self._materialized[node])
        m = getattr(self, "_" + type(node).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"{type(node).__name__} is not ported")
        if node in self._shared:
            self._materialized[node] = out = list(m(node))
            return iter(out)
        return m(node)

    def _OutputNode(self, node: OutputNode) -> Iterator[Batch]:
        return self.run(node.child)

    def _TableScanNode(self, node: TableScanNode) -> Iterator[Batch]:
        conn = self.session.catalogs.get(node.catalog)
        for split in conn.split_manager.splits(node.table, 1):
            source = conn.page_source(split, list(node.columns),
                                      node.pushdown or None,
                                      self.rows_per_batch,
                                      device=self.device)
            try:
                yield from source.batches()
            finally:
                source.close()

    def _ValuesNode(self, node: ValuesNode) -> Iterator[Batch]:
        if node.fields:
            yield Batch.from_pydict(
                {f.name: (f.type, [r[i] for r in node.rows])
                 for i, f in enumerate(node.fields)}, device=self.device)
            return
        # zero-column values (SELECT without FROM): live rows, no columns
        n = len(node.rows)
        yield Batch(Schema([]), [], torch.arange(
            bucket_capacity(max(n, 1)), device=self.device) < n)

    def _compactor(self):
        """Per-operator adaptive compaction (one host sync per checked
        batch; reference operator/project/PageProcessor.java compacted
        output pages): a selective filter or join leaves mostly-dead
        lanes that every later sort pays for. After the first batch that
        does not shrink 4x it stops checking."""
        state = {"check": True}

        def maybe_compact(b: Batch) -> Batch:
            if not state["check"] or b.capacity <= (1 << 17):
                return b
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

    def _drain(self, node: PlanNode) -> Optional[Batch]:
        batches = list(self.run(node))
        if not batches:
            return None
        return batches[0] if len(batches) == 1 else concat_batches(batches)

    @staticmethod
    def _sort_keys(node) -> List[SortKey]:
        return [SortKey(k.index, k.ascending, k.nulls_first)
                for k in node.keys]

    def _SortNode(self, node: SortNode) -> Iterator[Batch]:
        b = self._drain(node.child)
        if b is not None:
            yield sort_batch(b, self._sort_keys(node))

    def _TopNNode(self, node: TopNNode) -> Iterator[Batch]:
        keys = self._sort_keys(node)
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
        if node.default_gids:
            raise NotImplementedError("grouping sets are not ported")
        aggs = [AggSpec(a.fn, a.arg, a.output_type, a.name, mask=a.mask,
                        param=a.param) for a in node.aggs]
        group = list(node.group_indices)
        step = node.step
        if not group:
            yield from self._global_agg(node, aggs, step)
            return
        kb = tuple(node.key_bounds) if node.key_bounds else None
        yield from self._grouped_agg(node.child, group, aggs, kb, step)

    def _DistinctNode(self, node: DistinctNode) -> Iterator[Batch]:
        """A grouped aggregate with no aggregates under the node's key
        bounds."""
        kb = tuple(node.key_bounds) if node.key_bounds else None
        yield from self._grouped_agg(node.child, range(len(node.fields)),
                                     [], kb, "single")

    def _grouped_agg(self, child: PlanNode, group, aggs, kb,
                     step: str) -> Iterator[Batch]:
        """Partial aggregation per batch, partial states merged every
        MERGE_EVERY batches, then the final (or, for a partial step, the
        merge) aggregation of what is left."""
        allow = bool_property(self.session, "dense_grouping", True)
        group = list(group)
        key_idx = list(range(len(group)))
        states: List[Batch] = []
        for b in self.run(child):
            if step == "final":
                part = b
            else:
                self._flag_bounds(b, group, aggs, kb, allow)
                part = grouped_aggregate(b, group, aggs, mode="partial",
                                         key_bounds=kb, allow_dense=allow)
            states.append(part)
            if len(states) >= self.MERGE_EVERY:
                states = [self._merge_states(states, key_idx, aggs, kb,
                                             allow)]
        if not states:
            return
        merged = states[0] if len(states) == 1 else concat_batches(states)
        self._flag_bounds(merged, key_idx, aggs, kb, allow)
        yield grouped_aggregate(merged, key_idx, aggs,
                                mode="merge" if step == "partial" else "final",
                                key_bounds=kb, allow_dense=allow)

    def _merge_states(self, states, key_idx, aggs, kb, allow) -> Batch:
        """Merge buffered partial states into one compacted state batch."""
        cat = concat_batches(states)
        self._flag_bounds(cat, key_idx, aggs, kb, allow)
        merged = grouped_aggregate(cat, key_idx, aggs, mode="merge",
                                   key_bounds=kb, allow_dense=allow)
        return merged.compact(bucket_capacity(max(merged.host_count(), 1)))

    def _flag_bounds(self, b: Batch, cols, aggs, kb, allow) -> None:
        """Stats-bounds contract: a batch that takes the dense (clamping)
        path owes a violation flag on the error channel."""
        if kb is not None and allow and dense_path_selected(
                b, cols, aggs, key_bounds=kb):
            self.error_flags.append(key_bounds_violation(b, cols, kb))

    def _global_agg(self, node: AggregationNode, aggs, step):
        parts: List[Batch] = []
        for b in self.run(node.child):
            parts.append(global_aggregate(b, aggs, mode="partial")
                         if step != "final" else b)
            if len(parts) >= 64:
                parts = [global_aggregate(concat_batches(parts), aggs,
                                          mode="merge")]
        if not parts:
            # no input still finalizes to one row (count = 0)
            empty = Batch.from_arrays(
                _plan_schema(node.child), [[] for _ in node.child.fields],
                num_rows=0, device=self.device)
            parts = [empty if step == "final"
                     else global_aggregate(empty, aggs, mode="partial")]
        states = concat_batches(parts) if len(parts) > 1 else parts[0]
        if step == "partial":
            yield (global_aggregate(states, aggs, mode="merge")
                   if len(parts) > 1 else states)
        else:
            yield global_aggregate(states, aggs, mode="final")

    # -- joins ----------------------------------------------------------------
    def _JoinNode(self, node: JoinNode) -> Iterator[Batch]:
        yield from self._coalesce(self._join_once(node))

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
        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        build = self._drain(node.right)
        dyn = prep = sorted_cols = maxk = None
        if build is not None:
            summary = self._build_summary(build, rkeys)
            if node.join_type == "inner" and bool_property(
                    self.session, "enable_dynamic_filtering", True):
                dyn = self._summary_bounds(summary, lkeys)
            # compact a sparse build before sorting it
            scap = bucket_capacity(max(int(summary[0]), 1))
            if scap < build.capacity:
                build = build.compact(scap, check=False)
            prep = self._prepare_join_build(build, rkeys, summary,
                                            node.key_bounds)
            if node.build_unique and is_direct_prepared(prep):
                sorted_cols = sorted_payload(build, payload, prep)
            if not node.build_unique:
                maxk = self._build_multiplicity(prep)
        track_full = node.join_type == "full" and build is not None
        build_matched = None
        full_acc = ({"m": None} if track_full and residual_outer is not None
                    else None)
        compact = self._compactor()
        for probe in self.run(node.left):
            if build is None:
                if node.join_type != "inner":
                    yield compact(self._null_extend(probe, node))
                continue
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
                                           maxk):
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
                       maxk) -> Iterator[Batch]:
        schema = _plan_schema(node)
        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        # FULL OUTER probes like LEFT; _join_once emits the unmatched
        # build tail
        jt = "left" if node.join_type == "full" else node.join_type
        if node.build_unique:
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
            cap = probe.capacity
            reps: List[Batch] = []
            for k in range(nb):
                cols = list(probe.columns)
                for c in build.columns:
                    data = c.data[k:k + 1].expand(
                        (cap,) + tuple(c.data.shape[1:])).contiguous()
                    valid = c.validity[k:k + 1].expand(cap) & probe.row_mask
                    cols.append(Column(c.type, data, valid, c.dictionary))
                reps.append(Batch(schema, cols, probe.row_mask))
            yield concat_batches(reps) if len(reps) > 1 else reps[0]

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
            if residual is not None:
                res_maxk = self._build_multiplicity(prep)
        for b in self.run(node.source):
            if build is None:
                # an empty filtering side: NOT IN / NOT EXISTS keep every
                # row, IN / EXISTS none
                yield b if node.negated else Batch(
                    b.schema, b.columns, torch.zeros_like(b.row_mask))
                continue
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
