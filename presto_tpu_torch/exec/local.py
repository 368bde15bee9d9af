"""Local plan executor: logical plan -> streaming batch iterators on one
device.

The counterpart of ``presto_tpu/exec/local.py`` (reference
presto-main/.../sql/planner/LocalExecutionPlanner.java:357 and
operator/Driver.java): each plan node becomes a generator over device
batches, so scan->filter->project->partial-agg chains stream without
materializing, while join builds, sorts and aggregations drain their
input. Ported node kinds: output, table scan, filter, project, limit,
sort, top-n, aggregation and unique-build inner/left joins; any other
node raises NotImplementedError naming it.

Unique-build joins probe through the CUDA direct-address probe kernel
(``ops/probe.py``) whenever the build gets a direct-address table, and
through binary search over the sorted build otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..batch import Batch, Schema, bucket_capacity, concat_batches
from ..errors import STATS_BOUND_VIOLATION, QueryError
from ..expr.compiler import compile_filter, compile_projection
from ..ops.aggregation import (
    AggSpec, dense_path_selected, global_aggregate, grouped_aggregate,
)
from ..ops.join import (
    direct_keyed_plan, is_direct_prepared, lookup_join, prepare_build,
    prepare_direct, prepare_direct_keyed,
)
from ..ops.probe import lookup_join_direct, sorted_payload
from ..ops.sort import SortKey, limit as limit_kernel, sort_batch, top_n
from ..planner.plan import (
    AggregationNode, FilterNode, JoinNode, LimitNode, OutputNode, PlanNode,
    ProjectNode, SortNode, TableScanNode, TopNNode,
)
from ..planner.planner import LogicalPlan, Session, bool_property

_DYN_TYPES = (T.BigintType, T.IntegerType, T.SmallintType, T.TinyintType,
              T.DateType)


@dataclasses.dataclass
class QueryResult:
    names: List[str]
    types: List[T.Type]
    rows: List[tuple]


def execute_plan(plan: LogicalPlan, session: Session, device,
                 rows_per_batch: int = 1 << 17) -> QueryResult:
    """Run a planned query on ``device`` and decode its rows."""
    if plan.init_plans:
        raise NotImplementedError("scalar subqueries are not ported")
    ex = _Executor(session, rows_per_batch, torch.device(device))
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

    def __init__(self, session: Session, rows_per_batch: int,
                 device: torch.device):
        self.session = session
        self.rows_per_batch = rows_per_batch
        self.device = device
        # device int32 scalars from error-checking kernels; reduced to one
        # host sync by check_errors() after the plan drains
        self.error_flags: List[torch.Tensor] = []

    def check_errors(self) -> None:
        """Raise the highest-coded row error seen this query (one sync)."""
        if not self.error_flags:
            return
        code = int(torch.stack(self.error_flags).max())
        self.error_flags = []
        if code:
            raise QueryError(code)

    def run(self, node: PlanNode) -> Iterator[Batch]:
        m = getattr(self, "_" + type(node).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"{type(node).__name__} is not ported")
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
        fn = compile_filter(node.predicate, _plan_schema(node.child),
                            errors=True)
        compact = self._compactor()
        for b in self.run(node.child):
            out, err = fn(b)
            if err is not None:
                self.error_flags.append(err)
            yield compact(out)

    def _ProjectNode(self, node: ProjectNode) -> Iterator[Batch]:
        fn = compile_projection(node.exprs, [f.name for f in node.fields],
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
        allow = bool_property(self.session, "dense_grouping", True)
        kb = tuple(node.key_bounds) if node.key_bounds else None
        key_idx = list(range(len(group)))
        states: List[Batch] = []
        for b in self.run(node.child):
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
        if node.join_type not in ("inner", "left"):
            raise NotImplementedError(f"{node.join_type} joins are not ported")
        if not node.build_unique:
            raise NotImplementedError("expanding joins are not ported")
        if node.residual is not None:
            raise NotImplementedError("join residuals are not ported")
        payload = list(range(len(node.right.fields)))
        payload_names = [f"$b{i}" for i in payload]
        schema = _plan_schema(node)
        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        build = self._drain(node.right)
        if build is None:
            if node.join_type == "inner":
                return
            raise NotImplementedError("left joins against an empty build "
                                      "are not ported")
        summary = self._build_summary(build, rkeys)
        dyn = None
        if node.join_type == "inner" and bool_property(
                self.session, "enable_dynamic_filtering", True):
            dyn = self._summary_bounds(summary, lkeys)
        # compact a sparse build before sorting it
        scap = bucket_capacity(max(int(summary[0]), 1))
        if scap < build.capacity:
            build = build.compact(scap, check=False)
        prep = self._prepare_join_build(build, rkeys, summary,
                                        node.key_bounds)
        sorted_cols = (sorted_payload(build, payload, prep)
                       if is_direct_prepared(prep) else None)
        compact = self._compactor()
        for probe in self.run(node.left):
            if dyn:
                probe = _apply_dynamic_bounds(probe, dyn)
            out = self._dispatch_lookup(probe, build, lkeys, rkeys, payload,
                                        payload_names, node.join_type, prep,
                                        sorted_cols)
            yield compact(Batch(schema, out.columns, out.row_mask))

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

    def _prepare_join_build(self, build: Batch, keys, summary, key_bounds):
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
                                         _DYN_TYPES) and summary[0] > 0:
            lo, hi = int(summary[1]), int(summary[2])
            span = hi - lo + 1
            if 0 < span <= self.DIRECT_SPAN_LIMIT:
                return prepare_direct(build, keys, lo, bucket_capacity(span))
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
