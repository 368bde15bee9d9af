"""Plan fragmenter: cut an optimized plan into exchange-separated stages.

The counterpart of ``presto_tpu/planner/fragmenter.py``, in the role of
the reference's PlanFragmenter (reference
presto-main/.../sql/planner/PlanFragmenter.java:88,106 — SubPlan tree of
PlanFragments; exchange placement decided earlier by
optimizations/AddExchanges.java). Here both jobs collapse into one
bottom-up pass: each relational operator decides whether it can run
where its child runs or must cut a fragment boundary, and aggregations
split into PARTIAL (upstream, emits states) + FINAL (downstream, over a
RemoteSourceNode) exactly like AddExchanges' partial-aggregation rewrite.

Fragment partitioning handles (reference SystemPartitioningHandle):

- ``source``  — one task per split subset; the fragment contains the
  (single) TableScanNode chain,
- ``fixed``   — hash-partitioned intermediate stage, one task per worker,
- ``single``  — one task; final merges / sorts / limits / output.

Output specs (reference PartitioningScheme): ``partition(keys)``,
``broadcast``, ``single``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..expr import ir
from ..ops.aggregation import AggSpec
from ..sql.analyzer import Field
from .plan import (
    AggregationNode, DistinctNode, FilterNode, GroupIdNode, JoinNode,
    LimitNode, OutputNode, PlanAgg, PlanNode, ProjectNode,
    RemoteSourceNode, SemiJoinNode, SortNode, TableScanNode, TopNNode,
    UnionNode, ValuesNode, WindowNode,
)


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    """How a fragment's rows leave it (reference PartitioningScheme)."""

    kind: str                      # partition | broadcast | single
    keys: Tuple[int, ...] = ()     # partition key positions in output


@dataclasses.dataclass
class PlanFragment:
    id: int
    root: PlanNode
    partitioning: str              # source | fixed | single
    output: Optional[OutputSpec] = None   # None until the consumer fixes it


class FragmentedPlan:
    """Fragments in creation order; the last one is the root (single)."""

    def __init__(self, fragments: List[PlanFragment]):
        self.fragments = fragments

    @property
    def root(self) -> PlanFragment:
        return self.fragments[-1]

    def by_id(self) -> Dict[int, PlanFragment]:
        return {f.id: f for f in self.fragments}


def fragment_plan(root: PlanNode) -> FragmentedPlan:
    fr = _Fragmenter()
    node, loc = fr.visit(root)
    if loc != "single":
        node = fr.cut(node, loc, OutputSpec("single"))
    fr.fragments.append(PlanFragment(fr.next_id(), node, "single"))
    return FragmentedPlan(fr.fragments)


# -- mesh stages --------------------------------------------------------------
# The same exchange-placement pass, read as an SPMD stage recipe: on a
# device mesh a fragment is not a set of worker tasks but one shard
# program run on every mesh slot, and the fragment boundaries name the
# collectives between them (partition -> all_to_all, broadcast ->
# all_gather, single -> gather/replicated finalize). exec/distributed.py implements
# the stages inline per operator; this pass is the *selector's* view:
# whether a plan cuts cleanly into mesh stages (anything the fragmenter
# cannot place cannot run SPMD) and what the stage DAG looks like, for
# auto-routing, EXPLAIN surfaces and the profiler.

@dataclasses.dataclass(frozen=True)
class MeshStage:
    """One SPMD stage: ``kind`` is the fragment partitioning mapped to
    its mesh form (``scan-shard`` = data-parallel over splits, ``hash``
    = hash-partitioned on the owning shard, ``single`` = replicated /
    gathered finalize), ``exchange`` how its rows leave (``partition``,
    ``broadcast``, ``single`` or None for the root). ``fused`` marks a
    partition exchange the executor collapses into its consumer's
    shard program (compute + bucket-count + ship as one dispatch);
    one-shot whole-table shuffles — window, distinct, mark-distinct,
    percentile finalize — stay unfused because a tight per-round quota
    beats saving a single sync there."""

    id: int
    kind: str
    exchange: Optional[str]
    keys: Tuple[int, ...]
    ops: Tuple[str, ...]
    fused: bool = False


@dataclasses.dataclass
class MeshPlan:
    stages: List[MeshStage]
    supported: bool
    reason: str = ""


_MESH_STAGE_KIND = {"source": "scan-shard", "fixed": "hash",
                    "single": "single"}


def _stage_ops(node: PlanNode) -> Tuple[str, ...]:
    """Operator kinds inside one fragment, leaf-last, stopping at the
    RemoteSourceNodes that stand in for upstream stages."""
    out: List[str] = []

    def walk(n: PlanNode) -> None:
        if isinstance(n, RemoteSourceNode):
            return
        out.append(type(n).__name__.replace("Node", ""))
        for c in n.children:
            walk(c)

    walk(node)
    return tuple(out)


#: partition-exchange consumers whose shard program absorbs the
#: shuffle (exec/distributed.py fuses repartition into these); window /
#: distinct / mark-distinct / sort gather the whole table in one round
#: and stay on the quota-tight unfused path.
_FUSABLE_CONSUMERS = frozenset({"Aggregation", "Join", "SemiJoin"})


def _partition_consumers(fragments: List[PlanFragment]) -> Dict[int, str]:
    """Map upstream fragment id -> op name of the nearest operator above
    the RemoteSourceNode that pulls from it in the consuming fragment."""
    out: Dict[int, str] = {}

    def walk(n: PlanNode, above: str) -> None:
        name = type(n).__name__.replace("Node", "")
        if isinstance(n, RemoteSourceNode):
            for fid in n.fragment_ids:
                out[fid] = above
            return
        for c in n.children:
            walk(c, name)

    for f in fragments:
        walk(f.root, "Output")
    return out


def plan_mesh_stages(root: PlanNode) -> MeshPlan:
    """Cut a plan into mesh stages, or say why it cannot be cut. A plan
    the fragmenter cannot place (an operator with no exchange rule) has
    no SPMD form and must stay on the single-device path — the mesh
    auto-router treats ``supported=False`` as a local fallback, never
    an error."""
    try:
        fragmented = fragment_plan(root)
    except NotImplementedError as e:
        return MeshPlan([], False, str(e))
    consumers = _partition_consumers(fragmented.fragments)
    stages = [
        MeshStage(f.id, _MESH_STAGE_KIND.get(f.partitioning, "single"),
                  f.output.kind if f.output is not None else None,
                  tuple(f.output.keys) if f.output is not None else (),
                  _stage_ops(f.root),
                  fused=(f.output is not None
                         and f.output.kind == "partition"
                         and consumers.get(f.id) in _FUSABLE_CONSUMERS))
        for f in fragmented.fragments
    ]
    return MeshPlan(stages, True)


class _Fragmenter:
    def __init__(self) -> None:
        self.fragments: List[PlanFragment] = []
        self._seq = 0

    def next_id(self) -> int:
        self._seq += 1
        return self._seq - 1

    def cut(self, node: PlanNode, loc: str, output: OutputSpec,
            partitioning: Optional[str] = None) -> RemoteSourceNode:
        """Close ``node``'s fragment with the given output spec and
        return the RemoteSourceNode the consumer reads instead."""
        f = PlanFragment(self.next_id(), node,
                         partitioning or ("fixed" if loc == "fixed"
                                          else "source"),
                         output)
        self.fragments.append(f)
        return RemoteSourceNode(fragment_ids=(f.id,), fields=node.fields)

    # -- dispatch ------------------------------------------------------------
    def visit(self, node: PlanNode) -> Tuple[PlanNode, str]:
        """Returns (embedded node, location) where location says which
        partitioning the current (open) fragment needs: source / fixed /
        single / any (location-free leaves like VALUES)."""
        return getattr(self, "_" + type(node).__name__, self._default)(node)

    def _default(self, node: PlanNode):
        raise NotImplementedError(
            f"cannot fragment {type(node).__name__}")

    # -- leaves --------------------------------------------------------------
    def _TableScanNode(self, node: TableScanNode):
        return node, "source"

    def _ValuesNode(self, node: ValuesNode):
        return node, "any"

    # -- elementwise: stay in the child's fragment ---------------------------
    def _FilterNode(self, node: FilterNode):
        child, loc = self.visit(node.child)
        return dataclasses.replace(node, child=child), loc

    def _ProjectNode(self, node: ProjectNode):
        child, loc = self.visit(node.child)
        return dataclasses.replace(node, child=child), loc

    def _GroupIdNode(self, node: GroupIdNode):
        child, loc = self.visit(node.child)
        return dataclasses.replace(node, child=child), loc

    def _OutputNode(self, node: OutputNode):
        child, loc = self.visit(node.child)
        if loc not in ("single", "any"):
            child = self.cut(child, loc, OutputSpec("single"))
            loc = "single"
        return dataclasses.replace(node, child=child), "single"

    # -- aggregation: PARTIAL upstream + FINAL after the exchange ------------
    def _AggregationNode(self, node: AggregationNode):
        child, loc = self.visit(node.child)
        if loc in ("single", "any"):
            return dataclasses.replace(node, child=child), loc
        if node.step == "partial":
            # already split by the optimizer (partial-agg pushed through a
            # join): states merge downstream, leave it in place
            return dataclasses.replace(node, child=child), loc
        if node.step == "final":
            # pre-split final: hash-exchange the states by group key and
            # finalize in a fixed stage (global finals gather to one task)
            if node.group_indices:
                src = self.cut(child, loc,
                               OutputSpec("partition",
                                          tuple(node.group_indices)))
                return dataclasses.replace(node, child=src), "fixed"
            src = self.cut(child, loc, OutputSpec("single"))
            return dataclasses.replace(node, child=src), "single"
        from ..ops.aggregation import percentile_drains
        if percentile_drains(node.aggs, [f.type for f in child.fields],
                             bool(node.group_indices)):
            if node.group_indices:
                # grouped approx_percentile: colocate each group's raw
                # rows by key hash and run the exact single-step
                # aggregation per task — parallel across tasks, unlike
                # the reference's mergeable-sketch route but with the
                # same exchange shape (partition by group keys)
                src = self.cut(child, loc,
                               OutputSpec("partition",
                                          tuple(node.group_indices)))
                return dataclasses.replace(node, child=src), "fixed"
            # global string percentile: exact pass needs all rows in one
            # task (dictionary ranks are batch-local)
            src = self.cut(child, loc, OutputSpec("single"))
            return dataclasses.replace(node, child=src), "single"
        keys = list(node.group_indices)
        partial_fields = _agg_state_fields(node)
        partial = dataclasses.replace(
            node, child=child, step="partial", fields=partial_fields)
        if keys:
            src = self.cut(partial, loc,
                           OutputSpec("partition",
                                      tuple(range(len(keys)))))
            final = dataclasses.replace(
                node, child=src, step="final",
                group_indices=tuple(range(len(keys))))
            return final, "fixed"
        src = self.cut(partial, loc, OutputSpec("single"))
        final = dataclasses.replace(node, child=src, step="final")
        return final, "single"

    def _DistinctNode(self, node: DistinctNode):
        child, loc = self.visit(node.child)
        if loc in ("single", "any"):
            return dataclasses.replace(node, child=child), loc
        cols = tuple(range(len(node.fields)))
        partial = AggregationNode(child=child, group_indices=cols,
                                  aggs=(), fields=node.fields,
                                  step="partial",
                                  key_bounds=node.key_bounds)
        src = self.cut(partial, loc, OutputSpec("partition", cols))
        final = dataclasses.replace(node, child=src)
        return final, "fixed"

    # -- joins ---------------------------------------------------------------
    def _JoinNode(self, node: JoinNode):
        left, lloc = self.visit(node.left)
        right, rloc = self.visit(node.right)
        if lloc in ("single", "any") and rloc in ("single", "any"):
            return dataclasses.replace(node, left=left, right=right), \
                ("single" if "single" in (lloc, rloc) else "any")
        if node.distribution == "replicated" or node.join_type == "cross":
            # build side broadcast to every probe task; probe stays put
            if rloc not in ("any",):
                right = self.cut(right, rloc, OutputSpec("broadcast"))
            if lloc == "any":
                lloc = "single"
            return dataclasses.replace(node, left=left, right=right), lloc
        # partitioned: hash both sides by join keys into a fixed stage
        left = self.cut(left, lloc if lloc != "any" else "single",
                        OutputSpec("partition", tuple(node.left_keys)))
        right = self.cut(right, rloc if rloc != "any" else "single",
                         OutputSpec("partition", tuple(node.right_keys)))
        return dataclasses.replace(node, left=left, right=right), "fixed"

    def _SemiJoinNode(self, node: SemiJoinNode):
        source, sloc = self.visit(node.source)
        filtering, floc = self.visit(node.filtering)
        if sloc in ("single", "any") and floc in ("single", "any"):
            return dataclasses.replace(node, source=source,
                                       filtering=filtering), \
                ("single" if "single" in (sloc, floc) else "any")
        if node.distribution == "partitioned" \
                and not (node.negated and node.null_aware):
            # stats said the filtering set is too large to broadcast
            # (optimizer._attach_join_strategy): hash BOTH sides by key
            # into a fixed stage — matching keys colocate, so the
            # per-partition membership verdicts compose exactly.
            # NULL-aware anti joins never take this branch (their
            # build_has_null / build_empty facts are global).
            source = self.cut(source, sloc if sloc != "any" else "single",
                              OutputSpec("partition",
                                         tuple(node.source_keys)))
            filtering = self.cut(
                filtering, floc if floc != "any" else "single",
                OutputSpec("partition", tuple(node.filtering_keys)))
            return dataclasses.replace(node, source=source,
                                       filtering=filtering), "fixed"
        # the filtering set broadcasts: every source task needs every key
        # (and NULL-aware anti semantics need global NULL knowledge)
        if floc != "any":
            filtering = self.cut(filtering, floc, OutputSpec("broadcast"))
        if sloc == "any":
            sloc = "single"
        return dataclasses.replace(node, source=source,
                                   filtering=filtering), sloc

    # -- order/limit: partial upstream, merge in a single stage --------------
    def _SortNode(self, node: SortNode):
        child, loc = self.visit(node.child)
        if loc in ("single", "any"):
            return dataclasses.replace(node, child=child), loc
        partial = dataclasses.replace(node, child=child)
        src = self.cut(partial, loc, OutputSpec("single"))
        return dataclasses.replace(node, child=src), "single"

    def _TopNNode(self, node: TopNNode):
        child, loc = self.visit(node.child)
        if loc in ("single", "any"):
            return dataclasses.replace(node, child=child), loc
        partial = dataclasses.replace(node, child=child)
        src = self.cut(partial, loc, OutputSpec("single"))
        return dataclasses.replace(node, child=src), "single"

    def _LimitNode(self, node: LimitNode):
        child, loc = self.visit(node.child)
        if loc in ("single", "any"):
            return dataclasses.replace(node, child=child), loc
        partial = dataclasses.replace(node, child=child)
        src = self.cut(partial, loc, OutputSpec("single"))
        return dataclasses.replace(node, child=src), "single"

    def _MarkDistinctNode(self, node):
        """First-occurrence flags need all rows of a group in one task:
        partition by the group keys (or gather when there are none)."""
        child, loc = self.visit(node.child)
        if loc in ("single", "any"):
            return dataclasses.replace(node, child=child), loc
        if node.partition_cols:
            src = self.cut(child, loc,
                           OutputSpec("partition",
                                      tuple(node.partition_cols)))
            return dataclasses.replace(node, child=src), "fixed"
        src = self.cut(child, loc, OutputSpec("single"))
        return dataclasses.replace(node, child=src), "single"

    def _UnnestNode(self, node):
        # row-local expansion: runs wherever its child runs
        child, loc = self.visit(node.child)
        return dataclasses.replace(node, child=child), loc

    def _WindowNode(self, node: WindowNode):
        child, loc = self.visit(node.child)
        if loc in ("single", "any"):
            return dataclasses.replace(node, child=child), loc
        if node.partition_indices:
            src = self.cut(child, loc,
                           OutputSpec("partition",
                                      tuple(node.partition_indices)))
            return dataclasses.replace(node, child=src), "fixed"
        src = self.cut(child, loc, OutputSpec("single"))
        return dataclasses.replace(node, child=src), "single"

    def _UnionNode(self, node: UnionNode):
        ids: List[int] = []
        embedded: List[PlanNode] = []
        locs: List[str] = []
        for c in node.children:
            n, loc = self.visit(c)
            embedded.append(n)
            locs.append(loc)
        if all(l in ("single", "any") for l in locs):
            return node.with_children(embedded), \
                ("single" if "single" in locs else "any")
        for n, loc in zip(embedded, locs):
            src = self.cut(n, loc if loc != "any" else "single",
                           OutputSpec("single"))
            ids.extend(src.fragment_ids)
        return RemoteSourceNode(fragment_ids=tuple(ids),
                                fields=node.fields), "single"


def _agg_state_fields(node: AggregationNode) -> Tuple[Field, ...]:
    """Output schema of the PARTIAL step: group keys + state columns."""
    child = node.child
    fields: List[Field] = [child.fields[i] for i in node.group_indices]
    for a in node.aggs:
        spec = AggSpec(a.fn, a.arg, a.output_type, a.name)
        fields.extend(Field(n, t) for n, t in spec.state_types())
    return tuple(fields)
