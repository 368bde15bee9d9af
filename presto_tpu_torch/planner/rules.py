"""Iterative rule engine: memo + pattern DSL + the load-bearing rewrite
rules.

Conceptual parity with the reference's exploratory optimizer (reference
sql/planner/iterative/IterativeOptimizer.java, Memo.java, Rule.java,
pattern DSL presto-matching/.../matching/Pattern.java, rule catalog
sql/planner/iterative/rule/ — each rule below names the file it ports
the concept of). The memo stores one group per plan position; rules fire
over groups to a fixpoint with an exploration budget, so rewrites
compose across levels without manual pass ordering — the property the
round-2 fixed pipeline could not express.

Rules here are the simplify/merge/push family; field order of every
rewritten node is preserved, so parent expressions never need remapping.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from ..expr import ir
from ..expr.rewrite import (
    combine_conjuncts, conjuncts, referenced_inputs, remap_inputs,
)
from .plan import (
    DistinctNode, FilterNode, LimitNode, PlanNode, ProjectNode, SortNode,
    TopNNode, UnionNode, ValuesNode,
)

MAX_ITERATIONS = 100


# -- pattern DSL (the presto-matching role) ---------------------------------

@dataclasses.dataclass(frozen=True)
class Pattern:
    """Structural matcher: node class + optional predicate + child
    patterns (by position for single-child chains)."""

    node_type: type
    where: Optional[Callable[[PlanNode], bool]] = None
    child: Optional["Pattern"] = None

    def matches(self, node: PlanNode) -> bool:
        if not isinstance(node, self.node_type):
            return False
        if self.where is not None and not self.where(node):
            return False
        if self.child is not None:
            kids = node.children
            if len(kids) != 1 or not self.child.matches(kids[0]):
                return False
        return True


def pattern(node_type: type, *, where=None, child: Optional[Pattern] = None
            ) -> Pattern:
    return Pattern(node_type, where, child)


class Rule:
    """One rewrite (reference iterative/Rule.java): fires when ``pattern``
    matches; ``apply`` returns the replacement or None to decline."""

    pattern: Pattern

    def apply(self, node: PlanNode, lookup) -> Optional[PlanNode]:
        """``lookup`` resolves a _GroupRef child to its current node
        (reference iterative/Lookup.java)."""
        raise NotImplementedError


# -- memo -------------------------------------------------------------------

class Memo:
    """Group table (reference iterative/Memo.java): each plan position
    becomes a group holding its current best expression; rewrites replace
    group contents without touching parents (children are referenced by
    group id)."""

    def __init__(self, root: PlanNode):
        self._groups: Dict[int, PlanNode] = {}
        self._next = itertools.count()
        self.root_group = self._insert(root)

    def _insert(self, node: PlanNode) -> int:
        if isinstance(node, _GroupRef):
            return node.gid
        gid = next(self._next)
        kids = tuple(self._insert(c) for c in node.children)
        self._groups[gid] = _GroupRef.strip(node, kids)
        return gid

    def node(self, gid: int) -> PlanNode:
        return self._groups[gid]

    def replace(self, gid: int, node: PlanNode) -> None:
        """Replace a group's expression; new children become new groups."""
        kids = tuple(self._insert(c) if not isinstance(c, _GroupRef)
                     else c.gid for c in node.children)
        self._groups[gid] = _GroupRef.strip(node, kids)

    def extract(self, gid: Optional[int] = None) -> PlanNode:
        node = self._groups[self.root_group if gid is None else gid]
        return self._resolve(node)

    def _resolve(self, node: PlanNode) -> PlanNode:
        kids = [self._resolve(self._groups[c.gid])
                if isinstance(c, _GroupRef) else self._resolve(c)
                for c in node.children]
        return node.with_children(kids) if kids else node

    def groups(self) -> List[int]:
        return list(self._groups)


@dataclasses.dataclass(frozen=True)
class _GroupRef(PlanNode):
    """Leaf standing for a memo group (reference iterative/GroupReference
    .java)."""

    gid: int = -1
    fields: Tuple = ()

    @property
    def children(self) -> Tuple[PlanNode, ...]:
        return ()

    @staticmethod
    def strip(node: PlanNode, kid_gids: Tuple[int, ...]) -> PlanNode:
        if not node.children:
            return node
        refs = [_GroupRef(gid=g, fields=c.fields)
                for g, c in zip(kid_gids, node.children)]
        return node.with_children(refs)


class IterativeOptimizer:
    """Fixpoint loop (reference IterativeOptimizer.java:exploreGroup):
    resolve each group one level deep, offer it to every matching rule,
    and loop until no rule fires or the budget runs out."""

    def __init__(self, rules: Sequence[Rule]):
        self.rules = list(rules)

    def run(self, root: PlanNode) -> PlanNode:
        memo = Memo(root)
        for _ in range(MAX_ITERATIONS):
            fired = False
            for gid in memo.groups():
                node = memo.node(gid)
                if isinstance(node, _GroupRef):
                    continue
                # rules see children one level deep (resolved)
                shallow = node.with_children([
                    memo.node(c.gid) if isinstance(c, _GroupRef) else c
                    for c in node.children]) if node.children else node
                def lookup(n: PlanNode) -> PlanNode:
                    return (memo.node(n.gid)
                            if isinstance(n, _GroupRef) else n)

                for rule in self.rules:
                    if not rule.pattern.matches(shallow):
                        continue
                    out = rule.apply(shallow, lookup)
                    if out is not None and out is not shallow:
                        memo.replace(gid, out)
                        fired = True
                        break
            if not fired:
                break
        return memo.extract()


# -- rule catalog -----------------------------------------------------------

def _empty(fields) -> ValuesNode:
    return ValuesNode(fields=tuple(fields), rows=())


class MergeLimits(Rule):
    """Limit(a, Limit(b, x)) -> Limit(min(a,b), x) (reference
    iterative/rule/MergeLimits.java)."""

    pattern = pattern(LimitNode, child=pattern(LimitNode))

    def apply(self, node: LimitNode, lookup):
        inner: LimitNode = node.child
        return LimitNode(child=inner.child,
                         count=min(node.count, inner.count),
                         fields=node.fields)


class MergeLimitWithSort(Rule):
    """Limit(n, Sort(x)) -> TopN(n, x) (reference
    iterative/rule/MergeLimitWithSort.java)."""

    pattern = pattern(LimitNode, child=pattern(SortNode))

    def apply(self, node: LimitNode, lookup):
        inner: SortNode = node.child
        return TopNNode(child=inner.child, keys=inner.keys,
                        count=node.count, fields=node.fields)


class MergeLimitWithTopN(Rule):
    """Limit(a, TopN(b, x)) -> TopN(min(a,b), x) (reference
    iterative/rule/MergeLimitWithTopN.java)."""

    pattern = pattern(LimitNode, child=pattern(TopNNode))

    def apply(self, node: LimitNode, lookup):
        inner: TopNNode = node.child
        return TopNNode(child=inner.child, keys=inner.keys,
                        count=min(node.count, inner.count),
                        fields=node.fields)


class MergeLimitOverDistinct(Rule):
    """Limit(Distinct(Limit? ...)) stays; but Distinct(Distinct(x)) ->
    Distinct(x) (reference iterative/rule/RemoveRedundantDistinct
    shape)."""

    pattern = pattern(DistinctNode, child=pattern(DistinctNode))

    def apply(self, node: DistinctNode, lookup):
        return DistinctNode(child=node.child.child, fields=node.fields)


class EvaluateZeroLimit(Rule):
    """Limit(0, x) -> empty Values (reference
    iterative/rule/EvaluateEmptyIntersect / RemoveRedundant* family)."""

    pattern = pattern(LimitNode, where=lambda n: n.count == 0)

    def apply(self, node: LimitNode, lookup):
        return _empty(node.fields)


class EvaluateZeroTopN(Rule):
    pattern = pattern(TopNNode, where=lambda n: n.count == 0)

    def apply(self, node: TopNNode, lookup):
        return _empty(node.fields)


class MergeFilters(Rule):
    """Filter(p, Filter(q, x)) -> Filter(p AND q, x) (reference
    iterative/rule/MergeFilters.java)."""

    pattern = pattern(FilterNode, child=pattern(FilterNode))

    def apply(self, node: FilterNode, lookup):
        inner: FilterNode = node.child
        return FilterNode(
            child=inner.child,
            predicate=combine_conjuncts(
                conjuncts(inner.predicate) + conjuncts(node.predicate)),
            fields=node.fields)


def _is_true(e: ir.Expr) -> bool:
    return isinstance(e, ir.Literal) and e.value is True


def _is_false_or_null(e: ir.Expr) -> bool:
    return isinstance(e, ir.Literal) and (e.value is False
                                          or e.value is None)


class RemoveTrivialFilters(Rule):
    """Filter(true, x) -> x; Filter(false|null, x) -> empty (reference
    iterative/rule/RemoveTrivialFilters.java)."""

    pattern = pattern(FilterNode,
                      where=lambda n: _is_true(n.predicate)
                      or _is_false_or_null(n.predicate))

    def apply(self, node: FilterNode, lookup):
        if _is_true(node.predicate):
            return node.child
        return _empty(node.fields)


class PushLimitThroughProject(Rule):
    """Limit(Project(x)) -> Project(Limit(x)) (reference
    iterative/rule/PushLimitThroughProject.java)."""

    pattern = pattern(LimitNode, child=pattern(ProjectNode))

    def apply(self, node: LimitNode, lookup):
        proj: ProjectNode = node.child
        return ProjectNode(
            child=LimitNode(child=proj.child, count=node.count),
            exprs=proj.exprs, fields=proj.fields)


class PushLimitThroughUnion(Rule):
    """Limit(n, Union(a, b)) -> Limit(n, Union(Limit(n,a), Limit(n,b)))
    (reference iterative/rule/PushLimitThroughUnion.java). Guarded so it
    fires once (children not already limits)."""

    pattern = pattern(
        LimitNode,
        child=pattern(UnionNode, where=lambda u: not u.distinct))

    def apply(self, node: LimitNode, lookup):
        union: UnionNode = node.child
        resolved = [lookup(c) for c in union.children]
        if all(isinstance(rc, LimitNode) and rc.count <= node.count
               for rc in resolved):
            return None
        limited = tuple(
            c if isinstance(rc, LimitNode) and rc.count <= node.count
            else LimitNode(child=c, count=node.count)
            for c, rc in zip(union.children, resolved))
        return LimitNode(
            child=dataclasses.replace(union, children_=limited),
            count=node.count, fields=node.fields)


class LimitOverValues(Rule):
    """Limit(n, Values) -> Values[:n] (reference
    iterative/rule/EvaluateLimitOverValues shape)."""

    pattern = pattern(LimitNode, child=pattern(ValuesNode))

    def apply(self, node: LimitNode, lookup):
        vals: ValuesNode = node.child
        if len(vals.rows) <= node.count:
            return vals
        return ValuesNode(fields=vals.fields,
                          rows=vals.rows[:node.count])


def _identity_projection(node: ProjectNode) -> bool:
    if len(node.exprs) != len(node.child.fields):
        return False
    for i, e in enumerate(node.exprs):
        if not isinstance(e, ir.InputRef) or e.index != i:
            return False
        if node.fields[i].name != node.child.fields[i].name:
            return False
    return True


class RemoveRedundantIdentityProjection(Rule):
    """Project(identity, x) -> x (reference
    iterative/rule/RemoveRedundantIdentityProjections.java)."""

    pattern = pattern(ProjectNode, where=_identity_projection)

    def apply(self, node: ProjectNode, lookup):
        return node.child


def _inline_into(outer: ir.Expr, inner: Sequence[ir.Expr]) -> ir.Expr:
    from ..expr.rewrite import rewrite

    def repl(e: ir.Expr):
        if isinstance(e, ir.InputRef):
            return inner[e.index]
        return e

    return rewrite(outer, repl)


class InlineProjections(Rule):
    """Project(Project(x)) -> Project(x) when the inner exprs are cheap
    to inline (input refs / literals, or referenced once) (reference
    iterative/rule/InlineProjections.java)."""

    pattern = pattern(ProjectNode, child=pattern(ProjectNode))

    def apply(self, node: ProjectNode, lookup):
        inner: ProjectNode = node.child
        uses: Dict[int, int] = {}
        for e in node.exprs:
            for r in referenced_inputs(e):
                uses[r] = uses.get(r, 0) + 1
        for i, e in enumerate(inner.exprs):
            simple = isinstance(e, (ir.InputRef, ir.Literal))
            if not simple and uses.get(i, 0) > 1:
                return None          # would duplicate computation
        exprs = tuple(_inline_into(e, inner.exprs) for e in node.exprs)
        return ProjectNode(child=inner.child, exprs=exprs,
                           fields=node.fields)


class PushFilterThroughProject(Rule):
    """Filter(Project(x)) -> Project(Filter(x)) when the predicate
    rewrites through the projection (reference the PredicatePushDown
    visitor's project case; iterative/rule shape
    PushDownFilterThroughProject)."""

    pattern = pattern(FilterNode, child=pattern(ProjectNode))

    def apply(self, node: FilterNode, lookup):
        proj: ProjectNode = node.child
        # cost guard (same stance as InlineProjections): only push when
        # every projection expr the predicate references is trivial —
        # otherwise the expression would be evaluated twice
        for r in referenced_inputs(node.predicate):
            if not isinstance(proj.exprs[r], (ir.InputRef, ir.Literal)):
                return None
        pred = _inline_into(node.predicate, proj.exprs)
        return ProjectNode(
            child=FilterNode(child=proj.child, predicate=pred),
            exprs=proj.exprs, fields=proj.fields)


DEFAULT_RULES: Tuple[Rule, ...] = (
    MergeLimits(),
    MergeLimitWithSort(),
    MergeLimitWithTopN(),
    MergeLimitOverDistinct(),
    EvaluateZeroLimit(),
    EvaluateZeroTopN(),
    MergeFilters(),
    RemoveTrivialFilters(),
    PushLimitThroughProject(),
    PushLimitThroughUnion(),
    LimitOverValues(),
    RemoveRedundantIdentityProjection(),
    InlineProjections(),
    PushFilterThroughProject(),
)


def iterative_optimize(root: PlanNode,
                       rules: Sequence[Rule] = DEFAULT_RULES) -> PlanNode:
    return IterativeOptimizer(rules).run(root)
