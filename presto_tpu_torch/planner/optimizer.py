"""Plan optimizer: the load-bearing visitor passes.

Conceptual parity with the reference's optimizer pipeline (reference
presto-main/.../sql/planner/PlanOptimizers.java:252-412). Round-1 passes:

1. join graph construction — flattens cross-join trees + filters into
   relations/conjuncts, pushes single-relation predicates down, orders
   equi-joins greedily by estimated size (reference EliminateCrossJoins.java,
   PredicatePushDown.java, ReorderJoins.java collapsed into one pass over
   the positional plan);
2. column pruning — scans read only referenced columns (reference the 18
   Prune*.java rules + PushProjectionIntoTableScan);
3. join implementation — picks build side (unique-key side, smaller on
   ties) and distribution (replicated when the build side is small),
   reference DetermineJoinDistributionType.java.

Passes keep output field order stable by appending restoring projections,
so parent expressions never need rewriting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import types as T
from ..expr import ir
from ..expr.rewrite import (
    combine_conjuncts, conjuncts, referenced_inputs, remap_inputs,
)
from ..sql.analyzer import Field
from .fragmenter import _agg_state_fields
from .plan import (
    AggregationNode, DistinctNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanNode, ProjectNode, SemiJoinNode, SortNode,
    TableScanNode, TopNNode, UnionNode, ValuesNode,
)
from .planner import LogicalPlan, Session, bool_property

BROADCAST_ROW_LIMIT = 2_000_000


def optimize(plan: LogicalPlan, session: Session) -> LogicalPlan:
    from .rules import iterative_optimize
    from .stats import StatsCalculator

    def pipeline(node: PlanNode) -> PlanNode:
        # iterative simplify/merge/push rules to a fixpoint (reference
        # IterativeOptimizer over the rule catalog), then the structural
        # visitor passes (reference PlanOptimizers.java:252-412 ordering)
        node = iterative_optimize(node)
        node = _rewrite_joins(node, session)
        node, _ = _prune(node, list(range(len(node.fields))))
        node = _implement_joins(node, session)
        if bool_property(session, "push_partial_aggregation_through_join",
                         True):
            node = _push_partial_agg_through_join(node, session)
        if bool_property(session, "stats_bounded_grouping", True):
            node = _attach_group_bounds(node, session)
        node = _attach_join_strategy(
            node, session,
            dense=bool_property(session, "join_dense_path", True))
        return _attach_scan_pushdown(node)
    # one memoized StatsCalculator for the whole pass: join ordering,
    # distribution choice, and the eager-agg gate all estimate the same
    # subtrees, and connector table_stats can be full-scan priced
    # (sqlite) — per-call calculators would re-derive everything
    token = _PASS_CALC.set(StatsCalculator(session))
    try:
        root = pipeline(plan.root)
        init = [pipeline(p) for p in plan.init_plans]
    finally:
        _PASS_CALC.reset(token)
    return LogicalPlan(root, init)


# ---------------------------------------------------------------------------
# Scan pushdown: advisory min/max bounds for connector pruning
# ---------------------------------------------------------------------------

_BOUNDABLE = (T.BigintType, T.IntegerType, T.SmallintType, T.TinyintType,
              T.DateType)


def _attach_scan_pushdown(node: PlanNode) -> PlanNode:
    """Filter directly over a scan: extract per-column [lo, hi] integer
    bounds from its conjuncts and attach them to the scan (the
    TupleDomain-lite handoff of reference
    sql/planner/iterative/rule/PushPredicateIntoTableScan.java +
    spi/predicate/TupleDomain.java). The filter stays — the bounds only
    let connectors prune files/stripes on statistics."""
    if (isinstance(node, FilterNode)
            and isinstance(node.child, TableScanNode)):
        bounds = _extract_bounds(node.predicate, node.child)
        if bounds:
            return dataclasses.replace(
                node, child=dataclasses.replace(node.child,
                                                pushdown=bounds))
        return node
    return node.with_children([_attach_scan_pushdown(c)
                               for c in node.children])


def _extract_bounds(pred: ir.Expr,
                    scan: TableScanNode
                    ) -> Tuple[Tuple[str, Optional[int], Optional[int]], ...]:
    INF = (1 << 62)
    bounds: Dict[str, List[int]] = {}

    def note(idx: int, lo, hi) -> None:
        t = scan.fields[idx].type
        if not isinstance(t, _BOUNDABLE):
            return
        name = scan.columns[idx]
        b = bounds.setdefault(name, [-INF, INF])
        b[0] = max(b[0], lo if lo is not None else -INF)
        b[1] = min(b[1], hi if hi is not None else INF)

    def ref_of(e: ir.Expr):
        if isinstance(e, ir.Cast):
            e = e.arg
        return e.index if isinstance(e, ir.InputRef) else None

    def lit_of(e: ir.Expr, allow_param: bool = False):
        """(storage int, param-or-None) for a boundable constant; param
        is the ir.Param the value came from (plan templates). Params
        are only consultable for RANGE comparisons: baking a bound from
        them records a value-equality reuse guard (expr/params.consult)
        — acceptable for fleet-constant range windows, but an eq bound
        on the fleet's VARYING slot (user_id = ?) would turn every
        binding into a guard fallback, so eq never consults."""
        if isinstance(e, ir.Cast):
            e = e.arg
        # only literals whose own domain is integer-like convert safely:
        # a decimal/double literal's storage (unscaled / float) is NOT in
        # the column's integer domain, and a wrong bound silently prunes
        # live data
        if (isinstance(e, ir.Literal) and e.value is not None
                and isinstance(e.type, _BOUNDABLE)):
            try:
                return int(e.type.to_storage(e.value)), None
            except (TypeError, ValueError):
                return None, None
        if (allow_param and isinstance(e, ir.Param)
                and e.bound is not None
                and isinstance(e.type, _BOUNDABLE)):
            try:
                return int(e.type.to_storage(e.bound)), e
            except (TypeError, ValueError):
                return None, None
        return None, None

    def guarded(idx: int, *ps) -> bool:
        """Record consultation guards for the params feeding a bound —
        only when the bound will actually attach (boundable column)."""
        if not isinstance(scan.fields[idx].type, _BOUNDABLE):
            return False
        from ..expr import params as _params
        for p in ps:
            if p is not None:
                _params.consult(p)
        return True

    for c in conjuncts(pred):
        if isinstance(c, ir.SpecialForm) and c.form == ir.Form.BETWEEN:
            i = ref_of(c.args[0])
            (lo, plo), (hi, phi) = (lit_of(c.args[1], True),
                                    lit_of(c.args[2], True))
            if i is not None and lo is not None and hi is not None \
                    and guarded(i, plo, phi):
                note(i, lo, hi)
            continue
        if not isinstance(c, ir.Call) or len(c.args) != 2:
            continue
        op = c.name
        range_op = op in ("lt", "le", "gt", "ge")
        a, b = c.args
        ia, ib = ref_of(a), ref_of(b)
        la, pa = lit_of(a, range_op)
        lb, pb = lit_of(b, range_op)
        if ia is not None and lb is not None:
            idx, v, p = ia, lb, pb
        elif ib is not None and la is not None:
            # flip the comparison: lit OP col == col FLIP(op) lit
            idx, v, p = ib, la, pa
            op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                  "eq": "eq"}.get(op, "")
        else:
            continue
        if op == "eq":
            if guarded(idx, p):
                note(idx, v, v)
        elif op in ("lt", "le"):
            if guarded(idx, p):
                note(idx, None, v)
        elif op in ("gt", "ge"):
            if guarded(idx, p):
                note(idx, v, None)
    # unbounded sides stay None: a finite sentinel would be compared
    # against real column statistics and could prune live data
    return tuple((n, lo if lo > -INF else None, hi if hi < INF else None)
                 for n, (lo, hi) in sorted(bounds.items())
                 if lo > -INF or hi < INF)


# ---------------------------------------------------------------------------
# Pass 1: join graph (cross-join elimination + predicate pushdown + ordering)
# ---------------------------------------------------------------------------

def _rewrite_joins(node: PlanNode, session: Session) -> PlanNode:
    # top-down: a filter directly above a join tree contributes its
    # conjuncts to the join graph BEFORE the tree is reordered; leaves of
    # the graph are rewritten recursively inside _plan_join_graph
    if (isinstance(node, FilterNode) and isinstance(node.child, JoinNode)
            and node.child.join_type in ("cross", "inner")):
        return _plan_join_graph(node.child, [node.predicate], session)
    if (isinstance(node, FilterNode) and isinstance(node.child, JoinNode)
            and node.child.join_type == "left"):
        # WHERE conjuncts that touch only the probe side of a LEFT JOIN
        # push below it (they cannot change match semantics; reference
        # optimizations/PredicatePushDown.java outer-join handling), which
        # lets the probe side's own join graph form.
        j = node.child
        n_left = len(j.left.fields)
        push, keep = [], []
        for c in conjuncts(node.predicate):
            refs = referenced_inputs(c)
            if refs and all(r < n_left for r in refs):
                push.append(c)
            else:
                keep.append(c)
        if push:
            j = dataclasses.replace(
                j, left=FilterNode(child=j.left,
                                   predicate=combine_conjuncts(push)))
            rebuilt: PlanNode = j
            if keep:
                rebuilt = FilterNode(child=j,
                                     predicate=combine_conjuncts(keep))
            return _rewrite_joins(rebuilt, session)
    if isinstance(node, JoinNode) and node.join_type in ("cross", "inner"):
        return _plan_join_graph(node, [], session)
    return node.with_children([_rewrite_joins(c, session)
                               for c in node.children])


def _flatten_join_tree(node: PlanNode, leaves: List[PlanNode],
                       preds: List[ir.Expr], offset: int) -> None:
    """Collect leaves + predicates of an inner/cross join tree.

    Positions: the tree's output = concatenation of leaf fields in visit
    order, so conjuncts lifted from ON clauses keep their global indices.
    """
    if isinstance(node, JoinNode) and node.join_type in ("cross", "inner"):
        _flatten_join_tree(node.left, leaves, preds, offset)
        right_off = offset + len(node.left.fields)
        _flatten_join_tree(node.right, leaves, preds, right_off)
        n_left = len(node.left.fields)
        for lk, rk in zip(node.left_keys, node.right_keys):
            lt = node.left.fields[lk].type
            rt = node.right.fields[rk].type
            t = T.common_super_type(lt, rt) or lt
            preds.append(ir.call(
                "eq", T.BOOLEAN,
                _coerce_ref(offset + lk, lt, t),
                _coerce_ref(right_off + rk, rt, t)))
        if node.residual is not None:
            shift = {i: offset + i for i in
                     range(len(node.left.fields) + len(node.right.fields))}
            preds.append(remap_inputs(node.residual, shift))
        return
    if isinstance(node, FilterNode):
        # filter inside the join tree: lift its conjuncts
        _flatten_join_tree(node.child, leaves, preds, offset)
        shift = {i: offset + i for i in range(len(node.child.fields))}
        preds.append(remap_inputs(node.predicate, shift))
        return
    leaves.append(node)


def _factor_or(p: ir.Expr) -> ir.Expr:
    """Factor conjuncts common to every OR disjunct out of the OR:
    (a AND x) OR (a AND y) -> a AND (x OR y). Exposes join keys hidden
    inside disjunctions — TPC-H Q19's shape (reference sql/
    ExpressionUtils + ExtractCommonPredicatesExpressionRewriter)."""
    if not (isinstance(p, ir.SpecialForm) and p.form == ir.Form.OR):
        return p
    disjunct_conjs = [list(conjuncts(d)) for d in p.args]
    common = [c for c in disjunct_conjs[0]
              if all(c in dc for dc in disjunct_conjs[1:])]
    if not common:
        return p
    rest = []
    for dc in disjunct_conjs:
        left = [c for c in dc if c not in common]
        rest.append(combine_conjuncts(left) or ir.lit(True, T.BOOLEAN))
    new_or = rest[0] if len(rest) == 1 else ir.special(
        ir.Form.OR, T.BOOLEAN, *rest)
    return combine_conjuncts(common + [new_or])


def _coerce_ref(idx: int, t: T.Type, to: T.Type) -> ir.Expr:
    r = ir.input_ref(idx, t)
    return r if t == to else ir.cast(r, to)


import contextvars

#: the optimization pass's shared StatsCalculator (set by optimize());
#: estimates outside a pass fall back to a throwaway calculator
_PASS_CALC: contextvars.ContextVar = contextvars.ContextVar(
    "presto_tpu_stats_calc", default=None)


def _stats_calc(session: Session):
    calc = _PASS_CALC.get()
    if calc is not None and calc.session is session:
        return calc
    from .stats import StatsCalculator
    return StatsCalculator(session)


def _estimate_rows(node: PlanNode, session: Session) -> float:
    """Row estimate via the stats calculus (planner/stats.py): scan
    statistics propagated through filter selectivities (range/NDV math),
    join containment, and group NDV products — the reference's
    cost/StatsCalculator.java role. Memoized across the optimization
    pass via _PASS_CALC."""
    return _stats_calc(session).rows(node)


def _plan_join_graph(join: JoinNode, extra_preds: List[ir.Expr],
                     session: Session) -> PlanNode:
    leaves: List[PlanNode] = []
    preds: List[ir.Expr] = []
    _flatten_join_tree(join, leaves, preds, 0)
    leaves = [_rewrite_joins(lf, session) for lf in leaves]
    for p in extra_preds:
        preds.extend(conjuncts(p))
    preds = [c for p in preds for c in conjuncts(_factor_or(p))]

    # global position ranges per leaf
    offsets: List[int] = []
    off = 0
    for lf in leaves:
        offsets.append(off)
        off += len(lf.fields)
    total = off

    def leaf_of(pos: int) -> int:
        for i in range(len(leaves) - 1, -1, -1):
            if pos >= offsets[i]:
                return i
        raise AssertionError

    # push single-leaf predicates into the leaf
    leaf_preds: Dict[int, List[ir.Expr]] = {i: [] for i in range(len(leaves))}
    edges: List[Tuple[int, int, ir.Expr, ir.Expr]] = []  # (li, lj, lref, rref)
    multi: List[ir.Expr] = []
    for p in preds:
        refs = referenced_inputs(p)
        ls = {leaf_of(r) for r in refs}
        if len(ls) == 1:
            (li,) = ls
            shift = {r: r - offsets[li] for r in refs}
            leaf_preds[li].append(remap_inputs(p, shift))
        elif (len(ls) == 2 and isinstance(p, ir.Call) and p.name == "eq"
                and all(_is_col(a) for a in p.args)):
            a, b = p.args
            la, lb = leaf_of(_col_index(a)), leaf_of(_col_index(b))
            if la != lb:
                edges.append((la, lb, a, b))
            else:
                multi.append(p)
        else:
            multi.append(p)

    new_leaves = [
        FilterNode(child=lf, predicate=combine_conjuncts(ps))
        if ps else lf
        for lf, ps in ((leaves[i], leaf_preds[i]) for i in range(len(leaves)))
    ]
    sizes = [_estimate_rows(nl, session) for nl in new_leaves]

    # greedy join order: start from the largest leaf (fact table), repeatedly
    # join the smallest connected leaf (dimension-first probe keeps the
    # build sides small) — the heuristic core of ReorderJoins
    remaining = set(range(len(leaves)))
    start = max(remaining, key=lambda i: sizes[i])
    joined = [start]
    remaining.remove(start)
    # current node: global positions of its output
    current: PlanNode = new_leaves[start]
    cur_pos: List[int] = [offsets[start] + k
                          for k in range(len(leaves[start].fields))]

    def edges_between(done: Sequence[int], cand: int):
        out = []
        for (la, lb, a, b) in edges:
            if la in done and lb == cand:
                out.append((a, b))
            elif lb in done and la == cand:
                out.append((b, a))
        return out

    while remaining:
        cands = [i for i in remaining if edges_between(joined, i)]
        if not cands:
            # disconnected: only allowed for 1-row-ish sides (cross join)
            i = min(remaining, key=lambda i: sizes[i])
            pairs = []
        else:
            # prefer candidates the unique-key join kernel can execute:
            # either the candidate's keys or the tree's keys must be unique
            # (the tree side can be swapped by _implement_joins)
            def viable(i: int) -> bool:
                ps = edges_between(joined, i)
                rmap_l = {g: k for k, g in enumerate(cur_pos)}
                cand_keys = []
                tree_keys = []
                for (a, b) in ps:
                    off = offsets[i]
                    cand_keys.append(_col_index(b) - off)
                    tree_keys.append(rmap_l[_col_index(a)])
                return (_key_unique(new_leaves[i], cand_keys, session)
                        or _key_unique(current, tree_keys, session))

            def selectivity(i: int) -> float:
                """Estimated fraction of the current tree's rows that
                survive joining candidate i — the containment formula of
                _JoinNode (rows = L*R/max(ndv)) divided by L. Star chains
                then join the MOST SELECTIVE dimension first, so a fused
                probe pipeline's first join prunes the fact table instead
                of merely widening it (a filtered dimension can be far
                more selective than a small-but-unfiltered one — ranking
                by build size alone puts a 12-row store table ahead of a
                1/70-selective customer_demographics filter)."""
                ps = edges_between(joined, i)
                if not ps:
                    return 1.0
                calc = _stats_calc(session)
                cand_est = calc.estimate(new_leaves[i])
                cur_est = calc.estimate(current)
                rmap_l = {g: k for k, g in enumerate(cur_pos)}
                ndv = 1.0
                for (a, b) in ps:
                    ln = cur_est.column(rmap_l[_col_index(a)]).distinct
                    rn = cand_est.column(_col_index(b)
                                         - offsets[i]).distinct
                    cap = max(filter(None, (ln, rn)), default=None)
                    if cap:
                        ndv = max(ndv, cap)
                if ndv <= 1.0:
                    ndv = max(cur_est.rows, cand_est.rows)
                return min(1.0, cand_est.rows / max(ndv, 1.0))

            ranked = sorted(cands, key=lambda i: (not viable(i),
                                                  selectivity(i), sizes[i]))
            i = ranked[0]
            pairs = edges_between(joined, i)
        right = new_leaves[i]
        right_pos = [offsets[i] + k for k in range(len(leaves[i].fields))]
        lmap = {g: k for k, g in enumerate(cur_pos)}
        rmap = {g: k for k, g in enumerate(right_pos)}
        lkeys, rkeys = [], []
        for (a, b) in pairs:
            ia, ib = _col_index(a), _col_index(b)
            lkeys.append(lmap[ia])
            rkeys.append(rmap[ib])
        if not pairs and not (sizes[i] <= 2 or len(right.fields) == 0):
            raise ValueError(
                "cartesian product between large relations is not supported")
        current = JoinNode(
            join_type="inner" if pairs else "cross",
            left=current, right=right,
            left_keys=tuple(lkeys), right_keys=tuple(rkeys),
            fields=current.fields + right.fields,
            build_unique=_key_unique(right, rkeys, session))
        cur_pos = cur_pos + right_pos
        joined.append(i)
        remaining.remove(i)
        # apply any multi-leaf residuals that are now fully available
        avail = set(cur_pos)
        ready = [p for p in multi if referenced_inputs(p) <= avail]
        if ready:
            gmap = {g: k for k, g in enumerate(cur_pos)}
            pred = combine_conjuncts(
                [remap_inputs(p, {r: gmap[r] for r in referenced_inputs(p)})
                 for p in ready])
            current = FilterNode(child=current, predicate=pred)
            multi = [p for p in multi if p not in ready]

    if multi:
        raise ValueError("unapplied join predicates remain")

    # restore original global field order
    gmap = {g: k for k, g in enumerate(cur_pos)}
    exprs = tuple(
        ir.input_ref(gmap[g], _field_at(leaves, offsets, g).type)
        for g in range(total))
    fields = tuple(_field_at(leaves, offsets, g) for g in range(total))
    return ProjectNode(child=current, exprs=exprs, fields=fields)


def _field_at(leaves, offsets, g: int) -> Field:
    for i in range(len(leaves) - 1, -1, -1):
        if g >= offsets[i]:
            return leaves[i].fields[g - offsets[i]]
    raise AssertionError


def _is_col(e: ir.Expr) -> bool:
    """Join-key edge endpoint: a raw column, or a cast the join kernel can
    drop safely. _join_key compares keys in the int64 domain, so an
    int-stored widening cast (integral->integral, date->integral) is
    value-exact without the cast; decimal rescales and float casts are NOT
    and must stay residual filters."""
    if isinstance(e, ir.InputRef):
        return True
    if isinstance(e, ir.Cast) and isinstance(e.arg, ir.InputRef):
        src, dst = e.arg.type, e.type
        int_stored = lambda t: T.is_integral(t) or isinstance(t, T.DateType)
        return int_stored(src) and int_stored(dst)
    return False


def _col_index(e: ir.Expr) -> int:
    if isinstance(e, ir.InputRef):
        return e.index
    return e.arg.index


# ---------------------------------------------------------------------------
# Pass 2: column pruning
# ---------------------------------------------------------------------------

def _prune(node: PlanNode, required: List[int]) -> Tuple[PlanNode, Dict[int, int]]:
    """Rewrite the subtree to produce exactly ``required`` (in order);
    returns the new node + mapping old index -> new index."""
    req = sorted(set(required))
    mapping = {old: new for new, old in enumerate(req)}

    if isinstance(node, TableScanNode):
        cols = tuple(node.columns[i] for i in req)
        fields = tuple(node.fields[i] for i in req)
        return (dataclasses.replace(node, columns=cols, fields=fields),
                mapping)

    if isinstance(node, ProjectNode):
        child_req: Set[int] = set()
        for i in req:
            child_req |= referenced_inputs(node.exprs[i])
        child, cmap = _prune(node.child, sorted(child_req))
        exprs = tuple(remap_inputs(node.exprs[i], cmap) for i in req)
        fields = tuple(node.fields[i] for i in req)
        return ProjectNode(child=child, exprs=exprs, fields=fields), mapping

    if isinstance(node, FilterNode):
        need = set(req) | referenced_inputs(node.predicate)
        child, cmap = _prune(node.child, sorted(need))
        pred = remap_inputs(node.predicate, cmap)
        inner = FilterNode(child=child, predicate=pred)
        return _narrow(inner, [cmap[i] for i in req],
                       [node.fields[i] for i in req]), mapping

    if isinstance(node, JoinNode):
        n_left = len(node.left.fields)
        need = set(req) | set(node.left_keys) | {
            n_left + k for k in node.right_keys}
        if node.residual is not None:
            need |= referenced_inputs(node.residual)
        lneed = sorted(i for i in need if i < n_left)
        rneed = sorted(i - n_left for i in need if i >= n_left)
        left, lmap = _prune(node.left, lneed)
        right, rmap = _prune(node.right, rneed)
        both = {i: lmap[i] for i in lneed}
        both.update({n_left + i: len(left.fields) + rmap[i] for i in rneed})
        fields = tuple(node.left.fields[i] for i in lneed) + tuple(
            node.right.fields[i] for i in rneed)
        inner = JoinNode(
            join_type=node.join_type, left=left, right=right,
            left_keys=tuple(lmap[k] for k in node.left_keys),
            right_keys=tuple(rmap[k] for k in node.right_keys),
            fields=fields,
            residual=(remap_inputs(node.residual, both)
                      if node.residual is not None else None),
            distribution=node.distribution, build_unique=node.build_unique)
        return _narrow(inner, [both[i] for i in req],
                       [node.fields[i] for i in req]), mapping

    if isinstance(node, SemiJoinNode):
        n_src = len(node.source.fields)
        res_refs = (referenced_inputs(node.residual)
                    if node.residual is not None else set())
        src_res = {i for i in res_refs if i < n_src}
        flt_res = {i - n_src for i in res_refs if i >= n_src}
        need = set(req) | set(node.source_keys) | src_res
        source, smap = _prune(node.source, sorted(need))
        fneed = sorted(set(node.filtering_keys) | flt_res)
        filtering, fmap = _prune(node.filtering, fneed)
        residual = None
        if node.residual is not None:
            both = {i: smap[i] for i in src_res}
            both.update({n_src + i: len(source.fields) + fmap[i]
                         for i in flt_res})
            residual = remap_inputs(node.residual, both)
        inner = SemiJoinNode(
            source=source, filtering=filtering,
            source_keys=tuple(smap[k] for k in node.source_keys),
            filtering_keys=tuple(fmap[k] for k in node.filtering_keys),
            fields=source.fields, negated=node.negated,
            residual=residual, null_aware=node.null_aware)
        return _narrow(inner, [smap[i] for i in req],
                       [node.fields[i] for i in req]), mapping

    if isinstance(node, AggregationNode):
        # group keys always kept; aggs only if required
        n_keys = len(node.group_indices)
        child_req = set(node.group_indices)
        kept_aggs = [j for j in range(len(node.aggs))
                     if (n_keys + j) in mapping or not req]
        # keys must stay even if not required (they define grouping)
        for j in kept_aggs:
            if node.aggs[j].arg is not None:
                child_req.add(node.aggs[j].arg)
        child, cmap = _prune(node.child, sorted(child_req))
        aggs = tuple(
            dataclasses.replace(node.aggs[j],
                                arg=(cmap[node.aggs[j].arg]
                                     if node.aggs[j].arg is not None else None))
            for j in kept_aggs)
        fields = tuple(node.fields[i] for i in range(n_keys)) + tuple(
            node.fields[n_keys + j] for j in kept_aggs)
        inner = AggregationNode(
            child=child,
            group_indices=tuple(cmap[g] for g in node.group_indices),
            aggs=aggs, fields=fields, step=node.step,
            default_gids=node.default_gids)
        # remap required through (keys keep positions, aggs shift)
        agg_pos = {n_keys + j: n_keys + k for k, j in enumerate(kept_aggs)}
        inner_map = {**{i: i for i in range(n_keys)}, **agg_pos}
        return _narrow(inner, [inner_map[i] for i in req],
                       [node.fields[i] for i in req]), mapping

    if isinstance(node, (SortNode, TopNNode)):
        need = set(req) | {k.index for k in node.keys}
        child, cmap = _prune(node.child, sorted(need))
        keys = tuple(dataclasses.replace(k, index=cmap[k.index])
                     for k in node.keys)
        inner = dataclasses.replace(node, child=child, keys=keys,
                                    fields=child.fields)
        return _narrow(inner, [cmap[i] for i in req],
                       [node.fields[i] for i in req]), mapping

    if isinstance(node, LimitNode):
        # a child that does not prune (Unnest) keeps all its fields, so
        # narrow through cmap rather than assume the child shrank to req
        child, cmap = _prune(node.child, req)
        inner = LimitNode(child=child, count=node.count, fields=child.fields)
        return _narrow(inner, [cmap[i] for i in req],
                       [node.fields[i] for i in req]), mapping

    if isinstance(node, DistinctNode):
        # distinct is over ALL columns: cannot prune through it
        child, cmap = _prune(node.child,
                             list(range(len(node.child.fields))))
        inner = DistinctNode(child=child)
        return _narrow(inner, [cmap[i] for i in req],
                       [node.fields[i] for i in req]), mapping

    if isinstance(node, UnionNode):
        new_children = []
        for c in node.children:
            nc, cmap = _prune(c, req)
            new_children.append(_narrow(nc, [cmap[i] for i in req],
                                        [c.fields[i] for i in req]))
        fields = tuple(node.fields[i] for i in req)
        return (UnionNode(children_=tuple(new_children), fields=fields,
                          distinct=node.distinct), mapping)

    if isinstance(node, ValuesNode):
        rows = tuple(tuple(r[i] for i in req) for r in node.rows)
        fields = tuple(node.fields[i] for i in req)
        return ValuesNode(fields=fields, rows=rows), mapping

    if isinstance(node, OutputNode):
        child, cmap = _prune(node.child, req)
        narrowed = _narrow(child, [cmap[i] for i in req],
                           [node.fields[i] for i in req])
        return OutputNode(child=narrowed,
                          fields=tuple(node.fields[i] for i in req)), mapping

    from .plan import MarkDistinctNode
    if isinstance(node, MarkDistinctNode):
        # mask channels read (keys, arg): keep all child columns live but
        # recurse so the subtree below still prunes
        child_req = list(range(len(node.child.fields)))
        child, cmap = _prune(node.child, child_req)
        child = _narrow(child, [cmap[i] for i in child_req],
                        list(node.child.fields))
        return (dataclasses.replace(node, child=child),
                {i: i for i in range(len(node.fields))})

    from .plan import GroupIdNode
    if isinstance(node, GroupIdNode):
        # all child columns stay live (keys feed the grouping sets, the
        # rest are agg args), but recurse so the subtree below still prunes
        child_req = list(range(len(node.child.fields)))
        child, cmap = _prune(node.child, child_req)
        child = _narrow(child, [cmap[i] for i in child_req],
                        list(node.child.fields))
        return (dataclasses.replace(node, child=child),
                {i: i for i in range(len(node.fields))})

    # unknown node: don't prune through
    return node, {i: i for i in range(len(node.fields))}


def _narrow(node: PlanNode, indices: List[int],
            fields: List[Field]) -> PlanNode:
    """Project the node down to ``indices`` unless it already matches."""
    if indices == list(range(len(node.fields))):
        return node
    return ProjectNode(
        child=node,
        exprs=tuple(ir.input_ref(i, node.fields[i].type) for i in indices),
        fields=tuple(fields))


# ---------------------------------------------------------------------------
# Pass 3: join implementation (build side + distribution)
# ---------------------------------------------------------------------------

def _key_unique(node: PlanNode, keys: Sequence[int],
                session: Session) -> bool:
    """Conservatively: are these key columns unique in this relation?"""
    if isinstance(node, AggregationNode):
        return set(keys) == set(range(len(node.group_indices)))
    if isinstance(node, DistinctNode):
        return set(keys) == set(range(len(node.fields)))
    if isinstance(node, (FilterNode, SortNode, TopNNode, LimitNode)):
        return _key_unique(node.child, keys, session)
    if isinstance(node, ProjectNode):
        src = []
        for k in keys:
            e = node.exprs[k]
            if not isinstance(e, ir.InputRef):
                return False
            src.append(e.index)
        return _key_unique(node.child, src, session)
    if isinstance(node, TableScanNode):
        conn = session.catalogs.get(node.catalog)
        stats = conn.metadata.table_stats(node.table)
        names = {node.columns[k] for k in keys}
        if stats.primary_key and set(stats.primary_key) <= names:
            return True
        if stats.row_count is None:
            return False
        for k in keys:
            cs = stats.columns.get(node.columns[k])
            if cs is not None and cs.distinct_count is not None \
                    and cs.distinct_count >= 0.999 * stats.row_count:
                return True  # any single unique column makes the tuple unique
        return False
    if isinstance(node, JoinNode):
        # keys on the probe side of a PK-FK join stay unique
        n_left = len(node.left.fields)
        lkeys = [k for k in keys if k < n_left]
        if len(lkeys) == len(keys) and node.build_unique:
            return _key_unique(node.left, lkeys, session)
        return False
    return False


def _implement_joins(node: PlanNode, session: Session) -> PlanNode:
    node = node.with_children([_implement_joins(c, session)
                               for c in node.children])
    if not isinstance(node, JoinNode) or node.join_type == "cross":
        return node
    left_unique = _key_unique(node.left, node.left_keys, session)
    right_unique = _key_unique(node.right, node.right_keys, session)
    lrows = _estimate_rows(node.left, session)
    rrows = _estimate_rows(node.right, session)

    swap = False
    if node.join_type == "inner":
        if right_unique and left_unique:
            swap = rrows > lrows
        elif left_unique:
            swap = True
        elif not right_unique:
            # many-to-many: expansion join; build on the smaller side
            swap = lrows < rrows
    # left outer: probe must stay on the left (expansion join handles a
    # non-unique build side)
    if swap:
        n_left, n_right = len(node.left.fields), len(node.right.fields)
        # old global index -> index in the swapped join's output
        remap = {i: n_right + i for i in range(n_left)}
        remap.update({n_left + j: j for j in range(n_right)})
        inner = JoinNode(
            join_type="inner", left=node.right, right=node.left,
            left_keys=node.right_keys, right_keys=node.left_keys,
            fields=node.right.fields + node.left.fields,
            residual=(remap_inputs(node.residual, remap)
                      if node.residual is not None else None),
            build_unique=True,
            distribution=_distribution(node.left, lrows, session))
        # restore the original left+right field order for parents
        return ProjectNode(
            child=inner,
            exprs=tuple(ir.input_ref(remap[i], f.type)
                        for i, f in enumerate(node.fields)),
            fields=node.fields)
    if node.join_type == "full":
        # a replicated build would emit its unmatched-row tail once per
        # shard; FULL OUTER must hash-partition both sides (reference
        # DetermineJoinDistributionType.java mustPartition for FULL)
        return dataclasses.replace(node, build_unique=right_unique,
                                   distribution="partitioned")
    return dataclasses.replace(
        node, build_unique=right_unique,
        distribution=_distribution(node.right, rrows, session))


def _distribution(build: PlanNode, rows: float, session: Session) -> str:
    limit = session.properties.get("broadcast_join_row_limit",
                                   BROADCAST_ROW_LIMIT)
    return "replicated" if rows <= limit else "partitioned"


# ---------------------------------------------------------------------------
# Pass 4: eager aggregation — partial agg pushed through an inner join
# ---------------------------------------------------------------------------

#: aggregate functions with mergeable partial states the push understands
_PUSHABLE_AGG_FNS = ("sum", "count", "count_star", "min", "max", "avg")


def _column_distinct(node: PlanNode, idx: int,
                     session: Session) -> Optional[float]:
    """Distinct-count estimate for one output column via the stats
    calculus (NDV propagated from scan statistics, capped by filtered
    row counts) — the eager-aggregation gate's input."""
    calc = _stats_calc(session)
    d = calc.estimate(node).column(idx).distinct
    return min(d, calc.rows(node)) if d is not None else None


def _push_partial_agg_through_join(node: PlanNode,
                                   session: Session) -> PlanNode:
    """Rewrite Agg(Project*(Join(L, R))) into
    Final(Project(Join(Partial(Project(L)), R))) when every aggregate
    input comes from the probe (left) side — the reference's
    iterative/rule/PushPartialAggregationThroughJoin.java (+ the
    PushPartialAggregationThroughExchange state-split machinery).

    Correct for INNER joins regardless of build-key multiplicity: a
    partial-state row replicated by k matches merges identically to its
    k underlying rows (sum/count/min/max/avg states are replication-
    linear), and whole partial groups match-or-drop together because the
    left join keys are part of the partial grouping key. The win on this
    hardware: the probe side shrinks to one state row per group BEFORE
    the join, so probe gathers and the post-join group-by touch
    group-count rows, not input rows."""
    node = node.with_children(
        [_push_partial_agg_through_join(c, session)
         for c in node.children])
    if not isinstance(node, AggregationNode) or node.step != "single":
        return node
    out = _try_eager_agg(node, session)
    return out if out is not None else node


def _try_eager_agg(agg: AggregationNode,
                   session: Session) -> Optional[PlanNode]:
    from .rules import _inline_into

    if not agg.group_indices:
        return None                  # global agg: partial is one row; no win
    for a in agg.aggs:
        if a.distinct or a.mask is not None \
                or a.fn not in _PUSHABLE_AGG_FNS:
            return None
    chain: List[ProjectNode] = []
    cur = agg.child
    while isinstance(cur, ProjectNode):
        chain.append(cur)
        cur = cur.child
    if not isinstance(cur, JoinNode) or cur.join_type != "inner" \
            or cur.residual is not None:
        return None
    join = cur
    # compose the project chain: agg-child column i as an expr over the
    # join's output schema
    exprs: Optional[List[ir.Expr]] = None
    for p in chain:
        exprs = list(p.exprs) if exprs is None \
            else [_inline_into(e, p.exprs) for e in exprs]
    if exprs is None:
        exprs = [ir.input_ref(i, f.type)
                 for i, f in enumerate(join.fields)]
    nL = len(join.left.fields)

    def left_only(e: ir.Expr) -> bool:
        refs = referenced_inputs(e)
        return all(r < nL for r in refs)

    # classify group keys: left-side exprs join the partial grouping key;
    # right-side keys must be bare column refs (still available above)
    left_group: List[Tuple[int, ir.Expr]] = []
    right_group: List[Tuple[int, int]] = []
    for pos in range(len(agg.group_indices)):
        e = exprs[agg.group_indices[pos]]
        if left_only(e):
            left_group.append((pos, e))
        elif isinstance(e, ir.InputRef) and e.index >= nL:
            right_group.append((pos, e.index - nL))
        else:
            return None
    for a in agg.aggs:
        if a.arg is not None and not left_only(exprs[a.arg]):
            return None

    # below-projection over the left side: join keys + left group keys +
    # aggregate inputs (deduplicated by structural equality)
    Lf = join.left.fields
    below: List[ir.Expr] = []
    below_fields: List[Field] = []
    index_of: Dict[ir.Expr, int] = {}

    def add(e: ir.Expr, name: str) -> int:
        if e in index_of:
            return index_of[e]
        index_of[e] = len(below)
        below.append(e)
        below_fields.append(Field(name, e.type))
        return len(below) - 1

    jk_below = [add(ir.input_ref(k, Lf[k].type), Lf[k].name)
                for k in join.left_keys]
    n_keys = len(agg.group_indices)
    gk_below = [(pos, add(e, agg.fields[pos].name))
                for pos, e in left_group]
    agg_below = [None if a.arg is None
                 else add(exprs[a.arg], f"$aggin{i}")
                 for i, a in enumerate(agg.aggs)]

    partial_group: List[int] = list(dict.fromkeys(
        jk_below + [b for _, b in gk_below]))
    if len(partial_group) > 4:
        # the pushed partial sorts by (dead, null, data) per key: TPU
        # variadic-sort compile time grows superlinearly with operand
        # count (measured minutes at ~10 operands), so wide grouping
        # keys stay above the join
        return None
    # cardinality gate (the reference rule is cost-based): decline when
    # statistics PROVE the partial cannot shrink its input — the push
    # would add a full sort-based aggregation pass for nothing. When any
    # key's distinct count is unknown, push optimistically: the worst
    # case is one extra aggregation pass over rows the plan was already
    # aggregating, while the win (q3/q55-shaped plans) is an order of
    # magnitude.
    distincts = [_column_distinct(
        ProjectNode(child=join.left, exprs=tuple(below),
                    fields=tuple(below_fields)), b, session)
        for b in partial_group]
    if all(d is not None for d in distincts):
        groups_est = 1.0
        for d in distincts:
            groups_est *= max(d, 1.0)
        left_rows = _estimate_rows(join.left, session)
        if groups_est >= 0.5 * left_rows:
            return None
    below_proj = ProjectNode(child=join.left, exprs=tuple(below),
                             fields=tuple(below_fields))
    partial_aggs = tuple(
        dataclasses.replace(a, arg=agg_below[i])
        for i, a in enumerate(agg.aggs))
    partial = AggregationNode(
        child=below_proj, group_indices=tuple(partial_group),
        aggs=partial_aggs, fields=(), step="partial")
    partial = dataclasses.replace(partial,
                                  fields=_agg_state_fields(partial))
    # the rewritten join: partial states probe the unchanged build side
    new_left_keys = tuple(partial_group.index(b) for b in jk_below)
    new_join = dataclasses.replace(
        join, left=partial, left_keys=new_left_keys,
        fields=tuple(partial.fields) + tuple(join.right.fields))
    # above-projection: [final group keys..., state columns...] — the
    # final step consumes states positionally after the keys
    np_fields = len(partial.fields)
    key_ref: Dict[int, ir.Expr] = {}
    for pos, e in left_group:
        b = index_of[e]
        key_ref[pos] = ir.input_ref(partial_group.index(b),
                                    below_fields[b].type)
    for pos, rcol in right_group:
        key_ref[pos] = ir.input_ref(np_fields + rcol,
                                    join.right.fields[rcol].type)
    above_exprs: List[ir.Expr] = [key_ref[pos] for pos in range(n_keys)]
    above_fields: List[Field] = [agg.fields[pos] for pos in range(n_keys)]
    from ..ops.aggregation import AggSpec
    st = len(partial_group)
    state_args: List[int] = []
    for a in agg.aggs:
        spec = AggSpec(a.fn, a.arg, a.output_type, a.name)
        state_args.append(len(above_exprs))
        for sn, stype in spec.state_types():
            above_exprs.append(
                ir.input_ref(st, stype))
            above_fields.append(Field(sn, stype))
            st += 1
    above = ProjectNode(child=new_join, exprs=tuple(above_exprs),
                        fields=tuple(above_fields))
    final_aggs = tuple(
        dataclasses.replace(a, arg=state_args[i])
        for i, a in enumerate(agg.aggs))
    return AggregationNode(
        child=above, group_indices=tuple(range(n_keys)),
        aggs=final_aggs, fields=agg.fields, step="final",
        default_gids=agg.default_gids)


# ---------------------------------------------------------------------------
# Pass 5: stats-bounded dense grouping (the rewrite gate for the
# ops/scatter_agg.py digit-scatter group-by path)
# ---------------------------------------------------------------------------

from ..ops.aggregation import DENSE_SCATTER_LIMIT  # noqa: E402


def _group_key_bound(node: PlanNode, idx: int, session: Session
                     ) -> Optional[Tuple[int, int]]:
    """Static [lo, hi] for one group-key column when statistics prove it:
    integer-family storage with both range ends known. Bounds must be
    TRUE bounds, not estimates — the stats calculus only ever narrows
    ranges from connector min/max (filters keep ranges, joins/projections
    pass them through), so a connector publishing exact min/max yields
    hard bounds. The executor still cross-checks every batch through the
    row-error channel (exec/local.py), so a connector overclaiming its
    statistics fails the query instead of corrupting groups."""
    t = node.fields[idx].type
    if not isinstance(t, _BOUNDABLE):
        return None
    ce = _stats_calc(session).estimate(node).column(idx)
    if ce.lo is None or ce.hi is None or ce.hi < ce.lo:
        return None
    import math
    lo, hi = math.floor(ce.lo), math.ceil(ce.hi)
    if hi - lo + 1 > DENSE_SCATTER_LIMIT:
        return None
    return int(lo), int(hi)


def _bounds_for_keys(child: PlanNode, key_cols: Sequence[int],
                     session: Session
                     ) -> Tuple[Optional[Tuple[int, int]], ...]:
    """key_bounds tuple for a grouping over ``key_cols`` of ``child``, or
    () when the dense composite code cannot engage. The gate mirrors the
    kernel's dispatch (ops/aggregation.py dense_group_plan): every key
    needs a host-known domain — integer stats bounds here, dictionary /
    boolean domains at trace time — and the composite product must stay
    under DENSE_SCATTER_LIMIT. Unknown string/bool domains contribute
    their NDV estimate (the kernel re-gates with the true dictionary
    size, so an optimistic pass here costs nothing)."""
    calc = _stats_calc(session)
    bounds: List[Optional[Tuple[int, int]]] = []
    domain = 1.0
    any_bound = False
    for k in key_cols:
        t = child.fields[k].type
        if isinstance(t, _BOUNDABLE):
            b = _group_key_bound(child, k, session)
            if b is None:
                return ()
            bounds.append(b)
            domain *= b[1] - b[0] + 2          # + NULL component
            any_bound = True
        elif t.is_string or isinstance(t, T.BooleanType):
            # domain known only at trace time (dictionary size); gate on
            # the NDV estimate when stats offer one
            bounds.append(None)
            d = calc.estimate(child).column(k).distinct
            if d is not None:
                domain *= max(d, 1.0) + 1
        else:
            return ()
    if not any_bound or domain > DENSE_SCATTER_LIMIT:
        return ()
    return tuple(bounds)


# ---------------------------------------------------------------------------
# Pass 6: stats-driven join strategy (direct-address builds + semi-join
# distribution) — the rewrite gate for ops/join.prepare_direct_keyed
# ---------------------------------------------------------------------------

def _join_key_bounds(node: PlanNode, keys: Sequence[int],
                     session: Session
                     ) -> Tuple[Optional[Tuple[int, int]], ...]:
    """Hard [lo, hi] per build/filtering key when statistics prove them
    all, or () when the direct-address table cannot engage. Bounds must
    be TRUE bounds (the _group_key_bound contract): the stats calculus
    only narrows ranges from connector min/max, and the executor
    cross-checks every build batch through the row-error channel
    (STATS_BOUND_VIOLATION), so an overclaiming connector fails the
    query instead of dropping matches. The composite mixed-radix
    product gates against ops/join.DIRECT_KEYED_LIMIT — the same
    dispatch shape as dense grouping's DENSE_SCATTER_LIMIT."""
    from ..ops.join import direct_keyed_plan
    import math
    if not keys:
        return ()
    calc = _stats_calc(session)
    bounds: List[Tuple[int, int]] = []
    for k in keys:
        t = node.fields[k].type
        if not isinstance(t, _BOUNDABLE):
            return ()
        ce = calc.estimate(node).column(k)
        if ce.lo is None or ce.hi is None or ce.hi < ce.lo:
            return ()
        bounds.append((int(math.floor(ce.lo)), int(math.ceil(ce.hi))))
    if direct_keyed_plan(tuple(bounds)) is None:
        return ()
    return tuple(bounds)


def _attach_join_strategy(node: PlanNode, session: Session,
                          dense: bool = True) -> PlanNode:
    """Attach stats-derived build-key bounds to joins whose composite
    key domain is provably small — the planner side of the dense-key
    direct-address join (ops/join.prepare_direct_keyed: a bounded key
    tuple answers in TWO gathers independent of build size, where the
    sorted fallback pays O(log n) gathers per probe lane) — and pick
    semi-join distribution from the estimated filtering size instead of
    broadcast-membership-everywhere. Runs AFTER _implement_joins /
    the eager-agg push, so build sides are final. ``dense`` is the
    `join_dense_path` escape hatch — it gates ONLY the direct-address
    bounds; distribution selection is an independent decision and stays
    on either way."""
    node = node.with_children([_attach_join_strategy(c, session, dense)
                               for c in node.children])
    if dense and isinstance(node, JoinNode) and node.join_type != "cross" \
            and node.right_keys:
        kb = _join_key_bounds(node.right, node.right_keys, session)
        if kb:
            node = dataclasses.replace(node, key_bounds=kb)
    if isinstance(node, SemiJoinNode):
        if dense:
            kb = _join_key_bounds(node.filtering, node.filtering_keys,
                                  session)
            if kb:
                node = dataclasses.replace(node, key_bounds=kb)
        if not (node.negated and node.null_aware):
            # NULL-aware anti joins (NOT IN) must see the GLOBAL
            # filtering set (any NULL build key poisons every shard's
            # verdict; an empty set passes everything) — they stay
            # replicated. Everything else partitions when the
            # filtering set is too large to broadcast.
            rows = _estimate_rows(node.filtering, session)
            node = dataclasses.replace(
                node,
                distribution=_distribution(node.filtering, rows,
                                           session))
    return node


def _attach_group_bounds(node: PlanNode, session: Session) -> PlanNode:
    """Attach stats-derived static key bounds to aggregations and
    DISTINCTs whose composite key domain is provably small — the
    planner-side gate that routes multi-key GROUP BYs onto the dense i32
    scatter path (the reference BigintGroupByHash dense-array mode,
    generalized to mixed-radix composite keys)."""
    node = node.with_children([_attach_group_bounds(c, session)
                               for c in node.children])
    if isinstance(node, AggregationNode) and node.group_indices:
        kb = _bounds_for_keys(node.child, node.group_indices, session)
        if kb:
            return dataclasses.replace(node, key_bounds=kb)
    if isinstance(node, DistinctNode) and node.fields:
        kb = _bounds_for_keys(node.child,
                              tuple(range(len(node.fields))), session)
        if kb:
            return dataclasses.replace(node, key_bounds=kb)
    return node
