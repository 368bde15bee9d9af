"""Statistics calculus: row/NDV/range estimates propagated per plan node.

The TPU build's counterpart of the reference cost framework (reference
presto-main/.../cost/StatsCalculator.java:1, FilterStatsCalculator.java:1,
JoinStatsRule.java:1): every node gets a PlanEstimate —
row count plus per-output-column NDV / numeric range / null fraction —
derived from connector table statistics and propagated through filters
(range arithmetic + equality-by-NDV), joins (containment by the smaller
key NDV), aggregations (group NDV product), and the rest. The optimizer
consumes it for join ordering, broadcast-vs-partitioned distribution, and
the eager-aggregation gate.

Estimates are upper-bound-biased (like the reference's
UNKNOWN_FILTER_COEFFICIENT = 0.9 treatment of unestimatable conjuncts):
an overestimate costs performance, an underestimate can pick a broadcast
join that OOMs — same asymmetry the reference encodes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from .. import types as T
from ..expr import ir
from .plan import (
    AggregationNode, DistinctNode, FilterNode, GroupIdNode, JoinNode,
    LimitNode, MarkDistinctNode, OutputNode, PlanNode, ProjectNode,
    SemiJoinNode, SortNode, TableScanNode, TopNNode, UnionNode, UnnestNode,
    ValuesNode, WindowNode,
)

#: selectivity charged to a conjunct the calculus can't evaluate
#: (reference cost/FilterStatsCalculator.java UNKNOWN_FILTER_COEFFICIENT)
UNKNOWN_FILTER_COEFFICIENT = 0.9

#: fallback row count for a scan with no connector statistics
UNKNOWN_SCAN_ROWS = 1e9


@dataclasses.dataclass(frozen=True)
class ColumnEstimate:
    """Range/NDV estimate for one output column (reference
    spi/statistics/ColumnStatistics + cost/SymbolStatsEstimate)."""
    distinct: Optional[float] = None
    lo: Optional[float] = None         # numeric/date range (storage repr)
    hi: Optional[float] = None
    null_fraction: float = 0.0

    def capped(self, rows: float) -> "ColumnEstimate":
        """NDV capped by the owning relation's row count (ranges survive
        selection unchanged — upper bound)."""
        if self.distinct is None or self.distinct <= rows:
            return self
        return dataclasses.replace(self, distinct=max(1.0, rows))


@dataclasses.dataclass(frozen=True)
class PlanEstimate:
    rows: float
    columns: Dict[int, ColumnEstimate] = dataclasses.field(
        default_factory=dict)

    def column(self, i: int) -> ColumnEstimate:
        return self.columns.get(i, ColumnEstimate())


def _lit_num(e: ir.Expr) -> Optional[float]:
    if isinstance(e, ir.Literal) and isinstance(e.value, (int, float)) \
            and not isinstance(e.value, bool):
        return float(e.value)
    if isinstance(e, ir.Cast) :
        return _lit_num(e.arg)
    return None


def _ref_idx(e: ir.Expr) -> Optional[int]:
    if isinstance(e, ir.InputRef):
        return e.index
    if isinstance(e, ir.Cast):
        return _ref_idx(e.arg)
    return None


def _conjuncts(p: ir.Expr):
    if isinstance(p, ir.Call) and p.name == "and":
        for a in p.args:
            yield from _conjuncts(a)
    else:
        yield p


def _range_fraction(ce: ColumnEstimate, lo: Optional[float],
                    hi: Optional[float]) -> Optional[float]:
    """Fraction of the column's [lo, hi] range kept by a predicate range
    (reference FilterStatsCalculator range arithmetic)."""
    if ce.lo is None or ce.hi is None or ce.hi <= ce.lo:
        return None
    span = ce.hi - ce.lo
    keep_lo = ce.lo if lo is None else max(ce.lo, lo)
    keep_hi = ce.hi if hi is None else min(ce.hi, hi)
    if keep_hi <= keep_lo:
        return 0.0
    return min(1.0, (keep_hi - keep_lo) / span)


def _conjunct_selectivity(c: ir.Expr, cols: Dict[int, ColumnEstimate]
                          ) -> float:
    """Selectivity of one conjunct against the child's column estimates."""
    if isinstance(c, ir.Call) and c.name in ("eq", "lt", "le", "gt", "ge",
                                           "between", "ne"):
        a = c.args
        op = c.name
        idx = _ref_idx(a[0])
        if idx is None and len(a) >= 2:
            idx = _ref_idx(a[1])
            if idx is not None:
                # literal-first comparison: swap operands AND mirror the
                # operator (90 < x  ==  x > 90)
                a = (a[1], a[0])
                op = {"lt": "gt", "le": "ge",
                      "gt": "lt", "ge": "le"}.get(op, op)
        if idx is not None:
            ce = cols.get(idx, ColumnEstimate())
            if op == "eq":
                if ce.distinct and ce.distinct > 0:
                    return min(1.0, 1.0 / ce.distinct)
            elif op == "ne":
                if ce.distinct and ce.distinct > 0:
                    return max(0.0, 1.0 - 1.0 / ce.distinct)
            elif op == "between" and len(a) == 3:
                lo, hi = _lit_num(a[1]), _lit_num(a[2])
                f = _range_fraction(ce, lo, hi)
                if f is not None:
                    return f
            else:
                v = _lit_num(a[1]) if len(a) > 1 else None
                if v is not None:
                    f = _range_fraction(
                        ce,
                        v if op in ("gt", "ge") else None,
                        v if op in ("lt", "le") else None)
                    if f is not None:
                        return f
    if isinstance(c, ir.Call) and c.name == "in" and len(c.args) >= 2:
        idx = _ref_idx(c.args[0])
        ce = cols.get(idx, ColumnEstimate()) if idx is not None else None
        if ce is not None and ce.distinct and ce.distinct > 0:
            return min(1.0, (len(c.args) - 1) / ce.distinct)
    if isinstance(c, ir.Call) and c.name == "or":
        s = 0.0
        for d in c.args:
            s += _conjunct_selectivity(d, cols)
        return min(1.0, s)
    return UNKNOWN_FILTER_COEFFICIENT


class StatsCalculator:
    """Memoized per-node estimates for one optimization pass."""

    def __init__(self, session):
        self.session = session
        # memo holds the node alongside its estimate: entries are keyed
        # by id(), and keeping the reference pins the node so a
        # garbage-collected node's id can't be reused by a new node
        # within the same (now pass-long-lived) calculator
        self._memo: Dict[int, tuple] = {}

    def estimate(self, node: PlanNode) -> PlanEstimate:
        key = id(node)
        got = self._memo.get(key)
        if got is not None and got[0] is node:
            return got[1]
        est = self._compute(node)
        self._memo[key] = (node, est)
        return est

    def rows(self, node: PlanNode) -> float:
        return self.estimate(node).rows

    # -- per-node rules ------------------------------------------------------
    def _compute(self, node: PlanNode) -> PlanEstimate:
        m = getattr(self, "_" + type(node).__name__, None)
        if m is not None:
            return m(node)
        # default: pass the first child through (Output, Sort, Window...)
        if node.children:
            child = self.estimate(node.children[0])
            return PlanEstimate(child.rows, {})
        return PlanEstimate(1.0, {})

    def _TableScanNode(self, node: TableScanNode) -> PlanEstimate:
        conn = self.session.catalogs.get(node.catalog)
        stats = conn.metadata.table_stats(node.table)
        rows = stats.row_count if stats.row_count is not None \
            else UNKNOWN_SCAN_ROWS
        cols: Dict[int, ColumnEstimate] = {}
        for i, name in enumerate(node.columns):
            cs = stats.columns.get(name)
            if cs is None:
                continue
            lo = cs.min_value if isinstance(cs.min_value, (int, float)) \
                else None
            hi = cs.max_value if isinstance(cs.max_value, (int, float)) \
                else None
            cols[i] = ColumnEstimate(
                distinct=cs.distinct_count,
                lo=float(lo) if lo is not None else None,
                hi=float(hi) if hi is not None else None,
                null_fraction=cs.null_fraction or 0.0)
        # pushdown bounds are NOT discounted here: the planner always
        # keeps the exact FilterNode above the scan (connectors prune at
        # chunk granularity only), and that filter's selectivity already
        # charges the same predicate — scaling both would double-count
        return PlanEstimate(max(rows, 1.0), cols)

    def _ValuesNode(self, node: ValuesNode) -> PlanEstimate:
        return PlanEstimate(float(max(len(node.rows), 1)), {})

    def _FilterNode(self, node: FilterNode) -> PlanEstimate:
        child = self.estimate(node.child)
        sel = 1.0
        for c in _conjuncts(node.predicate):
            sel *= _conjunct_selectivity(c, child.columns)
        rows = max(child.rows * sel, 1.0)
        cols = {i: ce.capped(rows) for i, ce in child.columns.items()}
        return PlanEstimate(rows, cols)

    def _ProjectNode(self, node: ProjectNode) -> PlanEstimate:
        child = self.estimate(node.child)
        cols: Dict[int, ColumnEstimate] = {}
        for out_i, e in enumerate(node.exprs):
            idx = _ref_idx(e)
            if idx is not None and idx in child.columns:
                cols[out_i] = child.columns[idx]
        return PlanEstimate(child.rows, cols)

    def _JoinNode(self, node: JoinNode) -> PlanEstimate:
        left = self.estimate(node.left)
        right = self.estimate(node.right)
        if node.join_type == "cross" or not node.left_keys:
            rows = left.rows * right.rows
        else:
            # containment: |L >< R| = |L|*|R| / max(ndv(lk), ndv(rk))
            # (reference cost/JoinStatsRule.java)
            ndv = 1.0
            for lk, rk in zip(node.left_keys, node.right_keys):
                ln = left.column(lk).distinct
                rn = right.column(rk).distinct
                cand = max(filter(None, (ln, rn)), default=None)
                if cand:
                    ndv = max(ndv, cand)
            if ndv <= 1.0:
                ndv = max(left.rows, right.rows)
            rows = left.rows * right.rows / max(ndv, 1.0)
            if node.build_unique:
                # PK side: at most one match per probe row
                rows = min(rows, left.rows)
        if node.join_type in ("left", "full"):
            rows = max(rows, left.rows)
        if node.join_type == "full":
            rows = max(rows, right.rows)
        nl = len(node.left.fields)
        cols = dict(left.columns)
        for i, ce in right.columns.items():
            cols[nl + i] = ce
        return PlanEstimate(max(rows, 1.0), cols)

    def _SemiJoinNode(self, node: SemiJoinNode) -> PlanEstimate:
        """Containment selectivity (the JoinStatsRule formula applied to
        membership): the fraction of source rows with a match is bounded
        by ndv(filtering key) / ndv(source key). Feeds the semi-join
        distribution choice (optimizer._attach_join_strategy) and join
        ordering above; falls back to the old flat 0.5 when NDVs are
        unknown. Anti joins invert, floored to stay upper-bound-biased."""
        src = self.estimate(node.source)
        filt = self.estimate(node.filtering)
        sel: Optional[float] = None
        for sk, fk in zip(node.source_keys, node.filtering_keys):
            sn = src.column(sk).distinct
            fn = filt.column(fk).distinct
            if sn and fn and sn > 0:
                frac = min(1.0, fn / sn)
                sel = frac if sel is None else min(sel, frac)
        if sel is None:
            sel = 0.5
        if node.negated:
            sel = max(1.0 - sel, 0.1)
        rows = max(src.rows * sel, 1.0)
        cols = {i: ce.capped(rows) for i, ce in src.columns.items()}
        return PlanEstimate(rows, cols)

    def _AggregationNode(self, node: AggregationNode) -> PlanEstimate:
        child = self.estimate(node.child)
        if not node.group_indices:
            return PlanEstimate(1.0, {})
        groups = 1.0
        known = True
        for k in node.group_indices:
            d = child.column(k).distinct
            if d is None:
                known = False
                continue
            groups *= max(d, 1.0)
        if not known:
            groups = max(groups, math.sqrt(child.rows))
        rows = min(groups, child.rows)
        cols = {i: child.column(k)
                for i, k in enumerate(node.group_indices)
                if k in child.columns}
        return PlanEstimate(max(rows, 1.0), cols)

    def _DistinctNode(self, node: DistinctNode) -> PlanEstimate:
        child = self.estimate(node.child)
        groups = 1.0
        for i in range(len(node.fields)):
            d = child.column(i).distinct
            groups *= max(d, 1.0) if d else math.sqrt(child.rows)
        return PlanEstimate(max(min(groups, child.rows), 1.0),
                            child.columns)

    def _GroupIdNode(self, node: GroupIdNode) -> PlanEstimate:
        child = self.estimate(node.child)
        nsets = max(len(node.grouping_sets), 1)
        # child columns pass through (keys are nulled per set, which only
        # raises the null fraction — ranges survive); the appended
        # $group_id column has the exact static domain [0, nsets) — the
        # bound that lets ROLLUP/CUBE aggregations compose a dense group
        # code over it (optimizer._attach_group_bounds)
        cols = dict(child.columns)
        cols[len(node.child.fields)] = ColumnEstimate(
            distinct=float(nsets), lo=0.0, hi=float(nsets - 1))
        return PlanEstimate(child.rows * nsets, cols)

    def _LimitNode(self, node: LimitNode) -> PlanEstimate:
        child = self.estimate(node.child)
        return PlanEstimate(min(float(node.count), child.rows),
                            child.columns)

    def _TopNNode(self, node: TopNNode) -> PlanEstimate:
        child = self.estimate(node.child)
        return PlanEstimate(min(float(node.count), child.rows),
                            child.columns)

    def _SortNode(self, node: SortNode) -> PlanEstimate:
        child = self.estimate(node.child)
        return PlanEstimate(child.rows, child.columns)

    def _WindowNode(self, node: WindowNode) -> PlanEstimate:
        child = self.estimate(node.child)
        return PlanEstimate(child.rows, child.columns)

    def _MarkDistinctNode(self, node: MarkDistinctNode) -> PlanEstimate:
        child = self.estimate(node.child)
        return PlanEstimate(child.rows, child.columns)

    def _UnnestNode(self, node: UnnestNode) -> PlanEstimate:
        child = self.estimate(node.child)
        return PlanEstimate(child.rows * 8.0, {})

    def _UnionNode(self, node: UnionNode) -> PlanEstimate:
        return PlanEstimate(
            sum(self.estimate(c).rows for c in node.children), {})

    def _OutputNode(self, node: OutputNode) -> PlanEstimate:
        return self.estimate(node.child)
