"""AST -> logical plan lowering.

Conceptual parity with the reference's LogicalPlanner / QueryPlanner /
RelationPlanner / SubqueryPlanner stack (reference presto-main/.../sql/
planner/LogicalPlanner.java:156, QueryPlanner.java, RelationPlanner.java,
SubqueryPlanner.java): relations become plan nodes, SELECT decomposes into
project/aggregate/filter/sort layers, and subqueries lower to semi joins
(IN/EXISTS) or init plans (uncorrelated scalar subqueries, executed before
the main plan like reference ExchangeClient-fed index lookups).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .. import types as T
from ..connectors.spi import CatalogManager, TableHandle
from ..expr import ir
from ..sql import ast as A
from ..sql.analyzer import (
    AGGREGATE_FUNCTIONS, AnalysisError, ExpressionAnalyzer, Field, Scope,
    UnresolvedColumnError, _FUNCTION_ALIASES, coerce,
)
from .plan import (
    AggregationNode, DistinctNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanAgg, PlanNode, ProjectNode, SemiJoinNode, SortKeySpec,
    SortNode, TableScanNode, TopNNode, UnionNode, ValuesNode,
)


@dataclasses.dataclass(frozen=True)
class InitPlanRef:
    """Placeholder literal value for an uncorrelated scalar subquery;
    the executor runs the init plan and substitutes the scalar."""

    index: int


@dataclasses.dataclass
class LogicalPlan:
    root: OutputNode
    init_plans: List[PlanNode]


@dataclasses.dataclass
class Session:
    """Query session context (reference Session.java essentials)."""

    catalogs: CatalogManager
    catalog: str = "tpch"
    schema: str = "default"
    properties: Dict[str, object] = dataclasses.field(default_factory=dict)
    # logical views: (catalog, schema, name) -> stored A.Query, expanded
    # at plan time (reference metadata views / ConnectorViewDefinition)
    views: Dict[Tuple[str, str, str], object] = dataclasses.field(
        default_factory=dict)
    # prepared statements: name -> statement AST (reference
    # Session.preparedStatements + PrepareTask)
    prepared: Dict[str, object] = dataclasses.field(default_factory=dict)
    # filled by the executor: memory.MemoryStats of the last query
    last_memory_stats: object = None
    # serving-plane context (serving/groups.QueryServingContext) set on
    # the per-query overlay by LocalRunner.execute when the query was
    # admitted through a resource group: carries the group path /
    # scheduling weight for the device scheduler and the group memory
    # account for the query pool
    serving: object = None
    # plan-template bindings {slot: value} set on the per-query overlay
    # when the plan came from serving/template.py: the executor opens an
    # expr/params binding scope around the drain so ir.Param kernels
    # read THIS query's literals as traced scalars
    param_bindings: Optional[Dict[int, object]] = None


def _schema_exists(session: "Session", schema: str) -> bool:
    """True when the session catalog exposes ``schema`` (or a view is
    registered under it) — the gate for reference-style schema-first
    two-part name resolution (a schema named like a mounted
    catalog must not be silently shadowed)."""
    try:
        conn = session.catalogs.get(session.catalog)
        if schema in conn.metadata.list_schemas():
            return True
    except Exception:
        pass
    return any(k[0] == session.catalog and k[1] == schema
               for k in session.views)


def bool_property(session: "Session", name: str, default: bool) -> bool:
    """Session properties arrive as strings from SET SESSION / HTTP
    headers; parse the usual spellings instead of trusting truthiness.
    Shared by the executor's and the optimizer's feature gates."""
    v = session.properties.get(name, default)
    if isinstance(v, str):
        return v.strip().lower() not in ("false", "0", "off", "no", "")
    return bool(v)


def _const_value(e: ir.Expr):
    """Evaluate a constant expression to its python value (VALUES cells,
    which may be arbitrary constant expressions: casts, arithmetic —
    reference ExpressionInterpreter's role). Evaluates on the CPU through
    the port's expression compiler: a one-row constant never pays a
    device round trip."""
    if isinstance(e, ir.Literal):
        return e.value
    import torch

    from ..batch import Batch, Column, Schema
    from ..errors import QueryError
    from ..expr.compiler import eval_expr
    from ..expr.functions import Val

    one = torch.ones(1, dtype=torch.bool)
    carrier = Val(one, one, T.BOOLEAN)
    try:
        v = eval_expr(e, [carrier])
    except NotImplementedError as exc:
        # an engine limitation, not a user error — say so
        raise NotImplementedError(
            f"cannot evaluate VALUES cell {e!r}: {exc}")
    if v.err is not None:
        code = int(v.err.max())
        if code:
            raise QueryError(code)
    mask = torch.ones(v.valid.shape[0], dtype=torch.bool)
    b = Batch(Schema([("c", e.type)]),
              [Column(e.type, v.data, v.valid, v.dictionary)], mask)
    out = b.to_pylist()[0][0]
    # plan nodes are hashable dataclasses: array values ride as tuples
    return tuple(out) if isinstance(out, list) else out


def plan_query(query: A.Query, session: Session) -> LogicalPlan:
    planner = _Planner(session)
    root = planner.plan_root(query)
    return LogicalPlan(root, planner.init_plans)


class _Planner:
    def __init__(self, session: Session):
        self.session = session
        self.ctes: Dict[str, PlanNode] = {}
        self.init_plans: List[PlanNode] = []
        self._ids = itertools.count()
        self._view_stack: List[Tuple[str, str, str]] = []

    # -- entry ---------------------------------------------------------------
    def plan_root(self, query: A.Query) -> OutputNode:
        node = self.plan_query_node(query)
        if isinstance(node, OutputNode):
            return node
        return OutputNode(child=node, fields=node.fields)

    def plan_query_node(self, query: A.Query) -> PlanNode:
        saved = dict(self.ctes)
        try:
            for name, cte_q in query.with_:
                cte_plan = self.plan_query_node(cte_q)
                # alias fields with the CTE name
                self.ctes[name] = _realias(cte_plan, name)
            return self.plan_body(query.body)
        finally:
            self.ctes = saved

    def plan_body(self, body: A.Node) -> PlanNode:
        if isinstance(body, A.QuerySpecification):
            return self.plan_query_spec(body)
        if isinstance(body, A.SetOperation):
            return self.plan_set_op(body)
        if isinstance(body, A.Query):   # parenthesized query term
            return self.plan_query_node(body)
        if isinstance(body, A.ValuesQuery):
            return self.plan_values(body)
        raise AnalysisError(f"unsupported query body {type(body).__name__}")

    def plan_values(self, v: A.ValuesQuery) -> PlanNode:
        """VALUES rows -> ValuesNode: cells analyze in an empty scope and
        must fold to constants (reference sql/tree/Values.java + the
        analyzer's row-type derivation)."""
        if not v.rows:
            raise AnalysisError("VALUES needs at least one row")
        n_cols = len(v.rows[0])
        analyzer = ExpressionAnalyzer(Scope(()))
        cells: List[List[ir.Expr]] = []
        for row in v.rows:
            if len(row) != n_cols:
                raise AnalysisError("VALUES rows differ in arity")
            cells.append([analyzer.analyze(e) for e in row])
        col_types: List[T.Type] = []
        for c in range(n_cols):
            t: T.Type = T.UNKNOWN
            for row in cells:
                nxt = T.common_super_type(t, row[c].type)
                if nxt is None:
                    raise AnalysisError(
                        f"VALUES column {c + 1} has incompatible types")
                t = nxt
            col_types.append(t)
        out_rows = []
        for row in cells:
            vals = []
            for c in range(n_cols):
                vals.append(_const_value(coerce(row[c], col_types[c])))
            out_rows.append(tuple(vals))
        fields = tuple(Field(f"_col{c}", col_types[c])
                       for c in range(n_cols))
        return ValuesNode(fields=fields, rows=tuple(out_rows))

    def plan_set_op(self, op: A.SetOperation) -> PlanNode:
        left = self.plan_body(op.left)
        right = self.plan_body(op.right)
        if len(left.fields) != len(right.fields):
            raise AnalysisError(
                f"{op.op.upper()} inputs have different column counts")
        # coerce each side to common types
        out_fields = []
        for lf, rf in zip(left.fields, right.fields):
            t = T.common_super_type(lf.type, rf.type)
            if t is None:
                raise AnalysisError(
                    f"{op.op.upper()} column {lf.name}: incompatible types "
                    f"{lf.type.display()} vs {rf.type.display()}")
            out_fields.append(Field(lf.name, t))
        left = _coerce_to(left, [f.type for f in out_fields])
        right = _coerce_to(right, [f.type for f in out_fields])
        if op.op == "union":
            node: PlanNode = UnionNode(
                children_=(left, right), fields=tuple(out_fields),
                distinct=op.distinct)
            if op.distinct:
                node = DistinctNode(child=node)
        else:
            node = self._plan_intersect_except(op, left, right, out_fields)
        if op.order_by:
            scope = Scope(node.fields)
            keys = self._sort_keys(op.order_by, node, scope, {})
            if op.limit is not None:
                return TopNNode(child=node, keys=tuple(keys), count=op.limit)
            node = SortNode(child=node, keys=tuple(keys))
        if op.limit is not None:
            node = LimitNode(child=node, count=op.limit)
        return node

    def _plan_intersect_except(self, op: A.SetOperation, left: PlanNode,
                               right: PlanNode,
                               out_fields: List[Field]) -> PlanNode:
        """Lower INTERSECT/EXCEPT to union-all + marker aggregation
        (reference iterative/rule/ImplementIntersectAsUnion.java,
        ImplementExceptAsUnion.java): tag each source's rows with
        per-source presence markers, union, count markers per distinct
        row value, then keep rows by marker counts."""
        if not op.distinct:
            raise AnalysisError(
                f"{op.op.upper()} ALL is not supported")
        n = len(out_fields)
        m1 = Field("$m1", T.BIGINT)
        m2 = Field("$m2", T.BIGINT)

        def tagged(side: PlanNode, first: int) -> PlanNode:
            exprs = [ir.input_ref(i, f.type)
                     for i, f in enumerate(out_fields)]
            exprs.append(ir.lit(first, T.BIGINT))
            exprs.append(ir.lit(1 - first, T.BIGINT))
            return ProjectNode(child=side, exprs=tuple(exprs),
                               fields=tuple(out_fields) + (m1, m2))

        u = UnionNode(children_=(tagged(left, 1), tagged(right, 0)),
                      fields=tuple(out_fields) + (m1, m2), distinct=False)
        agg = AggregationNode(
            child=u, group_indices=tuple(range(n)),
            aggs=(PlanAgg("sum", n, T.BIGINT, "$c1"),
                  PlanAgg("sum", n + 1, T.BIGINT, "$c2")),
            fields=tuple(out_fields) + (Field("$c1", T.BIGINT),
                                        Field("$c2", T.BIGINT)))
        zero = ir.lit(0, T.BIGINT)
        in_left = ir.call("gt", T.BOOLEAN,
                          ir.input_ref(n, T.BIGINT), zero)
        if op.op == "intersect":
            in_right = ir.call("gt", T.BOOLEAN,
                               ir.input_ref(n + 1, T.BIGINT), zero)
        else:     # except
            in_right = ir.call("eq", T.BOOLEAN,
                               ir.input_ref(n + 1, T.BIGINT), zero)
        from ..expr.rewrite import combine_conjuncts
        filt = FilterNode(child=agg,
                          predicate=combine_conjuncts([in_left, in_right]))
        return ProjectNode(
            child=filt,
            exprs=tuple(ir.input_ref(i, f.type)
                        for i, f in enumerate(out_fields)),
            fields=tuple(out_fields))

    # -- relations -----------------------------------------------------------
    def plan_relation(self, rel: A.Relation) -> PlanNode:
        if isinstance(rel, A.Table):
            return self.plan_table(rel)
        if isinstance(rel, A.AliasedRelation):
            inner = self.plan_relation(rel.relation)
            return _realias(inner, rel.alias, rel.column_names)
        if isinstance(rel, A.SubqueryRelation):
            return self.plan_query_node(rel.query)
        if isinstance(rel, A.Join):
            return self.plan_join(rel)
        if isinstance(rel, A.Unnest):
            # standalone FROM UNNEST(...): expand over a one-row input
            return self.plan_unnest(
                ValuesNode(fields=(), rows=((),)), rel, None, ())
        raise AnalysisError(f"unsupported relation {type(rel).__name__}")

    def plan_unnest(self, left: PlanNode, un: A.Unnest,
                    alias: Optional[str],
                    col_names: Tuple[str, ...]) -> PlanNode:
        """Lateral UNNEST: expressions resolve against the relations to
        the LEFT in the FROM list (reference RelationPlanner.visitUnnest +
        plan/UnnestNode.java)."""
        from .plan import UnnestNode
        scope = Scope(left.fields)
        analyzer = ExpressionAnalyzer(scope)
        exprs = []
        elem_fields: List[Field] = []
        for i, e in enumerate(un.exprs):
            x = analyzer.analyze(e)
            if not isinstance(x.type, T.ArrayType):
                raise AnalysisError("UNNEST argument must be an array")
            exprs.append(x)
            name = col_names[len(elem_fields)] \
                if len(elem_fields) < len(col_names) else f"_unnest{i}"
            elem_fields.append(Field(name, x.type.element,
                                     relation=alias or ""))
        if un.ordinality:
            name = col_names[len(elem_fields)] \
                if len(elem_fields) < len(col_names) else "ordinality"
            elem_fields.append(Field(name, T.BIGINT, relation=alias or ""))
        fields = tuple(left.fields) + tuple(elem_fields)
        return UnnestNode(child=left, exprs=tuple(exprs),
                          ordinality=un.ordinality, fields=fields)

    def plan_table(self, rel: A.Table) -> PlanNode:
        name = rel.name
        if len(name) == 1 and name[0] in self.ctes:
            return self.ctes[name[0]]
        if len(name) == 1:
            catalog, schema, table = (self.session.catalog,
                                      self.session.schema, name[0])
        elif len(name) == 2:
            if (self.session.catalogs.exists(name[0])
                    and not _schema_exists(self.session, name[0])):
                # the qualifier names a mounted catalog AND no schema of
                # the session catalog shadows it: resolve catalog-first
                # (catalog.table in its default schema) — same rule as
                # the write path (_writable), so the same name reads and
                # writes one table
                catalog, schema, table = name[0], "default", name[1]
            else:
                # reference semantics (StatementAnalyzer name
                # resolution): x.y is schema x in the session catalog
                catalog, schema, table = (self.session.catalog, name[0],
                                          name[1])
        else:
            catalog, schema, table = name[-3], name[-2], name[-1]
        view_key = (catalog, schema, table)
        view = self.session.views.get(view_key)
        if view is not None:
            # view expansion (reference StatementAnalyzer view handling):
            # plan the stored query, alias columns under the view name
            if view_key in self._view_stack:
                raise AnalysisError(
                    f"view {'.'.join(view_key)} is recursive")
            self._view_stack.append(view_key)
            # the view body resolves names in ITS OWN scope: the caller's
            # WITH aliases must not capture tables inside the view
            outer_ctes, self.ctes = self.ctes, {}
            try:
                inner = self.plan_query_node(view)
            finally:
                self.ctes = outer_ctes
                self._view_stack.pop()
            return _realias(inner, table, ())
        conn = self.session.catalogs.get(catalog)
        handle = TableHandle(catalog, schema, table)
        table_schema = conn.metadata.table_schema(handle)
        fields = tuple(
            Field(f.name, f.type, relation=table) for f in table_schema.fields)
        return TableScanNode(
            catalog=catalog, table=handle,
            columns=tuple(table_schema.names), fields=fields)

    def plan_join(self, rel: A.Join) -> PlanNode:
        left = self.plan_relation(rel.left)
        # lateral UNNEST as the right side of an (implicit) cross join
        right_rel, un_alias, un_cols = rel.right, None, ()
        if isinstance(right_rel, A.AliasedRelation) \
                and isinstance(right_rel.relation, A.Unnest):
            un_alias, un_cols = right_rel.alias, right_rel.column_names
            right_rel = right_rel.relation
        if isinstance(right_rel, A.Unnest):
            if rel.join_type not in ("cross", "implicit"):
                raise AnalysisError(
                    "UNNEST only joins as CROSS JOIN / FROM-list item")
            return self.plan_unnest(left, right_rel, un_alias, un_cols)
        right = self.plan_relation(rel.right)
        combined = left.fields + right.fields
        if rel.join_type in ("cross", "implicit"):
            return JoinNode(
                join_type="cross", left=left, right=right,
                left_keys=(), right_keys=(), fields=combined)
        join_type = rel.join_type
        swapped = False
        if join_type == "right":
            left, right = right, left
            combined = left.fields + right.fields
            join_type = "left"
            swapped = True
        scope = Scope(combined)
        analyzer = ExpressionAnalyzer(scope)
        cond = analyzer.analyze(rel.condition) if rel.condition is not None \
            else None
        left_keys, right_keys, residual = _extract_equi_keys(
            cond, len(left.fields))
        if not left_keys:
            raise AnalysisError(
                "non-equi join conditions require at least one equality "
                "conjunct")
        if residual is not None and join_type == "left":
            # ON predicates touching only the build side filter the build
            # input (valid for LEFT: they decide matching, not probe rows)
            from ..expr.rewrite import (
                combine_conjuncts, conjuncts as split_conj, referenced_inputs,
                remap_inputs)
            n_left = len(left.fields)
            right_only, rest = [], []
            for c in split_conj(residual):
                refs = referenced_inputs(c)
                if refs and all(r >= n_left for r in refs):
                    right_only.append(
                        remap_inputs(c, {r: r - n_left for r in refs}))
                else:
                    rest.append(c)
            if right_only:
                right = FilterNode(child=right,
                                   predicate=combine_conjuncts(right_only))
            residual = combine_conjuncts(rest)
        # RIGHT was swapped above (key sides were extracted against the
        # swapped order, since the scope was built after the swap); restore
        # the WRITTEN column order for parents per SQL semantics
        node: PlanNode = JoinNode(
            join_type=join_type, left=left, right=right,
            left_keys=tuple(left_keys), right_keys=tuple(right_keys),
            fields=combined, residual=residual)
        if swapped:
            n_probe = len(left.fields)
            order = list(range(n_probe, len(combined))) + list(range(n_probe))
            node = ProjectNode(
                child=node,
                exprs=tuple(ir.input_ref(i, combined[i].type) for i in order),
                fields=tuple(combined[i] for i in order))
        return node

    # -- SELECT decomposition -----------------------------------------------
    def plan_query_spec(self, spec: A.QuerySpecification) -> PlanNode:
        spec = self._decorrelate_scalar_aggs(spec)
        if spec.from_ is not None:
            node = self.plan_relation(spec.from_)
        else:
            node = ValuesNode(fields=(), rows=((),))
        scope = Scope(node.fields)

        # WHERE: plain conjuncts filter first (directly above the join tree
        # so the optimizer's join-graph pass sees them), then subquery
        # conjuncts become semi joins above the filter
        if spec.where is not None:
            subquery_conjs, where = _split_subquery_conjuncts(spec.where)
            if where is not None:
                analyzer = ExpressionAnalyzer(scope)
                node = FilterNode(
                    child=node,
                    predicate=self._analyze_with_subqueries(where, analyzer))
            for kind, value, query, negated in subquery_conjs:
                if kind == "in":
                    node = self._plan_semi_join(node, value, query, negated)
                else:
                    node = self._plan_exists(node, query, negated)
            scope = Scope(node.fields)

        select_items = self._expand_stars(spec.select, scope)
        agg_calls = _collect_aggs(
            [it.value for it in select_items]
            + ([spec.having] if spec.having else [])
            + [s.key for s in spec.order_by])
        window_calls = _collect_windows(
            [it.value for it in select_items] + [s.key for s in spec.order_by])

        if agg_calls or spec.group_by:
            node, replacements = self._plan_aggregation(
                node, scope, spec, select_items, agg_calls)
            scope = Scope(node.fields)
        else:
            replacements = {}
        if window_calls:
            # windows over aggregated queries evaluate AFTER grouping
            # (reference QueryPlanner.window over the aggregation plan):
            # the agg replacements map sum(x)-style window inputs to the
            # aggregation's output columns
            node, win_repl = self._plan_windows(node, scope, window_calls,
                                                replacements)
            scope = Scope(node.fields)
            replacements.update(win_repl)

        # HAVING (after aggregation)
        if spec.having is not None:
            analyzer = ExpressionAnalyzer(scope, replacements)
            node = FilterNode(
                child=node,
                predicate=self._analyze_with_subqueries(spec.having, analyzer))

        # SELECT projection (+ hidden sort keys)
        analyzer = ExpressionAnalyzer(scope, replacements)
        out_exprs: List[ir.Expr] = []
        out_fields: List[Field] = []
        for i, item in enumerate(select_items):
            e = self._analyze_with_subqueries(item.value, analyzer)
            name = item.alias or _derive_name(item.value, i)
            out_exprs.append(e)
            out_fields.append(Field(name, e.type))
        project = ProjectNode(child=node, exprs=tuple(out_exprs),
                              fields=tuple(out_fields))

        result: PlanNode = project
        if spec.distinct:
            result = DistinctNode(child=result)

        if spec.order_by:
            out_scope = Scope(result.fields)
            keys, result = self._sort_keys_with_hidden(
                spec.order_by, result, out_scope, select_items, analyzer)
            if spec.limit is not None and not spec.distinct:
                result = TopNNode(child=result, keys=tuple(keys),
                                  count=spec.limit)
            else:
                result = SortNode(child=result, keys=tuple(keys))
                if spec.limit is not None:
                    result = LimitNode(child=result, count=spec.limit)
        elif spec.limit is not None:
            result = LimitNode(child=result, count=spec.limit)

        # drop hidden sort columns if any were added
        if len(result.fields) > len(out_fields):
            keep = list(range(len(out_fields)))
            result = ProjectNode(
                child=result,
                exprs=tuple(ir.input_ref(i, result.fields[i].type)
                            for i in keep),
                fields=tuple(result.fields[i] for i in keep))
        return result

    # -- subqueries -----------------------------------------------------------
    def _plan_semi_join(self, source: PlanNode, value: A.Expression,
                        query: A.Query, negated: bool) -> PlanNode:
        filtering = self.plan_query_node(query)
        if len(filtering.fields) != 1:
            raise AnalysisError("IN subquery must return one column")
        analyzer = ExpressionAnalyzer(Scope(source.fields))
        key = analyzer.analyze(value)
        if not isinstance(key, ir.InputRef):
            # project the key expression as a hidden column
            exprs = tuple(
                ir.input_ref(i, f.type)
                for i, f in enumerate(source.fields)) + (key,)
            fields = source.fields + (Field("$semikey", key.type),)
            source = ProjectNode(child=source, exprs=exprs, fields=fields)
            key_index = len(fields) - 1
        else:
            key_index = key.index
        node: PlanNode = SemiJoinNode(
            source=source, filtering=filtering, source_keys=(key_index,),
            filtering_keys=(0,), fields=source.fields, negated=negated)
        if source.fields and source.fields[-1].name == "$semikey":
            keep = list(range(len(source.fields) - 1))
            node = ProjectNode(
                child=node,
                exprs=tuple(ir.input_ref(i, source.fields[i].type)
                            for i in keep),
                fields=tuple(source.fields[i] for i in keep))
        return node

    def _plan_exists(self, source: PlanNode, query: A.Query,
                     negated: bool) -> PlanNode:
        """Decorrelate [NOT] EXISTS into a semi/anti join: correlated
        equality conjuncts become join keys, inner-only conjuncts filter
        the filtering side, any other correlated conjunct becomes the
        join's residual (mark-join; reference iterative/rule/
        TransformExistsApplyToCorrelatedJoin.java)."""
        body = query.body
        if query.with_ or not isinstance(body, A.QuerySpecification):
            raise AnalysisError("unsupported EXISTS subquery shape")
        if body.group_by or body.having or body.limit is not None \
                or body.from_ is None:
            raise AnalysisError("unsupported EXISTS subquery shape")
        if _collect_aggs([it.value for it in body.select
                          if not isinstance(it.value, A.Star)]):
            # an ungrouped aggregate subquery always returns exactly one
            # row, so EXISTS over it is constant TRUE — not a semi join
            raise AnalysisError(
                "EXISTS over an aggregate subquery is not supported")
        inner = self.plan_relation(body.from_)
        inner_scope = Scope(inner.fields)
        outer_scope = Scope(source.fields)
        combined_scope = Scope(source.fields + inner.fields)

        inner_filters: List[ir.Expr] = []
        skeys: List[int] = []
        fkeys: List[int] = []
        residuals: List[ir.Expr] = []
        conjs = _split_conjuncts(body.where) if body.where is not None else []
        for c in conjs:
            try:
                inner_filters.append(
                    ExpressionAnalyzer(inner_scope).analyze(c))
                continue
            except AnalysisError:
                pass
            pair = None
            if isinstance(c, A.Comparison) and c.op == "=":
                for o_ast, i_ast in ((c.left, c.right), (c.right, c.left)):
                    try:
                        oe = ExpressionAnalyzer(outer_scope).analyze(o_ast)
                        ie = ExpressionAnalyzer(inner_scope).analyze(i_ast)
                    except AnalysisError:
                        continue
                    if isinstance(oe, ir.InputRef) and isinstance(
                            ie, ir.InputRef):
                        pair = (oe.index, ie.index)
                        break
            if pair is not None:
                skeys.append(pair[0])
                fkeys.append(pair[1])
            else:
                # general correlated conjunct -> residual over
                # (source fields, filtering fields)
                residuals.append(
                    ExpressionAnalyzer(combined_scope).analyze(c))
        if not skeys:
            raise AnalysisError(
                "EXISTS must correlate on at least one equality")
        if len(skeys) > 2:
            raise AnalysisError("EXISTS on >2 correlation keys")
        from ..expr.rewrite import combine_conjuncts
        filtering: PlanNode = inner
        if inner_filters:
            filtering = FilterNode(child=inner,
                                   predicate=combine_conjuncts(inner_filters))
        residual = combine_conjuncts(residuals) if residuals else None
        return SemiJoinNode(
            source=source, filtering=filtering, source_keys=tuple(skeys),
            filtering_keys=tuple(fkeys), fields=source.fields,
            negated=negated, residual=residual, null_aware=False)

    # -- correlated scalar aggregates (AST pre-pass) --------------------------
    def _decorrelate_scalar_aggs(
            self, spec: A.QuerySpecification) -> A.QuerySpecification:
        """Rewrite `expr CMP (SELECT agg(..) FROM t WHERE t.k = outer.k
        AND ..)` conjuncts into a LEFT JOIN against a grouped derived table
        (reference iterative/rule/
        TransformCorrelatedScalarAggregationToJoin.java). Missing groups
        yield NULL, which fails the comparison — exactly the scalar
        subquery's empty-result semantics for min/max/sum/avg (count is
        rejected: empty groups must yield 0, which a join cannot)."""
        if spec.where is None or spec.from_ is None:
            return spec
        conjs = _split_conjuncts(spec.where)
        if not any(_find_scalar_subqueries(c) for c in conjs):
            return spec
        outer_scope: Optional[Scope] = None
        new_from = spec.from_
        new_conjs: List[A.Expression] = []
        changed = False
        for c in conjs:
            subs = _find_scalar_subqueries(c)
            if len(subs) != 1 or not self._is_correlated(subs[0].query):
                new_conjs.append(c)
                continue
            sub = subs[0]
            body = sub.query.body
            if (sub.query.with_ or not isinstance(body, A.QuerySpecification)
                    or body.group_by or body.having
                    or body.limit is not None or len(body.select) != 1
                    or body.from_ is None):
                raise AnalysisError("unsupported correlated subquery shape")
            value_expr = body.select[0].value
            if any(_FUNCTION_ALIASES.get(a.name, a.name) == "count"
                   for a in _collect_aggs([value_expr])):
                raise AnalysisError(
                    "correlated count() subquery is not supported yet")
            if not _collect_aggs([value_expr]):
                raise AnalysisError(
                    "correlated non-aggregate subquery is not supported yet")
            if outer_scope is None:
                saved = list(self.init_plans)
                outer_scope = Scope(self.plan_relation(spec.from_).fields)
                self.init_plans = saved
            saved = list(self.init_plans)
            inner_scope = Scope(self.plan_relation(body.from_).fields)
            self.init_plans = saved
            inner_only: List[A.Expression] = []
            corr_pairs: List[Tuple[A.Expression, A.Expression]] = []
            for ic in (_split_conjuncts(body.where)
                       if body.where is not None else []):
                try:
                    ExpressionAnalyzer(inner_scope).analyze(ic)
                    inner_only.append(ic)
                    continue
                except AnalysisError:
                    pass
                pair = None
                if isinstance(ic, A.Comparison) and ic.op == "=":
                    for o_ast, i_ast in ((ic.left, ic.right),
                                         (ic.right, ic.left)):
                        try:
                            ExpressionAnalyzer(outer_scope).analyze(o_ast)
                            ExpressionAnalyzer(inner_scope).analyze(i_ast)
                            pair = (o_ast, i_ast)
                            break
                        except AnalysisError:
                            continue
                if pair is None:
                    raise AnalysisError(
                        "cannot decorrelate subquery predicate")
                corr_pairs.append(pair)
            if not corr_pairs:
                raise AnalysisError("cannot decorrelate subquery")
            n = next(self._ids)
            alias = f"__corr{n}"
            knames = [f"__ck{i}" for i in range(len(corr_pairs))]
            vname = "__cv"
            derived_spec = A.QuerySpecification(
                select=tuple(
                    A.SelectItem(i_ast, kn)
                    for (_, i_ast), kn in zip(corr_pairs, knames)
                ) + (A.SelectItem(value_expr, vname),),
                from_=body.from_,
                where=_and_all(inner_only),
                group_by=tuple(i_ast for (_, i_ast) in corr_pairs))
            derived = A.AliasedRelation(
                A.SubqueryRelation(A.Query(body=derived_spec)),
                alias, tuple(knames) + (vname,))
            on = _and_all([
                A.Comparison("=", o_ast,
                             A.DereferenceExpression(
                                 A.Identifier(alias), A.Identifier(kn)))
                for (o_ast, _), kn in zip(corr_pairs, knames)])
            new_from = A.Join("left", new_from, derived, on)
            new_conjs.append(_replace_node(
                c, sub,
                A.DereferenceExpression(A.Identifier(alias),
                                        A.Identifier(vname))))
            changed = True
        if not changed:
            return spec
        return dataclasses.replace(spec, from_=new_from,
                                   where=_and_all(new_conjs))

    def _is_correlated(self, query: A.Query) -> bool:
        """A subquery is correlated iff standalone planning fails on an
        UNRESOLVED COLUMN specifically — any other failure is a genuine
        error in the subquery and must surface as-is, not be misreported
        as a decorrelation failure."""
        saved_init = list(self.init_plans)
        saved_ctes = dict(self.ctes)
        try:
            self.plan_query_node(query)
            return False
        except UnresolvedColumnError:
            return True
        finally:
            self.init_plans = saved_init
            self.ctes = saved_ctes

    def _analyze_with_subqueries(self, expr: A.Expression,
                                 analyzer: ExpressionAnalyzer) -> ir.Expr:
        """Lower an expression, turning uncorrelated scalar subqueries into
        init-plan literal placeholders."""
        rewritten = self._rewrite_scalar_subqueries(expr, analyzer)
        return analyzer.analyze(rewritten)

    def _rewrite_scalar_subqueries(self, expr: A.Expression,
                                   analyzer: ExpressionAnalyzer):
        if isinstance(expr, A.ScalarSubquery):
            sub = self.plan_query_node(expr.query)
            if len(sub.fields) != 1:
                raise AnalysisError("scalar subquery must return one column")
            idx = len(self.init_plans)
            self.init_plans.append(sub)
            placeholder = ir.lit(InitPlanRef(idx), sub.fields[0].type)
            # stash under a synthetic replacement key
            analyzer.replacements[expr] = placeholder
            return expr
        for child_name in ("left", "right", "value", "min", "max", "first",
                           "second", "operand", "default"):
            child = getattr(expr, child_name, None)
            if isinstance(child, A.Expression):
                self._rewrite_scalar_subqueries(child, analyzer)
        for seq_name in ("args", "items", "whens"):
            seq = getattr(expr, seq_name, None)
            if seq:
                for c in seq:
                    if isinstance(c, A.WhenClause):
                        self._rewrite_scalar_subqueries(c.condition, analyzer)
                        self._rewrite_scalar_subqueries(c.result, analyzer)
                    elif isinstance(c, A.Expression):
                        self._rewrite_scalar_subqueries(c, analyzer)
        return expr

    # -- aggregation ----------------------------------------------------------
    def _plan_aggregation(self, node: PlanNode, scope: Scope,
                          spec: A.QuerySpecification,
                          select_items: Sequence[A.SelectItem],
                          agg_calls: List[A.FunctionCall]):
        analyzer = ExpressionAnalyzer(scope)
        # group keys (ordinals supported)
        group_exprs: List[A.Expression] = []
        for g in spec.group_by:
            if isinstance(g, A.LongLiteral):
                ordinal = g.value
                if not (1 <= ordinal <= len(select_items)):
                    raise AnalysisError(f"GROUP BY ordinal {ordinal} out of range")
                group_exprs.append(select_items[ordinal - 1].value)
            else:
                group_exprs.append(g)

        pre_exprs: List[ir.Expr] = []
        pre_fields: List[Field] = []
        for i, g in enumerate(group_exprs):
            e = analyzer.analyze(g)
            name = _derive_name(g, i)
            pre_exprs.append(e)
            pre_fields.append(Field(name, e.type))

        aggs: List[PlanAgg] = []
        agg_fields: List[Field] = []
        # dedupe structurally identical aggregate calls
        seen: Dict[A.FunctionCall, int] = {}
        uniq_aggs: List[A.FunctionCall] = []
        for call in agg_calls:
            if call not in seen:
                seen[call] = len(uniq_aggs)
                uniq_aggs.append(call)
        for j, call in enumerate(uniq_aggs):
            fn = _FUNCTION_ALIASES.get(call.name, call.name)
            distinct = call.distinct
            if fn == "approx_distinct" and group_exprs:
                # grouped approx_distinct: HLL registers are a dense
                # [groups, m] tile on device, so an unbounded group count
                # would be unbounded state; without tight group-domain
                # statistics the engine keeps the EXACT lowering (a
                # strictly tighter error bound; the reference's sketch
                # exists to bound per-group memory, which the sort-based
                # mark-distinct path bounds differently).  The global
                # form below carries real bounded HLL state through
                # partial -> exchange -> final.
                if len(call.args) == 2:
                    # validate-and-drop the standard-error argument: the
                    # exact lowering satisfies any error bound
                    _parse_approx_distinct_error(analyzer, call)
                    call = dataclasses.replace(call,
                                               args=(call.args[0],))
                elif len(call.args) != 1:
                    raise AnalysisError(
                        "approx_distinct takes one or two arguments")
                fn, distinct = "count", True
            # ARBITRARY allows any live value; max picks one branch-free
            if fn in ("any_value", "arbitrary"):
                fn = "max"
            if fn not in ("count", "sum", "avg", "min", "max", "var_samp",
                          "var_pop", "stddev_samp", "stddev_pop",
                          "bool_and", "bool_or", "approx_percentile",
                          "approx_distinct"):
                raise AnalysisError(f"aggregate {fn}() not supported yet")
            if call.is_star or not call.args:
                if fn != "count":
                    raise AnalysisError(f"{fn}(*) is not valid")
                aggs.append(PlanAgg("count_star", None, T.BIGINT,
                                    f"_agg{j}", distinct=False))
                agg_fields.append(Field(f"_agg{j}", T.BIGINT))
                continue
            param = None
            if fn == "approx_distinct":
                # approx_distinct(x[, e]): bounded-memory HLL sketch with
                # standard error e (reference
                # ApproximateCountDistinctAggregations.java); state =
                # one register vector, mergeable across exchanges
                if len(call.args) == 2:
                    param = _parse_approx_distinct_error(analyzer, call)
                elif len(call.args) != 1:
                    raise AnalysisError(
                        "approx_distinct takes one or two arguments")
                arg = analyzer.analyze(call.args[0])
                arg_index = len(pre_exprs)
                pre_exprs.append(arg)
                pre_fields.append(Field(f"_aggarg{j}", arg.type))
                aggs.append(PlanAgg(fn, arg_index, T.BIGINT, f"_agg{j}",
                                    distinct=False, param=param))
                agg_fields.append(Field(f"_agg{j}", T.BIGINT))
                continue
            if fn == "approx_percentile":
                # approx_percentile(x, p): p must be a constant in [0, 1]
                # (reference ApproximateLongPercentileAggregations)
                if len(call.args) != 2:
                    raise AnalysisError(
                        "approx_percentile(x, p) takes two arguments "
                        "(the weighted form is not supported)")
                p_expr = analyzer.analyze(call.args[1])
                if not isinstance(p_expr, ir.Literal) \
                        or p_expr.value is None:
                    raise AnalysisError(
                        "approx_percentile percentage must be a constant")
                param = float(p_expr.value)
                if not 0.0 <= param <= 1.0:
                    raise AnalysisError(
                        "percentile must be between 0 and 1")
            elif len(call.args) != 1:
                raise AnalysisError(f"{fn}() takes one argument")
            arg = analyzer.analyze(call.args[0])
            arg_index = len(pre_exprs)
            pre_exprs.append(arg)
            pre_fields.append(Field(f"_aggarg{j}", arg.type))
            out_t = _agg_output_type(fn, arg.type)
            aggs.append(PlanAgg(fn, arg_index, out_t, f"_agg{j}",
                                distinct=distinct, param=param))
            agg_fields.append(Field(f"_agg{j}", out_t))

        pre = ProjectNode(child=node, exprs=tuple(pre_exprs),
                          fields=tuple(pre_fields))
        out_fields = tuple(pre_fields[:len(group_exprs)]) + tuple(agg_fields)
        nk = len(group_exprs)
        if spec.grouping_sets is not None:
            return self._plan_grouping_sets(
                spec, pre, pre_fields, nk, aggs, agg_fields, group_exprs,
                select_items, seen)
        if any(a.distinct for a in aggs):
            args = {a.arg for a in aggs}
            if all(a.distinct for a in aggs) and len(args) == 1 \
                    and None not in args:
                # all-distinct, one argument: distinct rows of
                # (keys, arg) first, then plain aggregation (reference
                # iterative/rule/SingleDistinctAggregationToGroupBy.java)
                arg0 = aggs[0].arg
                sel = list(range(nk)) + [arg0]
                dproj = ProjectNode(
                    child=pre,
                    exprs=tuple(ir.input_ref(i, pre_fields[i].type)
                                for i in sel),
                    fields=tuple(pre_fields[i] for i in sel))
                dnode = DistinctNode(child=dproj)
                aggs = [dataclasses.replace(a, arg=nk, distinct=False)
                        for a in aggs]
                agg_node = AggregationNode(
                    child=dnode, group_indices=tuple(range(nk)),
                    aggs=tuple(aggs), fields=out_fields)
            else:
                # mixed / multi-argument: one MarkDistinct mask channel
                # per distinct argument (reference MarkDistinctNode +
                # AggregationNode mask symbols via
                # rule/MultipleDistinctAggregationToMarkDistinct.java)
                from .plan import MarkDistinctNode
                if any(a.distinct and a.arg is None for a in aggs):
                    raise AnalysisError(
                        "count(DISTINCT *) is not valid")
                child: PlanNode = pre
                fields = list(pre_fields)
                mask_idx: Dict[int, int] = {}
                for arg in sorted({a.arg for a in aggs if a.distinct}):
                    mark = Field(f"$distinct{arg}", T.BOOLEAN)
                    child = MarkDistinctNode(
                        child=child,
                        cols=tuple(range(nk)) + (arg,),
                        partition_cols=tuple(range(nk)),
                        fields=tuple(fields) + (mark,))
                    mask_idx[arg] = len(fields)
                    fields.append(mark)
                aggs = [dataclasses.replace(a, distinct=False,
                                            mask=mask_idx[a.arg])
                        if a.distinct else a for a in aggs]
                agg_node = AggregationNode(
                    child=child, group_indices=tuple(range(nk)),
                    aggs=tuple(aggs), fields=out_fields)
        else:
            agg_node = AggregationNode(
                child=pre, group_indices=tuple(range(nk)),
                aggs=tuple(aggs), fields=out_fields)

        replacements: Dict[A.Expression, ir.Expr] = {}
        for i, g in enumerate(group_exprs):
            replacements[g] = ir.input_ref(i, pre_fields[i].type)
        for call, j in seen.items():
            replacements[call] = ir.input_ref(
                len(group_exprs) + j, agg_fields[j].type)
        return agg_node, replacements

    def _plan_grouping_sets(self, spec, pre, pre_fields, nk, aggs,
                            agg_fields, group_exprs, select_items, seen):
        """GROUP BY ROLLUP/CUBE/GROUPING SETS, lowered single-pass via
        GroupIdNode (reference plan/GroupIdNode.java +
        operator/GroupIdOperator.java): replicate rows per grouping set
        with absent keys nulled, aggregate ONCE over (keys..., $group_id)
        — empty sets (the ROLLUP grand-total row) included, so the whole
        input pipeline runs exactly once — and compute GROUPING() values
        by SWITCH on $group_id. Empty sets' grand-total rows over EMPTY
        input come from AggregationNode.default_gids (reference
        AggregationNode.hasDefaultOutput): the executor synthesizes the
        default rows when the aggregation produced no groups."""
        from .plan import GroupIdNode, UnionNode

        if any(a.distinct for a in aggs):
            raise AnalysisError(
                "DISTINCT aggregates with grouping sets are not supported")
        grouping_calls: List[A.FunctionCall] = []
        exprs_to_scan = ([it.value for it in select_items]
                         + ([spec.having] if spec.having else [])
                         + [s.key for s in spec.order_by])
        for c in _collect_calls_named(exprs_to_scan, "grouping"):
            if c not in grouping_calls:
                grouping_calls.append(c)

        def gidx(e: A.Expression) -> int:
            for i, g in enumerate(group_exprs):
                if g == e:
                    return i
            raise AnalysisError(
                "GROUPING() arguments must be grouping columns")

        call_arg_idx = [[gidx(a) for a in c.args] for c in grouping_calls]

        def grouping_val(s: Tuple[int, ...], idxs: List[int]) -> int:
            m = len(idxs)
            return sum((0 if idxs[a] in s else 1) << (m - 1 - a)
                       for a in range(m))

        all_sets = list(spec.grouping_sets)
        nonempty = [s for s in all_sets if s]
        out_fields = (tuple(pre_fields[:nk]) + tuple(agg_fields)
                      + tuple(Field(f"_grouping{k}", T.BIGINT)
                              for k in range(len(grouping_calls))))

        branches: List[PlanNode] = []
        if nonempty:
            gid_field = Field("$group_id", T.BIGINT)
            gid_node = GroupIdNode(
                child=pre, grouping_sets=tuple(all_sets), n_keys=nk,
                fields=tuple(pre_fields) + (gid_field,))
            gid_idx = len(pre_fields)
            agg_node = AggregationNode(
                child=gid_node,
                group_indices=tuple(range(nk)) + (gid_idx,),
                aggs=tuple(aggs),
                fields=(tuple(pre_fields[:nk]) + (gid_field,)
                        + tuple(agg_fields)),
                default_gids=tuple(g for g, s in enumerate(all_sets)
                                   if not s))
            # agg layout: [keys..., $group_id, aggs...]
            exprs: List[ir.Expr] = [
                ir.input_ref(i, pre_fields[i].type) for i in range(nk)]
            exprs += [ir.input_ref(nk + 1 + j, af.type)
                      for j, af in enumerate(agg_fields)]
            gid_ref = ir.input_ref(nk, T.BIGINT)
            for idxs in call_arg_idx:
                vals = [grouping_val(s, idxs) for s in all_sets]
                if len(set(vals)) == 1:
                    exprs.append(ir.lit(vals[0], T.BIGINT))
                    continue
                ops: List[ir.Expr] = []
                for g, v in enumerate(vals[:-1]):
                    ops.append(ir.call("eq", T.BOOLEAN, gid_ref,
                                       ir.lit(g, T.BIGINT)))
                    ops.append(ir.lit(v, T.BIGINT))
                ops.append(ir.lit(vals[-1], T.BIGINT))
                exprs.append(ir.special(ir.Form.SWITCH, T.BIGINT, *ops))
            branches.append(ProjectNode(child=agg_node, exprs=tuple(exprs),
                                        fields=out_fields))
        else:
            # only empty sets (GROUPING SETS ((), ...)): plain global
            # aggregation branches, one row each
            for _ in all_sets:
                g_agg = AggregationNode(
                    child=pre, group_indices=(), aggs=tuple(aggs),
                    fields=tuple(agg_fields))
                exprs = [ir.lit(None, pre_fields[i].type)
                         for i in range(nk)]
                exprs += [ir.input_ref(j, af.type)
                          for j, af in enumerate(agg_fields)]
                for idxs in call_arg_idx:
                    exprs.append(ir.lit(grouping_val((), idxs), T.BIGINT))
                branches.append(ProjectNode(child=g_agg,
                                            exprs=tuple(exprs),
                                            fields=out_fields))

        node: PlanNode = (branches[0] if len(branches) == 1 else
                          UnionNode(children_=tuple(branches),
                                    fields=out_fields))
        replacements: Dict[A.Expression, ir.Expr] = {}
        for i, g in enumerate(group_exprs):
            replacements[g] = ir.input_ref(i, pre_fields[i].type)
        for call, j in seen.items():
            replacements[call] = ir.input_ref(nk + j, agg_fields[j].type)
        for k, c in enumerate(grouping_calls):
            replacements[c] = ir.input_ref(nk + len(agg_fields) + k,
                                           T.BIGINT)
        return node, replacements

    # -- windows --------------------------------------------------------------
    def _plan_windows(self, node: PlanNode, scope: Scope,
                      window_calls: List[A.WindowFunction],
                      agg_replacements: Optional[Dict] = None):
        """One WindowNode per distinct (PARTITION BY, ORDER BY) window;
        shared windows evaluate together (reference plan/WindowNode.java
        groups functions under one window). ``agg_replacements`` resolves
        group-aggregate subexpressions inside window specs against the
        aggregation output (windows over aggregated queries)."""
        from .plan import WindowFnSpec, WindowNode
        replacements: Dict[A.Expression, ir.Expr] = {}
        groups: Dict[Tuple, List[A.WindowFunction]] = {}
        for w in window_calls:
            groups.setdefault((w.partition_by, w.order_by), []).append(w)
        for (partition_by, order_by), wins in groups.items():
            analyzer = ExpressionAnalyzer(Scope(node.fields),
                                          agg_replacements or {})
            base = len(node.fields)
            extra_exprs: List[ir.Expr] = []
            extra_fields: List[Field] = []

            def col_of(ast_expr: A.Expression):
                e = analyzer.analyze(ast_expr)
                if isinstance(e, ir.InputRef):
                    return e.index, e.type
                extra_exprs.append(e)
                extra_fields.append(
                    Field(f"$w{base + len(extra_exprs) - 1}", e.type))
                return base + len(extra_exprs) - 1, e.type

            part_idx = [col_of(p)[0] for p in partition_by]
            okeys = [SortKeySpec(col_of(s.key)[0], s.ascending, s.nulls_first)
                     for s in order_by]
            fn_specs: List[WindowFnSpec] = []
            out_fields: List[Field] = []
            for j, w in enumerate(wins):
                spec = self._window_fn_spec(w, col_of, f"_win{j}",
                                            bool(order_by))
                if (w.frame != "range"
                        or w.frame_start != ("unbounded_preceding", 0)
                        or w.frame_end != ("current_row", 0)):
                    if (w.frame == "range"
                            and (w.frame_start[0] in ("preceding",
                                                      "following")
                                 or w.frame_end[0] in ("preceding",
                                                       "following"))):
                        if len(order_by) != 1:
                            raise AnalysisError(
                                "RANGE frames with offsets require "
                                "exactly one ORDER BY key")
                        key_t = col_of(order_by[0].key)[1]
                        if not isinstance(key_t, (
                                T.BigintType, T.IntegerType,
                                T.SmallintType, T.TinyintType,
                                T.DoubleType, T.RealType, T.DateType,
                                T.DecimalType)):
                            raise AnalysisError(
                                "RANGE frames with offsets require a "
                                "numeric or date ORDER BY key, got "
                                f"{key_t.display()}")
                    spec = dataclasses.replace(
                        spec, frame=w.frame, frame_start=w.frame_start,
                        frame_end=w.frame_end)
                fn_specs.append(spec)
                out_fields.append(Field(spec.name, spec.output_type))
            if extra_exprs:
                exprs = tuple(ir.input_ref(i, f.type)
                              for i, f in enumerate(node.fields)
                              ) + tuple(extra_exprs)
                fields = node.fields + tuple(extra_fields)
                node = ProjectNode(child=node, exprs=exprs, fields=fields)
            win_out = node.fields + tuple(out_fields)
            node = WindowNode(
                child=node, partition_indices=tuple(part_idx),
                order_keys=tuple(okeys), functions=tuple(fn_specs),
                fields=win_out)
            for j, w in enumerate(wins):
                replacements[w] = ir.input_ref(
                    len(node.fields) - len(wins) + j,
                    fn_specs[j].output_type)
        return node, replacements

    def _window_fn_spec(self, w: A.WindowFunction, col_of, name: str,
                        has_order: bool):
        from .plan import WindowFnSpec
        call = w.call
        fn = _FUNCTION_ALIASES.get(call.name, call.name)
        if fn in ("rank", "dense_rank", "row_number", "percent_rank",
                  "cume_dist") and not has_order:
            raise AnalysisError(f"{fn}() requires window ORDER BY")
        offset = 1
        args: List[int] = []
        if fn == "ntile":
            if len(call.args) != 1 or not isinstance(call.args[0],
                                                     A.LongLiteral):
                raise AnalysisError("ntile(n) takes a literal bucket count")
            offset = call.args[0].value
            return WindowFnSpec("ntile", (), T.BIGINT, name, offset)
        if fn in ("row_number", "rank", "dense_rank"):
            return WindowFnSpec(fn, (), T.BIGINT, name)
        if fn in ("percent_rank", "cume_dist"):
            return WindowFnSpec(fn, (), T.DOUBLE, name)
        if fn in ("lag", "lead", "nth_value"):
            if not call.args:
                raise AnalysisError(f"{fn}() needs an argument")
            arg, arg_t = col_of(call.args[0])
            if len(call.args) > 1:
                if not isinstance(call.args[1], A.LongLiteral):
                    raise AnalysisError(f"{fn} offset must be a literal")
                offset = call.args[1].value
            if len(call.args) > 2:
                raise AnalysisError(
                    f"{fn} default argument is not supported yet")
            return WindowFnSpec(fn, (arg,), arg_t, name, offset)
        if fn in ("first_value", "last_value"):
            arg, arg_t = col_of(call.args[0])
            return WindowFnSpec(fn, (arg,), arg_t, name)
        if fn in ("count",) and (call.is_star or not call.args):
            return WindowFnSpec("count_star", (), T.BIGINT, name,
                                ignore_order=not has_order)
        if fn in ("sum", "avg", "min", "max", "count"):
            arg, arg_t = col_of(call.args[0])
            if isinstance(arg_t, T.DecimalType) and arg_t.is_long:
                raise AnalysisError(
                    "window aggregates over decimal(>18) are not "
                    "supported yet (cast to decimal(18,s) or double)")
            if fn == "sum" and isinstance(arg_t, T.DecimalType):
                # the window kernel runs i64 cumsum differences, which
                # are exact for short-decimal inputs; keep the short
                # output type here (the group-by path widens to
                # decimal(38) like the reference)
                out_t: T.Type = T.DecimalType(18, arg_t.scale)
            else:
                out_t = (T.BIGINT if fn == "count" else
                         T.DOUBLE if fn == "avg" else
                         _agg_output_type(fn, arg_t))
            return WindowFnSpec(fn, (arg,), out_t, name,
                                ignore_order=not has_order)
        raise AnalysisError(f"window function {fn}() is not supported")

    # -- ORDER BY -------------------------------------------------------------
    def _sort_keys(self, order_by, node: PlanNode, scope: Scope,
                   replacements) -> List[SortKeySpec]:
        keys = []
        for s in order_by:
            if isinstance(s.key, A.LongLiteral):
                idx = s.key.value - 1
                if not (0 <= idx < len(node.fields)):
                    raise AnalysisError("ORDER BY ordinal out of range")
            else:
                analyzer = ExpressionAnalyzer(scope, replacements)
                e = analyzer.analyze(s.key)
                if not isinstance(e, ir.InputRef):
                    raise AnalysisError(
                        "ORDER BY expression must be an output column here")
                idx = e.index
            keys.append(SortKeySpec(idx, s.ascending, s.nulls_first))
        return keys

    def _sort_keys_with_hidden(self, order_by, project: PlanNode,
                               out_scope: Scope, select_items, analyzer):
        """Resolve sort keys against select outputs; unmatched expressions
        become hidden projected columns."""
        keys: List[SortKeySpec] = []
        extra_exprs: List[ir.Expr] = []
        extra_fields: List[Field] = []
        n_out = len(project.fields)
        # map: select item AST -> output index; alias -> index
        by_ast = {it.value: i for i, it in enumerate(select_items)}
        by_alias = {it.alias: i for i, it in enumerate(select_items)
                    if it.alias}
        for s in order_by:
            k = s.key
            if isinstance(k, A.LongLiteral):
                idx = k.value - 1
                if not (0 <= idx < n_out):
                    raise AnalysisError("ORDER BY ordinal out of range")
            elif isinstance(k, A.Identifier) and k.name in by_alias:
                idx = by_alias[k.name]
            elif k in by_ast:
                idx = by_ast[k]
            else:
                # SQL lets ORDER BY expressions reference SELECT aliases
                # (reference StatementAnalyzer orderBy scope): substitute
                # alias identifiers with their select expressions before
                # analyzing (q36-style 'case when lochierarchy = 0 ...');
                # source columns of the same name take precedence
                def resolves_in_input(name: str) -> bool:
                    try:
                        analyzer.scope.resolve(name)
                        return True
                    except Exception:
                        return False
                k = _subst_select_aliases(k, by_alias, select_items,
                                          resolves_in_input)
                e = analyzer.analyze(k)
                if isinstance(e, ir.InputRef) and isinstance(
                        project, ProjectNode):
                    # column of the pre-projection input: check if it is
                    # already projected unchanged
                    match = [i for i, pe in enumerate(project.exprs)
                             if pe == e]
                    if match:
                        idx = match[0]
                    else:
                        idx = n_out + len(extra_exprs)
                        extra_exprs.append(e)
                        extra_fields.append(
                            Field(f"$sort{len(extra_exprs)}", e.type))
                else:
                    idx = n_out + len(extra_exprs)
                    extra_exprs.append(e)
                    extra_fields.append(
                        Field(f"$sort{len(extra_exprs)}", e.type))
            keys.append(SortKeySpec(idx, s.ascending, s.nulls_first))
        if extra_exprs and isinstance(project, ProjectNode):
            project = ProjectNode(
                child=project.child,
                exprs=project.exprs + tuple(extra_exprs),
                fields=project.fields + tuple(extra_fields))
        elif extra_exprs:
            raise AnalysisError(
                "ORDER BY expression not derivable from output columns")
        return keys, project

    # -- stars ----------------------------------------------------------------
    def _expand_stars(self, items, scope: Scope) -> List[A.SelectItem]:
        out: List[A.SelectItem] = []
        for it in items:
            if isinstance(it.value, A.Star):
                q = it.value.qualifier
                matched = 0
                for f in scope.fields:
                    if q is None or f.relation == q:
                        ref = (A.Identifier(f.name) if q is None
                               else A.DereferenceExpression(
                                   A.Identifier(q), A.Identifier(f.name)))
                        out.append(A.SelectItem(ref, f.name))
                        matched += 1
                if not matched:
                    raise AnalysisError(f"no columns match {q}.*")
            else:
                out.append(it)
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _realias(node: PlanNode, alias: str,
             column_names: Tuple[str, ...] = ()) -> PlanNode:
    names = list(column_names) or [f.name for f in node.fields]
    fields = tuple(Field(n, f.type, relation=alias)
                   for n, f in zip(names, node.fields))
    if isinstance(node, OutputNode):
        node = node.child
    return _Realiased(node, fields)


def _Realiased(node: PlanNode, fields) -> PlanNode:
    # identity projection carrying the new field names/relations
    return ProjectNode(
        child=node,
        exprs=tuple(ir.input_ref(i, f.type) for i, f in enumerate(fields)),
        fields=fields)


def _coerce_to(node: PlanNode, types: List[T.Type]) -> PlanNode:
    if [f.type for f in node.fields] == types:
        return node
    exprs = tuple(
        coerce(ir.input_ref(i, f.type), t)
        for i, (f, t) in enumerate(zip(node.fields, types)))
    fields = tuple(Field(f.name, t, f.relation)
                   for f, t in zip(node.fields, types))
    return ProjectNode(child=node, exprs=exprs, fields=fields)


def _split_conjuncts(e: A.Expression) -> List[A.Expression]:
    if isinstance(e, A.LogicalBinary) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _split_subquery_conjuncts(where: A.Expression):
    """Separate IN-subquery and [NOT] EXISTS conjuncts (-> semi joins)
    from plain ones. Entries: ("in", value, query, negated) or
    ("exists", None, query, negated)."""
    subqueries = []
    remaining: List[A.Expression] = []
    for c in _split_conjuncts(where):
        neg = False
        inner = c
        if isinstance(inner, A.Not):
            neg = True
            inner = inner.value
        if isinstance(inner, A.InSubquery):
            subqueries.append(
                ("in", inner.value, inner.query, neg != inner.negated))
            continue
        if isinstance(inner, A.Exists):
            subqueries.append(
                ("exists", None, inner.query, neg != inner.negated))
            continue
        remaining.append(c)
    return subqueries, _and_all(remaining)


def _and_all(conjuncts: List[A.Expression]) -> Optional[A.Expression]:
    if not conjuncts:
        return None
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = A.LogicalBinary("and", out, c)
    return out


def _walk_ast(exprs: Sequence[A.Expression], visit) -> None:
    """Generic AST walk (no descent into subquery bodies). ``visit``
    returns True to stop descending below a node."""

    def walk(n):
        if isinstance(n, (A.ScalarSubquery, A.InSubquery, A.Exists)):
            return
        if visit(n):
            return
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, tuple):
                    for x in v:
                        if dataclasses.is_dataclass(x):
                            walk(x)
                elif dataclasses.is_dataclass(v):
                    walk(v)
    for e in exprs:
        if e is not None:
            walk(e)


def _subst_select_aliases(k, by_alias, select_items, resolves_in_input):
    """Replace SELECT-alias identifiers inside an expression with their
    select expressions (no descent into subquery bodies). SQL scoping:
    a source column of the same name WINS over the alias (the reference
    resolves ORDER BY expression identifiers against the source relation
    first), so only identifiers that do NOT resolve in the input scope
    substitute. Dereference member names (x.field) are not free
    identifiers and never substitute."""
    def sub(n):
        if isinstance(n, (A.ScalarSubquery, A.InSubquery, A.Exists)):
            return n
        if isinstance(n, A.Identifier) and n.name in by_alias \
                and not resolves_in_input(n.name):
            return select_items[by_alias[n.name]].value
        if isinstance(n, A.DereferenceExpression):
            if isinstance(n.base, A.Identifier):
                return n      # qualified column ref: both parts are names
            base = sub(n.base)
            return (dataclasses.replace(n, base=base)
                    if base is not n.base else n)
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            changed = {}
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, tuple):
                    nv = tuple(sub(x) if dataclasses.is_dataclass(x)
                               and not isinstance(x, type) else x
                               for x in v)
                    if nv != v:
                        changed[f.name] = nv
                elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                    nv = sub(v)
                    if nv is not v:
                        changed[f.name] = nv
            return dataclasses.replace(n, **changed) if changed else n
        return n
    return sub(k)


def _collect_aggs(exprs: Sequence[A.Expression]) -> List[A.FunctionCall]:
    found: List[A.FunctionCall] = []

    def visit(n):
        if isinstance(n, A.WindowFunction):
            # the window call itself is not a group agg, but group aggs
            # may appear INSIDE it: avg(sum(x)) over (order by sum(y))
            # runs sum() in GROUP BY and avg() over the grouped rows
            # (reference AggregationAnalyzer's windowed-aggregate rules)
            _walk_ast(list(n.call.args) + list(n.partition_by)
                      + [s.key for s in n.order_by], visit)
            return True
        if isinstance(n, A.FunctionCall):
            fn = _FUNCTION_ALIASES.get(n.name, n.name)
            if fn in AGGREGATE_FUNCTIONS or n.is_star and fn == "count":
                found.append(n)
                return True  # don't descend into agg args
        return False
    _walk_ast(exprs, visit)
    return found


def _collect_calls_named(exprs: Sequence[A.Expression],
                         name: str) -> List[A.FunctionCall]:
    """All FunctionCall nodes with the given (unaliased) name, no descent
    into subqueries."""
    found: List[A.FunctionCall] = []

    def visit(n):
        if isinstance(n, A.FunctionCall) and n.name == name:
            found.append(n)
            return True
        return False
    _walk_ast(exprs, visit)
    return found


def _find_scalar_subqueries(e: A.Expression) -> List[A.ScalarSubquery]:
    """Top-level scalar subqueries of an expression (no descent into
    nested subquery bodies)."""
    found: List[A.ScalarSubquery] = []

    def walk(n):
        if isinstance(n, A.ScalarSubquery):
            found.append(n)
            return
        if isinstance(n, (A.InSubquery, A.Exists)):
            if isinstance(n, A.InSubquery):
                walk(n.value)
            return
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, tuple):
                    for x in v:
                        if dataclasses.is_dataclass(x):
                            walk(x)
                elif dataclasses.is_dataclass(v):
                    walk(v)
    walk(e)
    return found


def _replace_node(root, target, replacement):
    """Structurally replace ``target`` with ``replacement`` in an AST."""
    if root == target:
        return replacement
    if not (dataclasses.is_dataclass(root) and not isinstance(root, type)):
        return root
    changed = {}
    for f in dataclasses.fields(root):
        v = getattr(root, f.name)
        if isinstance(v, tuple):
            nv = tuple(
                _replace_node(x, target, replacement)
                if dataclasses.is_dataclass(x) else x for x in v)
            if nv != v:
                changed[f.name] = nv
        elif dataclasses.is_dataclass(v):
            nv = _replace_node(v, target, replacement)
            if nv != v:
                changed[f.name] = nv
    return dataclasses.replace(root, **changed) if changed else root


def _collect_windows(exprs: Sequence[A.Expression]
                     ) -> List[A.WindowFunction]:
    found: List[A.WindowFunction] = []

    def walk(n):
        if isinstance(n, (A.ScalarSubquery, A.InSubquery, A.Exists)):
            return
        if isinstance(n, A.WindowFunction):
            found.append(n)
            return
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, tuple):
                    for x in v:
                        if dataclasses.is_dataclass(x):
                            walk(x)
                elif dataclasses.is_dataclass(v):
                    walk(v)
    for e in exprs:
        if e is not None:
            walk(e)
    return found


def _parse_approx_distinct_error(analyzer, call) -> float:
    """Validate approx_distinct's optional max-standard-error argument
    (must be a constant within the reference's supported range)."""
    e_expr = analyzer.analyze(call.args[1])
    if not isinstance(e_expr, ir.Literal) or e_expr.value is None:
        raise AnalysisError(
            "approx_distinct standard error must be a constant")
    param = float(e_expr.value)
    from ..ops.sketch import MAX_STANDARD_ERROR, MIN_STANDARD_ERROR
    if not (MIN_STANDARD_ERROR <= param <= MAX_STANDARD_ERROR):
        raise AnalysisError(
            "approx_distinct standard error must be in "
            f"[{MIN_STANDARD_ERROR}, {MAX_STANDARD_ERROR}]")
    return param


def _derive_name(e: A.Expression, i: int) -> str:
    if isinstance(e, A.Identifier):
        return e.name
    if isinstance(e, A.DereferenceExpression):
        return e.field.name
    if isinstance(e, A.FunctionCall):
        return e.name
    return f"_col{i}"


def _agg_output_type(fn: str, arg: T.Type) -> T.Type:
    if fn == "count":
        return T.BIGINT
    if fn == "sum":
        if isinstance(arg, T.DecimalType):
            # reference DecimalSumAggregation: sum(decimal) is always
            # decimal(38, s) with Int128 state
            return T.DecimalType(38, arg.scale)
        if T.is_integral(arg):
            return T.BIGINT
        return T.DOUBLE if isinstance(arg, (T.DoubleType, T.RealType)) \
            else T.DOUBLE
    if fn == "avg":
        if isinstance(arg, T.DecimalType):
            return arg
        return T.DOUBLE
    if fn in ("var_samp", "var_pop", "stddev_samp", "stddev_pop"):
        return T.DOUBLE
    if fn in ("bool_and", "bool_or"):
        return T.BOOLEAN
    # min/max
    return arg


def _key_ref(e: ir.Expr) -> ir.Expr:
    """A join key's column: an input itself, or an integral input widened
    to a wider integral type (``cast(#k:integer as bigint)``, as when an
    INTEGER column of VALUES meets a BIGINT key), which joins on the
    same values: key operands widen to int64 in the join and the hash
    exchange alike."""
    if isinstance(e, ir.Cast) and isinstance(e.arg, ir.InputRef) \
            and T.is_integral(e.arg.type) and T.is_integral(e.type) \
            and T.common_super_type(e.arg.type, e.type) == e.type:
        return e.arg
    return e


def _extract_equi_keys(cond: Optional[ir.Expr], n_left: int):
    """Split an ON condition into equi-key pairs + residual.

    Mirrors the reference's join-criteria extraction (reference
    sql/planner/optimizations/PredicatePushDown.java + EqualityInference).
    """
    left_keys: List[int] = []
    right_keys: List[int] = []
    residual: List[ir.Expr] = []
    conjuncts: List[ir.Expr] = []

    def split(e: ir.Expr):
        if isinstance(e, ir.SpecialForm) and e.form == ir.Form.AND:
            for a in e.args:
                split(a)
        else:
            conjuncts.append(e)
    if cond is not None:
        split(cond)
    for c in conjuncts:
        a = b = None
        if isinstance(c, ir.Call) and c.name == "eq":
            a, b = (_key_ref(x) for x in c.args)
        if isinstance(a, ir.InputRef) and isinstance(b, ir.InputRef):
            if a.index < n_left <= b.index:
                left_keys.append(a.index)
                right_keys.append(b.index - n_left)
                continue
            if b.index < n_left <= a.index:
                left_keys.append(b.index)
                right_keys.append(a.index - n_left)
                continue
        residual.append(c)
    res = None
    if residual:
        res = residual[0] if len(residual) == 1 else ir.special(
            ir.Form.AND, T.BOOLEAN, *residual)
    return left_keys, right_keys, res
