"""SQL abstract syntax tree.

Conceptual parity with Presto's AST (reference presto-parser/src/main/java/
io/prestosql/sql/tree/ — 169 node classes); this is the subset needed for
the TPC-H/TPC-DS query language plus the session/DDL-lite statements the
engine serves. Nodes are frozen dataclasses: hashable, comparable,
printable — the analyzer annotates types out-of-band keyed by node
identity, like Presto's Analysis maps (reference
presto-main/.../sql/analyzer/Analysis.java).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from decimal import Decimal


class Node:
    pass


# ---------------------------------------------------------------------------
# Expressions (reference sql/tree/Expression.java subclasses)
# ---------------------------------------------------------------------------

class Expression(Node):
    pass


@dataclasses.dataclass(frozen=True)
class Identifier(Expression):
    name: str                      # lowercased unless quoted
    quoted: bool = False


@dataclasses.dataclass(frozen=True)
class DereferenceExpression(Expression):
    """Qualified name a.b (table.column)."""
    base: Expression
    field: Identifier


@dataclasses.dataclass(frozen=True)
class NullLiteral(Expression):
    pass


@dataclasses.dataclass(frozen=True)
class BooleanLiteral(Expression):
    value: bool


@dataclasses.dataclass(frozen=True)
class LongLiteral(Expression):
    value: int


@dataclasses.dataclass(frozen=True)
class DecimalLiteral(Expression):
    value: Decimal


@dataclasses.dataclass(frozen=True)
class DoubleLiteral(Expression):
    value: float


@dataclasses.dataclass(frozen=True)
class StringLiteral(Expression):
    value: str


@dataclasses.dataclass(frozen=True)
class DateLiteral(Expression):
    """DATE 'yyyy-mm-dd' (reference sql/tree/GenericLiteral.java)."""
    value: str


@dataclasses.dataclass(frozen=True)
class IntervalLiteral(Expression):
    """INTERVAL '3' MONTH — sign, value text, unit."""
    value: str
    unit: str                      # year|month|day|hour|minute|second
    sign: int = 1


@dataclasses.dataclass(frozen=True)
class ArithmeticBinary(Expression):
    op: str                        # + - * / %
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class ArithmeticUnary(Expression):
    op: str                        # + -
    value: Expression


@dataclasses.dataclass(frozen=True)
class Comparison(Expression):
    op: str                        # = <> < <= > >=
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class LogicalBinary(Expression):
    op: str                        # and | or
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class Not(Expression):
    value: Expression


@dataclasses.dataclass(frozen=True)
class Between(Expression):
    value: Expression
    min: Expression
    max: Expression
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InList(Expression):
    value: Expression
    items: Tuple[Expression, ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InSubquery(Expression):
    value: Expression
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Exists(Expression):
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Expression):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class Like(Expression):
    value: Expression
    pattern: Expression
    escape: Optional[Expression] = None
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class IsNull(Expression):
    value: Expression
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class FunctionCall(Expression):
    name: str                      # lowercased
    args: Tuple[Expression, ...]
    distinct: bool = False
    is_star: bool = False          # count(*)


@dataclasses.dataclass(frozen=True)
class Parameter(Expression):
    """Positional ? parameter in a prepared statement
    (reference sql/tree/Parameter.java)."""
    index: int


@dataclasses.dataclass(frozen=True)
class TypedParameter(Expression):
    """Literal hole in a plan-template fingerprint (serving/template.py):
    position plus the literal's TYPE KIND, never its value — two
    statements differing only in hole-punched literal values hash to
    the same template. Never planned; exists only to be hashed."""
    index: int
    kind: str                # integer | bigint | double | date | decimal(p,s)


# Slot-marked literals: value-carrying literals the template
# parameterizer has assigned a binding slot. They subclass their plain
# forms, so every analysis/validation isinstance check keeps working,
# but the analyzer lowers them to runtime-bound ir.Param nodes instead
# of baked constants (see analyzer._Slot*Literal).

@dataclasses.dataclass(frozen=True)
class SlotLongLiteral(LongLiteral):
    slot: int = -1


@dataclasses.dataclass(frozen=True)
class SlotDoubleLiteral(DoubleLiteral):
    slot: int = -1


@dataclasses.dataclass(frozen=True)
class SlotDecimalLiteral(DecimalLiteral):
    slot: int = -1


@dataclasses.dataclass(frozen=True)
class SlotDateLiteral(DateLiteral):
    slot: int = -1


@dataclasses.dataclass(frozen=True)
class ArrayLiteral(Expression):
    """ARRAY[e1, e2, ...] (reference sql/tree/ArrayConstructor.java)."""
    items: Tuple[Expression, ...]


@dataclasses.dataclass(frozen=True)
class Subscript(Expression):
    """base[index] — 1-based array subscript / map key lookup
    (reference sql/tree/SubscriptExpression.java)."""
    base: Expression
    index: Expression


@dataclasses.dataclass(frozen=True)
class Lambda(Expression):
    """x -> expr / (x, y) -> expr (reference sql/tree/LambdaExpression.java)."""
    params: Tuple[str, ...]
    body: Expression


@dataclasses.dataclass(frozen=True)
class WindowFunction(Expression):
    """fn(...) OVER (PARTITION BY ... ORDER BY ... [frame]) (reference
    sql/tree/FunctionCall window + Window.java + WindowFrame.java).
    Frame bounds are (kind, offset) with kind in unbounded_preceding |
    preceding | current_row | following | unbounded_following."""
    call: "FunctionCall"
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple["SortItem", ...] = ()
    frame: str = "range"           # frame unit: RANGE | ROWS
    frame_start: Tuple[str, int] = ("unbounded_preceding", 0)
    frame_end: Tuple[str, int] = ("current_row", 0)


@dataclasses.dataclass(frozen=True)
class Cast(Expression):
    value: Expression
    type_name: str                 # e.g. "decimal(12,2)"
    try_cast: bool = False


@dataclasses.dataclass(frozen=True)
class Extract(Expression):
    field: str                     # year|month|day|...
    value: Expression


@dataclasses.dataclass(frozen=True)
class WhenClause(Node):
    condition: Expression
    result: Expression


@dataclasses.dataclass(frozen=True)
class SearchedCase(Expression):
    whens: Tuple[WhenClause, ...]
    default: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class SimpleCase(Expression):
    operand: Expression
    whens: Tuple[WhenClause, ...]
    default: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class Coalesce(Expression):
    args: Tuple[Expression, ...]


@dataclasses.dataclass(frozen=True)
class NullIf(Expression):
    first: Expression
    second: Expression


@dataclasses.dataclass(frozen=True)
class Star(Expression):
    """SELECT * or t.*"""
    qualifier: Optional[str] = None


# ---------------------------------------------------------------------------
# Relations (reference sql/tree/Relation.java subclasses)
# ---------------------------------------------------------------------------

class Relation(Node):
    pass


@dataclasses.dataclass(frozen=True)
class Table(Relation):
    """Possibly-qualified table name: [catalog.][schema.]table"""
    name: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class AliasedRelation(Relation):
    relation: Relation
    alias: str
    column_names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SubqueryRelation(Relation):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class Unnest(Relation):
    """UNNEST(expr, ...) [WITH ORDINALITY] — lateral array expansion
    (reference sql/tree/Unnest.java). Expressions may reference columns
    of relations earlier in the FROM list."""
    exprs: Tuple[Expression, ...]
    ordinality: bool = False


@dataclasses.dataclass(frozen=True)
class Join(Relation):
    join_type: str                 # inner|left|right|full|cross|implicit
    left: Relation
    right: Relation
    condition: Optional[Expression] = None   # ON expr (None for cross)


# ---------------------------------------------------------------------------
# Query structure (reference sql/tree/Query.java, QuerySpecification.java)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SelectItem(Node):
    value: Expression
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SortItem(Node):
    key: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None     # None = type default (last for asc)


@dataclasses.dataclass(frozen=True)
class QuerySpecification(Node):
    select: Tuple[SelectItem, ...]
    distinct: bool = False
    from_: Optional[Relation] = None
    where: Optional[Expression] = None
    group_by: Tuple[Expression, ...] = ()
    # GROUP BY ROLLUP/CUBE/GROUPING SETS desugar to index tuples into
    # group_by (reference sql/tree/GroupingSets.java); None = plain GROUP BY
    grouping_sets: Optional[Tuple[Tuple[int, ...], ...]] = None
    having: Optional[Expression] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ValuesQuery(Node):
    """VALUES (e, ...), ... as a query body (reference
    sql/tree/Values.java — the inlineTable rule)."""
    rows: Tuple[Tuple[Expression, ...], ...]


@dataclasses.dataclass(frozen=True)
class Query(Node):
    """Top-level query: body plus WITH bindings."""
    body: Node                     # QuerySpecification | SetOperation | ValuesQuery
    with_: Tuple[Tuple[str, "Query"], ...] = ()


@dataclasses.dataclass(frozen=True)
class SetOperation(Node):
    op: str                        # union|intersect|except
    distinct: bool                 # False = ALL
    left: Node
    right: Node
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None


# ---------------------------------------------------------------------------
# Statements beyond queries (reference sql/tree/Statement.java subclasses)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Explain(Node):
    statement: Node
    analyze: bool = False
    type: str = "logical"          # logical|distributed|validate|io
    format: str = "text"           # text|json|graphviz


@dataclasses.dataclass(frozen=True)
class ShowTables(Node):
    schema: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ShowColumns(Node):
    table: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ShowCatalogs(Node):
    pass


@dataclasses.dataclass(frozen=True)
class ShowSession(Node):
    pass


@dataclasses.dataclass(frozen=True)
class SetSession(Node):
    name: str
    value: Expression


@dataclasses.dataclass(frozen=True)
class ResetSession(Node):
    name: str


@dataclasses.dataclass(frozen=True)
class StartTransaction(Node):
    isolation: str = "READ COMMITTED"
    read_only: bool = False


@dataclasses.dataclass(frozen=True)
class Commit(Node):
    pass


@dataclasses.dataclass(frozen=True)
class Rollback(Node):
    pass


@dataclasses.dataclass(frozen=True)
class CreateTableAsSelect(Node):
    name: Tuple[str, ...]
    query: Query
    if_not_exists: bool = False
    #: WITH (k = v, ...) table properties (reference
    #: sql/tree/CreateTableAsSelect.java properties; e.g. partitioned_by)
    properties: Tuple[Tuple[str, object], ...] = ()


@dataclasses.dataclass(frozen=True)
class DropTable(Node):
    name: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateView(Node):
    """CREATE [OR REPLACE] VIEW name AS query (reference
    sql/tree/CreateView.java; the parsed query is the stored
    ConnectorViewDefinition analogue)."""
    name: Tuple[str, ...]
    query: "Query"
    or_replace: bool = False


@dataclasses.dataclass(frozen=True)
class DropView(Node):
    name: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Prepare(Node):
    """PREPARE name FROM statement (reference sql/tree/Prepare.java)."""
    name: str
    statement: Node


@dataclasses.dataclass(frozen=True)
class ExecuteStmt(Node):
    """EXECUTE name [USING expr, ...] (reference sql/tree/Execute.java)."""
    name: str
    args: Tuple[Expression, ...] = ()


@dataclasses.dataclass(frozen=True)
class Deallocate(Node):
    name: str


@dataclasses.dataclass(frozen=True)
class DescribeOutput(Node):
    name: str


@dataclasses.dataclass(frozen=True)
class DescribeInput(Node):
    name: str


# ---------------------------------------------------------------------------
# Prepared-statement parameter binding (reference
# sql/planner/ParameterRewriter.java over sql/tree nodes)
# ---------------------------------------------------------------------------

def substitute_parameters(node, values):
    """Replace Parameter(i) nodes with the i-th bound expression,
    rebuilding the immutable AST."""
    def walk(n):
        if isinstance(n, Parameter):
            if n.index >= len(values):
                raise ValueError(
                    "Incorrect number of parameters: expected at least "
                    f"{n.index + 1} but found {len(values)}")
            return values[n.index]
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            changes = {}
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                nv = walk(v)
                if nv is not v:
                    changes[f.name] = nv
            return dataclasses.replace(n, **changes) if changes else n
        if isinstance(n, tuple):
            out = tuple(walk(x) for x in n)
            return out if any(a is not b for a, b in zip(out, n)) else n
        if isinstance(n, list):
            return [walk(x) for x in n]
        return n
    return walk(node)


def count_parameters(node) -> int:
    """Highest parameter ordinal + 1 in a statement AST."""
    best = 0

    def walk(n):
        nonlocal best
        if isinstance(n, Parameter):
            best = max(best, n.index + 1)
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            for f in dataclasses.fields(n):
                walk(getattr(n, f.name))
        elif isinstance(n, (tuple, list)):
            for x in n:
                walk(x)
    walk(node)
    return best


@dataclasses.dataclass(frozen=True)
class InsertInto(Node):
    name: Tuple[str, ...]
    query: Query
    columns: Tuple[str, ...] = ()


# -- roles & privileges (reference sql/tree/CreateRole.java, Grant.java,
# -- Revoke.java, SetRole.java, ShowGrants.java; spi/security/RoleGrant)


@dataclasses.dataclass(frozen=True)
class CreateRole(Node):
    name: str


@dataclasses.dataclass(frozen=True)
class DropRole(Node):
    name: str


@dataclasses.dataclass(frozen=True)
class GrantRoles(Node):
    roles: Tuple[str, ...]
    grantees: Tuple[str, ...]
    admin_option: bool = False


@dataclasses.dataclass(frozen=True)
class RevokeRoles(Node):
    roles: Tuple[str, ...]
    grantees: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class GrantPrivileges(Node):
    privileges: Tuple[str, ...]          # SELECT/INSERT/DELETE or ALL
    table: Tuple[str, ...]
    grantee: str
    grant_option: bool = False


@dataclasses.dataclass(frozen=True)
class RevokePrivileges(Node):
    privileges: Tuple[str, ...]
    table: Tuple[str, ...]
    grantee: str


@dataclasses.dataclass(frozen=True)
class SetRole(Node):
    role: str                            # a role name, or ALL / NONE


@dataclasses.dataclass(frozen=True)
class ShowRoles(Node):
    pass


@dataclasses.dataclass(frozen=True)
class ShowGrants(Node):
    table: Tuple[str, ...] = ()
