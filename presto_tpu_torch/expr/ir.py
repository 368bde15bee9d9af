"""Typed scalar expression IR.

Conceptual parity with Presto's RowExpression IR (reference
presto-main/src/main/java/io/prestosql/sql/relational/RowExpression.java and
subclasses CallExpression, ConstantExpression, InputReferenceExpression,
SpecialForm) — the planner lowers analyzed AST expressions into this IR and
the kernel compiler (compiler.py) traces it into XLA, playing the role of
Presto's bytecode generator (sql/gen/PageFunctionCompiler.java).

Expressions are immutable and hashable: the hash is the compile-cache key.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Tuple

from ..types import Type


class Form(enum.Enum):
    """Special forms with non-default null/short-circuit semantics
    (reference sql/relational/SpecialForm.java Form enum)."""

    AND = "and"
    OR = "or"
    IF = "if"                # IF(cond, then, else)
    COALESCE = "coalesce"
    IS_NULL = "is_null"
    IN = "in"                # IN(value, c1, c2, ...)
    BETWEEN = "between"      # BETWEEN(v, lo, hi)
    NULL_IF = "null_if"
    SWITCH = "switch"        # SWITCH(cond1, val1, cond2, val2, ..., default)
    TRY = "try"              # TRY(expr): row-level errors become NULL


@dataclasses.dataclass(frozen=True)
class Expr:
    type: Type

    def children(self) -> Tuple["Expr", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class InputRef(Expr):
    """Reference to input column by position (InputReferenceExpression)."""

    index: int = 0

    def __repr__(self) -> str:
        return f"#{self.index}:{self.type.display()}"


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    """Constant. value is the python-domain value (None = NULL).

    Hashability: python scalars and strings only — arrays never appear here.
    """

    value: Any = None

    def __repr__(self) -> str:
        return f"lit({self.value!r}:{self.type.display()})"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Scalar function call, including operators (name like 'add', 'eq')."""

    name: str = ""
    args: Tuple[Expr, ...] = ()

    def children(self) -> Tuple[Expr, ...]:
        return self.args

    def __repr__(self) -> str:
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    arg: Optional[Expr] = None

    def children(self) -> Tuple[Expr, ...]:
        return (self.arg,)

    def __repr__(self) -> str:
        return f"cast({self.arg!r} as {self.type.display()})"


@dataclasses.dataclass(frozen=True)
class LambdaRef(Expr):
    """Reference to an enclosing lambda's parameter: ``level`` is the
    absolute nesting depth of the owning lambda (0 = outermost), ``index``
    the parameter position within it — so nested lambdas can reference
    outer parameters unambiguously."""

    index: int = 0
    level: int = 0

    def __repr__(self) -> str:
        return f"$lam{self.level}.{self.index}:{self.type.display()}"


@dataclasses.dataclass(frozen=True)
class LambdaExpr(Expr):
    """Lambda passed to a higher-order function (reference
    sql/relational/LambdaDefinitionExpression.java). ``type`` is the body's
    result type; parameters appear in the body as LambdaRef nodes."""

    body: Optional[Expr] = None
    n_params: int = 0

    def children(self) -> Tuple[Expr, ...]:
        return (self.body,)

    def __repr__(self) -> str:
        return f"lambda({self.n_params})->{self.body!r}"


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Param(Expr):
    """Execution-bound parameter slot (the plan-template analogue of
    Presto's Parameter after ParameterRewriter — except the value stays
    a RUNTIME input instead of folding to a constant).

    ``bound`` carries the binding the plan was BUILT with, but equality,
    hashing and repr deliberately exclude it: two plans differing only
    in bindings compare equal expression-by-expression, so the compile
    caches (expr/compiler.ExprCompiler, ops/jitcache) hand every binding
    the SAME traced executable. At dispatch the kernel reads the live
    value from the query's binding scope (expr/params.py) as a traced
    scalar argument."""

    slot: int = 0
    #: build-time binding (python-domain value). NEVER read at trace
    #: time — only the planner may consult it, and only through
    #: expr/params.consult(), which records a reuse guard.
    bound: Any = None

    def __eq__(self, other):
        return (type(other) is Param and other.type == self.type
                and other.slot == self.slot)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((Param, self.type, self.slot))

    def __repr__(self) -> str:
        return f"?{self.slot}:{self.type.display()}"


@dataclasses.dataclass(frozen=True)
class SpecialForm(Expr):
    form: Form = Form.AND
    args: Tuple[Expr, ...] = ()

    def children(self) -> Tuple[Expr, ...]:
        return self.args

    def __repr__(self) -> str:
        return f"{self.form.value}({', '.join(map(repr, self.args))})"


# -- convenience constructors ------------------------------------------------

def input_ref(index: int, type: Type) -> InputRef:
    return InputRef(type=type, index=index)


def lit(value: Any, type: Type) -> Literal:
    return Literal(type=type, value=value)


def param(slot: int, value: Any, type: Type) -> Param:
    return Param(type=type, slot=slot, bound=value)


def call(name: str, type: Type, *args: Expr) -> Call:
    return Call(type=type, name=name, args=tuple(args))


def cast(arg: Expr, to_type: Type) -> Cast:
    return Cast(type=to_type, arg=arg)


def special(form: Form, type: Type, *args: Expr) -> SpecialForm:
    return SpecialForm(type=type, form=form, args=tuple(args))
