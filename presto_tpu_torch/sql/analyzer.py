"""Name/type resolution: AST expressions -> typed kernel IR.

Conceptual parity with the reference's ExpressionAnalyzer + scope machinery
(reference presto-main/.../sql/analyzer/ExpressionAnalyzer.java, Scope.java,
and the AST->RowExpression lowering in sql/relational/SqlToRowExpression-
Translator.java) collapsed into one pass: resolving a column yields its
input index, inferring a type yields the IR node, so analysis produces the
compile-ready expression directly.

Aggregate calls are NOT handled here — the query planner rewrites them to
input references before lowering (reference sql/analyzer/
AggregationAnalyzer.java + planner/QueryPlanner.java split).
"""
from __future__ import annotations

import dataclasses
import math
from decimal import Decimal
from typing import Dict, List, Optional, Sequence, Tuple

from .. import types as T
from ..expr import ir
from ..expr.functions import infer_call_type
from . import ast as A
from .lexer import SqlSyntaxError


class AnalysisError(ValueError):
    pass


class UnresolvedColumnError(AnalysisError):
    """A name did not resolve in any visible scope — the signal the
    planner's decorrelation uses to distinguish a correlated subquery
    from one that fails for unrelated reasons."""


AGGREGATE_FUNCTIONS = frozenset(
    ["count", "sum", "avg", "min", "max", "stddev", "stddev_samp",
     "stddev_pop", "variance", "var_samp", "var_pop", "approx_distinct",
     "any_value", "arbitrary", "bool_and", "bool_or",
     "approx_percentile"])

# SQL surface name -> kernel registry name
_FUNCTION_ALIASES = {
    "substring": "substr", "mod": "modulus", "pow": "power",
    "ceiling": "ceil", "char_length": "length",
    "stddev": "stddev_samp", "variance": "var_samp",
    "var": "var_samp", "every": "bool_and",
    "dow": "day_of_week", "doy": "day_of_year",
    "day_of_month": "day",
    "week_of_year": "week", "yow": "year_of_week",
}

#: zero-argument functions folded to literals at analysis time
_NILADIC = {
    "pi": (math.pi, T.DOUBLE),
    "e": (math.e, T.DOUBLE),
    "nan": (float("nan"), T.DOUBLE),
    "infinity": (float("inf"), T.DOUBLE),
}

_ARITH_OPS = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide",
              "%": "modulus"}
_CMP_OPS = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt",
            ">=": "ge"}


@dataclasses.dataclass(frozen=True)
class Field:
    """One resolvable output column of a relation (reference
    sql/analyzer/Field.java): name plus originating relation alias."""

    name: str
    type: T.Type
    relation: Optional[str] = None   # alias or table name, lowercased


class Scope:
    """Visible fields during expression analysis (reference Scope.java).

    Resolution is positional: a resolved column is its index in the
    underlying relation's output — the IR InputRef index.
    """

    def __init__(self, fields: Sequence[Field],
                 parent: Optional["Scope"] = None):
        self.fields: Tuple[Field, ...] = tuple(fields)
        self.parent = parent

    def resolve(self, name: str, qualifier: Optional[str] = None) -> int:
        matches = [
            i for i, f in enumerate(self.fields)
            if f.name == name and (qualifier is None or f.relation == qualifier)
        ]
        if not matches:
            # identifiers match case-insensitively (the reference engine
            # lowercases unquoted identifiers and resolves quoted ones
            # case-insensitively too — its own TPC-DS SQL aliases "YEAR"
            # and references "year")
            low = name.lower()
            lq = qualifier.lower() if qualifier else None
            matches = [
                i for i, f in enumerate(self.fields)
                if f.name.lower() == low
                and (lq is None or (f.relation or "").lower() == lq)
            ]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise AnalysisError(f"column {name!r} is ambiguous")
        if self.parent is not None:
            # correlated reference into an outer query — not yet planned
            try:
                self.parent.resolve(name, qualifier)
            except AnalysisError:
                pass
            else:
                raise UnresolvedColumnError(
                    f"correlated reference to outer column {name!r} is not "
                    "supported yet")
        q = f"{qualifier}." if qualifier else ""
        raise UnresolvedColumnError(f"column {q}{name} cannot be resolved")

    def field(self, index: int) -> Field:
        return self.fields[index]

    def __len__(self) -> int:
        return len(self.fields)


#: magnitude of the widest INTEGER literal
_INTEGER_LITERAL_MAX = (1 << 31) - 1


def literal_type(node: A.Expression) -> T.Type:
    if isinstance(node, A.LongLiteral):
        # ExpressionAnalyzer.visitLongLiteral: INTEGER when the literal
        # fits in [-2^31, 2^31-1], else BIGINT. SQL writes a literal
        # unsigned (the grammar's integerLiteral); a sign is the unary
        # minus the parser folds in, which keeps the unsigned literal's
        # type, so the magnitude decides: -2147483648 is BIGINT
        return T.INTEGER if abs(node.value) <= _INTEGER_LITERAL_MAX \
            else T.BIGINT
    if isinstance(node, A.DecimalLiteral):
        d = node.value.as_tuple()
        scale = max(0, -int(d.exponent))
        precision = max(len(d.digits), scale)
        # literals past 38 digits would silently round; refuse like the
        # reference parser (Decimals.parse overflow)
        if precision > 38:
            raise AnalysisError(
                f"DECIMAL literal exceeds 38 digits: {node.value}")
        return T.DecimalType(precision, scale)
    if isinstance(node, A.DoubleLiteral):
        return T.DOUBLE
    if isinstance(node, A.StringLiteral):
        return T.VarcharType(len(node.value))
    if isinstance(node, A.BooleanLiteral):
        return T.BOOLEAN
    if isinstance(node, A.DateLiteral):
        return T.DATE
    if isinstance(node, A.NullLiteral):
        return T.UNKNOWN
    raise AnalysisError(f"not a literal: {node}")


def coerce(e: ir.Expr, to: T.Type) -> ir.Expr:
    if e.type == to:
        return e
    if isinstance(e, ir.Param) and T.is_integral(e.type) \
            and T.is_integral(to) and T.common_super_type(e.type, to) == to:
        # a template slot widens as the literal it stands for would fold:
        # the binding is stored in the wider type (expr/params.py)
        return ir.param(e.slot, e.bound, to)
    if isinstance(e, ir.Literal):
        # fold literal casts at analysis time (constant folding, reference
        # sql/planner/ExpressionInterpreter.java role)
        v = e.value
        if v is None:
            return ir.lit(None, to)
        if isinstance(to, (T.DoubleType, T.RealType)):
            return ir.lit(float(v), to)
        if isinstance(v, float) and not math.isfinite(v) and (
                T.is_integral(to) or isinstance(to, T.DecimalType)):
            # NaN and infinities: the runtime cast raises
            # INVALID_CAST_ARGUMENT through the row error channel
            return ir.cast(e, to)
        if T.is_integral(to):
            # Presto integral casts round half-up and range-check; an
            # out-of-range constant falls through to the runtime cast,
            # which raises through the row error channel
            import decimal as _d
            with _d.localcontext() as ctx:
                ctx.prec = 60
                iv = int(Decimal(str(v)).quantize(
                    0, rounding=_d.ROUND_HALF_UP))
            bits = {"tinyint": 7, "smallint": 15, "integer": 31,
                    "bigint": 63}[to.name]
            if -(1 << bits) <= iv < (1 << bits):
                return ir.lit(iv, to)
            return ir.cast(e, to)
        if isinstance(to, T.DecimalType):
            if abs(Decimal(str(v))) < Decimal(10) ** (to.precision - to.scale):
                return ir.lit(Decimal(str(v)), to)
            return ir.cast(e, to)
        if isinstance(to, (T.VarcharType, T.CharType)):
            return ir.lit(str(v), to)
    return ir.cast(e, to)


def unify(a: ir.Expr, b: ir.Expr) -> Tuple[ir.Expr, ir.Expr, T.Type]:
    t = T.common_super_type(a.type, b.type)
    if t is None:
        raise AnalysisError(
            f"cannot compare/combine {a.type.display()} and {b.type.display()}")
    return coerce(a, t), coerce(b, t), t


class ExpressionAnalyzer:
    """Lowers one AST expression against a scope.

    ``replacements`` maps AST subtrees (by structural equality) to
    pre-computed input references — how the planner routes aggregate
    results and group keys through post-aggregation expressions.
    """

    def __init__(self, scope: Scope,
                 replacements: Optional[Dict[A.Expression, ir.Expr]] = None):
        self.scope = scope
        self.replacements = replacements or {}
        # innermost-last stack of {param_name: (position, type)} frames
        # for lambda bodies (reference analyzer LambdaArgumentDeclaration)
        self.lambda_scopes: List[Dict[str, Tuple[int, T.Type]]] = []

    def analyze(self, node: A.Expression) -> ir.Expr:
        hit = self.replacements.get(node)
        if hit is not None:
            return hit
        m = getattr(self, "_" + type(node).__name__, None)
        if m is None:
            raise AnalysisError(f"unsupported expression {type(node).__name__}")
        return m(node)

    # -- leaves --------------------------------------------------------------
    def _Identifier(self, node: A.Identifier) -> ir.Expr:
        low = node.name.lower()
        for lvl in range(len(self.lambda_scopes) - 1, -1, -1):
            frame = self.lambda_scopes[lvl]
            if low in frame:
                pos, typ = frame[low]
                return ir.LambdaRef(type=typ, index=pos, level=lvl)
        idx = self.scope.resolve(node.name)
        return ir.input_ref(idx, self.scope.field(idx).type)

    def _DereferenceExpression(self, node: A.DereferenceExpression) -> ir.Expr:
        if not isinstance(node.base, A.Identifier):
            raise AnalysisError("only table.column dereference is supported")
        idx = self.scope.resolve(node.field.name, node.base.name)
        return ir.input_ref(idx, self.scope.field(idx).type)

    def _NullLiteral(self, node):
        return ir.lit(None, T.UNKNOWN)

    def _BooleanLiteral(self, node):
        return ir.lit(node.value, T.BOOLEAN)

    def _LongLiteral(self, node):
        return ir.lit(node.value, literal_type(node))

    def _DecimalLiteral(self, node):
        return ir.lit(node.value, literal_type(node))

    def _DoubleLiteral(self, node):
        return ir.lit(node.value, T.DOUBLE)

    def _StringLiteral(self, node):
        return ir.lit(node.value, T.VarcharType(len(node.value)))

    def _DateLiteral(self, node):
        return ir.lit(node.value, T.DATE)

    # -- slot-marked literals (plan templates, serving/template.py):
    # -- lowered to runtime-bound parameters instead of baked constants.
    # -- Types match the plain literal forms exactly, and are value-
    # -- independent for every parameterizable kind (a DecimalLiteral's
    # -- inferred precision/scale is part of the template key).
    def _SlotLongLiteral(self, node):
        return ir.param(node.slot, node.value, literal_type(node))

    def _SlotDoubleLiteral(self, node):
        return ir.param(node.slot, node.value, T.DOUBLE)

    def _SlotDecimalLiteral(self, node):
        return ir.param(node.slot, node.value, literal_type(node))

    def _SlotDateLiteral(self, node):
        return ir.param(node.slot, node.value, T.DATE)

    def _IntervalLiteral(self, node):
        raise AnalysisError(
            "interval literal only supported in date +/- interval")

    # -- operators -----------------------------------------------------------
    def _ArithmeticBinary(self, node: A.ArithmeticBinary) -> ir.Expr:
        # date +/- interval  ->  date_add_*
        if isinstance(node.right, A.IntervalLiteral) and node.op in "+-":
            left = self.analyze(node.left)
            iv = node.right
            amount = int(iv.value) * iv.sign * (1 if node.op == "+" else -1)
            unit_fn = {"day": "date_add_days", "month": "date_add_months",
                       "year": "date_add_years"}.get(iv.unit)
            if unit_fn is None or not isinstance(left.type, (T.DateType, T.TimestampType)):
                raise AnalysisError(f"unsupported interval arithmetic {iv}")
            return ir.call(unit_fn, left.type, left,
                           ir.lit(amount, T.BIGINT))
        left = self.analyze(node.left)
        right = self.analyze(node.right)
        name = _ARITH_OPS[node.op]
        out = infer_call_type(name, [left.type, right.type])
        # operands coerce toward the output domain (decimal args keep their
        # scales: the kernel handles rescaling; float args widen)
        if not isinstance(out, T.DecimalType):
            left, right = coerce(left, out), coerce(right, out)
        return ir.call(name, out, left, right)

    def _ArithmeticUnary(self, node: A.ArithmeticUnary) -> ir.Expr:
        v = self.analyze(node.value)
        if node.op == "+":
            return v
        return ir.call("negate", v.type, v)

    def _Comparison(self, node: A.Comparison) -> ir.Expr:
        left = self.analyze(node.left)
        right = self.analyze(node.right)
        left, right, _ = unify(left, right)
        return ir.call(_CMP_OPS[node.op], T.BOOLEAN, left, right)

    def _LogicalBinary(self, node: A.LogicalBinary) -> ir.Expr:
        # flatten chains into one n-ary special form
        form = ir.Form.AND if node.op == "and" else ir.Form.OR
        args: List[ir.Expr] = []

        def walk(n: A.Expression):
            if isinstance(n, A.LogicalBinary) and n.op == node.op:
                walk(n.left)
                walk(n.right)
            else:
                args.append(self._to_bool(self.analyze(n)))
        walk(node)
        return ir.special(form, T.BOOLEAN, *args)

    def _to_bool(self, e: ir.Expr) -> ir.Expr:
        if not isinstance(e.type, T.BooleanType):
            raise AnalysisError(
                f"expected boolean, got {e.type.display()}")
        return e

    def _Not(self, node: A.Not) -> ir.Expr:
        return ir.call("not", T.BOOLEAN, self._to_bool(self.analyze(node.value)))

    def _Between(self, node: A.Between) -> ir.Expr:
        v = self.analyze(node.value)
        lo = self.analyze(node.min)
        hi = self.analyze(node.max)
        v1, lo, _ = unify(v, lo)
        v2, hi, _ = unify(v, hi)
        # coerce v to the wider of both unifications
        v = v1 if v1.type == v2.type else (
            v1 if T.common_super_type(v1.type, v2.type) == v1.type else v2)
        lo = coerce(lo, v.type)
        hi = coerce(hi, v.type)
        e = ir.special(ir.Form.BETWEEN, T.BOOLEAN, v, lo, hi)
        return ir.call("not", T.BOOLEAN, e) if node.negated else e

    def _InList(self, node: A.InList) -> ir.Expr:
        v = self.analyze(node.value)
        items = [self.analyze(i) for i in node.items]
        for i, it in enumerate(items):
            v2, it2, _ = unify(v, it)
            v, items[i] = v2, it2
        items = [coerce(it, v.type) for it in items]
        e = ir.special(ir.Form.IN, T.BOOLEAN, v, *items)
        return ir.call("not", T.BOOLEAN, e) if node.negated else e

    def _Like(self, node: A.Like) -> ir.Expr:
        v = self.analyze(node.value)
        if not isinstance(node.pattern, A.StringLiteral):
            raise AnalysisError("LIKE pattern must be a string literal")
        escape = None
        if node.escape is not None:
            if not isinstance(node.escape, A.StringLiteral):
                raise AnalysisError("LIKE escape must be a string literal")
            escape = node.escape.value
        pat = ir.lit(node.pattern.value, T.VarcharType(len(node.pattern.value)))
        args = [v, pat]
        if escape is not None:
            args.append(ir.lit(escape, T.VarcharType(len(escape))))
        e = ir.call("like", T.BOOLEAN, *args)
        return ir.call("not", T.BOOLEAN, e) if node.negated else e

    def _IsNull(self, node: A.IsNull) -> ir.Expr:
        e = ir.special(ir.Form.IS_NULL, T.BOOLEAN, self.analyze(node.value))
        return ir.call("not", T.BOOLEAN, e) if node.negated else e

    def _Cast(self, node: A.Cast) -> ir.Expr:
        v = self.analyze(node.value)
        to = T.parse_type(node.type_name)
        return coerce(v, to)

    def _Extract(self, node: A.Extract) -> ir.Expr:
        v = self.analyze(node.value)
        field = node.field.lower()
        field = {"dow": "day_of_week", "doy": "day_of_year",
                 "yow": "year_of_week"}.get(field, field)
        if field not in ("year", "month", "day", "quarter", "day_of_week",
                         "day_of_year", "week", "year_of_week", "hour",
                         "minute", "second", "millisecond"):
            raise AnalysisError(f"EXTRACT({field}) not supported")
        return ir.call(field, T.BIGINT, v)

    def _WhenList(self, whens, default, operand=None):
        args: List[ir.Expr] = []
        results: List[ir.Expr] = []
        conds: List[ir.Expr] = []
        for w in whens:
            if operand is not None:
                op_e = self.analyze(operand)
                val_e = self.analyze(w.condition)
                a, b, _ = unify(op_e, val_e)
                conds.append(ir.call("eq", T.BOOLEAN, a, b))
            else:
                conds.append(self._to_bool(self.analyze(w.condition)))
            results.append(self.analyze(w.result))
        d = self.analyze(default) if default is not None else ir.lit(None, T.UNKNOWN)
        out_t = d.type
        for r in results:
            t = T.common_super_type(out_t, r.type)
            if t is None:
                raise AnalysisError("CASE branches have incompatible types")
            out_t = t
        results = [coerce(r, out_t) for r in results]
        d = coerce(d, out_t)
        for c, r in zip(conds, results):
            args.extend([c, r])
        args.append(d)
        return ir.special(ir.Form.SWITCH, out_t, *args)

    def _SearchedCase(self, node: A.SearchedCase) -> ir.Expr:
        return self._WhenList(node.whens, node.default)

    def _SimpleCase(self, node: A.SimpleCase) -> ir.Expr:
        return self._WhenList(node.whens, node.default, operand=node.operand)

    def _Coalesce(self, node: A.Coalesce) -> ir.Expr:
        args = [self.analyze(a) for a in node.args]
        out_t = args[0].type
        for a in args[1:]:
            t = T.common_super_type(out_t, a.type)
            if t is None:
                raise AnalysisError("COALESCE args have incompatible types")
            out_t = t
        args = [coerce(a, out_t) for a in args]
        return ir.special(ir.Form.COALESCE, out_t, *args)

    def _NullIf(self, node: A.NullIf) -> ir.Expr:
        a = self.analyze(node.first)
        b = self.analyze(node.second)
        a2, b2, _ = unify(a, b)
        return ir.special(ir.Form.NULL_IF, a.type, a2, b2)

    def _FunctionCall(self, node: A.FunctionCall) -> ir.Expr:
        name = _FUNCTION_ALIASES.get(node.name, node.name)
        if name in _NILADIC and not node.args:
            value, typ = _NILADIC[name]
            return ir.lit(value, typ)
        if name == "parse_timestamp_literal":
            # TIMESTAMP '...' — folded to a literal here
            s = node.args[0]
            if not isinstance(s, A.StringLiteral):
                raise AnalysisError("TIMESTAMP literal must be a string")
            T.TIMESTAMP.to_storage(s.value)    # validate now
            return ir.lit(s.value, T.TIMESTAMP)
        if name == "try":
            # TRY(expr): row-level evaluation errors become NULL
            # (reference operator/scalar/TryFunction.java)
            if len(node.args) != 1:
                raise AnalysisError("try() takes exactly one argument")
            arg = self.analyze(node.args[0])
            return ir.special(ir.Form.TRY, arg.type, arg)
        if name == "if":
            # IF(cond, then [, else]) function spelling of CASE
            if len(node.args) not in (2, 3):
                raise AnalysisError("if() takes two or three arguments")
            cond = self._to_bool(self.analyze(node.args[0]))
            then = self.analyze(node.args[1])
            els = (self.analyze(node.args[2]) if len(node.args) == 3
                   else ir.lit(None, then.type))
            out_t = T.common_super_type(then.type, els.type)
            if out_t is None:
                raise AnalysisError("IF branches have incompatible types")
            return ir.special(ir.Form.IF, out_t, cond,
                              coerce(then, out_t), coerce(els, out_t))
        if name in AGGREGATE_FUNCTIONS:
            raise AnalysisError(
                f"aggregate function {name}() in scalar context (missing "
                "GROUP BY rewrite?)")
        if name in ("transform", "filter", "reduce", "any_match",
                    "all_match", "none_match") \
                and node.args and any(isinstance(a, A.Lambda)
                                      for a in node.args):
            return self._higher_order(name, node)
        args = [self.analyze(a) for a in node.args]
        array_t = self._array_fn_type(name, args)
        if array_t is not None:
            fn = "array_concat" if (name == "concat" and
                                    isinstance(args[0].type, T.ArrayType)) \
                else name
            return ir.call(fn, array_t, *args)
        try:
            out = infer_call_type(name, [a.type for a in args])
        except KeyError:
            raise AnalysisError(f"unknown function {node.name!r}")
        return ir.call(name, out, *args)

    def _ArrayLiteral(self, node: A.ArrayLiteral) -> ir.Expr:
        if not node.items:
            raise AnalysisError("empty ARRAY[] literal needs a cast")
        items = [self.analyze(a) for a in node.items]
        el: T.Type = T.UNKNOWN
        for a in items:
            nxt = T.common_super_type(el, a.type)
            if nxt is None:
                raise AnalysisError("ARRAY elements have incompatible types")
            el = nxt
        items = [coerce(a, el) for a in items]
        return ir.call("array_constructor", T.ArrayType(el), *items)

    def _Subscript(self, node: A.Subscript) -> ir.Expr:
        base = self.analyze(node.base)
        idx = self.analyze(node.index)
        if isinstance(base.type, T.ArrayType):
            if not T.is_integral(idx.type):
                raise AnalysisError("array subscript must be an integer")
            return ir.call("subscript", base.type.element, base, idx)
        if isinstance(base.type, T.MapType):
            return ir.call("subscript", base.type.value, base,
                           coerce(idx, base.type.key))
        raise AnalysisError(
            f"cannot subscript {base.type.display()}")

    def _Lambda(self, node):
        raise AnalysisError(
            "lambda expressions are only valid as arguments of "
            "higher-order functions (transform, filter, reduce, ...)")

    def _analyze_lambda(self, lam: A.Lambda,
                        param_types: Sequence[T.Type]) -> ir.LambdaExpr:
        if len(lam.params) != len(param_types):
            raise AnalysisError(
                f"lambda takes {len(lam.params)} arguments, expected "
                f"{len(param_types)}")
        frame = {p.lower(): (i, t)
                 for i, (p, t) in enumerate(zip(lam.params, param_types))}
        self.lambda_scopes.append(frame)
        try:
            body = self.analyze(lam.body)
        finally:
            self.lambda_scopes.pop()
        return ir.LambdaExpr(type=body.type, body=body,
                             n_params=len(lam.params))

    def _higher_order(self, name: str, node: A.FunctionCall) -> ir.Expr:
        args = list(node.args)
        arr = self.analyze(args[0])
        if not isinstance(arr.type, T.ArrayType):
            raise AnalysisError(f"{name}() expects an array argument")
        et = arr.type.element
        if name == "reduce":
            if len(args) != 4:
                raise AnalysisError(
                    "reduce(array, init, (s, x) -> ..., s -> ...) "
                    "takes four arguments")
            init = self.analyze(args[1])
            if not isinstance(args[2], A.Lambda) \
                    or not isinstance(args[3], A.Lambda):
                raise AnalysisError("reduce() needs lambda arguments")
            step = self._analyze_lambda(args[2], [init.type, et])
            step_body = coerce(step.body, init.type)
            step = ir.LambdaExpr(type=init.type, body=step_body, n_params=2)
            out_lam = self._analyze_lambda(args[3], [init.type])
            return ir.call("reduce", out_lam.type, arr, init, step, out_lam)
        if len(args) != 2 or not isinstance(args[1], A.Lambda):
            raise AnalysisError(f"{name}(array, lambda) takes a lambda")
        lam = self._analyze_lambda(args[1], [et])
        if name == "transform":
            return ir.call(name, T.ArrayType(lam.type), arr, lam)
        if not isinstance(lam.type, T.BooleanType):
            raise AnalysisError(f"{name}() lambda must return boolean")
        if name == "filter":
            return ir.call(name, arr.type, arr, lam)
        return ir.call(name, T.BOOLEAN, arr, lam)

    def _array_fn_type(self, name: str,
                       args: List[ir.Expr]) -> Optional[T.Type]:
        """Structural return types for array/map builtins (these need the
        argument's element types, which name-only infer_call_type can't
        see)."""
        ts = [a.type for a in args]
        if name == "cardinality" and isinstance(ts[0], (T.ArrayType,
                                                        T.MapType)):
            return T.BIGINT
        if name == "element_at":
            if isinstance(ts[0], T.ArrayType):
                return ts[0].element
            if isinstance(ts[0], T.MapType):
                return ts[0].value
        if not any(isinstance(t, (T.ArrayType, T.MapType)) for t in ts) \
                and name not in ("repeat", "sequence", "split", "map"):
            return None
        if name == "contains":
            return T.BOOLEAN
        if name == "array_position":
            return T.BIGINT
        if name in ("array_min", "array_max"):
            return ts[0].element
        if name in ("array_distinct", "array_sort"):
            return ts[0]
        if name == "array_concat" or (name == "concat" and
                                      isinstance(ts[0], T.ArrayType)):
            out = ts[0]
            for t in ts[1:]:
                out = T.common_super_type(out, t)
                if out is None:
                    raise AnalysisError("cannot concat incompatible arrays")
            return out
        if name == "repeat" and len(ts) == 2:
            return T.ArrayType(ts[0])
        if name == "sequence":
            return T.ArrayType(T.BIGINT)
        if name == "split" and ts and ts[0].is_string:
            return T.ArrayType(T.VARCHAR)
        if name == "map" and len(ts) == 2 \
                and all(isinstance(t, T.ArrayType) for t in ts):
            return T.MapType(ts[0].element, ts[1].element)
        if name == "map_keys" and isinstance(ts[0], T.MapType):
            return T.ArrayType(ts[0].key)
        if name == "map_values" and isinstance(ts[0], T.MapType):
            return T.ArrayType(ts[0].value)
        return None

    def _Parameter(self, node):
        raise AnalysisError(
            "unbound ? parameter (only valid inside PREPARE; bind with "
            "EXECUTE ... USING)")

    def _ScalarSubquery(self, node):
        raise AnalysisError("scalar subquery must be planned (init plan)")

    def _InSubquery(self, node):
        raise AnalysisError("IN subquery must be planned (semi join)")

    def _Exists(self, node):
        raise AnalysisError("EXISTS must be planned (semi join)")

    def _WindowFunction(self, node):
        raise AnalysisError(
            "window function in invalid context (only SELECT items and "
            "ORDER BY may contain OVER)")

    def _Star(self, node):
        raise AnalysisError("* only allowed at the top of SELECT")
