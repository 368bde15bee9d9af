"""Expression evaluation: IR -> torch tensor programs.

The counterpart of ``presto_tpu/expr/compiler.py`` (reference
presto-main/.../sql/gen/ExpressionCompiler.java:93 and
PageFunctionCompiler.java:98). PyTorch runs eagerly, so "compiling" an
expression means binding it to a schema once; each call interprets the
IR over the batch's tensors on the batch's device. No program cache is
needed.

Three-valued logic (AND/OR/NOT, BETWEEN, IS NULL, IF, CASE, COALESCE,
IN, NULLIF, TRY) follows ANSI SQL semantics, mirroring Presto's
SpecialForm handling in sql/gen/AndCodeGenerator etc. Row errors of a
conditional follow the branch taken, as the row-at-a-time reference
never evaluates the other one.
Row errors ride the int32 per-row error channel of ``functions.Val`` and
reduce to one device scalar per batch (``_err_scalar``).
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Column, Schema, repeat_rows
from . import array_functions  # noqa: F401  (registers the array functions)
from . import functions as F
from .array_functions import compact_elements, in_length
from .functions import Val, cast_val, merge_err
from .ir import (
    Call, Cast, Expr, Form, InputRef, LambdaExpr, LambdaRef, Literal,
    Param, SpecialForm,
)
from .params import param_val

#: functions whose lambda arguments are evaluated over array elements
HIGHER_ORDER = frozenset(
    ["transform", "filter", "any_match", "all_match", "none_match",
     "reduce"])

#: lambda parameter bindings of the expression being evaluated, one frame
#: per enclosing lambda; per thread, as a probe side may evaluate on a
#: producer thread while its build evaluates on the consumer's
_LAMBDA = threading.local()


def _lambda_stack() -> List[List[Val]]:
    stack = getattr(_LAMBDA, "stack", None)
    if stack is None:
        stack = _LAMBDA.stack = []
    return stack


def _masked_err(cond, err):
    """err where cond else 0 (None-transparent)."""
    if err is None:
        return None
    return torch.where(cond, err, 0).to(torch.int32)


def eval_expr(expr: Expr, inputs: List[Val]) -> Val:
    """Evaluate an expression against input column Vals."""
    if isinstance(expr, InputRef):
        return inputs[expr.index]
    if isinstance(expr, Literal):
        valid = inputs[0].valid
        return Val.constant(expr.value, expr.type, valid.shape[0],
                            valid.device)
    if isinstance(expr, Param):
        # plan-template parameter: this query's binding, read from the
        # binding scope (expr/params.py), never a baked constant
        valid = inputs[0].valid
        return param_val(expr, valid.shape[0], valid.device)
    if isinstance(expr, Cast):
        arg = eval_expr(expr.arg, inputs)
        out = cast_val(arg, expr.type)
        out.err = merge_err(out.err, arg.err)
        return out
    if isinstance(expr, LambdaRef):
        return _lambda_stack()[expr.level][expr.index]
    if isinstance(expr, Call):
        if expr.name in HIGHER_ORDER:
            return _eval_higher_order(expr, inputs)
        args = [eval_expr(a, inputs) for a in expr.args]
        out = F.lookup(expr.name)(args, expr.type)
        # strict calls: an argument's row error poisons the call's row
        out.err = merge_err(out.err, *[a.err for a in args])
        return out
    if isinstance(expr, SpecialForm):
        return _eval_special(expr, inputs)
    raise NotImplementedError(f"{type(expr).__name__} expressions are not ported")


def _repeat_val(v: Val, L: int) -> Val:
    """Lift an outer-row Val to element granularity (row i -> L copies)."""
    return Val(repeat_rows(v.data, L), v.valid.repeat_interleave(L),
               v.type, v.dictionary,
               err=None if v.err is None else v.err.repeat_interleave(L))


def _eval_higher_order(expr: Call, inputs: List[Val]) -> Val:
    """Array higher-order functions: the lambda body runs once over the
    FLATTENED element array [cap*L] (captured outer columns repeat per
    element), then results fold back to [cap, L] (reference
    sql/gen/LambdaBytecodeGenerator.java invokes the lambda per element).
    reduce folds sequentially over the L element slots."""
    name = expr.name
    stack = _lambda_stack()
    arr = eval_expr(expr.args[0], inputs)
    values, lengths, elem_valid = arr.data
    cap, L = values.shape[0], values.shape[1]
    inl = in_length(values, lengths)
    et = expr.args[0].type.element

    if name == "reduce":
        init = eval_expr(expr.args[1], inputs)
        step_lam: LambdaExpr = expr.args[2]
        out_lam: LambdaExpr = expr.args[3]
        state = init
        for j in range(L):
            xj = Val(values[:, j], (elem_valid & inl)[:, j], et,
                     arr.dictionary)
            stack.append([state, xj])
            try:
                new = eval_expr(step_lam.body, inputs)
            finally:
                stack.pop()
            active = inl[:, j]
            state = Val(torch.where(active, new.data, state.data),
                        torch.where(active, new.valid, state.valid),
                        new.type, new.dictionary,
                        err=merge_err(state.err, _masked_err(active,
                                                             new.err)))
        stack.append([state])
        try:
            out = eval_expr(out_lam.body, inputs)
        finally:
            stack.pop()
        out.valid = out.valid & arr.valid
        out.err = merge_err(out.err, arr.err)
        return out

    lam: LambdaExpr = expr.args[1]
    elem = Val(values.reshape(-1), (elem_valid & inl).reshape(-1), et,
               arr.dictionary)
    rep_inputs = [_repeat_val(v, L) for v in inputs]
    # nested lambdas: enclosing frames lift to the new element granularity
    old_stack = list(stack)
    stack[:] = [[_repeat_val(v, L) for v in frame]
                for frame in old_stack] + [[elem]]
    try:
        body = eval_expr(lam.body, rep_inputs)
    finally:
        stack[:] = old_stack
    body_err = None
    if body.err is not None:
        body_err = torch.where(inl, body.err.reshape(cap, L), 0).max(1).values
    if name == "transform":
        return Val((body.data.reshape(cap, L), lengths,
                    body.valid.reshape(cap, L) & inl), arr.valid, expr.type,
                   dictionary=body.dictionary,
                   err=merge_err(arr.err, body_err))
    if name == "filter":
        keep = (body.data & body.valid).reshape(cap, L) & inl
        out = compact_elements(values, elem_valid, keep, arr, expr.type)
        out.err = merge_err(out.err, body_err)
        return out
    # any/all/none_match: ANSI three-valued fold over the elements
    b = body.data.reshape(cap, L)
    bv = body.valid.reshape(cap, L)
    any_true = (b & bv & inl).any(1)
    any_null = (~bv & inl).any(1)
    if name == "all_match":
        any_false = (~b & bv & inl).any(1)
        data, valid = ~any_false, any_false | ~any_null
    else:
        data = any_true if name == "any_match" else ~any_true
        valid = any_true | ~any_null
    return Val(data, valid & arr.valid, T.BOOLEAN,
               err=merge_err(arr.err, body_err))


def _eval_special(expr: SpecialForm, inputs: List[Val]) -> Val:
    form = expr.form
    if form == Form.AND or form == Form.OR:
        vals = [eval_expr(a, inputs) for a in expr.args]
        return _logical(vals, is_and=(form == Form.AND))
    if form == Form.IS_NULL:
        v = eval_expr(expr.args[0], inputs)
        return Val(~v.valid, torch.ones_like(v.valid), T.BOOLEAN, err=v.err)
    if form == Form.BETWEEN:
        v, lo, hi = (eval_expr(a, inputs) for a in expr.args)
        ge = F.lookup("ge")([v, lo], T.BOOLEAN)
        le = F.lookup("le")([v, hi], T.BOOLEAN)
        out = _logical([ge, le], is_and=True)
        out.err = merge_err(out.err, v.err, lo.err, hi.err)
        return out
    if form == Form.IF:
        cond = eval_expr(expr.args[0], inputs)
        then = eval_expr(expr.args[1], inputs)
        els = eval_expr(expr.args[2], inputs)
        out = _merge_branch(cond.valid & cond.data, then, els, expr.type)
        out.err = merge_err(out.err, cond.err)
        return out
    if form == Form.SWITCH:
        # SWITCH(c1, v1, c2, v2, ..., default), folded right to left so
        # earlier WHENs win; an earlier match also masks later branches'
        # and conditions' errors
        out = eval_expr(expr.args[-1], inputs)
        pairs = list(zip(expr.args[:-1:2], expr.args[1::2]))
        for cond_e, val_e in reversed(pairs):
            cond = eval_expr(cond_e, inputs)
            val = eval_expr(val_e, inputs)
            out = _merge_branch(cond.valid & cond.data, val, out, expr.type)
            out.err = merge_err(out.err, cond.err)
        return out
    if form == Form.COALESCE:
        vals = [eval_expr(a, inputs) for a in expr.args]
        out = vals[-1]
        for v in reversed(vals[:-1]):
            nxt = _merge_branch(v.valid, v, out, expr.type)
            # v's own errors always surface (v made itself NULL by
            # erroring); later args' errors only where v was NULL
            nxt.err = merge_err(v.err, _masked_err(~v.valid, out.err))
            out = nxt
        return out
    if form == Form.IN:
        return _eval_in(expr, inputs)
    if form == Form.NULL_IF:
        a = eval_expr(expr.args[0], inputs)
        b = eval_expr(expr.args[1], inputs)
        eq = F.lookup("eq")([a, b], T.BOOLEAN)
        return Val(a.data, a.valid & ~(eq.valid & eq.data), a.type,
                   a.dictionary, err=merge_err(a.err, b.err))
    if form == Form.TRY:
        v = eval_expr(expr.args[0], inputs)
        if v.err is None:
            return v
        return Val(v.data, v.valid & (v.err == 0), v.type, v.dictionary)
    raise NotImplementedError(f"special form {form} is not ported")


def _logical(vals: List[Val], is_and: bool) -> Val:
    """ANSI AND/OR over any number of boolean Vals.

    Errors honor left-to-right short-circuit evaluation (reference
    sql/gen/AndCodeGenerator): a row error in arg i is suppressed where an
    earlier arg already decided the result.
    """
    err = None
    decided = torch.zeros_like(vals[0].valid)
    for v in vals:
        if v.err is not None:
            err = merge_err(err, _masked_err(~decided, v.err))
        decided = decided | (v.valid & (~v.data if is_and else v.data))
    all_valid = torch.ones_like(vals[0].valid)
    for v in vals:
        all_valid = all_valid & v.valid
    if is_and:
        known_false = torch.zeros_like(vals[0].valid)
        for v in vals:
            known_false = known_false | (v.valid & ~v.data)
        data = ~known_false & all_valid
        return Val(data, all_valid | known_false, T.BOOLEAN, err=err)
    known_true = torch.zeros_like(vals[0].valid)
    for v in vals:
        known_true = known_true | (v.valid & v.data)
    return Val(known_true, all_valid | known_true, T.BOOLEAN, err=err)


def _merge_branch(take_a: torch.Tensor, a: Val, b: Val,
                  out_type: T.Type) -> Val:
    """where(take_a, a, b) with validity merge and dictionary unification.
    Row errors follow the taken branch."""
    if a.err is None and b.err is None:
        err = None
    else:
        zeros = torch.zeros(take_a.shape, dtype=torch.int32,
                            device=take_a.device)
        err = torch.where(take_a,
                          a.err if a.err is not None else zeros,
                          b.err if b.err is not None else zeros)
    if out_type.is_string:
        da, db = a.dictionary or (), b.dictionary or ()
        if da == db:
            vocab = da
            data = torch.where(take_a, a.data, b.data)
        else:
            # b's codes move into a vocabulary that extends a's
            vocab_list = list(da)
            lookup = {s: i for i, s in enumerate(vocab_list)}
            remap_b = np.empty(len(db) + 1, dtype=np.int32)
            remap_b[-1] = -1
            for i, s in enumerate(db):
                if s not in lookup:
                    lookup[s] = len(vocab_list)
                    vocab_list.append(s)
                remap_b[i] = lookup[s]
            vocab = tuple(vocab_list)
            tbl = torch.from_numpy(remap_b).to(take_a.device)
            b_codes = tbl[torch.where(b.data >= 0, b.data,
                                      len(db)).to(torch.int64)]
            data = torch.where(take_a, a.data, b_codes)
        valid = torch.where(take_a, a.valid, b.valid)
        return Val(data, valid, out_type, vocab, err=err)
    a = cast_val(a, out_type)
    b = cast_val(b, out_type)
    cond = take_a[:, None] if a.data.ndim == 2 else take_a
    return Val(torch.where(cond, a.data, b.data),
               torch.where(take_a, a.valid, b.valid), out_type, err=err)


def _eval_in(expr: SpecialForm, inputs: List[Val]) -> Val:
    v = eval_expr(expr.args[0], inputs)
    items = [eval_expr(a, inputs) for a in expr.args[1:]]
    if v.type.is_string and v.dictionary is not None:
        # constant items only: one vocabulary table, one gather
        targets = set()
        for it in items:
            s = F._string_literal_of(it)
            if s is None:
                raise NotImplementedError("IN with non-constant string items")
            targets.add(F._str_padded(v, s))
        table = F.vocab_table(v.dictionary, lambda s: s in targets, np.bool_,
                              v.data.device)
        return Val(F._code_gather(table, v.data), v.valid, T.BOOLEAN,
                   err=v.err)
    # numeric: an OR of equalities (ANSI null semantics come along)
    eqs = [F.lookup("eq")([v, it], T.BOOLEAN) for it in items]
    out = _logical(eqs, is_and=False)
    out.err = merge_err(out.err, v.err, *[it.err for it in items])
    return out


def _inputs(batch: Batch) -> List[Val]:
    inputs = [Val(c.data, c.validity, c.type, c.dictionary)
              for c in batch.columns]
    if not inputs:
        # zero-column input (SELECT without FROM): shape carrier so literal
        # projections broadcast to the batch capacity
        inputs = [Val(batch.row_mask, batch.row_mask, T.BOOLEAN)]
    return inputs


def _err_scalar(errs: List[Optional[torch.Tensor]], row_mask):
    """Reduce per-row error codes over live rows to one device scalar —
    or None when the expression is statically error-free."""
    merged = merge_err(*errs)
    if merged is None:
        return None
    return torch.where(row_mask, merged, 0).max().to(torch.int32)


def compile_projection(exprs: Sequence[Expr], out_names: Sequence[str],
                       schema: Schema, errors: bool = False
                       ) -> Callable[[Batch], Batch]:
    """fn(batch)->batch with columns named out_names. With ``errors=True``
    fn returns ``(batch, err_code)``: err_code is a device int32 scalar,
    the max row error code over live rows (None when error-free)."""
    exprs = list(exprs)
    out_schema = Schema([(n, e.type) for n, e in zip(out_names, exprs)])

    def run(batch: Batch):
        outs = [eval_expr(e, _inputs(batch)) for e in exprs]
        cols = [Column(o.type, o.data, o.valid & batch.row_mask, o.dictionary)
                for o in outs]
        result = Batch(out_schema, cols, batch.row_mask)
        if not errors:
            return result
        return result, _err_scalar([o.err for o in outs], batch.row_mask)
    return run


def compile_filter(pred: Expr, schema: Schema, errors: bool = False
                   ) -> Callable[[Batch], Batch]:
    """fn(batch)->batch with a narrowed row_mask; a NULL predicate drops
    the row (ANSI WHERE). ``errors=True`` returns ``(batch, err_code)``."""

    def run(batch: Batch):
        p = eval_expr(pred, _inputs(batch))
        keep = batch.row_mask & p.valid & p.data
        result = Batch(batch.schema, batch.columns, keep)
        if not errors:
            return result
        return result, _err_scalar([p.err], batch.row_mask)
    return run
