"""Expression evaluation: IR -> torch tensor programs.

The counterpart of ``presto_tpu/expr/compiler.py`` (reference
presto-main/.../sql/gen/ExpressionCompiler.java:93 and
PageFunctionCompiler.java:98). PyTorch runs eagerly, so "compiling" an
expression means binding it to a schema once; each call interprets the
IR over the batch's tensors on the batch's device. No program cache is
needed.

Three-valued logic (AND/OR/NOT, BETWEEN, IS NULL) follows ANSI SQL
semantics, mirroring Presto's SpecialForm handling in
sql/gen/AndCodeGenerator etc.; the other special forms (IF, CASE,
COALESCE, IN, NULLIF, TRY) are not ported yet and raise
NotImplementedError.
Row errors ride the int32 per-row error channel of ``functions.Val`` and
reduce to one device scalar per batch (``_err_scalar``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .. import types as T
from ..batch import Batch, Column, Schema
from . import functions as F
from .functions import Val, cast_val, merge_err
from .ir import Call, Cast, Expr, Form, InputRef, Literal, SpecialForm


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
    if isinstance(expr, Cast):
        arg = eval_expr(expr.arg, inputs)
        out = cast_val(arg, expr.type)
        out.err = merge_err(out.err, arg.err)
        return out
    if isinstance(expr, Call):
        args = [eval_expr(a, inputs) for a in expr.args]
        out = F.lookup(expr.name)(args, expr.type)
        # strict calls: an argument's row error poisons the call's row
        out.err = merge_err(out.err, *[a.err for a in args])
        return out
    if isinstance(expr, SpecialForm):
        return _eval_special(expr, inputs)
    raise NotImplementedError(f"{type(expr).__name__} expressions are not ported")


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
