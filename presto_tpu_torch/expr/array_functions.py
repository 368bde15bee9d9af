"""ARRAY and MAP scalar functions over the padded dense representation.

The counterpart of ``presto_tpu/expr/array_functions.py`` (reference
presto-main/.../operator/scalar/ArrayFunctions and the Array* classes,
spi/block/ArrayBlock.java): an array Val's ``data`` is the tuple
(values [cap, L], lengths [cap] int32, elem_valid [cap, L] bool), and
every function below is a tensor program over that tile — no offsets
indirection, no per-row loops. A MAP Val's data is (keys, values, lengths,
val_valid) with a (key vocabulary, value vocabulary) dictionary. The
higher-order functions (transform, filter, reduce, ...) live in
compiler.py because they evaluate lambda IR.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import errors as E
from .. import types as T
from ..batch import unify_dictionaries
from ..ops.sort import rank_codes, unrank_table
from ..types import Type
from .functions import (
    Val, _all_valid, _code_gather, _string_literal_of, cast_val, flag_err,
    merge_err, register,
)


def in_length(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[cap, L] mask of the slots below each row's length."""
    L = values.shape[1]
    return torch.arange(L, device=values.device)[None, :] < lengths[:, None]


def unify_codes(vals: Sequence[Val]):
    """Re-code each string Val onto one merged vocabulary."""
    vocab, remaps = unify_dictionaries(
        [SimpleNamespace(dictionary=v.dictionary) for v in vals])
    dev = vals[0].data.device
    return vocab, [_code_gather(torch.from_numpy(r).to(dev), v.data)
                   for v, r in zip(vals, remaps)]


def _flat_strings(values: torch.Tensor, dictionary) -> Val:
    return Val(values.reshape(-1), None, T.VARCHAR, dictionary=dictionary)


@register("array_constructor")
def _array_constructor(args: List[Val], out: Type) -> Val:
    et = out.element
    if not args:
        raise NotImplementedError("empty ARRAY[] literal")
    dictionary: Optional[Tuple[str, ...]] = None
    if et.is_string:
        dictionary, codes = unify_codes(args)
        values = torch.stack(codes, dim=1)
    else:
        values = torch.stack([cast_val(a, et).data for a in args], dim=1)
    elem_valid = torch.stack([a.valid for a in args], dim=1)
    n = values.shape[0]
    lengths = torch.full((n,), len(args), dtype=torch.int32,
                         device=values.device)
    return Val((values, lengths, elem_valid),
               torch.ones(n, dtype=torch.bool, device=values.device), out,
               dictionary=dictionary, err=merge_err(*[a.err for a in args]))


@register("cardinality")
def _cardinality(args, out):
    (a,) = args
    lengths = a.data[2] if isinstance(a.type, T.MapType) else a.data[1]
    return Val(lengths.to(torch.int64), a.valid, out)


def _gather_element(a: Val, j: torch.Tensor):
    """values[i, j[i]] and the element's validity (j clamped in range)."""
    values, _, elem_valid = a.data
    jj = j.clamp(0, values.shape[1] - 1).to(torch.int64)[:, None]
    return (torch.gather(values, 1, jj)[:, 0],
            torch.gather(elem_valid, 1, jj)[:, 0])


@register("subscript")
def _subscript(args, out):
    a, i = args
    if isinstance(a.type, T.MapType):
        return _map_lookup(a, i, out, null_on_missing=False)
    idx = i.data.to(torch.int64)
    in_range = (idx >= 1) & (idx <= a.data[1].to(torch.int64))
    data, ev = _gather_element(a, idx - 1)
    both = a.valid & i.valid
    # an out-of-bounds subscript is an error (ArraySubscriptOperator)
    err = flag_err(both & ~in_range, E.INVALID_FUNCTION_ARGUMENT)
    return Val(data, both & in_range & ev, out, dictionary=a.dictionary,
               err=merge_err(err, a.err, i.err))


@register("element_at")
def _element_at(args, out):
    a, i = args
    if isinstance(a.type, T.MapType):
        return _map_lookup(a, i, out, null_on_missing=True)
    idx = i.data.to(torch.int64)
    ln = a.data[1].to(torch.int64)
    # a negative index counts from the end; index 0 raises
    # (ElementAtFunction: "SQL array indices start at 1")
    j = torch.where(idx < 0, ln + idx, idx - 1)
    in_range = (j >= 0) & (j < ln)
    data, ev = _gather_element(a, j)
    err = flag_err(a.valid & i.valid & (idx == 0),
                   E.INVALID_FUNCTION_ARGUMENT)
    return Val(data, a.valid & i.valid & in_range & ev, out,
               dictionary=a.dictionary, err=merge_err(err, a.err, i.err))


def _elem_compare_eq(a: Val, x: Val) -> torch.Tensor:
    """values[i, j] == x[i], unifying vocabularies for strings."""
    values, lengths, elem_valid = a.data
    if a.type.element.is_string:
        _, (flat, xdata) = unify_codes(
            [_flat_strings(values, a.dictionary), x])
        values = flat.reshape(values.shape)
    else:
        xdata = cast_val(x, a.type.element).data
    return (values == xdata[:, None]) & elem_valid & in_length(values,
                                                               lengths)


@register("contains")
def _contains(args, out):
    a, x = args
    values, lengths, elem_valid = a.data
    any_hit = _elem_compare_eq(a, x).any(1)
    # ANSI 3VL: no match over an array with NULL elements is unknown
    has_null = (~elem_valid & in_length(values, lengths)).any(1)
    return Val(any_hit, a.valid & x.valid & (any_hit | ~has_null),
               T.BOOLEAN, err=merge_err(a.err, x.err))


@register("array_position")
def _array_position(args, out):
    a, x = args
    hit = _elem_compare_eq(a, x)
    first = torch.argmax(hit.to(torch.int32), dim=1) + 1
    pos = torch.where(hit.any(1), first, 0).to(torch.int64)
    return Val(pos, a.valid & x.valid, out, err=merge_err(a.err, x.err))


def _sentinel(dtype, is_max: bool):
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


def _array_extreme(is_max):
    def impl(args, out):
        (a,) = args
        values, lengths, elem_valid = a.data
        inl = in_length(values, lengths)
        live = elem_valid & inl
        unrank = None
        if a.type.element.is_string:
            values = rank_codes(values, a.dictionary or ())
            unrank = unrank_table(a.dictionary or (), values.device)
        masked = torch.where(live, values, torch.full(
            (), _sentinel(values.dtype, is_max), dtype=values.dtype,
            device=values.device))
        data = masked.max(1).values if is_max else masked.min(1).values
        # Presto: NULL if the array holds a NULL element
        has_null = (~elem_valid & inl).any(1)
        if unrank is not None:
            data = unrank[data.clamp(0, unrank.shape[0] - 1)]
        return Val(data, a.valid & live.any(1) & ~has_null, out,
                   dictionary=a.dictionary, err=a.err)
    return impl


register("array_max")(_array_extreme(True))
register("array_min")(_array_extreme(False))


def _row_lexsort(primary: torch.Tensor, secondary: torch.Tensor):
    """Per-row stable order by (primary, secondary) along axis 1."""
    order = torch.sort(secondary, dim=1, stable=True).indices
    p = torch.gather(primary, 1, order)
    return torch.gather(order, 1, torch.sort(p, dim=1, stable=True).indices)


@register("array_sort")
def _array_sort(args, out):
    """Ascending, nulls last (reference ArraySortFunction)."""
    (a,) = args
    values, lengths, elem_valid = a.data
    inl = in_length(values, lengths)
    svals = values
    if a.type.element.is_string:
        svals = rank_codes(values, a.dictionary or ())
    # slot class: 0 = value, 1 = null element, 2 = beyond length
    slot = torch.where(inl & elem_valid, 0, torch.where(inl, 1, 2))
    neutral = torch.where(inl & elem_valid, svals, torch.zeros_like(svals))
    order = _row_lexsort(slot, neutral)
    return Val((torch.gather(values, 1, order), lengths,
                torch.gather(elem_valid & inl, 1, order)), a.valid, out,
               dictionary=a.dictionary, err=a.err)


def compact_elements(values, elem_valid, keep, a: Val, out: Type) -> Val:
    """Keep the flagged elements in order; recompute the lengths."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    return Val((torch.gather(values, 1, order), keep.sum(1).to(torch.int32),
                torch.gather(elem_valid & keep, 1, order)), a.valid, out,
               dictionary=a.dictionary, err=a.err)


@register("array_distinct")
def _array_distinct(args, out):
    """First-occurrence order (reference ArrayDistinctFunction)."""
    (a,) = args
    values, lengths, elem_valid = a.data
    inl = in_length(values, lengths)
    live = inl & elem_valid
    nulls = inl & ~elem_valid
    L = values.shape[1]
    # pairwise: dup[i, j] = an earlier slot holds an equal value (or null)
    eq = values[:, :, None] == values[:, None, :]
    prior = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                  device=values.device), diagonal=-1)
    dup_val = (eq & live[:, :, None] & live[:, None, :]
               & prior[None]).any(2)
    dup_null = (nulls[:, :, None] & nulls[:, None, :] & prior[None]).any(2)
    keep = inl & ~torch.where(elem_valid, dup_val, dup_null)
    return compact_elements(values, elem_valid, keep, a, out)


def _take_cols(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, j.to(torch.int64))


@register("array_concat")
def _array_concat(args, out):
    if len(args) > 2:
        # variadic: left fold (reference ArrayConcatFunction)
        acc = args[0]
        for nxt in args[1:]:
            acc = _array_concat([acc, nxt], out)
        return acc
    a, b = args
    dictionary: Optional[Tuple[str, ...]] = None
    if a.type.element.is_string:
        av, al, ae = a.data
        bv, bl, be = b.data
        dictionary, (ac, bc) = unify_codes([_flat_strings(av, a.dictionary),
                                            _flat_strings(bv, b.dictionary)])
        a = Val((ac.reshape(av.shape), al, ae), a.valid, a.type, dictionary)
        b = Val((bc.reshape(bv.shape), bl, be), b.valid, b.type, dictionary)
    av, al, ae = a.data
    bv, bl, be = b.data
    La, Lb = av.shape[1], bv.shape[1]
    n = av.shape[0]
    # out[i, j] = a[i, j] if j < len_a else b[i, j - len_a]
    j = torch.arange(La + Lb, device=av.device)[None, :].expand(n, La + Lb)
    from_a = j < al[:, None]
    bj = (j - al[:, None]).clamp(0, Lb - 1)
    aj = j.clamp(0, La - 1)
    new_len = (al + bl).to(torch.int32)
    vals = torch.where(from_a, _take_cols(av, aj), _take_cols(bv, bj))
    ev = torch.where(from_a, _take_cols(ae, aj), _take_cols(be, bj)) \
        & (j < new_len[:, None])
    return Val((vals, new_len, ev), a.valid & b.valid, out,
               dictionary=dictionary, err=merge_err(a.err, b.err))


@register("repeat")
def _repeat(args, out):
    x, n = args
    if n.literal is None:
        raise NotImplementedError("repeat() count must be a constant")
    k = max(int(n.literal), 0)
    rows = x.data.shape[0]
    values = x.data[:, None].expand(rows, max(k, 1)).contiguous()
    ev = x.valid[:, None].expand(values.shape).contiguous()
    lengths = torch.full((rows,), k, dtype=torch.int32, device=values.device)
    return Val((values, lengths, ev), n.valid, out, dictionary=x.dictionary,
               err=merge_err(x.err, n.err))


@register("sequence")
def _sequence(args, out):
    """sequence(a, b[, step]) with constant bounds (static length)."""
    for v in args:
        if v.literal is None:
            raise NotImplementedError("sequence() bounds must be constants")
    start, stop = int(args[0].literal), int(args[1].literal)
    step = int(args[2].literal) if len(args) > 2 else (
        1 if stop >= start else -1)
    if step == 0:
        raise E.QueryError(E.INVALID_FUNCTION_ARGUMENT,
                           "sequence step cannot be zero")
    seq = list(range(start, stop + (1 if step > 0 else -1), step))
    n = args[0].data.shape[0]
    dev = args[0].data.device
    k = max(len(seq), 1)
    values = torch.tensor(seq or [0], dtype=torch.int64,
                          device=dev)[None, :].expand(n, k).contiguous()
    lengths = torch.full((n,), len(seq), dtype=torch.int32, device=dev)
    ev = (torch.arange(k, device=dev) < len(seq))[None, :].expand(
        n, k).contiguous()
    return Val((values, lengths, ev), _all_valid(args), out)


@register("split")
def _split(args, out):
    """split(s, delim[, limit]): each vocabulary entry's parts become a
    host table, gathered by code."""
    a, d = args[0], args[1]
    delim = _string_literal_of(d)
    if a.dictionary is None or delim is None:
        raise NotImplementedError("split() needs a dictionary column and "
                                  "a constant delimiter")
    limit = None
    if len(args) > 2:
        if args[2].literal is None:
            raise NotImplementedError("split() limit must be a constant")
        limit = int(args[2].literal)
    parts_per = [s.split(delim, limit - 1 if limit else -1) if delim
                 else [s] for s in a.dictionary]
    L = max([len(p) for p in parts_per] + [1])
    lookup: dict = {}
    val_table = np.zeros((len(a.dictionary) + 1, L), dtype=np.int32)
    len_table = np.zeros(len(a.dictionary) + 1, dtype=np.int32)
    for i, parts in enumerate(parts_per):
        len_table[i] = len(parts)
        for j, p in enumerate(parts):
            val_table[i, j] = lookup.setdefault(p, len(lookup))
    dev = a.data.device
    values = _code_gather(torch.from_numpy(val_table).to(dev), a.data)
    lengths = _code_gather(torch.from_numpy(len_table).to(dev), a.data)
    return Val((values, lengths, in_length(values, lengths)), a.valid, out,
               dictionary=tuple(lookup), err=a.err)


# -- MAP ---------------------------------------------------------------------

def _pad_width(t: torch.Tensor, L: int) -> torch.Tensor:
    if t.shape[1] >= L:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], L - t.shape[1]))], dim=1)


@register("map")
def _map_constructor(args, out):
    """map(key_array, value_array) (reference MapConstructor)."""
    karr, varr = args
    kv, kl, ke = karr.data
    vv, vl, ve = varr.data
    L = max(kv.shape[1], vv.shape[1])
    kv, ke, vv, ve = (_pad_width(t, L) for t in (kv, ke, vv, ve))
    # equal lengths required; duplicate keys raise ("Duplicate map keys
    # are not allowed")
    inl = in_length(kv, kl)
    prior = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                  device=kv.device), diagonal=-1)
    dup_rows = ((kv[:, :, None] == kv[:, None, :]) & inl[:, :, None]
                & inl[:, None, :] & prior[None]).any(2).any(1)
    err = flag_err(karr.valid & varr.valid & ((kl != vl) | dup_rows),
                   E.INVALID_FUNCTION_ARGUMENT)
    dictionary = (karr.dictionary, varr.dictionary) \
        if (karr.dictionary or varr.dictionary) else None
    return Val((kv, vv, kl, ve), karr.valid & varr.valid, out,
               dictionary=dictionary,
               err=merge_err(err, karr.err, varr.err))


def _map_lookup(m: Val, k: Val, out: Type, null_on_missing: bool) -> Val:
    keys, values, lengths, val_valid = m.data
    kd, vd = m.dictionary or (None, None)
    if m.type.key.is_string:
        _, (flat, xdata) = unify_codes([_flat_strings(keys, kd), k])
        keys = flat.reshape(keys.shape)
    else:
        xdata = cast_val(k, m.type.key).data
    hit = (keys == xdata[:, None]) & in_length(keys, lengths)
    found = hit.any(1)
    j = torch.argmax(hit.to(torch.int32), dim=1)[:, None]
    data = torch.gather(values, 1, j)[:, 0]
    vv = torch.gather(val_valid, 1, j)[:, 0]
    both = m.valid & k.valid
    err = None
    if not null_on_missing:
        # a missing key of m[k] raises (reference MapSubscriptOperator)
        err = flag_err(both & ~found, E.INVALID_FUNCTION_ARGUMENT)
    return Val(data, both & found & vv, out, dictionary=vd,
               err=merge_err(err, m.err, k.err))


@register("map_keys")
def _map_keys(args, out):
    (m,) = args
    keys, _, lengths, _ = m.data
    kd, _ = m.dictionary or (None, None)
    return Val((keys, lengths, in_length(keys, lengths)), m.valid, out,
               dictionary=kd, err=m.err)


@register("map_values")
def _map_values(args, out):
    (m,) = args
    _, values, lengths, val_valid = m.data
    _, vd = m.dictionary or (None, None)
    return Val((values, lengths, in_length(values, lengths) & val_valid),
               m.valid, out, dictionary=vd, err=m.err)
