"""Aggregation kernels: dense-slot and sort + segment-reduce GROUP BY.

The counterpart of ``presto_tpu/ops/aggregation.py`` (reference
presto-main/.../operator/HashAggregationOperator.java:48,
MultiChannelGroupByHash.java): instead of an open-addressing hash table,
a grouping either

- takes the DENSE path when every key's domain is host-known
  (dictionary codes, booleans, stats-bounded integers): the mixed-radix
  composite key code IS the group slot, reduced with ``index_add_`` /
  ``scatter_reduce_`` over K slots (``dense_group_plan``); or
- takes the SORT path: rows sort by their keys, segment boundaries give
  dense group ids and run starts, and int64 sums go through the
  sorted-run segment-sum kernel (``ops/scan.py``, a CUDA kernel on the
  card). Double sums on this path use ``index_add_``: prefix differences
  over millions of rows would lose about 1e-10 relative precision.

NULL is a group key value like any other (SQL GROUP BY semantics).
Two-phase execution mirrors Presto's PARTIAL/FINAL split (reference
AggregationNode.Step): partial emits state columns, final re-aggregates
states.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Column, Schema, bucket_capacity
from ..types import Type
from .join import lexsort_permutation
from .scan import segment_sum_sorted_i64
from .sort import rank_codes, unrank_table

_SUPPORTED = ("sum", "count", "count_star", "min", "max", "avg",
              "var_samp", "var_pop", "stddev_samp", "stddev_pop",
              "bool_and", "bool_or", "approx_percentile",
              "approx_distinct")
#: aggregates the reference supports that the port does not run yet
_UNPORTED = ("var_samp", "var_pop", "stddev_samp", "stddev_pop",
             "bool_and", "bool_or", "approx_percentile", "approx_distinct")

#: largest fused key-domain of the unbounded dense path (dictionary and
#: boolean keys); shared semantics with the reference
_DENSE_GROUP_LIMIT = 4096

#: largest fused key-domain of the stats-bounded dense path; past it the
#: sort-segment path runs. Shared with the planner's rewrite gate
#: (optimizer._attach_group_bounds).
DENSE_SCATTER_LIMIT = 1 << 21


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: fn over an input column (None for count(*))."""

    fn: str
    input: Optional[int]
    output_type: Type
    name: str = ""
    mask: Optional[int] = None
    param: Optional[float] = None

    def __post_init__(self):
        assert self.fn in _SUPPORTED, self.fn

    def state_types(self) -> List[Tuple[str, Type]]:
        base = self.name or self.fn
        if self.fn in _UNPORTED:
            raise NotImplementedError(f"aggregate {self.fn} is not ported")
        if self.fn in ("count", "count_star"):
            return [(f"{base}$cnt", T.BIGINT)]
        if self.fn == "avg":
            return [(f"{base}$sum", self._sum_type()),
                    (f"{base}$cnt", T.BIGINT)]
        return [(f"{base}$val", self._sum_type() if self.fn == "sum"
                 else self.output_type), (f"{base}$cnt", T.BIGINT)]

    def _sum_type(self) -> Type:
        if isinstance(self.output_type, T.DecimalType):
            return T.DecimalType(38, self.output_type.scale)
        return self.output_type


def _check_ported(aggs: Sequence[AggSpec]) -> None:
    for a in aggs:
        for _, st in a.state_types():
            if getattr(st, "storage_width", None):
                raise NotImplementedError(
                    f"{a.fn} over {a.output_type.display()} needs long-"
                    "decimal state, which is not ported")


def _max_sentinel(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _min_sentinel(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _fill(x: torch.Tensor, keep: torch.Tensor, value) -> torch.Tensor:
    return torch.where(keep, x, torch.full((), value, dtype=x.dtype,
                                           device=x.device))


def _group_key_ops(batch: Batch,
                   group_indices: Sequence[int]) -> List[torch.Tensor]:
    """Lexicographic sort operands for GROUP BY keys: [dead_rank, then per
    key (null_rank, null-neutralized data)]."""
    key_ops = [(~batch.row_mask).to(torch.int32)]
    for gi in group_indices:
        c = batch.columns[gi]
        if c.data.ndim == 2:
            raise NotImplementedError("grouping by long decimals is not ported")
        data = c.data.to(torch.int32) if c.data.dtype == torch.bool else c.data
        key_ops.append((~c.validity).to(torch.int32))   # nulls last
        key_ops.append(_fill(data, c.validity, 0))
    return key_ops


def _first_slots(flags: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """Indices of the True entries of ``flags`` in order, padded with
    ``fill`` to ``cap`` (a static-size nonzero)."""
    n = flags.shape[0]
    rank = torch.cumsum(flags.to(torch.int64), 0) - 1
    tgt = torch.where(flags & (rank < cap), rank, cap)
    out = torch.full((cap + 1,), fill, dtype=torch.int64, device=flags.device)
    out.scatter_(0, tgt, torch.arange(n, device=flags.device))
    return out[:cap]


def _group_sort(batch: Batch, group_indices: Sequence[int]):
    """Sort rows by group keys. Returns (sorted column data, sorted
    validity, sorted mask, boundary, group_id, num_groups); boundary marks
    the first live row of each group."""
    key_ops = _group_key_ops(batch, group_indices)
    perm = lexsort_permutation(key_ops)
    s_keys = [k[perm] for k in key_ops[1:]]
    s_mask = batch.row_mask[perm]
    s_data = [c.data[perm] for c in batch.columns]
    s_valid = [c.validity[perm] for c in batch.columns]
    diff = torch.zeros_like(s_mask)
    for op in s_keys:
        diff = diff | (op != torch.roll(op, 1))
    first = torch.zeros_like(s_mask)
    first[0] = True
    boundary = s_mask & (diff | first)
    group_id = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp(min=0)
    num_groups = boundary.sum(dtype=torch.int64)
    return s_data, s_valid, s_mask, boundary, group_id, num_groups


def dense_path_selected(batch: Batch, group_indices: Sequence[int],
                        aggs: Sequence[AggSpec],
                        output_capacity: Optional[int] = None,
                        key_bounds=None) -> bool:
    """Host-only mirror of grouped_aggregate's dispatch: True when this
    batch/grouping takes the dense path."""
    cap = output_capacity or batch.capacity
    return dense_group_plan(batch, group_indices, cap,
                            key_bounds) is not None


@dataclasses.dataclass(frozen=True)
class DenseGroupPlan:
    """Host-static plan for the composite dense group code: one
    mixed-radix component per key (component 0 = NULL)."""

    sizes: Tuple[int, ...]
    los: Tuple[Optional[int], ...]
    K: int


def dense_group_plan(batch: Batch, group_indices: Sequence[int], cap: int,
                     key_bounds=None) -> Optional[DenseGroupPlan]:
    """Dense-path dispatch rule (host-only): every key's domain must be
    host-known — dictionary codes (|vocab|), booleans, or integer keys
    with stats-derived [lo, hi] bounds — and the composite product must
    stay under the limit; otherwise None and the sort path runs."""
    sizes: List[int] = []
    los: List[Optional[int]] = []
    bounded = False
    for j, gi in enumerate(group_indices):
        c = batch.columns[gi]
        kb = key_bounds[j] if key_bounds else None
        if c.type.is_string and c.dictionary is not None:
            sizes.append(len(c.dictionary) + 1)
            los.append(None)
        elif c.data.dtype == torch.bool:
            sizes.append(3)
            los.append(None)
        elif (kb is not None and c.data.ndim == 1
              and not c.data.is_floating_point()):
            lo, hi = int(kb[0]), int(kb[1])
            if hi < lo:
                return None
            sizes.append(hi - lo + 2)
            los.append(lo)
            bounded = True
        else:
            return None
    K = 1
    for s in sizes:
        K *= s
    limit = min(cap, DENSE_SCATTER_LIMIT if bounded else _DENSE_GROUP_LIMIT)
    if not 0 < K <= limit:
        return None
    return DenseGroupPlan(tuple(sizes), tuple(los), K)


def _dense_group_code(batch: Batch, group_indices: Sequence[int],
                      plan: DenseGroupPlan) -> torch.Tensor:
    """Fused dense group slot: mixed-radix(key components), component 0 =
    NULL. A live key outside its stats bound clamps into the domain (the
    executor raises STATS_BOUND_VIOLATION for such rows)."""
    code = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
    for gi, size, lo in zip(group_indices, plan.sizes, plan.los):
        c = batch.columns[gi]
        if lo is None:
            comp = c.data.to(torch.int64) + 1
        else:
            comp = (c.data.to(torch.int64) - lo + 1).clamp(1, size - 1)
        code = code * size + torch.where(c.validity, comp, 0)
    return code


def _dense_key_columns(batch: Batch, group_indices: Sequence[int],
                       plan: DenseGroupPlan, cap: int,
                       out_mask: torch.Tensor) -> List[Column]:
    """Decode slot indices 0..K-1 back into key columns, padded to cap."""
    K = plan.K
    slots = np.arange(K, dtype=np.int64)
    comps: List[np.ndarray] = []
    for size in reversed(list(plan.sizes)):
        comps.append(slots % size)
        slots = slots // size
    comps.reverse()
    dev = batch.device

    def padded(a: np.ndarray, dtype) -> torch.Tensor:
        out = torch.zeros(cap, dtype=dtype, device=dev)
        out[:K] = torch.from_numpy(a).to(device=dev, dtype=dtype)
        return out

    key_cols = []
    for gi, comp, lo in zip(group_indices, comps, plan.los):
        c = batch.columns[gi]
        valid = padded(comp > 0, torch.bool) & out_mask
        if lo is not None:
            data = padded(lo + np.maximum(comp - 1, 0), c.data.dtype)
        elif c.data.dtype == torch.bool:
            data = padded(comp == 2, torch.bool)
        else:
            data = padded(np.maximum(comp - 1, 0), c.data.dtype)
        key_cols.append(Column(c.type, data, valid, c.dictionary))
    return key_cols


class _SlotReducers:
    """Group reductions over a group id in [0, cap) via ``index_add_`` /
    ``scatter_reduce_`` — the dense path's reducers (group id = composite
    key code; the reference's broadcast-compare and i32 digit-scatter
    reducers are TPU workarounds), and the sort path's reducers for
    everything but its int64 sums."""

    def __init__(self, group_id: torch.Tensor, cap: int):
        self.gid, self.cap = group_id, cap

    def count(self, valid):
        return self.sum(valid.to(torch.int64))

    def sum(self, x):
        out = torch.zeros((self.cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, self.gid, x)

    def _reduce(self, x, how, init):
        out = torch.full((self.cap,), init, dtype=x.dtype, device=x.device)
        return out.scatter_reduce_(0, self.gid, x, reduce=how)

    def min(self, x):
        return self._reduce(x, "amin", _max_sentinel(x.dtype))

    def max(self, x):
        return self._reduce(x, "amax", _min_sentinel(x.dtype))

class _SegReducers(_SlotReducers):
    """Sort-path reducers: group ids are sorted runs with per-group start
    rows (absent groups point one past the end), so int64 sums take the
    sorted-run segment-sum kernel (exact, wrapping like the reference)."""

    def __init__(self, group_id: torch.Tensor, cap: int,
                 starts: torch.Tensor):
        super().__init__(group_id, cap)
        self.starts = starts

    def sum(self, x):
        if x.dtype == torch.int64 and x.ndim == 1:
            return segment_sum_sorted_i64(x, self.starts, self.cap)
        return super().sum(x)


class _GlobalReducer:
    """Single-group reducer with the reducer surface."""

    def count(self, valid):
        return valid.sum(dtype=torch.int64)

    def sum(self, x):
        return x.sum(0)

    def min(self, x):
        return x.min(0).values if x.shape[0] else torch.full(
            (), _max_sentinel(x.dtype), dtype=x.dtype, device=x.device)

    def max(self, x):
        return x.max(0).values if x.shape[0] else torch.full(
            (), _min_sentinel(x.dtype), dtype=x.dtype, device=x.device)

def _rank_reduce(codes, live, red, vocab, fn: str):
    """min/max over dictionary codes in LEXICOGRAPHIC order: map codes to
    ranks, reduce, map the winning rank back to a code."""
    ranks = rank_codes(codes, vocab)
    if fn == "min":
        r = red.min(_fill(ranks, live, torch.iinfo(torch.int64).max))
    else:
        r = red.max(_fill(ranks, live, -1))
    table = unrank_table(vocab, codes.device)
    return table[r.clamp(0, table.shape[0] - 1)]


def _segment_aggs(aggs: Sequence[AggSpec], col_data, col_valid,
                  mask: torch.Tensor, red, from_states: bool,
                  col_dicts=None) -> List[Tuple[torch.Tensor, ...]]:
    """Per-aggregate reductions: state tuples in each agg's state layout
    (raw input when ``from_states`` is False, merged states when True)."""
    results = []
    state_cursor = 0
    for agg in aggs:
        if from_states:
            n_state = len(agg.state_types())
            s_cols = list(range(state_cursor, state_cursor + n_state))
            state_cursor += n_state
            if agg.fn in ("count", "count_star"):
                results.append((red.sum(_fill(col_data[s_cols[0]], mask, 0)),))
                continue
            val_in = col_data[s_cols[0]]
            cnt_raw = col_data[s_cols[1]]
            cnt = red.sum(_fill(cnt_raw, mask, 0))
            live = mask & (cnt_raw > 0)
            vocab = col_dicts[s_cols[0]] if col_dicts else None
            if vocab is not None and agg.fn in ("min", "max"):
                val = _rank_reduce(val_in, live, red, vocab, agg.fn)
            elif agg.fn in ("sum", "avg"):
                val = red.sum(_fill(val_in, live, 0))
            elif agg.fn == "min":
                val = red.min(_fill(val_in, live, _max_sentinel(val_in.dtype)))
            else:
                val = red.max(_fill(val_in, live, _min_sentinel(val_in.dtype)))
            results.append((val, cnt))
            continue
        if agg.fn == "count_star":
            results.append((red.count(mask),))
            continue
        data = col_data[agg.input]
        valid = col_valid[agg.input] & mask
        if agg.mask is not None:
            valid = valid & col_data[agg.mask].to(torch.bool)
        cnt = red.count(valid)
        if agg.fn == "count":
            results.append((cnt,))
            continue
        vocab = col_dicts[agg.input] if col_dicts else None
        if vocab is not None and agg.fn in ("min", "max"):
            results.append((_rank_reduce(data, valid, red, vocab, agg.fn),
                            cnt))
            continue
        acc_dtype = agg.state_types()[0][1].storage_dtype
        x = data.to(acc_dtype)
        if agg.fn in ("sum", "avg"):
            val = red.sum(_fill(x, valid, 0))
        elif agg.fn == "min":
            val = red.min(_fill(x, valid, _max_sentinel(acc_dtype)))
        else:
            val = red.max(_fill(x, valid, _min_sentinel(acc_dtype)))
        results.append((val, cnt))
    return results


def _finalize(agg: AggSpec, parts):
    """state -> (output data, output validity)."""
    if agg.fn in ("count", "count_star"):
        return parts[0], torch.ones_like(parts[0], dtype=torch.bool)
    val, cnt = parts
    valid = cnt > 0
    if agg.fn == "avg":
        den = cnt.clamp(min=1)
        if isinstance(agg.output_type, T.DecimalType):
            q = val.to(torch.float64) / den.to(torch.float64)
            out = torch.sign(q) * torch.floor(
                val.abs().to(torch.float64) / den.to(torch.float64) + 0.5)
            return out.to(torch.int64), valid
        return val / den.to(val.dtype), valid
    return val.to(agg.output_type.storage_dtype), valid


def _pad_to(arr: torch.Tensor, K: int, cap: int) -> torch.Tensor:
    out = torch.zeros((cap,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out[:K] = arr[:K]
    return out


def grouped_aggregate(batch: Batch, group_indices: Sequence[int],
                      aggs: Sequence[AggSpec], mode: str = "single",
                      output_capacity: Optional[int] = None,
                      allow_dense: bool = True, key_bounds=None) -> Batch:
    """GROUP BY aggregation. mode: 'single' | 'partial' | 'final' | 'merge'.

    In 'final' and 'merge' modes the input layout is [group key
    columns..., state columns in agg order...] (the output of 'partial').
    'merge' re-combines state rows sharing a key but keeps the state
    layout. ``key_bounds`` (one Optional[(lo, hi)] per key) lets integer
    keys join the dense composite-code path."""
    assert mode in ("single", "partial", "final", "merge")
    _check_ported(aggs)
    cap = output_capacity or batch.capacity
    from_states = mode in ("final", "merge")
    n_keys = len(group_indices)
    plan = (dense_group_plan(batch, group_indices, cap, key_bounds)
            if allow_dense else None)
    dev = batch.device
    if plan is not None:
        # no-sort path: group id straight from the key data; the output
        # shrinks to the key domain's bucket when capacity is left open
        K = plan.K
        if output_capacity is None:
            cap = min(cap, bucket_capacity(K + 1))
        code = _dense_group_code(batch, group_indices, plan)
        mask = batch.row_mask
        red = _SlotReducers(torch.where(mask, code, K), K + 1)
        out_mask = torch.zeros(cap, dtype=torch.bool, device=dev)
        out_mask[:K] = red.count(mask)[:K] > 0
        key_cols = _dense_key_columns(batch, group_indices, plan, cap,
                                      out_mask)
        in_cols = batch.columns[n_keys:] if from_states else batch.columns
        raw = _segment_aggs(aggs, [c.data for c in in_cols],
                            [c.validity for c in in_cols], mask, red,
                            from_states=from_states,
                            col_dicts=[c.dictionary for c in in_cols])
        seg = [tuple(_pad_to(a, K, cap) for a in parts) for parts in raw]
    else:
        s_data, s_valid, s_mask, boundary, group_id, num_groups = \
            _group_sort(batch, group_indices)
        bidx = _first_slots(boundary, cap, batch.capacity - 1)
        out_mask = torch.arange(cap, device=dev) < num_groups
        key_cols = [Column(batch.columns[gi].type, s_data[gi][bidx],
                           s_valid[gi][bidx] & out_mask,
                           batch.columns[gi].dictionary)
                    for gi in group_indices]
        # sorted-run starts; absent groups point one past the end
        starts = torch.where(out_mask, bidx, batch.capacity).to(torch.int32)
        red = _SegReducers(group_id, cap, starts)
        if from_states:
            seg = _segment_aggs(aggs, s_data[n_keys:], s_valid[n_keys:],
                                s_mask, red, from_states=True,
                                col_dicts=[c.dictionary
                                           for c in batch.columns[n_keys:]])
        else:
            seg = _segment_aggs(aggs, s_data, s_valid, s_mask, red,
                                from_states=False,
                                col_dicts=[c.dictionary
                                           for c in batch.columns])

    def value_dict(agg: AggSpec):
        """Dictionary for a string-valued min/max output/state column."""
        if agg.fn not in ("min", "max") or agg.input is None:
            return None
        if from_states:
            cursor = 0
            for a in aggs:
                if a is agg:
                    break
                cursor += len(a.state_types())
            return batch.columns[n_keys + cursor].dictionary
        return batch.columns[agg.input].dictionary

    out_cols: List[Column] = list(key_cols)
    out_fields: List[Tuple[str, Type]] = [
        (batch.schema.names[gi], batch.schema.types[gi])
        for gi in group_indices]
    if mode in ("partial", "merge"):
        for agg, parts in zip(aggs, seg):
            vd = value_dict(agg)
            for (fname, ftype), arr in zip(agg.state_types(), parts):
                out_fields.append((fname, ftype))
                out_cols.append(Column(ftype, arr.to(ftype.storage_dtype),
                                       out_mask,
                                       vd if ftype.is_string else None))
    else:
        for agg, parts in zip(aggs, seg):
            data, valid = _finalize(agg, parts)
            out_fields.append((agg.name or agg.fn, agg.output_type))
            out_cols.append(Column(
                agg.output_type, data.to(agg.output_type.storage_dtype),
                valid & out_mask,
                value_dict(agg) if agg.output_type.is_string else None))
    return Batch(Schema(out_fields), out_cols, out_mask)


def global_aggregate(batch: Batch, aggs: Sequence[AggSpec],
                     mode: str = "single") -> Batch:
    """Aggregation without GROUP BY: one output row, even over empty input
    (reference AggregationOperator.java). 'merge' consumes state columns
    and emits merged state columns."""
    assert mode in ("single", "partial", "final", "merge")
    _check_ported(aggs)
    cap = 128  # minimum bucket; one live row
    dev = batch.device
    mask = batch.row_mask
    out_mask = torch.arange(cap, device=dev) < 1
    from_states = mode in ("final", "merge")
    cols = batch.columns
    seg = _segment_aggs(aggs, [c.data for c in cols],
                        [c.validity for c in cols], mask, _GlobalReducer(),
                        from_states=from_states,
                        col_dicts=[c.dictionary for c in cols])

    def pad(scalar: torch.Tensor, dtype) -> torch.Tensor:
        out = torch.zeros(cap, dtype=dtype, device=dev)
        out[0] = scalar.to(dtype)
        return out

    out_fields: List[Tuple[str, Type]] = []
    out_cols: List[Column] = []
    state_cursor = 0
    for agg, parts in zip(aggs, seg):
        n_state = len(agg.state_types())
        vd = None
        if agg.fn in ("min", "max") and agg.input is not None:
            vd = (cols[state_cursor].dictionary if from_states
                  else cols[agg.input].dictionary)
        state_cursor += n_state
        if mode in ("partial", "merge"):
            for (fname, ftype), arr in zip(agg.state_types(), parts):
                out_fields.append((fname, ftype))
                out_cols.append(Column(ftype, pad(arr, ftype.storage_dtype),
                                       out_mask,
                                       vd if ftype.is_string else None))
            continue
        data, valid = _finalize(agg, parts)
        dt = agg.output_type.storage_dtype
        out_fields.append((agg.name or agg.fn, agg.output_type))
        out_cols.append(Column(agg.output_type, pad(data, dt),
                               pad(valid, torch.bool),
                               vd if agg.output_type.is_string else None))
    return Batch(Schema(out_fields), out_cols, out_mask)
