"""Aggregation kernels: dense-slot and sort + segment-reduce GROUP BY.

The counterpart of ``presto_tpu/ops/aggregation.py`` (reference
presto-main/.../operator/HashAggregationOperator.java:48,
MultiChannelGroupByHash.java): instead of an open-addressing hash table,
a grouping either

- takes the DENSE path when every key's domain is host-known
  (dictionary codes, booleans, stats-bounded integers): the mixed-radix
  composite key code IS the group slot, reduced over K slots
  (``dense_group_plan``) by the slot-sum kernel on the card
  (``ops/slotsum.py``) for K + 1 <= 4097 and by ``index_add_`` above,
  and by ``scatter_reduce_`` for min and max; or
- takes the SORT path: rows sort by their keys, segment boundaries give
  dense group ids and run starts, and int64 sums go through the
  sorted-run segment-sum kernel (``ops/scan.py``, a CUDA kernel on the
  card). Double sums on this path take the dense path's rule (the
  slot-sum kernel up to 4097 slots, ``index_add_`` above): prefix
  differences over millions of rows would lose about 1e-10 relative
  precision.

Integral ``sum`` is checked (``checked_sum_i64``): each reduction sums
two digit planes of the int64 values, which cannot wrap, and a group
whose exact sum leaves int64 raises NUMERIC_VALUE_OUT_OF_RANGE through
the executor's error channel (the ``errors`` list of the entry points).

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
from ..batch import Batch, Column, Schema, bucket_capacity, gather_rows
from ..errors import NUMERIC_VALUE_OUT_OF_RANGE
from ..types import Type
from . import int128 as I
from . import slotsum
from .join import lexsort_permutation
from .scan import segment_sum_sorted_i64
from .sketch import (
    QD_BINS, hashed_column, hll_estimate, hll_m, hll_update, qd_estimate,
    qd_update,
)
from .sort import rank_codes, unrank_table

_VARIANCE_FNS = ("var_samp", "var_pop", "stddev_samp", "stddev_pop")
_SUPPORTED = ("sum", "count", "count_star", "min", "max", "avg",
              "var_samp", "var_pop", "stddev_samp", "stddev_pop",
              "bool_and", "bool_or", "approx_percentile",
              "approx_distinct")
#: aggregates whose GROUPED form drains the input into one exact
#: 'single'-mode pass (a segmented sort by group and value); the GLOBAL
#: numeric form carries the bounded histogram state of ops/sketch.py
#: through partial -> final like every other aggregate
DRAIN_FNS = ("approx_percentile",)


def has_drain_agg(aggs) -> bool:
    return any(a.fn in DRAIN_FNS for a in aggs)


def percentile_drains(aggs, input_types, grouped: bool) -> bool:
    """True when approx_percentile aggregates must run as an exact drain:
    grouped aggregations and string inputs. ``input_types`` is the child
    schema's type list."""
    drains = [a for a in aggs if a.fn in DRAIN_FNS]
    if not drains:
        return False
    if grouped:
        return True
    # accepts AggSpec (.input) and planner PlanAgg (.arg) alike
    return any(
        input_types[a.input if hasattr(a, "input") else a.arg].is_string
        for a in drains)


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
    #: rows where this boolean column is false do not feed the aggregate
    #: (the MarkDistinct lowering of DISTINCT aggregates)
    mask: Optional[int] = None
    #: static scalar parameter (approx_percentile's p, approx_distinct's
    #: standard error)
    param: Optional[float] = None

    def __post_init__(self):
        assert self.fn in _SUPPORTED, self.fn

    def state_types(self) -> List[Tuple[str, Type]]:
        base = self.name or self.fn
        if self.fn == "approx_percentile":
            return [(f"{base}$qdig", T.QdigestStateType(QD_BINS))]
        if self.fn == "approx_distinct":
            return [(f"{base}$hll", T.HllStateType(hll_m(self.param)))]
        if self.fn in ("count", "count_star"):
            return [(f"{base}$cnt", T.BIGINT)]
        if self.fn == "avg":
            return [(f"{base}$sum", self._sum_type()),
                    (f"{base}$cnt", T.BIGINT)]
        if self.fn in _VARIANCE_FNS:
            # central moments (mean, m2, count), not sum / sum of squares:
            # sumsq - sum^2/n cancels catastrophically for large-mean
            # low-variance data (reference CentralMomentsState.java)
            return [(f"{base}$mean", T.DOUBLE), (f"{base}$m2", T.DOUBLE),
                    (f"{base}$cnt", T.BIGINT)]
        if self.fn in ("bool_and", "bool_or"):
            return [(f"{base}$val", T.INTEGER), (f"{base}$cnt", T.BIGINT)]
        return [(f"{base}$val", self._sum_type() if self.fn == "sum"
                 else self.output_type), (f"{base}$cnt", T.BIGINT)]

    def _sum_type(self) -> Type:
        if isinstance(self.output_type, T.DecimalType):
            # decimal sums and averages accumulate in decimal(38, s)
            # limb-pair state (DecimalSumAggregation's Int128 state)
            return T.DecimalType(38, self.output_type.scale)
        return self.output_type


def mark_distinct_flags(batch: Batch, cols: Sequence[int]) -> torch.Tensor:
    """True at the first live occurrence of each distinct tuple of
    ``cols`` (reference operator/MarkDistinctOperator.java: hash-set
    membership becomes one stable sort, boundaries, and a scatter back to
    the input order). Dead rows are False."""
    ops = [(~batch.row_mask).to(torch.int32)]
    for ci in cols:
        ops.extend(_key_operands(batch.columns[ci]))
    perm = lexsort_permutation(ops)
    s_live = batch.row_mask[perm]
    diff = torch.zeros_like(s_live)
    for op in ops[1:]:
        s = op[perm]
        diff = diff | (s != torch.roll(s, 1))
    diff[0] = True
    out = torch.zeros_like(s_live)
    out[perm] = s_live & diff
    return out


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


def _key_operands(c: Column) -> List[torch.Tensor]:
    """One key column as lexicographic operands: [null_rank, data] with
    NULL rows' data neutralized (stale values must not split NULL groups);
    long-decimal limb pairs give (signed hi, unsigned-ordered lo)."""
    ops = [(~c.validity).to(torch.int32)]   # nulls last
    if c.data.ndim == 2:
        ops.append(_fill(I.hi(c.data), c.validity, 0))
        ops.append(_fill(I.sortable_lo(c.data), c.validity, 0))
        return ops
    data = c.data.to(torch.int32) if c.data.dtype == torch.bool else c.data
    ops.append(_fill(data, c.validity, 0))
    return ops


def _group_key_ops(batch: Batch,
                   group_indices: Sequence[int]) -> List[torch.Tensor]:
    """Lexicographic sort operands for GROUP BY keys: [dead_rank, then per
    key its operands]. Shared by every kernel whose output rows must align
    positionally across separate sorts of one batch (grouped_aggregate and
    the percentile drain)."""
    key_ops = [(~batch.row_mask).to(torch.int32)]
    for gi in group_indices:
        key_ops.extend(_key_operands(batch.columns[gi]))
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


def _boundary_groups(s_keys, s_mask):
    """Boundary / group id / group count over sorted key operands."""
    diff = torch.zeros_like(s_mask)
    for op in s_keys:
        diff = diff | (op != torch.roll(op, 1))
    diff[0] = True
    boundary = s_mask & diff
    group_id = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp(min=0)
    return boundary, group_id, boundary.sum(dtype=torch.int64)


def _group_sort(batch: Batch, group_indices: Sequence[int]):
    """Sort rows by group keys. Returns (sorted column data, sorted
    validity, sorted mask, boundary, group_id, num_groups); boundary marks
    the first live row of each group."""
    key_ops = _group_key_ops(batch, group_indices)
    perm = lexsort_permutation(key_ops)
    s_keys = [k[perm] for k in key_ops[1:]]
    s_mask = batch.row_mask[perm]
    s_data = [gather_rows(c.data, perm) for c in batch.columns]
    s_valid = [c.validity[perm] for c in batch.columns]
    boundary, group_id, num_groups = _boundary_groups(s_keys, s_mask)
    return s_data, s_valid, s_mask, boundary, group_id, num_groups


def _wide_state_aggs(aggs: Sequence[AggSpec]) -> bool:
    """Aggregates whose states carry a trailing width (HLL registers,
    decimal(38) limb pairs): they take the sort path, as in the
    reference."""
    return any(a.fn == "approx_distinct" for a in aggs) or any(
        getattr(st, "storage_width", None)
        for a in aggs if a.fn not in DRAIN_FNS
        for _, st in a.state_types())


def dense_path_selected(batch: Batch, group_indices: Sequence[int],
                        aggs: Sequence[AggSpec],
                        output_capacity: Optional[int] = None,
                        key_bounds=None) -> bool:
    """Host-only mirror of grouped_aggregate's dispatch: True when this
    batch/grouping takes the dense path."""
    if has_drain_agg(aggs) or _wide_state_aggs(aggs):
        return False
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
    """Group reductions over a group id in [0, cap) — the dense path's
    reducers (group id = composite key code; the reference's
    broadcast-compare and i32 digit-scatter reducers are TPU
    workarounds), and the sort path's reducers for everything but its
    int64 sums. Sums and counts of 1-D float64, int64 or bool columns
    over at most ``slotsum.MAX_SLOTS`` slots go through
    ``slotsum.slot_sum`` (``slotsum.routed``: the kernel on the card,
    its plain version on the CPU); other sums take ``index_add_``, min
    and max ``scatter_reduce_``. Values may carry a trailing width
    (digit planes, HLL registers)."""

    def __init__(self, group_id: torch.Tensor, cap: int):
        # a checked sum's digit planes are exact below 2^31 rows
        assert group_id.shape[0] <= CHECKED_SUM_MAX_ROWS, group_id.shape
        self.gid, self.cap = group_id, cap

    def count(self, valid):
        """int64 count of the True lanes of ``valid`` per group."""
        return self.sum(valid)

    def sum(self, x):
        """Per-group sums (a bool ``x`` counts its True lanes)."""
        if slotsum.routed(x, self.cap):
            return slotsum.slot_sum(self.gid, x, self.cap)
        if x.dtype == torch.bool:
            x = x.to(torch.int64)
        out = torch.zeros((self.cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, self.gid, x)

    def _reduce(self, x, how, init):
        out = torch.full((self.cap,) + tuple(x.shape[1:]), init,
                         dtype=x.dtype, device=x.device)
        idx = self.gid.view((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
        return out.scatter_reduce_(0, idx, x, reduce=how)

    def min(self, x):
        return self._reduce(x, "amin", _max_sentinel(x.dtype))

    def max(self, x):
        return self._reduce(x, "amax", _min_sentinel(x.dtype))

    def hll(self, valid, hashed, m):
        return hll_update(self.gid, valid, hashed, self.cap, m)

    def gather(self, per_group):
        return per_group[self.gid]


class _SegReducers(_SlotReducers):
    """Sort-path reducers: group ids are sorted runs with per-group start
    rows (absent groups point one past the end), so every 1-D int64 sum
    takes the sorted-run segment-sum kernel: counts, and each digit plane
    of a checked integral sum (``checked_sum_i64``). The kernel wraps mod
    2^64; the planes cannot wrap, so the sums are exact and checked.
    Other sums take the base class's rule."""

    def __init__(self, group_id: torch.Tensor, cap: int,
                 starts: torch.Tensor):
        super().__init__(group_id, cap)
        self.starts = starts

    def sum(self, x):
        if x.dtype in (torch.int64, torch.bool) and x.ndim == 1:
            return segment_sum_sorted_i64(x.to(torch.int64), self.starts,
                                          self.cap)
        return super().sum(x)


#: rows one checked sum may reduce: below 2^31 rows neither digit
#: plane's sum can leave int64
CHECKED_SUM_MAX_ROWS = (1 << 31) - 1


def i64_planes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two digit planes of int64 values, each a 1-D int64 tensor:
    ``hi = x >> 32`` (arithmetic, in [-2^31, 2^31)) and ``lo = x &
    0xFFFFFFFF`` (in [0, 2^32)), so that ``x = hi * 2^32 + lo``."""
    return x >> 32, x & 0xFFFFFFFF


def from_plane_sums(hs: torch.Tensor, ls: torch.Tensor):
    """``(value, overflow)`` of a sum given its planes' exact sums: the
    exact sum is ``h * 2^32 + (ls & 0xFFFFFFFF)`` with ``h = hs + (ls >>
    32)``, so it fits int64 iff ``h`` lies in [-2^31, 2^31). ``value`` is
    ``hs * 2^32 + ls`` in wrapping int64: the bits of the plain wrapping
    sum, so a sum that fits is the same as without the check."""
    h = hs + (ls >> 32)
    overflow = (h < -(1 << 31)) | (h >= (1 << 31))
    return hs * (1 << 32) + ls, overflow


def checked_sum_i64(x: torch.Tensor, red_sum):
    """Exact integral sum with an overflow flag per group
    (LongSumAggregation's ``Math.addExact``, checked per state). ``x``
    is 1-D int64 with dead rows zero; ``red_sum`` is the reducer's sum,
    which each plane passes through as its own 1-D int64 tensor (on the
    sort path, one launch of the segment-sum kernel each). Exact for
    fewer than 2^31 rows.

    Semantics: a sum raises iff the exact sum of some state (partial,
    merged or final) leaves int64. A running sum that leaves int64 and
    comes back within one reduction does not raise, where Presto's
    row-by-row ``addExact`` would."""
    assert x.shape[0] <= CHECKED_SUM_MAX_ROWS, x.shape
    hi, lo = i64_planes(x)
    return from_plane_sums(red_sum(hi), red_sum(lo))


def overflow_code(flags: Sequence[torch.Tensor], device) -> torch.Tensor:
    """One device int32 scalar: NUMERIC_VALUE_OUT_OF_RANGE when any flag
    is set, else 0 (no host sync)."""
    bad = torch.zeros((), dtype=torch.bool, device=device)
    for f in flags:
        bad = bad | f.any()
    return torch.where(bad, NUMERIC_VALUE_OUT_OF_RANGE, 0).to(torch.int32)


class _GlobalReducer:
    """Single-group reducer with the reducer surface (min/max/sum
    collapse all rows; gather broadcasts), so the grouped and global
    paths share the int128 and variance code."""

    def count(self, valid):
        return valid.sum(dtype=torch.int64)

    def sum(self, x):
        return x.sum(0)

    def min(self, x):
        return x.min(0).values if x.shape[0] else torch.full(
            tuple(x.shape[1:]), _max_sentinel(x.dtype), dtype=x.dtype,
            device=x.device)

    def max(self, x):
        return x.max(0).values if x.shape[0] else torch.full(
            tuple(x.shape[1:]), _min_sentinel(x.dtype), dtype=x.dtype,
            device=x.device)

    def hll(self, valid, hashed, m):
        gid = torch.zeros(hashed.shape[0], dtype=torch.int64,
                          device=hashed.device)
        return hll_update(gid, valid, hashed, 1, m)[0]

    def gather(self, per_group):
        return per_group


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


def _merge_variance(red, m_in, m2_in, cnt_raw, mask):
    """Merge partial (mean, m2, n) states: Chan's parallel combination
    generalized to k partials, M2 = sum(m2_i + n_i (mean_i - mean)^2),
    with the (sum n_i dev_i)^2 / n term that cancels the rounding error of
    the computed mean."""
    live = mask & (cnt_raw > 0)
    nw = _fill(cnt_raw, live, 0)
    cnt = red.sum(nw)
    nf = nw.to(torch.float64)
    n = cnt.clamp(min=1).to(torch.float64)
    mean = red.sum(nf * _fill(m_in, live, 0.0)) / n
    dev = m_in - red.gather(mean)
    wdev = red.sum(_fill(nf * dev, live, 0.0))
    m2 = red.sum(_fill(m2_in + nf * dev * dev, live, 0.0)) - wdev * wdev / n
    return mean + wdev / n, m2, cnt


def _raw_variance(red, data, valid, cnt):
    """Corrected two-pass central moments: the mean first, then squared
    deviations with the (sum dev)^2 / n term that cancels the first pass's
    rounding error — stable for any magnitude."""
    x = data.to(torch.float64)
    n = cnt.clamp(min=1).to(torch.float64)
    mean = red.sum(_fill(x, valid, 0.0)) / n
    dev = _fill(x - red.gather(mean), valid, 0.0)
    s1 = red.sum(dev)
    return mean + s1 / n, red.sum(dev * dev) - s1 * s1 / n, cnt


def _segment_aggs(aggs: Sequence[AggSpec], col_data, col_valid,
                  mask: torch.Tensor, red, from_states: bool,
                  overflow: list, col_dicts=None
                  ) -> List[Tuple[torch.Tensor, ...]]:
    """Per-aggregate reductions: state tuples in each agg's state layout
    (raw input when ``from_states`` is False, merged states when True).
    Each checked integral sum appends its per-group overflow flags to
    ``overflow``."""
    def int_sum(x: torch.Tensor) -> torch.Tensor:
        val, ovf = checked_sum_i64(x, red.sum)
        overflow.append(ovf)
        return val
    results = []
    state_cursor = 0
    for agg in aggs:
        if from_states:
            n_state = len(agg.state_types())
            s_cols = list(range(state_cursor, state_cursor + n_state))
            state_cursor += n_state
            if agg.fn == "approx_percentile":
                raise NotImplementedError(
                    "grouped approx_percentile is drain-only "
                    "(see percentile_drains)")
            if agg.fn == "approx_distinct":
                # HLL merge: per-bucket max of register rows; 0 is the
                # register identity, so dead rows drop out
                regs = col_data[s_cols[0]]
                results.append((red.max(_fill(regs, mask[:, None], 0))
                                .clamp(min=0),))
                continue
            if agg.fn in ("count", "count_star"):
                results.append((red.sum(_fill(col_data[s_cols[0]], mask, 0)),))
                continue
            if agg.fn in _VARIANCE_FNS:
                results.append(_merge_variance(
                    red, col_data[s_cols[0]], col_data[s_cols[1]],
                    col_data[s_cols[2]], mask))
                continue
            val_in = col_data[s_cols[0]]
            cnt_raw = col_data[s_cols[1]]
            cnt = red.sum(_fill(cnt_raw, mask, 0))
            live = mask & (cnt_raw > 0)
            vocab = col_dicts[s_cols[0]] if col_dicts else None
            if val_in.ndim == 2:
                # long-decimal limb states
                val = (_checked_sum128(val_in, live, red.sum)
                       if agg.fn in ("sum", "avg")
                       else _minmax128(val_in, live, red, agg.fn))
            elif vocab is not None and agg.fn in ("min", "max"):
                val = _rank_reduce(val_in, live, red, vocab, agg.fn)
            elif agg.fn == "sum" and val_in.dtype == torch.int64:
                val = int_sum(_fill(val_in, live, 0))
            elif agg.fn in ("sum", "avg"):
                val = red.sum(_fill(val_in, live, 0))
            elif agg.fn in ("bool_and", "min"):
                val = red.min(_fill(val_in, live, _max_sentinel(val_in.dtype)))
            else:                                     # max, bool_or
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
        vocab = col_dicts[agg.input] if col_dicts else None
        if agg.fn == "approx_distinct":
            results.append((red.hll(valid, hashed_column(data, vocab),
                                    hll_m(agg.param)),))
            continue
        cnt = red.count(valid)
        if agg.fn == "count":
            results.append((cnt,))
            continue
        if agg.fn in _VARIANCE_FNS:
            results.append(_raw_variance(red, data, valid, cnt))
            continue
        if agg.fn in ("bool_and", "bool_or"):
            x = data.to(torch.int32)
            val = (red.min(_fill(x, valid, 1)) if agg.fn == "bool_and"
                   else red.max(_fill(x, valid, 0)))
            results.append((val, cnt))
            continue
        if vocab is not None and agg.fn in ("min", "max"):
            results.append((_rank_reduce(data, valid, red, vocab, agg.fn),
                            cnt))
            continue
        acc_t = agg.state_types()[0][1]
        if getattr(acc_t, "storage_width", None):
            # decimal(38) accumulation: short inputs sign-extend to limbs,
            # long inputs pass through; sums are exact digit-plane sums
            x = data if data.ndim == 2 else I.from_i64(data)
            val = (_checked_sum128(x, valid, red.sum)
                   if agg.fn in ("sum", "avg")
                   else _minmax128(x, valid, red, agg.fn))
            results.append((val, cnt))
            continue
        acc_dtype = acc_t.storage_dtype
        x = data.to(acc_dtype)
        if agg.fn == "sum" and acc_dtype == torch.int64:
            val = int_sum(_fill(x, valid, 0))
        elif agg.fn in ("sum", "avg"):
            val = red.sum(_fill(x, valid, 0))
        elif agg.fn == "min":
            val = red.min(_fill(x, valid, _max_sentinel(acc_dtype)))
        else:
            val = red.max(_fill(x, valid, _min_sentinel(acc_dtype)))
        results.append((val, cnt))
    return results


def _checked_sum128(x: torch.Tensor, live: torch.Tensor,
                    red_sum) -> torch.Tensor:
    """Exact 128-bit sum of limb pairs [n, 2] with overflow poisoning:
    groups whose true sum exceeds 38 digits (or that merge an already
    poisoned partial) yield the OVERFLOW_SENTINEL, which raises
    NUMERIC_VALUE_OUT_OF_RANGE when decoded (the deferred analogue of the
    reference DecimalSumAggregation throw)."""
    planes = _fill(I.digit_sum_tiles(x), live[:, None], 0)
    val, ovf = I.from_digit_sum_tiles_checked(red_sum(planes))
    ovf = ovf | ~I.fits_decimal(val, 38)
    poisoned = red_sum((live & I.is_overflow_sentinel(x))
                       .to(torch.int64)) > 0
    return I.where(ovf | poisoned, I.sentinel_like(val), val)


def _minmax128(x: torch.Tensor, live: torch.Tensor, red,
               fn: str) -> torch.Tensor:
    """min/max over limb pairs [n, 2]: lexicographic (hi, unsigned lo) in
    two reductions — reduce hi, then lo among rows tied at the winning
    hi."""
    h, l = I.hi(x), I.sortable_lo(x)
    op = red.min if fn == "min" else red.max
    sent = _max_sentinel(h.dtype) if fn == "min" else _min_sentinel(h.dtype)
    mh = op(_fill(h, live, sent))
    tie = live & (h == red.gather(mh))
    ml = op(_fill(l, tie, sent))
    return I.pack(mh, ml ^ I.SIGN64)


def _finalize_dec128(agg: AggSpec, val: torch.Tensor, cnt: torch.Tensor):
    """Long-decimal finalize: the avg divide (poisoned past the 2^31-row
    divisor bound and through overflowed sums), short-output narrowing.
    ``val`` is [..., 2] limbs."""
    out_t = agg.output_type
    short_out = isinstance(out_t, T.DecimalType) and not out_t.is_long
    if agg.fn == "avg":
        q = I.div_round_half_up(val, cnt.clamp(1, 1 << 31))
        bad = I.is_overflow_sentinel(val) | (cnt > (1 << 31))
        val = I.where(bad, I.sentinel_like(q), q)
    return I.lo(val) if short_out else val


def _variance_out(agg: AggSpec, mean, m2, cnt):
    """(mean, m2, count) central-moment state -> variance / stddev."""
    del mean
    n = cnt.clamp(min=1).to(torch.float64)
    pop = agg.fn in ("var_pop", "stddev_pop")
    den = n if pop else (n - 1.0).clamp(min=1.0)
    var = m2.clamp(min=0.0) / den
    out = torch.sqrt(var) if agg.fn.startswith("stddev") else var
    return out, (cnt > 0) if pop else (cnt > 1)


def _finalize(agg: AggSpec, parts):
    """state -> (output data, output validity)."""
    if agg.fn in ("count", "count_star"):
        return parts[0], torch.ones_like(parts[0], dtype=torch.bool)
    if agg.fn == "approx_distinct":
        regs = parts[0]
        return hll_estimate(regs), torch.ones(
            regs.shape[:-1], dtype=torch.bool, device=regs.device)
    if agg.fn in _VARIANCE_FNS:
        return _variance_out(agg, *parts)
    val, cnt = parts
    valid = cnt > 0
    if agg.fn in ("bool_and", "bool_or"):
        return val > 0, valid
    if val.ndim == cnt.ndim + 1:
        return _finalize_dec128(agg, val, cnt), valid
    if agg.fn == "avg":
        den = cnt.clamp(min=1)
        if isinstance(agg.output_type, T.DecimalType):
            q = val.to(torch.float64) / den.to(torch.float64)
            out = torch.sign(q) * torch.floor(
                val.abs().to(torch.float64) / den.to(torch.float64) + 0.5)
            return out.to(torch.int64), valid
        return val / den.to(val.dtype), valid
    return val.to(agg.output_type.storage_dtype), valid


# -- drained aggregates (grouped / string approx_percentile) ------------------

def _percentile_input(batch: Batch, input_idx: int, mask_idx):
    """(valid, sort value, unrank) of a percentile input column: dictionary
    codes map through lexicographic ranks so value order is string order;
    unrank maps the winner back to a code."""
    c = batch.columns[input_idx]
    if c.data.ndim == 2:
        raise NotImplementedError(
            "grouped approx_percentile over decimal(>18) is not "
            "supported (cast to decimal(18,s) or double)")
    valid = c.validity & batch.row_mask
    if mask_idx is not None:
        valid = valid & batch.columns[mask_idx].data.to(torch.bool)
    vdata, unrank = c.data, None
    if c.dictionary is not None:
        vdata = rank_codes(vdata, c.dictionary)
        unrank = unrank_table(c.dictionary, vdata.device)
    elif vdata.dtype == torch.bool:
        vdata = vdata.to(torch.int32)
    return valid, vdata, unrank


def _select_ks(aggs: Sequence[AggSpec], nvalid: torch.Tensor):
    """Per-agg nearest-rank index (0-based) within the valid run."""
    ks = []
    for agg in aggs:
        p = float(agg.param if agg.param is not None else 0.5)
        k = torch.ceil(p * nvalid.to(torch.float64)).to(torch.int64) - 1
        ks.append(torch.minimum(k.clamp(min=0), (nvalid - 1).clamp(min=0)))
    return ks


def _unranked(data, unrank):
    if unrank is None:
        return data
    return unrank[data.clamp(0, unrank.shape[0] - 1)]


def _grouped_percentiles(batch: Batch, group_indices: Sequence[int],
                         aggs: Sequence[AggSpec], cap: int):
    """Nearest-rank percentiles per group for aggregates sharing one
    (input, mask): ONE segmented sort by (group keys, value), k
    selections. Valid values sort first within each group, so the k-th
    smallest valid value sits at (group start + k). Group order comes from
    the shared _group_key_ops operands, so outputs align positionally with
    grouped_aggregate's rows."""
    valid, vdata, unrank = _percentile_input(batch, aggs[0].input,
                                             aggs[0].mask)
    key_ops = _group_key_ops(batch, group_indices)
    val_null = (~valid).to(torch.int32)
    ops = key_ops + [val_null, _fill(vdata, valid, 0)]
    perm = lexsort_permutation(ops)
    s_live = batch.row_mask[perm]
    s_keys = [k[perm] for k in key_ops[1:]]
    s_vnull, s_vals = val_null[perm], ops[-1][perm]
    boundary, group_id, num_groups = _boundary_groups(s_keys, s_live)
    red = _SlotReducers(group_id, cap)
    nvalid = red.sum((s_live & (s_vnull == 0)).to(torch.int64))
    bidx = _first_slots(boundary, cap, batch.capacity - 1)
    out_mask = torch.arange(cap, device=batch.device) < num_groups
    results = []
    for k in _select_ks(aggs, nvalid):
        sel = (bidx + k).clamp(0, batch.capacity - 1)
        results.append((_unranked(s_vals[sel], unrank),
                        (nvalid > 0) & out_mask))
    return results


def _global_percentiles(batch: Batch, aggs: Sequence[AggSpec]):
    """Single-group nearest-rank percentiles (one sort, k selections)."""
    valid, vdata, unrank = _percentile_input(batch, aggs[0].input,
                                             aggs[0].mask)
    ops = [(~valid).to(torch.int32), _fill(vdata, valid, 0)]
    s_vals = ops[1][lexsort_permutation(ops)]
    n = valid.sum(dtype=torch.int64)
    return [(_unranked(s_vals[k], unrank), n > 0)
            for k in _select_ks(aggs, n)]


def _drain_groups(aggs):
    """Drain aggs grouped by shared (input, mask): one sort per group."""
    groups: dict = {}
    for agg in aggs:
        if agg.fn in DRAIN_FNS:
            groups.setdefault((agg.input, agg.mask), []).append(agg)
    return groups


def _with_drain_aggs(batch: Batch, group_indices, aggs, mode,
                     output_capacity, errors=None) -> Batch:
    """grouped_aggregate with approx_percentile columns spliced in."""
    if mode != "single":
        raise NotImplementedError(
            "approx_percentile requires single-step aggregation "
            "(the planner routes such plans through a drain)")
    regular = [a for a in aggs if a.fn not in DRAIN_FNS]
    # the drains align with the regular aggregates POSITIONALLY (both
    # orders come from _group_key_ops), so the dense path must not run
    base = grouped_aggregate(batch, group_indices, regular, "single",
                             output_capacity, allow_dense=False,
                             errors=errors)
    computed = {}
    for shared in _drain_groups(aggs).values():
        for agg, res in zip(shared, _grouped_percentiles(
                batch, group_indices, shared, base.capacity)):
            computed[id(agg)] = res
    nk = len(group_indices)
    out_cols = list(base.columns[:nk])
    out_fields = list(zip(base.schema.names[:nk], base.schema.types[:nk]))
    ri = nk
    for agg in aggs:
        if agg.fn in DRAIN_FNS:
            data, valid = computed[id(agg)]
            out_fields.append((agg.name or agg.fn, agg.output_type))
            out_cols.append(Column(
                agg.output_type, data.to(agg.output_type.storage_dtype),
                valid, batch.columns[agg.input].dictionary
                if agg.output_type.is_string else None))
        else:
            out_cols.append(base.columns[ri])
            out_fields.append((base.schema.names[ri], base.schema.types[ri]))
            ri += 1
    return Batch(Schema(out_fields), out_cols, base.row_mask)


def _pad_to(arr: torch.Tensor, K: int, cap: int) -> torch.Tensor:
    out = torch.zeros((cap,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out[:K] = arr[:K]
    return out


def grouped_aggregate(batch: Batch, group_indices: Sequence[int],
                      aggs: Sequence[AggSpec], mode: str = "single",
                      output_capacity: Optional[int] = None,
                      allow_dense: bool = True, key_bounds=None,
                      errors: Optional[list] = None) -> Batch:
    """GROUP BY aggregation. mode: 'single' | 'partial' | 'final' | 'merge'.

    In 'final' and 'merge' modes the input layout is [group key
    columns..., state columns in agg order...] (the output of 'partial').
    'merge' re-combines state rows sharing a key but keeps the state
    layout. ``key_bounds`` (one Optional[(lo, hi)] per key) lets integer
    keys join the dense composite-code path. When the aggregates hold a
    checked integral sum, one device int32 scalar (``overflow_code``:
    NUMERIC_VALUE_OUT_OF_RANGE or 0) is appended to ``errors``, the
    executor's error flags."""
    assert mode in ("single", "partial", "final", "merge")
    if has_drain_agg(aggs):
        return _with_drain_aggs(batch, group_indices, aggs, mode,
                                output_capacity, errors)
    cap = output_capacity or batch.capacity
    from_states = mode in ("final", "merge")
    n_keys = len(group_indices)
    overflow: list = []
    # wide states (HLL registers, decimal(38) limb pairs) take the sort
    # path, as in the reference
    wide = _wide_state_aggs(aggs)
    plan = (dense_group_plan(batch, group_indices, cap, key_bounds)
            if allow_dense and not wide else None)
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
                            col_dicts=[c.dictionary for c in in_cols],
                            overflow=overflow)
        seg = [tuple(_pad_to(a, K, cap) for a in parts) for parts in raw]
    else:
        s_data, s_valid, s_mask, boundary, group_id, num_groups = \
            _group_sort(batch, group_indices)
        if wide and output_capacity is None:
            # wide states are [cap, width] tensors and their sums go
            # through [cap, 4] digit planes: size them by the group count,
            # not by the input's lanes (one host sync)
            cap = min(cap, bucket_capacity(max(int(num_groups), 1)))
        bidx = _first_slots(boundary, cap, batch.capacity - 1)
        out_mask = torch.arange(cap, device=dev) < num_groups
        key_cols = [Column(batch.columns[gi].type, s_data[gi][bidx],
                           s_valid[gi][bidx] & out_mask,
                           batch.columns[gi].dictionary)
                    for gi in group_indices]
        # sorted-run starts; absent groups point one past the end
        starts = torch.where(out_mask, bidx, batch.capacity).to(torch.int32)
        red = _SegReducers(group_id, cap, starts)
        first = n_keys if from_states else 0
        seg = _segment_aggs(aggs, s_data[first:], s_valid[first:], s_mask,
                            red, from_states=from_states,
                            col_dicts=[c.dictionary
                                       for c in batch.columns[first:]],
                            overflow=overflow)
    if overflow and errors is not None:
        errors.append(overflow_code(overflow, dev))

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


def _global_drains(batch: Batch, aggs: Sequence[AggSpec],
                   errors=None) -> Batch:
    """Single-mode global aggregation with exact percentile columns (the
    drain callers and string inputs)."""
    base = global_aggregate(batch, [a for a in aggs
                                    if a.fn not in DRAIN_FNS], "single",
                            errors)
    computed = {}
    for shared in _drain_groups(aggs).values():
        for agg, res in zip(shared, _global_percentiles(batch, shared)):
            computed[id(agg)] = res
    cap, dev = base.capacity, batch.device
    out_cols: List[Column] = []
    out_fields: List[Tuple[str, Type]] = []
    ri = 0
    for agg in aggs:
        if agg.fn in DRAIN_FNS:
            data, valid = computed[id(agg)]
            dt = agg.output_type.storage_dtype
            col = torch.zeros(cap, dtype=dt, device=dev)
            col[0] = data.to(dt)
            ok = torch.zeros(cap, dtype=torch.bool, device=dev)
            ok[0] = valid
            out_fields.append((agg.name or agg.fn, agg.output_type))
            out_cols.append(Column(agg.output_type, col, ok,
                                   batch.columns[agg.input].dictionary
                                   if agg.output_type.is_string else None))
        else:
            out_cols.append(base.columns[ri])
            out_fields.append((base.schema.names[ri], base.schema.types[ri]))
            ri += 1
    return Batch(Schema(out_fields), out_cols, base.row_mask)


def _global_percentile_state(batch: Batch, agg: AggSpec, cols,
                             from_states: bool) -> torch.Tensor:
    """[QD_BINS] histogram of a global numeric approx_percentile: merged
    state rows, or one pass over the raw input."""
    mask = batch.row_mask
    if from_states:
        return _fill(cols[0].data, mask[:, None], 0).sum(0)
    c = batch.columns[agg.input]
    if c.dictionary is not None:
        raise NotImplementedError(
            "approx_percentile over strings is drain-only "
            "(see percentile_drains)")
    valid = c.validity & mask
    if agg.mask is not None:
        valid = valid & batch.columns[agg.mask].data.to(torch.bool)
    # long decimals: histogram over the float64 image of the unscaled
    # value (monotone, so the percentile's bin is the same)
    values = I.to_f64(c.data) if c.data.ndim == 2 else c.data
    return qd_update(valid, values.to(torch.float64))


def _percentile_out(agg: AggSpec, counts: torch.Tensor):
    p = float(agg.param if agg.param is not None else 0.5)
    val, ok = qd_estimate(counts, p)
    out_t = agg.output_type
    if isinstance(out_t, T.DecimalType) and out_t.is_long:
        val = I.from_f64(torch.round(val))
    elif not out_t.storage_dtype.is_floating_point:
        val = torch.round(val)
    return val, ok


def global_aggregate(batch: Batch, aggs: Sequence[AggSpec],
                     mode: str = "single",
                     errors: Optional[list] = None) -> Batch:
    """Aggregation without GROUP BY: one output row, even over empty input
    (reference AggregationOperator.java). 'merge' consumes state columns
    and emits merged state columns. Checked integral sums append their
    overflow scalar to ``errors`` as in ``grouped_aggregate``."""
    assert mode in ("single", "partial", "final", "merge")
    if has_drain_agg(aggs) and mode == "single":
        return _global_drains(batch, aggs, errors)
    cap = 128  # minimum bucket; one live row
    dev = batch.device
    mask = batch.row_mask
    out_mask = torch.arange(cap, device=dev) < 1
    from_states = mode in ("final", "merge")
    cols = batch.columns
    regular = [a for a in aggs if a.fn != "approx_percentile"]
    if from_states:
        # state columns of the regular aggregates, in their order
        reg_cols, cursor = [], 0
        for a in aggs:
            n = len(a.state_types())
            if a.fn != "approx_percentile":
                reg_cols.extend(cols[cursor:cursor + n])
            cursor += n
    else:
        reg_cols = cols
    overflow: list = []
    seg = iter(_segment_aggs(regular, [c.data for c in reg_cols],
                             [c.validity for c in reg_cols], mask,
                             _GlobalReducer(), from_states=from_states,
                             col_dicts=[c.dictionary for c in reg_cols],
                             overflow=overflow))
    if overflow and errors is not None:
        errors.append(overflow_code(overflow, dev))

    def pad(value: torch.Tensor, dtype) -> torch.Tensor:
        out = torch.zeros((cap,) + tuple(value.shape), dtype=dtype,
                          device=dev)
        out[0] = value.to(dtype)
        return out

    out_fields: List[Tuple[str, Type]] = []
    out_cols: List[Column] = []
    state_cursor = 0
    for agg in aggs:
        n_state = len(agg.state_types())
        my_cols = cols[state_cursor:state_cursor + n_state]
        vd = None
        if agg.fn in ("min", "max") and agg.input is not None:
            vd = (my_cols[0].dictionary if from_states
                  else cols[agg.input].dictionary)
        state_cursor += n_state
        if agg.fn == "approx_percentile":
            parts = (_global_percentile_state(batch, agg, my_cols,
                                              from_states),)
        else:
            parts = next(seg)
        if mode in ("partial", "merge"):
            for (fname, ftype), arr in zip(agg.state_types(), parts):
                out_fields.append((fname, ftype))
                out_cols.append(Column(ftype, pad(arr, ftype.storage_dtype),
                                       out_mask,
                                       vd if ftype.is_string else None))
            continue
        if agg.fn == "approx_percentile":
            data, valid = _percentile_out(agg, parts[0])
        else:
            data, valid = _finalize(agg, parts)
        dt = agg.output_type.storage_dtype
        out_fields.append((agg.name or agg.fn, agg.output_type))
        out_cols.append(Column(agg.output_type, pad(data, dt),
                               pad(valid, torch.bool),
                               vd if agg.output_type.is_string else None))
    return Batch(Schema(out_fields), out_cols, out_mask)
