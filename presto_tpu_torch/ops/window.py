"""Window function kernels.

The counterpart of ``presto_tpu/ops/window.py`` (reference
presto-main/.../operator/WindowOperator.java sorts via PagesIndex, then
WindowPartition evaluates functions per partition; built-ins in
operator/window/). The whole batch is sorted once by (partition keys,
order keys) with every payload column gathered by the permutation, and
per-row values come from branch-free cumulative/segment ops:

- partition boundaries -> segment starts and ends;
- peer runs (equal order keys within a partition) for RANGE-frame
  semantics: ranking ties and running aggregates include full peer runs;
- running aggregates = prefix sums over the sorted order at the frame
  end minus the prefix at the partition start (``prefix_sum``: a fixed
  pairwise summation order, so a partition's sum does not depend on the
  run or the device). An integral ``sum`` takes the prefix sums of its
  two digit planes (``ops/aggregation.i64_planes``) with frame
  differences per plane, so a frame whose exact sum leaves int64 raises
  NUMERIC_VALUE_OUT_OF_RANGE through the executor's error channel.

Rows are returned in (partition, order) order — a valid SQL result order;
the planner's own ORDER BY, if any, sorts afterwards.

Explicit frames (ROWS/RANGE BETWEEN <bound> AND <bound>, reference
operator/window/FrameInfo.java) compute per-row [fs, fe] position spans:
ROWS bounds are position offsets, RANGE bounds binary-search the
partition-sorted order key, aggregates answer from prefix-sum
differences, and MIN/MAX answer arbitrary spans from sparse range-query
tables.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..batch import Batch, Column, Schema, gather_rows
from ..types import Type
from .aggregation import (
    CHECKED_SUM_MAX_ROWS, from_plane_sums, i64_planes, overflow_code,
)
from .join import lexsort_permutation
from .sort import SortKey, _sortable, rank_codes, unrank_table

RANKING = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
           "ntile")
VALUE_FNS = ("first_value", "last_value", "lag", "lead", "nth_value")
AGG_FNS = ("sum", "count", "avg", "min", "max", "count_star")

_I64_MAX = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """One window function application over shared partition/order keys."""

    fn: str
    args: Tuple[int, ...]          # input column indices
    output_type: Type
    name: str
    offset: int = 1                # lag/lead offset; ntile buckets
    ignore_order: bool = False     # aggregate without ORDER BY: whole part.
    frame: str = "range"           # frame unit: RANGE | ROWS
    #: frame bounds (kind, offset): unbounded_preceding | preceding |
    #: current_row | following | unbounded_following (reference
    #: operator/window/FrameInfo.java)
    frame_start: Tuple[str, int] = ("unbounded_preceding", 0)
    frame_end: Tuple[str, int] = ("current_row", 0)

    @property
    def default_frame(self) -> bool:
        return (self.frame_start == ("unbounded_preceding", 0)
                and self.frame_end == ("current_row", 0))


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0. Integers take ``torch.cumsum``
    (exact in any order). Floats take the odd/even pairwise scan that
    ``jax.lax.associative_scan`` runs, which presto_tpu's window kernels
    use: the same additions in the same order, so both engines give the
    same bits, and the rounding error of a prefix grows with log2(n)
    rather than n. That matters here because a partition's sum is a
    difference of two prefixes over the whole batch."""
    if not x.is_floating_point():
        return torch.cumsum(x, 0)
    n = x.shape[0]
    if n < 2:
        return x
    odd = prefix_sum(x[0:-1:2] + x[1::2])
    even = (odd[:-1] if n % 2 == 0 else odd) + x[2::2]
    out = torch.empty_like(x)
    out[0] = x[0]
    out[2::2] = even
    out[1::2] = odd
    return out


def _shift_back(x: torch.Tensor, step: int, fill) -> torch.Tensor:
    """x[i + step], ``fill`` past the end."""
    out = torch.full_like(x, fill)
    if step < x.shape[0]:
        out[:x.shape[0] - step] = x[step:]
    return out


def _bounded_searchsorted(vals: torch.Tensor, targets: torch.Tensor,
                          lo0: torch.Tensor, hi0: torch.Tensor,
                          side: str, ascending: bool) -> torch.Tensor:
    """Per-lane binary search with per-lane [lo, hi) bounds: first
    position p in [lo0_i, hi0_i) whose value passes the boundary test
    against targets_i (vals sorted within each lane's own bound range —
    the partition). O(log cap) gathers, branch-free."""
    cap = vals.shape[0]
    lo, hi = lo0.to(torch.int64), hi0.to(torch.int64)
    for _ in range(max(cap.bit_length(), 1)):
        mid = (lo + hi) >> 1
        v = vals[mid.clamp(0, cap - 1)]
        if ascending:
            go = (v < targets) if side == "left" else (v <= targets)
        else:
            go = (v > targets) if side == "left" else (v >= targets)
        go = go & (lo < hi)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return lo


def _rmq_tables(x: torch.Tensor, op, sentinel,
                max_width: Optional[int] = None) -> torch.Tensor:
    """Sparse-table range-min/max: [levels, cap] where level k holds the
    reduction of [i, i + 2^k) — O(cap log cap) build, O(1) (two gathers)
    per query. ``max_width`` (a static bound on any queried frame length,
    e.g. from constant ROWS offsets) caps the level count."""
    cap = x.shape[0]
    levels = max(cap.bit_length(), 1)
    if max_width is not None:
        levels = min(levels, max(int(max_width).bit_length(), 1))
    tabs = [x]
    for k in range(1, levels):
        prev = tabs[-1]
        tabs.append(op(prev, _shift_back(prev, 1 << (k - 1), sentinel)))
    return torch.stack(tabs)


def _floor_log2(n: torch.Tensor) -> torch.Tensor:
    """floor(log2(n)) for int64 n >= 1 (exact below 2^53)."""
    return torch.frexp(n.to(torch.float64)).exponent.to(torch.int64) - 1


def _rmq_query(tabs: torch.Tensor, op, sentinel, fs: torch.Tensor,
               fe: torch.Tensor) -> torch.Tensor:
    """Reduce [fs, fe] per lane from sparse tables; empty -> sentinel."""
    levels, cap = tabs.shape
    length = torch.clamp(fe - fs + 1, min=1)
    k = _floor_log2(length).clamp(0, levels - 1)
    flat = tabs.reshape(-1)
    a = flat[k * cap + fs.clamp(0, cap - 1)]
    b = flat[k * cap + (fe - (1 << k) + 1).clamp(0, cap - 1)]
    return torch.where(fe >= fs, op(a, b),
                       torch.full((), sentinel, dtype=tabs.dtype,
                                  device=tabs.device))


def _frame_positions(spec: WindowSpec, idx, pstart, pend, ostart, oend,
                     order_vals):
    """(fs, fe) inclusive frame row-positions per lane for an explicit
    frame (reference operator/window/FrameInfo.java semantics): ROWS
    bounds offset by physical positions, RANGE bounds by order-key value
    (bounded binary searches over the partition-sorted key). fs > fe
    encodes an empty frame."""

    def one(kind_off, is_start):
        kind, off = kind_off
        if kind == "unbounded_preceding":
            return pstart
        if kind == "unbounded_following":
            return pend
        if spec.frame == "rows":
            if kind == "current_row":
                return idx
            return idx - off if kind == "preceding" else idx + off
        # RANGE unit
        if kind == "current_row":
            return ostart if is_start else oend
        vals, valid, asc, vstart, vend, key_scale = order_vals
        assert vals is not None, \
            "offset RANGE frame requires one ORDER BY key"
        # DECIMAL order keys store scaled integers: the literal offset
        # scales by 10^scale (reference FrameInfo applies offsets in
        # VALUE space)
        delta = torch.tensor(off * key_scale, dtype=vals.dtype,
                             device=vals.device)
        if kind == "preceding":
            target = vals - delta if asc else vals + delta
        else:
            target = vals + delta if asc else vals - delta
        side = "left" if is_start else "right"
        # search only the partition's non-NULL run: NULL rows cluster at
        # one end of the partition and their payloads are not ordered
        p = _bounded_searchsorted(vals, target, vstart, vend + 1, side, asc)
        p = p if is_start else p - 1
        # SQL: a NULL order key's offset frame is its peer run
        return torch.where(valid, p, ostart if is_start else oend)

    fs = torch.maximum(one(spec.frame_start, True), pstart)
    fe = torch.minimum(one(spec.frame_end, False), pend)
    return fs, fe


def _segment_scan(x: torch.Tensor, pstart: torch.Tensor, op) -> torch.Tensor:
    """Inclusive running ``op`` within contiguous segments (reset at each
    lane's segment start): a doubling scan, log2(cap) elementwise steps."""
    cap = x.shape[0]
    idx = torch.arange(cap, dtype=torch.int64, device=x.device)
    out = x
    step = 1
    while step < cap:
        prev = torch.roll(out, step)
        out = torch.where(idx - step >= pstart, op(out, prev), out)
        step *= 2
    return out


def _partition_operands(batch: Batch, partition_by) -> List[torch.Tensor]:
    ops: List[torch.Tensor] = []
    for pi in partition_by:
        c = batch.columns[pi]
        ops.append((~c.validity).to(torch.int32))
        if c.data.ndim == 2:
            # long-decimal limb pairs: two operands (hi, unsigned lo)
            ops.append(torch.where(c.validity, c.data[:, 0], 0))
            ops.append(torch.where(c.validity, c.data[:, 1] ^ (-(1 << 63)),
                                   0))
            continue
        d = c.data.to(torch.int32) if c.data.dtype == torch.bool else c.data
        # neutralize NULL rows' storage so stale values can't split one
        # NULL partition into many
        ops.append(torch.where(c.validity, d, torch.zeros_like(d)))
    return ops


def _boundaries(ops: Sequence[torch.Tensor], start: torch.Tensor
                ) -> torch.Tensor:
    out = start.clone()
    for op in ops:
        out = out | (op != torch.roll(op, 1))
    out[0] = True
    return out


def _runs(boundary: torch.Tensor, idx: torch.Tensor, live_n: torch.Tensor):
    """(start, inclusive end) of each lane's run; runs end at the last
    live row."""
    start = _cummax(torch.where(boundary, idx, -1))
    ends = torch.roll(boundary, -1)
    ends[-1] = True
    nxt = _reverse_cummin(torch.where(ends, idx + 1, _I64_MAX))
    return start, torch.minimum(nxt, live_n) - 1


def evaluate_window(
    batch: Batch,
    partition_by: Sequence[int],
    order_by: Sequence[SortKey],
    specs: Sequence[WindowSpec],
    errors: Optional[list] = None,
) -> Batch:
    """Append one output column per spec; rows re-ordered by
    (partition, order, original position). When a spec is an integral
    ``sum``, one device int32 scalar (NUMERIC_VALUE_OUT_OF_RANGE where
    a live row's frame sum leaves int64, else 0) is appended to
    ``errors``, the executor's error flags."""
    cap = batch.capacity
    dev = batch.device
    # ---- global sort: dead rows last, then partition keys, then order keys
    part_ops = _partition_operands(batch, partition_by)
    order_ops: List[torch.Tensor] = []
    for k in order_by:
        order_ops.extend(_sortable(batch.columns[k.column], k))
    perm = lexsort_permutation([(~batch.row_mask).to(torch.int32)]
                               + part_ops + order_ops)
    s_part = [op[perm] for op in part_ops]
    s_order = [op[perm] for op in order_ops]
    mask = batch.row_mask[perm]
    s_cols = [(gather_rows(c.data, perm), c.validity[perm])
              for c in batch.columns]

    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    first = torch.zeros(cap, dtype=torch.bool, device=dev)
    first[0] = True

    # ---- partitions, and peer runs (order-key ties) within them
    live_n = mask.sum(dtype=torch.int64)
    pboundary = _boundaries(s_part, first)
    pstart, pend = _runs(pboundary, idx, live_n)
    psize = torch.clamp(pend - pstart + 1, min=1)
    oboundary = _boundaries(s_order, pboundary)
    ostart, oend = _runs(oboundary, idx, live_n)

    row_in_part = idx - pstart                                    # 0-based
    dense = prefix_sum(oboundary.to(torch.int64))                 # global
    dense_at_pstart = dense[pstart.clamp(min=0)]

    # first-order-key context for offset RANGE frames: raw sorted values,
    # their validity, direction, each partition's non-NULL run, and the
    # key's decimal scale factor (offsets are given in VALUE space)
    order_ctx = (None, None, True, pstart, pend, 1)
    if order_by:
        k0 = order_by[0]
        k0_col = batch.columns[k0.column]
        key_scale = (10 ** k0_col.type.scale
                     if isinstance(k0_col.type, T.DecimalType) else 1)
        ovals = k0_col.data[perm]
        ovalid = k0_col.validity[perm] & mask
        at_pend = pend.clamp(0, cap - 1)
        vfirst = _segment_scan(torch.where(ovalid, idx, _I64_MAX), pstart,
                               torch.minimum)[at_pend]
        vlast = _segment_scan(torch.where(ovalid, idx, -1), pstart,
                              torch.maximum)[at_pend]
        order_ctx = (ovals, ovalid, bool(k0.ascending), vfirst, vlast,
                     key_scale)

    fields: List[Tuple[str, Type]] = list(zip(batch.schema.names,
                                              batch.schema.types))
    new_cols = [Column(c.type, d, v, c.dictionary)
                for c, (d, v) in zip(batch.columns, s_cols)]
    ctx = _Ctx(s_cols, batch, mask, idx, pstart, pend, psize, row_in_part,
               ostart, oend, dense, dense_at_pstart, order_ctx, [])
    for spec in specs:
        data, valid = _one_window(spec, ctx)
        fields.append((spec.name, spec.output_type))
        # string-valued outputs (lag/lead/first/last/nth_value, min/max
        # over varchar) are codes into the argument column's vocabulary
        # (reference LagFunction.java returns the source block's value)
        dictionary = None
        if spec.output_type.is_string and spec.args:
            dictionary = batch.columns[spec.args[0]].dictionary
        new_cols.append(Column(spec.output_type,
                               data.to(spec.output_type.storage_dtype),
                               valid & mask, dictionary))
    if ctx.overflow and errors is not None:
        errors.append(overflow_code(ctx.overflow, dev))
    return Batch(Schema(fields), new_cols, mask)


@dataclasses.dataclass
class _Ctx:
    """The sorted batch and its partition / peer-run positions."""

    s_cols: List[Tuple[torch.Tensor, torch.Tensor]]
    batch: Batch
    mask: torch.Tensor
    idx: torch.Tensor
    pstart: torch.Tensor
    pend: torch.Tensor
    psize: torch.Tensor
    row_in_part: torch.Tensor
    ostart: torch.Tensor
    oend: torch.Tensor
    dense: torch.Tensor
    dense_at_pstart: torch.Tensor
    order_ctx: tuple
    #: per-row overflow flags of the checked integral sums
    overflow: List[torch.Tensor]


def _gather(data, valid, src, cap, ok=None):
    src = src.clamp(0, cap - 1)
    v = valid[src]
    return data[src], v if ok is None else v & ok


def _one_window(spec: WindowSpec, c: _Ctx):
    fn = spec.fn
    mask, idx, pstart, pend = c.mask, c.idx, c.pstart, c.pend
    cap = mask.shape[0]
    ones = torch.ones(cap, dtype=torch.bool, device=mask.device)
    # explicit frame positions (ranking functions and lag/lead ignore
    # frames per the SQL standard)
    explicit = (not spec.default_frame
                and fn not in RANKING and fn not in ("lag", "lead"))
    if explicit:
        fs, fe = _frame_positions(spec, idx, pstart, pend, c.ostart, c.oend,
                                  c.order_ctx)
        frame_nonempty = fe >= fs
    if fn == "row_number":
        return c.row_in_part + 1, ones
    if fn == "rank":
        return c.ostart - pstart + 1, ones
    if fn == "dense_rank":
        return c.dense - c.dense_at_pstart + 1, ones
    if fn == "percent_rank":
        r = (c.ostart - pstart).to(torch.float64)
        den = torch.clamp(c.psize - 1, min=1).to(torch.float64)
        return torch.where(c.psize > 1, r / den, 0.0), ones
    if fn == "cume_dist":
        covered = (c.oend - pstart + 1).to(torch.float64)
        return covered / c.psize.to(torch.float64), ones
    if fn == "ntile":
        n = spec.offset
        size, rem = c.psize // n, c.psize % n
        big = (size + 1) * rem
        rip = c.row_in_part
        bucket = torch.where(
            rip < big, rip // torch.clamp(size + 1, min=1),
            rem + (rip - big) // torch.clamp(size, min=1))
        return bucket + 1, ones

    def col(j):
        return c.s_cols[j]

    if fn in ("lag", "lead"):
        data, valid = col(spec.args[0])
        off = spec.offset if fn == "lag" else -spec.offset
        src = idx - off
        return _gather(data, valid, src, cap, (src >= pstart) & (src <= pend))
    if fn == "first_value":
        data, valid = col(spec.args[0])
        if explicit:
            return _gather(data, valid, fs, cap, frame_nonempty)
        return _gather(data, valid, pstart, cap)
    # frame end: RANGE frames end at the current row's last peer, ROWS
    # frames at the current row itself (reference window/FrameInfo.java)
    frame_end = idx if spec.frame == "rows" else c.oend

    if fn == "last_value":
        data, valid = col(spec.args[0])
        if explicit:
            return _gather(data, valid, fe, cap, frame_nonempty)
        return _gather(data, valid, frame_end, cap)
    if fn == "nth_value":
        data, valid = col(spec.args[0])
        if explicit:
            src = fs + spec.offset - 1
            return _gather(data, valid, src, cap,
                           frame_nonempty & (src <= fe))
        src = pstart + spec.offset - 1
        return _gather(data, valid, src, cap,
                       src <= torch.minimum(frame_end, pend))

    # ---- aggregates --------------------------------------------------------
    if fn == "count_star":
        data, valid_in = mask.to(torch.int64), mask
    else:
        data, valid_in = col(spec.args[0])
        valid_in = valid_in & mask
    acc_dtype = spec.output_type.storage_dtype
    if fn in ("min", "max"):
        return _min_max(spec, c, data, valid_in, acc_dtype, explicit,
                        fs if explicit else None, fe if explicit else None,
                        frame_end)
    if fn in ("count", "count_star"):
        x = valid_in.to(torch.int64)
    else:
        x = data.to(torch.float64 if fn == "avg" else acc_dtype)
        x = torch.where(valid_in, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
    # sum / count / avg: prefix-sum differences over the sorted order
    if explicit:
        def frame_sum(v):
            csum = prefix_sum(v)
            zero = torch.zeros((), dtype=csum.dtype, device=csum.device)
            base = torch.where(fs > 0, csum[(fs - 1).clamp(0, cap - 1)],
                               zero)
            return torch.where(fe >= fs, csum[fe.clamp(0, cap - 1)] - base,
                               zero)
        cnt = _frame_count(valid_in, fs, fe)
    else:
        upto = _agg_frame_end(spec, frame_end, pend)

        def frame_sum(v):
            csum = prefix_sum(v)
            zero = torch.zeros((), dtype=csum.dtype, device=csum.device)
            base = torch.where(pstart > 0,
                               csum[(pstart - 1).clamp(min=0)], zero)
            return csum[upto.clamp(0, cap - 1)] - base
        cnt = _running_count(valid_in, pstart, upto)
    if fn == "sum" and x.dtype == torch.int64:
        # checked: per-plane prefix sums cannot wrap below 2^31 rows
        assert cap <= CHECKED_SUM_MAX_ROWS, cap
        hi, lo = i64_planes(x)
        val, ovf = from_plane_sums(frame_sum(hi), frame_sum(lo))
        c.overflow.append(ovf & mask)
    else:
        val = frame_sum(x)
    if fn in ("count", "count_star"):
        return val, ones
    if fn == "avg":
        return val / torch.clamp(cnt, min=1).to(torch.float64), cnt > 0
    return val, cnt > 0


def _min_max(spec, c: _Ctx, data, valid_in, acc_dtype, explicit, fs, fe,
             frame_end):
    """MIN/MAX over the frame; strings compare lexicographic ranks, not
    codes (codes are assigned in order of appearance)."""
    cap = data.shape[0]
    col_in = c.batch.columns[spec.args[0]]
    vocab = col_in.dictionary if col_in.type.is_string else None
    if col_in.type.is_string:
        xdata = rank_codes(data, vocab)
    else:
        xdata = data.to(acc_dtype)
    red_dtype = xdata.dtype
    if red_dtype.is_floating_point:
        big, small = float("inf"), float("-inf")
    else:
        big, small = torch.iinfo(red_dtype).max, torch.iinfo(red_dtype).min
    sent = big if spec.fn == "min" else small
    op = torch.minimum if spec.fn == "min" else torch.maximum
    xm = torch.where(valid_in, xdata,
                     torch.full((), sent, dtype=red_dtype,
                                device=xdata.device))
    if explicit:
        # arbitrary [fs, fe] frames: sparse-table range queries; constant
        # ROWS offsets statically bound the frame width
        max_width = None
        if spec.frame == "rows" and \
                spec.frame_start[0] != "unbounded_preceding" and \
                spec.frame_end[0] != "unbounded_following":
            max_width = spec.frame_start[1] + spec.frame_end[1] + 1
        tabs = _rmq_tables(xm, op, sent, max_width)
        val = _rmq_query(tabs, op, sent, fs, fe)
        cnt = _frame_count(valid_in, fs, fe)
    else:
        run = _segment_scan(xm, c.pstart, op)
        upto = _agg_frame_end(spec, frame_end, c.pend)
        val = run[upto.clamp(0, cap - 1)]
        cnt = _running_count(valid_in, c.pstart, upto)
    if vocab is not None:
        # map the winning rank back to a dictionary code
        inv = unrank_table(vocab, val.device)
        val = inv[val.clamp(0, inv.shape[0] - 1)]
    return val, cnt > 0


def _agg_frame_end(spec, frame_end, pend):
    """Frame end for running aggregates: an explicit ROWS frame always ends
    at the current row, even without ORDER BY (ignore_order covers only the
    default whole-partition frame of order-less windows)."""
    if spec.frame == "rows":
        return frame_end
    return pend if spec.ignore_order else frame_end


def _running_count(valid_in, pstart, upto):
    cap = valid_in.shape[0]
    csum = prefix_sum(valid_in.to(torch.int64))
    base = torch.where(pstart > 0, csum[(pstart - 1).clamp(min=0)], 0)
    return csum[upto.clamp(0, cap - 1)] - base


def _frame_count(valid_in, fs, fe):
    """Valid-row count over explicit [fs, fe] frames (0 when empty)."""
    cap = valid_in.shape[0]
    csum = prefix_sum(valid_in.to(torch.int64))
    base = torch.where(fs > 0, csum[(fs - 1).clamp(0, cap - 1)], 0)
    return torch.where(fe >= fs, csum[fe.clamp(0, cap - 1)] - base, 0)
