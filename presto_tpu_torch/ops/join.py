"""Join kernels: unique-build lookup joins (sorted or direct-address).

The counterpart of ``presto_tpu/ops/join.py`` (reference
presto-main/.../operator/HashBuilderOperator.java:51,
LookupJoinOperator.java, PagesHash.java): the build side is sorted by key
once; each probe lane finds its match by binary search over the sorted
keys, or — for an integer key with a bounded span — by two lookups in a
direct-address table (``prepare_direct`` / ``prepare_direct_keyed``). The
output has the probe's capacity, with the row mask narrowed for misses
(inner) or payload validity cleared (left outer).

SQL semantics: NULL keys never match (either side).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..batch import Batch, Column, Schema

_I64_MAX = torch.iinfo(torch.int64).max
_FLIP = 0x7FFFFFFFFFFFFFFF


def _key_arrays(batch: Batch, key_cols: Sequence[int]
                ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Per-column comparable int64 key operands + combined key validity.

    Integer-family columns (ints, dates, decimals, dictionary codes,
    booleans) widen to int64; doubles map through the IEEE-754 total-order
    bit trick onto signed int64 (monotone and exact); long-decimal limb
    pairs become two operands (signed hi, unsigned-ordered lo)."""
    ops: List[torch.Tensor] = []
    valid: Optional[torch.Tensor] = None
    for i in key_cols:
        c = batch.columns[i]
        d = c.data
        if d.ndim == 2:
            ops.append(d[:, 0])
            ops.append(d[:, 1] ^ (-_I64_MAX - 1))
        elif d.is_floating_point():
            # +0.0 canonicalization: SQL equality joins the two zeros
            bits = (d.to(torch.float64) + 0.0).view(torch.int64)
            ops.append(torch.where(bits >= 0, bits, bits ^ _FLIP))
        else:
            ops.append(d.to(torch.int64))
        valid = c.validity if valid is None else valid & c.validity
    return ops, valid


def lexsort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows lexicographically by ``keys``
    (most significant first): successive stable sorts from the least
    significant key."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(list(keys)):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def build_sorted(build: Batch, key_cols: Sequence[int]):
    """Sort the build side by the key tuple; dead and null-key rows to the
    end (their operands overwritten with the int64 max sentinel).

    Returns (sorted_key_ops, sorted_live, permutation)."""
    ops, kvalid = _key_arrays(build, key_cols)
    live = build.row_mask & kvalid
    dead_rank = (~live).to(torch.int32)
    perm = lexsort_permutation([dead_rank] + ops)
    slive = live[perm]
    s_ops = [torch.where(slive, op[perm], _I64_MAX) for op in ops]
    return s_ops, slive, perm


def prepare_build(build: Batch, key_cols: Sequence[int]):
    """One-time build-side preparation shared by every probe batch (the
    role of the reference's LookupSource)."""
    return build_sorted(build, key_cols)


def _direct_tables(slive, tgt, size: int):
    """(lo_table, cnt_table) int32[size] from each sorted build row's slot
    ``tgt`` (dead rows -> the overflow slot ``size``): empty slots hold
    (n, 0)."""
    n = slive.shape[0]
    dev = slive.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    lo_table = torch.full((size + 1,), n, dtype=torch.int32, device=dev)
    lo_table.scatter_reduce_(0, tgt, idx, reduce="amin")
    cnt_table = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    cnt_table.scatter_add_(0, tgt, torch.ones_like(idx))
    return lo_table[:size], cnt_table[:size]


def prepare_direct(build: Batch, key_cols: Sequence[int], lo0: int,
                   size: int):
    """Direct-address lookup table for a single integer key with a
    host-known bounded range (reference BigintGroupByHash.java's array
    mode applied to joins): a probe key's sorted match run [lo, lo+cnt)
    comes from TWO table reads, independent of build size.

    Returns (lo0, lo_table, cnt_table, s_ops, slive, perm); tables are
    indexed by (key - lo0)."""
    s_ops, slive, perm = build_sorted(build, key_cols)
    off = (s_ops[0] - lo0).clamp(0, size - 1)
    tgt = torch.where(slive, off, size)
    lo_table, cnt_table = _direct_tables(slive, tgt, size)
    return (int(lo0), lo_table, cnt_table, s_ops, slive, perm)


#: largest composite slot-table size a planner-keyed direct build may
#: allocate; the planner gate (optimizer._attach_join_strategy) and the
#: executor both respect it
DIRECT_KEYED_LIMIT = 1 << 26


def direct_keyed_plan(key_bounds, limit: int = DIRECT_KEYED_LIMIT):
    """Host-static (los, sizes, K) for a planner-bounded multi-key
    direct-address table, or None when it cannot engage."""
    if not key_bounds or any(b is None for b in key_bounds):
        return None
    los: List[int] = []
    sizes: List[int] = []
    K = 1
    for lo, hi in key_bounds:
        if hi < lo:
            return None
        span = int(hi) - int(lo) + 1
        los.append(int(lo))
        sizes.append(span)
        K *= span
        if K > limit:
            return None
    return tuple(los), tuple(sizes), K


def _composite_code(ops: Sequence[torch.Tensor], los, sizes):
    """(code, in_domain) of key-operand tuples against per-key
    [lo, lo+size) domains: the mixed-radix slot index."""
    code = torch.zeros(ops[0].shape, dtype=torch.int64, device=ops[0].device)
    ind = torch.ones(ops[0].shape, dtype=torch.bool, device=ops[0].device)
    for op, lo, size in zip(ops, los, sizes):
        off = op - lo
        ind = ind & (off >= 0) & (off < size)
        code = code * size + off.clamp(0, size - 1)
    return code, ind


def prepare_direct_keyed(build: Batch, key_cols: Sequence[int],
                         los: Sequence[int], sizes: Sequence[int],
                         size: int):
    """Multi-key direct-address table from PLANNER-PROMISED key bounds.
    Live build keys outside their bounds land in the overflow slot (the
    executor raises STATS_BOUND_VIOLATION for them).

    Returns (los, sizes, lo_table, cnt_table, s_ops, slive, perm)."""
    s_ops, slive, perm = build_sorted(build, key_cols)
    code, inr = _composite_code(s_ops, los, sizes)
    tgt = torch.where(slive & inr, code, size)
    lo_table, cnt_table = _direct_tables(slive, tgt, size)
    return (tuple(los), tuple(sizes), lo_table, cnt_table, s_ops, slive,
            perm)


def _is_direct(prepared) -> bool:
    return prepared is not None and len(prepared) == 6


def _is_direct_keyed(prepared) -> bool:
    return prepared is not None and len(prepared) == 7


def is_direct_prepared(prepared) -> bool:
    """Either direct layout (single-key measured or multi-key planner
    bounds)."""
    return _is_direct(prepared) or _is_direct_keyed(prepared)


def split_prepared(prepared):
    """(s_ops, slive, perm) of any prepared build."""
    if _is_direct(prepared):
        return prepared[3], prepared[4], prepared[5]
    if _is_direct_keyed(prepared):
        return prepared[4], prepared[5], prepared[6]
    return prepared


def direct_tables(prepared):
    """(lo_table, cnt_table) of a direct prepared build."""
    if _is_direct(prepared):
        return prepared[1], prepared[2]
    return prepared[2], prepared[3]


def direct_slot_codes(q_ops, prepared):
    """(slot, in_domain) probe-side addressing of a direct prepared build:
    slot is a clamped int64 index into the lookup tables. Shared by the
    plain lookup path and the CUDA probe so the two agree by
    construction."""
    lo_table = direct_tables(prepared)[0]
    size = lo_table.shape[0]
    if _is_direct(prepared):
        off = q_ops[0] - prepared[0]
        inr = (off >= 0) & (off < size)
        return off.clamp(0, size - 1), inr
    code, inr = _composite_code(q_ops, prepared[0], prepared[1])
    return code.clamp(0, size - 1), inr


def _lex_searchsorted(s_ops: Sequence[torch.Tensor],
                      q_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Leftmost insertion point of each query tuple among lexicographically
    sorted operand arrays (searchsorted over composite keys)."""
    if len(s_ops) == 1:
        return torch.searchsorted(s_ops[0], q_ops[0])
    n = s_ops[0].shape[0]
    lo = torch.zeros(q_ops[0].shape, dtype=torch.int64,
                     device=q_ops[0].device)
    hi = torch.full_like(lo, n)
    for _ in range(max(n.bit_length(), 1)):
        mid = (lo + hi) >> 1
        safe = mid.clamp(max=n - 1)
        less = torch.zeros(mid.shape, dtype=torch.bool, device=mid.device)
        eq = torch.ones_like(less)
        for s, q in zip(s_ops, q_ops):
            sv = s[safe]
            less = less | (eq & (sv < q))
            eq = eq & (sv == q)
        active = lo < hi
        go = less & active
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def _point_lookup(q_ops, prepared):
    """(pos, hit) of each probe lane's first match in the sorted build."""
    s_ops, slive, _ = split_prepared(prepared)
    n = s_ops[0].shape[0]
    if is_direct_prepared(prepared):
        lo_table, cnt_table = direct_tables(prepared)
        idx, inr = direct_slot_codes(q_ops, prepared)
        lo = torch.where(inr, lo_table[idx], n)
        cnt = torch.where(inr, cnt_table[idx], 0)
        return lo.clamp(0, n - 1).to(torch.int64), cnt > 0
    pos = _lex_searchsorted(s_ops, q_ops).clamp(max=n - 1)
    hit = slive[pos]
    for s, q in zip(s_ops, q_ops):
        hit = hit & (s[pos] == q)
    return pos, hit


def lookup_join(probe: Batch, build: Batch, probe_keys: Sequence[int],
                build_keys: Sequence[int], payload: Sequence[int],
                payload_names: Sequence[str], join_type: str = "inner",
                prepared=None) -> Batch:
    """Join probe against a unique-key build side with plain tensor
    gathers (sorted or direct prepared build).

    join_type: 'inner' | 'left'. Output schema = probe columns + named
    build payload columns."""
    assert join_type in ("inner", "left")
    prepared = prepared or build_sorted(build, build_keys)
    _, _, perm = split_prepared(prepared)
    q_ops, pvalid = _key_arrays(probe, probe_keys)
    pos, hit = _point_lookup(q_ops, prepared)
    match = probe.row_mask & pvalid & hit
    rows = perm[pos]
    out_fields = list(zip(probe.schema.names, probe.schema.types))
    out_cols: List[Column] = list(probe.columns)
    for ci, name in zip(payload, payload_names):
        c = build.columns[ci]
        out_fields.append((name, c.type))
        out_cols.append(Column(c.type, c.data[rows],
                               c.validity[rows] & match, c.dictionary))
    mask = match if join_type == "inner" else probe.row_mask
    return Batch(Schema(out_fields), out_cols, mask)
