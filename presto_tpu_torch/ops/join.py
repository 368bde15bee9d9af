"""Join kernels: lookup, expanding and membership joins over a sorted or
direct-address build.

The counterpart of ``presto_tpu/ops/join.py`` (reference
presto-main/.../operator/HashBuilderOperator.java:51,
LookupJoinOperator.java, PagesHash.java): the build side is sorted by key
once; each probe lane finds its match by binary search over the sorted
keys, or — for an integer key with a bounded span — by two lookups in a
direct-address table (``prepare_direct`` / ``prepare_direct_keyed``). The
output has the probe's capacity, with the row mask narrowed for misses
(inner) or payload validity cleared (left outer). ``expand_join`` serves
non-unique builds with a static expansion factor; ``semi_join_mask``
and the build-side match masks serve semi, anti and FULL OUTER joins.
Every scatter here is an integer add or max, so CPU and CUDA give the
same result in any order.

SQL semantics: NULL keys never match (either side).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..batch import Batch, Column, Schema, gather_rows, map_parts

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
                      q_ops: Sequence[torch.Tensor],
                      right: bool = False) -> torch.Tensor:
    """Leftmost (or, with ``right``, rightmost) insertion point of each
    query tuple among lexicographically sorted operand arrays
    (searchsorted over composite keys)."""
    if len(s_ops) == 1:
        return torch.searchsorted(s_ops[0], q_ops[0], right=right)
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
        go = (less | eq if right else less) & active
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def _range_lookup(q_ops, prepared):
    """Per-probe-lane [lo, hi) of its key's run in the SORTED build: two
    direct-table reads, or two composite binary searches."""
    s_ops = split_prepared(prepared)[0]
    if is_direct_prepared(prepared):
        n = s_ops[0].shape[0]
        lo_table, cnt_table = direct_tables(prepared)
        idx, inr = direct_slot_codes(q_ops, prepared)
        lo = torch.where(inr, lo_table[idx], n).to(torch.int64)
        cnt = torch.where(inr, cnt_table[idx], 0).to(torch.int64)
        return lo, lo + cnt
    return (_lex_searchsorted(s_ops, q_ops),
            _lex_searchsorted(s_ops, q_ops, right=True))


def _point_lookup(q_ops, prepared):
    """(pos, hit) of each probe lane's first match in the sorted build."""
    s_ops, slive, _ = split_prepared(prepared)
    n = s_ops[0].shape[0]
    if is_direct_prepared(prepared):
        lo, hi = _range_lookup(q_ops, prepared)
        return lo.clamp(0, n - 1), hi > lo
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
        out_cols.append(Column(c.type, gather_rows(c.data, rows),
                               c.validity[rows] & match, c.dictionary))
    mask = match if join_type == "inner" else probe.row_mask
    return Batch(Schema(out_fields), out_cols, mask)


def match_count_max(probe: Batch, build: Batch, probe_keys: Sequence[int],
                    build_keys: Sequence[int], prepared=None) -> torch.Tensor:
    """Most build matches of any live probe key in this batch (device
    scalar): the per-batch expansion factor of a skewed build (reference
    operator/ArrayPositionLinks.java chain length)."""
    prepared = prepared or build_sorted(build, build_keys)
    q_ops, pvalid = _key_arrays(probe, probe_keys)
    lo, hi = _range_lookup(q_ops, prepared)
    cnt = torch.where(probe.row_mask & pvalid, hi - lo, 0)
    return cnt.max() if cnt.shape[0] else torch.zeros(
        (), dtype=torch.int64, device=cnt.device)


def _run_starts(s_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """For each sorted build row, the index of the first row of its key
    run (a running max of the run-start positions)."""
    n = s_ops[0].shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=s_ops[0].device)
    diff = torch.zeros(n, dtype=torch.bool, device=idx.device)
    diff[0] = True
    for op in s_ops:
        diff[1:] |= op[1:] != op[:-1]
    return idx, torch.cummax(torch.where(diff, idx, -1), 0).values


def max_multiplicity(prepared) -> torch.Tensor:
    """Largest live-key multiplicity of a prepared build (device int64
    scalar): a bound on ``match_count_max`` for every probe batch, read
    back once per build."""
    if is_direct_prepared(prepared):
        cnt_table = direct_tables(prepared)[1]
        if cnt_table.shape[0] == 0:
            return torch.zeros((), dtype=torch.int64,
                               device=cnt_table.device)
        return cnt_table.max().to(torch.int64)
    s_ops, slive, _ = prepared
    if s_ops[0].shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=slive.device)
    idx, start = _run_starts(s_ops)
    # dead rows share one sentinel run; slive excludes them
    return torch.where(slive, idx - start + 1, 0).max()


def _expand_slots(probe: Batch, probe_keys, prepared, k: int):
    """(pos, matched, slot-major [k, C] grids) of the first ``k`` matches
    of every probe lane, as positions in the sorted build."""
    s_ops, slive, _ = split_prepared(prepared)
    q_ops, pvalid = _key_arrays(probe, probe_keys)
    lo, hi = _range_lookup(q_ops, prepared)
    cnt = torch.where(probe.row_mask & pvalid, hi - lo, 0)
    slot = torch.arange(k, device=lo.device)[:, None]
    pos = torch.clamp(lo[None, :] + slot, max=s_ops[0].shape[0] - 1)
    # slive guards the sentinel edge (a probe key equal to int64 max would
    # otherwise "match" dead build rows)
    matched = (slot < cnt[None, :]) & slive[pos]
    return pos, matched, cnt


def _tile(t: torch.Tensor, k: int) -> torch.Tensor:
    """k copies of a column along the row axis (slot-major)."""
    return t.repeat((k,) + (1,) * (t.ndim - 1))


def expand_join(probe: Batch, build: Batch, probe_keys: Sequence[int],
                build_keys: Sequence[int], payload: Sequence[int],
                payload_names: Sequence[str], join_type: str = "inner",
                max_matches: int = 1, prepared=None) -> Batch:
    """Many-to-many equi-join with a static expansion factor: output
    capacity = probe capacity x ``max_matches``; lane ``s * C + i`` holds
    probe row i's s-th match (masked off past its match count). A left
    join keeps an unmatched probe row in slot 0 with NULL payload."""
    assert join_type in ("inner", "left")
    k = max(1, max_matches)
    prepared = prepared or build_sorted(build, build_keys)
    perm = split_prepared(prepared)[2]
    pos, matched, cnt = _expand_slots(probe, probe_keys, prepared, k)
    rows = perm[pos].reshape(-1)
    flat = matched.reshape(-1)
    out_fields = list(zip(probe.schema.names, probe.schema.types))
    out_cols: List[Column] = [
        Column(c.type, map_parts(c.data, lambda a: _tile(a, k)),
               _tile(c.validity, k), c.dictionary)
        for c in probe.columns]
    for ci, name in zip(payload, payload_names):
        c = build.columns[ci]
        out_fields.append((name, c.type))
        out_cols.append(Column(c.type, gather_rows(c.data, rows),
                               c.validity[rows] & flat, c.dictionary))
    if join_type == "inner":
        mask = flat
    else:
        first = torch.zeros_like(matched)
        first[0] = (cnt == 0) & probe.row_mask
        mask = flat | first.reshape(-1)
    return Batch(Schema(out_fields), out_cols, mask)


def build_key_ranks(build: Batch, key_cols: Sequence[int],
                    prepared=None) -> torch.Tensor:
    """0-based occurrence rank of each build row within its key tuple, in
    ORIGINAL row order (dead and null-key rows get 0): slices a skewed
    build into bounded-multiplicity chunks."""
    s_ops, slive, perm = split_prepared(
        prepared or build_sorted(build, key_cols))
    idx, start = _run_starts(s_ops)
    out = torch.zeros(idx.shape[0], dtype=torch.int64, device=idx.device)
    out[perm] = torch.where(slive, idx - start, 0)
    return out


def build_match_mask(probe: Batch, build: Batch, probe_keys: Sequence[int],
                     build_keys: Sequence[int],
                     prepared=None) -> torch.Tensor:
    """bool[build.capacity] in ORIGINAL build order: the build rows with at
    least one live match in this probe batch (a FULL OUTER join's
    visited-positions bitmap; reference LookupOuterOperator)."""
    prepared = prepared or build_sorted(build, build_keys)
    s_ops, slive, perm = split_prepared(prepared)
    q_ops, pvalid = _key_arrays(probe, probe_keys)
    live = probe.row_mask & pvalid
    lo, hi = _range_lookup(q_ops, prepared)
    n = s_ops[0].shape[0]
    # difference-array coverage of every [lo, hi): integer adds, exact in
    # any order
    inc = live.to(torch.int32)
    add = torch.zeros(n + 1, dtype=torch.int32, device=lo.device)
    add.index_add_(0, torch.where(live, lo, n), inc)
    add.index_add_(0, torch.where(live, hi, n), -inc)
    covered = (torch.cumsum(add[:n], 0) > 0) & slive
    out = torch.zeros(n, dtype=torch.bool, device=lo.device)
    out[perm] = covered
    return out


def semi_join_mask(probe: Batch, build: Batch, probe_keys: Sequence[int],
                   build_keys: Sequence[int], negated: bool = False,
                   null_aware: bool = True, prepared=None) -> torch.Tensor:
    """Membership mask of a semi or anti join (IN / NOT IN / [NOT] EXISTS;
    reference HashSemiJoinOperator.java + SetBuilderOperator.java).

    null_aware=True (IN / NOT IN): a NULL probe key never matches; for NOT
    IN, any NULL build key makes a non-matching row UNKNOWN (nothing
    passes), while an EMPTY build makes NOT IN true for every probe row,
    NULL keys included. null_aware=False (decorrelated [NOT] EXISTS): NULL
    keys simply never match, so NOT EXISTS keeps every row without a live
    match."""
    prepared = prepared or build_sorted(build, build_keys)
    q_ops, pvalid = _key_arrays(probe, probe_keys)
    _, hit = _point_lookup(q_ops, prepared)
    if not negated:
        return probe.row_mask & pvalid & hit
    if not null_aware:
        return probe.row_mask & ~(pvalid & hit)
    _, bvalid = _key_arrays(build, build_keys)
    build_has_null = (build.row_mask & ~bvalid).any()
    build_empty = ~build.row_mask.any()
    anti = probe.row_mask & pvalid & ~hit & ~build_has_null
    return torch.where(build_empty, probe.row_mask, anti)


def mark_rows(rows: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n]: which of rows[ok] occur (a max-scatter into an overflow
    slot that takes the lanes not ok; exact in any order)."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=rows.device)
    out.scatter_reduce_(0, torch.where(ok, rows, n), ok.to(torch.int32),
                        reduce="amax")
    return out[:n] > 0


def unique_match_build_mask(probe: Batch, build: Batch,
                            probe_keys: Sequence[int],
                            build_keys: Sequence[int],
                            survived: torch.Tensor,
                            prepared=None) -> torch.Tensor:
    """bool[build.capacity] in ORIGINAL build order: build rows whose
    unique-key match in this probe batch SURVIVED a residual predicate
    (reference LookupJoinOperator's OuterPositionTracker with a join
    filter: a filtered-out match leaves the build row unmatched)."""
    prepared = prepared or build_sorted(build, build_keys)
    s_ops, _, perm = split_prepared(prepared)
    q_ops, pvalid = _key_arrays(probe, probe_keys)
    pos, hit = _point_lookup(q_ops, prepared)
    ok = survived & hit & probe.row_mask & pvalid
    return mark_rows(perm[pos], ok, s_ops[0].shape[0])


def expand_match_origins(probe: Batch, build: Batch,
                         probe_keys: Sequence[int], build_keys: Sequence[int],
                         max_matches: int, prepared=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(original build row, matched) of every ``expand_join`` output lane,
    in its lane order: lets a residual-filtered FULL OUTER join mark the
    build rows whose matches survived."""
    prepared = prepared or build_sorted(build, build_keys)
    perm = split_prepared(prepared)[2]
    pos, matched, _ = _expand_slots(probe, probe_keys, prepared,
                                    max(1, max_matches))
    return perm[pos].reshape(-1), matched.reshape(-1)
