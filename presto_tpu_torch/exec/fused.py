"""Fused join chains: a chain of unique-build lookup joins, with the
filters and projections between them, run as one head/tail program pair
per probe batch.

The counterpart of ``presto_tpu/exec/fused.py`` (the reference's
ScanFilterAndProjectOperator fusion, operator/
ScanFilterAndProjectOperator.java:62, generalized to join chains). The
JAX package compiles each program into one XLA executable; here each is
a plain callable over tensors (an ``lru_cache`` over the frozen stage
tuple builds it once per chain shape). What the pair buys on the card is
the order of work:

- the HEAD applies every dynamic-filter bound that maps to a raw source
  column, the source-side filter and projection stages, and (for an
  inner first join) the first join's key-membership mask, gathering no
  payload; it returns the batch's live count as a 0-d device tensor, so
  the executor reads a window of counts back in one sync and compacts
  the surviving lanes (``exec/local._stream_fused``);
- the TAIL then runs every join's payload gathers, and the stages
  between them, over the compacted lanes only.

Each stage applies the same kernel its standalone operator would: a
``JoinStage`` over a direct-address prepared build probes through
``ops/probe.lookup_join_direct`` (the CUDA kernel on CUDA tensors, its
plain version on CPU tensors), any other build through
``ops/join.lookup_join``. A kernel that fails raises; there is no
fallback to plain code. The executor decides what to fuse
(``exec/local._try_fused_chain``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ..batch import Batch, Column, Schema, remap_codes, unify_dictionaries
from ..expr import ir
from ..expr.compiler import _err_scalar, _inputs, eval_expr
from ..ops.join import is_direct_prepared, lookup_join, semi_join_mask
from ..ops.probe import lookup_join_direct


@dataclasses.dataclass(frozen=True)
class JoinStage:
    """One unique-build lookup join. ``dyn_keys`` are probe-schema column
    indices with runtime [lo, hi] bounds from the build's summary (inner
    joins only), passed at call time so changing bounds reuse the
    program."""
    lkeys: Tuple[int, ...]
    rkeys: Tuple[int, ...]
    payload: Tuple[int, ...]
    names: Tuple[str, ...]
    join_type: str                        # inner | left
    out_fields: Tuple[Tuple[str, object], ...]
    dyn_keys: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class FilterStage:
    pred: ir.Expr


@dataclasses.dataclass(frozen=True)
class ProjectStage:
    exprs: Tuple[ir.Expr, ...]
    out_names: Tuple[str, ...]


def keys_in_build_vocab(probe: Batch, build: Batch, probe_keys,
                        build_keys) -> Batch:
    """``probe`` with each string join key re-coded into the build key's
    vocabulary, extended by the probe's strings the build lacks. The two
    sides' dictionaries are built independently (per batch for free-text
    columns), and the join kernels compare codes, so equal strings must
    carry equal codes first; the build keeps its codes."""
    cols = list(probe.columns)
    for pk, bk in zip(probe_keys, build_keys):
        pc, bc = probe.columns[pk], build.columns[bk]
        if pc.type.is_string and pc.dictionary != bc.dictionary:
            vocab, remaps = unify_dictionaries([bc, pc])
            cols[pk] = remap_codes(pc, remaps[1], vocab)
    return Batch(probe.schema, cols, probe.row_mask)


def _bounded(cur: Batch, keys: Sequence[int], bounds) -> Batch:
    """``cur`` with rows whose key is NULL or outside [lo, hi] dead."""
    keep = cur.row_mask
    for ki, (lo, hi) in zip(keys, bounds):
        c = cur.columns[ki]
        keep = keep & c.validity & (c.data >= lo) & (c.data <= hi)
    return Batch(cur.schema, cur.columns, keep)


def _apply_stages(cur: Batch, stages, preps, builds, sorted_cols, dyns,
                  errs: List[torch.Tensor]) -> Batch:
    """Apply ``stages`` in order; JoinStages take their prepared build,
    build, sorted payload (direct builds) and bounds positionally. Row
    errors append to ``errs`` as device int32 scalars."""
    ji = 0
    for st in stages:
        if isinstance(st, JoinStage):
            if st.dyn_keys:
                cur = _bounded(cur, st.dyn_keys, dyns[ji])
            build, prep = builds[ji], preps[ji]
            cur = keys_in_build_vocab(cur, build, st.lkeys, st.rkeys)
            if is_direct_prepared(prep):
                out = lookup_join_direct(cur, build, st.lkeys, st.rkeys,
                                         st.payload, st.names, st.join_type,
                                         prep, sorted_cols=sorted_cols[ji])
            else:
                out = lookup_join(cur, build, st.lkeys, st.rkeys,
                                  st.payload, st.names, st.join_type, prep)
            cur = Batch(Schema(list(st.out_fields)), out.columns,
                        out.row_mask)
            ji += 1
        elif isinstance(st, FilterStage):
            p = eval_expr(st.pred, _inputs(cur))
            err = _err_scalar([p.err], cur.row_mask)
            if err is not None:
                errs.append(err)
            cur = Batch(cur.schema, cur.columns,
                        cur.row_mask & p.valid & p.data)
        else:  # ProjectStage
            outs = [eval_expr(e, _inputs(cur)) for e in st.exprs]
            err = _err_scalar([o.err for o in outs], cur.row_mask)
            if err is not None:
                errs.append(err)
            cols = [Column(o.type, o.data, o.valid & cur.row_mask,
                           o.dictionary) for o in outs]
            cur = Batch(Schema([(n, e.type) for n, e in
                                zip(st.out_names, st.exprs)]),
                        cols, cur.row_mask)
    return cur


def _merge_errs(errs: List[torch.Tensor]) -> Optional[torch.Tensor]:
    return torch.stack(errs).max() if errs else None


@functools.lru_cache(maxsize=None)
def fused_pipeline(stages: Tuple[object, ...]):
    """The tail: fn(probe, preps, builds, sorted_cols, dyns) ->
    (Batch, err or None). ``preps``, ``builds``, ``sorted_cols`` and
    ``dyns`` hold one entry per JoinStage (bottom-up order); ``dyns[i]``
    is that stage's [(lo, hi)] aligned with its ``dyn_keys``."""

    def run(probe: Batch, preps, builds, sorted_cols, dyns):
        errs: List[torch.Tensor] = []
        cur = _apply_stages(probe, stages, preps, builds, sorted_cols, dyns,
                            errs)
        return cur, _merge_errs(errs)
    return run


@functools.lru_cache(maxsize=None)
def fused_prefilter(stages: Tuple[object, ...],
                    pre_keys: Tuple[int, ...],
                    semi_keys: Optional[Tuple[Tuple[int, ...],
                                              Tuple[int, ...]]]):
    """The head: fn(probe, pre_bounds, semi_build, semi_prep) ->
    (Batch, err or None, live count).

    ``pre_keys`` index the SOURCE schema and ``pre_bounds`` is the
    aligned [(lo, hi)]; ``stages`` are the source-side filter and
    projection stages; ``semi_keys`` = (lkeys, rkeys) of an inner first
    join, whose membership mask gates the lanes without gathering any
    payload. The live count is a 0-d device tensor (no readback here)."""

    def run(probe: Batch, pre_bounds, semi_build, semi_prep):
        cur = _bounded(probe, pre_keys, pre_bounds)
        errs: List[torch.Tensor] = []
        cur = _apply_stages(cur, stages, (), (), (), (), errs)
        if semi_keys is not None:
            lkeys, rkeys = semi_keys
            cur = keys_in_build_vocab(cur, semi_build, lkeys, rkeys)
            m = semi_join_mask(cur, semi_build, list(lkeys), list(rkeys),
                               negated=False, null_aware=False,
                               prepared=semi_prep)
            cur = Batch(cur.schema, cur.columns, cur.row_mask & m)
        count = cur.row_mask.sum(dtype=torch.int32)
        return cur, _merge_errs(errs), count
    return run
