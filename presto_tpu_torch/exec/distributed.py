"""Distributed plan executor: SPMD stages over a mesh of device slots.

The counterpart of ``presto_tpu/exec/distributed.py`` (reference
presto-main/.../sql/planner/PlanFragmenter.java:106 splits the plan at
exchanges; execution/scheduler/SqlQueryScheduler.java:533 runs the stage
DAG; operator/PartitionedOutputOperator.java:48 + ExchangeClient.java
implement the shuffle). One controller drives every slot of a
``parallel/mesh.Mesh``:

- a worker's share of a stage is a SHARD of one program run on every
  slot, not a process. Between operators a batch is a
  :class:`ShardedBatch`: one ``Batch`` per slot, each resident on its
  slot's device, all of one capacity and one vocabulary per column (the
  JAX package's row-sharded arrays, whose shard i is the i-th equal row
  range). Elementwise stages (filter, project, limit, group id) run once
  per slot on the slot's own part, with no collective;
- ``_smap`` is the per-slot dispatcher that replaces ``shard_map``: it
  hands each slot its part of every sharded input, runs the body once
  per slot, and keeps the outputs per slot. ``replicated_in`` inputs
  reach every slot whole; a ``replicated_out`` output stays as one copy
  per device (a :class:`_Replicated`), so a later program that takes it
  whole copies nothing (when every input and output is replicated the
  body runs once per device). A collective body takes the slot lists
  and calls ``parallel/exchange.py``;
- batch data comes onto the controller device (slot 0's) only at the
  root, where the rows leave for the host, and in the all-gather behind
  a shard-0 finalize; every such copy passes ``controller_copy``, which
  counts it (``stacked_bytes`` and its siblings below);
- exchanges are collectives: FIXED_HASH distribution is the
  quota-compacted all-to-all (``repartition_fused`` /
  ``repartition_by_buckets_compact``), FIXED_BROADCAST the all-gather of
  the build side, GATHER (final aggregation, top-n, a global window) a
  replicated finalize over the gathered batch whose output sits on shard
  0; sort is a range-partitioned exchange;
- aggregation splits into partial (shard-local) -> hash exchange -> final,
  exactly the PARTIAL/FINAL AggregationNode split.

Scan splits are assigned round-robin to shards (reference
execution/scheduler/UniformNodeSelector.java): shard i streams split i
through the scan cache on its slot's device, and each round's chunks
stay on their slots as one sharded batch.

Where the port differs from the JAX package:

- ``lax.fori_loop`` bodies (the fused aggregation wave) are Python loops
  over the slots and rounds; the flight record keeps the reference's
  ``rounds`` count.
- Reductions GSPMD performed implicitly over a sharded array (the
  stats-bounds violation scans, the wave's ``pmax``) are explicit: each
  slot flags its own part, and the query's error check takes the max.
- The cross-query program cache (``_PROGRAM_CACHE`` and its
  ``mesh_program_cache_{hit,miss}_total`` counters) has nothing to cache
  in torch and is left out; a shard program is a Python closure.
- String join keys are re-coded into the build's vocabulary on every
  slot after the exchange (``keys_in_build_vocab``, as the port's local
  joins do); the exchange moves codes, and hashes strings by value.
- A join's ON residual and a mark join's residual feed their row errors
  to the query's error channel, as on the single-device path.
- ``mesh_fused_exchange`` takes ``auto`` (the default) besides true and
  false. Under ``auto`` the hash exchanges take the fused plane when
  every slot has its device to itself and the counted plane when slots
  share a device (one card seen as several slots); true forces the
  fused plane, false the counted one. The fused plane's capacity-safe quota ships every shard's
  full lane count to every peer, so n slots on one device would hold
  n^2 x C lanes there and every operator after the exchange would work
  over them (Q3 at SF10 on four slots of an 80 GB card ran out of
  memory that way). The fused aggregation waves are unaffected.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from .._devtools.lockcheck import checked_lock
from ..batch import (
    Batch, Column, Schema, bucket_capacity, concat_batches, map_parts,
)
from ..expr.compiler import compile_filter, compile_projection
from ..memory import batch_device_bytes
from ..obs import flight as _flight
from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER
from ..ops.aggregation import AggSpec, global_aggregate, grouped_aggregate
from ..ops.join import (
    build_match_mask, expand_join, lookup_join, match_count_max,
    semi_join_mask,
)
from ..ops.sort import SortKey, limit as limit_kernel, sort_batch, top_n
from ..parallel import exchange as X
from ..parallel.mesh import Mesh, make_mesh, visible_slots
from ..planner.plan import (
    AggregationNode, DistinctNode, FilterNode, GroupIdNode, JoinNode,
    LimitNode, PlanNode, ProjectNode, SemiJoinNode, SortNode,
    TableScanNode, TopNNode, ValuesNode,
)
from ..planner.planner import LogicalPlan, Session, bool_property
from .failpoints import FAILPOINTS
from .fused import keys_in_build_vocab
from .local import (
    QueryResult, _Executor, _default_grouping_batch, _note_join_strategy,
    _plan_schema, cross_expand, grouping_set_batch, key_bounds_violation,
    values_batch,
)

#: mesh-path auto-selection: one count per query the router placed on
#: the mesh
_MESH_SELECTED = REGISTRY.counter("mesh_path_selected_total")
#: adaptive re-splits: one count per hot-bucket re-assignment a
#: _PartitionMap performed mid-query
_MESH_RESPLITS = REGISTRY.counter("mesh_repartition_resplit_total")
#: host dispatches onto the mesh: one count per ``_smap`` program call
#: (the dotted tail labels the issuing stage kind)
_MESH_DISPATCHES = REGISTRY.counter("mesh_dispatches_total")


class _FlightDispatch:
    """Wraps an ``_smap`` program so every host-side dispatch counts in
    ``mesh_dispatches_total`` (dotted tail = issuing stage kind) and,
    when a flight recorder is active and ``kind`` is not None, lands as
    one flight round (obs/flight.py). Call semantics are untouched."""

    __slots__ = ("entry", "kind", "rounds", "_stage_counter")

    def __init__(self, entry, kind: Optional[str], stage: str = "misc",
                 rounds: int = 1):
        self.entry = entry
        self.kind = kind
        #: exchange rounds one dispatch covers: a fused wave program
        #: amortizes R rounds behind one host touch
        self.rounds = max(int(rounds), 1)
        self._stage_counter = REGISTRY.counter(
            f"mesh_dispatches_total.{stage}")

    def __call__(self, *args):
        _MESH_DISPATCHES.inc()
        self._stage_counter.inc()
        fl = _flight.current_flight()
        if fl is None or self.kind is None:
            return self.entry(*args)
        t0 = time.perf_counter()
        out = self.entry(*args)
        fl.record(self.kind, wall=time.perf_counter() - t0,
                  rounds=self.rounds)
        return out


def _batch_row_bytes(batch: Batch) -> int:
    """Rough per-row wire width (column storage + validity + mask): the
    flight recorder's bytes-moved estimate for an exchange round."""
    total = 1
    for c in batch.columns:
        for a in (c.data if isinstance(c.data, tuple) else (c.data,)):
            total += a.element_size() * (a[0].numel() if a.ndim > 1 else 1)
        total += 1
    return total


def _tensors(values) -> Iterator[torch.Tensor]:
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, Batch):
            yield v.row_mask
        elif isinstance(v, (_Sharded, ShardedBatch)):
            yield from _tensors(v.parts)
        elif isinstance(v, _Replicated):
            yield from _tensors(list(v.by_dev.values()))
        elif isinstance(v, (tuple, list)):
            yield from _tensors(v)


@contextlib.contextmanager
def _sync_record(what: str, kind: str = "sync"):
    """A ``device-sync`` trace span that also records the host-blocking
    interval as a flight round (the control_sync / staging / drain
    buckets). A program dispatched inside one of these intervals is
    built with ``flight_kind=None`` so its wall is not counted twice."""
    fl = _flight.current_flight()
    t0 = time.perf_counter() if fl is not None else 0.0
    try:
        with TRACER.span("device-sync", what=what):
            yield
    finally:
        if fl is not None:
            fl.record(kind, wall=time.perf_counter() - t0)


def _drain_inputs(*values) -> None:
    """Wait out the device work feeding a control-scalar fetch, recorded
    as a ``drain`` flight round (device_compute bucket), so the sync
    bracket after it times only the control round trip itself. It waits
    for the devices that hold ``values`` (the counterpart of
    ``jax.block_until_ready``); on the CPU there is nothing to wait for."""
    fl = _flight.current_flight()
    t0 = time.perf_counter() if fl is not None else 0.0
    try:
        with TRACER.span("device-sync", what="input-drain"):
            for d in {t.device for t in _tensors(
                    [v for v in values if v is not None])
                    if t.device.type == "cuda"}:
                torch.cuda.synchronize(d)
    finally:
        if fl is not None:
            fl.record("drain", wall=time.perf_counter() - t0)


def mesh_mode(session) -> str:
    """Resolved ``mesh_execution`` mode: the session property when set,
    else the ``PRESTO_TPU_TORCH_MESH_EXECUTION`` environment default,
    else ``auto`` (mesh whenever more than one slot is visible and the
    plan cuts into mesh stages)."""
    v = session.properties.get("mesh_execution")
    if v is None:
        v = os.environ.get("PRESTO_TPU_TORCH_MESH_EXECUTION", "auto")
    return str(v).lower()


def mesh_flight_on(session) -> bool:
    """Resolved ``mesh_flight`` switch: the session property when set,
    else the ``PRESTO_TPU_TORCH_MESH_FLIGHT`` environment default, else
    on."""
    v = session.properties.get("mesh_flight")
    if v is None:
        return os.environ.get(
            "PRESTO_TPU_TORCH_MESH_FLIGHT", "on").lower() \
            not in ("off", "0", "false")
    return bool(v)


def fused_exchange_mode(session) -> str | bool:
    """``mesh_fused_exchange`` as ``"auto"``, True or False (unset is
    auto; values arrive as booleans or as SET SESSION / header
    strings)."""
    v = session.properties.get("mesh_fused_exchange", "auto")
    if isinstance(v, str) and v.strip().lower() == "auto":
        return "auto"
    return bool_property(session, "mesh_fused_exchange", True)


def mesh_device_count(session, device=None) -> int:
    """Effective mesh width: every visible slot of ``device``'s type,
    clamped by the ``mesh_devices`` session property when positive."""
    have = len(visible_slots(device))
    want = int(session.properties.get("mesh_devices", 0) or 0)
    return min(want, have) if want > 0 else have


def _walk_scans(node) -> Iterator[TableScanNode]:
    if isinstance(node, TableScanNode):
        yield node
    for c in node.children:
        yield from _walk_scans(c)


#: memoized router verdicts per LogicalPlan identity: the fragmenter walk
#: runs once per plan object, not once per execution. Entries carry a
#: weakref to the plan and only serve while it still points at the same
#: live object, so id reuse after GC never resurrects a dead plan's
#: verdict. Leaf lock, never held across a dispatch.
_PLAN_VERDICTS: Dict[int, Tuple[object, Tuple[bool, bool, str]]] = {}
_PLAN_VERDICTS_LOCK = checked_lock("distributed.plan_verdicts")


def _plan_mesh_verdict(plan: LogicalPlan) -> Tuple[bool, bool, str]:
    """(fragments-into-mesh-stages, reads-real-data, reason)."""
    key = id(plan)
    with _PLAN_VERDICTS_LOCK:
        hit = _PLAN_VERDICTS.get(key)
        if hit is not None and hit[0]() is plan:
            return hit[1]
    from ..planner.fragmenter import plan_mesh_stages
    roots = [plan.root] + list(plan.init_plans)
    supported, reason = True, ""
    for r in roots:
        mp = plan_mesh_stages(r)
        if not mp.supported:
            supported, reason = False, mp.reason
            break
    scans = [s for r in roots for s in _walk_scans(r)]
    scannable = bool(scans) and all(s.catalog != "system" for s in scans)
    verdict = (supported, scannable, reason)
    with _PLAN_VERDICTS_LOCK:
        if len(_PLAN_VERDICTS) > 512:
            # dead plans first, then the oldest live ones; never clear()
            for k in [k for k, (ref, _) in _PLAN_VERDICTS.items()
                      if ref() is None]:
                _PLAN_VERDICTS.pop(k, None)
            while len(_PLAN_VERDICTS) > 512:
                _PLAN_VERDICTS.pop(next(iter(_PLAN_VERDICTS)), None)
        _PLAN_VERDICTS[key] = (weakref.ref(plan), verdict)
    return verdict


def select_mesh(session: Session, plan: LogicalPlan,
                device=None) -> Optional[Mesh]:
    """The mesh auto-router: the Mesh this query runs on, or None for
    the single-device path. ``auto`` selects the mesh when more than one
    slot is effective, the plan (init plans included) cuts into mesh
    stages (planner/fragmenter.plan_mesh_stages) and the query reads real
    data (system-catalog queries gain nothing from SPMD); ``on`` forces
    the mesh, and an unfragmentable plan then raises; ``off`` never
    meshes."""
    mode = mesh_mode(session)
    if mode == "off":
        return None
    n = mesh_device_count(session, device)
    if n < 2 and mode != "on":
        return None
    supported, scannable, reason = _plan_mesh_verdict(plan)
    if not supported:
        if mode == "on":
            raise NotImplementedError(
                f"mesh_execution=on: plan has no mesh form ({reason})")
        return None
    if mode != "on" and not scannable:
        return None
    # built per query, not cached: the slots follow
    # PRESTO_TPU_TORCH_MESH_SLOTS as it stands at this routing decision
    mesh = make_mesh(max(n, 1), device=device)
    _MESH_SELECTED.inc()
    return mesh


#: bucket subdivisions per shard in the adaptive exchange: B = n*4
#: buckets give the greedy re-balancer ~25%-of-a-shard granularity
_RESPLIT_FACTOR = 4

def _skew_ratio() -> float:
    """The engine's one definition of "skewed": the coordinator
    StageMonitor's verdict ratio (``exec/cluster.py``) also decides when
    the mesh exchange re-splits hot buckets."""
    from .cluster import StageMonitor
    return float(StageMonitor.skew_ratio)


def _per_dest_quota(counts: np.ndarray, assign: Sequence[int],
                    n: int) -> int:
    """Max live rows any (src shard, dst shard) pair ships under
    ``assign``: the static quota the compacted exchange needs."""
    a = np.asarray(assign)
    worst = 1
    for d in range(n):
        sel = counts[:, a == d]
        if sel.size:
            worst = max(worst, int(sel.sum(axis=1).max()))
    return worst


class _PartitionMap:
    """Bucket -> shard assignment shared by every exchange of one
    operator. Both sides of a partitioned join ship through ONE map, so
    equal keys colocate under ANY assignment (keys hash to buckets,
    buckets move atomically). The map observes per-bucket live counts as
    batches flow and re-splits hot buckets between batches: when one
    shard's load crosses the skew ratio over the balanced load and a
    greedy LPT re-balance of bucket totals lowers the max, the
    assignment flips, ``epoch`` bumps, and the owning operator re-ships
    its prepared side under the new map."""

    #: re-balancing converges or it stops: never thrash the build side
    MAX_CHANGES = 2

    def __init__(self, n: int, adaptive: bool = True,
                 ratio: Optional[float] = None):
        self.n = n
        self.buckets = n * _RESPLIT_FACTOR
        self.assign: Tuple[int, ...] = tuple(
            b % n for b in range(self.buckets))
        self.epoch = 0
        self.adaptive = bool(adaptive) and n > 1
        self.ratio = float(ratio) if ratio is not None else _skew_ratio()
        self.changes = 0
        self._totals = np.zeros(self.buckets, dtype=np.int64)

    def observe(self, counts: np.ndarray) -> None:
        """Fold one batch's [n_src, buckets] live counts in; maybe
        re-assign."""
        if not self.adaptive:
            return
        t0 = time.perf_counter()
        self._totals += counts.sum(axis=0, dtype=np.int64)
        if self.changes >= self.MAX_CHANGES:
            return
        loads = np.zeros(self.n, dtype=np.int64)
        np.add.at(loads, np.asarray(self.assign), self._totals)
        # skew verdict against the BALANCED load (total/n), not the
        # median: with most shards idle the median collapses to zero
        fair = float(self._totals.sum()) / self.n
        if fair < 1.0 or float(loads.max()) <= self.ratio * fair:
            return
        new = self._greedy()
        new_loads = np.zeros(self.n, dtype=np.int64)
        np.add.at(new_loads, np.asarray(new), self._totals)
        if new == self.assign or new_loads.max() >= loads.max():
            return            # a single hot KEY cannot be split further
        self.assign = new
        self.epoch += 1
        self.changes += 1
        _MESH_RESPLITS.inc()
        fl = _flight.current_flight()
        if fl is not None:
            fl.record("resplit", wall=time.perf_counter() - t0,
                      rows=int(self._totals.sum()),
                      loads=[int(x) for x in new_loads])

    def _greedy(self) -> Tuple[int, ...]:
        """LPT: heaviest bucket first onto the least-loaded shard."""
        order = np.argsort(-self._totals, kind="stable")
        loads = [0] * self.n
        out = [0] * self.buckets
        for b in order:
            d = min(range(self.n), key=lambda i: (loads[i], i))
            out[int(b)] = d
            loads[d] += int(self._totals[int(b)])
        return tuple(out)


#: deferred skew checks in the fused exchange: device-side bucket counts
#: are fetched and folded into the _PartitionMap once per this many
#: rounds (minus the newest, in flight)
_FUSED_OBSERVE_EVERY = 4

#: per-shard slot ceiling for the fused aggregation carry: a grouping
#: rides the multi-round wave only when its dense key domain proves the
#: state fits this many slots on every round
_FUSED_STATE_SLOTS = 1 << 15
#: gathered-state ceiling (global rows) under which the fused finisher
#: replaces the hash exchange + final pair with ONE gathered final
_FUSED_GATHER_SLOTS = 1 << 17


class _Repartitioner:
    """Quota-compacted bucket-hash exchange driver, two control planes:

    - **fused** (``mesh_fused_exchange`` true, or auto when every slot
      has its device to itself): bucket count + ship
      run as ONE collective per round (``exchange.repartition_fused``)
      under a capacity-safe static quota, so a round is a single dispatch
      with no quota readback. Per-bucket counts stay on the device; the
      host folds them into the shared _PartitionMap only at deferred
      observe points (builds force one; probe loops check every
      _FUSED_OBSERVE_EVERY rounds, lagging one round).
    - **classic**: one cheap program reads per-(src, bucket) live counts,
      the host sizes the static quota and may re-balance hot buckets,
      and the exchange ships exactly quota lanes per peer."""

    def __init__(self, ex: "DistributedExecutor",
                 key_cols: Sequence[int], pmap: _PartitionMap,
                 fused: Optional[bool] = None):
        self.ex = ex
        self.keys = tuple(key_cols)
        self.map = pmap
        self.fused = (ex.fused_ship if fused is None else bool(fused))
        self._counts_fn = None
        self._last_counts: Optional[np.ndarray] = None
        #: device-resident [n*buckets] count vectors awaiting observe
        self._pending: List[torch.Tensor] = []
        self._rounds_since_observe = 0

    @property
    def epoch(self) -> int:
        return self.map.epoch

    def _counts(self, batch: "ShardedBatch") -> np.ndarray:
        if self._counts_fn is None:
            keys, nb = self.keys, self.map.buckets
            self._counts_fn = self.ex._smap(
                lambda b: X.partition_counts(b, keys, nb), 1,
                flight_kind=None, stage="exchange")
        _drain_inputs(batch)
        with _sync_record("exchange-quota"):
            raw = self.ex._control(self._counts_fn(batch)).cpu().numpy()
        return raw.reshape(self.ex.n, self.map.buckets)

    # -- fused control plane --------------------------------------------------
    def fused_quota(self, batch: "ShardedBatch") -> int:
        """Capacity-safe static quota: any per-(src, dst) live count is
        bounded by the source shard's lane count."""
        return bucket_capacity(max(self.ex._shard_cap(batch), 1))

    def note_counts(self, counts: torch.Tensor) -> None:
        """Queue one fused round's device-side bucket counts for a
        deferred skew check."""
        REGISTRY.counter("exchange_repartitions_total").inc()
        if not self.map.adaptive:
            return
        self._pending.append(counts)
        self._rounds_since_observe += 1
        if self._rounds_since_observe >= _FUSED_OBSERVE_EVERY:
            # leave the newest round's counts pending so the fetch only
            # touches rounds that already retired
            self.observe_pending(keep_newest=len(self._pending) > 1)

    def observe_pending(self, keep_newest: bool = False) -> None:
        """Fetch queued device counts ONCE and fold them into the shared
        _PartitionMap: the per-stage control-scalar sync of the fused
        plane."""
        take = self._pending[:-1] if keep_newest else self._pending
        if not take:
            return
        self._pending = self._pending[-1:] if keep_newest else []
        self._rounds_since_observe = len(self._pending)
        total = np.zeros((self.ex.n, self.map.buckets), dtype=np.int64)
        _drain_inputs(*take)
        with _sync_record("exchange-skew-check"):
            for c in take:
                total += c.cpu().numpy().reshape(self.ex.n,
                                                 self.map.buckets)
        self._last_counts = total
        self.map.observe(total)

    def _fused_ship(self, batch: ShardedBatch,
                    record_counts: bool = True) -> ShardedBatch:
        fl = _flight.current_flight()
        t0 = time.perf_counter()
        FAILPOINTS.hit("mesh.repartition")
        assign = self.map.assign
        quota = self.fused_quota(batch)
        keys, n = self.keys, self.ex.n
        fn = self.ex._smap(
            lambda bs: X.repartition_fused(bs, keys, n, assign, quota), 1,
            n_out=2, flight_kind=None, stage="exchange", collective=True)
        out, counts = fn(batch)
        if record_counts:
            self.note_counts(self.ex._control(counts))
        else:
            # replay rounds still ship; they just don't fold counts twice
            REGISTRY.counter("exchange_repartitions_total").inc()
        if fl is not None:
            # live row loads stay on the device (that is the point); the
            # bytes are the lanes the all-to-all moves, live or dead
            fl.record("repartition", wall=time.perf_counter() - t0,
                      nbytes=self.ex._wire_bytes(batch, quota))
        return out

    def _ship(self, batch: ShardedBatch,
              counts: np.ndarray) -> ShardedBatch:
        fl = _flight.current_flight()
        t0 = time.perf_counter()
        FAILPOINTS.hit("mesh.repartition")
        assign = self.map.assign
        quota = bucket_capacity(_per_dest_quota(counts, assign, self.ex.n))
        keys, n = self.keys, self.ex.n
        fn = self.ex._smap(
            lambda bs: X.repartition_by_buckets_compact(
                bs, keys, n, assign, quota), 1,
            flight_kind=None, stage="exchange", collective=True)
        REGISTRY.counter("exchange_repartitions_total").inc()
        out = fn(batch)
        if fl is not None:
            # per-dest row loads under the CURRENT assignment: the
            # round's straggler signal for the critical path
            loads = np.zeros(self.ex.n, dtype=np.int64)
            np.add.at(loads, np.asarray(assign),
                      counts.sum(axis=0, dtype=np.int64))
            rows = int(loads.sum())
            fl.record("repartition", wall=time.perf_counter() - t0,
                      rows=rows,
                      nbytes=rows * _batch_row_bytes(batch.parts[0]),
                      loads=[int(x) for x in loads])
        return out

    def __call__(self, batch: "ShardedBatch") -> "ShardedBatch":
        if self.fused:
            return self._fused_ship(batch)
        counts = self._counts(batch)
        self._last_counts = counts
        self.map.observe(counts)
        return self._ship(batch, counts)

    def replay(self, batch: "ShardedBatch") -> "ShardedBatch":
        """Re-ship a batch this exchange already observed (the join's
        build side after a probe-driven re-split) under the CURRENT
        assignment, without folding its counts in twice."""
        if self.fused:
            return self._fused_ship(batch, record_counts=False)
        counts = (self._last_counts if self._last_counts is not None
                  else self._counts(batch))
        return self._ship(batch, counts)


class _Sharded:
    """Per-slot values of a sharded output that is not a batch (a
    prepared build, per-slot tensors such as a FULL join's matched-build
    masks or a round's bucket counts): they stay on their slots and feed
    the next program's shards as they are."""

    __slots__ = ("parts",)

    def __init__(self, parts: List[object]):
        self.parts = parts


class _Replicated:
    """A value every slot holds whole, one copy per device (``by_dev``):
    a broadcast build and what is prepared from it, or a control value.
    A program that takes it replicated finds its copy on each device."""

    __slots__ = ("by_dev",)

    def __init__(self, by_dev: Dict[torch.device, object]):
        self.by_dev = by_dev


class ShardedBatch:
    """A mesh batch between operators: ``parts[i]`` is slot i's shard, a
    ``Batch`` on slot i's device. The parts have one capacity and share
    one dictionary object per string column, so they read as the equal
    row ranges of one batch in slot order, as the JAX package's
    row-sharded arrays do (``shard_parts`` makes one).

    ``capacity`` and ``host_count`` count across the parts (the stats'
    lanes and rows); ``to_pylist`` gathers the live rows once onto slot
    0's device, in slot order, and decodes them there: the root's copy."""

    __slots__ = ("schema", "parts")

    def __init__(self, parts: Sequence[Batch]):
        self.parts = list(parts)
        self.schema = self.parts[0].schema

    @property
    def shard_capacity(self) -> int:
        return self.parts[0].capacity

    @property
    def capacity(self) -> int:
        return self.shard_capacity * len(self.parts)

    def counts(self) -> List[int]:
        """Live rows of each part, in one readback."""
        dev = self.parts[0].device
        got = controller_copy([p.count() for p in self.parts], dev,
                              "control")
        with TRACER.span("device-sync", what="shard-counts"):
            return [int(c) for c in torch.stack(got).cpu()]

    def host_count(self) -> int:
        return sum(self.counts())

    def gather(self) -> Batch:
        """The live rows of every part in slot order, as one batch on
        slot 0's device (the controller) of ``bucket_capacity`` of their
        count: each part is compacted to its live rows on its own device
        (one readback of the counts), and only those rows are stacked."""
        counts = self.counts()
        live = [p.compact(c, check=False) if c < p.capacity else p
                for p, c in zip(self.parts, counts) if c]
        if not live:
            return _dead_batch(self.parts[0], bucket_capacity(1))
        dev = self.parts[0].device
        out = _cat_shards(controller_copy(live, dev, "stacked"))
        return out.pad(bucket_capacity(sum(counts)))

    def to_pylist(self) -> List[Tuple]:
        """Decode the live rows in slot order: the root's one gather."""
        return self.gather().to_pylist()

    def __repr__(self) -> str:
        return (f"ShardedBatch({self.schema!r}, {len(self.parts)} x "
                f"{self.shard_capacity})")


#: copies onto the mesh's controller device (slot 0's): every one passes
#: ``controller_copy``. Plain integers, bumped under ``_COPY_LOCK``; the
#: tests and chip_smoke.py read them. ``stacked_*`` counts slot parts
#: stacked into one batch there (the root's rows, the all-gather behind
#: a shard-0 finalize); ``control_*`` the control values the host reads
#: (live counts, bucket counts, error flags). Bytes are the values' own,
#: whether or not a slot shares the controller's device. Nothing is
#: copied out of the controller to the slots (``_split`` and ``_rep``
#: take only per-slot values), and the exchanges (exchange.py's
#: collectives) move data slot to slot: slot 0 takes its share there as
#: every slot does.
stacked_bytes = 0
stacked_calls = 0
control_bytes = 0
control_calls = 0
_COPY_LOCK = checked_lock("distributed.copy_counters")


def _value_bytes(x) -> int:
    if isinstance(x, Batch):
        return batch_device_bytes(x)
    return sum(t.numel() * t.element_size() for t in _tensors([x]))


def controller_copy(values: Sequence, dev: torch.device,
                    what: str) -> List:
    """``values`` moved to the controller device ``dev``, counted as one
    ``what`` call: ``"stacked"`` (slot parts of a batch) or ``"control"``
    (control values the host is about to read)."""
    global stacked_bytes, stacked_calls, control_bytes, control_calls
    out = [_to_device(v, dev) for v in values]
    nbytes = sum(_value_bytes(v) for v in values)
    with _COPY_LOCK:
        if what == "stacked":
            stacked_bytes += nbytes
            stacked_calls += 1
        elif what == "control":
            control_bytes += nbytes
            control_calls += 1
        else:
            raise ValueError(f"unknown controller copy {what!r}")
    return out


def copy_counters() -> Dict[str, int]:
    """The controller-copy counters as one dict (take deltas)."""
    return {"stacked_bytes": stacked_bytes, "stacked_calls": stacked_calls,
            "control_bytes": control_bytes, "control_calls": control_calls}


def _to_device(x, dev: torch.device):
    """``x`` (a batch, tensor or tuple of them) with every tensor on
    ``dev``."""
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    if isinstance(x, Batch):
        if x.device == dev:
            return x
        return Batch(x.schema, [Column(c.type, _to_device(c.data, dev),
                                       c.validity.to(dev), c.dictionary)
                                for c in x.columns], x.row_mask.to(dev))
    if isinstance(x, tuple):
        return tuple(_to_device(a, dev) for a in x)
    if isinstance(x, list):
        return [_to_device(a, dev) for a in x]
    return x


def _dead_batch(proto: Batch, cap: int, dev=None) -> Batch:
    """A batch of ``cap`` dead lanes shaped like ``proto``, made on
    ``dev`` (``proto``'s device by default)."""
    dev = proto.device if dev is None else dev
    cols = [Column(c.type, map_parts(c.data, lambda a: torch.zeros(
        (cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)),
        torch.zeros(cap, dtype=torch.bool, device=dev), c.dictionary)
        for c in proto.columns]
    return Batch(proto.schema, cols,
                 torch.zeros(cap, dtype=torch.bool, device=dev))


def _or_parts(acc: Optional[_Sharded], m: _Sharded) -> _Sharded:
    """Per-slot masks OR-ed slot by slot (``acc`` None starts them)."""
    if acc is None:
        return m
    return _Sharded([a | b for a, b in zip(acc.parts, m.parts)])


def _cat_shards(parts: List[Batch]) -> Batch:
    """Row-concatenate shards with one vocabulary on one device."""
    cols = []
    for ci, c0 in enumerate(parts[0].columns):
        cs = [p.columns[ci] for p in parts]
        if isinstance(c0.data, tuple):
            data = tuple(torch.cat([c.data[k] for c in cs])
                         for k in range(len(c0.data)))
        else:
            data = torch.cat([c.data for c in cs])
        cols.append(Column(c0.type, data,
                           torch.cat([c.validity for c in cs]),
                           c0.dictionary))
    return Batch(parts[0].schema, cols,
                 torch.cat([p.row_mask for p in parts]))


def shard_parts(parts: Sequence[Batch]) -> ShardedBatch:
    """Slot outputs as one sharded batch, each part staying on its
    device: string columns whose vocabularies differ are re-coded into
    the merged one on each slot, and every part is padded on its own
    device to the largest capacity."""
    parts = X.unify_slot_vocabs(parts)
    cap = max(p.capacity for p in parts)
    return ShardedBatch([p.pad(cap) for p in parts])


class DistributedExecutor(_Executor):
    """Executes a logical plan with data sharded over a mesh of slots.

    Inherits the streaming structure of the local executor; every node
    yields ``ShardedBatch`` values. Overrides the scan placement, the
    elementwise stages (filter, project, limit, group id: once per slot)
    and the exchange-bearing nodes (aggregation, join, semi join, sort /
    top-n / window / distinct / mark-distinct finalization, unnest) with
    per-slot programs and collectives."""

    #: the local compactor is never used: each node runs per slot (after
    #: a hash exchange each row sits on its owning shard); shard-local
    #: compaction happens in the exchange path
    compact_streams = False

    def __init__(self, session: Session, rows_per_batch: int, mesh: Mesh,
                 stats=None):
        super().__init__(session, rows_per_batch, mesh.devices[0],
                         stats=stats)
        self.mesh = mesh
        self.axis = mesh.axis
        self.n = mesh.size
        self.slots = tuple(mesh.devices)
        mode = fused_exchange_mode(session)
        #: fused SPMD exchange (on unless mesh_fused_exchange=false):
        #: stats-bounded aggregation stages run several rounds per
        #: dispatch and control scalars are fetched once per stage;
        #: false is the per-round host control plane
        self.fused_exchange = mode is not False
        #: slots that share a device: on one card every slot's receive
        #: buffers land in the same memory
        self.shared_devices = len(set(self.slots)) < self.n
        #: the fused hash exchange ships under a capacity-safe quota:
        #: every shard's full lane count to every peer, n x C lanes a
        #: slot, which a device of its own holds. Slots sharing a device
        #: would hold n^2 x C lanes there (and every later operator works
        #: over them), so under auto their exchanges take the counted
        #: plane: one counts readback, then exactly the quota the counts
        #: need
        self.fused_ship = (not self.shared_devices if mode == "auto"
                           else mode)
        #: cap on chunks one fused wave may stack
        try:
            self.fused_loop_rounds = max(int(
                session.properties.get("mesh_fused_loop_rounds", 32)), 1)
        except (TypeError, ValueError):
            self.fused_loop_rounds = 32

    def check_errors(self) -> None:
        # slot bodies on other devices append their flags there
        self.error_flags = controller_copy(self.error_flags, self.device,
                                           "control")
        super().check_errors()

    # -- slot helpers ---------------------------------------------------------
    def _shard_cap(self, b) -> int:
        if isinstance(b, ShardedBatch):
            return b.shard_capacity
        return -(-b.capacity // self.n)

    def _devices(self) -> List[Tuple[int, torch.device]]:
        """Each distinct slot device with its first slot, in slot order."""
        seen: Dict[torch.device, int] = {}
        for i, d in enumerate(self.slots):
            seen.setdefault(d, i)
        return [(i, d) for d, i in seen.items()]

    def _split(self, x) -> List[object]:
        """Slot shards of a sharded value: its parts, as they lie."""
        if not isinstance(x, (_Sharded, ShardedBatch)):
            raise TypeError(f"a {type(x).__name__} is not sharded over "
                            f"the slots")
        assert len(x.parts) == self.n, "parts must match the slots"
        return list(x.parts)

    def _rep(self, x) -> List[object]:
        """A replicated value on every slot: its copy on each slot's
        device."""
        if not isinstance(x, _Replicated):
            raise TypeError(f"a {type(x).__name__} is not replicated over "
                            f"the slots")
        return [x.by_dev[d] for d in self.slots]

    def _keep(self, parts: List[object], replicated: bool):
        """Slot outputs as the value the next program takes: a replicated
        output one copy per device, batches a ``ShardedBatch``, anything
        else per slot."""
        if replicated:
            return _Replicated({d: parts[i] for i, d in self._devices()})
        if isinstance(parts[0], Batch):
            return shard_parts(parts)
        return _Sharded(list(parts))

    def _control(self, x: "_Sharded | _Replicated") -> torch.Tensor:
        """A control value the host is about to read, on the controller
        device: per-slot tensors in slot order (0-d ones stacked, others
        concatenated), or a replicated value's copy there."""
        if isinstance(x, _Replicated):
            # slot 0 holds the controller device's copy
            return x.by_dev[self.device]
        parts = controller_copy(x.parts, self.device, "control")
        return (torch.stack(parts) if parts[0].ndim == 0
                else torch.cat(parts))

    def _slot_flags(self, fn, x) -> None:
        """Append ``fn(part)``, an error flag computed on each slot's own
        part of ``x``, to the query's error channel."""
        for i, p in enumerate(self._split(x)):
            with self._in_slot(i):
                self.error_flags.append(fn(p))

    def _from_host(self, b: Batch) -> ShardedBatch:
        """A batch built on the host (VALUES, the default grouping rows,
        an empty input) dealt to the slots once at its source: shard i
        is the i-th equal row range, moved to slot i's device."""
        per = self._shard_cap(b)
        if per * self.n != b.capacity:
            b = concat_batches([b], capacity=per * self.n)
        return ShardedBatch([_to_device(X.local_shard(b, i, self.n), d)
                             for i, d in enumerate(self.slots)])

    def _empty(self, schema: Schema) -> ShardedBatch:
        """A sharded batch with no live row, made on each slot."""
        return ShardedBatch([Batch.from_arrays(
            schema, [[] for _ in range(len(schema))], num_rows=0,
            device=d) for d in self.slots])

    def _in_slot(self, i: int):
        d = self.slots[i]
        if d.type == "cuda":
            return torch.cuda.device(d)
        return contextlib.nullcontext()

    def _smap(self, fn, n_in: int, replicated_in: Sequence[int] = (),
              n_out: int = 1, replicated_out=False,
              flight_kind: Optional[str] = "dispatch",
              stage: str = "misc", rounds: int = 1,
              collective: bool = False):
        """The per-slot dispatcher (the JAX package's ``shard_map``).

        Inputs at ``replicated_in`` positions reach every slot whole
        (``P()``); the others give each slot its part (``P(axis)``).
        ``replicated_out`` (True for every output, or a sequence of output
        positions) marks outputs every slot computes identically: they
        stay one copy per device (``_Replicated``). Other outputs stay per
        slot: batches as a ``ShardedBatch``, anything else as a
        ``_Sharded``. A ``collective`` body takes one list of slot values
        per input and returns one list per output (it calls
        ``parallel/exchange.py``); otherwise the body runs once per slot
        on that slot's parts, or once per device when every input and
        output is replicated. Each call is one dispatch
        (``_FlightDispatch``). Nothing is copied onto the controller."""
        rep_in = set(replicated_in)
        if isinstance(replicated_out, bool):
            rep_out = set(range(n_out)) if replicated_out else set()
        else:
            rep_out = set(replicated_out)
        all_rep = (len(rep_in) == n_in and len(rep_out) == n_out
                   and not collective)
        n = self.n

        def entry(*args):
            slot_args = [self._rep(a) if i in rep_in else self._split(a)
                         for i, a in enumerate(args)]
            if all_rep:
                by_dev = {}
                for s, d in self._devices():
                    with self._in_slot(s):
                        out = fn(*[sa[s] for sa in slot_args])
                    by_dev[d] = [out] if n_out == 1 else list(out)
                res = [_Replicated({d: o[k] for d, o in by_dev.items()})
                       for k in range(n_out)]
                return res[0] if n_out == 1 else tuple(res)
            if collective:
                out = fn(*slot_args)
                per_out = [out] if n_out == 1 else list(out)
            else:
                per_slot = []
                for s in range(n):
                    with self._in_slot(s):
                        o = fn(*[sa[s] for sa in slot_args])
                    per_slot.append([o] if n_out == 1 else list(o))
                per_out = [[per_slot[s][k] for s in range(n)]
                           for k in range(n_out)]
            res = [self._keep(per_out[k], k in rep_out)
                   for k in range(n_out)]
            return res[0] if n_out == 1 else tuple(res)

        return _FlightDispatch(entry, flight_kind, stage=stage,
                               rounds=rounds)

    def _first_shard(self, b: Batch) -> ShardedBatch:
        """``b`` (on slot 0's device) as shard 0 of the mesh, every other
        shard dead and made on its own slot: the layout of a replicated
        finalize whose output the JAX package keeps on shard 0 only
        (``_keep_first_shard``)."""
        return ShardedBatch([b] + [_dead_batch(b, b.capacity, d)
                                   for d in self.slots[1:]])

    def _gathered_call(self, fn, batch: ShardedBatch,
                       stage: str) -> ShardedBatch:
        """Every slot's ``fn`` over the all-gathered batch, kept on shard
        0. The gather stacks the parts' live rows in slot order onto slot
        0's device (the controller; dead lanes stay behind, at the cost of
        one count readback), and every slot would compute the same value,
        so ``fn`` runs once there."""
        def gathered(b: ShardedBatch) -> ShardedBatch:
            _drain_inputs(b)
            with _sync_record("gather-live"):
                whole = b.gather()
            with self._in_slot(0):
                return self._first_shard(fn(whole))
        return _FlightDispatch(gathered, "dispatch", stage=stage)(batch)

    def _wire_bytes(self, batch: ShardedBatch, quota: int) -> int:
        """Bytes one quota-compacted all-to-all of ``batch`` moves: every
        slot sends ``quota`` lanes to each of the n slots."""
        return self.n * self.n * quota * _batch_row_bytes(batch.parts[0])

    def _shard_live_max(self, batch: ShardedBatch) -> int:
        """Max live rows on any shard (host sync): sizes compactions."""
        per = self._smap(
            lambda b: b.row_mask.sum(dtype=torch.int64).reshape(1), 1,
            flight_kind=None)
        _drain_inputs(batch)
        with _sync_record("shard-live-max"):
            counts = self._control(per(batch)).cpu().numpy()
        return int(counts.max()) if counts.size else 0

    def _replicate_device(self, batch: ShardedBatch) -> _Replicated:
        """A row-sharded batch replicated to every slot: the all-gather
        of the FIXED_BROADCAST exchange (device to device, no host), one
        copy per device."""
        return self._smap(lambda bs: X.broadcast_batch(bs), 1,
                          replicated_out=True, stage="exchange",
                          collective=True)(batch)

    def _repartitioner(self, key_cols: Sequence[int],
                       pmap: Optional[_PartitionMap] = None,
                       adaptive: bool = True,
                       fused: Optional[bool] = None) -> _Repartitioner:
        """An adaptive quota-compacted hash exchange. Pass one shared
        ``pmap`` for every exchange whose outputs must colocate (both
        sides of a partitioned join)."""
        if pmap is None:
            pmap = _PartitionMap(self.n, adaptive=adaptive)
        return _Repartitioner(self, key_cols, pmap, fused=fused)

    # -- scan: split placement ------------------------------------------------
    def _TableScanNode(self, node: TableScanNode
                       ) -> Iterator[ShardedBatch]:
        """Round-robin split streams across shards THROUGH the device scan
        cache + prefetch pipeline (exec/scancache.py): shard i's stream
        is a ``scan_splits`` pipeline on slot i's device, so hot splits
        replay device-resident across mesh queries. Each round's shard
        chunks stay on their slots as one sharded batch."""
        from . import scancache

        conn = self.session.catalogs.get(node.catalog)
        opts = scancache.options_from_session(self.session)
        splits = conn.split_manager.splits(node.table, self.n)
        pushdown = node.pushdown or None
        t_query0 = time.perf_counter()

        def record_for(shard: int):
            def record_split(i: int, t0: float, batches: int) -> None:
                if self.stats is not None:
                    self.stats.record_split(
                        node.table.table, shard, t0 - t_query0,
                        time.perf_counter() - t0, batches)
            return record_split

        streams: List[Iterator[Batch]] = [
            scancache.scan_splits(
                conn, node.catalog, list(node.columns), [s],
                lambda: pushdown, self.rows_per_batch, opts,
                self.slots[i % self.n], record_split=record_for(i),
                check_cancel=self._check_cancel, stats=self.stats,
                static_pushdown=pushdown)
            for i, s in enumerate(splits)
        ]
        # more splits than shards: shard i takes splits i, i+n, ...
        per_shard: List[Iterator[Batch]] = [
            itertools.chain.from_iterable(streams[i::self.n])
            for i in range(self.n)]
        done = [False] * self.n
        schema = _plan_schema(node)
        try:
            while not all(done):
                fl = _flight.current_flight()
                t0 = time.perf_counter()
                s0 = fl.kind_wall("stall") if fl is not None else 0.0
                parts: List[Optional[Batch]] = []
                for i, st in enumerate(per_shard):
                    if done[i]:
                        parts.append(None)
                        continue
                    b = next(st, None)
                    if b is None:
                        done[i] = True
                    parts.append(b)
                if all(p is None for p in parts):
                    break
                if fl is not None:
                    # host scan work feeding the mesh: the pull wall minus
                    # the prefetch stalls recorded inside the pulls
                    dt = (time.perf_counter() - t0
                          - (fl.kind_wall("stall") - s0))
                    fl.record("staging", wall=max(dt, 0.0))
                yield self._assemble(parts, schema)
        finally:
            for st in streams:
                close = getattr(st, "close", None)
                if close is not None:
                    close()

    def _assemble(self, parts: List[Optional[Batch]],
                  schema: Schema) -> ShardedBatch:
        """One round's shard chunks as a sharded batch, each on its own
        slot: a chunk is padded to the round's capacity on its device and
        an exhausted shard gets a dead batch made there. Shards whose
        string columns carry different dictionaries are re-coded into the
        merged vocabulary, each on its own slot (the JAX package rounds
        through the host here), recorded as a ``staging`` flight round
        with the round's rows, bytes and per-shard loads."""
        cap = max(p.capacity for p in parts if p is not None)
        proto = next(p for p in parts if p is not None)
        full = [p.pad(cap) if p is not None
                else _dead_batch(proto, cap, self.slots[i])
                for i, p in enumerate(parts)]
        if all(p.columns[ci].dictionary is c0.dictionary
               or p.columns[ci].dictionary == c0.dictionary
               for ci, c0 in enumerate(proto.columns) for p in full):
            return ShardedBatch(X.unify_slot_vocabs(full))
        fl = _flight.current_flight()
        t0 = time.perf_counter()
        with TRACER.span("device-sync", what="scan-stage"):
            out = ShardedBatch(X.unify_slot_vocabs(full))
            loads = out.counts() if fl is not None else None
        if fl is not None:
            fl.record("staging", wall=time.perf_counter() - t0,
                      rows=sum(loads),
                      nbytes=sum(batch_device_bytes(p) for p in out.parts),
                      loads=loads)
        return out

    def _ValuesNode(self, node: ValuesNode) -> Iterator[ShardedBatch]:
        yield self._from_host(values_batch(node, torch.device("cpu")))

    # -- elementwise stages: once per slot, on the slot's own part -----------
    def _FilterNode(self, node: FilterNode) -> Iterator[ShardedBatch]:
        fn = self._smap(self.checked_filter(self._resolve(node.predicate),
                                            _plan_schema(node.child)), 1,
                        stage="scan")
        for b in self.run(node.child):
            yield fn(b)

    def _ProjectNode(self, node: ProjectNode) -> Iterator[ShardedBatch]:
        proj = compile_projection([self._resolve(e) for e in node.exprs],
                                  [f.name for f in node.fields],
                                  _plan_schema(node.child), errors=True)

        def local(b: Batch) -> Batch:
            out, err = proj(b)
            if err is not None:
                self.error_flags.append(err)
            return out
        fn = self._smap(local, 1, stage="scan")
        for b in self.run(node.child):
            yield fn(b)

    def _LimitNode(self, node: LimitNode) -> Iterator[ShardedBatch]:
        """The first ``count`` live rows in slot order: one readback of
        the parts' live counts per batch sizes each slot's share."""
        fn = self._smap(limit_kernel, 2, stage="scan")
        remaining = node.count
        for b in self.run(node.child):
            if remaining <= 0:
                return
            shares = []
            for c in b.counts():
                shares.append(min(c, remaining))
                remaining -= shares[-1]
            yield fn(b, _Sharded(shares))

    def _GroupIdNode(self, node: GroupIdNode) -> Iterator[ShardedBatch]:
        schema = _plan_schema(node)
        fns = [self._smap(lambda b, _g=g: grouping_set_batch(
            b, node, _g, schema), 1, stage="scan")
            for g in range(len(node.grouping_sets))]
        for b in self.run(node.child):
            for fn in fns:
                yield fn(b)

    def _cross_join(self, node: JoinNode, build: Optional[ShardedBatch]
                    ) -> Iterator[ShardedBatch]:
        """Cross join against a tiny build (scalar subqueries, VALUES):
        the build broadcast to every slot, compacted there, and each
        slot's probe part copied once per build row."""
        if build is None:
            return
        rep = self._smap(lambda b: b.compact(), 1, replicated_in=(0,),
                         replicated_out=True, stage="join")(
            self._replicate_device(build))
        count = self._smap(lambda b: b.count(), 1, replicated_in=(0,),
                           replicated_out=True, flight_kind=None,
                           stage="join")
        _drain_inputs(rep)
        with _sync_record("cross-build-count"):
            nb = int(self._control(count(rep)))
        if nb == 0:
            return
        schema = _plan_schema(node)
        fn = self._smap(lambda p, b: cross_expand(p, b, nb, schema), 2,
                        replicated_in=(1,), stage="join")
        for probe in self.run(node.left):
            yield fn(probe, rep)

    # -- aggregation: partial -> hash exchange -> final -----------------------
    def _AggregationNode(self, node: AggregationNode
                         ) -> Iterator[ShardedBatch]:
        for a in node.aggs:
            if a.distinct:
                raise NotImplementedError(
                    "DISTINCT aggregates must be lowered by the planner")
        aggs = [AggSpec(a.fn, a.arg, a.output_type, a.name, mask=a.mask,
                        param=a.param)
                for a in node.aggs]
        group = list(node.group_indices)
        # checked integral sums flag overflow from inside the slot bodies
        errs = self.error_flags
        from ..ops.aggregation import percentile_drains
        # final-step nodes consume STATE columns whose layout the raw agg
        # input indices don't describe: never re-check them
        if node.step != "final" and \
                percentile_drains(aggs, _plan_schema(node.child).types,
                                  bool(group)):
            # approx_percentile: colocate each group's raw rows via hash
            # exchange, then one exact segmented-sort pass per shard
            b = self._drain(node.child)
            if b is None:
                if group:
                    return
                b = self._empty(_plan_schema(node.child))
            if group:
                b = self._repartitioner(group, fused=False)(b)
                fn = self._smap(
                    lambda x: grouped_aggregate(x, group, aggs,
                                                mode="single",
                                                errors=errs), 1,
                    stage="agg")
                yield fn(b)
            else:
                yield self._gathered_call(
                    lambda x: global_aggregate(x, aggs, mode="single",
                                               errors=errs), b, "agg")
            return
        if not group:
            yield self._global_agg(node, aggs)
            return
        key_idx = list(range(len(group)))
        allow_dense = bool_property(self.session, "dense_grouping", True)
        kb = tuple(node.key_bounds) if node.key_bounds else None
        # fragment steps: PARTIAL consumes raw rows and yields shard-local
        # state, FINAL consumes state rows, SINGLE does both
        step = node.step

        partial_fn = self._smap(
            lambda b: grouped_aggregate(b, group, aggs, mode="partial",
                                        key_bounds=kb,
                                        allow_dense=allow_dense,
                                        errors=errs), 1,
            stage="agg")
        merge_fn = None

        state: Optional[ShardedBatch] = None
        fused_state = False
        src: Iterator[ShardedBatch] = iter(self.run(node.child))
        if self.fused_exchange and allow_dense and step != "final":
            # fused control plane: drain chunks through multi-round wave
            # programs; the classic loop below takes whatever the drain
            # did not
            state, src = self._fused_agg_drain(src, group, aggs, kb)
            fused_state = state is not None
        merges = 0
        next_check = 1
        check_every = 1
        for chunk in src:
            if kb is not None and allow_dense and step != "final":
                # bounds are hard invariants on this tier: an overclaimed
                # bound fails the query through the error channel (one
                # explicit reduction per slot)
                self._slot_flags(
                    lambda b: key_bounds_violation(b, group, kb), chunk)
            partial = (chunk if step == "final" else partial_fn(chunk))
            if state is None:
                state = partial
            else:
                if merge_fn is None:
                    merge_fn = self._smap(
                        lambda a, b: grouped_aggregate(
                            concat_batches([a, b]), key_idx, aggs,
                            mode="merge", key_bounds=kb,
                            allow_dense=allow_dense, errors=errs), 2,
                        stage="agg")
                merged = merge_fn(state, partial)
                merges += 1
                # compaction sizing is an optimization: the live-max sync
                # runs on a doubling cadence
                if merges >= next_check:
                    live = self._shard_live_max(merged)
                    cap = bucket_capacity(max(live, 1))
                    if cap * self.n < merged.capacity:
                        compact_fn = self._smap(
                            lambda b, _cap=cap: b.compact(_cap,
                                                          check=False),
                            1, stage="agg")
                        merged = compact_fn(merged)
                        check_every = 1
                    else:
                        check_every = min(check_every * 2, 8)
                    next_check = merges + check_every
                state = merged
        if state is None:
            if node.default_gids and step in ("single", "final"):
                # grouping sets over empty input: the empty sets' grand
                # totals
                yield self._from_host(
                    _default_grouping_batch(node, torch.device("cpu")))
            return
        if step == "partial":
            # states stay shard-local: the FINAL node owns the exchange
            yield state
            return
        if fused_state and state.capacity <= _FUSED_GATHER_SLOTS:
            # fused finisher: the carry is small enough to gather, so the
            # final runs replicated in ONE dispatch, kept on shard 0
            out = self._gathered_call(
                lambda b: grouped_aggregate(
                    b, key_idx, aggs, mode="final", key_bounds=kb,
                    allow_dense=allow_dense, errors=errs), state, "agg")
        else:
            state = self._repartitioner(key_idx, fused=False)(state)
            final_fn = self._smap(
                lambda b: grouped_aggregate(b, key_idx, aggs, mode="final",
                                            key_bounds=kb,
                                            allow_dense=allow_dense,
                                            errors=errs), 1,
                stage="agg")
            out = final_fn(state)
        if node.default_gids and step in ("single", "final") \
                and out.host_count() == 0:
            yield self._from_host(
                _default_grouping_batch(node, torch.device("cpu")))
            return
        yield out

    @staticmethod
    def _wave_sig(b: ShardedBatch):
        """Signature a fused wave holds constant: capacity, schema and
        every column's dictionary object must match the first chunk's
        (the parts share one dictionary object per column)."""
        return (b.capacity, b.schema,
                tuple(id(c.dictionary) for c in b.parts[0].columns))

    def _fused_agg_drain(self, src: Iterator[ShardedBatch],
                         group: List[int],
                         aggs: List[AggSpec], kb):
        """Drain grouped-aggregation input through fused multi-round wave
        programs: each wave takes up to ``mesh_fused_loop_rounds`` chunks
        into ONE dispatch whose body loops partial aggregate + state merge
        at a STATIC state capacity proven from the dense key domain. The
        host dispatches once per wave instead of 3-4 times (+ a liveness
        sync) per chunk; bounds violations fold into one scalar on the
        error channel.

        Returns ``(state, leftover)``: the fused carry (None when the
        gate rejected the stream) and the chunks the classic loop must
        still process."""
        from ..ops.aggregation import (
            _wide_state_aggs, dense_group_plan, has_drain_agg,
        )
        first = next(src, None)
        if first is None:
            return None, iter(())
        if has_drain_agg(aggs) or _wide_state_aggs(aggs):
            return None, itertools.chain([first], src)
        kb_list = list(kb) if kb else None
        # host-only metadata (key dictionaries), which every part shares
        plan = dense_group_plan(first.parts[0], group, _FUSED_STATE_SLOTS,
                                kb_list)
        if plan is None:
            return None, itertools.chain([first], src)
        cap_out = bucket_capacity(plan.K + 1)
        key_idx = list(range(len(group)))
        sig0 = self._wave_sig(first)
        wave_fns: Dict[Tuple[int, bool, int], object] = {}

        def run_wave(carry: Optional[ShardedBatch],
                     chunks: List[ShardedBatch]) -> ShardedBatch:
            # the reference pads a wave to a power of two with dead copies
            # of the last chunk so its loop programs stay few; the port's
            # loop skips the dead rounds but records the same count, so a
            # program is keyed by the chunks it really loops over
            rounds = 1 << max(len(chunks) - 1, 0).bit_length()
            has_carry = carry is not None
            key = (rounds, has_carry, len(chunks))
            fn = wave_fns.get(key)
            if fn is None:
                fn = wave_fns[key] = self._smap(
                    _fused_agg_wave_fn(group, key_idx, aggs, kb, cap_out,
                                       has_carry, len(chunks),
                                       self._in_slot),
                    len(chunks) + (1 if has_carry else 0),
                    n_out=2, stage="agg", rounds=rounds, collective=True)
            out, viols = fn(*([carry] if has_carry else []), *chunks)
            # bounds violations and checked-sum overflow, one scalar a slot
            self.error_flags.extend(viols.parts)
            return out

        state: Optional[ShardedBatch] = None
        pending = [first]
        leftover: Optional[ShardedBatch] = None
        for chunk in src:
            if self._wave_sig(chunk) != sig0:
                # signature drifted: hand the rest to the classic plane,
                # which merges into the fused carry
                leftover = chunk
                break
            pending.append(chunk)
            if len(pending) >= self.fused_loop_rounds:
                state = run_wave(state, pending)
                pending = []
        if pending:
            state = run_wave(state, pending)
        if leftover is not None:
            return state, itertools.chain([leftover], src)
        return state, iter(())

    def _global_agg(self, node: AggregationNode,
                    aggs: List[AggSpec]) -> ShardedBatch:
        step = node.step
        errs = self.error_flags
        partial_fn = self._smap(
            lambda b: global_aggregate(b, aggs, mode="partial",
                                       errors=errs), 1,
            stage="agg")
        merge_fn = self._smap(
            lambda a, b: global_aggregate(
                concat_batches([a, b]), aggs, mode="merge", errors=errs),
            2, stage="agg")
        state: Optional[ShardedBatch] = None
        for chunk in self.run(node.child):
            partial = (chunk if step == "final" else partial_fn(chunk))
            state = partial if state is None else merge_fn(state, partial)
        if state is None:
            state = partial_fn(self._empty(_plan_schema(node.child)))
        if step == "partial":
            return state          # shard-local states; FINAL gathers
        # gather every shard's state and finalize replicated, on shard 0
        return self._gathered_call(
            lambda b: global_aggregate(b, aggs, mode="final", errors=errs),
            state, "agg")

    # -- joins -----------------------------------------------------------------
    def _JoinNode(self, node: JoinNode) -> Iterator[ShardedBatch]:
        build = self._drain(node.right)
        if node.join_type == "cross":
            yield from self._cross_join(node, build)
            return
        residual = (self._resolve(node.residual)
                    if node.residual is not None else None)
        out_schema = _plan_schema(node)
        # the ON residual runs inside the shard programs; its row errors
        # reach the query's error channel like the local path's
        residual_err = (compile_filter(residual, out_schema, errors=True)
                        if residual is not None else None)

        def residual_fn(b: Batch) -> Batch:
            out, err = residual_err(b)
            if err is not None:
                self.error_flags.append(err)
            return out

        residual_outer = (residual_err is not None
                          and node.join_type in ("left", "full"))
        payload = list(range(len(node.right.fields)))
        payload_names = [f"$b{i}" for i in payload]

        if build is None:
            extend = self._smap(lambda p: self._null_extend(p, node), 1,
                                stage="join")
            for probe in self.run(node.left):
                if node.join_type in ("left", "full"):
                    yield extend(probe)
            return

        lkeys, rkeys = list(node.left_keys), list(node.right_keys)
        replicated = node.distribution == "replicated"
        track_full = node.join_type == "full"
        pmap = repart_build = None
        if replicated:
            # FIXED_BROADCAST: the build replicated to every slot
            build_side = self._replicate_device(build)
        else:
            # FIXED_HASH: the build repartitioned by join key once. ONE
            # _PartitionMap covers build AND probe exchanges. FULL joins
            # pin the map: their per-shard unmatched-build masks cannot
            # survive rows moving shards
            pmap = _PartitionMap(self.n, adaptive=not track_full)
            repart_build = self._repartitioner(rkeys, pmap)
            e0 = pmap.epoch
            build_side = repart_build(build)
            # fold the build round's counts NOW, before any probe ships;
            # a verdict from its own round re-ships the build once
            repart_build.observe_pending()
            if pmap.epoch != e0:
                build_side = repart_build.replay(build)

        # prepare the build ONCE per shard (the LookupSource role):
        # planner key_bounds build the mixed-radix direct-address table,
        # cross-checked against the promised bounds through the error
        # channel before any probe runs
        from ..ops.join import (
            direct_keyed_plan, prepare_build, prepare_direct_keyed,
        )
        kb_plan = (direct_keyed_plan(tuple(node.key_bounds))
                   if node.key_bounds
                   and bool_property(self.session, "join_dense_path",
                                     True) else None)
        if kb_plan is not None:
            los, sizes, K = kb_plan
            cap = bucket_capacity(K)

            def prep_local(b: Batch):
                return prepare_direct_keyed(b, rkeys, los, sizes, cap)
            # the JAX package's GSPMD reduces the sharded violation scan
            # to one scalar; here each slot scans its part of the build
            self._slot_flags(lambda b: key_bounds_violation(
                b, tuple(rkeys), tuple(node.key_bounds)), build)
        else:
            def prep_local(b: Batch):
                return prepare_build(b, rkeys)
        prep_in = (0,) if replicated else ()
        prep_smap = self._smap(prep_local, 1, replicated_in=prep_in,
                               replicated_out=replicated, stage="join")
        prepared = prep_smap(build_side)
        _note_join_strategy(
            self.stats, node,
            ("direct" if kb_plan is not None else "sorted")
            if node.build_unique else "expand", node.distribution)
        # probe programs: build + prepared ride the same sharding
        rep_in2 = (1, 2) if replicated else ()

        # FULL OUTER probes like LEFT; the unmatched-build tail follows the
        # probe stream (per shard: a FULL join is partitioned, so each
        # build row lives on one shard)
        jt = "left" if node.join_type == "full" else node.join_type
        npro = len(node.left.fields)

        def local_probe(probe_l: Batch, build_l: Batch, prep_l,
                        maxk: int) -> Batch:
            probe_l = keys_in_build_vocab(probe_l, build_l, lkeys, rkeys)
            if node.build_unique:
                out = lookup_join(probe_l, build_l, lkeys, rkeys,
                                  payload, payload_names, jt,
                                  prepared=prep_l)
            else:
                out = expand_join(probe_l, build_l, lkeys, rkeys,
                                  payload, payload_names, jt,
                                  max_matches=maxk, prepared=prep_l)
            out = Batch(out_schema, out.columns, out.row_mask)
            return residual_fn(out) if residual_err is not None else out

        def local_probe_outer(probe_l: Batch, build_l: Batch, prep_l,
                              maxk: int):
            """LEFT/FULL with a residual, shard-local: the residual gates
            matches and probe rows never drop. Returns (batch,
            surviving-build-match mask); the mask feeds the FULL tail."""
            from ..ops.join import (
                expand_match_origins, unique_match_build_mask,
            )
            probe_l = keys_in_build_vocab(probe_l, build_l, lkeys, rkeys)
            if node.build_unique:
                out = lookup_join(probe_l, build_l, lkeys, rkeys,
                                  payload, payload_names, "left",
                                  prepared=prep_l)
                match = semi_join_mask(probe_l, build_l, lkeys, rkeys,
                                       prepared=prep_l)
                gated = residual_fn(Batch(out_schema, out.columns,
                                          probe_l.row_mask & match))
                survived = gated.row_mask
                cols = list(out.columns[:npro])
                for c in out.columns[npro:]:
                    cols.append(Column(c.type, c.data,
                                       c.validity & survived,
                                       c.dictionary))
                bmask = (unique_match_build_mask(
                    probe_l, build_l, lkeys, rkeys, survived,
                    prepared=prep_l)
                    if track_full
                    else torch.zeros(build_l.capacity, dtype=torch.bool,
                                     device=build_l.device))
                return Batch(out_schema, cols, probe_l.row_mask), bmask
            k = max(1, maxk)
            e = expand_join(probe_l, build_l, lkeys, rkeys, payload,
                            payload_names, "inner", max_matches=k,
                            prepared=prep_l)
            gated = residual_fn(Batch(out_schema, e.columns, e.row_mask))
            survived = gated.row_mask
            C = probe_l.capacity
            has = survived.reshape(k, C).any(dim=0)
            # reinstate unmatched probe rows in their slot-0 lanes with a
            # null payload (lane = slot*C + i, so slot 0 is the first C)
            reinstate = torch.zeros(k * C, dtype=torch.bool,
                                    device=probe_l.device)
            reinstate[:C] = probe_l.row_mask & ~has
            cols = []
            for i, c in enumerate(e.columns):
                if i < npro:
                    cols.append(c)
                else:
                    cols.append(Column(c.type, c.data,
                                       c.validity & survived,
                                       c.dictionary))
            nb = build_l.capacity
            bmask = torch.zeros(nb + 1, dtype=torch.bool,
                                device=build_l.device)
            if track_full:
                orig, _ = expand_match_origins(probe_l, build_l, lkeys,
                                               rkeys, k, prepared=prep_l)
                tgt = torch.where(survived, orig.to(torch.int64), nb)
                bmask[tgt] = True
            return Batch(out_schema, cols, survived | reinstate), bmask[:nb]

        count_fn = None
        maxk_static: Optional[int] = None
        if not node.build_unique:
            # ONE build-side multiplicity readback bounds every probe
            # batch's match count; the per-probe-batch count sync only
            # returns for skewed builds
            from ..ops.join import max_multiplicity
            mult_fn = self._smap(
                lambda pr: max_multiplicity(pr).reshape(1).to(torch.int64),
                1, replicated_in=(0,) if replicated else (),
                replicated_out=replicated, flight_kind=None, stage="join")
            _drain_inputs(prepared)
            with _sync_record("join-multiplicity"):
                bound = int(self._control(mult_fn(prepared)).max())
            if bound <= self.SKEW_MATCH_LIMIT:
                # a key's rows move between shards atomically, so a
                # shard's max multiplicity never exceeds the global max
                maxk_static = bucket_capacity(max(bound, 1), minimum=1)
            else:
                def local_count(p: Batch, b: Batch, pr) -> torch.Tensor:
                    p = keys_in_build_vocab(p, b, lkeys, rkeys)
                    return match_count_max(p, b, lkeys, rkeys,
                                           prepared=pr).reshape(1)
                count_fn = self._smap(local_count, 3,
                                      replicated_in=rep_in2,
                                      flight_kind=None, stage="join")

        repart_probe = (None if replicated
                        else self._repartitioner(lkeys, pmap))
        join_fns: Dict[int, object] = {}

        def local_match(p, b, pr):
            p = keys_in_build_vocab(p, b, lkeys, rkeys)
            return build_match_mask(p, b, lkeys, rkeys, prepared=pr)
        match_fn = (self._smap(local_match, 3, replicated_in=rep_in2,
                               stage="join")
                    if track_full else None)
        build_matched = None
        built_epoch = pmap.epoch if pmap is not None else 0
        # fused probe plane: with a static match bound and no outer or
        # residual bookkeeping, the key exchange FUSES into the probe
        # program: collective and probe are one dispatch, the round's
        # bucket counts a device-resident second output
        fuse_probe = (repart_probe is not None and repart_probe.fused
                      and count_fn is None and not residual_outer
                      and not track_full)
        for probe in self.run(node.left):
            if fuse_probe:
                if pmap.epoch != built_epoch:
                    # a deferred skew verdict landed: re-ship the retained
                    # build under the new assignment before the next round
                    build_side = repart_build.replay(build)
                    prepared = prep_smap(build_side)
                    built_epoch = pmap.epoch
                fl = _flight.current_flight()
                t0 = time.perf_counter()
                FAILPOINTS.hit("mesh.repartition")
                maxk = maxk_static if maxk_static is not None else 1
                assign, quota = pmap.assign, repart_probe.fused_quota(probe)
                n = self.n

                def fused_probe(ps, bs, prs, _a=assign, _q=quota, _k=maxk):
                    shipped, counts = X.repartition_fused(
                        ps, lkeys, n, _a, _q)
                    outs = []
                    for s in range(n):
                        with self._in_slot(s):
                            outs.append(local_probe(shipped[s], bs[s],
                                                    prs[s], _k))
                    return outs, counts
                fn = self._smap(fused_probe, 3, replicated_in=rep_in2,
                                n_out=2, flight_kind=None, stage="join",
                                collective=True)
                out, counts = fn(probe, build_side, prepared)
                repart_probe.note_counts(self._control(counts))
                if fl is not None:
                    # exchange + probe are ONE program: the round record
                    # is a repartition record covering the whole dispatch
                    fl.record("repartition", wall=time.perf_counter() - t0,
                              nbytes=self._wire_bytes(probe, quota))
                yield out
                continue
            if repart_probe is not None:
                probe = repart_probe(probe)
                if pmap.epoch != built_epoch:
                    # adaptive re-split: the prepared build is stale, so
                    # re-ship the retained build and re-prepare
                    build_side = repart_build.replay(build)
                    prepared = prep_smap(build_side)
                    built_epoch = pmap.epoch
            maxk = 1
            if maxk_static is not None:
                maxk = maxk_static
            elif count_fn is not None:
                _drain_inputs(probe, build_side, prepared)
                with _sync_record("join-match-count"):
                    maxk = bucket_capacity(
                        max(int(self._control(count_fn(
                            probe, build_side, prepared)).max()), 1),
                        minimum=1)
            fn = join_fns.get(maxk)
            if fn is None:
                if residual_outer:
                    fn = join_fns[maxk] = self._smap(
                        lambda p, b, pr, _k=maxk: local_probe_outer(
                            p, b, pr, _k),
                        3, replicated_in=rep_in2, n_out=2, stage="join")
                else:
                    fn = join_fns[maxk] = self._smap(
                        lambda p, b, pr, _k=maxk: local_probe(
                            p, b, pr, _k), 3,
                        replicated_in=rep_in2, stage="join")
            if residual_outer:
                out, m = fn(probe, build_side, prepared)
                if track_full:
                    build_matched = _or_parts(build_matched, m)
                yield out
                continue
            if track_full:
                build_matched = _or_parts(
                    build_matched, match_fn(probe, build_side, prepared))
            yield fn(probe, build_side, prepared)
        if repart_probe is not None:
            # any still-pending fused round counts fold in exactly once
            repart_probe.observe_pending()
        if track_full:
            left_fields = node.left.fields

            def local_tail(b_l: Batch, matched_l) -> Batch:
                from .local import _null_columns
                mask = b_l.row_mask & ~matched_l
                cols = _null_columns(left_fields, b_l.capacity, b_l.device)
                cols.extend(b_l.columns)
                return Batch(out_schema, cols, mask)

            if build_matched is None:
                build_matched = _Sharded([torch.zeros_like(p.row_mask)
                                          for p in build_side.parts])
            yield self._smap(local_tail, 2, stage="join")(build_side,
                                                          build_matched)

    def _SemiJoinNode(self, node: SemiJoinNode
                      ) -> Iterator[ShardedBatch]:
        build = self._drain(node.filtering)
        skeys, fkeys = list(node.source_keys), list(node.filtering_keys)
        neg = node.negated
        if build is None:
            for b in self.run(node.source):
                if neg:
                    yield b
            return
        # stats-driven distribution: a large filtering set hash-partitions
        # BOTH sides by key so membership never broadcasts. NULL-aware
        # anti joins always replicate (their build_has_null / build_empty
        # facts are global); mark joins (residual semis) keep the
        # replicated path
        partitioned = (node.distribution == "partitioned"
                       and not (neg and node.null_aware)
                       and node.residual is None)
        pmap = repart_build = None
        if partitioned:
            pmap = _PartitionMap(self.n)
            repart_build = self._repartitioner(fkeys, pmap)
            e0 = pmap.epoch
            build_rep = repart_build(build)
            repart_build.observe_pending()
            if pmap.epoch != e0:
                build_rep = repart_build.replay(build)
            repart_src = self._repartitioner(skeys, pmap)
        else:
            build_rep = self._replicate_device(build)
            repart_src = None
        # the EXECUTED distribution: a residual mark join the planner
        # marked partitioned still runs replicated here
        _note_join_strategy(self.stats, node, "sorted",
                            "partitioned" if partitioned
                            else "replicated")

        if node.residual is None:
            # prepare the membership table ONCE per shard
            from ..ops.join import prepare_build
            prep_smap = self._smap(lambda f: prepare_build(f, fkeys), 1,
                                   replicated_in=(0,) if not partitioned
                                   else (),
                                   replicated_out=not partitioned,
                                   stage="semi")
            prep = prep_smap(build_rep)

            def local(b: Batch, flt: Batch, pr) -> Batch:
                b = keys_in_build_vocab(b, flt, skeys, fkeys)
                mask = semi_join_mask(b, flt, skeys, fkeys, negated=neg,
                                      null_aware=node.null_aware,
                                      prepared=pr)
                return Batch(b.schema, b.columns, mask)

            fn = self._smap(local, 3,
                            replicated_in=(1, 2) if not partitioned
                            else (), stage="semi")
            built_epoch = pmap.epoch if pmap is not None else 0
            # fused source plane: key exchange + membership probe as ONE
            # dispatch per round, bucket counts deferred
            fuse_src = repart_src is not None and repart_src.fused
            for b in self.run(node.source):
                if fuse_src:
                    if pmap.epoch != built_epoch:
                        build_rep = repart_build.replay(build)
                        prep = prep_smap(build_rep)
                        built_epoch = pmap.epoch
                    fl = _flight.current_flight()
                    t0 = time.perf_counter()
                    FAILPOINTS.hit("mesh.repartition")
                    assign, quota = pmap.assign, repart_src.fused_quota(b)
                    n = self.n

                    def fused_semi(ps, fs, prs, _a=assign, _q=quota):
                        shipped, counts = X.repartition_fused(
                            ps, skeys, n, _a, _q)
                        outs = []
                        for s in range(n):
                            with self._in_slot(s):
                                outs.append(local(shipped[s], fs[s],
                                                  prs[s]))
                        return outs, counts
                    f2 = self._smap(fused_semi, 3, n_out=2,
                                    flight_kind=None, stage="semi",
                                    collective=True)
                    out, counts = f2(b, build_rep, prep)
                    repart_src.note_counts(self._control(counts))
                    if fl is not None:
                        fl.record("repartition",
                                  wall=time.perf_counter() - t0,
                                  nbytes=self._wire_bytes(b, quota))
                    yield out
                    continue
                if repart_src is not None:
                    b = repart_src(b)
                    if pmap.epoch != built_epoch:
                        build_rep = repart_build.replay(build)
                        prep = prep_smap(build_rep)
                        built_epoch = pmap.epoch
                yield fn(b, build_rep, prep)
            if repart_src is not None:
                repart_src.observe_pending()
            return

        # mark join (EXISTS with a residual): shard-local against the
        # replicated filtering side; the expansion factor from ONE
        # build-side multiplicity readback (skewed builds per chunk)
        from ..ops.join import build_sorted, max_multiplicity
        from .local import mark_exists_mask
        residual = self._resolve(node.residual)
        mult_fn = self._smap(
            lambda f: max_multiplicity(
                build_sorted(f, fkeys)).reshape(1).to(torch.int64), 1,
            replicated_in=(0,), replicated_out=True, flight_kind=None,
            stage="semi")
        _drain_inputs(build_rep)
        with _sync_record("semi-multiplicity"):
            bound = int(self._control(mult_fn(build_rep)).max())
        res_maxk = (bucket_capacity(max(bound, 1), minimum=1)
                    if bound <= self.SKEW_MATCH_LIMIT else None)

        def local_count(p: Batch, f: Batch) -> torch.Tensor:
            p = keys_in_build_vocab(p, f, skeys, fkeys)
            return match_count_max(p, f, skeys, fkeys).reshape(1)
        count_fn = (None if res_maxk is not None else self._smap(
            local_count, 2, replicated_in=(1,), flight_kind=None,
            stage="semi"))
        fns: Dict[int, object] = {}
        for b in self.run(node.source):
            if res_maxk is not None:
                maxk = res_maxk
            else:
                _drain_inputs(b, build_rep)
                with _sync_record("semi-match-count"):
                    maxk = bucket_capacity(
                        max(int(self._control(
                            count_fn(b, build_rep)).max()), 1),
                        minimum=1)
            fn = fns.get(maxk)
            if fn is None:
                def local_mark(p: Batch, f: Batch, _k=maxk) -> Batch:
                    p = keys_in_build_vocab(p, f, skeys, fkeys)
                    mask = mark_exists_mask(p, f, skeys, fkeys, residual,
                                            neg, _k, self)
                    return Batch(p.schema, p.columns, mask)
                fn = fns[maxk] = self._smap(local_mark, 2,
                                            replicated_in=(1,),
                                            stage="semi")
            yield fn(b, build_rep)

    # -- sort family: local pre-reduce + gather-merge -------------------------
    @staticmethod
    def _sort_sentinel_dt(dtype):
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max

    def _SortNode(self, node: SortNode) -> Iterator[ShardedBatch]:
        b = self._drain(node.child)
        if b is None:
            return
        keys = [SortKey(k.index, k.ascending, k.nulls_first)
                for k in node.keys]
        n = self.n
        samples_per_shard = 64
        sentinel_dt = self._sort_sentinel_dt

        # RANGE-partitioned distributed sort (reference dist-sort.rst +
        # MergeOperator.java:45): sample the primary key per shard, agree
        # on splitters via all_gather, all-to-all rows into disjoint key
        # ranges, sort shard-locally. Shard-major concatenation IS the
        # global order.
        def samples(x: Batch):
            from ..ops.sort import _sortable
            x = sort_batch(x, keys)          # local sort (dead rows last)
            k0 = keys[0]
            # a long decimal ranges by its high limb: equal high limbs
            # share a range, and the local sort orders the rest
            ops = _sortable(x.columns[k0.column], k0)
            null_rank, data = ops[0], ops[1]
            nulls_first = k0.effective_nulls_first()
            live = x.row_mask
            nn = live & (null_rank == (1 if nulls_first else 0))
            # after the local sort, non-null live rows are contiguous
            n_nn = nn.sum(dtype=torch.int32)
            start = ((live & ~nn).sum(dtype=torch.int32) if nulls_first
                     else torch.zeros((), dtype=torch.int32,
                                      device=x.device))
            m = samples_per_shard
            step = torch.clamp(n_nn, min=1).to(torch.float32) / m
            pos = start + ((torch.arange(m, dtype=torch.float32,
                                         device=x.device) + 0.5)
                           * step).to(torch.int32)
            pos = torch.clamp(pos, 0, x.capacity - 1).to(torch.int64)
            local = data[pos]
            # shards with no non-null rows contribute max-sentinels so
            # they never pull the splitters down
            sent = torch.full((m,), sentinel_dt(data.dtype),
                              dtype=data.dtype, device=x.device)
            local = torch.where(n_nn > 0, local, sent)
            return x, data, nn, local

        def program(xs: List[Batch]) -> List[Batch]:
            per = []
            for s in range(n):
                with self._in_slot(s):
                    per.append(samples(xs[s]))
            all_samples = X.all_gather([p[3] for p in per],
                                       [x.device for x in xs])   # [n*m]
            sorted_xs, pids = [], []
            for s, (x, data, nn, _) in enumerate(per):
                with self._in_slot(s):
                    s_sorted = torch.sort(all_samples[s]).values
                    splitters = s_sorted[torch.arange(
                        1, n, device=x.device) * samples_per_shard]
                    pid = torch.searchsorted(splitters, data, right=True)
                    null_pid = 0 if keys[0].effective_nulls_first() \
                        else n - 1
                    pids.append(torch.where(nn, pid, null_pid)
                                .to(torch.int32))
                    sorted_xs.append(x)
            ex = X.repartition_by_ids(sorted_xs, pids, n)
            out = []
            for s in range(n):
                with self._in_slot(s):
                    out.append(sort_batch(ex[s], keys))
            return out

        yield self._smap(program, 1, stage="sort", collective=True)(b)

    def _TopNNode(self, node: TopNNode) -> Iterator[ShardedBatch]:
        """Shard-local top-n accumulation, then ONE gathered merge at the
        end (reference TopNOperator keeps a per-driver heap the same way
        and merges once at output)."""
        keys = [SortKey(k.index, k.ascending, k.nulls_first)
                for k in node.keys]
        cap = bucket_capacity(node.count)
        local_topn = self._smap(
            lambda b: top_n(b, keys, node.count).compact(cap, check=False),
            1, stage="sort")
        merge_fn = self._smap(
            lambda s, c: top_n(concat_batches([s, c]), keys,
                               node.count).compact(cap, check=False), 2,
            stage="sort")
        state: Optional[ShardedBatch] = None
        for b in self.run(node.child):
            cand = local_topn(b)
            state = cand if state is None else merge_fn(state, cand)
        if state is not None:
            # the global top-n over the gathered candidates, on shard 0
            yield self._gathered_call(
                lambda s: sort_batch(top_n(s, keys, node.count), keys),
                state, "sort")

    def _UnnestNode(self, node) -> Iterator[ShardedBatch]:
        # shard-local expansion: every shard expands by the same element
        # count, so per-shard capacity stays uniform
        from .local import unnest_expand
        exprs = [self._resolve(e) for e in node.exprs]
        schema = _plan_schema(node)

        def local_unnest(x: Batch):
            out, err = unnest_expand(x, exprs, node.ordinality, schema)
            e = (torch.zeros(1, dtype=torch.int32, device=x.device)
                 if err is None else err.reshape(1).to(torch.int32))
            return out, e

        sfn = self._smap(local_unnest, 1, n_out=2)
        for b in self.run(node.child):
            out, err = sfn(b)
            self.error_flags.extend(e.max() for e in err.parts)
            yield out

    def _WindowNode(self, node) -> Iterator[ShardedBatch]:
        from ..ops.window import WindowSpec, evaluate_window
        b = self._drain(node.child)
        if b is None:
            return
        specs = [WindowSpec(f.fn, f.args, f.output_type, f.name, f.offset,
                            f.ignore_order, f.frame, f.frame_start,
                            f.frame_end) for f in node.functions]
        keys = [SortKey(k.index, k.ascending, k.nulls_first)
                for k in node.order_keys]
        parts = list(node.partition_indices)
        schema = _plan_schema(node)
        errs = self.error_flags
        def window(x: Batch) -> Batch:
            out = evaluate_window(x, parts, keys, specs, errors=errs)
            return Batch(schema, out.columns, out.row_mask)
        if parts:
            # colocate partitions via hash exchange, evaluate per shard
            b = self._repartitioner(parts, fused=False)(b)
            yield self._smap(window, 1)(b)
        else:
            # one global partition: evaluated over the gathered batch,
            # kept on shard 0
            yield self._gathered_call(window, b, "misc")

    def _DistinctNode(self, node: DistinctNode) -> Iterator[ShardedBatch]:
        b = self._drain(node.child)
        if b is None:
            return
        cols = list(range(len(node.fields)))
        allow_dense = bool_property(self.session, "dense_grouping", True)
        kb = tuple(node.key_bounds) if node.key_bounds else None
        if kb is not None and allow_dense:
            # unconditional hard-invariant check (see _AggregationNode)
            self._slot_flags(lambda x: key_bounds_violation(x, cols, kb), b)
        b = self._repartitioner(cols, fused=False)(b)
        fn = self._smap(
            lambda x: grouped_aggregate(x, cols, [], mode="single",
                                        key_bounds=kb,
                                        allow_dense=allow_dense), 1)
        yield fn(b)

    def _MarkDistinctNode(self, node) -> Iterator[ShardedBatch]:
        """Colocate rows by the distinct tuple, then flag per shard:
        equal tuples land on one shard, so first occurrence is global."""
        from ..ops.aggregation import mark_distinct_flags
        b = self._drain(node.child)
        if b is None:
            return
        b = self._repartitioner(list(node.cols), fused=False)(b)
        schema = _plan_schema(node)

        def local_mark(x: Batch) -> Batch:
            flags = mark_distinct_flags(x, list(node.cols))
            col = Column(T.BOOLEAN, flags, x.row_mask, None)
            return Batch(schema, list(x.columns) + [col], x.row_mask)
        yield self._smap(local_mark, 1)(b)

    def _drain(self, node: PlanNode) -> Optional[ShardedBatch]:
        batches = list(self.run(node))
        if not batches:
            return None
        if len(batches) == 1:
            return batches[0]
        # concat shard-locally to keep the result sharded
        fn = self._smap(lambda *bs: concat_batches(list(bs)), len(batches),
                        stage="scan")
        return fn(*batches)


# -- helpers -----------------------------------------------------------------

def _fused_agg_wave_fn(group, key_idx, aggs, kb, cap_out: int,
                       has_carry: bool, n_chunks: int, in_slot):
    """One-dispatch multi-round aggregation program (MapReduce rounds as
    one program, not host round trips): on every slot, partial aggregate
    + state merge over the wave's chunks with the carry at the STATIC
    ``cap_out`` capacity the dense key domain proves. A collective body:
    returns ``(states per slot, violations per slot)``, each violation
    one scalar on its slot's device: STATS_BOUND_VIOLATION, the checked
    sums' NUMERIC_VALUE_OUT_OF_RANGE, or 0 (the query's error check takes
    the max over them, the reference's ``pmax``)."""
    kb_t = tuple(kb) if kb else None

    def _partial(chunk: Batch, errs: list) -> Batch:
        return grouped_aggregate(chunk, group, aggs, mode="partial",
                                 output_capacity=cap_out,
                                 key_bounds=kb_t, allow_dense=True,
                                 errors=errs)

    def slot_wave(carry: Optional[Batch], chunks: List[Batch]):
        errs: list = []
        if kb_t is not None:
            for c in chunks:
                errs.append(key_bounds_violation(c, group, kb_t))
        if carry is not None:
            st, lo = carry, 0
        else:
            st, lo = _partial(chunks[0], errs), 1
        for r in range(lo, n_chunks):
            st = grouped_aggregate(
                concat_batches([st, _partial(chunks[r], errs)]),
                key_idx, aggs, mode="merge", output_capacity=cap_out,
                key_bounds=kb_t, allow_dense=True, errors=errs)
        v = torch.zeros((), dtype=torch.int32, device=chunks[0].device)
        for e in errs:
            v = torch.maximum(v, e)
        return st, v

    def fused_agg_wave(*args):
        carries = args[0] if has_carry else None
        chunk_lists = args[1:] if has_carry else args
        n = len(chunk_lists[0])
        states, viols = [], []
        for s in range(n):
            with in_slot(s):
                st, v = slot_wave(carries[s] if has_carry else None,
                                  [cl[s] for cl in chunk_lists])
            states.append(st)
            viols.append(v)
        return states, viols

    return fused_agg_wave


class DistributedRunner:
    """LocalRunner's multi-shard sibling: the same SQL queries, data
    sharded over an n-slot mesh (reference DistributedQueryRunner.java:76
    boots N servers; here N shards of one program). It serves SELECT
    queries: each statement is parsed and planned afresh (the JAX
    package's compiled-plan cache comes with the serving plane), runs on
    the mesh whatever ``mesh_execution`` says, and leaves a ``spmd``
    record with the flight attribution in the query history. Session
    statements belong to LocalRunner. With no ``device`` the mesh is on
    the GPU, which must exist."""

    def __init__(self, catalogs=None, catalog: str = "tpch",
                 schema: str = "default", tpch_sf: float = 0.01,
                 n_devices: Optional[int] = None,
                 rows_per_batch: int = 1 << 16, device=None):
        from ..connectors.spi import CatalogManager
        from ..connectors.tpch import TpchConnector
        from ..device import resolve_device
        self.device = resolve_device(device)
        if catalogs is None:
            from ..connectors.tpcds import TpcdsConnector
            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector(sf=tpch_sf))
            catalogs.register("tpcds", TpcdsConnector(sf=tpch_sf))
        self.session = Session(catalogs=catalogs, catalog=catalog,
                               schema=schema)
        self.mesh = make_mesh(n_devices, device=self.device)
        self.rows_per_batch = rows_per_batch
        self._seq = 0

    def execute(self, sql: str,
                properties: Optional[Dict[str, object]] = None,
                user: str = "", cancel_event=None) -> QueryResult:
        """Run one query on the mesh. ``properties`` overlays per-query
        session properties, validated through the declared registry;
        ``user`` scopes the history record; ``cancel_event`` interrupts
        between batches. SELECTs ride the parse and plan caches
        (serving/plancache.py): a repeated statement skips parse, plan
        and optimize."""
        from ..config import validate_session_property
        from ..obs.history import HISTORY
        from ..serving.plancache import cached_plan, parse_cached
        from ..sql import ast as A
        from .local import run_init_plans
        stmt = parse_cached(sql)
        if not isinstance(stmt, A.Query):
            raise NotImplementedError(
                "DistributedRunner serves queries; use LocalRunner for "
                "session statements")
        session = self.session
        if properties:
            overlay = {k: validate_session_property(k, v)
                       for k, v in properties.items()}
            session = dataclasses.replace(
                session, properties={**session.properties, **overlay})
        self._seq += 1
        qid = f"dq_{self._seq:06d}"
        t0 = time.perf_counter()
        create_time = time.time()
        error: Optional[str] = None
        rows = None
        flight = None
        fl_token = None
        if mesh_flight_on(session):
            flight = _flight.FlightRecorder(qid, self.mesh.size)
            fl_token = _flight.CURRENT_FLIGHT.set(flight)
        try:
            with TRACER.span("query", query_id=qid, user=user,
                             mode="spmd", shards=self.mesh.size):
                with TRACER.span("plan"):
                    plan = cached_plan(stmt, session, user=user)
                ex = DistributedExecutor(session, self.rows_per_batch,
                                         self.mesh)
                ex.cancel_event = cancel_event
                run_init_plans(ex, plan)
                root = plan.root
                batches = []
                for b in ex.run(root.child):
                    ex._check_cancel()
                    batches.append(b)
                ex.check_errors()
                with _sync_record("result-gather", kind="drain"):
                    rows = [r for b in batches for r in b.to_pylist()]
            return QueryResult(names=[f.name for f in root.fields],
                               types=[f.type for f in root.fields],
                               rows=rows)
        except Exception as e:
            error = str(e)
            raise
        finally:
            record = {
                "query_id": qid, "query": sql.strip(), "user": user,
                "state": "FAILED" if error is not None else "FINISHED",
                "error": error, "create_time": create_time,
                "elapsed_ms": round((time.perf_counter() - t0) * 1e3, 3),
                "rows": None if rows is None else len(rows),
                "mode": "spmd",
            }
            if flight is not None:
                _flight.CURRENT_FLIGHT.reset(fl_token)
                attr = flight.finish(time.perf_counter() - t0)
                record.update(_flight.history_fields(attr))
            # the SPMD path has no event listeners: feed the history
            # directly so completed_queries covers it
            HISTORY.add(record)
