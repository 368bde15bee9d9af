"""Two-tier spill: host memory first, then compressed pages on disk.

The counterpart of ``presto_tpu/exec/spill.py`` (reference
presto-main/.../spiller/GenericPartitioningSpiller.java for the
partitioned join spill, operator/aggregation/builder/
SpillableHashAggregationBuilder.java for aggregation state,
OrderByOperator.java + FileSingleStreamSpiller.java for the sort). The
first tier is host memory: a spilled device batch is copied to host
numpy arrays. That is storage, not a move of compute: every operator
still runs on the batch's device, and a partition read back goes to that
device again. When the query's staged host bytes cross the pool's disk
threshold, the store flushes its chunks as compressed wire pages
(``exec/pages.py``) to a temporary file, one page per (chunk,
partition), so reading a partition back is ranged reads.

Partition ids are computed on the device with the value hash the
exchange uses (``parallel/exchange.hash_partition_ids``), so a spilled
build partition and its probe partition agree by construction, string
keys included (hashed by value, not by per-chunk code).

Buffers accumulate device batches against an OperatorMemoryContext.
When the pool cannot fit the next batch (or another operator revokes
them) they stage everything to the host and keep accepting input there.
Each staged chunk is bucketed once at staging time (a stable argsort of
its partition ids), so reading a partition back is slicing, not a
rescan. The spilled ORDER BY sorts on the host with one ``np.lexsort``
over operands that reproduce ``ops/sort._sortable``.

With the tracer on (``obs/trace.py``), a revocation is a ``spill-revoke``
span naming its buffer kind and a flush to disk a ``spill-to-disk``
span.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import (
    Callable, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from ..batch import (
    Batch, Schema, apply_remap_np, bucket_capacity, concat_batches,
    unify_dictionaries, vocab_column,
)
from ..memory import QueryMemoryPool, batch_device_bytes
from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER
from ..ops.aggregation import AggSpec, grouped_aggregate
from ..ops.sort import SortKey, sort_batch
from ..parallel.exchange import hash_partition_ids

#: process-wide spill metrics (per-query figures live on the pool's
#: MemoryStats)
_SPILL_DEVICE_BYTES = REGISTRY.counter("spill_device_bytes_total")
_SPILL_HOST_BYTES = REGISTRY.counter("spill_host_staged_bytes_total")
_SPILL_DISK_BYTES = REGISTRY.counter("spill_disk_bytes_total")
_SPILL_REVOCATIONS = REGISTRY.counter("spill_revocations_total")


@dataclasses.dataclass
class _StagedChunk:
    datas: List[np.ndarray]
    valids: List[np.ndarray]
    dicts: List[Optional[Tuple[str, ...]]]
    part_rows: np.ndarray              # live row indices, partition-sorted
    bounds: Optional[np.ndarray]       # partition p = part_rows[b[p]:b[p+1]]

    def rows_of(self, p: Optional[int]) -> np.ndarray:
        if p is None or self.bounds is None:
            return self.part_rows
        return self.part_rows[self.bounds[p]:self.bounds[p + 1]]


def _stage_chunk(batch: Batch, pid: Optional[torch.Tensor] = None,
                 n_partitions: Optional[int] = None) -> _StagedChunk:
    """Copy a device batch to host arrays, its live rows bucketed by
    partition id."""
    for c in batch.columns:
        if isinstance(c.data, tuple):
            raise NotImplementedError(
                f"spilling {c.type.display()} columns")
    mask = batch.row_mask.cpu().numpy()
    live = np.nonzero(mask)[0]
    if pid is None:
        part_rows, bounds = live, None
    else:
        p = pid.cpu().numpy()[live]
        order = np.argsort(p, kind="stable")
        part_rows = live[order]
        bounds = np.searchsorted(p[order], np.arange(n_partitions + 1))
    return _StagedChunk(
        datas=[c.data.cpu().numpy() for c in batch.columns],
        valids=[c.validity.cpu().numpy() for c in batch.columns],
        dicts=[c.dictionary for c in batch.columns],
        part_rows=part_rows, bounds=bounds)


def _gather_chunks(schema: Schema,
                   selections: Iterable[Tuple[_StagedChunk, np.ndarray]]):
    """Concatenate selected rows across staged chunks, unifying string
    dictionaries incrementally (two chunks of one column may carry
    different vocabularies). Returns (arrays, validity, vocabs) or None
    when no rows are selected."""
    ncols = len(schema)
    datas: List[List[np.ndarray]] = [[] for _ in range(ncols)]
    valids: List[List[np.ndarray]] = [[] for _ in range(ncols)]
    vocabs: List[Optional[Tuple[str, ...]]] = [None] * ncols
    any_rows = False
    for ch, rows in selections:
        if rows.size == 0:
            continue
        any_rows = True
        for ci in range(ncols):
            d = ch.datas[ci][rows]
            v = ch.valids[ci][rows]
            if ch.dicts[ci] is not None:
                if vocabs[ci] is None:
                    vocabs[ci] = ch.dicts[ci]
                elif vocabs[ci] != ch.dicts[ci]:
                    merged, remaps = unify_dictionaries(
                        [vocab_column(vocabs[ci]),
                         vocab_column(ch.dicts[ci])])
                    vocabs[ci] = merged
                    datas[ci] = [apply_remap_np(a, remaps[0])
                                 for a in datas[ci]]
                    d = apply_remap_np(d, remaps[1])
            datas[ci].append(d)
            valids[ci].append(v)
    if not any_rows:
        return None
    arrays = [np.concatenate(datas[ci]) for ci in range(ncols)]
    valid_arr = [np.concatenate(valids[ci]) for ci in range(ncols)]
    return arrays, valid_arr, vocabs


class SpillFile:
    """Append-only temporary file of compressed wire pages, unlinked on
    close (the role of reference spiller/FileSingleStreamSpiller.java's
    file IO, synchronous here: staging already freed the device)."""

    def __init__(self, directory: Optional[str] = None):
        fd, self.path = tempfile.mkstemp(
            prefix="presto-tpu-spill-", suffix=".bin", dir=directory)
        self._f = os.fdopen(fd, "w+b")

    def append(self, data: bytes) -> Tuple[int, int]:
        off = self._f.seek(0, os.SEEK_END)
        self._f.write(data)
        return off, len(data)

    def read(self, off: int, length: int) -> bytes:
        self._f.seek(off)
        return self._f.read(length)

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self.path)
            except OSError:
                pass


def _chunk_host_bytes(ch: _StagedChunk) -> int:
    return sum(a.nbytes for a in ch.datas) + sum(v.nbytes for v in ch.valids)


class HostPartitionStore:
    """Rows staged to host memory, hash-partitioned by key columns; beyond
    the pool's disk threshold of query-wide staged bytes, chunks flush to
    a SpillFile as one compressed page per (chunk, partition). Partitions
    read back onto the device the first staged batch lived on."""

    def __init__(self, schema: Schema, n_partitions: int,
                 pool: Optional[QueryMemoryPool] = None):
        self.schema = schema
        self.n = n_partitions
        self.chunks: List[_StagedChunk] = []
        self.pool = pool
        self.host_bytes = 0
        self.device: Optional[torch.device] = None
        self._file: Optional[SpillFile] = None
        # per partition: [(offset, length)] fragments in the spill file
        self._frags: List[List[Tuple[int, int]]] = [
            [] for _ in range(n_partitions)]

    def add(self, batch: Batch, key_cols: Sequence[int]) -> int:
        """Stage a device batch; returns the device bytes it occupied."""
        if self.device is None:
            self.device = batch.device
        if self.n == 1:
            ch = _stage_chunk(batch)        # single partition: no hashing
        elif not key_cols:
            # bounds=None would alias every row into all n partitions
            raise ValueError(
                "multi-partition staging requires key columns")
        else:
            pid = hash_partition_ids(batch, list(key_cols), self.n)
            ch = _stage_chunk(batch, pid, self.n)
        if self._file is not None:
            self._flush_chunk(ch)
        else:
            self.chunks.append(ch)
            nb = _chunk_host_bytes(ch)
            self.host_bytes += nb
            _SPILL_HOST_BYTES.inc(nb)
            pool = self.pool
            if pool is not None:
                # the staging budget is QUERY-wide (reference
                # NodeSpillConfig.maxSpillPerNode): every store of the
                # query adds to one pool counter
                pool.host_staged_bytes += nb
                if (pool.disk_threshold is not None
                        and pool.host_staged_bytes > pool.disk_threshold):
                    self._flush_to_disk()
        nb_dev = batch_device_bytes(batch)
        _SPILL_DEVICE_BYTES.inc(nb_dev)
        return nb_dev

    def _flush_to_disk(self) -> None:
        with TRACER.span("spill-to-disk", chunks=len(self.chunks),
                         host_bytes=self.host_bytes):
            self._file = SpillFile(
                None if self.pool is None else self.pool.spill_dir)
            for ch in self.chunks:
                self._flush_chunk(ch)
            self.chunks = []
        if self.pool is not None:
            self.pool.host_staged_bytes -= self.host_bytes
        self.host_bytes = 0

    def _flush_chunk(self, ch: _StagedChunk) -> None:
        from .pages import _encode
        for p in range(self.n):
            rows = ch.rows_of(p)
            if rows.size == 0:
                continue
            page = _encode(self.schema,
                           [d[rows] for d in ch.datas],
                           [v[rows] for v in ch.valids],
                           ch.dicts, compress=True)
            self._frags[p].append(self._file.append(page))
            _SPILL_DISK_BYTES.inc(len(page))
            if self.pool is not None:
                self.pool.stats.disk_spilled_bytes += len(page)

    def _disk_chunks(self, p: int
                     ) -> Iterator[Tuple[_StagedChunk, np.ndarray]]:
        from .pages import deserialize_arrays
        for off, length in self._frags[p]:
            _, arrays, valids, dicts, n = deserialize_arrays(
                self._file.read(off, length))
            ch = _StagedChunk(datas=arrays, valids=valids, dicts=dicts,
                              part_rows=np.arange(n), bounds=None)
            yield ch, ch.part_rows

    def partition_arrays(self, p: int):
        """Partition ``p``'s rows as (arrays, validity, vocabs), or None."""
        selections = [(ch, ch.rows_of(p)) for ch in self.chunks]
        if self._file is not None:
            selections.extend(self._disk_chunks(p))
        return _gather_chunks(self.schema, selections)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self.pool is not None and self.host_bytes:
            self.pool.host_staged_bytes -= self.host_bytes
            self.host_bytes = 0

    def partition_batch(self, p: int) -> Optional[Batch]:
        """The whole partition as one device batch (build sides)."""
        got = self.partition_arrays(p)
        if got is None:
            return None
        arrays, valids, vocabs = got
        n = len(arrays[0]) if arrays else 0
        if n == 0:
            return None
        return Batch.from_arrays(self.schema, arrays, valids, vocabs,
                                 num_rows=n, device=self.device)

    def partition_batches(self, p: int,
                          rows_per_batch: int) -> Iterator[Batch]:
        """The partition streamed in bounded device chunks (probe
        sides)."""
        got = self.partition_arrays(p)
        if got is None:
            return
        arrays, valids, vocabs = got
        n = len(arrays[0]) if arrays else 0
        for lo in range(0, n, rows_per_batch):
            hi = min(lo + rows_per_batch, n)
            yield Batch.from_arrays(
                self.schema, [a[lo:hi] for a in arrays],
                [v[lo:hi] for v in valids], vocabs, num_rows=hi - lo,
                device=self.device)


class _SpillBuffer:
    """A revocable accumulator of device batches: each keeps a device
    list under a pool reservation until the pool refuses a batch or
    another operator revokes it, then stages to a HostPartitionStore.

    Every state change happens under ``pool.lock``: the pool's revoke
    path calls ``_spill_all`` from OTHER threads (a build draining on the
    main thread while a probe-prefetch thread reserves), and an
    unsynchronized revoke both stages batches and leaves them visible to
    a concurrent consumer (duplicated rows)."""

    #: the ``buffer`` attribute of this kind's ``spill-revoke`` span
    KIND = "join-build"

    def __init__(self, pool: QueryMemoryPool, name: str,
                 key_cols: Sequence[int], n_partitions: int):
        self.ctx = pool.context(name, revoke_cb=self._spill_all)
        self.key_cols = list(key_cols)
        self.n_partitions = n_partitions
        self.device: List[Batch] = []
        self.store: Optional[HostPartitionStore] = None
        self.spilled = False

    def _add(self, b: Batch) -> bool:
        """Take ``b`` (under the pool lock); True when it stays on the
        device."""
        if self.spilled:
            self._stage(b)
            return False
        if self.ctx.pool.try_reserve(batch_device_bytes(b), self.ctx):
            self.device.append(b)
            return True
        self.ctx.revoke()       # spills everything accumulated so far
        self._stage(b)
        return False

    def _stage(self, b: Batch) -> int:
        if self.store is None:
            self.store = HostPartitionStore(b.schema, self.n_partitions,
                                            pool=self.ctx.pool)
        n = self.store.add(b, self.key_cols)
        self.ctx.pool.stats.spilled_bytes += n
        return n

    def _spill_all(self) -> int:
        _SPILL_REVOCATIONS.inc()
        with TRACER.span("spill-revoke", buffer=self.KIND,
                         batches=len(self.device)):
            freed = 0
            for b in self.device:
                freed += self._stage(b)
            self.device = []
            self.spilled = True
            return freed

    def _pin(self) -> Tuple[bool, List[Batch]]:
        """End revocability (the consumer holds the state from here on)
        and snapshot (spilled, device batches) under the lock, so a late
        revoke cannot re-stage what is about to be handed out."""
        with self.ctx.pool.lock:
            self.ctx.pin()
            return self.spilled, list(self.device)

    def close(self) -> None:
        self.ctx.close()
        if self.store is not None:
            self.store.close()


class SpillableBuildBuffer(_SpillBuffer):
    """Join-build accumulator: device-resident until the pool forces host
    staging (reference HashBuilderOperator spill states :155-180).
    finish() returns None (empty), a device Batch, or a
    HostPartitionStore for partitioned probing."""

    def add(self, b: Batch) -> None:
        with self.ctx.pool.lock:
            self._add(b)

    def finish(self):
        # once the build is handed to the prober, revoking could no longer
        # free its device memory: keep the reservation, end revocability
        spilled, device = self._pin()
        if spilled:
            return self.store
        if not device:
            return None
        return device[0] if len(device) == 1 else concat_batches(device)


class AggSpillBuffer(_SpillBuffer):
    """Grouped-aggregation state accumulator: merges partial-state
    batches on the device; under memory pressure stages states to the
    host partitioned by a hash of the group keys and finalizes partition
    by partition (reference SpillableHashAggregationBuilder.java +
    MergingHashAggregationBuilder). Group keys are disjoint across hash
    partitions, so per-partition results concatenate to the global
    answer.

    ``flag_bounds(states)`` is called on every batch a merge or final
    aggregates: the executor's stats-bounds check (a merge whose larger
    capacity takes the dense, clamping path owes a violation flag)."""

    KIND = "hash-agg"

    def __init__(self, pool: QueryMemoryPool, name: str,
                 key_idx: Sequence[int], aggs: Sequence[AggSpec],
                 n_partitions: int, merge_every: int = 16,
                 key_bounds=None, allow_dense: bool = True,
                 flag_bounds: Callable[[Batch], None] = lambda b: None):
        super().__init__(pool, name, key_idx, n_partitions)
        self.aggs = list(aggs)
        self.key_bounds = tuple(key_bounds) if key_bounds else None
        self.allow_dense = allow_dense
        self.flag_bounds = flag_bounds
        self.merge_every = merge_every

    def _aggregate(self, states: Batch, mode: str) -> Batch:
        self.flag_bounds(states)
        return grouped_aggregate(states, self.key_cols, self.aggs,
                                 mode=mode, key_bounds=self.key_bounds,
                                 allow_dense=self.allow_dense)

    def add_partial(self, partial: Batch) -> None:
        with self.ctx.pool.lock:
            if not self._add(partial) or len(self.device) < self.merge_every:
                return
            # snapshot and clear under the lock; the merge itself (which
            # syncs for the compaction size) runs outside it, so other
            # operators' reservations do not wait on device work. A
            # revoke landing mid-merge finds an empty list and only sets
            # `spilled`.
            snapshot, self.device = self.device, []
        merged = self._aggregate(concat_batches(snapshot), "merge")
        state = merged.compact(bucket_capacity(max(merged.host_count(), 1)))
        with self.ctx.pool.lock:
            self.ctx.release_all()
            if not self.spilled and self.ctx.pool.try_reserve(
                    batch_device_bytes(state), self.ctx):
                self.device.append(state)
            else:
                self._stage(state)
                self.spilled = True

    def results(self, final: bool = True) -> Iterator[Batch]:
        """Final rows (default) or merged partial states (``final=False``,
        a PARTIAL step's output)."""
        mode = "final" if final else "merge"
        spilled, device = self._pin()
        if not spilled:
            if device:
                yield self._aggregate(
                    device[0] if len(device) == 1
                    else concat_batches(device), mode)
            return
        for p in range(self.n_partitions):
            part = None if self.store is None else \
                self.store.partition_batch(p)
            if part is not None:
                yield self._aggregate(part, mode)


class SortSpillBuffer(_SpillBuffer):
    """ORDER BY accumulator: a device sort when everything fits;
    otherwise raw chunks stage to the host (one partition, still riding
    the two tiers) and the final order is one np.lexsort over operands
    replicating ``ops/sort._sortable`` (reference OrderByOperator spill;
    the host takes the role of FileSingleStreamSpiller's disk)."""

    KIND = "order-by"

    def __init__(self, pool: QueryMemoryPool, name: str,
                 keys: Sequence[SortKey]):
        super().__init__(pool, name, [], 1)
        self.keys = list(keys)
        self.schema: Optional[Schema] = None

    def add(self, b: Batch) -> None:
        with self.ctx.pool.lock:
            self.schema = b.schema
            self._add(b)

    def results(self, rows_per_batch: int) -> Iterator[Batch]:
        spilled, device = self._pin()
        if not spilled:
            if device:
                yield sort_batch(device[0] if len(device) == 1
                                 else concat_batches(device), self.keys)
            return
        yield from self._host_sorted(rows_per_batch)

    def _host_sorted(self, rows_per_batch: int) -> Iterator[Batch]:
        got = None if self.store is None else self.store.partition_arrays(0)
        if got is None:
            return
        arrays, valid_arr, vocabs = got
        operands: List[np.ndarray] = []
        for k in self.keys:
            operands.extend(_np_sortable(
                arrays[k.column], valid_arr[k.column], vocabs[k.column],
                self.schema.types[k.column], k))
        # lexsort: the last operand is the primary key; stable, as the
        # device sort is
        perm = np.lexsort(tuple(reversed(operands)))
        n = len(perm)
        for lo in range(0, n, rows_per_batch):
            idx = perm[lo:min(lo + rows_per_batch, n)]
            yield Batch.from_arrays(
                self.schema, [a[idx] for a in arrays],
                [v[idx] for v in valid_arr], vocabs, num_rows=len(idx),
                device=self.store.device)


def _np_sortable(data: np.ndarray, valid: np.ndarray,
                 vocab: Optional[Tuple[str, ...]], typ,
                 key: SortKey) -> List[np.ndarray]:
    """Host replica of ``ops/sort._sortable``: ascending operands
    [null_rank, data'] (long decimals: [null_rank, hi', lo'])."""
    null_rank = (valid if key.effective_nulls_first()
                 else ~valid).astype(np.int32)
    if data.ndim == 2:
        # long-decimal limb pairs: signed hi, lo ordered as unsigned
        h = data[:, 0]
        lo = data[:, 1] ^ np.int64(-(1 << 63))
        if not key.ascending:
            h, lo = ~h, ~lo
        return [null_rank, np.where(valid, h, 0), np.where(valid, lo, 0)]
    if typ.is_string:
        v = np.asarray(vocab or ("",), dtype=object)
        rank = np.argsort(np.argsort(v))
        data = rank[np.where(data >= 0, data, 0)]
    if data.dtype == np.bool_:
        data = data.astype(np.int32)
    if not key.ascending:
        # floats negate; integers flip bits (no INT_MIN overflow)
        data = -data if np.issubdtype(data.dtype, np.floating) else ~data
    # NULL rows tie on null_rank: neutralize their data operand
    return [null_rank, np.where(valid, data, np.zeros((), data.dtype))]
