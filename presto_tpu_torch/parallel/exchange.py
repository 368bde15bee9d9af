"""Exchange primitives: the engine's network shuffle as collectives
between mesh slots.

The counterpart of ``presto_tpu/parallel/exchange.py`` (reference
presto-main/.../operator/PartitionedOutputOperator.java:48 hash-partitions
rows to per-partition buffers; operator/ExchangeClient.java:141 pulls
them over HTTP). Inside a mesh a hash exchange is one all-to-all and a
broadcast exchange is one all-gather; batches stay on their devices as
struct-of-arrays end to end, with no serde.

The JAX functions run inside ``shard_map`` and call
``jax.lax.all_to_all`` on their own shard. The port's controller holds
every shard at once, so each collective here takes the **slot list**:
``batches[i]`` is slot i's shard, and the result's entry i is what the
JAX collective delivers on shard i, lane for lane. ``all_to_all`` is
``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``: slot i receives row
i of every sender's ``[n, ...]`` send buffer, in sender order. Buffers
move to the receiving slot's device with ``.to``; when every slot is on
one device the exchange is one on-device stack and nothing passes
through the host. Column dictionaries are host metadata: senders whose
vocabularies differ are re-coded into one merged vocabulary first, so a
receiver's codes are consistent.

Wire cost: the default exchange is ``repartition_by_hash_compact``: rows
sort by destination on the device and exactly ``quota`` slots ship to
each peer, so a shard moves about C rows per exchange (n*quota with
quota sized to the max per-(src, dst) count). The masked
``repartition_by_hash`` (n*C) is the correctness baseline.

``hash_partition_ids`` is bit for bit the reference's: a splitmix64
chain over the key columns in unsigned 64-bit arithmetic. torch on CUDA
has no usable uint64 arithmetic, so the chain runs on int64 bit patterns
with logical shifts (as ``ops/sketch.py`` does) and the final modulo is
taken as the unsigned value's. The spill shares it, so a spilled build
partition and its probe partition agree by construction.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..batch import Batch, Column, map_parts, remap_codes, unify_dictionaries
from ..ops.sketch import _shr, _signed
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)
_SIGN = -(1 << 63)


def _fnv1a64(s: str) -> int:
    """Deterministic 64-bit string hash (FNV-1a): dictionary VALUES, not
    per-chunk codes, decide placement."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _fnv1a64_np(vocab: Tuple[str, ...]) -> np.ndarray:
    """``_fnv1a64`` of every string of ``vocab`` at once (uint64), one
    numpy pass per byte position over the padded UTF-8 bytes."""
    raw = [s.encode("utf-8") for s in vocab]
    lens = np.fromiter((len(b) for b in raw), dtype=np.int64, count=len(raw))
    width = int(lens.max()) if len(raw) else 0
    buf = np.zeros((len(raw), max(width, 1)), dtype=np.uint8)
    flat = np.frombuffer(b"".join(raw), dtype=np.uint8)
    if flat.size:
        rows = np.repeat(np.arange(len(raw)), lens)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens,
                                                lens)
        buf[rows, cols] = flat
    h = np.full(len(raw), 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    with np.errstate(over="ignore"):
        for k in range(width):
            nh = (h ^ buf[:, k].astype(np.uint64)) * prime
            h = np.where(lens > k, nh, h)
    return h


#: vocabulary -> its FNV-1a table on the host (LRU; the vocabulary is
#: held beside its table, so an id is never reused while cached)
_VOCAB_HASHES: "OrderedDict[int, tuple]" = OrderedDict()
_VOCAB_HASHES_CAP = 64
_VOCAB_HASHES_LOCK = threading.Lock()


def _vocab_hash_table(vocab: Tuple[str, ...], device) -> torch.Tensor:
    """Each vocabulary entry's FNV-1a hash as an int64 bit pattern, plus a
    sentinel slot (0) for -1 codes. Computed once per vocabulary object:
    an exchange hashes the same dictionaries batch after batch."""
    with _VOCAB_HASHES_LOCK:
        hit = _VOCAB_HASHES.get(id(vocab))
        if hit is not None and hit[0] is vocab:
            _VOCAB_HASHES.move_to_end(id(vocab))
            vals = hit[1]
        else:
            vals = None
    if vals is None:
        vals = np.append(_fnv1a64_np(vocab), np.uint64(0)).view(np.int64)
        with _VOCAB_HASHES_LOCK:
            _VOCAB_HASHES[id(vocab)] = (vocab, vals)
            while len(_VOCAB_HASHES) > _VOCAB_HASHES_CAP:
                _VOCAB_HASHES.popitem(last=False)
    return torch.from_numpy(vals).to(device)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 bit patterns (no golden-ratio
    increment, unlike ``ops/sketch.splitmix64``)."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h mod n`` of the unsigned 64-bit value whose bits ``h`` holds."""
    low = h & ~_SIGN                       # the low 63 bits, non-negative
    top = torch.where(h < 0, (1 << 63) % n, 0)
    return (low % n + top) % n


def hash_partition_ids(batch: Batch, key_cols: Sequence[int],
                       n_partitions: int) -> torch.Tensor:
    """Partition id per row in [0, n), int32 on the batch's device.

    Equal key tuples land in one partition. Columns fold into one
    splitmix chain; validity folds in too, and NULL rows' storage is
    zeroed first so stale data under a NULL never splits one NULL
    group. Strings hash their value through the vocabulary; a
    long-decimal limb pair folds to one word; doubles hash the int image
    of ``value * 65536`` (collisions only co-locate)."""
    h = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
    for ci in key_cols:
        c = batch.columns[ci]
        data = c.data
        if c.type.is_string:
            table = _vocab_hash_table(c.dictionary or (), data.device)
            idx = torch.where(data >= 0, data, table.shape[0] - 1)
            data = table[idx.to(torch.int64)]
        elif data.dtype == torch.bool:
            data = data.to(torch.int32)
        elif data.is_floating_point():
            data = (data * 65536.0).to(torch.int64)
        if data.ndim == 2:
            data = data[:, 0] ^ _splitmix64(data[:, 1])
        data = torch.where(c.validity, data.to(torch.int64), 0)
        h = _splitmix64(h ^ data ^ (c.validity.to(torch.int64) << 63))
    return _umod(h, n_partitions).to(torch.int32)


# -- collectives over a slot list --------------------------------------------

def all_to_all(sends: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)`` over slots:
    ``sends[j]`` is sender j's ``[n, ...]`` buffer; slot i receives
    ``[sends[0][i], ..., sends[n-1][i]]`` stacked on ``devices[i]``."""
    n = len(sends)
    if all(s.device == devices[i] for i, s in enumerate(sends)) \
            and len(set(devices)) == 1:
        # one device: [n_dst, n_src, ...] in one on-device copy
        big = torch.stack(list(sends), dim=1)
        return [big[i] for i in range(n)]
    return [torch.stack([sends[j][i].to(devices[i]) for j in range(n)])
            for i in range(n)]


def all_gather(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``jax.lax.all_gather(x, axis, tiled=True)`` over slots: every
    slot receives the row-concatenation of all shards. Slots sharing a
    device share one tensor."""
    by_dev = {}
    out = []
    for d in devices:
        t = by_dev.get(d)
        if t is None:
            t = by_dev[d] = torch.cat([x.to(d) for x in xs])
        out.append(t)
    return out


def _devices(batches: Sequence[Batch]) -> List[torch.device]:
    return [b.device for b in batches]


def unify_slot_vocabs(batches: Sequence[Batch]) -> List[Batch]:
    """The slot batches with every string column re-coded into one
    vocabulary shared by all slots: one dictionary object (codes
    unchanged when the vocabularies already agree)."""
    batches = list(batches)
    if not batches:
        return batches
    cols = [list(b.columns) for b in batches]
    for ci, c0 in enumerate(batches[0].columns):
        if not c0.type.is_string:
            continue
        vocabs = [b.columns[ci].dictionary for b in batches]
        if all(v is vocabs[0] for v in vocabs[1:]):
            continue
        if all(v == vocabs[0] for v in vocabs[1:]):
            for j, b in enumerate(batches):
                c = b.columns[ci]
                cols[j][ci] = Column(c.type, c.data, c.validity, vocabs[0])
            continue
        vocab, remaps = unify_dictionaries([b.columns[ci] for b in batches])
        for j, b in enumerate(batches):
            cols[j][ci] = remap_codes(b.columns[ci], remaps[j], vocab)
    return [Batch(b.schema, c, b.row_mask) for b, c in zip(batches, cols)]


def repartition_by_hash(batches: Sequence[Batch], key_cols: Sequence[int],
                        n_partitions: int) -> List[Batch]:
    """Collective hash exchange: rows land on the slot owning
    hash(key) % n. Output capacity is n*C per slot (each peer may send
    its full shard); masks say which lanes are live."""
    pids = [hash_partition_ids(b, key_cols, n_partitions) for b in batches]
    return repartition_by_ids(batches, pids, n_partitions)


def repartition_by_ids(batches: Sequence[Batch],
                       pids: Sequence[torch.Tensor],
                       n_partitions: int) -> List[Batch]:
    """Masked all-to-all by caller-supplied destination ids: the shared
    engine under the hash exchange and the range exchange (distributed
    sort)."""
    batches = unify_slot_vocabs(batches)
    devs = _devices(batches)
    masks = []
    for b, pid in zip(batches, pids):
        dest = torch.arange(n_partitions, dtype=torch.int32,
                            device=b.device)[:, None]
        masks.append(b.row_mask[None, :] & (pid[None, :] == dest))
    recv_mask = all_to_all(masks, devs)
    out_masks = [m.reshape(-1) for m in recv_mask]
    n = len(batches)
    out_cols: List[List[Column]] = [[] for _ in range(n)]
    for ci, c0 in enumerate(batches[0].columns):
        # every sender ships its whole shard to every receiver (masked),
        # so all receivers get the same lanes: the senders' shards in
        # order, gathered once per device
        data = all_gather_parts([b.columns[ci].data for b in batches],
                                devs)
        valid = all_gather([b.columns[ci].validity for b in batches], devs)
        for i in range(n):
            out_cols[i].append(Column(c0.type, data[i],
                                      valid[i] & out_masks[i],
                                      batches[i].columns[ci].dictionary))
    return [Batch(batches[0].schema, out_cols[i], out_masks[i])
            for i in range(n)]


def all_gather_parts(parts, devs) -> List:
    """``all_gather`` of each slot's column data (a tensor, or the tuple
    of a composite column)."""
    if isinstance(parts[0], tuple):
        per = [all_gather([p[k] for p in parts], devs)
               for k in range(len(parts[0]))]
        return [tuple(per[k][i] for k in range(len(per)))
                for i in range(len(parts))]
    return all_gather(parts, devs)


def partition_counts(batch: Batch, key_cols: Sequence[int],
                     n_partitions: int) -> torch.Tensor:
    """Live rows per destination on this shard: int64[n_partitions].
    Collective-free; callers take the host max across shards to size the
    static quota of ``repartition_by_hash_compact``."""
    pid = hash_partition_ids(batch, key_cols, n_partitions)
    dest = torch.arange(n_partitions, dtype=torch.int32,
                        device=batch.device)[:, None]
    return (batch.row_mask[None, :] & (pid[None, :] == dest)).sum(
        dim=1, dtype=torch.int64)


def repartition_by_hash_compact(batches: Sequence[Batch],
                                key_cols: Sequence[int], n_partitions: int,
                                quota: int) -> List[Batch]:
    """Quota-compacted hash exchange: rows sort by destination and exactly
    ``quota`` lanes ship to each peer, so the output is n*quota lanes per
    slot (reference operator/PartitionedOutputOperator.java:48
    PagePartitioner). ``quota`` must be >= the max per-(src, dst) live
    count across all shards; rows beyond it would be dropped."""
    pids = [hash_partition_ids(b, key_cols, n_partitions) for b in batches]
    return repartition_by_pids_compact(batches, pids, n_partitions, quota)


def _assign_pids(batch: Batch, key_cols: Sequence[int],
                 assign: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bucket id, owning slot) per row under a bucket -> slot map."""
    bucket = hash_partition_ids(batch, key_cols, len(assign))
    table = torch.as_tensor(np.asarray(assign, dtype=np.int32),
                            device=batch.device)
    return bucket, table[bucket.to(torch.int64)]


def repartition_by_buckets_compact(batches: Sequence[Batch],
                                   key_cols: Sequence[int],
                                   n_partitions: int, assign: Sequence[int],
                                   quota: int) -> List[Batch]:
    """Quota-compacted exchange through a bucket indirection: rows hash
    into ``len(assign)`` buckets and ``assign[bucket]`` names the owning
    slot. Equal keys share a bucket, so colocation holds under ANY
    assignment, and the host may re-balance hot buckets between batches
    (adaptive re-splitting of a skewed key space)."""
    pids = [_assign_pids(b, key_cols, assign)[1] for b in batches]
    return repartition_by_pids_compact(batches, pids, n_partitions, quota)


def repartition_by_pids_compact(batches: Sequence[Batch],
                                pids: Sequence[torch.Tensor],
                                n_partitions: int,
                                quota: int) -> List[Batch]:
    """The shared quota-compacted engine under the hash and bucket
    exchanges: the caller supplies per-row destination ids."""
    batches = unify_slot_vocabs(batches)
    devs = _devices(batches)
    lives, srcs = [], []
    for b, pid in zip(batches, pids):
        cap = b.capacity
        dev = b.device
        spid = torch.where(b.row_mask, pid.to(torch.int32),
                           n_partitions).to(torch.int32)   # dead rows last
        sorted_pid, sorted_idx = torch.sort(spid, stable=True)
        dests = torch.arange(n_partitions, dtype=torch.int32, device=dev)
        start = torch.searchsorted(sorted_pid, dests)
        counts = torch.searchsorted(sorted_pid, dests, right=True) - start
        q = torch.arange(quota, device=dev)[None, :]
        lives.append(q < counts[:, None])                        # [n, Q]
        srcs.append(sorted_idx[torch.clamp(start[:, None] + q,
                                           max=cap - 1)])
    # the all-to-all as one gather per receiver: slot i's lanes are
    # sender 0's quota lanes for i, then sender 1's, ... (row i of every
    # sender's [n, Q] buffer, in sender order), without staging the
    # senders' [n, Q] buffers first
    n = len(batches)
    out_masks = [torch.cat([lives[j][i].to(devs[i]) for j in range(n)])
                 for i in range(n)]
    out_cols: List[List[Column]] = [[] for _ in range(n)]
    for ci, c0 in enumerate(batches[0].columns):
        for i in range(n):
            def recv(get):
                return torch.cat([get(j).to(devs[i]) for j in range(n)])
            cols = [b.columns[ci] for b in batches]
            if isinstance(c0.data, tuple):
                data = tuple(recv(lambda j, k=k: cols[j].data[k][srcs[j][i]])
                             for k in range(len(c0.data)))
            else:
                data = recv(lambda j: cols[j].data[srcs[j][i]])
            valid = recv(lambda j: cols[j].validity[srcs[j][i]]
                         & lives[j][i])
            out_cols[i].append(Column(c0.type, data, valid & out_masks[i],
                                      batches[i].columns[ci].dictionary))
    return [Batch(batches[0].schema, out_cols[i], out_masks[i])
            for i in range(n)]


def repartition_fused(batches: Sequence[Batch], key_cols: Sequence[int],
                      n_partitions: int, assign: Sequence[int], quota: int
                      ) -> Tuple[List[Batch], List[torch.Tensor]]:
    """Bucket count + quota-compacted ship in one collective: returns
    ``(shipped, counts)`` where ``counts[i]`` is ``int64[len(assign)]``
    live rows per bucket on slot i, left on the device so the host
    fetches control scalars once per stage instead of once per round.
    The caller passes a capacity-safe quota (the per-shard lane count):
    no per-(src, dst) count can exceed it, so no row is ever dropped."""
    counts, pids = [], []
    for b in batches:
        bucket, pid = _assign_pids(b, key_cols, assign)
        b_ids = torch.arange(len(assign), dtype=torch.int32,
                             device=b.device)[:, None]
        counts.append((b.row_mask[None, :] & (bucket[None, :] == b_ids))
                      .sum(dim=1, dtype=torch.int64))
        pids.append(pid)
    return repartition_by_pids_compact(batches, pids, n_partitions,
                                       quota), counts


def broadcast_batch(batches: Sequence[Batch]) -> List[Batch]:
    """Collective broadcast exchange: every slot receives all rows
    (FIXED_BROADCAST distribution: the replicated join build side)."""
    batches = unify_slot_vocabs(batches)
    devs = _devices(batches)
    masks = all_gather([b.row_mask for b in batches], devs)
    n = len(batches)
    out_cols: List[List[Column]] = [[] for _ in range(n)]
    for ci, c0 in enumerate(batches[0].columns):
        data = all_gather_parts([b.columns[ci].data for b in batches],
                                devs)
        valid = all_gather([b.columns[ci].validity for b in batches], devs)
        for i in range(n):
            out_cols[i].append(Column(c0.type, data[i], valid[i],
                                      batches[i].columns[ci].dictionary))
    return [Batch(batches[0].schema, out_cols[i], masks[i])
            for i in range(n)]


# -- host-side helpers (not collective) -------------------------------------

def local_shard(batch: Batch, shard_index: int, n_shards: int) -> Batch:
    """Shard i's rows of a batch: the i-th of ``n_shards`` equal row
    ranges (views, no copy)."""
    cap = batch.capacity
    assert cap % n_shards == 0, "capacity must divide evenly across shards"
    per = cap // n_shards
    lo = shard_index * per

    def sl(x):
        return x[lo:lo + per]
    cols = [Column(c.type, map_parts(c.data, sl), sl(c.validity),
                   c.dictionary) for c in batch.columns]
    return Batch(batch.schema, cols, sl(batch.row_mask))


def shard_batch(batch: Batch, mesh) -> List[Batch]:
    """Place a batch row-sharded over the mesh: row range i on slot i's
    device (reference execution/scheduler/UniformNodeSelector.java
    assigns splits to workers the same way)."""
    n = mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        s = local_shard(batch, i, n)
        if s.device != dev:
            s = Batch(s.schema, [Column(c.type, map_parts(
                c.data, lambda a: a.to(dev)), c.validity.to(dev),
                c.dictionary) for c in s.columns], s.row_mask.to(dev))
        out.append(s)
    return out
