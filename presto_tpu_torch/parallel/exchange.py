"""Row placement by a value hash of key columns.

The counterpart of ``presto_tpu/parallel/exchange.py:57-100`` (the role
of the reference's InterpretedHashGenerator behind
operator/PartitionedOutputOperator.java:48). Only ``hash_partition_ids``
is ported: the spill stores partition staged rows with it, so a spilled
build partition and its probe partition agree by construction. The mesh
collectives come with the distributed slice.

The hash is bit for bit the reference's: a splitmix64 chain over the key
columns in unsigned 64-bit arithmetic. torch on CUDA has no usable
uint64 arithmetic, so the chain runs on int64 bit patterns with logical
shifts (as ``ops/sketch.py`` does) and the final modulo is taken as the
unsigned value's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..batch import Batch
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


def _vocab_hash_table(vocab: Tuple[str, ...], device) -> torch.Tensor:
    """Each vocabulary entry's FNV-1a hash as an int64 bit pattern, plus a
    sentinel slot (0) for -1 codes."""
    vals = np.asarray([_fnv1a64(s) for s in vocab] + [0], dtype=np.uint64)
    return torch.from_numpy(vals.view(np.int64)).to(device)


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
