"""Sketches: HyperLogLog (approx_distinct) and a log-linear quantile
histogram (approx_percentile).

The counterpart of ``presto_tpu/ops/sketch.py`` (reference
presto-main/.../operator/aggregation/
ApproximateCountDistinctAggregations.java + state/HyperLogLogState.java,
and state/DigestAndPercentileState.java). Per group, an HLL keeps m =
(1.04/e)^2 registers, each the largest leading-zero rank of the hashed
inputs of its bucket: updates are one ``scatter_reduce_`` max over
flattened (group, bucket) slots, merges a max over state rows, and the
estimate a harmonic mean. The quantile state is a dense [QD_BINS] int64
histogram (QD_L linear sub-buckets per power of two), updated by one
``index_add_`` and read by one cumulative sum.

Both sketches are deterministic given the hash (a max and an integer
sum do not depend on the order of the rows), so their results equal the
reference's exactly on every device.

The hash is splitmix64 over the int64 bit pattern. torch has no usable
unsigned 64-bit arithmetic on CUDA, so the mixer runs in int64: adds and
multiplies wrap like unsigned ones, right shifts are made logical with a
mask, and the constants above 2**63 enter as their signed values.
"""
from __future__ import annotations

import math
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

#: default standard error of approx_distinct (reference
#: ApproximateCountDistinctAggregations.java DEFAULT_STANDARD_ERROR)
DEFAULT_STANDARD_ERROR = 0.023
MIN_STANDARD_ERROR = 0.0040625
MAX_STANDARD_ERROR = 0.26


def _signed(u: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def hll_m(error: Optional[float]) -> int:
    """Register count for a target standard error (1.04/sqrt(m)),
    rounded up to a power of two."""
    e = DEFAULT_STANDARD_ERROR if error is None else float(error)
    if not (MIN_STANDARD_ERROR <= e <= MAX_STANDARD_ERROR):
        raise ValueError(
            f"standard error must be in [{MIN_STANDARD_ERROR}, "
            f"{MAX_STANDARD_ERROR}]: {e}")
    m = int(math.ceil((1.04 / e) ** 2))
    return 1 << max(int(math.ceil(math.log2(m))), 4)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Stateless 64-bit mix over int64 bit patterns (the reference's
    stand-in for Murmur3 element hashing)."""
    x = x.to(torch.int64) + _GOLDEN
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def hash_dictionary(vocab: Tuple[str, ...]) -> np.ndarray:
    """Stable 64-bit hashes of a string vocabulary (host-side, gathered by
    code on the device): codes are per batch, so hashing the VALUES keeps
    sketches mergeable across batches. Returned as int64 bit patterns."""
    out = np.ones(max(len(vocab), 1), dtype=np.uint64)
    for i, s in enumerate(vocab):
        b = s.encode("utf-8")
        out[i] = (np.uint64(zlib.crc32(b)) << np.uint64(32)) \
            | np.uint64(zlib.crc32(b, 0x9E3779B9))
    return out.view(np.int64)


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading-zero count of int64 bit patterns (x != 0), by halving."""
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = (x & ~((1 << (64 - s)) - 1)) == 0
        n = n + torch.where(top_zero, s, 0).to(torch.int32)
        x = torch.where(top_zero, x << s, x)
    return n


def bucket_and_rank(hashed: torch.Tensor, m: int):
    """(bucket, rank): bucket = top log2(m) bits, rank = leading-zero
    count of the remaining bits + 1."""
    b = int(math.log2(m))
    bucket = _shr(hashed, 64 - b).to(torch.int32)
    # the sentinel bit caps the rank at 64 - b + 1
    rest = (hashed << b) | (1 << (b - 1))
    return bucket, _clz64(rest) + 1


def hll_update(group_slot: torch.Tensor, valid: torch.Tensor,
               hashed: torch.Tensor, cap: int, m: int) -> torch.Tensor:
    """Registers [cap, m] from one pass of hashed values: a max over
    flattened (group, bucket) slots; invalid rows land in a trash slot."""
    bucket, rank = bucket_and_rank(hashed, m)
    flat = group_slot.to(torch.int64) * m + bucket
    flat = torch.where(valid, flat, cap * m)
    regs = torch.zeros(cap * m + 1, dtype=torch.int32, device=hashed.device)
    regs.scatter_reduce_(0, flat, torch.where(valid, rank, 0).to(torch.int32),
                         reduce="amax")
    return regs[:cap * m].reshape(cap, m)


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """Bias-corrected cardinality per group from registers [..., m], with
    the linear-counting small-range correction."""
    m = registers.shape[-1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    regs = registers.to(torch.float64)
    raw = alpha * m * m / torch.pow(2.0, -regs).sum(-1)
    zeros = (registers == 0).to(torch.float64).sum(-1)
    linear = m * torch.log(m / zeros.clamp(min=1.0))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
    return torch.round(est).to(torch.int64)


# -- quantile histogram (approx_percentile) ----------------------------------
# A value in bin (e, sub) lies within a span of relative width
# 1/(QD_L + sub); reporting the bin midpoint bounds the relative error by
# 1/(2*QD_L). Exact zero gets a bin of its own; NaN the top bin.

QD_L = 32                      # linear sub-buckets per octave
QD_E_LO = -126                 # lowest exponent bin
QD_E_COUNT = 254               # exponents -126 .. 127
QD_P = QD_E_COUNT * QD_L       # magnitude bins per sign
QD_BINS = 2 * QD_P + 1         # negatives desc | zero | positives asc


def qd_bin(values: torch.Tensor) -> torch.Tensor:
    """Bin index in ascending VALUE order for float64 inputs."""
    av = values.abs()
    nan = torch.isnan(values)
    tiny = (av < 2.0 ** QD_E_LO) & ~nan
    e = torch.floor(torch.log2(torch.where(tiny | nan, 1.0, av)))
    e = e.clamp(QD_E_LO, QD_E_LO + QD_E_COUNT - 1)
    m = av * torch.exp2(-e)
    sub = torch.floor((m - 1.0) * QD_L).clamp(0, QD_L - 1).to(torch.int64)
    mag = (e.to(torch.int64) - QD_E_LO) * QD_L + sub
    idx = torch.where(values >= 0, QD_P + 1 + mag, QD_P - 1 - mag)
    idx = torch.where(tiny, QD_P, idx)
    return torch.where(nan, QD_BINS - 1, idx)


def qd_update(valid: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[QD_BINS] int64 bin counts from one pass of raw values."""
    idx = torch.where(valid, qd_bin(values.to(torch.float64)), QD_BINS)
    counts = torch.zeros(QD_BINS + 1, dtype=torch.int64, device=values.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[:QD_BINS]


def qd_rep_values() -> np.ndarray:
    """[QD_BINS] bin representative values (midpoints of the linear
    sub-bucket; exact 0.0 for the zero bin)."""
    mag = np.arange(QD_P)
    e = (QD_E_LO + mag // QD_L).astype(np.float64)
    m = 1.0 + (mag % QD_L + 0.5) / QD_L
    pos = np.exp2(e) * m
    return np.concatenate([-pos[::-1], np.zeros(1), pos])


def qd_estimate(counts: torch.Tensor, p: float):
    """Nearest-rank percentile over counts [..., QD_BINS]: the cumulative
    counts cross ceil(p*n) in the bin holding the exact nearest-rank
    element. Returns (value float64, valid)."""
    total = counts.sum(-1)
    k = torch.ceil(p * total.to(torch.float64)).to(torch.int64)
    k = torch.minimum(k.clamp(min=1), total.clamp(min=1))
    cum = torch.cumsum(counts, -1)
    bin_idx = torch.argmax((cum >= k[..., None]).to(torch.int32), dim=-1)
    reps = torch.from_numpy(qd_rep_values()).to(counts.device)
    return reps[bin_idx], total > 0


def hashed_column(data: torch.Tensor, dictionary) -> torch.Tensor:
    """Hash of a column's storage values: strings hash their dictionary
    VALUES gathered by code; numerics hash their storage bits."""
    if dictionary is not None:
        table = torch.from_numpy(hash_dictionary(tuple(dictionary))).to(
            data.device)
        codes = data.to(torch.int64).clamp(0, table.shape[0] - 1)
        return splitmix64(table[codes])
    if data.ndim == 2:
        # long-decimal limb pairs: chain both limbs through the mixer
        return splitmix64(data[..., 0] ^ splitmix64(data[..., 1]))
    if data.is_floating_point():
        # canonicalize -0.0 so equal SQL values hash equally
        canon = torch.where(data == 0, 0.0, data.to(torch.float64))
        return splitmix64(canon.view(torch.int64))
    return splitmix64(data.to(torch.int64))
