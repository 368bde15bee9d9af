"""splitmix64 on int64 tensors, the hash behind every generated column.

Tensors hold the uint64 bit patterns as int64: additions and products wrap
modulo 2^64 as in unsigned arithmetic, right shifts are made logical with
a mask, and a modulus by a small positive number is taken on the two
32-bit halves.
"""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _signed(u: int) -> int:
    """The int64 with the bit pattern of the uint64 ``u``."""
    u &= _MASK64
    return u - (1 << 64) if u >= 1 << 63 else u


GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the uint64 patterns by ``0 < s < 64``."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + GOLDEN
    x = (x ^ lsr(x, 30)) * _M1
    x = (x ^ lsr(x, 27)) * _M2
    return x ^ lsr(x, 31)


def h(key: torch.Tensor, tag: int) -> torch.Tensor:
    """The column hash stream ``tag`` over int64 row keys."""
    return splitmix64(key.to(torch.int64) ^ _signed(tag * 0x9E3779B97F4A7C15))


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x mod m`` of the uint64 patterns, for ``0 < m < 2^31``."""
    if not 0 < m < 1 << 31:
        raise ValueError(f"modulus {m} out of range")
    hi = lsr(x, 32) % m
    lo = (x & 0xFFFFFFFF) % m
    return (hi * ((1 << 32) % m) + lo) % m


def randint(key: torch.Tensor, tag: int, lo: int, hi: int) -> torch.Tensor:
    """Uniform integers in [lo, hi]."""
    return lo + umod(h(key, tag), hi - lo + 1)


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded, as numpy divides. On CUDA, PyTorch
    divides by a Python scalar as a product with its reciprocal, which
    can be one unit in the last place off; a 0-dim tensor on the same
    device is divided by."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def round2(x: torch.Tensor) -> torch.Tensor:
    """Round float64 to 2 decimals half to even, as numpy's ``round``
    does: scale, round to integer, scale back."""
    return div(torch.round(x * 100.0), 100.0)
