"""Two-limb int128 tensor arithmetic: the storage and arithmetic layer of
long decimals (precision 19..38).

The counterpart of ``presto_tpu/ops/int128.py`` (reference
presto-spi/.../spi/block/Int128ArrayBlock.java, spi/type/Decimals.java
MAX_PRECISION = 38, spi/type/UnscaledDecimal128Arithmetic.java). A column
of long decimals is an ``[capacity, 2]`` int64 tensor: ``value = hi *
2**64 + (lo mod 2**64)`` with ``hi`` signed and ``lo`` holding the low 64
bits' two's-complement pattern. int64 adds and multiplies wrap on the CPU
and on CUDA alike, so carries come from unsigned compares (sign-flipped
signed compares), never from Python ints on tensors and never from
``torch.uint64`` kernels.

Multiplication and base-10 rescaling decompose limbs into 32-bit digits:
a 32x32 partial product is exact modulo 2**64, and short division by a
divisor of at most 2**31 runs as a four-step digit loop with a carried
remainder. Exact sums over rows use the same digits: four int64 digit
sums recombine with carry propagation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: the int64 sign bit as a signed value (XOR flips signed <-> unsigned order)
SIGN64 = -(1 << 63)
MASK32 = 0xFFFFFFFF

#: largest value magnitude a decimal(38) may hold
MAX_UNSCALED = 10 ** 38 - 1


# -- packing -----------------------------------------------------------------

def pack(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return torch.stack([h.to(torch.int64), l.to(torch.int64)], dim=-1)


def hi(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0]


def lo(x: torch.Tensor) -> torch.Tensor:
    return x[..., 1]


def limbs_of(value: int) -> Tuple[int, int]:
    """Python int -> (hi, lo) limb ints (lo as SIGNED two's complement)."""
    lo_u = value & ((1 << 64) - 1)
    h = value >> 64
    if not -(1 << 63) <= h < (1 << 63):
        raise OverflowError(f"{value} out of int128 range")
    return h, lo_u - (1 << 64) if lo_u >= (1 << 63) else lo_u


def int_of(h: int, l: int) -> int:
    """(hi, lo) limb ints -> Python int."""
    return (int(h) << 64) + (int(l) & ((1 << 64) - 1))


def const(value: int, device=None) -> torch.Tensor:
    return torch.tensor(limbs_of(value), dtype=torch.int64, device=device)


def from_i64(v: torch.Tensor) -> torch.Tensor:
    """Sign-extend int64 values into limb pairs."""
    v = v.to(torch.int64)
    return pack(v >> 63, v)


def _ones_like_rows(x: torch.Tensor) -> torch.Tensor:
    return from_i64(torch.ones(x.shape[:-1], dtype=torch.int64,
                               device=x.device))


# -- compares ----------------------------------------------------------------

def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned < over int64 bit patterns."""
    return (a ^ SIGN64) < (b ^ SIGN64)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (hi(a) == hi(b)) & (lo(a) == lo(b))


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (hi(a) < hi(b)) | ((hi(a) == hi(b)) & _ult(lo(a), lo(b)))


def le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lt(a, b) | eq(a, b)


def is_neg(x: torch.Tensor) -> torch.Tensor:
    return hi(x) < 0


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return (hi(x) == 0) & (lo(x) == 0)


def sign(x: torch.Tensor) -> torch.Tensor:
    """-1 / 0 / 1 as int64."""
    return torch.where(is_neg(x), -1, torch.where(is_zero(x), 0, 1)).to(
        torch.int64)


def sortable_lo(x: torch.Tensor) -> torch.Tensor:
    """lo limb transformed so SIGNED int64 order matches unsigned order
    (for (hi, sortable_lo) lexicographic sort keys)."""
    return lo(x) ^ SIGN64


# -- add / sub / neg ---------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    l = lo(a) + lo(b)                       # wraps mod 2^64
    carry = _ult(l, lo(a)).to(torch.int64)
    return pack(hi(a) + hi(b) + carry, l)


def add_overflows(a: torch.Tensor, b: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """True where a + b = s overflowed int128 (same-sign operands,
    different-sign result)."""
    return ((hi(a) < 0) == (hi(b) < 0)) & ((hi(s) < 0) != (hi(a) < 0))


def neg(a: torch.Tensor) -> torch.Tensor:
    l = -lo(a)                              # wraps
    h = torch.where(lo(a) == 0, -hi(a), ~hi(a))
    return pack(h, l)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add(a, neg(b))


def abs_(x: torch.Tensor) -> torch.Tensor:
    return torch.where(is_neg(x)[..., None], neg(x), x)


def where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise select over limb pairs (cond is row-shaped)."""
    return torch.where(cond[..., None], a, b)


# -- digit decomposition -----------------------------------------------------

def digits32(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(d0, d1, d2, d3): x = sum di * 2**(32 i); d0..d2 in [0, 2**32),
    d3 = arithmetic high digit (signed). All int64."""
    d0 = lo(x) & MASK32
    d1 = (lo(x) >> 32) & MASK32
    d2 = hi(x) & MASK32
    d3 = hi(x) >> 32
    return d0, d1, d2, d3


def from_digits(d0, d1, d2, d3) -> torch.Tensor:
    """Recombine possibly-carrying digit values (each int64; d0..d2 may
    exceed 32 bits, carries propagate upward; d3 absorbs the rest)."""
    t0 = d0
    t1 = d1 + (t0 >> 32)
    t2 = d2 + (t1 >> 32)
    t3 = d3 + (t2 >> 32)
    l = (t0 & MASK32) | ((t1 & MASK32) << 32)
    h = (t2 & MASK32) | ((t3 & MASK32) << 32)
    return pack(h, l)


# -- multiplication ----------------------------------------------------------

def mul(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed 128x128 -> low 128 product + overflow flag (any bits past
    the 127-bit magnitude). Magnitude multiply, sign fixup."""
    an, bn = is_neg(a), is_neg(b)
    ad = digits32(abs_(a))
    bd = digits32(abs_(b))

    def p(i: int, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        # 32x32 partial product; the int64 product wraps to the exact
        # unsigned 64-bit pattern, split into (lo32, hi32)
        full = ad[i] * bd[j]
        return full & MASK32, (full >> 32) & MASK32

    s = [torch.zeros_like(ad[0]) for _ in range(5)]
    overflow = torch.zeros(ad[0].shape, dtype=torch.bool, device=a.device)
    for i in range(4):
        for j in range(4):
            plo, phi = p(i, j)
            k = i + j
            if k < 4:
                s[k] = s[k] + plo
                s[k + 1] = s[k + 1] + phi
            else:
                overflow = overflow | (plo != 0) | (phi != 0)
    m = from_digits(s[0], s[1], s[2], s[3])
    carry_out = (s[3] + ((s[2] + ((s[1] + (s[0] >> 32)) >> 32)) >> 32)) >> 32
    overflow = overflow | (s[4] != 0) | (carry_out != 0) | is_neg(m)
    return torch.where((an ^ bn)[..., None], neg(m), m), overflow


def mul_small(a: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """a * k for a static Python int k >= 0 (k < 2**63)."""
    return mul(a, const(k, a.device).expand_as(a))


# -- short division (magnitudes) ---------------------------------------------

def divmod_small_abs(x: torch.Tensor, d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative x divided by divisor d (static int or int64 tensor,
    1 <= d <= 2**31): (quotient limbs, remainder int64). Base-2**32 short
    division; the remainder < 2**31 keeps every step in int64."""
    if isinstance(d, int):
        d = torch.tensor(d, dtype=torch.int64, device=x.device)
    d = d.to(torch.int64).clamp(1, 1 << 31)
    d0, d1, d2, d3 = digits32(x)
    r = torch.zeros_like(d0)
    qs = []
    for di in (d3, d2, d1, d0):
        cur = (r << 32) + di
        qs.append(torch.div(cur, d, rounding_mode="floor"))
        r = cur - qs[-1] * d
    q3, q2, q1, q0 = qs
    l = (q0 & MASK32) | ((q1 & MASK32) << 32)
    h = (q2 & MASK32) | ((q3 & MASK32) << 32)
    return pack(h, l), r


def div_round_half_up(x: torch.Tensor, d) -> torch.Tensor:
    """Signed x / d (d as in divmod_small_abs), rounding half up away
    from zero (Presto decimal rounding)."""
    if isinstance(d, int):
        d = torch.tensor(d, dtype=torch.int64, device=x.device)
    neg_in = is_neg(x)
    q, r = divmod_small_abs(abs_(x), d)
    bump = (2 * r >= d.to(torch.int64)).to(torch.int64)
    q = add(q, pack(torch.zeros_like(bump), bump))
    return torch.where(neg_in[..., None], neg(q), q)


# -- wide division (int128 / int128) -----------------------------------------

def divmod_abs(x: torch.Tensor, d: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative x divided by positive d, both int128 limb tensors:
    (quotient, remainder). Float-estimated quotient with exact integer
    correction: four estimate rounds shrink the residual to O(d), then
    three fix-up rounds land r in [0, d)."""
    df = to_f64(d).clamp(min=1.0)
    one = _ones_like_rows(x)
    q, r = torch.zeros_like(x), x
    for _ in range(4):
        e128 = from_f64(torch.floor(to_f64(r) / df))
        prod, _ = mul(e128, d)
        q, r = add(q, e128), sub(r, prod)
    for _ in range(3):
        neg_r = is_neg(r)
        q = where(neg_r, sub(q, one), q)
        r = where(neg_r, add(r, d), r)
        ge = le(d, r) & ~is_neg(r)
        q = where(ge, add(q, one), q)
        r = where(ge, sub(r, d), r)
    return q, r


def div_round_half_up_wide(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Signed int128 x / int128 d (|d| >= 1), rounding half up away from
    zero: the general long-decimal division."""
    neg_out = is_neg(x) ^ is_neg(d)
    da = abs_(d)
    q, r = divmod_abs(abs_(x), da)
    bump = le(sub(da, r), r)          # 2r >= d without overflowing
    q = where(bump, add(q, _ones_like_rows(q)), q)
    return where(neg_out, neg(q), q)


# -- base-10 rescale ---------------------------------------------------------

_P9 = 10 ** 9


def rescale(x: torch.Tensor, delta: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x * 10**delta (delta > 0) or round-half-up(x / 10**-delta)
    (delta < 0). Static delta. Returns (value, overflow)."""
    overflow = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    if delta == 0:
        return x, overflow
    if delta > 0:
        while delta > 0:
            step = min(delta, 18)
            x, o = mul_small(x, 10 ** step)
            overflow = overflow | o
            delta -= step
        return x, overflow
    k = -delta
    # all but the last step truncate: digits drop exactly until the final
    # rounding position, matching integer half-up semantics
    neg_in = is_neg(x)
    m = abs_(x)
    while k > 9:
        m, _ = divmod_small_abs(m, _P9)
        k -= 9
    d = 10 ** k
    q, r = divmod_small_abs(m, d)
    bump = (2 * r >= d).to(torch.int64)
    q = add(q, pack(torch.zeros_like(bump), bump))
    return torch.where(neg_in[..., None], neg(q), q), overflow


# -- float conversion --------------------------------------------------------

def to_f64(x: torch.Tensor) -> torch.Tensor:
    # lo as two 32-bit halves: (lo ^ SIGN64) + 2^63 would cancel
    # catastrophically for small magnitudes
    l = lo(x)
    lo_low = (l & MASK32).to(torch.float64)
    lo_high = ((l >> 32) & MASK32).to(torch.float64) * (2.0 ** 32)
    return hi(x).to(torch.float64) * (2.0 ** 64) + lo_high + lo_low


def from_f64(v: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest float64 -> int128 (|v| must be < 2**127)."""
    v = torch.round(v)
    # small magnitudes convert exactly through one int64 cast; the limb
    # split below would lose low bits of small negatives
    small = v.abs() < 2.0 ** 62
    direct = from_i64(torch.where(small, v, 0.0).to(torch.int64))
    h = torch.floor(v / (2.0 ** 64))
    frac = v - h * (2.0 ** 64)
    # the quotient rounds, so frac can fall outside [0, 2^64) by an ulp
    h = torch.where(frac < 0, h - 1, torch.where(frac >= 2.0 ** 64, h + 1, h))
    frac = torch.where(frac < 0, frac + 2.0 ** 64,
                       torch.where(frac >= 2.0 ** 64, frac - 2.0 ** 64, frac))
    l_signed = torch.where(frac >= 2.0 ** 63, frac - 2.0 ** 64,
                           frac).to(torch.int64)
    big = pack(torch.where(small, 0.0, h).to(torch.int64),
               torch.where(small, 0, l_signed))
    return where(small, direct, big)


# -- exact row sums via digit decomposition ----------------------------------

def digit_sum_tiles(x: torch.Tensor) -> torch.Tensor:
    """[..., 4] digit planes of limb tensors, ready for per-digit group or
    global sums (sums of < 2**31 rows cannot overflow int64)."""
    return torch.stack(digits32(x), dim=-1)


def from_digit_sum_tiles(s: torch.Tensor) -> torch.Tensor:
    """Recombine [..., 4] summed digit planes into limb pairs."""
    return from_digits(s[..., 0], s[..., 1], s[..., 2], s[..., 3])


def from_digit_sum_tiles_checked(s: torch.Tensor):
    """Like from_digit_sum_tiles, and also detects int128 overflow: the
    carried top digit must fit 32 signed bits. Returns (value, overflow)."""
    t0 = s[..., 0]
    t1 = s[..., 1] + (t0 >> 32)
    t2 = s[..., 2] + (t1 >> 32)
    t3 = s[..., 3] + (t2 >> 32)
    ovf = t3 != ((t3 << 32) >> 32)
    l = (t0 & MASK32) | ((t1 & MASK32) << 32)
    h = (t2 & MASK32) | ((t3 & MASK32) << 32)
    return pack(h, l), ovf


#: poisoned limb pattern of a decimal aggregate that overflowed: no value
#: with |v| <= 10^38 has it; decoding it raises (types.DecimalType), and
#: merges keep it poisoned
OVERFLOW_SENTINEL = np.array([-(1 << 63), 1], dtype=np.int64)


def is_overflow_sentinel(x: torch.Tensor) -> torch.Tensor:
    return (hi(x) == SIGN64) & (lo(x) == 1)


def sentinel_like(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(OVERFLOW_SENTINEL).to(x.device).expand_as(x)


# -- bounds ------------------------------------------------------------------

def fits_decimal(x: torch.Tensor, precision: int) -> torch.Tensor:
    """|x| <= 10**precision - 1 (UnscaledDecimal128Arithmetic.overflows)."""
    m = abs_(x)
    bound = const(10 ** precision - 1, x.device).expand_as(m)
    return le(m, bound) & ~is_neg(m)


# -- host conversion ---------------------------------------------------------

def np_limbs(values, null_value: int = 0) -> np.ndarray:
    """Python ints -> [n, 2] int64 numpy limb array (host-side builder)."""
    out = np.empty((len(values), 2), dtype=np.int64)
    for i, v in enumerate(values):
        out[i] = limbs_of(null_value if v is None else int(v))
    return out
