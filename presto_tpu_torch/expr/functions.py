"""Scalar function implementations over (data, validity) tensor pairs.

The counterpart of ``presto_tpu/expr/functions.py`` (reference
presto-main/.../metadata/FunctionRegistry.java:350 and operator/scalar/):
each function is a torch transform over storage tensors plus explicit SQL
three-valued-logic validity. String functions work on dictionary codes
with host-side tables computed over the (host) vocabulary, then one
device gather maps codes through the table.

Error semantics (reference spi/StandardErrorCode.java): functions record
a per-row int32 error code on the Val (``err``; None = statically
error-free) instead of raising — integer/decimal division by zero sets
DIVISION_BY_ZERO, double division follows IEEE. The executor raises
QueryError once per query.

Long decimals (precision 19..38) are [n, 2] limb pairs computed through
``ops/int128.py``. String functions (regex, JSON, URL, padding, ...) are
host transforms of each batch's vocabulary followed by one device
gather of the codes; nothing of them runs per row.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

import numpy as np
import torch

from .. import errors as E
from .. import types as T
from ..ops import int128 as I
from ..types import Type


@dataclasses.dataclass
class Val:
    """Evaluation-time column value: storage data + validity (+ vocab)."""

    data: torch.Tensor
    valid: torch.Tensor
    type: Type
    dictionary: Optional[Tuple[str, ...]] = None
    #: python value when this Val is a constant
    literal: Optional[object] = None
    #: per-row int32 error code (0 = ok); None = statically error-free
    err: Optional[torch.Tensor] = None

    @staticmethod
    def constant(value, typ: Type, n: int, device) -> "Val":
        if isinstance(typ, T.ArrayType) and value is None:
            return Val(_null_array(typ, n, device),
                       torch.zeros(n, dtype=torch.bool, device=device), typ,
                       dictionary=() if typ.element.is_string else None)
        if isinstance(typ, (T.ArrayType, T.MapType, T.RowType)):
            raise NotImplementedError(f"{typ.display()} constants")
        dt = typ.storage_dtype
        if value is None:
            width = getattr(typ, "storage_width", None)
            shape = (n,) if width is None else (n, width)
            return Val(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(n, dtype=torch.bool, device=device), typ)
        ones = torch.ones(n, dtype=torch.bool, device=device)
        if typ.is_string:
            s = value
            if isinstance(typ, T.CharType):
                s = str(s).ljust(typ.length)
            return Val(torch.zeros(n, dtype=torch.int32, device=device), ones,
                       typ, dictionary=(s,), literal=s)
        storage = typ.to_storage(value)
        if getattr(typ, "storage_width", None):
            data = torch.tensor(storage, dtype=dt, device=device).repeat(n, 1)
        else:
            data = torch.full((n,), storage, dtype=dt, device=device)
        return Val(data, ones, typ, literal=value)


def _null_array(typ, n: int, device):
    """Storage of n NULL arrays of one element slot."""
    return (torch.zeros((n, 1), dtype=typ.storage_dtype, device=device),
            torch.zeros(n, dtype=torch.int32, device=device),
            torch.zeros((n, 1), dtype=torch.bool, device=device))


def _all_valid(args) -> torch.Tensor:
    v = args[0].valid
    for a in args[1:]:
        v = v & a.valid
    return v


def merge_err(*errs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Combine per-row error codes; the max code wins on a row."""
    present = [e for e in errs if e is not None]
    if not present:
        return None
    out = present[0]
    for e in present[1:]:
        out = torch.maximum(out, e)
    return out


def flag_err(cond: torch.Tensor, code: int) -> torch.Tensor:
    return torch.where(cond, code, 0).to(torch.int32)


def _is_long_dec(t) -> bool:
    return isinstance(t, T.DecimalType) and t.is_long


def _dec_limbs(v: Val, to_scale: int):
    """Numeric Val -> ([n, 2] limbs at to_scale, overflow rows). Decimal
    inputs rescale from their own scale, integrals from 0
    (UnscaledDecimal128Arithmetic.rescale)."""
    t = v.type
    if isinstance(t, T.DecimalType):
        x = v.data if t.is_long else I.from_i64(v.data)
        return I.rescale(x, to_scale - t.scale)
    if T.is_integral(t) or isinstance(t, T.BigintType):
        return I.rescale(I.from_i64(v.data.to(torch.int64)), to_scale)
    raise NotImplementedError(f"cannot take decimal limbs of {t.display()}")


def _cast_long_decimal(v: Val, to: Type) -> Val:
    """Casts where the source or the target is a long decimal (p > 18):
    limb rescales with range checks (DecimalCasts.java). Out-of-range
    rows raise NUMERIC_VALUE_OUT_OF_RANGE, or INVALID_CAST_ARGUMENT where
    a DOUBLE or REAL source does not fit the decimal or a decimal does
    not fit the integral target."""
    f = v.type
    if isinstance(to, T.DecimalType):
        code = E.NUMERIC_VALUE_OUT_OF_RANGE
        if isinstance(f, T.DecimalType) or T.is_integral(f):
            x, ovf = _dec_limbs(v, to.scale)
        elif T.is_floating(f):
            bound = 10.0 ** (to.precision - to.scale)
            ovf = ~(v.data.to(torch.float64).abs() < bound)
            scaled = v.data.to(torch.float64) * (10.0 ** to.scale)
            x = I.from_f64(_round_half_away(torch.where(ovf, 0.0, scaled)))
            code = E.INVALID_CAST_ARGUMENT
        else:
            raise NotImplementedError(
                f"cast {f.display()} -> {to.display()}")
        fits = I.fits_decimal(x, to.precision) & ~ovf
        return _checked(v, x if to.is_long else I.lo(x), fits, to, code)
    # the source is a long decimal
    if isinstance(to, (T.DoubleType, T.RealType)):
        out = (I.to_f64(v.data) / (10.0 ** f.scale)).to(to.storage_dtype)
        return Val(out, v.valid, to)
    if T.is_integral(to):
        x, _ = I.rescale(v.data, -f.scale)
        fits = I.hi(x) == (I.lo(x) >> 63)       # the value fits one limb
        narrow = I.lo(x)
        fits = fits & _in_int_range(narrow, to)
        return _checked(v, torch.where(fits, narrow, 0).to(to.storage_dtype),
                        fits, to, E.INVALID_CAST_ARGUMENT)
    if isinstance(to, T.BooleanType):
        return Val(~I.is_zero(v.data), v.valid, to)
    raise NotImplementedError(f"cast {f.display()} -> {to.display()}")


def rescale_decimal(data: torch.Tensor, from_scale: int,
                    to_scale: int) -> torch.Tensor:
    """Rescale int64 decimal storage, rounding half-up away from zero."""
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    div = 10 ** (from_scale - to_scale)
    return torch.sign(data) * ((data.abs() + div // 2) // div)


def _unify_numeric(a: Val, b: Val) -> Tuple[Val, Val, Type]:
    t = T.common_super_type(a.type, b.type)
    if t is None:
        raise TypeError(f"cannot unify {a.type} and {b.type}")
    return cast_val(a, t), cast_val(b, t), t


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


#: SQL value range of each integral type. tinyint, smallint and integer
#: share int32 storage, so range checks hold a value to its SQL type,
#: not to its dtype
_INT_RANGE = {"tinyint": (-(1 << 7), (1 << 7) - 1),
              "smallint": (-(1 << 15), (1 << 15) - 1),
              "integer": (-(1 << 31), (1 << 31) - 1),
              "bigint": (-(1 << 63), (1 << 63) - 1)}


def int_range(t: Type) -> Tuple[int, int]:
    """[min, max] of an integral SQL type."""
    return _INT_RANGE[t.name]


def _in_int_range(x: torch.Tensor, t: Type) -> torch.Tensor:
    """Rows of integer tensor ``x`` that lie in ``t``'s range."""
    lo, hi = int_range(t)
    info = torch.iinfo(x.dtype)
    if lo <= info.min and hi >= info.max:
        return torch.ones_like(x, dtype=torch.bool)
    return (x >= lo) & (x <= hi)


def _checked(v: Val, out: torch.Tensor, ok: torch.Tensor, to: Type,
             code: int) -> Val:
    """A cast's result whose rows outside ``ok`` fail with ``code``:
    they turn NULL (so TRY yields NULL) and raise through the row-error
    channel."""
    err = flag_err(v.valid & ~ok, code)
    return Val(out, v.valid & ok, to, err=merge_err(v.err, err))


def cast_val(v: Val, to: Type) -> Val:
    """CAST implementation (reference operator/scalar casts per type)."""
    f = v.type
    if f == to:
        return v
    if isinstance(f, T.UnknownType):
        # typed NULL: all-invalid storage of the target type
        n = v.data.shape[0]
        if isinstance(to, T.ArrayType):
            return Val(_null_array(to, n, v.data.device),
                       torch.zeros_like(v.valid), to,
                       dictionary=() if to.element.is_string else None,
                       err=v.err)
        if isinstance(to, (T.MapType, T.RowType)):
            raise NotImplementedError(f"cast NULL to {to.display()}")
        width = getattr(to, "storage_width", None)
        shape = (n,) if width is None else (n, width)
        return Val(torch.zeros(shape, dtype=to.storage_dtype,
                               device=v.data.device),
                   torch.zeros_like(v.valid), to,
                   dictionary=() if to.is_string else None, err=v.err)
    data = v.data
    if _is_long_dec(f) or _is_long_dec(to):
        return _cast_long_decimal(v, to)
    if isinstance(f, T.DecimalType) and isinstance(to, T.DecimalType):
        return Val(rescale_decimal(data, f.scale, to.scale), v.valid, to)
    if isinstance(to, (T.DoubleType, T.RealType)):
        if isinstance(f, T.DecimalType):
            out = (data.to(torch.float64) / (10.0 ** f.scale)).to(
                to.storage_dtype)
        else:
            out = data.to(to.storage_dtype)
        return Val(out, v.valid, to)
    if isinstance(to, T.DecimalType):
        if T.is_integral(f):
            return Val(data.to(torch.int64) * (10 ** to.scale), v.valid, to)
        if T.is_floating(f):
            # DecimalCasts.doubleToShortDecimal: NaN, infinities and
            # values of more than `precision` digits raise, checked
            # before the conversion
            scaled = _round_half_away(
                data.to(torch.float64) * (10.0 ** to.scale))
            ok = scaled.abs() < float(10 ** to.precision)
            return _checked(v, torch.where(ok, scaled, 0.0).to(torch.int64),
                            ok, to, E.INVALID_CAST_ARGUMENT)
    if T.is_integral(to):
        if T.is_floating(f):
            # Presto DoubleOperators.castToLong: Math.round = half-up.
            # NaN, infinities and values past the type's range raise
            # INVALID_CAST_ARGUMENT; the bad rows never reach the
            # conversion, so the CPU and the card give the same rows
            lo, hi = int_range(to)
            r = torch.floor(data.to(torch.float64) + 0.5)
            ok = (r >= float(lo)) & (r < float(hi + 1))
            out = torch.floor(torch.where(ok, data, 0) + 0.5)
            return _checked(v, out.to(to.storage_dtype), ok, to,
                            E.INVALID_CAST_ARGUMENT)
        if isinstance(f, T.DecimalType):
            # DecimalCasts: a value past the integral type raises
            r = rescale_decimal(data, f.scale, 0)
            ok = _in_int_range(r, to)
            return _checked(v, torch.where(ok, r, 0).to(to.storage_dtype),
                            ok, to, E.INVALID_CAST_ARGUMENT)
        if T.is_integral(f):
            # a narrowing cast raises past the target's range
            # (IntegerOperators.castToTinyint and its siblings)
            ok = _in_int_range(data, to)
            return _checked(v, torch.where(ok, data, 0).to(to.storage_dtype),
                            ok, to, E.NUMERIC_VALUE_OUT_OF_RANGE)
        if isinstance(f, T.BooleanType):
            return Val(data.to(to.storage_dtype), v.valid, to)
    if isinstance(to, T.BooleanType) and T.is_numeric(f):
        return Val(data != 0, v.valid, to)
    if isinstance(to, T.VarcharType) and f.is_string \
            and not isinstance(f, T.VarbinaryType):
        return Val(data, v.valid, to, v.dictionary)
    if isinstance(to, T.TimestampType) and isinstance(f, T.DateType):
        return Val(data.to(torch.int64) * 86_400_000_000, v.valid, to)
    if isinstance(to, T.DateType) and isinstance(f, T.TimestampType):
        return Val((data // 86_400_000_000).to(torch.int32), v.valid, to)
    if isinstance(to, T.DateType) and f.is_string \
            and isinstance(v.dictionary, tuple):
        # dictionary-string -> date: parse each distinct value host-side,
        # then one device gather maps codes to epoch days; unparseable
        # values raise the row-error channel
        import datetime as _dt
        days, ok = [], []
        for s in v.dictionary:
            try:
                y, m, d = (int(p) for p in s.strip().split("-"))
                days.append((_dt.date(y, m, d) - _dt.date(1970, 1, 1)).days)
                ok.append(True)
            except (ValueError, TypeError):
                days.append(0)
                ok.append(False)
        dev = data.device
        table = torch.tensor(days + [0], dtype=torch.int32, device=dev)
        okt = torch.tensor(ok + [False], dtype=torch.bool, device=dev)
        codes = data.to(torch.int64).clamp(0, len(days))
        parsed_ok = okt[codes]
        err = flag_err(v.valid & ~parsed_ok, E.INVALID_FUNCTION_ARGUMENT)
        return Val(table[codes], v.valid & parsed_ok, to,
                   err=merge_err(v.err, err))
    raise NotImplementedError(f"cast {f.display()} -> {to.display()}")


# -- date math (branch-free civil calendar) ----------------------------------

def _civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day). Howard Hinnant's
    branch-free algorithm, exact for the whole int32 range."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    year = torch.where(m <= 2, y + 1, y)
    return year, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    y = y.to(torch.int64)
    yy = torch.where(m <= 2, y - 1, y)
    era = yy // 400
    yoe = yy - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = 365 * yoe + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


# -- string helpers (host-side over the vocabulary) --------------------------

def vocab_table(vocab: Tuple[str, ...], fn: Callable[[str], object], dtype,
                device) -> torch.Tensor:
    """Evaluate a host predicate/transform over the vocab -> device table.
    Appends a slot for the -1 (null) code at the end."""
    vals = [fn(s) for s in vocab]
    vals.append(fn("") if dtype != np.bool_ else False)
    return torch.from_numpy(np.asarray(vals, dtype=dtype)).to(device)


def _code_gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    idx = torch.where(codes >= 0, codes, table.shape[0] - 1).to(torch.int64)
    return table[idx]


def _string_literal_of(v: Val) -> Optional[str]:
    if v.dictionary is not None and len(v.dictionary) == 1 and v.data.ndim >= 1:
        return v.dictionary[0]
    return None


def _str_padded(v: Val, s: str) -> str:
    return s.ljust(v.type.length) if isinstance(v.type, T.CharType) else s


_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


def _string_compare(a: Val, b: Val, op: str) -> Val:
    """Comparison on dictionary-coded strings (vocab-table compares)."""
    lit_b = _string_literal_of(b)
    lit_a = _string_literal_of(a)
    valid = a.valid & b.valid
    dev = a.data.device
    if a.dictionary is not None and lit_b is not None:
        target = _str_padded(a, lit_b)
        if op in ("eq", "ne"):
            code = a.dictionary.index(target) if target in a.dictionary else -2
            d = a.data == code
            return Val(d if op == "eq" else ~d, valid, T.BOOLEAN)
        table = vocab_table(
            a.dictionary,
            {"lt": lambda s: s < target, "le": lambda s: s <= target,
             "gt": lambda s: s > target, "ge": lambda s: s >= target}[op],
            np.bool_, dev)
        return Val(_code_gather(table, a.data), valid, T.BOOLEAN)
    if lit_a is not None and b.dictionary is not None:
        flipped = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                   "eq": "eq", "ne": "ne"}[op]
        return _string_compare(b, a, flipped)
    if a.dictionary is not None and b.dictionary is not None:
        if a.dictionary == b.dictionary:
            if op in ("eq", "ne"):
                d = a.data == b.data
                return Val(d if op == "eq" else ~d, valid, T.BOOLEAN)
            order = {s: i for i, s in enumerate(sorted(a.dictionary))}
            rank = vocab_table(a.dictionary, lambda s: order.get(s, -1),
                               np.int32, dev)
            ra, rb = _code_gather(rank, a.data), _code_gather(rank, b.data)
            return Val(_CMP[op](ra, rb), valid, T.BOOLEAN)
        merged = sorted(set(a.dictionary) | set(b.dictionary))
        order = {s: i for i, s in enumerate(merged)}
        ta = vocab_table(a.dictionary, lambda s: order.get(s, -1), np.int64, dev)
        tb = vocab_table(b.dictionary, lambda s: order.get(s, -1), np.int64, dev)
        ra, rb = _code_gather(ta, a.data), _code_gather(tb, b.data)
        return Val(_CMP[op](ra, rb), valid, T.BOOLEAN)
    raise NotImplementedError("string comparison without dictionaries")


# -- function registry -------------------------------------------------------

FunctionImpl = Callable[[List[Val], Type], Val]
_REGISTRY: Dict[str, FunctionImpl] = {}
#: plugin-provided return-type inference, name -> (arg_types) -> Type
#: (the Plugin.getFunctions surface; reference spi/Plugin.java:33-78 and
#: metadata/FunctionRegistry registration)
_EXTERNAL_SIGNATURES: Dict[str, Callable[[List[Type]], Type]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def register_external(name: str, impl: FunctionImpl,
                      infer: Callable[[List[Type]], Type]) -> None:
    """Register a plugin scalar function: its implementation (``(args:
    List[Val], out_type) -> Val`` over torch tensors on the query's
    device, like every builtin) and its return-type inference."""
    key = name.lower()
    _REGISTRY[key] = impl
    _EXTERNAL_SIGNATURES[key] = infer


def lookup(name: str) -> FunctionImpl:
    if name not in _REGISTRY:
        raise KeyError(f"unknown function {name!r}")
    return _REGISTRY[name]


def _long_decimal_arith(op: str, a: Val, b: Val, out, valid) -> Val:
    """Decimal arithmetic through int128 limbs (DecimalOperators.java's
    long-decimal paths, and every decimal division): add/sub/mul exact
    with NUMERIC_VALUE_OUT_OF_RANGE past 38 digits; division by a short
    divisor (precision <= 9) through the base-2^32 short division, by any
    other through the general int128 division, rounding half up away from
    zero; a zero divisor raises DIVISION_BY_ZERO."""
    s_out = out.scale
    sa = a.type.scale if isinstance(a.type, T.DecimalType) else 0
    sb = b.type.scale if isinstance(b.type, T.DecimalType) else 0
    if op in ("add", "sub"):
        xa, oa = _dec_limbs(a, s_out)
        xb, ob = _dec_limbs(b, s_out)
        res = I.add(xa, xb) if op == "add" else I.sub(xa, xb)
        rhs = xb if op == "add" else I.neg(xb)
        wrap = I.add_overflows(xa, rhs, res)
        fits = I.fits_decimal(res, out.precision) & ~(oa | ob | wrap)
    elif op == "mul":
        xa, oa = _dec_limbs(a, sa)
        xb, ob = _dec_limbs(b, sb)
        prod, om = I.mul(xa, xb)
        res, orr = I.rescale(prod, s_out - (sa + sb))
        fits = I.fits_decimal(res, out.precision) & ~(oa | ob | om | orr)
    elif op == "div":
        num, on = _dec_limbs(a, s_out + sb)
        small_type = (isinstance(b.type, T.DecimalType)
                      and not b.type.is_long and b.type.precision <= 9) \
            or (T.is_integral(b.type)
                and not isinstance(b.type, T.BigintType))
        if small_type:
            db = b.data.to(torch.int64)
            zero = db == 0
            q = I.div_round_half_up(num, torch.where(zero, 1, db).abs())
            q = I.where(db < 0, I.neg(q), q)
        else:
            den, od = _dec_limbs(b, sb)
            on = on | od
            zero = I.is_zero(den)
            q = I.div_round_half_up_wide(
                num, I.where(zero, I.from_i64(torch.ones_like(
                    zero, dtype=torch.int64)), den))
        err = flag_err(valid & zero, E.DIVISION_BY_ZERO)
        fits = I.fits_decimal(q, out.precision) & ~on & ~zero
        err = err | flag_err(valid & ~zero & ~fits,
                             E.NUMERIC_VALUE_OUT_OF_RANGE)
        return Val(q if out.is_long else I.lo(q), valid & fits, out,
                   err=err)
    else:
        raise NotImplementedError(f"long decimal {op} is not supported")
    err = flag_err(valid & ~fits, E.NUMERIC_VALUE_OUT_OF_RANGE)
    return Val(res if out.is_long else I.lo(res), valid & fits, out,
               err=err)


def _short_decimal_mod(a: Val, b: Val, valid, out) -> Val:
    """Modulus of short decimals or integrals with a short result
    (DecimalOperators.modulus): both operands at the wider scale, the
    remainder signed like the dividend; a zero divisor raises
    DIVISION_BY_ZERO. Where an operand at that scale could leave int64
    (a bigint, or an integer at a large scale) the remainder is taken on
    int128 limbs: it is smaller than both operands, so it fits the
    result."""
    ta, tb = T.exact_decimal(a.type), T.exact_decimal(b.type)
    sc = max(ta.scale, tb.scale)
    zero = b.data == 0
    err = flag_err(valid & zero, E.DIVISION_BY_ZERO)
    if max(t.precision + sc - t.scale for t in (ta, tb)) > 18:
        xa, _ = _dec_limbs(a, sc)
        xb, _ = _dec_limbs(b, sc)
        one = I.from_i64(torch.ones_like(zero, dtype=torch.int64))
        _, r = I.divmod_abs(I.abs_(xa), I.where(zero, one, I.abs_(xb)))
        data = I.lo(I.where(I.is_neg(xa), I.neg(r), r))
    else:
        da = rescale_decimal(a.data.to(torch.int64), ta.scale, sc)
        db = rescale_decimal(b.data.to(torch.int64), tb.scale, sc)
        den = torch.where(zero, 1, db)
        data = torch.sign(da) * (da.abs() % den.abs())
    return Val(torch.where(zero, 0, data), valid & ~zero, out, err=err)


def _integral_arith(op: str, da: torch.Tensor, db: torch.Tensor,
                    valid: torch.Tensor, out: Type) -> Val:
    """add / sub / mul / div of tinyint..bigint, checked like Presto's
    BigintOperators and IntegerOperators (``Math.addExact`` and its
    siblings): a row whose exact result leaves the SQL type's range
    raises NUMERIC_VALUE_OUT_OF_RANGE. Narrower types compute exactly in
    int64 and check the range; bigint checks the wrapped result's sign
    bits (add, sub), divides the wrapped product back
    (``Math.multiplyExact``), and flags MIN / -1. Integer division
    truncates toward zero; a zero divisor raises DIVISION_BY_ZERO."""
    x, y = da.to(torch.int64), db.to(torch.int64)
    bigint = isinstance(out, T.BigintType)
    i64_min = int_range(T.BIGINT)[0]
    zero = None
    ovf = None
    if op == "add":
        r = x + y
        if bigint:
            ovf = ((x ^ r) & (y ^ r)) < 0
    elif op == "sub":
        r = x - y
        if bigint:
            ovf = ((x ^ y) & (x ^ r)) < 0
    elif op == "mul":
        r = x * y
        if bigint:
            m1 = y == -1
            den = torch.where((y == 0) | m1, 1, y)
            back = torch.div(r, den, rounding_mode="trunc")
            ovf = torch.where(m1, x == i64_min, (y != 0) & (back != x))
    elif op == "div":
        zero = y == 0
        m1 = y == -1
        den = torch.where(zero | m1, 1, y)
        # -x for a divisor of -1: MIN / -1 wraps, and is flagged below
        r = torch.where(m1, -x, torch.div(x, den, rounding_mode="trunc"))
        if bigint:
            ovf = m1 & (x == i64_min)
    else:
        raise AssertionError(op)
    if ovf is None:
        ovf = ~_in_int_range(r, out)
    err = flag_err(valid & ovf, E.NUMERIC_VALUE_OUT_OF_RANGE)
    ok = ~ovf
    if zero is not None:
        ok = ok & ~zero
        err = torch.maximum(err, flag_err(valid & zero, E.DIVISION_BY_ZERO))
    return Val(torch.where(ok, r, 0).to(out.storage_dtype), valid & ok, out,
               err=err)


def _arith(op):
    def impl(args: List[Val], out: Type) -> Val:
        a, b = args
        valid = a.valid & b.valid
        if isinstance(out, T.DecimalType) and (
                out.is_long or _is_long_dec(a.type) or _is_long_dec(b.type)):
            return _long_decimal_arith(op, a, b, out, valid)
        if isinstance(out, T.DecimalType):
            s_out = out.scale
            sa = a.type.scale if isinstance(a.type, T.DecimalType) else 0
            sb = b.type.scale if isinstance(b.type, T.DecimalType) else 0
            da = a.data.to(torch.int64)
            db = b.data.to(torch.int64)
            if op == "mul":
                data = rescale_decimal(da * db, sa + sb, s_out)
            elif op == "div":
                # exact: the rescaled numerator may leave int64, so the
                # quotient is the limbs' half-up division, narrowed
                return _long_decimal_arith(op, a, b, out, valid)
            elif op == "mod":
                return _short_decimal_mod(a, b, valid, out)
            else:
                da2 = rescale_decimal(da, sa, s_out)
                db2 = rescale_decimal(db, sb, s_out)
                data = da2 + db2 if op == "add" else da2 - db2
            return Val(data, valid, out)
        a2, b2 = cast_val(a, out), cast_val(b, out)
        da, db = a2.data, b2.data
        if T.is_integral(out) and op != "mod":
            return _integral_arith(op, da, db, valid, out)
        if op == "add":
            data = da + db
        elif op == "sub":
            data = da - db
        elif op == "mul":
            data = da * db
        elif op == "div":
            # double/real: IEEE semantics (DoubleOperators.divide)
            data = da / db
        elif op == "mod":
            if T.is_integral(out):
                den = torch.where(db == 0, 1, db)
                data = torch.sign(da) * (da.abs() % den.abs())
                err = flag_err(valid & (db == 0), E.DIVISION_BY_ZERO)
                return Val(data, valid & (db != 0), out, err=err)
            den = torch.where(db == 0.0, torch.nan, db)
            data = torch.sign(da) * torch.fmod(da.abs(), den.abs())
        else:
            raise AssertionError(op)
        return Val(data, valid, out)
    return impl


for _name, _op in [("add", "add"), ("subtract", "sub"), ("multiply", "mul"),
                   ("divide", "div"), ("modulus", "mod")]:
    register(_name)(_arith(_op))


def _checked_sign_flip(a: Val, data: torch.Tensor, out: Type) -> Val:
    """negate / abs of an integral value: the type's minimum has no
    positive counterpart and raises NUMERIC_VALUE_OUT_OF_RANGE
    (BigintOperators.negate, MathFunctions.abs)."""
    ok = a.data != int_range(a.type)[0]
    err = flag_err(a.valid & ~ok, E.NUMERIC_VALUE_OUT_OF_RANGE)
    return Val(torch.where(ok, data, 0), a.valid & ok, out, err=err)


@register("negate")
def _negate(args, out):
    (a,) = args
    if _is_long_dec(a.type):
        return Val(I.neg(a.data), a.valid, out)
    if T.is_integral(a.type):
        return _checked_sign_flip(a, -a.data, out)
    return Val(-a.data, a.valid, out)


@register("abs")
def _abs(args, out):
    (a,) = args
    if _is_long_dec(a.type):
        return Val(I.abs_(a.data), a.valid, out)
    if T.is_integral(a.type):
        return _checked_sign_flip(a, torch.abs(a.data), out)
    return Val(torch.abs(a.data), a.valid, out)


def _long_dec_compare(a: Val, b: Val, op: str) -> Val:
    """Compare when either side is a long decimal and both are exact
    numerics: rescale to the wider scale, compare limbs. Where the rescale
    would pass 38 digits (an extreme scale gap), compare float64 images."""
    da, db = T.exact_decimal(a.type), T.exact_decimal(b.type)
    pa, sa, pb, sb = da.precision, da.scale, db.precision, db.scale
    s = max(sa, sb)
    valid = a.valid & b.valid
    if max(pa + s - sa, pb + s - sb) > 38:
        fa = cast_val(a, T.DOUBLE).data
        fb = cast_val(b, T.DOUBLE).data
        return Val(_CMP[op](fa, fb), valid, T.BOOLEAN)
    xa, _ = _dec_limbs(a, s)
    xb, _ = _dec_limbs(b, s)
    data = {"eq": lambda: I.eq(xa, xb), "ne": lambda: ~I.eq(xa, xb),
            "lt": lambda: I.lt(xa, xb), "le": lambda: I.le(xa, xb),
            "gt": lambda: I.lt(xb, xa), "ge": lambda: I.le(xb, xa)}[op]()
    return Val(data, valid, T.BOOLEAN)


def _cmp(op):
    def impl(args: List[Val], out: Type) -> Val:
        a, b = args
        if a.type.is_string or b.type.is_string:
            return _string_compare(a, b, op)
        if (_is_long_dec(a.type) or _is_long_dec(b.type)) \
                and not (T.is_floating(a.type) or T.is_floating(b.type)):
            return _long_dec_compare(a, b, op)
        if a.type != b.type:
            a, b, _ = _unify_numeric(a, b)
        return Val(_CMP[op](a.data, b.data), a.valid & b.valid, T.BOOLEAN)
    return impl


for _name in ["eq", "ne", "lt", "le", "gt", "ge"]:
    register(_name)(_cmp(_name))


@register("not")
def _not(args, out):
    (a,) = args
    return Val(~a.data, a.valid, T.BOOLEAN)


# -- datetime ----------------------------------------------------------------

@register("date_add_days")
def _date_add_days(args, out):
    a, n = args
    return Val(a.data + n.data.to(a.data.dtype), a.valid & n.valid, out)


@register("date_add_months")
def _date_add_months(args, out):
    a, n = args
    y, m, d = _civil_from_days(a.data)
    months = y * 12 + (m - 1) + n.data.to(torch.int64)
    ny, nm = months // 12, months % 12 + 1
    # clamp day to the end of the target month
    dim_table = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                             dtype=torch.int64, device=a.data.device)
    leap = ((ny % 4 == 0) & (ny % 100 != 0)) | (ny % 400 == 0)
    dim = dim_table[nm - 1] + (leap & (nm == 2)).to(torch.int64)
    nd = torch.minimum(d, dim)
    return Val(_days_from_civil(ny, nm, nd).to(a.data.dtype),
               a.valid & n.valid, out)


@register("date_add_years")
def _date_add_years(args, out):
    a, n = args
    return _date_add_months([a, Val(n.data * 12, n.valid, n.type)], out)


def _date_part(part):
    def impl(args, out):
        (a,) = args
        days = (a.data if isinstance(a.type, T.DateType)
                else a.data // 86_400_000_000)
        y, m, d = _civil_from_days(days)
        val = {"year": y, "month": m, "day": d,
               "quarter": (m + 2) // 3}[part]
        return Val(val.to(torch.int64), a.valid, out)
    return impl


for _p in ["year", "month", "day", "quarter"]:
    register(_p)(_date_part(_p))


# -- strings (host tables over the vocabulary, one device gather) ------------

def _like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape is not None and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


@register("like")
def _like(args, out):
    a, pat = args[0], args[1]
    pattern = _string_literal_of(pat)
    if pattern is None:
        raise NotImplementedError("LIKE with non-constant pattern")
    escape = _string_literal_of(args[2]) if len(args) > 2 else None
    if a.dictionary is None:
        raise NotImplementedError("LIKE on non-dictionary column")
    rx = re.compile(_like_to_regex(pattern, escape), re.DOTALL)
    table = vocab_table(a.dictionary, lambda s: rx.fullmatch(s) is not None,
                        np.bool_, a.data.device)
    return Val(_code_gather(table, a.data), a.valid, T.BOOLEAN)


def _vocab_transform(fn):
    """String -> string function: transform the vocabulary, keep the codes
    (remapped where distinct inputs map to one output: equal strings must
    share one code, since grouping and joins compare codes)."""
    def impl(args, out):
        a = args[0]
        if a.dictionary is None:
            raise NotImplementedError("string fn on non-dictionary column")
        extra = []
        for x in args[1:]:
            if x.type.is_string:
                extra.append(_string_literal_of(x))
            elif x.literal is not None:
                extra.append(int(x.literal))
            else:
                raise NotImplementedError(
                    "string function positional args must be constants")
        entries = [fn(s, *extra) for s in a.dictionary]
        lookup: Dict[str, int] = {}
        vocab: List[str] = []
        remap = np.empty(len(entries) + 1, dtype=np.int32)
        for i, s in enumerate(entries):
            code = lookup.get(s)
            if code is None:
                code = lookup[s] = len(vocab)
                vocab.append(s)
            remap[i] = code
        remap[-1] = -1
        if len(vocab) == len(entries):
            return Val(a.data, a.valid, out, dictionary=tuple(entries))
        table = torch.from_numpy(remap).to(a.data.device)
        return Val(_code_gather(table, a.data), a.valid, out,
                   dictionary=tuple(vocab))
    return impl


register("lower")(_vocab_transform(lambda s: s.lower()))
register("upper")(_vocab_transform(lambda s: s.upper()))
register("trim")(_vocab_transform(lambda s: s.strip()))
def _substr(s: str, start: int, length: Optional[int] = None) -> str:
    """StringFunctions.substr over code points (a Python str's
    characters): ``start`` is 1-based, a negative start counts from the
    end, and a start of 0 or a length of 0 or below gives ''."""
    if start == 0 or (length is not None and length <= 0):
        return ""
    begin = start - 1 if start > 0 else start + len(s)
    if begin < 0:
        return ""
    return s[begin:] if length is None else s[begin:begin + length]


register("substr")(_vocab_transform(_substr))


@register("length")
def _length(args, out):
    (a,) = args
    if a.dictionary is None:
        raise NotImplementedError("length on non-dictionary column")
    table = vocab_table(a.dictionary, len, np.int64, a.data.device)
    return Val(_code_gather(table, a.data), a.valid, out)


@register("concat")
def _concat(args, out):
    lits = [_string_literal_of(v) for v in args]
    dyn = [i for i, s in enumerate(lits) if s is None]
    if not dyn:
        return Val.constant("".join(lits), out, args[0].data.shape[0],
                            args[0].data.device)
    if len(dyn) > 1:
        raise NotImplementedError("concat of multiple non-constant strings")
    i = dyn[0]
    a = args[i]
    if a.dictionary is None:
        raise NotImplementedError("concat on non-dictionary column")
    prefix, suffix = "".join(lits[:i]), "".join(lits[i + 1:])
    vocab = tuple(prefix + s + suffix for s in a.dictionary)
    valid = torch.stack([v.valid for v in args]).all(0)
    return Val(a.data, valid, out, vocab)


# -- math (reference operator/scalar/MathFunctions.java) ---------------------

def _dbl_fn(fn):
    def impl(args, out):
        a = cast_val(args[0], T.DOUBLE)
        return Val(fn(a.data), a.valid, out)
    return impl


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


for _name, _tfn in [
        ("sqrt", torch.sqrt), ("ln", torch.log), ("exp", torch.exp),
        ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
        ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
        ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
        ("log2", torch.log2), ("log10", torch.log10), ("cbrt", _cbrt),
        ("degrees", torch.rad2deg), ("radians", torch.deg2rad)]:
    register(_name)(_dbl_fn(_tfn))


def _long_dec_floor_ceil(a: Val, ceil: bool) -> torch.Tensor:
    """Exact floor/ceil to integer multiples of 10**scale for long
    decimals: drop the fraction digits by digit division, then bump toward
    -inf (floor of negatives) / +inf (ceil of positives) where any dropped
    digit was nonzero."""
    s = a.type.scale
    m = I.abs_(a.data)
    k = s
    rem_any = torch.zeros(a.data.shape[:-1], dtype=torch.bool,
                          device=a.data.device)
    while k > 0:
        step = min(k, 9)
        m, rr = I.divmod_small_abs(m, 10 ** step)
        rem_any = rem_any | (rr != 0)
        k -= step
    neg_in = I.is_neg(a.data)
    bump = (rem_any & (neg_in != ceil)).to(torch.int64)
    m = I.add(m, I.pack(torch.zeros_like(bump), bump))
    back, _ = I.rescale(I.where(neg_in, I.neg(m), m), s)
    return back


@register("floor")
def _floor(args, out):
    (a,) = args
    if _is_long_dec(a.type):
        return Val(_long_dec_floor_ceil(a, ceil=False), a.valid, out)
    if isinstance(a.type, T.DecimalType):
        div = 10 ** a.type.scale
        return Val(torch.div(a.data, div, rounding_mode="floor") * div,
                   a.valid, out)
    if T.is_integral(a.type):
        return Val(a.data, a.valid, out)
    return Val(torch.floor(a.data), a.valid, out)


@register("ceil")
def _ceil(args, out):
    (a,) = args
    if _is_long_dec(a.type):
        return Val(_long_dec_floor_ceil(a, ceil=True), a.valid, out)
    if isinstance(a.type, T.DecimalType):
        div = 10 ** a.type.scale
        return Val(-torch.div(-a.data, div, rounding_mode="floor") * div,
                   a.valid, out)
    if T.is_integral(a.type):
        return Val(a.data, a.valid, out)
    return Val(torch.ceil(a.data), a.valid, out)


@register("round")
def _round(args, out):
    a = args[0]
    digits = 0
    if len(args) > 1:
        if args[1].literal is None:
            raise NotImplementedError("round() with non-constant digits")
        digits = int(args[1].literal)
    if isinstance(a.type, T.DecimalType):
        if digits >= a.type.scale:
            return Val(a.data, a.valid, out)   # nothing to round away
        if _is_long_dec(a.type):
            x, _ = I.rescale(a.data, digits - a.type.scale)   # half up
            x, _ = I.rescale(x, a.type.scale - digits)
            return Val(x, a.valid, out)
        data = rescale_decimal(a.data, a.type.scale, digits)
        return Val(rescale_decimal(data, digits, a.type.scale), a.valid, out)
    scale = 10.0 ** digits
    x = a.data * scale
    return Val(torch.sign(x) * torch.floor(x.abs() + 0.5) / scale, a.valid,
               out)


@register("power")
def _power(args, out):
    a, b = (cast_val(x, T.DOUBLE) for x in args)
    return Val(torch.pow(a.data, b.data), a.valid & b.valid, out)


@register("atan2")
def _atan2(args, out):
    a, b = (cast_val(x, T.DOUBLE) for x in args)
    return Val(torch.atan2(a.data, b.data), a.valid & b.valid, out)


@register("log")
def _log(args, out):
    # log(b, x): base-b logarithm of x
    b, x = (cast_val(v, T.DOUBLE) for v in args)
    return Val(torch.log(x.data) / torch.log(b.data), b.valid & x.valid, out)


@register("sign")
def _sign(args, out):
    (a,) = args
    if _is_long_dec(a.type):
        return Val(I.sign(a.data).to(out.storage_dtype), a.valid, out)
    # a decimal input's output is decimal(1,0), so the raw -1/0/1 is
    # already scaled; doubles and integers keep their type
    return Val(torch.sign(a.data).to(out.storage_dtype), a.valid, out)


@register("truncate")
def _truncate(args, out):
    a = cast_val(args[0], T.DOUBLE)
    if len(args) == 1:
        return Val(torch.trunc(a.data), a.valid, out)
    if args[1].literal is None:
        raise NotImplementedError("truncate() scale must be a constant")
    scale = 10.0 ** int(args[1].literal)
    return Val(torch.trunc(a.data * scale) / scale, _all_valid(args), out)


@register("width_bucket")
def _width_bucket(args, out):
    x, lo, hi, n = (cast_val(v, T.DOUBLE) for v in args)
    frac = (x.data - lo.data) / (hi.data - lo.data)
    b = torch.floor(frac * n.data).to(torch.int64) + 1
    b = torch.minimum(b.clamp(min=0), n.data.to(torch.int64) + 1)
    return Val(b, _all_valid(args), out)


for _name, _tfn in [("is_nan", torch.isnan), ("is_finite", torch.isfinite),
                    ("is_infinite", torch.isinf)]:
    register(_name)(lambda args, out, f=_tfn: Val(
        f(cast_val(args[0], T.DOUBLE).data), args[0].valid, T.BOOLEAN))


def _variadic_extreme(is_max):
    def impl(args, out):
        # NULL if any argument is NULL (reference GreatestFunction)
        if out.is_string:
            # dictionary codes are insertion-ordered, not lexicographic
            raise NotImplementedError("greatest/least on varchar")
        vals = [cast_val(a, out) for a in args]
        data = vals[0].data
        for v in vals[1:]:
            data = (torch.maximum(data, v.data) if is_max
                    else torch.minimum(data, v.data))
        return Val(data, _all_valid(vals), out)
    return impl


register("greatest")(_variadic_extreme(True))
register("least")(_variadic_extreme(False))


# -- bitwise (reference operator/scalar/BitwiseFunctions.java) ---------------

def _bitwise(fn):
    def impl(args, out):
        vals = [cast_val(a, T.BIGINT) for a in args]
        return Val(fn(*[v.data for v in vals]), _all_valid(vals), out)
    return impl


def _shr_logical(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by n in [0, 64)."""
    mask = (torch.ones_like(n) << (64 - n).clamp(max=63)) - 1
    return torch.where(n == 0, a, (a >> n) & torch.where(n == 0, -1, mask))


register("bitwise_and")(_bitwise(torch.bitwise_and))
register("bitwise_or")(_bitwise(torch.bitwise_or))
register("bitwise_xor")(_bitwise(torch.bitwise_xor))
register("bitwise_not")(_bitwise(torch.bitwise_not))
register("bitwise_left_shift")(_bitwise(lambda a, n: a << n))
register("bitwise_right_shift")(_bitwise(_shr_logical))
register("bitwise_arithmetic_shift_right")(_bitwise(lambda a, n: a >> n))


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 bit patterns (SWAR with logical shifts)."""
    def shr(v, k):
        return (v >> k) & ((1 << (64 - k)) - 1)
    x = x - (shr(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (shr(x, 2) & 0x3333333333333333)
    x = (x + shr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return shr(x * 0x0101010101010101, 56)


@register("bit_count")
def _bit_count(args, out):
    a = cast_val(args[0], T.BIGINT)
    bits = 64
    if len(args) > 1:
        if args[1].literal is None:
            raise NotImplementedError("bit_count() bits must be a constant")
        bits = int(args[1].literal)
    data = a.data if bits == 64 else a.data & ((1 << bits) - 1)
    return Val(_popcount64(data), a.valid, out)


# -- vocabulary string functions (reference StringFunctions.java) ------------

def _const_args(args) -> List[object]:
    """The constant positional arguments of a string function."""
    extra = []
    for x in args:
        lit = _string_literal_of(x) if x.type.is_string else x.literal
        if lit is None:
            raise NotImplementedError(
                "string function positional args must be constants")
        extra.append(lit)
    return extra


def _vocab_transform_nullable(fn):
    """Like _vocab_transform, but fn may return None (SQL NULL): those
    entries clear validity, and the output vocabulary is deduplicated so
    equal strings share one code."""
    def impl(args, out):
        a = args[0]
        if a.dictionary is None:
            raise NotImplementedError("string fn on non-dictionary column")
        extra = _const_args(args[1:])
        lookup: Dict[str, int] = {}
        remap = np.full(len(a.dictionary) + 1, -1, dtype=np.int32)
        for i, s in enumerate(a.dictionary):
            r = fn(s, *extra)
            if r is not None:
                remap[i] = lookup.setdefault(r, len(lookup))
        codes = _code_gather(torch.from_numpy(remap).to(a.data.device),
                             a.data)
        return Val(codes, a.valid & (codes >= 0), out,
                   dictionary=tuple(lookup))
    return impl


def _vocab_table_fn(fn, dtype):
    """String -> bigint / boolean function via a host-computed table."""
    def impl(args, out):
        a = args[0]
        if a.dictionary is None:
            raise NotImplementedError("string fn on non-dictionary column")
        extra = _const_args(args[1:])
        table = vocab_table(a.dictionary, lambda s: fn(s, *extra), dtype,
                            a.data.device)
        return Val(_code_gather(table, a.data), a.valid,
                   T.BOOLEAN if dtype is np.bool_ else out)
    return impl


def _split_part(s: str, delim: str, idx: int) -> Optional[str]:
    if idx <= 0:
        # a constant index: raised at planning like Presto's
        # INVALID_FUNCTION_ARGUMENT for non-positive indexes
        raise E.QueryError(E.INVALID_FUNCTION_ARGUMENT,
                           "split_part index must be greater than zero")
    if not delim:
        return s if idx == 1 else None
    parts = s.split(delim)
    return parts[idx - 1] if idx <= len(parts) else None


def _levenshtein(s: str, t: str) -> int:
    if len(s) < len(t):
        s, t = t, s
    prev = list(range(len(t) + 1))
    for i, cs in enumerate(s, 1):
        cur = [i]
        for j, ct in enumerate(t, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (cs != ct)))
        prev = cur
    return prev[-1]


def _presto_replacement(repl: str) -> str:
    """Presto/Java replacement syntax -> a Python re.sub template: $n and
    ${name} are group references, \\$ is a literal dollar."""
    out = []
    i = 0
    while i < len(repl):
        c = repl[i]
        if c == "\\" and i + 1 < len(repl):
            nxt = repl[i + 1]
            out.append(nxt if nxt in ("$", "\\") else "\\" + nxt)
            i += 2
        elif c == "$" and i + 1 < len(repl):
            j = i + 1
            if repl[j] == "{":
                end = repl.index("}", j)
                out.append(f"\\g<{repl[j + 1:end]}>")
                i = end + 1
            elif repl[j].isdigit():
                while j < len(repl) and repl[j].isdigit():
                    j += 1
                out.append(f"\\g<{repl[i + 1:j]}>")
                i = j
            else:
                out.append("$")
                i += 1
        else:
            out.append("\\\\" if c == "\\" else c)
            i += 1
    return "".join(out)


def _json_extract_scalar(doc: str, path: str):
    """A small JSONPath: $.key and [idx] steps (the common Presto usage)."""
    try:
        v = json.loads(doc)
    except Exception:
        return None
    if not path.startswith("$"):
        return None
    i = 1
    while i < len(path):
        if path[i] == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            key = path[i + 1: j]
            if not isinstance(v, dict) or key not in v:
                return None
            v = v[key]
            i = j
        elif path[i] == "[":
            j = path.index("]", i)
            token = path[i + 1: j].strip("\"'")
            if isinstance(v, list):
                try:
                    v = v[int(token)]
                except (ValueError, IndexError):
                    return None
            elif isinstance(v, dict):
                if token not in v:
                    return None
                v = v[token]
            else:
                return None
            i = j + 1
        else:
            return None
    if isinstance(v, (dict, list)) or v is None:
        return None      # scalar extraction only
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _url_part(part):
    def get(s: str) -> str:
        try:
            u = urlparse(s)
        except Exception:
            return ""
        return {"protocol": u.scheme, "host": u.hostname or "",
                "path": u.path, "query": u.query,
                "fragment": u.fragment}[part]
    return get


def _url_port(s: str) -> int:
    try:
        p = urlparse(s).port
    except Exception:
        p = None
    return -1 if p is None else p


# varbinary bridge (reference VarbinaryFunctions.java): the dictionary
# plan carries bytes vocabularies the same way as strings
register("to_utf8")(_vocab_transform(
    lambda s: s.encode("utf-8") if isinstance(s, str) else s))
register("from_utf8")(_vocab_transform(
    lambda s: s.decode("utf-8", "replace")
    if isinstance(s, (bytes, bytearray)) else s))
register("replace")(_vocab_transform(
    lambda s, find, repl="": s.replace(find, repl)))
register("reverse")(_vocab_transform(lambda s: s[::-1]))
register("lpad")(_vocab_transform(
    lambda s, n, pad=" ": s[:n] if len(s) >= n
    else ((pad * n)[: n - len(s)] + s if pad else s)))
register("rpad")(_vocab_transform(
    lambda s, n, pad=" ": s[:n] if len(s) >= n
    else (s + (pad * n)[: n - len(s)] if pad else s)))
register("ltrim")(_vocab_transform(lambda s: s.lstrip()))
register("rtrim")(_vocab_transform(lambda s: s.rstrip()))
register("split_part")(_vocab_transform_nullable(_split_part))
register("strpos")(_vocab_table_fn(lambda s, sub: s.find(sub) + 1, np.int64))
register("codepoint")(_vocab_table_fn(lambda s: ord(s[0]) if s else 0,
                                      np.int64))
register("levenshtein_distance")(_vocab_table_fn(_levenshtein, np.int64))
register("starts_with")(_vocab_table_fn(lambda s, p: s.startswith(p),
                                        np.bool_))
register("ends_with")(_vocab_table_fn(lambda s, p: s.endswith(p), np.bool_))
# translate(): chars of `from` map positionally to `to`; unmatched delete
register("translate")(_vocab_transform(
    lambda s, frm, to: s.translate(
        {ord(c): (to[i] if i < len(to) else None)
         for i, c in enumerate(frm)})))
# as in the reference, unequal lengths count their difference (the
# vocabulary-table evaluation has no per-entry error channel)
register("hamming_distance")(_vocab_table_fn(
    lambda s, t: sum(a != b for a, b in zip(s, t)) + abs(len(s) - len(t)),
    np.int64))
# regex: host-compiled over the vocabulary (reference
# JoniRegexpFunctions.java); patterns must be constants
register("regexp_like")(_vocab_table_fn(
    lambda s, pat: re.search(pat, s) is not None, np.bool_))
register("regexp_extract")(_vocab_transform_nullable(
    lambda s, pat, group=0: (
        (lambda m: m.group(group) if m else None)(re.search(pat, s)))))
register("regexp_replace")(_vocab_transform(
    lambda s, pat, repl="": re.sub(pat, _presto_replacement(repl), s)))
register("json_extract_scalar")(
    _vocab_transform_nullable(_json_extract_scalar))
for _p in ["protocol", "host", "path", "query", "fragment"]:
    register(f"url_extract_{_p}")(_vocab_transform(_url_part(_p)))


@register("url_extract_port")
def _url_extract_port(args, out):
    a = args[0]
    if a.dictionary is None:
        raise NotImplementedError("url fn on non-dictionary column")
    vals = _code_gather(vocab_table(a.dictionary, _url_port, np.int64,
                                    a.data.device), a.data)
    return Val(vals, a.valid & (vals >= 0), out)


# -- more datetime (reference operator/scalar/DateTimeFunctions.java) --------

_US_DAY = 86_400_000_000
_US_PER = {"millisecond": 1_000, "second": 1_000_000,
           "minute": 60_000_000, "hour": 3_600_000_000,
           "day": _US_DAY, "week": 7 * _US_DAY}


def _to_micros(v: Val) -> torch.Tensor:
    if isinstance(v.type, T.DateType):
        return v.data.to(torch.int64) * _US_DAY
    return v.data.to(torch.int64)


def _days_of(a: Val) -> torch.Tensor:
    if isinstance(a.type, T.DateType):
        return a.data.to(torch.int64)
    return torch.div(a.data, _US_DAY, rounding_mode="floor")


def _jan1(y: torch.Tensor) -> torch.Tensor:
    return _days_from_civil(y, torch.ones_like(y), torch.ones_like(y))


@register("day_of_week")
def _day_of_week(args, out):
    (a,) = args
    # ISO: Monday=1..Sunday=7; 1970-01-01 was a Thursday (=4)
    return Val((_days_of(a) + 3) % 7 + 1, a.valid, out)


@register("day_of_year")
def _day_of_year(args, out):
    (a,) = args
    days = _days_of(a)
    y, _, _ = _civil_from_days(days)
    return Val(days - _jan1(y) + 1, a.valid, out)


def _iso_week(days: torch.Tensor):
    """ISO-8601 (week, week-year), branch-free."""
    y, _, _ = _civil_from_days(days)
    doy = days - _jan1(y) + 1
    isodow = (days + 3) % 7 + 1

    def weeks_in(year):
        # 53-week years: Jan 1 is a Thursday, or a leap year's Wednesday
        dow1 = (_jan1(year) + 3) % 7 + 1
        leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
        return torch.where((dow1 == 4) | (leap & (dow1 == 3)), 53, 52)

    w = torch.div(doy - isodow + 10, 7, rounding_mode="floor")
    wy = weeks_in(y)
    week = torch.where(w < 1, weeks_in(y - 1), torch.where(w > wy, 1, w))
    wyear = torch.where(w < 1, y - 1, torch.where(w > wy, y + 1, y))
    return week, wyear


@register("week")
def _week(args, out):
    (a,) = args
    return Val(_iso_week(_days_of(a))[0].to(torch.int64), a.valid, out)


@register("year_of_week")
def _year_of_week(args, out):
    (a,) = args
    return Val(_iso_week(_days_of(a))[1].to(torch.int64), a.valid, out)


def _time_part(part):
    div = {"hour": 3_600_000_000, "minute": 60_000_000,
           "second": 1_000_000, "millisecond": 1_000}[part]
    mod = {"hour": 24, "minute": 60, "second": 60, "millisecond": 1000}[part]

    def impl(args, out):
        (a,) = args
        us = torch.div(_to_micros(a), div, rounding_mode="floor")
        return Val(us % mod, a.valid, out)
    return impl


for _p in ["hour", "minute", "second", "millisecond"]:
    register(_p)(_time_part(_p))


def _unit_of(v: Val, fn: str) -> str:
    unit = _string_literal_of(v)
    if unit is None:
        raise NotImplementedError(f"{fn} needs a constant unit")
    return unit.lower()


@register("date_trunc")
def _date_trunc(args, out):
    unit_v, a = args
    unit = _unit_of(unit_v, "date_trunc")
    is_date = isinstance(a.type, T.DateType)
    days = _days_of(a)
    if unit in ("millisecond", "second", "minute", "hour"):
        if is_date:
            return Val(a.data, a.valid, out)
        q = _US_PER[unit]
        return Val(torch.div(a.data, q, rounding_mode="floor") * q,
                   a.valid, out)
    if unit == "day":
        td = days
    elif unit == "week":
        td = days - ((days + 3) % 7)          # back to Monday
    elif unit in ("month", "quarter", "year"):
        y, m, _ = _civil_from_days(days)
        if unit == "month":
            tm = m
        elif unit == "quarter":
            tm = torch.div(m - 1, 3, rounding_mode="floor") * 3 + 1
        else:
            tm = torch.ones_like(m)
        td = _days_from_civil(y, tm, torch.ones_like(m))
    else:
        raise NotImplementedError(f"date_trunc({unit!r})")
    if is_date:
        return Val(td.to(a.data.dtype), a.valid, out)
    return Val(td * _US_DAY, a.valid, out)


def _trunc_div(x: torch.Tensor, q: int) -> torch.Tensor:
    return torch.sign(x) * torch.div(x.abs(), q, rounding_mode="floor")


@register("date_diff")
def _date_diff(args, out):
    unit_v, a, b = args
    unit = _unit_of(unit_v, "date_diff")
    valid = a.valid & b.valid
    if unit in _US_PER:
        return Val(_trunc_div(_to_micros(b) - _to_micros(a), _US_PER[unit]),
                   valid, out)
    ya, ma, dda = _civil_from_days(
        torch.div(_to_micros(a), _US_DAY, rounding_mode="floor"))
    yb, mb, ddb = _civil_from_days(
        torch.div(_to_micros(b), _US_DAY, rounding_mode="floor"))
    months = (yb * 12 + mb) - (ya * 12 + ma)
    # complete months only (Joda monthsBetween semantics)
    months = months - ((months > 0) & (ddb < dda)).to(torch.int64) \
        + ((months < 0) & (ddb > dda)).to(torch.int64)
    if unit == "month":
        val = months
    elif unit == "quarter":
        val = _trunc_div(months, 3)
    elif unit == "year":
        val = _trunc_div(months, 12)
    else:
        raise NotImplementedError(f"date_diff({unit!r})")
    return Val(val, valid, out)


@register("date_add")
def _date_add(args, out):
    unit_v, n, a = args
    unit = _unit_of(unit_v, "date_add")
    valid = a.valid & n.valid
    is_date = isinstance(a.type, T.DateType)
    if unit in ("month", "quarter", "year"):
        mult = {"month": 1, "quarter": 3, "year": 12}[unit]
        days = _days_of(a)
        shifted = _date_add_months(
            [Val(days, a.valid, T.DATE),
             Val(n.data.to(torch.int64) * mult, n.valid, n.type)], T.DATE)
        if is_date:
            return Val(shifted.data.to(a.data.dtype), valid, out)
        return Val(shifted.data * _US_DAY + a.data % _US_DAY, valid, out)
    q = _US_PER.get(unit)
    if q is None:
        raise NotImplementedError(f"date_add({unit!r})")
    if is_date:
        if unit in ("day", "week"):
            return Val(a.data + (n.data * (q // _US_DAY)).to(a.data.dtype),
                       valid, out)
        raise NotImplementedError("date_add of sub-day unit to a DATE")
    return Val(a.data + n.data.to(torch.int64) * q, valid, out)


@register("last_day_of_month")
def _last_day_of_month(args, out):
    (a,) = args
    y, m, _ = _civil_from_days(_days_of(a))
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, 1, m + 1)
    td = _days_from_civil(ny, nm, torch.ones_like(m)) - 1
    return Val(td.to(torch.int32), a.valid, out)


@register("from_unixtime")
def _from_unixtime(args, out):
    a = cast_val(args[0], T.DOUBLE)
    return Val((a.data * 1_000_000.0).to(torch.int64), a.valid, out)


@register("to_unixtime")
def _to_unixtime(args, out):
    (a,) = args
    return Val(_to_micros(a).to(torch.float64) / 1_000_000.0, a.valid, out)


def infer_call_type(name: str, arg_types: List[Type]) -> Type:
    """Return type inference for scalar calls (used by the analyzer;
    FunctionRegistry.resolveFunction's role for the builtins)."""
    if name in ("eq", "ne", "lt", "le", "gt", "ge", "not", "like"):
        return T.BOOLEAN
    if name in ("add", "subtract", "multiply", "divide", "modulus"):
        a, b = arg_types
        if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
            # Presto's decimal operator signatures (reference
            # type/DecimalOperators.java), precision saturating at 38;
            # an integral operand counts as the decimal it coerces to
            if T.is_floating(a) or T.is_floating(b):
                return T.DOUBLE
            # (an untyped NULL counts as bigint's decimal(19,0))
            exact = [t if T.is_integral(t) or isinstance(t, T.DecimalType)
                     else T.BIGINT for t in (a, b)]
            da, db = (T.exact_decimal(t) for t in exact)
            pa, sa, pb, sb = da.precision, da.scale, db.precision, db.scale
            s = max(sa, sb)
            if name == "multiply":
                return T.DecimalType(min(38, pa + pb), min(38, sa + sb))
            if name == "divide":
                p = min(38, pa + sb + max(0, sb - sa))
                return T.DecimalType(max(p, s), s)
            if name == "modulus":
                return T.DecimalType(min(pa - sa, pb - sb) + s, s)
            p = min(38, max(pa - sa, pb - sb) + s + 1)
            return T.DecimalType(p, s)
        t = T.common_super_type(a, b)
        if t is None or isinstance(t, T.DateType):
            # Presto has no arithmetic operator over two dates
            raise TypeError(f"{name}({a.display()}, {b.display()})")
        return t
    if name == "negate" or name == "abs":
        return arg_types[0]
    if name == "sign":
        if isinstance(arg_types[0], T.DecimalType):
            return T.DecimalType(1, 0)
        return arg_types[0]
    if name in ("sqrt", "ln", "exp", "power", "sin", "cos", "tan", "asin",
                "acos", "atan", "atan2", "sinh", "cosh", "tanh", "log2",
                "log10", "log", "cbrt", "degrees", "radians", "truncate",
                "to_unixtime"):
        return T.DOUBLE
    if name in ("floor", "ceil", "round"):
        return arg_types[0]
    if name in ("year", "month", "day", "quarter", "day_of_week",
                "day_of_year", "week", "year_of_week", "hour", "minute",
                "second", "millisecond", "date_diff", "width_bucket",
                "strpos", "codepoint", "levenshtein_distance",
                "hamming_distance", "bit_count",
                "url_extract_port", "bitwise_and", "bitwise_or",
                "bitwise_xor", "bitwise_not", "bitwise_left_shift",
                "bitwise_right_shift", "bitwise_arithmetic_shift_right"):
        return T.BIGINT
    if name in ("is_nan", "is_finite", "is_infinite", "starts_with",
                "ends_with", "regexp_like"):
        return T.BOOLEAN
    if name in ("greatest", "least"):
        out = arg_types[0]
        for t in arg_types[1:]:
            nxt = T.common_super_type(out, t)
            if nxt is None:
                raise TypeError(f"{name} args have incompatible types")
            out = nxt
        return out
    if name in ("date_add_days", "date_add_months", "date_add_years"):
        return arg_types[0]
    if name == "date_trunc":
        return arg_types[1]
    if name == "date_add":
        return arg_types[2]
    if name == "last_day_of_month":
        return T.DATE
    if name == "from_unixtime":
        return T.TIMESTAMP
    if name in ("lower", "upper", "trim", "ltrim", "rtrim", "substr",
                "translate",
                "concat", "replace", "reverse", "lpad", "rpad", "split_part",
                "regexp_extract", "regexp_replace", "json_extract_scalar",
                "url_extract_protocol", "url_extract_host",
                "url_extract_path", "url_extract_query",
                "url_extract_fragment"):
        return T.VARCHAR
    if name == "length":
        return T.BIGINT
    if name == "to_utf8":
        return T.VARBINARY
    if name == "from_utf8":
        return T.VARCHAR
    if name in _EXTERNAL_SIGNATURES:
        return _EXTERNAL_SIGNATURES[name](list(arg_types))
    raise KeyError(f"unknown function {name!r}")
