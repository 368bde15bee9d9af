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

Ported so far: arithmetic (short decimals, integers, doubles), compares
(numeric, date, dictionary strings), NOT, casts, date plus
day/month/year intervals, the date parts year/month/day/quarter, LIKE
(with an escape), and the vocabulary string functions lower, upper,
trim, substr, length and concat. Every other builtin the analyzer knows
raises NotImplementedError naming itself when evaluated.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import errors as E
from .. import types as T
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
        if isinstance(typ, (T.ArrayType, T.MapType, T.RowType)):
            raise NotImplementedError(f"{typ.display()} constants are not ported")
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


def _long_dec_unported(what: str):
    return NotImplementedError(f"long decimal {what} is not ported")


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


def cast_val(v: Val, to: Type) -> Val:
    """CAST implementation (reference operator/scalar casts per type)."""
    f = v.type
    if f == to:
        return v
    if isinstance(f, T.UnknownType):
        # typed NULL: all-invalid storage of the target type
        n = v.data.shape[0]
        if isinstance(to, (T.ArrayType, T.MapType, T.RowType)):
            raise NotImplementedError(f"cast NULL to {to.display()}")
        width = getattr(to, "storage_width", None)
        shape = (n,) if width is None else (n, width)
        return Val(torch.zeros(shape, dtype=to.storage_dtype,
                               device=v.data.device),
                   torch.zeros_like(v.valid), to,
                   dictionary=() if to.is_string else None, err=v.err)
    data = v.data
    if _is_long_dec(f) or _is_long_dec(to):
        raise _long_dec_unported(f"cast {f.display()} -> {to.display()}")
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
            scaled = data.to(torch.float64) * (10.0 ** to.scale)
            return Val(_round_half_away(scaled).to(torch.int64), v.valid, to)
    if T.is_integral(to) or isinstance(to, T.BigintType):
        if T.is_floating(f):
            # Presto DoubleOperators.castToLong: Math.round = half-up
            return Val(torch.floor(data + 0.5).to(to.storage_dtype),
                       v.valid, to)
        if isinstance(f, T.DecimalType):
            return Val(rescale_decimal(data, f.scale, 0).to(to.storage_dtype),
                       v.valid, to)
        if T.is_integral(f) or isinstance(f, T.BooleanType):
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


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def lookup(name: str) -> FunctionImpl:
    if name in _REGISTRY:
        return _REGISTRY[name]
    try:
        infer_call_type(name, [])
    except KeyError:
        raise KeyError(f"unknown function {name!r}")
    except (TypeError, ValueError, IndexError):
        pass
    raise NotImplementedError(f"function {name} is not ported")


def _arith(op):
    def impl(args: List[Val], out: Type) -> Val:
        a, b = args
        valid = a.valid & b.valid
        if isinstance(out, T.DecimalType) and (
                out.is_long or _is_long_dec(a.type) or _is_long_dec(b.type)):
            raise _long_dec_unported(op)
        if isinstance(out, T.DecimalType):
            s_out = out.scale
            sa = a.type.scale if isinstance(a.type, T.DecimalType) else 0
            sb = b.type.scale if isinstance(b.type, T.DecimalType) else 0
            da = a.data.to(torch.int64)
            db = b.data.to(torch.int64)
            if op == "mul":
                data = rescale_decimal(da * db, sa + sb, s_out)
            elif op == "div":
                num = rescale_decimal(da, sa, s_out + sb)
                den = torch.where(db == 0, 1, db)
                q = num.to(torch.float64) / den.to(torch.float64)
                data = (torch.sign(q) * torch.floor(
                    num.abs().to(torch.float64) / den.abs().to(torch.float64)
                    + 0.5)).to(torch.int64)
                err = flag_err(valid & (db == 0), E.DIVISION_BY_ZERO)
                return Val(data, valid & (db != 0), out, err=err)
            elif op == "mod":
                sc = max(sa, sb)
                da2 = rescale_decimal(da, sa, sc)
                db2 = rescale_decimal(db, sb, sc)
                den = torch.where(db2 == 0, 1, db2)
                data = torch.sign(da2) * (da2.abs() % den.abs())
                err = flag_err(valid & (db2 == 0), E.DIVISION_BY_ZERO)
                return Val(data, valid & (db2 != 0), out, err=err)
            else:
                da2 = rescale_decimal(da, sa, s_out)
                db2 = rescale_decimal(db, sb, s_out)
                data = da2 + db2 if op == "add" else da2 - db2
            return Val(data, valid, out)
        a2, b2 = cast_val(a, out), cast_val(b, out)
        da, db = a2.data, b2.data
        if op == "add":
            data = da + db
        elif op == "sub":
            data = da - db
        elif op == "mul":
            data = da * db
        elif op == "div":
            if T.is_integral(out):
                den = torch.where(db == 0, 1, db)
                # SQL integer division truncates toward zero
                data = (torch.sign(da) * torch.sign(den)) * (da.abs() // den.abs())
                err = flag_err(valid & (db == 0), E.DIVISION_BY_ZERO)
                return Val(data, valid & (db != 0), out, err=err)
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


@register("negate")
def _negate(args, out):
    (a,) = args
    if _is_long_dec(a.type):
        raise _long_dec_unported("negate")
    return Val(-a.data, a.valid, out)


def _cmp(op):
    def impl(args: List[Val], out: Type) -> Val:
        a, b = args
        if a.type.is_string or b.type.is_string:
            return _string_compare(a, b, op)
        if _is_long_dec(a.type) or _is_long_dec(b.type):
            raise _long_dec_unported(op)
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
# SQL substr is 1-based
register("substr")(_vocab_transform(
    lambda s, start, length=None: s[start - 1: start - 1 + length]
    if length is not None else s[start - 1:]))


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


def infer_call_type(name: str, arg_types: List[Type]) -> Type:
    """Return type inference for scalar calls (used by the analyzer); a
    copy of the reference package's table, so the analyzer types every
    builtin even where evaluation is not ported yet."""
    if name in ("eq", "ne", "lt", "le", "gt", "ge", "not", "like"):
        return T.BOOLEAN
    if name in ("add", "subtract", "multiply", "divide", "modulus"):
        a, b = arg_types
        if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
            # Presto's decimal operator signatures (reference
            # type/DecimalOperators.java), precision saturating at 38
            sa = a.scale if isinstance(a, T.DecimalType) else 0
            pa = a.precision if isinstance(a, T.DecimalType) else 19
            sb = b.scale if isinstance(b, T.DecimalType) else 0
            pb = b.precision if isinstance(b, T.DecimalType) else 19
            if T.is_floating(a) or T.is_floating(b):
                return T.DOUBLE
            if name == "multiply":
                return T.DecimalType(min(38, pa + pb), min(38, sa + sb))
            if name == "divide":
                s = max(sa, sb)
                p = min(38, pa + sb + max(0, sb - sa))
                return T.DecimalType(max(p, s), s)
            s = max(sa, sb)
            p = min(38, max(pa - sa, pb - sb) + s + 1)
            return T.DecimalType(p, s)
        t = T.common_super_type(a, b)
        if t is None:
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
    raise KeyError(f"unknown function {name!r}")
