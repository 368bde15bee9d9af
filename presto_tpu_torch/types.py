"""SQL type system of the PyTorch port (``presto_tpu/types.py``'s
counterpart: the same types, with ``storage_dtype`` returning torch
dtypes).

Conceptual parity with Presto's type layer (reference:
presto-spi/src/main/java/io/prestosql/spi/type/ and
presto-main/src/main/java/io/prestosql/type/InternalTypeManager.java), but
designed around fixed-width device storage: every SQL type maps to a
fixed-width dtype so columns are flat tensors.

Storage mapping:
  BOOLEAN     -> bool_
  TINYINT     -> int8   (stored as int32 on device)
  SMALLINT    -> int16  (stored int32)
  INTEGER     -> int32
  BIGINT      -> int64
  DOUBLE      -> float64
  REAL        -> float32
  DECIMAL(p<=18, s) -> int64 scaled by 10**s  (Presto's "short decimal",
                       reference spi/type/DecimalType.java)
  DATE        -> int32 days since epoch
  TIMESTAMP   -> int64 microseconds since epoch
  VARCHAR/CHAR -> int32 dictionary codes + host-side vocabulary
                  (strings never live on device as bytes; mirrors
                  DictionaryBlock, reference spi/block/DictionaryBlock.java)

Null handling is out-of-band: a per-column boolean validity mask (see
batch.Column), like Presto's per-Block isNull arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Type:
    """Base class for SQL types."""

    #: canonical lowercase SQL name, e.g. "bigint"
    name: ClassVar[str] = "unknown"

    @property
    def storage_dtype(self):
        raise NotImplementedError

    @property
    def is_string(self) -> bool:
        return False

    @property
    def is_orderable(self) -> bool:
        return True

    @property
    def is_comparable(self) -> bool:
        return True

    def display(self) -> str:
        return self.name

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.display()

    # -- value conversion ---------------------------------------------------
    def to_storage(self, value: Any):
        """Convert a python literal to its device storage representation."""
        return value

    def from_storage(self, value: Any):
        """Convert a device storage value back to a python value."""
        return value

    def null_storage(self):
        """Padding value used in storage slots whose validity bit is off."""
        return 0


@dataclasses.dataclass(frozen=True)
class BooleanType(Type):
    name: ClassVar[str] = "boolean"

    @property
    def storage_dtype(self):
        return torch.bool

    def null_storage(self):
        return False


@dataclasses.dataclass(frozen=True)
class IntegerLikeType(Type):
    @property
    def storage_dtype(self):
        return torch.int32


@dataclasses.dataclass(frozen=True)
class TinyintType(IntegerLikeType):
    name: ClassVar[str] = "tinyint"


@dataclasses.dataclass(frozen=True)
class SmallintType(IntegerLikeType):
    name: ClassVar[str] = "smallint"


@dataclasses.dataclass(frozen=True)
class IntegerType(IntegerLikeType):
    name: ClassVar[str] = "integer"


@dataclasses.dataclass(frozen=True)
class BigintType(Type):
    name: ClassVar[str] = "bigint"

    @property
    def storage_dtype(self):
        return torch.int64


@dataclasses.dataclass(frozen=True)
class DoubleType(Type):
    """IEEE double."""

    name: ClassVar[str] = "double"

    @property
    def storage_dtype(self):
        return torch.float64

    def null_storage(self):
        return 0.0


@dataclasses.dataclass(frozen=True)
class RealType(Type):
    name: ClassVar[str] = "real"

    @property
    def storage_dtype(self):
        return torch.float32

    def null_storage(self):
        return 0.0


@dataclasses.dataclass(frozen=True)
class DecimalType(Type):
    """DECIMAL(p, s): unscaled-integer storage scaled by 10**scale.

    p <= 18 ("short") stores one i64 per value; p in 19..38 ("long")
    stores a two-limb [capacity, 2] i64 tile — value = hi * 2**64 +
    (lo mod 2**64), the TPU-columnar shape of the reference's Int128
    (reference spi/type/DecimalType.java MAX_PRECISION = 38,
    spi/block/Int128ArrayBlock.java; limb arithmetic in ops/int128.py).
    """

    precision: int = 18
    scale: int = 0
    name: ClassVar[str] = "decimal"

    def __post_init__(self):
        if not (1 <= self.precision <= 38):
            raise ValueError(f"unsupported decimal precision {self.precision}")
        if not (0 <= self.scale <= self.precision):
            raise ValueError(f"bad decimal scale {self.scale}")

    @property
    def is_long(self) -> bool:
        return self.precision > 18

    @property
    def storage_dtype(self):
        return torch.int64

    @property
    def storage_width(self):
        # None (absent) for short decimals keeps their 1-D columns
        return 2 if self.is_long else None

    def display(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def null_storage(self):
        return (0, 0) if self.is_long else 0

    def to_storage(self, value: Any):
        # round-half-up like Presto's Decimals.encodeScaledValue
        import decimal
        from decimal import Decimal, ROUND_HALF_UP

        with decimal.localcontext() as ctx:
            ctx.prec = 60                   # enough for 38-digit values
            d = Decimal(str(value)).quantize(
                Decimal(1).scaleb(-self.scale), rounding=ROUND_HALF_UP
            )
            unscaled = int(d.scaleb(self.scale))
        if abs(unscaled) >= 10 ** self.precision:
            raise ValueError(
                f"value {value!r} out of range for {self.display()}"
            )
        if self.is_long:
            return _limbs_of(unscaled)
        return unscaled

    def from_storage(self, value: Any):
        import decimal
        from decimal import Decimal

        with decimal.localcontext() as ctx:
            ctx.prec = 60
            if self.is_long:
                h, l = (int(value[0]), int(value[1]))
                if h == -(1 << 63) and l == 1:
                    # ops/int128.py OVERFLOW_SENTINEL: a decimal
                    # aggregate exceeded 38 digits (deferred raise,
                    # reference DecimalSumAggregation overflow throw)
                    from .errors import NUMERIC_VALUE_OUT_OF_RANGE, QueryError
                    raise QueryError(
                        NUMERIC_VALUE_OUT_OF_RANGE,
                        "decimal aggregate overflowed 38 digits")
                unscaled = (h << 64) + (l & ((1 << 64) - 1))
                if unscaled >= 1 << 127:
                    unscaled -= 1 << 128
                return Decimal(unscaled).scaleb(-self.scale)
            return Decimal(int(value)).scaleb(-self.scale)


@dataclasses.dataclass(frozen=True)
class DateType(Type):
    """Days since 1970-01-01 (matches Presto DateType semantics)."""

    name: ClassVar[str] = "date"

    @property
    def storage_dtype(self):
        return torch.int32

    def to_storage(self, value: Any) -> int:
        import datetime

        if isinstance(value, (int, np.integer)):
            return int(value)
        if isinstance(value, str):
            value = datetime.date.fromisoformat(value)
        if isinstance(value, datetime.date):
            return (value - datetime.date(1970, 1, 1)).days
        raise TypeError(f"cannot convert {value!r} to date")

    def from_storage(self, value: Any):
        import datetime

        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(value))


@dataclasses.dataclass(frozen=True)
class TimestampType(Type):
    """Microseconds since epoch."""

    name: ClassVar[str] = "timestamp"

    @property
    def storage_dtype(self):
        return torch.int64

    def to_storage(self, value: Any) -> int:
        import datetime

        if isinstance(value, (int, np.integer)):
            return int(value)
        if isinstance(value, str):
            s = value.strip().replace("T", " ")
            value = datetime.datetime.fromisoformat(s)
        if isinstance(value, datetime.datetime):
            epoch = datetime.datetime(1970, 1, 1)
            return round((value - epoch).total_seconds() * 1_000_000)
        if isinstance(value, datetime.date):
            return (value - datetime.date(1970, 1, 1)).days * 86_400_000_000
        raise TypeError(f"cannot convert {value!r} to timestamp")

    def from_storage(self, value: Any):
        import datetime

        return (datetime.datetime(1970, 1, 1)
                + datetime.timedelta(microseconds=int(value)))


@dataclasses.dataclass(frozen=True)
class VarcharType(Type):
    """Dictionary-encoded string: int32 codes into a host-side vocabulary."""

    length: Optional[int] = None  # None = unbounded
    name: ClassVar[str] = "varchar"

    @property
    def storage_dtype(self):
        return torch.int32

    @property
    def is_string(self) -> bool:
        return True

    def display(self) -> str:
        return "varchar" if self.length is None else f"varchar({self.length})"

    def null_storage(self):
        return -1


@dataclasses.dataclass(frozen=True)
class CharType(Type):
    length: int = 1
    name: ClassVar[str] = "char"

    @property
    def storage_dtype(self):
        return torch.int32

    @property
    def is_string(self) -> bool:
        return True

    def display(self) -> str:
        return f"char({self.length})"

    def null_storage(self):
        return -1


@dataclasses.dataclass(frozen=True)
class VarbinaryType(Type):
    """Binary strings, dictionary-encoded like varchar: int32 codes into
    a host-side vocabulary of bytes values (reference
    spi/type/VarbinaryType.java; the device representation reuses the
    string plan — binary payloads are metadata-heavy, compute-light)."""

    name: ClassVar[str] = "varbinary"

    @property
    def storage_dtype(self):
        return torch.int32

    @property
    def is_string(self) -> bool:
        return True

    def display(self) -> str:
        return "varbinary"

    def null_storage(self):
        return -1


@dataclasses.dataclass(frozen=True)
class ArrayType(Type):
    """ARRAY(T): padded dense device representation (reference
    spi/type/ArrayType.java + block/ArrayBlock.java's offsets+values,
    re-designed TPU-first as a [capacity, max_len] tile + per-row lengths
    so every array op is a static-shape vectorized 2D kernel).

    Column layout for an array column: ``data`` is the tuple
    (values[cap, L], lengths[cap] int32, elem_valid[cap, L] bool);
    ``validity`` stays the row-level null mask; ``dictionary`` holds the
    element vocabulary when the element type is a string."""

    element: Type = None  # type: ignore[assignment]
    name: ClassVar[str] = "array"

    @property
    def storage_dtype(self):
        return self.element.storage_dtype

    def display(self) -> str:
        return f"array({self.element.display()})"


@dataclasses.dataclass(frozen=True)
class MapType(Type):
    """MAP(K, V): padded dense like ArrayType. Column ``data`` is
    (keys[cap, L], values[cap, L], lengths[cap], val_valid[cap, L]);
    keys are never null (SQL map semantics). ``dictionary`` is the tuple
    (key_vocab, value_vocab) when either side is a string (reference
    spi/type/MapType.java + block/MapBlock.java)."""

    key: Type = None      # type: ignore[assignment]
    value: Type = None    # type: ignore[assignment]
    name: ClassVar[str] = "map"

    @property
    def storage_dtype(self):
        return self.value.storage_dtype

    def display(self) -> str:
        return f"map({self.key.display()}, {self.value.display()})"


@dataclasses.dataclass(frozen=True)
class HllStateType(Type):
    """HyperLogLog register-vector state for approx_distinct partials
    (reference presto-main/.../operator/aggregation/state/
    HyperLogLogState.java + airlift HyperLogLog). Column ``data`` is a
    dense i32 tile [capacity, m] of per-bucket max-rank registers — a
    fixed-width vector per group, so partial states merge with one
    vectorized segment_max and ship through exchanges as ordinary
    fixed-width columns (``storage_width`` tells the wire format the
    trailing dimension)."""

    m: int = 2048
    name: ClassVar[str] = "hllstate"

    @property
    def storage_dtype(self):
        return torch.int32

    @property
    def storage_width(self) -> int:
        return self.m

    def display(self) -> str:
        return f"hllstate({self.m})"


@dataclasses.dataclass(frozen=True)
class QdigestStateType(Type):
    """Quantile-histogram state for approx_percentile partials
    (reference presto-main/.../operator/aggregation/state/
    DigestAndPercentileState.java + airlift QuantileDigest). Column
    ``data`` is a dense i64 tile [capacity, bins] of log-linear bin
    counts (ops/sketch.py qd_*): fixed-size regardless of input rows,
    merged with one vector add, shipped through exchanges as an
    ordinary fixed-width column. ``bins`` must equal ops/sketch.py
    QD_BINS (the layout constant lives there; callers pass it in)."""

    bins: int
    name: ClassVar[str] = "qdigeststate"

    @property
    def storage_dtype(self):
        return torch.int64

    @property
    def storage_width(self) -> int:
        return self.bins

    def display(self) -> str:
        return f"qdigeststate({self.bins})"


@dataclasses.dataclass(frozen=True)
class RowType(Type):
    """ROW(f1 T1, ...): struct of child columns. Column ``data`` is a
    tuple of (child_data, child_valid) pairs; ``dictionary`` is a tuple
    of per-field vocabularies (reference spi/type/RowType.java)."""

    field_types: Tuple[Type, ...] = ()
    field_names: Tuple[str, ...] = ()
    name: ClassVar[str] = "row"

    @property
    def storage_dtype(self):
        return torch.int32   # unused; children carry their own dtypes

    def display(self) -> str:
        inner = ", ".join(
            (f"{n} {t.display()}" if n else t.display())
            for n, t in zip(self.field_names or [""] * len(self.field_types),
                            self.field_types))
        return f"row({inner})"


@dataclasses.dataclass(frozen=True)
class UnknownType(Type):
    """Type of a bare NULL literal."""

    name: ClassVar[str] = "unknown"

    @property
    def storage_dtype(self):
        return torch.int32


def _limbs_of(value: int) -> Tuple[int, int]:
    """Python int -> (hi, lo) int128 limb ints (lo as SIGNED two's
    complement)."""
    lo_u = value & ((1 << 64) - 1)
    h = value >> 64
    if not -(1 << 63) <= h < (1 << 63):
        raise OverflowError(f"{value} out of int128 range")
    return h, lo_u - (1 << 64) if lo_u >= (1 << 63) else lo_u


# Singletons (Presto style: BIGINT, DOUBLE, ... constants)
BOOLEAN = BooleanType()
TINYINT = TinyintType()
SMALLINT = SmallintType()
INTEGER = IntegerType()
BIGINT = BigintType()
DOUBLE = DoubleType()
REAL = RealType()
DATE = DateType()
TIMESTAMP = TimestampType()
VARCHAR = VarcharType()
VARBINARY = VarbinaryType()
UNKNOWN = UnknownType()


def decimal(precision: int, scale: int) -> DecimalType:
    return DecimalType(precision, scale)


def varchar(length: Optional[int] = None) -> VarcharType:
    return VarcharType(length)


def char(length: int) -> CharType:
    return CharType(length)


_NUMERIC = (TinyintType, SmallintType, IntegerType, BigintType, RealType,
            DoubleType, DecimalType)
_INTEGRAL = (TinyintType, SmallintType, IntegerType, BigintType)


def is_numeric(t: Type) -> bool:
    return isinstance(t, _NUMERIC)


def is_integral(t: Type) -> bool:
    return isinstance(t, _INTEGRAL)


def is_floating(t: Type) -> bool:
    return isinstance(t, (RealType, DoubleType))


def is_string_type(t: Type) -> bool:
    return t.is_string


_INTEGRAL_RANK = {"tinyint": 0, "smallint": 1, "integer": 2, "bigint": 3}

#: the decimal each integral type coerces to (TypeCoercion's
#: tinyint -> decimal(3,0) ... bigint -> decimal(19,0))
_INTEGRAL_DIGITS = {"tinyint": 3, "smallint": 5, "integer": 10, "bigint": 19}


def exact_decimal(t: Type) -> "DecimalType":
    """``t`` as the decimal an exact numeric operand counts as in decimal
    arithmetic and comparison: a decimal is itself, an integral type the
    decimal(3|5|10|19, 0) it coerces to."""
    if isinstance(t, DecimalType):
        return t
    return DecimalType(_INTEGRAL_DIGITS[t.name], 0)


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Least-common supertype for implicit coercion.

    Mirrors the coercion lattice in Presto's TypeCoercion/FunctionRegistry
    (reference presto-main/.../type/TypeCoercion.java concept): integral
    widening, integral->decimal->double, varchar/char unification.
    """
    if a == b:
        return a
    if isinstance(a, UnknownType):
        return b
    if isinstance(b, UnknownType):
        return a
    if is_integral(a) and is_integral(b):
        return a if _INTEGRAL_RANK[a.name] >= _INTEGRAL_RANK[b.name] else b
    if is_numeric(a) and is_numeric(b):
        if isinstance(a, DoubleType) or isinstance(b, DoubleType):
            return DOUBLE
        if isinstance(a, RealType) or isinstance(b, RealType):
            # decimal + real -> real in Presto
            return REAL
        if isinstance(a, DecimalType) and isinstance(b, DecimalType):
            # widen to long decimal past 18 digits like the reference
            # (TypeCoercion over Int128-backed DecimalType; precision
            # saturates at 38 keeping the wider scale)
            scale = max(a.scale, b.scale)
            int_digits = max(a.precision - a.scale, b.precision - b.scale)
            return DecimalType(min(int_digits + scale, 38), scale)
        if isinstance(a, DecimalType) and is_integral(b):
            return common_super_type(a, exact_decimal(b))
        if isinstance(b, DecimalType) and is_integral(a):
            return common_super_type(b, a)
    if isinstance(a, ArrayType) and isinstance(b, ArrayType):
        e = common_super_type(a.element, b.element)
        return ArrayType(e) if e is not None else None
    if a.is_string and b.is_string:
        # varbinary never unifies with character strings (the reference
        # rejects varchar<->varbinary comparison/coercion at analysis)
        if isinstance(a, VarbinaryType) != isinstance(b, VarbinaryType):
            return None
        if isinstance(a, VarbinaryType):
            return VARBINARY
        return VARCHAR
    if isinstance(a, DateType) and isinstance(b, TimestampType):
        return TIMESTAMP
    if isinstance(b, DateType) and isinstance(a, TimestampType):
        return TIMESTAMP
    return None


def parse_type(text: str) -> Type:
    """Parse a SQL type name like 'decimal(12,2)' or 'varchar(25)'."""
    s = text.strip().lower()
    if "(" in s:
        base, _, rest = s.partition("(")
        base = base.strip()
        inner = rest.rstrip()
        assert inner.endswith(")"), text
        inner = inner[:-1]
        if base == "array":
            return ArrayType(parse_type(inner))
        if base == "map":
            depth = 0
            for i, ch in enumerate(inner):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                elif ch == "," and depth == 0:
                    return MapType(parse_type(inner[:i]),
                                   parse_type(inner[i + 1:]))
            raise ValueError(f"bad map type {text!r}")
        args = [int(x) for x in inner.split(",")]
        if base == "decimal":
            return DecimalType(*args)
        if base == "varchar":
            return VarcharType(args[0])
        if base == "char":
            return CharType(args[0])
        if base == "hllstate":
            return HllStateType(args[0])
        if base == "qdigeststate":
            return QdigestStateType(args[0])
        raise ValueError(f"unknown parametric type {text!r}")
    simple = {
        "boolean": BOOLEAN,
        "tinyint": TINYINT,
        "smallint": SMALLINT,
        "integer": INTEGER,
        "int": INTEGER,
        "bigint": BIGINT,
        "double": DOUBLE,
        "real": REAL,
        "date": DATE,
        "timestamp": TIMESTAMP,
        "varchar": VARCHAR,
        "varbinary": VARBINARY,
        "unknown": UNKNOWN,
    }
    if s in simple:
        return simple[s]
    raise ValueError(f"unknown type {text!r}")
