"""Columnar data plane on torch tensors with an explicit device.

The counterpart of ``presto_tpu/batch.py`` (reference
presto-spi/src/main/java/io/prestosql/spi/Page.java:39-62 and
spi/block/Block.java:23):

- A Batch is a struct-of-arrays: one flat tensor per column, padded to a
  power-of-two *capacity* (``bucket_capacity``), every tensor on one
  device.
- Liveness is a boolean ``row_mask`` (True = live row). Filters narrow the
  mask instead of compacting; ``compact()`` gathers live rows forward.
- Nulls are per-column validity masks (Presto's per-Block isNull arrays).
- Strings are int32 dictionary codes + a host-side vocabulary tuple per
  column (Presto's DictionaryBlock made mandatory for device residency).

``Batch.from_numpy`` builds a batch from the numpy arrays of another
engine's batch (data, validity, row mask, vocabularies), so the same
inputs can be fed to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .types import ArrayType, CharType, MapType, Type

#: torch storage dtype -> numpy dtype (host staging and decoding)
NUMPY_DTYPE = {
    torch.bool: np.dtype(bool), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}


def bucket_capacity(n: int, minimum: int = 128) -> int:
    """Round row count up to a power-of-two bucket (reference
    presto-main/.../operator/project/PageProcessor.java:56
    MAX_BATCH_SIZE's adaptive batching)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: Type


class Schema:
    """Ordered, named, typed columns."""

    def __init__(self, fields: Sequence[Tuple[str, Type]]):
        self.fields: Tuple[Field, ...] = tuple(
            f if isinstance(f, Field) else Field(f[0], f[1]) for f in fields
        )
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def types(self) -> List[Type]:
        return [f.type for f in self.fields]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def type_of(self, name: str) -> Type:
        return self.fields[self._index[name]].type

    def __len__(self) -> int:
        return len(self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name} {f.type.display()}" for f in self.fields)
        return f"Schema({inner})"

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([(n, self.type_of(n)) for n in names])


class Column:
    """One device column: data + validity, plus host dictionary for strings.

    ``data`` is one tensor with the rows on axis 0 ([cap] or, for long
    decimals, [cap, 2]), or for composite types a tuple of such tensors:
    ARRAY is (values [cap, L], lengths [cap] int32, elem_valid [cap, L]),
    MAP is (keys [cap, L], values [cap, L], lengths [cap], val_valid
    [cap, L]). A MAP column's dictionary is the (key vocabulary, value
    vocabulary) pair."""

    def __init__(self, type: Type, data, validity: torch.Tensor,
                 dictionary: Optional[Tuple[str, ...]] = None):
        self.type = type
        self.data = data
        self.validity = validity
        self.dictionary = dictionary

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    def __repr__(self) -> str:
        return f"Column({self.type.display()}, cap={self.capacity})"


def map_parts(data, fn):
    """Apply ``fn`` to every tensor of a column's data (one tensor or the
    tuple of a composite column)."""
    if isinstance(data, tuple):
        return tuple(fn(a) for a in data)
    return fn(data)


def gather_rows(data, idx: torch.Tensor):
    """Rows ``idx`` of a column's data (every part of a composite)."""
    return map_parts(data, lambda a: a[idx])


def repeat_rows(data, k: int):
    """Each row of a column's data repeated ``k`` times in place."""
    return map_parts(data, lambda a: a.repeat_interleave(k, dim=0))


def data_parts(data) -> Tuple[torch.Tensor, ...]:
    return data if isinstance(data, tuple) else (data,)


class Batch:
    """A horizontal slice of rows: aligned columns + row liveness mask."""

    def __init__(self, schema: Schema, columns: Sequence[Column],
                 row_mask: torch.Tensor):
        self.schema = schema
        self.columns = tuple(columns)
        self.row_mask = row_mask

    @property
    def capacity(self) -> int:
        return int(self.row_mask.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    def count(self) -> torch.Tensor:
        """Number of live rows (device scalar)."""
        return self.row_mask.sum(dtype=torch.int64)

    def host_count(self) -> int:
        return int(self.count())

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_arrays(
        schema: Schema,
        arrays: Sequence[np.ndarray],
        validity: Optional[Sequence[Optional[np.ndarray]]] = None,
        dictionaries: Optional[Sequence[Optional[Tuple[str, ...]]]] = None,
        capacity: Optional[int] = None,
        num_rows: Optional[int] = None,
        *,
        device: torch.device,
    ) -> "Batch":
        """Build a batch on ``device`` from host numpy arrays already in
        storage representation (padded to a power-of-two capacity)."""
        n = num_rows if num_rows is not None else (len(arrays[0]) if arrays else 0)
        cap = capacity or bucket_capacity(max(n, 1))
        cols = []
        for i, (f, arr) in enumerate(zip(schema.fields, arrays)):
            if isinstance(f.type, (ArrayType, MapType)):
                # only empty composites arrive here (an empty scan)
                cols.append(_empty_composite(f.type, cap, device))
                continue
            dt = NUMPY_DTYPE[f.type.storage_dtype]
            width = getattr(f.type, "storage_width", None)
            shape = (cap,) if width is None else (cap, width)
            padded = np.zeros(shape, dtype=dt)
            padded[:n] = np.asarray(arr[:n]).astype(dt)
            v = np.zeros(cap, dtype=bool)
            if validity is not None and validity[i] is not None:
                v[:n] = validity[i][:n]
            else:
                v[:n] = True
            d = dictionaries[i] if dictionaries is not None else None
            cols.append(Column(f.type, torch.from_numpy(padded).to(device),
                               torch.from_numpy(v).to(device), d))
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        return Batch(schema, cols, torch.from_numpy(mask).to(device))

    @staticmethod
    def from_pydict(data: Dict[str, Tuple[Type, Sequence[Any]]],
                    capacity: Optional[int] = None, *,
                    device: torch.device) -> "Batch":
        """Build a batch on ``device`` from python values:
        {name: (type, [values... (None = null)])}."""
        fields, arrays, validities, dictionaries = [], [], [], []
        composite: Dict[int, Tuple[Type, List[Any]]] = {}
        n = None
        for name, (typ, values) in data.items():
            values = list(values)
            if n is None:
                n = len(values)
            elif len(values) != n:
                raise ValueError(
                    f"column {name!r} has {len(values)} values, expected {n}")
            fields.append((name, typ))
            validities.append(np.array([v is not None for v in values],
                                       dtype=bool))
            if isinstance(typ, (ArrayType, MapType)):
                if isinstance(typ, MapType):
                    raise NotImplementedError("MAP columns from python values")
                composite[len(fields) - 1] = (typ, values)
                arrays.append(None)
                dictionaries.append(None)
            elif typ.is_string:
                vocab: Dict[str, int] = {}
                codes = np.full(len(values), -1, dtype=np.int32)
                for i, v in enumerate(values):
                    if v is None:
                        continue
                    if isinstance(typ, CharType):
                        v = str(v).ljust(typ.length)
                    codes[i] = vocab.setdefault(v, len(vocab))
                arrays.append(codes)
                dictionaries.append(tuple(vocab))
            else:
                arrays.append(np.asarray(
                    [typ.to_storage(v) if v is not None
                     else typ.null_storage() for v in values]))
                dictionaries.append(None)
        out = Batch.from_arrays(Schema(fields), arrays, validities,
                                dictionaries, capacity=capacity,
                                num_rows=n, device=device)
        if composite:
            cols = list(out.columns)
            for i, (typ, values) in composite.items():
                cols[i] = make_array_column(typ, values, out.capacity,
                                            device)
            out = Batch(out.schema, cols, out.row_mask)
        return out

    @staticmethod
    def from_numpy(
        schema: Schema,
        data: Sequence[np.ndarray],
        validity: Sequence[np.ndarray],
        row_mask: np.ndarray,
        dictionaries: Optional[Sequence[Optional[Tuple[str, ...]]]] = None,
        *,
        device: torch.device,
    ) -> "Batch":
        """Carry a batch across engines: numpy arrays of every column's
        storage data and validity, the row mask and the vocabularies, as
        another engine's batch holds them (same capacity, same padding
        lanes), placed on ``device`` unchanged."""
        cap = len(row_mask)
        cols = []
        for i, f in enumerate(schema.fields):
            # copies: the source arrays may be another engine's read-only
            # buffers, and torch tensors on the CPU would alias them
            if isinstance(data[i], tuple):
                # ARRAY / MAP parts keep their own dtypes
                parts = tuple(torch.from_numpy(np.array(a)).to(device)
                              for a in data[i])
            else:
                parts = (torch.from_numpy(np.array(
                    data[i], dtype=NUMPY_DTYPE[f.type.storage_dtype]))
                    .to(device),)
            valid = np.array(validity[i], dtype=bool)
            if any(a.shape[0] != cap for a in parts) or valid.shape != (cap,):
                raise ValueError(
                    f"column {f.name!r} does not match capacity {cap}")
            d = dictionaries[i] if dictionaries is not None else None
            if d is not None:
                # a MAP's dictionary is a (keys, values) pair of vocabularies
                d = (tuple(tuple(x) if x is not None else None for x in d)
                     if isinstance(f.type, MapType) else tuple(d))
            cols.append(Column(f.type,
                               parts if isinstance(data[i], tuple)
                               else parts[0],
                               torch.from_numpy(valid).to(device), d))
        mask = np.array(row_mask, dtype=bool)
        return Batch(schema, cols, torch.from_numpy(mask).to(device))

    # -- export -------------------------------------------------------------
    def to_pylist(self) -> List[Tuple]:
        """Decode live rows to python tuples (tests / client results)."""
        mask = self.row_mask.cpu().numpy()
        out_cols = []
        for col in self.columns:
            if isinstance(col.type, (ArrayType, MapType)):
                out_cols.append(_composite_to_pylist(col, mask))
                continue
            data = col.data.cpu().numpy()[mask]
            valid = col.validity.cpu().numpy()[mask]
            vals: List[Any] = []
            for d, v in zip(data, valid):
                if not v:
                    vals.append(None)
                elif col.type.is_string:
                    code = int(d)
                    vals.append(col.dictionary[code]
                                if col.dictionary and 0 <= code < len(col.dictionary)
                                else None)
                else:
                    vals.append(col.type.from_storage(d))
            out_cols.append(vals)
        return [tuple(r) for r in zip(*out_cols)] if out_cols else []

    # -- transforms ---------------------------------------------------------
    def compact(self, capacity: Optional[int] = None, *,
                check: bool = True) -> "Batch":
        """Gather live rows to the front (no host sync unless ``check``
        guards a shrinking capacity).

        Live row i goes to slot rank(i); surplus slots gather the last
        input row and stay dead, like the reference's static-size
        nonzero with fill_value = capacity - 1."""
        cap = capacity or self.capacity
        if check and capacity is not None and capacity < self.capacity:
            live = self.host_count()
            if live > capacity:
                raise ValueError(
                    f"compact capacity {capacity} < live rows {live}")
        mask = self.row_mask
        rank = torch.cumsum(mask.to(torch.int64), 0) - 1
        tgt = torch.where(mask & (rank < cap), rank, cap)
        idx = torch.full((cap + 1,), self.capacity - 1, dtype=torch.int64,
                         device=self.device)
        idx.scatter_(0, tgt, torch.arange(self.capacity, device=self.device))
        idx = idx[:cap]
        new_mask = torch.arange(cap, device=self.device) < self.count()
        cols = [Column(c.type, gather_rows(c.data, idx),
                       c.validity.index_select(0, idx) & new_mask,
                       c.dictionary)
                for c in self.columns]
        return Batch(self.schema, cols, new_mask)

    def pad(self, capacity: int) -> "Batch":
        """Grow to a larger capacity with dead padding lanes (row mask and
        validity False), the inverse of ``compact``. The scan pipeline
        pads a split's ragged final chunk up to the stream's bucket, so
        every batch of a scan has one capacity; results are unchanged."""
        if capacity <= self.capacity:
            return self
        cols = [Column(c.type, map_parts(c.data,
                                         lambda a: _pad_rows(a, capacity)),
                       _pad_rows(c.validity, capacity), c.dictionary)
                for c in self.columns]
        return Batch(self.schema, cols, _pad_rows(self.row_mask, capacity))

    def __repr__(self) -> str:
        return f"Batch({self.schema!r}, capacity={self.capacity})"


def _pad_rows(a: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero-pad the row axis of ``a`` up to ``cap`` rows."""
    extra = cap - a.shape[0]
    if extra <= 0:
        return a
    return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])


def unify_dictionaries(columns: Sequence[Column]
                       ) -> Tuple[Tuple[str, ...], List[np.ndarray]]:
    """Merge per-column vocabularies; return (vocab, remap arrays per column).

    remap[i] maps old codes of columns[i] to codes in the unified vocab; -1
    stays -1 via the sentinel slot appended at the end.
    """
    vocab: List[str] = []
    lookup: Dict[str, int] = {}
    remaps: List[np.ndarray] = []
    for col in columns:
        src = col.dictionary or ()
        remap = np.full(len(src) + 1, -1, dtype=np.int32)
        for old_code, s in enumerate(src):
            code = lookup.get(s)
            if code is None:
                code = lookup[s] = len(vocab)
                vocab.append(s)
            remap[old_code] = code
        remaps.append(remap)
    return tuple(vocab), remaps


def apply_remap_np(codes: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """Host-side dictionary code remap (-1 maps through the sentinel)."""
    idx = np.where(codes >= 0, codes, len(remap) - 1)
    return remap[idx]


def vocab_column(vocab: Optional[Tuple[str, ...]]) -> Column:
    """A one-slot CPU column carrying only a vocabulary, so host code can
    reuse ``unify_dictionaries`` without real data."""
    from .types import VARCHAR
    return Column(VARCHAR, torch.zeros(1, dtype=torch.int32),
                  torch.zeros(1, dtype=torch.bool), vocab)


def remap_codes(col: Column, remap: np.ndarray, vocab: Tuple[str, ...]) -> Column:
    """Apply a dictionary remap on device (gather)."""
    table = torch.from_numpy(remap).to(col.data.device)
    idx = torch.where(col.data >= 0, col.data, len(remap) - 1).to(torch.int64)
    return Column(col.type, table[idx], col.validity, vocab)


def concat_batches(batches: Sequence[Batch],
                   capacity: Optional[int] = None) -> Batch:
    """Concatenate batches of identical schema."""
    assert batches, "concat of zero batches"
    schema = batches[0].schema
    total_cap = sum(b.capacity for b in batches)
    cap = capacity or bucket_capacity(total_cap)
    if cap < total_cap:
        raise ValueError("concat capacity too small")
    out_cols = []
    for i in range(len(schema)):
        cols = [b.columns[i] for b in batches]
        typ = cols[0].type
        if isinstance(typ, ArrayType):
            out_cols.append(_concat_array_columns(cols, cap))
            continue
        if isinstance(typ, MapType):
            raise NotImplementedError("concat of MAP columns")
        dictionary = None
        if typ.is_string:
            dictionary, remaps = unify_dictionaries(cols)
            if any(c.dictionary != dictionary for c in cols):
                cols = [remap_codes(c, r, dictionary)
                        for c, r in zip(cols, remaps)]
        data = _pad_rows(torch.cat([c.data for c in cols]), cap)
        validity = _pad_rows(torch.cat([c.validity for c in cols]), cap)
        out_cols.append(Column(typ, data, validity, dictionary))
    mask = _pad_rows(torch.cat([b.row_mask for b in batches]), cap)
    return Batch(schema, out_cols, mask)


def _empty_composite(typ: Type, cap: int, device) -> Column:
    """An all-NULL ARRAY / MAP column of one element slot."""
    z = torch.zeros(cap, dtype=torch.int32, device=device)
    ev = torch.zeros((cap, 1), dtype=torch.bool, device=device)
    if isinstance(typ, ArrayType):
        vals = torch.zeros((cap, 1), dtype=typ.element.storage_dtype,
                           device=device)
        return Column(typ, (vals, z, ev), z.bool(),
                      () if typ.element.is_string else None)
    keys = torch.zeros((cap, 1), dtype=typ.key.storage_dtype, device=device)
    vals = torch.zeros((cap, 1), dtype=typ.value.storage_dtype, device=device)
    return Column(typ, (keys, vals, z, ev), z.bool(), None)


def _decode_elem(typ: Type, d, vocab):
    if typ.is_string:
        code = int(d)
        return vocab[code] if vocab and 0 <= code < len(vocab) else None
    return typ.from_storage(d)


def _composite_to_pylist(col: Column, mask: np.ndarray) -> List[Any]:
    """Decode an ARRAY / MAP column's live rows to python lists / dicts."""
    valid = col.validity.cpu().numpy()[mask]
    parts = [a.cpu().numpy()[mask] for a in col.data]
    out: List[Any] = []
    if isinstance(col.type, ArrayType):
        values, lengths, elem_valid = parts
        et = col.type.element
        for i, v in enumerate(valid):
            out.append(None if not v else [
                _decode_elem(et, values[i, j], col.dictionary)
                if elem_valid[i, j] else None
                for j in range(int(lengths[i]))])
        return out
    keys, values, lengths, val_valid = parts
    kt, vt = col.type.key, col.type.value
    kd, vd = col.dictionary or (None, None)
    for i, v in enumerate(valid):
        if not v:
            out.append(None)
            continue
        out.append({_decode_elem(kt, keys[i, j], kd):
                    (_decode_elem(vt, values[i, j], vd)
                     if val_valid[i, j] else None)
                    for j in range(int(lengths[i]))})
    return out


def make_array_column(typ: ArrayType, values: Sequence[Optional[Sequence]],
                      cap: int, device) -> Column:
    """Build an ARRAY column from python lists (None = NULL row)."""
    et = typ.element
    max_len = max([len(v) for v in values if v is not None] + [1])
    data = np.zeros((cap, max_len), dtype=NUMPY_DTYPE[et.storage_dtype])
    lengths = np.zeros(cap, dtype=np.int32)
    elem_valid = np.zeros((cap, max_len), dtype=bool)
    row_valid = np.zeros(cap, dtype=bool)
    vocab: Dict[str, int] = {}
    for i, row in enumerate(values):
        if row is None:
            continue
        row_valid[i] = True
        lengths[i] = len(row)
        for j, e in enumerate(row):
            if e is None:
                continue
            elem_valid[i, j] = True
            data[i, j] = (vocab.setdefault(e, len(vocab)) if et.is_string
                          else et.to_storage(e))
    parts = tuple(torch.from_numpy(a).to(device)
                  for a in (data, lengths, elem_valid))
    return Column(typ, parts, torch.from_numpy(row_valid).to(device),
                  tuple(vocab) if et.is_string else None)


def _concat_array_columns(cols: Sequence[Column], cap: int) -> Column:
    """Concatenate ARRAY columns along rows, padding widths to the max and
    re-coding string elements into one vocabulary."""
    typ = cols[0].type
    width = max(c.data[0].shape[1] for c in cols)
    dictionary, remaps = None, None
    if typ.element.is_string:
        dictionary, remaps = unify_dictionaries(cols)
    vals, lens, evs = [], [], []
    for ci, c in enumerate(cols):
        v, ln, ev = c.data
        if v.shape[1] < width:
            v = torch.cat([v, v.new_zeros((v.shape[0], width - v.shape[1]))],
                          dim=1)
            ev = torch.cat([ev, ev.new_zeros((ev.shape[0],
                                              width - ev.shape[1]))], dim=1)
        if remaps is not None:
            table = torch.from_numpy(remaps[ci]).to(v.device)
            v = table[torch.where(v >= 0, v, len(remaps[ci]) - 1).to(
                torch.int64)]
        vals.append(v)
        lens.append(ln)
        evs.append(ev)
    parts = tuple(_pad_rows(torch.cat(p), cap) for p in (vals, lens, evs))
    return Column(typ, parts,
                  _pad_rows(torch.cat([c.validity for c in cols]), cap),
                  dictionary)
