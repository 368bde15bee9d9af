"""Parquet file reader and writer: host metadata and pruning, device
column decode.

The counterpart of ``presto_tpu/formats/parquet.py`` (reference
presto-parquet/.../reader/ParquetReader.java and the per-type
PrimitiveColumnReader, RunLengthBitPackingHybridDecoder,
predicate/TupleDomainParquetPredicate.java row-group pruning). As in
``formats/orc.py``, footer and page-header parsing and row-group pruning
stay on the host; the bulk decode of the RLE / bit-packed hybrid
(dictionary indices) runs on the device the caller names
(``_expand_hybrid``, plain PyTorch), and dictionary-encoded string
columns land as the port's dictionary codes: Parquet's dictionary is the
column's vocabulary, with no re-encoding.

Supported, as in the reference: flat schemas over BOOLEAN, INT32, INT64,
FLOAT, DOUBLE and BYTE_ARRAY (with the DATE, TIMESTAMP, DECIMAL and UTF8
logical types), V1 data pages, PLAIN and PLAIN_DICTIONARY /
RLE_DICTIONARY encodings, UNCOMPRESSED or GZIP codecs, nulls through
definition levels, row-group min/max pruning.

The writer (``write_parquet`` from python values, ``write_parquet_batches``
from the port's batches) writes the reference writer's bytes: one row
group, V1 pages, PLAIN numerics, PLAIN_DICTIONARY strings, UNCOMPRESSED.
Where the reference loops over values in Python, it computes the same
bytes with numpy (``_rle_encode``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import struct
import time
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Column, Schema, bucket_capacity
from . import decodestats as stats
from . import thrift_compact as tc

MAGIC = b"PAR1"

# physical types (parquet.thrift Type)
P_BOOLEAN, P_INT32, P_INT64, P_INT96, P_FLOAT, P_DOUBLE, P_BYTE_ARRAY, \
    P_FIXED = range(8)
# encodings
E_PLAIN, _, E_PLAIN_DICT, E_RLE, E_BIT_PACKED = 0, 1, 2, 3, 4
E_RLE_DICT = 8
# codecs
C_UNCOMPRESSED, C_SNAPPY, C_GZIP = 0, 1, 2
# converted types
CT_UTF8, CT_DECIMAL, CT_DATE = 0, 5, 6
CT_TS_MILLIS, CT_TS_MICROS = 9, 10


@dataclasses.dataclass
class ParquetColumn:
    name: str
    type: T.Type
    physical: int
    converted: Optional[int]
    optional: bool
    scale: int = 0
    # timestamp unit -> engine micros: multiply by max(m,1), divide by
    # max(-m,1) (millis: 1000, micros: 1, nanos: -1000)
    ts_mult: int = 1


@dataclasses.dataclass
class ChunkInfo:
    offset: int                  # first page offset (dict page if any)
    total_size: int
    codec: int
    num_values: int
    min_val: Optional[object] = None
    max_val: Optional[object] = None
    null_count: Optional[int] = None


@dataclasses.dataclass
class RowGroupInfo:
    num_rows: int
    chunks: Dict[str, ChunkInfo]


def _engine_type(el: Dict[int, object]) -> Tuple[T.Type, int]:
    # SchemaElement fields (parquet.thrift): 1 type, 3 repetition,
    # 4 name, 6 converted_type, 7 scale, 8 precision, 10 logicalType
    phys = el.get(1)
    conv = el.get(6)
    scale = el.get(7, 0)
    precision = el.get(8, 0)
    logical = el.get(10) or {}
    if conv == CT_DECIMAL and phys in (P_INT32, P_INT64):
        return T.DecimalType(precision or 18, scale or 0), scale or 0
    if phys == P_BOOLEAN:
        return T.BOOLEAN, 0
    if phys == P_INT32:
        if conv == CT_DATE or 6 in logical:
            return T.DATE, 0
        return T.INTEGER, 0
    if phys == P_INT64:
        if conv in (CT_TS_MILLIS, CT_TS_MICROS) or 8 in logical:
            return T.TIMESTAMP, 0
        if 6 in logical:      # logical-only DATE on int64 (unusual)
            return T.DATE, 0
        return T.BIGINT, 0
    if phys in (P_FLOAT, P_DOUBLE):
        return T.DOUBLE, 0
    if phys == P_BYTE_ARRAY:
        return T.VARCHAR, 0
    raise NotImplementedError(f"parquet physical type {phys}")


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid: host header scan + device expansion
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HybridRuns:
    """Flat per-run decode parameters (device-uploadable)."""

    out_start: np.ndarray        # int64[r]
    is_packed: np.ndarray        # bool[r]
    values: np.ndarray           # int64[r]   RLE value
    bit_start: np.ndarray        # int64[r]   absolute payload bit offset


def scan_hybrid(data: bytes, n: int, width: int,
                pos: int = 0) -> Tuple[HybridRuns, int]:
    """Host scan of RLE/bit-packed hybrid run headers: O(runs)."""
    out_start: List[int] = []
    packed: List[bool] = []
    values: List[int] = []
    bit_start: List[int] = []
    nbytes = (width + 7) // 8
    out = 0
    while out < n:
        header, pos = tc._varint(data, pos)
        if header & 1:                     # bit-packed group
            count = (header >> 1) * 8
            out_start.append(out)
            packed.append(True)
            values.append(0)
            bit_start.append(pos * 8)
            pos += (count * width) // 8
            out += count                   # may exceed n (padding group)
        else:                              # RLE run
            count = header >> 1
            v = int.from_bytes(data[pos:pos + nbytes], "little")
            pos += nbytes
            out_start.append(out)
            packed.append(False)
            values.append(v)
            bit_start.append(0)
            out += count
    return HybridRuns(
        out_start=np.asarray(out_start or [0], dtype=np.int64),
        is_packed=np.asarray(packed or [False], dtype=bool),
        values=np.asarray(values or [0], dtype=np.int64),
        bit_start=np.asarray(bit_start or [0], dtype=np.int64),
    ), pos


def _expand_hybrid(stream: torch.Tensor, runs: HybridRuns, width: int,
                   cap: int, device: torch.device) -> torch.Tensor:
    """Device expansion: j -> its run by searchsorted, then either the
    run's RLE value or an LSB-first bit-gather from the raw page bytes
    (RunLengthBitPackingHybridDecoder's inner loop, for every value at
    once). ``runs`` holds tensors on ``device``."""
    out_start = runs.out_start
    j = torch.arange(cap, dtype=torch.int64, device=device)
    run = (torch.searchsorted(out_start, j, right=True) - 1).clamp(
        0, out_start.shape[0] - 1)
    rel = j - out_start[run]
    bit = runs.bit_start[run] + rel * width
    byte0 = bit >> 3
    shift = bit & 7
    last = stream.shape[0] - 1
    acc = torch.zeros(cap, dtype=torch.int64, device=device)
    for k in range(5):                      # width <= 32 spans <= 5 bytes
        b = stream[(byte0 + k).clamp(0, last)].to(torch.int64)
        acc = acc | (b << (8 * k))
    mask = (1 << width) - 1 if width < 63 else -1
    unpacked = (acc >> shift) & mask
    return torch.where(runs.is_packed[run], unpacked, runs.values[run])


def decode_hybrid_device(data: bytes, n: int, width: int, cap: int,
                         pos: int = 0, *, device) -> torch.Tensor:
    """int64[cap] values of the hybrid stream at ``data[pos:]`` on
    ``device`` (the host scans run headers; the device expands)."""
    device = torch.device(device)
    if width == 0:
        return torch.zeros(cap, dtype=torch.int64, device=device)
    runs, _ = scan_hybrid(data, n, width, pos)
    # eight zero bytes past the page: a gather past the end reads 0
    stream = np.zeros(len(data) + 8, dtype=np.uint8)
    stream[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    stream = torch.from_numpy(stream).to(device)
    runs = HybridRuns(**{f.name: torch.from_numpy(getattr(runs, f.name))
                         .to(device) for f in dataclasses.fields(runs)})
    with stats.expansion():
        return _expand_hybrid(stream, runs, width, cap, device)


def _bitwidth(v: int) -> int:
    return max(int(v).bit_length(), 1) if v > 0 else 1


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class ParquetReader:
    """One file: parsed footer + per-row-group device decode."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(size - 8, 0))
            tail = f.read(8)
            if tail[4:] != MAGIC:
                raise ValueError(f"{path}: not a parquet file")
            meta_len = struct.unpack("<I", tail[:4])[0]
            f.seek(size - 8 - meta_len)
            meta = f.read(meta_len)
        fm, _ = tc.read_struct(meta)
        elements = fm[2]
        self.num_rows = fm.get(3, 0)
        self.columns: List[ParquetColumn] = []
        root = elements[0]
        n_children = root.get(5, 0)
        if n_children != len(elements) - 1:
            raise NotImplementedError("nested parquet schemas")
        for el in elements[1:]:
            typ, scale = _engine_type(el)
            name = el[4].decode() if isinstance(el[4], bytes) else el[4]
            conv = el.get(6)
            ts_mult = 1
            if typ is T.TIMESTAMP:
                if conv == CT_TS_MILLIS:
                    ts_mult = 1000
                else:
                    ts = (el.get(10) or {}).get(8) or {}
                    unit = ts.get(2) or {}
                    if 1 in unit:            # MILLIS
                        ts_mult = 1000
                    elif 3 in unit:          # NANOS
                        ts_mult = -1000
            self.columns.append(ParquetColumn(
                name=name, type=typ, physical=el.get(1),
                converted=conv,
                optional=el.get(3, 0) == 1, scale=scale,
                ts_mult=ts_mult))
        self.schema = Schema([(c.name, c.type) for c in self.columns])
        self.row_groups: List[RowGroupInfo] = []
        for rg in fm.get(4, ()):
            chunks: Dict[str, ChunkInfo] = {}
            for cc in rg[1]:
                md = cc[3]
                path_in_schema = [
                    p.decode() if isinstance(p, bytes) else p
                    for p in md[3]]
                name = path_in_schema[0]
                offset = md.get(11) or md[9]
                col_stats = md.get(12) or {}
                col = next(c for c in self.columns if c.name == name)
                mn, mx = _decode_stat(col_stats, col)
                chunks[name] = ChunkInfo(
                    offset=offset, total_size=md[7], codec=md[4],
                    num_values=md[5], min_val=mn, max_val=mx,
                    null_count=col_stats.get(3))
            self.row_groups.append(RowGroupInfo(num_rows=rg[3],
                                                chunks=chunks))

    # -- pruning -------------------------------------------------------------
    def _group_matches(self, rg: RowGroupInfo, pushdown) -> bool:
        """Row-group min/max pruning (reference
        TupleDomainParquetPredicate.java matches())."""
        if not pushdown:
            return True
        for name, lo, hi in pushdown:
            ch = rg.chunks.get(name)
            if ch is None or ch.min_val is None or ch.max_val is None:
                continue
            if lo is not None and ch.max_val < lo:
                return False
            if hi is not None and ch.min_val > hi:
                return False
        return True

    # -- decode --------------------------------------------------------------
    def batches(self, columns: Sequence[str], pushdown=None, *,
                device) -> Iterator[Batch]:
        """One batch on ``device`` per surviving row group."""
        device = torch.device(device)
        want = [next(c for c in self.columns if c.name == n)
                for n in columns]
        schema = Schema([(c.name, c.type) for c in want])
        matching = [rg for rg in self.row_groups
                    if self._group_matches(rg, pushdown)]
        pruned = len(self.row_groups) - len(matching)
        stats.PARQUET_GROUPS_PRUNED.inc(pruned)
        if pruned and not matching:
            stats.PARQUET_FILES_PRUNED.inc()
        with open(self.path, "rb") as f:
            for rg in matching:
                t0 = time.perf_counter()
                n = rg.num_rows
                cap = bucket_capacity(max(n, 1))
                cols = []
                for c in want:
                    ch = rg.chunks[c.name]
                    f.seek(ch.offset)
                    raw = f.read(ch.total_size)
                    cols.append(self._decode_chunk(c, ch, raw, n, cap,
                                                   device))
                mask = torch.arange(cap, device=device) < n
                stats.HOST_SECONDS.inc(time.perf_counter() - t0)
                stats.PARQUET_GROUPS_READ.inc()
                yield Batch(schema, cols, mask)

    def _decode_chunk(self, col: ParquetColumn, ch: ChunkInfo,
                      raw: bytes, n_rows: int, cap: int,
                      device: torch.device) -> Column:
        pos = 0
        dict_values: Optional[np.ndarray] = None
        dict_vocab: Optional[Tuple[str, ...]] = None
        parts: List[Tuple[int, np.ndarray, object]] = []
        # [(num_values, present, values-or-indices info)]
        total = 0
        while total < ch.num_values and pos < len(raw):
            header, pos = tc.read_struct(raw, pos)
            ptype = header[1]
            comp_size = header[3]
            payload = raw[pos:pos + comp_size]
            pos += comp_size
            if ch.codec == C_GZIP:
                payload = zlib.decompress(payload, 16 + 15)
            elif ch.codec != C_UNCOMPRESSED:
                raise NotImplementedError(
                    f"parquet codec {ch.codec} (use UNCOMPRESSED or GZIP)")
            if ptype == 2:              # dictionary page
                dph = header[7]
                dict_values, dict_vocab = _decode_dict_page(
                    col, payload, dph[1])
                continue
            if ptype != 0:
                raise NotImplementedError(f"page type {ptype}")
            dh = header[5]
            num_values = dh[1]
            encoding = dh[2]
            present, vpos = _decode_def_levels(col, payload, num_values)
            n_present = int(present.sum()) if present is not None \
                else num_values
            parts.append((num_values, present,
                          (encoding, payload, vpos, n_present)))
            total += num_values
        return _assemble_column(col, parts, dict_values, dict_vocab,
                                n_rows, cap, device)


def _decode_stat(col_stats: Dict[int, object], col: ParquetColumn):
    def dec(b):
        if b is None:
            return None
        if col.physical == P_INT32:
            return struct.unpack("<i", b)[0]
        if col.physical == P_INT64:
            return struct.unpack("<q", b)[0]
        if col.physical == P_DOUBLE:
            return struct.unpack("<d", b)[0]
        if col.physical == P_FLOAT:
            return struct.unpack("<f", b)[0]
        return None
    # prefer min_value/max_value (field 6/5) over deprecated min/max (2/1)
    mn = dec(col_stats.get(6, col_stats.get(2)))
    mx = dec(col_stats.get(5, col_stats.get(1)))
    if col.ts_mult != 1:
        # stats are in the file's physical timestamp unit; convert to the
        # engine's micros exactly like _storage_fix converts values (the
        # floor in nanos->micros is monotonic, so converted stats remain
        # valid bounds for converted data)
        if mn is not None:
            mn = int(_storage_fix(col, np.asarray([mn], dtype=np.int64))[0])
        if mx is not None:
            mx = int(_storage_fix(col, np.asarray([mx], dtype=np.int64))[0])
    return mn, mx


def _decode_def_levels(col: ParquetColumn, payload: bytes,
                       num_values: int):
    """V1 data page definition levels -> (present bool[n] | None, pos)."""
    if not col.optional:
        return None, 0
    ln = struct.unpack("<I", payload[:4])[0]
    levels = _decode_hybrid_numpy(payload[4:4 + ln], num_values, 1)
    return levels.astype(bool), 4 + ln


def _decode_hybrid_numpy(data: bytes, n: int, width: int) -> np.ndarray:
    """Host hybrid decode (small streams: def levels)."""
    runs, _ = scan_hybrid(data, n, width, 0)
    out = np.zeros(n, dtype=np.int64)
    arr = np.frombuffer(data, dtype=np.uint8)
    starts = runs.out_start
    for i in range(len(starts)):
        start = int(starts[i])
        end = int(starts[i + 1]) if i + 1 < len(starts) else n
        end = min(end, n)
        if start >= n:
            break
        if not runs.is_packed[i]:
            out[start:end] = runs.values[i]
            continue
        bit0 = int(runs.bit_start[i])
        idx = np.arange(end - start, dtype=np.int64)
        bit = bit0 + idx * width
        acc = np.zeros(end - start, dtype=np.int64)
        for k in range(5):
            byte_idx = np.clip(bit // 8 + k, 0, len(arr) - 1)
            acc |= arr[byte_idx].astype(np.int64) << (8 * k)
        out[start:end] = (acc >> (bit % 8)) & ((1 << width) - 1)
    return out


def _decode_dict_page(col: ParquetColumn, payload: bytes, n: int):
    """PLAIN dictionary page -> (numeric values | None, vocab | None)."""
    if col.physical == P_BYTE_ARRAY:
        vocab: List[str] = []
        pos = 0
        for _ in range(n):
            ln = struct.unpack("<I", payload[pos:pos + 4])[0]
            pos += 4
            vocab.append(payload[pos:pos + ln].decode("utf-8", "replace"))
            pos += ln
        return None, tuple(vocab)
    return _storage_fix(col, np.asarray(_plain_values(col, payload, n))), None


def _plain_values(col: ParquetColumn, payload: bytes, n: int) -> np.ndarray:
    if col.physical == P_INT32:
        return np.frombuffer(payload, dtype="<i4", count=n)
    if col.physical == P_INT64:
        return np.frombuffer(payload, dtype="<i8", count=n)
    if col.physical == P_DOUBLE:
        return np.frombuffer(payload, dtype="<f8", count=n)
    if col.physical == P_FLOAT:
        return np.frombuffer(payload, dtype="<f4", count=n).astype("<f8")
    if col.physical == P_BOOLEAN:
        bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8),
                             bitorder="little")
        return bits[:n].astype(np.int8)
    raise NotImplementedError(f"PLAIN physical {col.physical}")


def _storage_fix(col: ParquetColumn, arr):
    """Physical -> engine storage adjustments (timestamp units)."""
    if col.ts_mult > 1:
        return arr * col.ts_mult
    if col.ts_mult < -1:
        return arr // (-col.ts_mult)
    return arr


def _assemble_column(col: ParquetColumn, parts, dict_values, dict_vocab,
                     n_rows: int, cap: int, device: torch.device) -> Column:
    """Fuse page parts into one device column of ``cap`` slots."""
    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device)

    out_dtype = col.type.storage_dtype
    row0 = 0
    value_arrays: List[torch.Tensor] = []
    present_all = np.zeros(cap, dtype=bool)
    # ONE vocabulary per chunk, seeded from the dictionary page: PLAIN
    # fallback pages after a dictionary page (parquet-mr's dictionary
    # overflow layout) and multi-page PLAIN columns append to it, so codes
    # from earlier pages stay valid
    vocab: List[str] = list(dict_vocab or ())
    lookup: Dict[str, int] = {s: i for i, s in enumerate(vocab)}
    for num_values, present, (encoding, payload, vpos, n_present) in parts:
        if present is None:
            present_all[row0:row0 + num_values] = True
        else:
            present_all[row0:row0 + num_values] = present
        if encoding in (E_PLAIN_DICT, E_RLE_DICT):
            width = payload[vpos]
            vcap = bucket_capacity(max(n_present, 1))
            idx = decode_hybrid_device(payload, n_present, width, vcap,
                                       pos=vpos + 1,
                                       device=device)[:n_present]
            if dict_vocab is not None:
                value_arrays.append(idx.to(torch.int32))
            else:
                table = up(dict_values)
                value_arrays.append(
                    table[idx.clamp(0, len(dict_values) - 1)])
        elif encoding == E_PLAIN:
            if col.physical == P_BYTE_ARRAY:
                # host-parsed strings -> the shared chunk vocabulary
                p = vpos
                codes = np.empty(n_present, dtype=np.int32)
                for i in range(n_present):
                    ln = struct.unpack("<I", payload[p:p + 4])[0]
                    p += 4
                    s = payload[p:p + ln].decode("utf-8", "replace")
                    p += ln
                    code = lookup.get(s)
                    if code is None:
                        code = lookup[s] = len(vocab)
                        vocab.append(s)
                    codes[i] = code
                value_arrays.append(up(codes))
            elif col.physical == P_BOOLEAN:
                value_arrays.append(up(_plain_values(col, payload[vpos:],
                                                     n_present)))
            else:
                arr = _plain_values(col, payload[vpos:], n_present)
                value_arrays.append(up(_storage_fix(col, np.asarray(arr))))
        else:
            raise NotImplementedError(f"parquet encoding {encoding}")
        row0 += num_values
    if col.physical == P_BYTE_ARRAY:
        dict_vocab = tuple(vocab)
    flat = (torch.cat([v.reshape(-1).to(out_dtype) for v in value_arrays])
            if value_arrays else torch.zeros(1, dtype=out_dtype,
                                             device=device))
    if flat.shape[0] == 0:      # entirely-NULL chunk: pages carry 0 values
        flat = torch.zeros(1, dtype=out_dtype, device=device)
    # scatter present values to row slots: row j takes the k-th value
    # where k = rank of j among present rows
    presj = torch.from_numpy(present_all).to(device)
    rank = torch.cumsum(presj.to(torch.int32), 0) - 1
    gathered = flat[rank.clamp(0, flat.shape[0] - 1)]
    data = torch.where(presj, gathered, torch.zeros_like(gathered))
    return Column(col.type, data, presj, dict_vocab)


# ---------------------------------------------------------------------------
# Writer (test fixtures, CTAS export and the smoke's data files): one row
# group, V1 pages, PLAIN numerics / PLAIN_DICTIONARY strings, UNCOMPRESSED
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ColumnValues:
    """One column's rows in the writer's terms: which rows are present,
    and either the present rows' storage values (numpy, in the physical
    type's dtype) or their codes into a vocabulary in order of first
    appearance."""

    present: np.ndarray
    live: Optional[np.ndarray] = None
    vocab: Optional[List[str]] = None
    codes: Optional[np.ndarray] = None


_PLAIN_DTYPE = {P_INT32: "<i4", P_INT64: "<i8", P_DOUBLE: "<f8",
                P_BOOLEAN: np.uint8}


def write_parquet(path: str, schema: Schema,
                  columns: Sequence[Sequence[object]]) -> None:
    """Write python column values (None = NULL) as a flat parquet file."""
    n = len(columns[0]) if columns else 0
    cols = []
    for f, values in zip(schema.fields, columns):
        present = np.fromiter((v is not None for v in values), dtype=bool,
                              count=len(values))
        if f.type.is_string:
            vocab: List[str] = []
            lookup: Dict[str, int] = {}
            idx: List[int] = []
            for v in values:
                if v is None:
                    continue
                code = lookup.get(v)
                if code is None:
                    code = lookup[v] = len(vocab)
                    vocab.append(v)
                idx.append(code)
            cols.append(_ColumnValues(present, vocab=vocab,
                                      codes=np.asarray(idx, dtype=np.int64)))
            continue
        phys, _ = _physical_of(f.type)
        live = np.asarray([f.type.to_storage(v) for v in values
                           if v is not None], dtype=_PLAIN_DTYPE[phys])
        cols.append(_ColumnValues(present, live=live))
    _write(path, schema, n, cols)


def write_parquet_batches(path: str, schema: Schema, batches) -> int:
    """Write the live rows of the port's batches as one flat parquet file,
    the bytes ``write_parquet`` writes for the same rows' python values;
    returns the row count."""
    batches = list(batches)
    masks = [b.row_mask.cpu().numpy() for b in batches]
    n = int(sum(m.sum() for m in masks))
    cols = []
    for ci, f in enumerate(schema.fields):
        if isinstance(batches[0].columns[ci].data if batches else None,
                      tuple):
            raise NotImplementedError("parquet write of ARRAY/MAP")
        data = [b.columns[ci].data.cpu().numpy()[m]
                for b, m in zip(batches, masks)]
        valid = [b.columns[ci].validity.cpu().numpy()[m]
                 for b, m in zip(batches, masks)]
        if f.type.is_string:
            cols.append(_batch_strings(
                data, valid, [b.columns[ci].dictionary or ()
                              for b in batches]))
            continue
        phys, _ = _physical_of(f.type)
        if data and data[0].ndim != 1:
            raise NotImplementedError(
                f"parquet write of {f.type.display()}")
        present = (np.concatenate(valid) if valid
                   else np.zeros(0, dtype=bool))
        live = (np.concatenate([d[v] for d, v in zip(data, valid)])
                if data else np.zeros(0))
        cols.append(_ColumnValues(present,
                                  live=live.astype(_PLAIN_DTYPE[phys])))
    _write(path, schema, n, cols)
    return n


def _batch_strings(data, valid, vocabs) -> _ColumnValues:
    """String codes of several batches (each with its own vocabulary) as
    one vocabulary in order of first appearance; a valid row whose code
    lies outside its batch's vocabulary reads as NULL, as ``to_pylist``
    decodes it."""
    vocab: List[str] = []
    lookup: Dict[str, int] = {}
    present_parts, code_parts = [], []
    for codes, ok, batch_vocab in zip(data, valid, vocabs):
        ok = ok & (codes >= 0) & (codes < len(batch_vocab))
        sel = codes[ok].astype(np.int64)
        present_parts.append(ok)
        if not len(sel):
            code_parts.append(sel)
            continue
        # the batch's codes in order of first appearance
        uniq, first = np.unique(sel, return_index=True)
        remap = np.zeros(int(uniq.max()) + 1, dtype=np.int64)
        for c in uniq[np.argsort(first, kind="stable")].tolist():
            s = batch_vocab[c]
            g = lookup.get(s)
            if g is None:
                g = lookup[s] = len(vocab)
                vocab.append(s)
            remap[c] = g
        code_parts.append(remap[sel])
    present = (np.concatenate(present_parts) if present_parts
               else np.zeros(0, dtype=bool))
    codes = (np.concatenate(code_parts) if code_parts
             else np.zeros(0, dtype=np.int64))
    return _ColumnValues(present, vocab=vocab, codes=codes)


def _write(path: str, schema: Schema, n: int,
           columns: Sequence[_ColumnValues]) -> None:
    out = bytearray(MAGIC)
    chunk_metas: List[bytes] = []
    for (name, typ), cv in zip(
            [(f.name, f.type) for f in schema.fields], columns):
        phys, conv = _physical_of(typ)
        offset = len(out)
        dict_page_offset = None
        if typ.is_string:
            dict_payload = b"".join(
                struct.pack("<I", len(b)) + b
                for b in (s.encode() for s in cv.vocab))
            dict_page_offset = len(out)
            out += _page_header(2, len(dict_payload), dict_n=len(cv.vocab))
            out += dict_payload
            width = _bitwidth(max(len(cv.vocab) - 1, 1))
            payload = _def_levels(cv.present) + bytes([width]) \
                + _rle_encode(cv.codes, width)
            data_page_offset = len(out)
            out += _page_header(0, len(payload), data_n=n,
                                encoding=E_PLAIN_DICT)
            out += payload
        else:
            payload = _def_levels(cv.present) + _plain_encode(phys, cv.live)
            data_page_offset = len(out)
            out += _page_header(0, len(payload), data_n=n,
                                encoding=E_PLAIN)
            out += payload
        total = len(out) - offset
        md = tc.write_struct([
            (1, tc.I32, phys),
            (2, tc.LIST, (tc.I32, [E_PLAIN, E_RLE, E_PLAIN_DICT])),
            (3, tc.LIST, (tc.BINARY, [name])),
            (4, tc.I32, C_UNCOMPRESSED),
            (5, tc.I64, n),
            (6, tc.I64, total),
            (7, tc.I64, total),
            (9, tc.I64, data_page_offset),
            (11, tc.I64, dict_page_offset),
            (12, tc.STRUCT, None if typ.is_string
             else _stats_struct(phys, cv)),
        ])
        chunk_metas.append(tc.write_struct([
            (2, tc.I64, offset),
            (3, tc.STRUCT, md),
        ]))
    rg = tc.write_struct([
        (1, tc.LIST, (tc.STRUCT, chunk_metas)),
        (2, tc.I64, len(out) - 4),
        (3, tc.I64, n),
    ])
    elements = [tc.write_struct([
        (4, tc.BINARY, "schema"),
        (5, tc.I32, len(schema)),
    ])]
    for f in schema.fields:
        phys, conv = _physical_of(f.type)
        fields = [(1, tc.I32, phys), (3, tc.I32, 1),
                  (4, tc.BINARY, f.name)]
        if conv is not None:
            fields.append((6, tc.I32, conv))
        if isinstance(f.type, T.DecimalType):
            fields.append((7, tc.I32, f.type.scale))
            fields.append((8, tc.I32, f.type.precision))
        elements.append(tc.write_struct(fields))
    meta = tc.write_struct([
        (1, tc.I32, 1),
        (2, tc.LIST, (tc.STRUCT, elements)),
        (3, tc.I64, n),
        (4, tc.LIST, (tc.STRUCT, [rg])),
    ])
    out += meta
    out += struct.pack("<I", len(meta))
    out += MAGIC
    with open(path, "wb") as f:
        f.write(bytes(out))


def _physical_of(typ: T.Type) -> Tuple[int, Optional[int]]:
    if isinstance(typ, T.BooleanType):
        return P_BOOLEAN, None
    if isinstance(typ, T.DateType):
        return P_INT32, CT_DATE
    if isinstance(typ, (T.TinyintType, T.SmallintType, T.IntegerType)):
        return P_INT32, None
    if isinstance(typ, T.TimestampType):
        return P_INT64, CT_TS_MICROS
    if isinstance(typ, T.DecimalType):
        if typ.precision > 18:
            raise NotImplementedError(
                f"parquet write of {typ.display()} (one int64 holds at "
                "most 18 digits)")
        return P_INT64, CT_DECIMAL
    if isinstance(typ, T.BigintType):
        return P_INT64, None
    if isinstance(typ, (T.DoubleType, T.RealType)):
        return P_DOUBLE, None
    if typ.is_string:
        return P_BYTE_ARRAY, CT_UTF8
    raise NotImplementedError(f"parquet write of {typ.display()}")


def _page_header(ptype: int, size: int, data_n: int = 0,
                 dict_n: int = 0, encoding: int = E_PLAIN) -> bytes:
    if ptype == 2:
        inner = tc.write_struct([(1, tc.I32, dict_n),
                                 (2, tc.I32, E_PLAIN)])
        return tc.write_struct([
            (1, tc.I32, 2), (2, tc.I32, size), (3, tc.I32, size),
            (7, tc.STRUCT, inner)])
    inner = tc.write_struct([
        (1, tc.I32, data_n), (2, tc.I32, encoding),
        (3, tc.I32, E_RLE), (4, tc.I32, E_RLE)])
    return tc.write_struct([
        (1, tc.I32, 0), (2, tc.I32, size), (3, tc.I32, size),
        (5, tc.STRUCT, inner)])


def _def_levels(present: np.ndarray) -> bytes:
    body = _rle_encode(present.astype(np.int64), 1)
    return struct.pack("<I", len(body)) + body


def _rle_encode(values: np.ndarray, width: int) -> bytes:
    """Pure RLE runs (always a valid hybrid encoding): per run of equal
    values, the varint of ``count << 1`` and the value in
    ``ceil(width / 8)`` little-endian bytes, every run at once."""
    v = np.asarray(values, dtype=np.int64)
    if not len(v):
        return b""
    nbytes = (width + 7) // 8
    starts = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
    heads = np.diff(np.append(starts, len(v))) << 1
    vlen = np.ones(len(heads), dtype=np.int64)
    for k in range(1, 10):
        vlen += heads >= (1 << (7 * k))
    rec = vlen + nbytes
    offs = np.cumsum(rec) - rec
    out = np.zeros(int(rec.sum()), dtype=np.uint8)
    for k in range(int(vlen.max())):
        m = vlen > k
        cont = np.where(vlen[m] - 1 > k, 0x80, 0)
        out[offs[m] + k] = ((heads[m] >> (7 * k)) & 0x7F) | cont
    vals = v[starts]
    for j in range(nbytes):
        out[offs + vlen + j] = (vals >> (8 * j)) & 0xFF
    return out.tobytes()


def _plain_encode(phys: int, live: np.ndarray) -> bytes:
    if phys in (P_INT32, P_INT64, P_DOUBLE):
        return live.astype(_PLAIN_DTYPE[phys]).tobytes()
    if phys == P_BOOLEAN:
        return np.packbits(live.astype(np.uint8),
                           bitorder="little").tobytes()
    raise NotImplementedError(f"plain encode {phys}")


def _extremes(live: np.ndarray) -> Tuple[object, object]:
    """Python's min() and max() of the values: numpy's where they agree
    (ties of 0.0 and -0.0 and NaNs keep the first value met, as Python
    compares)."""
    mn, mx = live.min(), live.max()
    if live.dtype.kind == "f" and (mn == 0 or mx == 0 or math.isnan(mn)
                                   or math.isnan(mx)):
        seq = live.tolist()
        return min(seq), max(seq)
    return mn.item(), mx.item()


def _stats_struct(phys: int, cv: _ColumnValues) -> Optional[bytes]:
    live = cv.live
    if not len(live) or phys not in (P_INT32, P_INT64, P_DOUBLE):
        return None
    mn, mx = _extremes(live)
    fmt = {P_INT32: "<i", P_INT64: "<q", P_DOUBLE: "<d"}[phys]
    return tc.write_struct([
        (3, tc.I64, int((~cv.present).sum())),
        (5, tc.BINARY, struct.pack(fmt, mx)),
        (6, tc.BINARY, struct.pack(fmt, mn)),
    ])
