"""ORC file writer: spec-conformant stripes and a protobuf tail.

The counterpart of ``presto_tpu/formats/orc_writer.py`` (reference
presto-orc/src/main/java/io/prestosql/orc/writer/OrcWriter.java, the
column writers and metadata serializers). It writes the same bytes as
the reference for the same batches, with the same encodings:

- int family / date:  RLEv2 DIRECT runs (zigzag for signed)
- double:             raw little-endian IEEE
- string/varchar:     DIRECT_V2 (utf-8 blob + RLEv2 length stream)
- boolean:            bit-packed over byte-RLE
- nulls:              PRESENT stream (bit-packed over byte-RLE)
- compression:        NONE (postscript declares it; readers honor it)

File and stripe integer statistics (min/max/hasNull) are emitted so
readers prune files and stripes (reference TupleDomainOrcPredicate.java:77).

Where the reference loops over values in Python, the port computes the
same bytes with numpy: ``rle_v2_encode`` packs each 512-value run's
big-endian bits at once, and string columns gather their UTF-8 bytes
from each batch's encoded vocabulary instead of building a Python string
per row.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Schema
from .orc_rle import _WIDTH_TABLE

MAGIC = b"ORC"

# engine type -> orc kind code
_KIND_BOOL, _KIND_BYTE, _KIND_SHORT, _KIND_INT, _KIND_LONG = 0, 1, 2, 3, 4
_KIND_FLOAT, _KIND_DOUBLE, _KIND_STRING = 5, 6, 7
_KIND_STRUCT, _KIND_DECIMAL, _KIND_DATE = 12, 14, 15
_KIND_VARCHAR, _KIND_CHAR = 16, 17


# -- protobuf wire writing ---------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _field_varint(field: int, v: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(v)


def _field_bytes(field: int, b: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(b)) + b


# -- stream encoders ---------------------------------------------------------

#: DIRECT runs must use ALIGNED widths (ORC spec; the C++ reader decodes
#: unaligned DIRECT widths as their aligned round-up, silently corrupting
#: values)
_ALIGNED_WIDTHS = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64)


def _closest_width(bits: int) -> int:
    for w in _ALIGNED_WIDTHS:
        if w >= bits:
            return w
    return 64


def _pack_big_endian(run: np.ndarray, width: int) -> bytes:
    """``run`` (uint64) as consecutive ``width``-bit big-endian fields,
    the last byte zero-padded (the reference's one big integer shifted
    and written big-endian)."""
    be = run.astype(">u8").view(np.uint8).reshape(-1, 8)
    if width % 8 == 0:
        return be[:, 8 - width // 8:].tobytes()
    bits = np.unpackbits(be, axis=1)[:, 64 - width:]
    return np.packbits(bits.reshape(-1)).tobytes()


def rle_v2_encode(values: np.ndarray, signed: bool) -> bytes:
    """DIRECT-run RLEv2: runs of <=512 values, per-run width from the
    run's max magnitude (reference RunLengthIntegerWriterV2 DIRECT
    mode)."""
    vals = values.astype(np.int64)
    if signed:
        enc = (vals.astype(np.uint64) << np.uint64(1)) ^ \
            (vals >> np.int64(63)).astype(np.uint64)
    else:
        enc = vals.astype(np.uint64)
    out = []
    for start in range(0, len(enc), 512):
        run = enc[start:start + 512]
        count = len(run)
        mx = int(run.max()) if count else 0
        width = _closest_width(max(mx.bit_length(), 1))
        wcode = _WIDTH_TABLE.index(width)
        out.append(bytes([(1 << 6) | (wcode << 1) | ((count - 1) >> 8),
                          (count - 1) & 0xFF]))
        out.append(_pack_big_endian(run, width))
    return b"".join(out)


def byte_rle_encode(raw: bytes) -> bytes:
    """ORC byte-RLE (reference stream/ByteOutputStream.java): repeat runs
    of 3..130 as (count-3, byte); literal groups of <=127 as
    (256-count, bytes)."""
    out = bytearray()
    i, n = 0, len(raw)
    lit_start = i
    while i < n:
        run = 1
        while i + run < n and run < 130 and raw[i + run] == raw[i]:
            run += 1
        if run >= 3:
            while lit_start < i:
                take = min(127, i - lit_start)
                out.append(256 - take)
                out += raw[lit_start:lit_start + take]
                lit_start += take
            out.append(run - 3)
            out.append(raw[i])
            i += run
            lit_start = i
        else:
            i += run
    while lit_start < i:
        take = min(127, i - lit_start)
        out.append(256 - take)
        out += raw[lit_start:lit_start + take]
        lit_start += take
    return bytes(out)


def present_encode(validity: np.ndarray) -> bytes:
    return byte_rle_encode(np.packbits(validity.astype(np.uint8))
                           .tobytes())


# -- column serialization ----------------------------------------------------

def _orc_kind(t: T.Type) -> int:
    if isinstance(t, T.BooleanType):
        return _KIND_BOOL
    if isinstance(t, T.TinyintType):
        return _KIND_BYTE
    if isinstance(t, T.SmallintType):
        return _KIND_SHORT
    if isinstance(t, T.IntegerType):
        return _KIND_INT
    if isinstance(t, T.BigintType):
        return _KIND_LONG
    if isinstance(t, T.DoubleType):
        return _KIND_DOUBLE
    if isinstance(t, T.DateType):
        return _KIND_DATE
    if isinstance(t, T.DecimalType):
        return _KIND_DECIMAL
    if t.is_string:
        return _KIND_STRING
    raise NotImplementedError(
        f"ORC writer does not support {t.display()}")


def _svarint(v: int) -> bytes:
    return _varint(_zigzag(v))


class _Vocab:
    """A batch vocabulary's UTF-8 bytes: one blob, each entry's offset
    and length."""

    def __init__(self, vocab: Tuple[str, ...]):
        encoded = [s.encode("utf-8") for s in vocab]
        self.lengths = np.fromiter((len(b) for b in encoded),
                                   dtype=np.int64, count=len(encoded))
        self.offsets = np.cumsum(self.lengths) - self.lengths
        self.blob = np.frombuffer(b"".join(encoded), dtype=np.uint8)


@dataclasses.dataclass
class _ColumnAccum:
    """Host row accumulator for one column across a stripe."""

    type: T.Type
    values: List[np.ndarray] = dataclasses.field(default_factory=list)
    validity: List[np.ndarray] = dataclasses.field(default_factory=list)
    #: (codes, validity, vocabulary bytes) per string chunk
    strings: List[Tuple[np.ndarray, np.ndarray, _Vocab]] = \
        dataclasses.field(default_factory=list)

    def add(self, data: np.ndarray, valid: np.ndarray,
            vocab: Optional[_Vocab]) -> None:
        self.validity.append(valid)
        if self.type.is_string:
            self.strings.append((data, valid, vocab))
        else:
            self.values.append(data)


def _string_streams(chunks) -> Tuple[bytes, np.ndarray]:
    """(UTF-8 data, per-value lengths) of the present strings of a
    stripe's chunks: a row is present when valid with a code inside its
    vocabulary (the reference's rule)."""
    data, lengths = [], []
    for codes, valid, vb in chunks:
        ok = valid & (codes >= 0) & (codes < len(vb.lengths))
        sel = codes[ok].astype(np.int64)
        lens = vb.lengths[sel]
        total = int(lens.sum())
        ends = np.cumsum(lens)
        idx = np.repeat(vb.offsets[sel] - (ends - lens), lens) \
            + np.arange(total, dtype=np.int64)
        data.append(vb.blob[idx].tobytes())
        lengths.append(lens)
    return b"".join(data), (np.concatenate(lengths) if lengths
                            else np.zeros(0, dtype=np.int64))


def _encode_column(acc: _ColumnAccum) -> Tuple[
        Dict[str, bytes], Optional[Tuple[int, int]], bool, int]:
    """-> (streams, int min/max or None, has_null, n_values)"""
    validity = (np.concatenate(acc.validity) if acc.validity
                else np.zeros(0, dtype=bool))
    has_null = bool((~validity).any())
    streams: Dict[str, bytes] = {}
    if has_null:
        streams["present"] = present_encode(validity)
    stats = None
    if acc.type.is_string:
        streams["data"], lengths = _string_streams(acc.strings)
        streams["length"] = rle_v2_encode(lengths, signed=False)
        return streams, None, has_null, len(lengths)
    vals = (np.concatenate(acc.values) if acc.values
            else np.zeros(0, dtype=np.int64))
    live = vals[validity]
    n_values = len(live)
    if isinstance(acc.type, T.DecimalType):
        # ORC decimal: DATA = zigzag base-128 varint unscaled values,
        # SECONDARY = per-value scale as signed RLE (reference
        # presto-orc/.../stream/DecimalInputStream.java)
        streams["data"] = b"".join(_svarint(int(v))
                                   for v in live.tolist())
        streams["secondary"] = rle_v2_encode(
            np.full(n_values, acc.type.scale, dtype=np.int64),
            signed=True)
        return streams, None, has_null, n_values
    if isinstance(acc.type, T.DoubleType):
        streams["data"] = live.astype("<f8").tobytes()
    elif isinstance(acc.type, T.BooleanType):
        streams["data"] = byte_rle_encode(
            np.packbits(live.astype(np.uint8)).tobytes())
    elif isinstance(acc.type, T.TinyintType):
        streams["data"] = byte_rle_encode(
            live.astype(np.int8).tobytes())
        if n_values:
            stats = (int(live.min()), int(live.max()))
    else:
        streams["data"] = rle_v2_encode(live.astype(np.int64),
                                        signed=True)
        if n_values:
            stats = (int(live.min()), int(live.max()))
    return streams, stats, has_null, n_values


def _column_stats_pb(n_values: int, stats: Optional[Tuple[int, int]],
                     has_null: bool) -> bytes:
    msg = _field_varint(1, n_values)
    if stats is not None:
        ints = (_field_varint(1, _zigzag(stats[0]))
                + _field_varint(2, _zigzag(stats[1])))
        msg += _field_bytes(2, ints)
    msg += _field_varint(10, 1 if has_null else 0)
    return msg


class OrcWriter:
    """Streaming ORC writer: batches in, stripes out every
    ``stripe_rows`` rows (reference writer/OrcWriter.java flush
    policy)."""

    def __init__(self, path: str, schema: Schema,
                 stripe_rows: int = 1 << 16):
        for t in schema.types:
            _orc_kind(t)
            if isinstance(t, T.DecimalType) and t.precision > 18:
                raise NotImplementedError(
                    f"ORC writer stores decimals in one int64; "
                    f"{t.display()} does not fit")
        self.path = path
        self.schema = schema
        self.stripe_rows = stripe_rows
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offset = len(MAGIC)
        self._accums = [_ColumnAccum(t) for t in schema.types]
        self._accum_rows = 0
        self._total_rows = 0
        self._stripe_infos: List[Tuple[int, int, int, int]] = []
        # (offset, data_len, footer_len, rows)
        self._stripe_stats: List[List[bytes]] = []
        self._file_stats: List[Tuple[
            int, Optional[Tuple[int, int]], bool]] = [
            (0, None, False) for _ in schema.types]

    # -- ingest --------------------------------------------------------------
    def write_batch(self, batch: Batch) -> int:
        mask = batch.row_mask.cpu().numpy()
        rows = np.nonzero(mask)[0]
        n = len(rows)
        if n == 0:
            return 0
        host = []
        for col in batch.columns:
            vocab = None
            if col.type.is_string:
                vocab = _Vocab(tuple(col.dictionary or ()))
            host.append((_host(col.data), col.validity.cpu().numpy(),
                         vocab))
        # chunk so no stripe exceeds stripe_rows
        start = 0
        while start < n:
            room = self.stripe_rows - self._accum_rows
            take = rows[start:start + room]
            for acc, (data, valid, vocab) in zip(self._accums, host):
                acc.add(data[take], valid[take], vocab)
            self._accum_rows += len(take)
            self._total_rows += len(take)
            start += len(take)
            if self._accum_rows >= self.stripe_rows:
                self._flush_stripe()
        return n

    # -- stripe / tail -------------------------------------------------------
    def _flush_stripe(self) -> None:
        if self._accum_rows == 0:
            return
        stream_list: List[Tuple[int, str, bytes]] = []
        col_stats_pb: List[bytes] = [
            _column_stats_pb(self._accum_rows, None, False)]
        for ci, acc in enumerate(self._accums):
            streams, stats, has_null, n_values = _encode_column(acc)
            for kind in ("present", "data", "length", "secondary"):
                if kind in streams:
                    stream_list.append((ci + 1, kind, streams[kind]))
            col_stats_pb.append(
                _column_stats_pb(n_values, stats, has_null))
            total, fstats, fnull = self._file_stats[ci]
            if stats is not None:
                fstats = (stats if fstats is None else
                          (min(fstats[0], stats[0]),
                           max(fstats[1], stats[1])))
            self._file_stats[ci] = (total + n_values, fstats,
                                    fnull or has_null)

        kind_code = {"present": 0, "data": 1, "length": 2,
                     "secondary": 5}
        footer = []
        for ci, kind, blob in stream_list:
            s = (_field_varint(1, kind_code[kind])
                 + _field_varint(2, ci)
                 + _field_varint(3, len(blob)))
            footer.append(_field_bytes(1, s))
        # encodings: DIRECT_V2 wherever an integer RLE stream is involved
        # (plain DIRECT would mean RLE v1 to conformant readers); struct
        # root and streams with no int RLE (bool/byte/double) are DIRECT
        footer.append(_field_bytes(2, _field_varint(1, 0)))
        for t in self.schema.types:
            v1_ok = isinstance(t, (T.BooleanType, T.TinyintType,
                                   T.DoubleType))
            footer.append(_field_bytes(2, _field_varint(1, 0 if v1_ok
                                                        else 2)))
        data = b"".join(blob for _, _, blob in stream_list)
        footer_b = b"".join(footer)
        self._f.write(data)
        self._f.write(footer_b)
        self._stripe_infos.append(
            (self._offset, len(data), len(footer_b), self._accum_rows))
        self._stripe_stats.append(col_stats_pb)
        self._offset += len(data) + len(footer_b)
        self._accums = [_ColumnAccum(t) for t in self.schema.types]
        self._accum_rows = 0

    def close(self) -> None:
        try:
            self._flush_stripe()
            # --- metadata (per-stripe statistics) ---
            metadata = b"".join(
                _field_bytes(1, b"".join(_field_bytes(1, cs)
                                         for cs in col_stats))
                for col_stats in self._stripe_stats)
            # --- footer ---
            footer = _field_varint(1, len(MAGIC))       # headerLength
            footer += _field_varint(2, self._offset)    # contentLength
            for off, dlen, flen, rows in self._stripe_infos:
                si = (_field_varint(1, off) + _field_varint(2, 0)
                      + _field_varint(3, dlen) + _field_varint(4, flen)
                      + _field_varint(5, rows))
                footer += _field_bytes(3, si)
            root = _field_varint(1, _KIND_STRUCT)
            for i in range(len(self.schema.types)):
                root += _field_varint(2, i + 1)
            for name in self.schema.names:
                root += _field_bytes(3, name.encode("utf-8"))
            footer += _field_bytes(4, root)
            for t in self.schema.types:
                tb = _field_varint(1, _orc_kind(t))
                if isinstance(t, T.DecimalType):
                    tb += _field_varint(5, t.precision)
                    tb += _field_varint(6, t.scale)
                footer += _field_bytes(4, tb)
            footer += _field_varint(6, self._total_rows)
            footer += _field_bytes(
                7, _column_stats_pb(self._total_rows, None, False))
            for n_values, stats, has_null in self._file_stats:
                footer += _field_bytes(
                    7, _column_stats_pb(n_values, stats, has_null))
            footer += _field_varint(8, 0)               # rowIndexStride
            # --- postscript ---
            ps = (_field_varint(1, len(footer))
                  + _field_varint(2, 0)                 # compression NONE
                  + _field_varint(3, 256 * 1024)
                  + _field_varint(4, 0) + _field_varint(4, 12)  # v0.12
                  + _field_varint(5, len(metadata))
                  + _field_varint(6, 1)                 # writer version
                  + _field_bytes(8000, MAGIC))
            self._f.write(metadata)
            self._f.write(footer)
            self._f.write(ps)
            self._f.write(bytes([len(ps)]))
        finally:
            self._f.close()


def _host(data) -> np.ndarray:
    if isinstance(data, tuple):
        raise NotImplementedError("ORC writer does not support ARRAY/MAP")
    return data.cpu().numpy() if isinstance(data, torch.Tensor) \
        else np.asarray(data)


def write_orc(path: str, schema: Schema, batches,
              stripe_rows: int = 1 << 16) -> int:
    w = OrcWriter(path, schema, stripe_rows)
    n = 0
    try:
        for b in batches:
            n += w.write_batch(b)
    except BaseException:
        # no tail: drop the partial file rather than leave a short table
        w._f.close()
        os.remove(path)
        raise
    w.close()
    return n
