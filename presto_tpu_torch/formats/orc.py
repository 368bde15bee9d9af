"""ORC file reader: host metadata and pruning, device column decode.

The counterpart of ``presto_tpu/formats/orc.py`` (reference
presto-orc/.../OrcReader.java:50 parses the tail;
OrcRecordReader.java:70,366 iterates stripes and materializes columns
through per-type stream readers; TupleDomainOrcPredicate.java:77 prunes
stripes on min/max statistics). The stripe and footer parsing and the
pruning stay on the host; the bulk value decode (RLEv2 bit-unpacking,
IEEE byte assembly) runs on the device the caller names
(``formats/orc_rle.py``), and columns land there as the port's
``Column``s.

IO is ranged: the tail parses from a bounded suffix read and each stripe
reads exactly its byte range.

Supported, as in the reference: a struct root over boolean, byte, int,
long, short, float, double, string, varchar, char, date and decimal (up
to 18 digits) columns, NONE or ZLIB compression, DIRECT, DIRECT_V2 and
DICTIONARY_V2 encodings, nulls through present streams, file- and
stripe-level min/max pruning.

DIRECT_V2 strings decode on the host, as in the reference, into codes
over the stripe's sorted distinct values; the port sorts them with numpy
(``_direct_strings``) where the bytes allow it to give the reference
loop's exact vocabulary and codes, and runs that loop otherwise.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Column, Schema, bucket_capacity
from . import decodestats as stats
from .orc_meta import (
    ColumnIntStats, OrcFileTail, StripeFooter, StripeInfo,
    decompress_stream, parse_stripe_footer, read_tail, tail_size_needed,
)
from .orc_rle import (
    decode_byte_rle, decode_present, decode_rle_v2_device,
    decode_rle_v2_numpy,
)

_ORC_TO_ENGINE = {
    "boolean": T.BOOLEAN,
    "byte": T.TINYINT,
    "short": T.SMALLINT,
    "int": T.INTEGER,
    "long": T.BIGINT,
    "float": T.DOUBLE,
    "double": T.DOUBLE,
    "string": T.VARCHAR,
    "varchar": T.VARCHAR,
    "char": T.VARCHAR,
    "date": T.DATE,
}

_TAIL_GUESS = 64 * 1024

#: largest [values, longest string] byte matrix the numpy string decode
#: builds; larger stripes take the reference loop
_STRING_MATRIX_BYTES = 1 << 27


@dataclasses.dataclass
class OrcColumn:
    name: str
    orc_id: int            # type id in the ORC schema tree
    orc_kind: str
    type: T.Type


class OrcReader:
    """One ORC file; column-projected, stripe-granular batch iterator."""

    def __init__(self, path: str):
        self.path = path
        self._size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, self._size - _TAIL_GUESS))
            suffix = f.read()
            needed = tail_size_needed(suffix)
            if needed > len(suffix):
                f.seek(self._size - needed)
                suffix = f.read()
        self.tail: OrcFileTail = read_tail(suffix)
        root = self.tail.types[0]
        if root.kind != "struct":
            raise ValueError("only struct-rooted ORC files are supported")
        self.columns: List[OrcColumn] = []
        for name, tid in zip(root.field_names, root.subtypes):
            t = self.tail.types[tid]
            if t.kind == "decimal":
                if (t.precision or 38) > 18:
                    # the reference stores ORC decimals in one int64
                    raise NotImplementedError(
                        f"ORC decimal({t.precision},{t.scale}) exceeds "
                        "the supported precision 18")
                engine_t = T.DecimalType(t.precision or 38, t.scale or 0)
            elif t.kind not in _ORC_TO_ENGINE:
                raise NotImplementedError(
                    f"ORC column type {t.kind!r} is not supported")
            else:
                engine_t = _ORC_TO_ENGINE[t.kind]
            if t.kind in ("varchar", "char") and t.max_length:
                engine_t = T.varchar(t.max_length)
            self.columns.append(OrcColumn(name, tid, t.kind, engine_t))
        self._by_name = {c.name: c for c in self.columns}

    def _read_range(self, offset: int, length: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    @property
    def schema(self) -> Schema:
        return Schema([(c.name, c.type) for c in self.columns])

    @property
    def num_rows(self) -> int:
        return self.tail.num_rows

    # -- pruning -------------------------------------------------------------
    def _excluded(self, col_stats: Dict[int, ColumnIntStats],
                  min_max: Dict[str, Tuple[int, int]]) -> bool:
        for name, (lo, hi) in min_max.items():
            c = self._by_name.get(name)
            if c is None:
                continue
            st = col_stats.get(c.orc_id)
            if st is None or st.min is None or st.max is None:
                continue
            # lo/hi of None = unbounded on that side
            if ((lo is not None and st.max < lo)
                    or (hi is not None and st.min > hi)):
                return True
        return False

    def file_prunable(self, min_max: Dict[str, Tuple[int, int]]) -> bool:
        return bool(min_max) and self._excluded(self.tail.int_stats,
                                                min_max)

    def stripe_prunable(self, stripe_index: int,
                        min_max: Dict[str, Tuple[int, int]]) -> bool:
        """Per-stripe min/max exclusion from the metadata section
        (reference TupleDomainOrcPredicate.java:77 over
        StripeStatistics)."""
        if not min_max or stripe_index >= len(self.tail.stripe_stats):
            return False
        return self._excluded(self.tail.stripe_stats[stripe_index],
                              min_max)

    # -- stripe decode -------------------------------------------------------
    def read_stripe(self, stripe: StripeInfo, names: Sequence[str], *,
                    device) -> Batch:
        """One stripe's columns ``names`` as a batch on ``device``."""
        device = torch.device(device)
        t0 = time.perf_counter()
        body = self._read_range(
            stripe.offset,
            stripe.index_length + stripe.data_length
            + stripe.footer_length)
        footer = parse_stripe_footer(
            body[stripe.index_length + stripe.data_length:],
            self.tail.compression)
        n = stripe.num_rows
        cap = bucket_capacity(n)
        cols: List[Column] = []
        fields: List[Tuple[str, T.Type]] = []
        for name in names:
            c = self._by_name[name]
            cols.append(self._decode_column(c, footer, body, n, cap, device))
            fields.append((name, c.type))
        mask = torch.arange(cap, device=device) < n
        stats.HOST_SECONDS.inc(time.perf_counter() - t0)
        stats.ORC_STRIPES_READ.inc()
        return Batch(Schema(fields), cols, mask)

    def batches(self, names: Optional[Sequence[str]] = None,
                min_max: Optional[Dict[str, Tuple[int, int]]] = None, *,
                device) -> Iterator[Batch]:
        """One batch on ``device`` per stripe that the min/max bounds do
        not exclude."""
        names = list(names) if names is not None \
            else [c.name for c in self.columns]
        if min_max and self.file_prunable(min_max):
            stats.ORC_FILES_PRUNED.inc()
            stats.ORC_STRIPES_PRUNED.inc(len(self.tail.stripes))
            return
        for si, stripe in enumerate(self.tail.stripes):
            if min_max and self.stripe_prunable(si, min_max):
                stats.ORC_STRIPES_PRUNED.inc()
                continue
            yield self.read_stripe(stripe, names, device=device)

    # -- column decoders -----------------------------------------------------
    def _streams(self, footer: StripeFooter, body: bytes,
                 orc_id: int) -> Dict[str, bytes]:
        out = {}
        for s in footer.streams:
            if s.column == orc_id and s.kind in (
                    "present", "data", "length", "dictionary_data",
                    "secondary"):
                raw = body[s.offset:s.offset + s.length]
                out[s.kind] = decompress_stream(raw,
                                                self.tail.compression)
        return out

    def _decode_column(self, c: OrcColumn, footer: StripeFooter,
                       body: bytes, n: int, cap: int,
                       device: torch.device) -> Column:
        enc = footer.encodings[c.orc_id]
        streams = self._streams(footer, body, c.orc_id)
        present = streams.get("present")
        if present is not None:
            validity_np = decode_present(present, n)
        else:
            validity_np = np.ones(n, dtype=bool)
        n_values = int(validity_np.sum())
        validity = np.zeros(cap, dtype=bool)
        validity[:n] = validity_np
        valid_t = torch.from_numpy(validity).to(device)

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def scatter_i64(vals: torch.Tensor) -> torch.Tensor:
            """Spread n_values decoded values to their row slots."""
            if vals.shape[0] == 0:       # no value: every row is NULL
                vals = vals.new_zeros(1)
            if n_values == n:
                if vals.shape[0] >= cap:
                    return vals[:cap]
                return torch.cat([vals, vals.new_zeros(cap - vals.shape[0])])
            pos = np.zeros(cap, dtype=np.int64)
            pos[np.nonzero(validity)[0]] = np.arange(n_values)
            return vals[up(pos)]

        def rle_values(data: bytes, signed: bool) -> torch.Tensor:
            return decode_rle_v2_device(
                data, n_values, signed=signed,
                capacity=bucket_capacity(max(n_values, 1)), device=device)

        data = streams.get("data", b"")
        if c.orc_kind in ("long", "int", "short", "date"):
            out = scatter_i64(rle_values(data, True))
            return Column(c.type, out.to(c.type.storage_dtype), valid_t,
                          None)
        if c.orc_kind == "byte":
            # sign-extend: ORC byte is a signed tinyint
            vals = decode_byte_rle(data, n_values).view(np.int8) \
                .astype(np.int64)
            out = scatter_i64(up(vals))
            return Column(c.type, out.to(c.type.storage_dtype), valid_t,
                          None)
        if c.orc_kind == "boolean":
            bits = decode_present(data, n_values)
            out = scatter_i64(up(bits.astype(np.int64)))
            return Column(c.type, out.to(torch.bool), valid_t, None)
        if c.orc_kind in ("double", "float"):
            width = 8 if c.orc_kind == "double" else 4
            raw = up(np.frombuffer(data, dtype=np.uint8)[:n_values * width]
                     .copy())
            with stats.expansion():
                vals = _assemble_ieee(raw, n_values, width)
            out = scatter_i64(vals)
            return Column(c.type, out.to(torch.float64), valid_t, None)
        if c.orc_kind == "decimal":
            # DATA = zigzag base-128 varint unscaled values, SECONDARY =
            # per-value scale (reference stream/DecimalInputStream.java);
            # rescale to the declared scale and store i64
            scales = decode_rle_v2_numpy(
                streams.get("secondary", b""), n_values, signed=True)
            target = c.type.scale
            mant = np.empty(n_values, dtype=np.int64)
            pos = 0
            for i in range(n_values):
                result = 0
                shift = 0
                while True:
                    b = data[pos]
                    pos += 1
                    result |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                # exact python-int arithmetic, bounds-checked into i64
                v = (result >> 1) ^ -(result & 1)
                d = target - int(scales[i])
                if d > 0:
                    v *= 10 ** d
                elif d < 0:
                    v //= 10 ** (-d)
                if not -(2 ** 63) <= v < 2 ** 63:
                    raise OverflowError(
                        f"decimal value out of i64 range in {c.name!r}")
                mant[i] = v
            out = scatter_i64(up(mant))
            return Column(c.type, out.to(c.type.storage_dtype), valid_t,
                          None)
        if c.orc_kind in ("string", "varchar", "char"):
            if enc == "dictionary_v2":
                dict_size = footer.dictionary_sizes[c.orc_id]
                lengths = decode_rle_v2_numpy(
                    streams.get("length", b""), dict_size, signed=False)
                blob = streams.get("dictionary_data", b"")
                vocab: List[str] = []
                pos = 0
                for ln in lengths:
                    vocab.append(blob[pos:pos + int(ln)].decode(
                        "utf-8", "replace"))
                    pos += int(ln)
                out = scatter_i64(rle_values(data, False))
                return Column(c.type, out.to(torch.int32), valid_t,
                              tuple(vocab) or ("",))
            if enc == "direct_v2":
                lengths = decode_rle_v2_numpy(
                    streams.get("length", b""), n_values, signed=False)
                codes, vocab_t = _direct_strings(data, lengths)
                out = scatter_i64(up(codes))
                return Column(c.type, out.to(torch.int32), valid_t,
                              vocab_t or ("",))
            raise NotImplementedError(f"string encoding {enc!r}")
        raise NotImplementedError(c.orc_kind)


def _direct_strings(blob: bytes, lengths: np.ndarray
                    ) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """(int64 codes, vocabulary) of DIRECT_V2 strings: the vocabulary is
    the sorted distinct decoded values and each code its value's rank,
    as the reference builds them. numpy sorts the bytes as one
    fixed-width matrix when that gives the same answer: no NUL byte
    (fixed-width bytes drop trailing NULs) and decoded values that stay
    distinct and in byte order (a valid UTF-8 text sorts by code point
    as by bytes); the reference loop decodes the rest."""
    n = len(lengths)
    lengths = np.asarray(lengths, dtype=np.int64)
    width = int(lengths.max()) if n else 0
    if n and b"\x00" not in blob and n * max(width, 1) <= _STRING_MATRIX_BYTES:
        if width == 0:
            return np.zeros(n, dtype=np.int64), ("",)
        starts = np.cumsum(lengths) - lengths
        # strings of up to 8 bytes sort as big-endian integers of their
        # zero-padded bytes, faster than as fixed-width bytes
        cols = 8 if width <= 8 else width
        col = np.arange(width, dtype=np.int64)
        take = col[None, :] < lengths[:, None]
        mat = np.zeros((n, cols), dtype=np.uint8)
        mat[:, :width][take] = np.frombuffer(blob, dtype=np.uint8)[
            (starts[:, None] + col[None, :])[take]]
        keys = mat.view(">u8" if cols == 8 else f"S{cols}").ravel()
        uniq, codes = np.unique(keys, return_inverse=True)
        if cols == 8:
            uniq = [int(u).to_bytes(8, "big").rstrip(b"\0")
                    for u in uniq.tolist()]
        vocab = [u.decode("utf-8", "replace") for u in uniq]
        if all(a < b for a, b in zip(vocab, vocab[1:])):
            return codes.reshape(-1).astype(np.int64), tuple(vocab)
    values: List[str] = []
    pos = 0
    for ln in lengths:
        values.append(blob[pos:pos + int(ln)].decode("utf-8", "replace"))
        pos += int(ln)
    vocab_list = sorted(set(values))
    lookup = {s: i for i, s in enumerate(vocab_list)}
    return (np.asarray([lookup[s] for s in values], dtype=np.int64),
            tuple(vocab_list))


def _assemble_ieee(u8: torch.Tensor, n_values: int,
                   width: int) -> torch.Tensor:
    """Little-endian IEEE values from their raw bytes: a bit
    reinterpretation of a contiguous slice, exact on any device."""
    if width == 8:
        return u8[:n_values * 8].contiguous().view(torch.float64)
    return u8[:n_values * 4].contiguous().view(torch.float32) \
        .to(torch.float64)
