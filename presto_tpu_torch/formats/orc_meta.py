"""ORC container metadata: postscript, footer, stripe footers.

A copy of ``presto_tpu/formats/orc_meta.py`` (the port imports nothing
of the JAX package).

From-scratch port of concept from the reference's ORC metadata layer
(reference presto-orc/.../metadata/OrcMetadataReader.java,
PostScript.java, Footer.java, StripeInformation.java, Stream.java,
ColumnEncoding.java; the message/field numbers are the public ORC spec's
orc_proto.proto). Host-side only — metadata is tiny.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

from .proto import first, packed_varints, parse_message, read_varint

MAGIC = b"ORC"

COMPRESSION = {0: "none", 1: "zlib", 2: "snappy", 3: "lzo", 4: "lz4",
               5: "zstd"}

TYPE_KINDS = {
    0: "boolean", 1: "byte", 2: "short", 3: "int", 4: "long", 5: "float",
    6: "double", 7: "string", 8: "binary", 9: "timestamp", 10: "list",
    11: "map", 12: "struct", 13: "union", 14: "decimal", 15: "date",
    16: "varchar", 17: "char",
}

STREAM_KINDS = {0: "present", 1: "data", 2: "length", 3: "dictionary_data",
                4: "dictionary_count", 5: "secondary", 6: "row_index",
                7: "bloom_filter"}

ENCODINGS = {0: "direct", 1: "dictionary", 2: "direct_v2",
             3: "dictionary_v2"}


@dataclasses.dataclass
class OrcType:
    kind: str
    subtypes: List[int]
    field_names: List[str]
    max_length: Optional[int] = None
    precision: Optional[int] = None
    scale: Optional[int] = None


@dataclasses.dataclass
class StripeInfo:
    offset: int
    index_length: int
    data_length: int
    footer_length: int
    num_rows: int


@dataclasses.dataclass
class ColumnIntStats:
    min: Optional[int]
    max: Optional[int]
    has_null: bool


@dataclasses.dataclass
class StreamInfo:
    kind: str
    column: int
    length: int
    offset: int = 0        # filled while laying out the stripe


@dataclasses.dataclass
class StripeFooter:
    streams: List[StreamInfo]
    encodings: List[str]           # per column id
    dictionary_sizes: List[int]


@dataclasses.dataclass
class OrcFileTail:
    compression: str
    compression_block_size: int
    types: List[OrcType]
    stripes: List[StripeInfo]
    num_rows: int
    row_index_stride: int
    int_stats: Dict[int, ColumnIntStats]     # column id -> file stats
    # per-stripe column stats from the metadata section (may be empty)
    stripe_stats: List[Dict[int, ColumnIntStats]] = dataclasses.field(
        default_factory=list)


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def decompress_stream(data: bytes, compression: str) -> bytes:
    """Undo ORC's chunked compression framing: 3-byte LE header =
    (chunk_len << 1) | is_original, then chunk_len bytes (reference
    presto-orc/.../stream/CompressedOrcChunkLoader.java)."""
    if compression == "none":
        return data
    out = bytearray()
    pos = 0
    n = len(data)
    while pos + 3 <= n:
        header = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        original = header & 1
        length = header >> 1
        chunk = data[pos:pos + length]
        pos += length
        if original:
            out += chunk
        elif compression == "zlib":
            out += zlib.decompress(chunk, wbits=-15)
        else:
            raise NotImplementedError(
                f"ORC compression {compression!r} is not supported "
                "(none/zlib are)")
    return bytes(out)


def _parse_type(buf: bytes) -> OrcType:
    f = parse_message(buf)
    subtypes: List[int] = []
    for v in f.get(2, []):
        if isinstance(v, bytes):
            subtypes.extend(packed_varints(v))
        else:
            subtypes.append(v)
    return OrcType(
        kind=TYPE_KINDS[first(f, 1, 0)],
        subtypes=subtypes,
        field_names=[b.decode() for b in f.get(3, [])],
        max_length=first(f, 4),
        precision=first(f, 5),
        scale=first(f, 6),
    )


def _parse_int_stats(buf: bytes) -> Optional[ColumnIntStats]:
    f = parse_message(buf)
    has_null = bool(first(f, 10, 0))
    raw = first(f, 2)
    if raw is None:
        return ColumnIntStats(None, None, has_null)
    g = parse_message(raw)
    mn, mx = first(g, 1), first(g, 2)
    # IntegerStatistics min/max are sint64 (zigzag)
    return ColumnIntStats(
        _zigzag(mn) if mn is not None else None,
        _zigzag(mx) if mx is not None else None,
        has_null,
    )


def tail_size_needed(suffix: bytes) -> int:
    """Bytes from end-of-file the full tail spans (postscript + footer +
    metadata). Callers re-read with a bigger suffix if this exceeds what
    they fetched."""
    ps_len = suffix[-1]
    ps = parse_message(suffix[-1 - ps_len:-1])
    return 1 + ps_len + first(ps, 1, 0) + first(ps, 5, 0)


def read_tail(data: bytes) -> OrcFileTail:
    """Parse the file tail. ``data`` may be the whole file or any suffix
    that covers postscript + footer + metadata (tail_size_needed)."""
    if len(data) < 4:
        raise ValueError("not an ORC file (too short)")
    ps_len = data[-1]
    ps = parse_message(data[-1 - ps_len:-1])
    footer_len = first(ps, 1, 0)
    compression = COMPRESSION[first(ps, 2, 0)]
    block_size = first(ps, 3, 256 * 1024)
    metadata_len = first(ps, 5, 0)
    magic = first(ps, 8000, b"")
    if magic != MAGIC:
        raise ValueError("bad postscript magic (not an ORC file?)")
    footer_raw = data[-1 - ps_len - footer_len:-1 - ps_len]
    footer = parse_message(decompress_stream(footer_raw, compression))
    stripe_stats: List[Dict[int, ColumnIntStats]] = []
    if metadata_len:
        meta_raw = data[-1 - ps_len - footer_len - metadata_len:
                        -1 - ps_len - footer_len]
        meta = parse_message(decompress_stream(meta_raw, compression))
        for sb in meta.get(1, []):          # repeated StripeStatistics
            cols: Dict[int, ColumnIntStats] = {}
            for ci, cb in enumerate(parse_message(sb).get(1, [])):
                st = _parse_int_stats(cb)
                if st is not None:
                    cols[ci] = st
            stripe_stats.append(cols)
    types = [_parse_type(b) for b in footer.get(4, [])]
    stripes = []
    for b in footer.get(3, []):
        f = parse_message(b)
        stripes.append(StripeInfo(
            offset=first(f, 1, 0), index_length=first(f, 2, 0),
            data_length=first(f, 3, 0), footer_length=first(f, 4, 0),
            num_rows=first(f, 5, 0)))
    int_stats: Dict[int, ColumnIntStats] = {}
    for ci, b in enumerate(footer.get(7, [])):
        st = _parse_int_stats(b)
        if st is not None:
            int_stats[ci] = st
    return OrcFileTail(
        compression=compression,
        compression_block_size=block_size,
        types=types,
        stripes=stripes,
        num_rows=first(footer, 6, 0),
        row_index_stride=first(footer, 8, 0),
        int_stats=int_stats,
        stripe_stats=stripe_stats,
    )


def parse_stripe_footer(raw: bytes, compression: str) -> StripeFooter:
    """Parse a stripe footer; stream offsets come out RELATIVE to the
    stripe start (index region first, then data — stream-list order)."""
    f = parse_message(decompress_stream(raw, compression))
    streams: List[StreamInfo] = []
    offset = 0
    for b in f.get(1, []):
        g = parse_message(b)
        s = StreamInfo(
            kind=STREAM_KINDS.get(first(g, 1, 0), "?"),
            column=first(g, 2, 0),
            length=first(g, 3, 0),
            offset=offset)
        offset += s.length
        streams.append(s)
    encodings: List[str] = []
    dict_sizes: List[int] = []
    for b in f.get(2, []):
        g = parse_message(b)
        encodings.append(ENCODINGS[first(g, 1, 0)])
        dict_sizes.append(first(g, 2, 0))
    return StripeFooter(streams=streams, encodings=encodings,
                        dictionary_sizes=dict_sizes)
