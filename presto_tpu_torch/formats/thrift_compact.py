"""Thrift compact-protocol reader/writer (Parquet metadata encoding).

A copy of ``presto_tpu/formats/thrift_compact.py`` (the port imports
nothing of the JAX package).

Hand-written minimal codec — the no-codegen analogue of the reference's
parquet-format thrift bindings (reference presto-parquet depends on the
generated org.apache.parquet.format structs; this build parses the same
wire format directly). Values decode into {field_id: value} dicts; struct
shape knowledge lives in the callers (parquet.py's dataclass builders).

Compact protocol essentials: per-field header byte (delta<<4 | type) with
zigzag-varint escape for long deltas; zigzag varints for integers; varint
length-prefixed binary; list header (size<<4 | elem_type) with size=15
escape; BOOL encodes its value in the field type nibble.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

STOP = 0
BOOL_TRUE = 1
BOOL_FALSE = 2
BYTE = 3
I16 = 4
I32 = 5
I64 = 6
DOUBLE = 7
BINARY = 8
LIST = 9
SET = 10
MAP = 11
STRUCT = 12


def _varint(data: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def read_struct(data: bytes, pos: int = 0) -> Tuple[Dict[int, Any], int]:
    """Parse one struct into {field_id: python value}."""
    out: Dict[int, Any] = {}
    field_id = 0
    while True:
        header = data[pos]
        pos += 1
        if header == STOP:
            return out, pos
        delta = header >> 4
        ftype = header & 0x0F
        if delta:
            field_id += delta
        else:
            raw, pos = _varint(data, pos)
            field_id = _zigzag(raw)
        value, pos = _read_value(data, pos, ftype)
        out[field_id] = value


def _read_value(data: bytes, pos: int, ftype: int) -> Tuple[Any, int]:
    if ftype == BOOL_TRUE:
        return True, pos
    if ftype == BOOL_FALSE:
        return False, pos
    if ftype == BYTE:
        return int.from_bytes(data[pos:pos + 1], "little", signed=True), pos + 1
    if ftype in (I16, I32, I64):
        raw, pos = _varint(data, pos)
        return _zigzag(raw), pos
    if ftype == DOUBLE:
        import struct
        return struct.unpack("<d", data[pos:pos + 8])[0], pos + 8
    if ftype == BINARY:
        ln, pos = _varint(data, pos)
        return bytes(data[pos:pos + ln]), pos + ln
    if ftype in (LIST, SET):
        header = data[pos]
        pos += 1
        size = header >> 4
        etype = header & 0x0F
        if size == 15:
            size, pos = _varint(data, pos)
        items: List[Any] = []
        for _ in range(size):
            v, pos = _read_value(data, pos, etype)
            items.append(v)
        return items, pos
    if ftype == STRUCT:
        return read_struct(data, pos)
    raise ValueError(f"unsupported thrift compact type {ftype}")


# ---------------------------------------------------------------------------
# Writer (for the test-fixture Parquet writer)
# ---------------------------------------------------------------------------

def _w_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _w_zigzag(v: int) -> bytes:
    return _w_varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)


def write_struct(fields: List[Tuple[int, int, Any]]) -> bytes:
    """fields = [(field_id, type, value)] in ascending id order."""
    out = bytearray()
    last = 0
    for fid, ftype, value in fields:
        if value is None:
            continue
        wire_type = ftype
        if ftype == BOOL_TRUE:           # caller passes BOOL_TRUE for bools
            wire_type = BOOL_TRUE if value else BOOL_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | wire_type)
        else:
            out.append(wire_type)
            out += _w_zigzag(fid)
        last = fid
        out += _write_value(wire_type, value)
    out.append(STOP)
    return bytes(out)


def _write_value(ftype: int, value: Any) -> bytes:
    if ftype in (BOOL_TRUE, BOOL_FALSE):
        return b""
    if ftype in (I16, I32, I64):
        return _w_zigzag(int(value))
    if ftype == DOUBLE:
        import struct
        return struct.pack("<d", value)
    if ftype == BINARY:
        if isinstance(value, str):
            value = value.encode()
        return _w_varint(len(value)) + value
    if ftype == LIST:
        etype, items = value            # caller passes (elem_type, [encoded])
        size = len(items)
        out = bytearray()
        if size < 15:
            out.append((size << 4) | etype)
        else:
            out.append(0xF0 | etype)
            out += _w_varint(size)
        for it in items:
            if etype in (I16, I32, I64):
                out += _w_zigzag(int(it))
            elif etype == BINARY:
                b = it.encode() if isinstance(it, str) else it
                out += _w_varint(len(b)) + b
            elif etype == STRUCT:
                out += it               # pre-encoded struct bytes
            else:
                raise ValueError(f"list elem type {etype}")
        return bytes(out)
    if ftype == STRUCT:
        return value                    # pre-encoded struct bytes
    raise ValueError(f"unsupported write type {ftype}")
