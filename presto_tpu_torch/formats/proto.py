"""Minimal protobuf wire-format reader for ORC metadata.

A copy of ``presto_tpu/formats/proto.py`` (the port imports nothing of
the JAX package).

ORC stores its postscript/footer/stripe-footer metadata as protocol
buffers (reference presto-orc/.../metadata/OrcMetadataReader.java parses
the same messages via protobuf-generated classes). The ORC proto schema
is small and frozen, so a hand-rolled wire reader (varints + length-
delimited fields) avoids a protoc dependency.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

Value = Union[int, bytes, List]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List[Value]]:
    """Parse one protobuf message into {field_number: [values...]}.

    Wire types handled: 0 = varint, 1 = fixed64, 2 = length-delimited,
    5 = fixed32. Nested messages stay as bytes for the caller to parse.
    """
    fields: Dict[int, List[Value]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = read_varint(buf, pos)
        elif wire == 1:
            v = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == 2:
            ln, pos = read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        fields.setdefault(field, []).append(v)
    return fields


def first(fields: Dict[int, List[Value]], num: int, default=None):
    vals = fields.get(num)
    return vals[0] if vals else default


def packed_varints(data: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = read_varint(data, pos)
        out.append(v)
    return out
